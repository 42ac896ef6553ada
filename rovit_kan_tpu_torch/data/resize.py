"""The plain numpy version of the dataset's host-side image resize.

A copy of ``rovit_kan_tpu/native/preprocess.cpp::resize_image``, the resize
the JAX package's dataset runs whenever its native library builds: separable
bilinear with half-pixel centres (``align_corners=False``), no antialias,
every intermediate in float32, the result rounded by adding 0.5 and
truncating. The operations run in the C++ order, vectorized, so the port
loads the same uint8 pixels as the reference.

The dataset resizes through the C++ engine (``native/preprocess.cpp``),
which gives these bits; this copy is what the tests and
``cli.bench_host_pipeline`` hold it against. The reference falls back to
PIL's ``BILINEAR`` (which antialiases when it shrinks) only on a machine
where its native library cannot be compiled; the port has no such fallback.
"""
from __future__ import annotations

import numpy as np

_HALF = np.float32(0.5)


def _axis(src: int, dst: int):
    """Sample positions along one axis: the two source indices and the
    weight of the second, as the C++ computes them in float32."""
    scale = np.float32(src) / np.float32(dst)
    s = (np.arange(dst, dtype=np.float32) + _HALF) * scale - _HALF
    s = np.minimum(s, np.float32(src - 1))
    s = np.maximum(np.float32(0.0), s)
    i0 = s.astype(np.int64)                   # truncation, s >= 0
    i1 = np.minimum(i0 + 1, src - 1)
    w = s - i0.astype(np.float32)
    return i0, i1, w


def resize_image(src_u8_hwc: np.ndarray, size: int) -> np.ndarray:
    """Resize an ``(H, W, C)`` uint8 image to ``(size, size, C)`` uint8.

    Each output value is ``top + fy * (bot - top) + 0.5`` truncated, where
    ``top`` and ``bot`` interpolate the two nearest source rows along x
    (``r0[a] + fx * (r0[b] - r0[a])``), all in float32."""
    src = np.asarray(src_u8_hwc)
    if src.dtype != np.uint8 or src.ndim != 3:
        raise ValueError(f"resize_image takes (H, W, C) uint8, got "
                         f"{src.dtype} {src.shape}")
    sh, sw = src.shape[:2]
    y0, y1, fy = _axis(sh, size)
    x0, x1, fx = _axis(sw, size)
    f = src.astype(np.float32)
    fx = fx[None, :, None]
    fy = fy[:, None, None]
    r0, r1 = f[y0], f[y1]
    top = r0[:, x0] + fx * (r0[:, x1] - r0[:, x0])
    bot = r1[:, x0] + fx * (r1[:, x1] - r1[:, x0])
    v = top + fy * (bot - top)
    return (v + _HALF).astype(np.uint8)
