"""The host-side resize engine: ``native/preprocess.cpp`` through ctypes.

Counterpart of ``rovit_kan_tpu/native/__init__.py``, with the same C ABI and
the same Python signatures (``resize_batch``, ``normalize_batch``). The
library builds with ``g++`` at first use, never at import, into
``rovit_kan_tpu_torch/_build/`` under a name keyed on a hash of the source
and the flags (as ``ops/_build.py`` builds the CUDA sources, and under its
lock), so an edited source rebuilds and an unchanged one is reused.

``-ffp-contract=off`` keeps every float32 product and sum rounded on its
own: where the compiler contracts ``top + fx * (bot - top)`` into a fused
multiply-add (GCC does by default on aarch64), some pixels move by one
against ``data/resize.py`` and the JAX engine. There is no fallback: a
failed build raises with the compiler's output.

ctypes releases the GIL for the whole call, so the dataset's decode threads
resize in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from rovit_kan_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "preprocess.cpp"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-ffp-contract=off"]
DEFAULT_THREADS = min(8, os.cpu_count() or 1)

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    return _build.BUILD_DIR / f"preprocess-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError when the compiler is missing or fails."""
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"{CXX} not found: the resize engine "
                           f"(native/preprocess.cpp) builds with {CXX}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build.BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{CXX} failed for {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)      # atomic when two processes build at once
    return target


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _build._lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.resize_batch_u8.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64]
            lib.resize_batch_u8.restype = None
            lib.normalize_batch_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64]
            lib.normalize_batch_u8.restype = None
            _lib = lib
        return _lib


def resize_batch(images, size: int,
                 n_threads: int = DEFAULT_THREADS) -> np.ndarray:
    """Resize a list of ``(H, W, 3)`` uint8 arrays to one
    ``(N, size, size, 3)`` uint8 batch."""
    lib = load()
    n = len(images)
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    for im in images:
        if im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"resize_batch takes (H, W, 3) images, got "
                             f"{im.shape}")
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
    hw = np.asarray([im.shape[:2] for im in images],
                    np.int64).reshape(-1)
    lib.resize_batch_u8(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, out.ctypes.data, size, size, n_threads)
    return out


def normalize_batch(images_u8: np.ndarray, mean, std,
                    n_threads: int = DEFAULT_THREADS) -> np.ndarray:
    """uint8 ``(N, H, W, 3)`` -> float32 ``(x / 255 - mean) / std``."""
    lib = load()
    images_u8 = np.ascontiguousarray(images_u8, dtype=np.uint8)
    n = images_u8.shape[0]
    hw = int(np.prod(images_u8.shape[1:-1]))
    out = np.empty(images_u8.shape, dtype=np.float32)
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    inv_std = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    lib.normalize_batch_u8(images_u8.ctypes.data, out.ctypes.data, n, hw,
                           mean.ctypes.data, inv_std.ctypes.data, n_threads)
    return out
