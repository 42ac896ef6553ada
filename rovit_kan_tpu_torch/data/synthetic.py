"""Deterministic synthetic rose-leaf images.

A copy of ``rovit_kan_tpu/data/synthetic.py`` (numpy only; the port keeps its
own copy rather than importing the JAX package): class-distinguishable leaf
images (a green ellipse on a dark background, with class-specific lesions:
holes, black spots, brown dry patches), the same pixels for the same seed.
``make_leaf_image`` makes one in memory; ``generate_synthetic_dataset``
writes a class-per-folder JPEG tree and imports PIL only then.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

DEFAULT_CLASSES = ("Healthy Leaf", "Leaf Holes", "Black Spot", "Dry Leaf")


def make_leaf_image(class_idx: int, rng: np.random.RandomState,
                    size: int = 224) -> np.ndarray:
    """One synthetic leaf image (H, W, 3) uint8 for class ``class_idx``."""
    img = np.zeros((size, size, 3), dtype=np.float32)
    bg_color = rng.uniform(10, 40, 3).astype(np.float32)       # soil bg
    img[..., :] = bg_color

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy, cx = size / 2 + rng.uniform(-8, 8), size / 2 + rng.uniform(-8, 8)
    ry, rx = size * rng.uniform(0.30, 0.42), size * rng.uniform(0.22, 0.33)
    theta = rng.uniform(0, np.pi)
    yr = (yy - cy) * np.cos(theta) + (xx - cx) * np.sin(theta)
    xr = -(yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta)
    leaf = ((yr / ry) ** 2 + (xr / rx) ** 2) <= 1.0

    green = np.array([rng.uniform(30, 60), rng.uniform(120, 180),
                      rng.uniform(30, 70)], np.float32)
    img[leaf] = green + rng.randn(int(leaf.sum()), 3) * 8

    # central vein
    vein = (np.abs(xr) < 1.5) & leaf
    img[vein] = green * 0.7

    n_marks = rng.randint(3, 9)
    for _ in range(n_marks):
        my = rng.uniform(cy - ry * 0.7, cy + ry * 0.7)
        mx = rng.uniform(cx - rx * 0.7, cx + rx * 0.7)
        mr = rng.uniform(size * 0.02, size * 0.06)
        d2 = (yy - my) ** 2 + (xx - mx) ** 2
        mark = (d2 <= mr ** 2) & leaf
        ring = (d2 <= (mr * 1.6) ** 2) & ~(d2 <= mr ** 2) & leaf
        if class_idx == 1:      # Leaf Holes: punch through to the ACTUAL
            # background (real holes show the soil behind the leaf), with a
            # thin brown necrotic rim typical of chewing-insect damage.
            img[ring] = np.array([100, 70, 30], np.float32) \
                + rng.randn(int(ring.sum()), 3) * 6
            img[mark] = bg_color + rng.randn(int(mark.sum()), 3) * 3
        elif class_idx == 2:    # Black Spot: near-black fungal lesion with
            # the disease's signature yellow chlorotic halo.
            img[ring] = np.array([165, 160, 45], np.float32) \
                + rng.randn(int(ring.sum()), 3) * 8
            img[mark] = rng.uniform(0, 18) \
                + rng.randn(int(mark.sum()), 3) * 3
        elif class_idx == 3:    # Dry Leaf: brown patches
            img[mark] = np.array([rng.uniform(120, 160),
                                  rng.uniform(80, 110),
                                  rng.uniform(20, 50)], np.float32)
    if class_idx == 3:          # overall desaturation for dry leaves
        img[leaf] = img[leaf] * 0.8 + np.array([40, 20, 0], np.float32)

    return np.clip(img, 0, 255).astype(np.uint8)


def generate_synthetic_dataset(
    root: Path,
    n_per_class: int = 8,
    size: int = 224,
    class_names: Sequence[str] = DEFAULT_CLASSES,
    seed: int = 0,
) -> Path:
    """Write a class-per-folder JPEG tree under ``root`` and return it."""
    from PIL import Image
    root = Path(root)
    rng = np.random.RandomState(seed)
    for ci, cname in enumerate(class_names):
        cdir = root / cname
        cdir.mkdir(parents=True, exist_ok=True)
        for j in range(n_per_class):
            arr = make_leaf_image(ci, rng, size)
            Image.fromarray(arr).save(cdir / f"{cname.replace(' ', '_')}_{j:04d}.jpg",
                                      quality=90)
    return root
