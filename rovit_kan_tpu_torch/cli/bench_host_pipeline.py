"""Time the host input pipeline: the C++ resize engine against its numpy copy.

    python -m rovit_kan_tpu_torch.cli.bench_host_pipeline \
        [--out outputs/torch_host_pipeline/host_pipeline.json] \
        [--scales 4000 20000] [--src_size 384] [--image_size 224] \
        [--rounds 2] [--workers 1]

Counterpart of the JAX package's ``scripts/bench_host_pipeline.py``. For
each scale it writes a class-per-folder JPEG tree at ``--src_size`` (so
every load resizes) and times a full ``RoseLeafDataset`` cache build
(decode and resize of every image; on one thread as the JAX script does, or
on ``--workers`` threads as ``DeviceLoader`` fills its cache) through the
engine (``native/preprocess.cpp``, the dataset's own path) and through
``data/resize.py``, the arms in turns for ``--rounds`` rounds, with the
seconds spent inside the resize (summed over the threads) and so its share
of the build's thread time. The JPEG files are read warm after the tree is
written. A micro-benchmark times the resize alone, decode excluded: the
numpy copy and the engine image by image, and the engine on the whole batch
at 1, 2, 4 and 8 threads. The host's ``os.cpu_count()`` and the CPUs this
process may run on are recorded.

Writes one JSON file, never the JAX package's ``outputs/ab_host_pipeline.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

DEFAULT_OUT = Path("outputs/torch_host_pipeline/host_pipeline.json")


def make_jpeg_tree(root: Path, class_names, n_per_class: int,
                   src_size: int, seed: int = 0, workers: int = 1) -> None:
    """A class-per-folder tree of random JPEGs at ``src_size`` px (the
    pixels drawn in order from ``seed``, the encoding on ``workers``
    threads)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    with ThreadPoolExecutor(workers) as ex:
        for c in class_names:
            d = root / c
            d.mkdir(parents=True, exist_ok=True)
            arrs = [rng.randint(0, 256, (src_size, src_size, 3), np.uint8)
                    for _ in range(n_per_class)]
            list(ex.map(lambda i: Image.fromarray(arrs[i]).save(
                d / f"{i:05d}.jpg", quality=90), range(n_per_class)))


def _numpy_resize_batch(images, size: int, n_threads: int = 1):
    from rovit_kan_tpu_torch.data.resize import resize_image
    return np.stack([resize_image(im, size) for im in images])


def time_cache_build(root: Path, class_names, severity_map,
                     image_size: int, arm: str, workers: int = 1) -> dict:
    """Wall time of a full cache build on ``workers`` threads with the
    dataset's resize through ``arm`` ("engine" or "numpy"), and the seconds
    inside the resize."""
    from rovit_kan_tpu_torch.data import dataset as ds_mod
    from rovit_kan_tpu_torch import native

    inner = native.resize_batch if arm == "engine" else _numpy_resize_batch
    spent = []

    def timed(images, size, n_threads=1):
        t0 = time.perf_counter()
        out = inner(images, size, n_threads=n_threads)
        spent.append(time.perf_counter() - t0)
        return out

    kept = ds_mod.resize_batch
    ds_mod.resize_batch = timed
    try:
        ds = ds_mod.RoseLeafDataset(root, class_names, severity_map,
                                    image_size=image_size, cache=True)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as ex:
            list(ex.map(ds._load_image, range(len(ds))))
        wall = time.perf_counter() - t0
    finally:
        ds_mod.resize_batch = kept
    return {"n_images": len(ds), "workers": workers, "wall_s": wall,
            "images_per_s": len(ds) / wall, "resize_s": sum(spent),
            "resize_share": sum(spent) / (wall * workers)}


def micro_resize(src_size: int, image_size: int, n: int = 200,
                 threads=(1, 2, 4, 8)) -> dict:
    """The resize alone: the numpy copy and the engine image by image, and
    the engine's batch call over a thread sweep."""
    from rovit_kan_tpu_torch import native
    from rovit_kan_tpu_torch.data.resize import resize_image

    native.load()                          # the build is not timed
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (src_size, src_size, 3), np.uint8)
            for _ in range(n)]
    out = {"n": n, "src": src_size, "dst": image_size}
    t0 = time.perf_counter()
    for a in imgs:
        resize_image(a, image_size)
    out["numpy_images_per_s"] = n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for a in imgs:
        native.resize_batch([a], image_size, n_threads=1)
    out["engine_per_image_images_per_s"] = n / (time.perf_counter() - t0)
    for nt in threads:
        t0 = time.perf_counter()
        native.resize_batch(imgs, image_size, n_threads=nt)
        out[f"engine_batch_t{nt}_images_per_s"] = (
            n / (time.perf_counter() - t0))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", type=Path, default=DEFAULT_OUT)
    p.add_argument("--scales", type=int, nargs="+", default=[4000, 20000],
                   help="cache-build sizes (total images)")
    p.add_argument("--src_size", type=int, default=384,
                   help="stored JPEG resolution (the resize's source)")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--rounds", type=int, default=2,
                   help="rounds of the two arms, in turns")
    p.add_argument("--micro_n", type=int, default=200,
                   help="images in the resize micro-benchmark")
    p.add_argument("--workers", type=int, default=1,
                   help="threads that write the tree and build the cache "
                        "(1: the JAX script's sequential build)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; returns the record it writes."""
    args = parse_args(argv)
    from rovit_kan_tpu_torch.config import get_config
    cfg = get_config()
    class_names = cfg.data.class_names
    result = {"host_cpus": os.cpu_count(),
              "affinity_cpus": len(os.sched_getaffinity(0)),
              "src_size": args.src_size, "image_size": args.image_size,
              "micro_resize": micro_resize(args.src_size, args.image_size,
                                           n=args.micro_n)}
    print(json.dumps(result["micro_resize"]), flush=True)
    for total in args.scales:
        per_class = total // len(class_names)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp) / "imgs"
            t0 = time.perf_counter()
            make_jpeg_tree(root, class_names, per_class, args.src_size,
                           workers=args.workers)
            rec = {"tree_write_s": time.perf_counter() - t0, "rounds": []}
            for r in range(args.rounds):
                # Alternate which arm goes first, so neither always runs
                # on the other's warmed caches.
                arms = ("engine", "numpy") if r % 2 == 0 else (
                    "numpy", "engine")
                rnd = {arm: time_cache_build(root, class_names,
                                             cfg.data.severity_map,
                                             args.image_size, arm,
                                             args.workers)
                       for arm in arms}
                rnd["engine_speedup"] = (rnd["numpy"]["wall_s"]
                                         / rnd["engine"]["wall_s"])
                rec["rounds"].append(rnd)
                print(json.dumps({"images": total, "round": r, **rnd}),
                      flush=True)
            result[f"cache_build_{total}"] = rec
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=2))
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
