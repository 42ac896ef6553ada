#!/usr/bin/env python
"""Time the port's bf16 block kernels #1-#4 from several checkouts of the
repo on one card, each run in a process of its own, in the order given
(parent, change, change, parent), so two versions are compared within one
call on one card.

    python scripts/ab_block_kernels.py --widths small,d256,d512,base \\
        PARENT CHANGE CHANGE PARENT

Each argument is a checkout's root (its ``chip_smoke.py`` and
``rovit_kan_tpu_torch/``). Every checkout's block libraries
(``csrc/vit_block_fwd.cu``, ``csrc/vit_block_bwd.cu``) are built first,
one ``nvcc`` each, all started together, into that checkout's own build
directory. A run is ``chip_smoke.py``'s ``check_preset_blocks`` at each
width of ``PRESET_BLOCKS`` named (its seed as in the smoke): the holds
against the plain versions, and each kernel's CUDA-event time beside its
bound. Prints one JSON line a run, then the card's name and power limit;
exits 1 if a build or a hold fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SOURCES = ("vit_block_fwd", "vit_block_bwd")
BUILD = ("import sys; from rovit_kan_tpu_torch.ops import _build; "
         "_build.build(sys.argv[1:])")
RUN = """
import json, sys
import chip_smoke
names = list(chip_smoke.PRESET_BLOCKS)
out = {}
for p in sys.argv[1:]:
    r = chip_smoke.check_preset_blocks(p, seed=30 + names.index(p))
    out[p] = {k: {f: v[f] for f in ("shape", "kernel_ms", "bound_ms",
                                     "max_abs_err")}
              for k, v in r.items()}
print(json.dumps(out))
"""


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--widths", default="small,d256,d512,base",
                   help="chip_smoke.PRESET_BLOCKS names, comma-separated")
    p.add_argument("roots", nargs="+", help="checkout roots, in run order")
    args = p.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    builds = {r: subprocess.Popen([sys.executable, "-c", BUILD, *SOURCES],
                                  cwd=r) for r in dict.fromkeys(roots)}
    if any(b.wait() for b in builds.values()):
        print("ab_block_kernels: a build failed", file=sys.stderr)
        return 1
    for i, root in enumerate(roots):
        run = subprocess.run([sys.executable, "-c", RUN,
                              *args.widths.split(",")], cwd=root,
                             stdout=subprocess.PIPE, text=True)
        if run.returncode:
            print(f"ab_block_kernels: run {i} in {root} failed",
                  file=sys.stderr)
            return 1
        print(json.dumps({"run": i, "root": root,
                          **json.loads(run.stdout.splitlines()[-1])}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
