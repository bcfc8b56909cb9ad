#!/usr/bin/env python3
"""The 2-rank grid step of ``chip_smoke.py`` (``check_grid``: data 1 x
spatial 2, two gloo ranks sharing one CUDA card, fcn8s_kitti at 384x1248) in
two checkouts, timed in turns.

    python tools/grid_ab.py --base DIR [--out build/grid_ab.json]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), this one is the change. Each turn
runs in a process of its own, in turns base, change, change, base, and calls
that checkout's ``check_grid``, which holds the grid step against the
single-process step and reports ms per step and the profiled shares of the
halo exchange and the gradient all-reduce. The kernel library this checkout
built is copied into the base's ``build/kernels/`` first when the base has
none (the file name carries the hash of the kernel sources, so a base with
other sources builds its own). Prints each turn's line with the card's name
and power limit and writes JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, os, subprocess, sys, tempfile
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "tools")]
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
assert chip_smoke.REPO == root, chip_smoke.REPO
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
with tempfile.TemporaryDirectory() as tmp:
    r = chip_smoke.check_grid(torch, tmp, smi)
print("RESULT " + json.dumps(r), flush=True)
"""


def turn(root: str) -> dict:
    """One ``check_grid`` of the checkout at ``root``, in a fresh process."""
    p = subprocess.run([sys.executable, "-c", TURN, root], capture_output=True,
                       text=True)
    for line in p.stdout.splitlines():
        if line.startswith("grid"):
            print(line, flush=True)
    if p.returncode:
        print(p.stderr[-3000:], file=sys.stderr, flush=True)
        raise SystemExit(f"check_grid in {root} exited with {p.returncode}")
    return json.loads([ln for ln in p.stdout.splitlines()
                       if ln.startswith("RESULT ")][-1][7:])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", required=True)
    p.add_argument("--out", default=os.path.join(REPO, "build", "grid_ab.json"))
    args = p.parse_args(argv)
    base = os.path.abspath(args.base)
    sys.path.insert(0, REPO)
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    build.lib()
    dst = os.path.join(base, "build", "kernels")
    if not glob.glob(os.path.join(dst, "*.so")):
        os.makedirs(dst, exist_ok=True)
        shutil.copy(build.library_path(), dst)
    turns = []
    for name, root in (("base", base), ("change", REPO), ("change", REPO),
                       ("base", base)):
        print(f"--- {name}: {root}", flush=True)
        turns.append({"turn": name, **turn(root)})
    for name in ("base", "change"):
        ms = [t["grid_ms"] for t in turns if t["turn"] == name]
        print(f"{name}: {' / '.join(f'{v:.2f}' for v in ms)} ms/step")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(turns, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
