#!/usr/bin/env python3
"""The train step's peak memory and time in two checkouts, in turns on one
CUDA card: by default the FCN preset with ``remat`` and without.

    python tools/remat_ab.py --base DIR [--workloads preset_remat,preset] \
        [--out build/remat_ab.json]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), this one is the change. Each turn
runs in a process of its own, importing that checkout's package and its
``tools/profile_train.py`` (``train_workload``, ``time_train``: two warm-up
steps, 8 steps on the host clock ending in a synchronize, peak device memory
over them, then one profiled run for the device time), in turns base,
change, change, base. Prints each workload's host ms per step, device ms per
step and peak GiB per turn with the card's name and power limit, and writes
JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(root: str, workloads: list[str]) -> dict:
    sys.path[:0] = [root, os.path.join(root, "tools")]
    import torch
    from profile_train import WORKLOADS, time_train, train_workload

    import semanticsegmentation_tensorflow_tpu_torch as pkg

    assert os.path.abspath(pkg.__file__).startswith(os.path.abspath(root))
    res = {}
    for name in workloads:
        wl = WORKLOADS[name]
        torch.cuda.empty_cache()
        step = train_workload(torch, wl)
        r = time_train(torch, step, wl["n"], iters=8)
        res[name] = {k: r[k] for k in ("host_ms", "device_ms", "peak_gib", "loss")}
        del step
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout (the parent)")
    ap.add_argument("--workloads", default="preset_remat,preset")
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "remat_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    workloads = args.workloads.split(",")
    if args.worker:
        print(json.dumps(worker(args.worker, workloads)))
        return 0
    import torch

    if not args.base:
        ap.error("--base is required")
    if not torch.cuda.is_available():
        print("remat_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    order = ["base", "change", "change", "base"]
    runs = {"base": [], "change": []}
    for who in order:
        root = os.path.abspath(args.base) if who == "base" else REPO
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              root, "--workloads", args.workloads], cwd=root,
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"worker for {root} failed:\n{out.stdout[-2000:]}\n"
                               f"{out.stderr[-4000:]}")
        runs[who].append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(f"train step, change {REPO} vs base {os.path.abspath(args.base)} ({smi}); "
          f"turns {' '.join(order)}")
    for name in workloads:
        for who in ("base", "change"):
            rs = [r[name] for r in runs[who]]
            print(f"  {name} {who}: host ms " + " ".join(f"{r['host_ms']:.2f}" for r in rs)
                  + ", device ms " + " ".join(f"{r['device_ms']:.2f}" for r in rs)
                  + ", peak GiB " + " ".join(f"{r['peak_gib']:.3f}" for r in rs))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "turns": order, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
