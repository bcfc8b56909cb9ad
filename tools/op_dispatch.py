#!/usr/bin/env python3
"""Host cost of calling the port's kernels as registered torch ops, on one
CUDA card.

    python tools/op_dispatch.py [--calls 2000] [--out build/op_dispatch.json]

For each ``segport::`` op (``ops/cuda/library.py``) at a small shape, where
the kernel's device time is far below the host's work per call: host µs per
call through the wrapper (the op: the dispatcher, then the op's CUDA
implementation) against the CUDA implementation called directly (the launch
path the wrapper took before the kernels were ops), in turns op, direct,
direct, op, each the mean of ``--calls`` calls after 200 warm-up calls and
ending in a synchronize; under ``torch.inference_mode`` (the Predictor's)
and with autograd on. SegNet's pool and unpool also through their autograd
Functions (``MaxPoolArgmax``, ``MaxUnpool``), as the model calls them.
Prints a table with the card's name and power limit and the torch version,
and writes JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases(torch):
    """name -> (through the op, the CUDA implementation directly)."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import (
        overlay as ov, pool, stage1, winograd as wg,
    )

    dev = dict(device="cuda")
    z1 = torch.randn(1, 8, 64, 64, **dev).bfloat16()
    k2 = torch.randn(64, 64, 3, 3, **dev).bfloat16()
    b2 = torch.randn(64, **dev).bfloat16()
    x = torch.randn(1, 8, 16, 64, **dev).bfloat16()
    pooled, idx = pool.pool_argmax(x)
    img = torch.zeros(1, 8, 16, 3, dtype=torch.uint8, **dev)
    logits = torch.randn(1, 8, 16, 2, **dev)
    pal = torch.zeros(2, 3, **dev)
    wx = torch.randn(1, 8, 16, 64, **dev).bfloat16()
    u = wg.u_for(torch.randn(64, 64, 3, 3, **dev), "f2", torch.bfloat16)
    wb = torch.randn(64, **dev).bfloat16()
    return {
        "stage1_tail": (lambda: stage1.stage1_tail(z1, k2, b2),
                        lambda: stage1._stage1_tail_cuda(z1, k2, b2)),
        "stage1_tail_segnet": (lambda: stage1.stage1_tail_segnet(z1, k2, b2),
                               lambda: stage1._stage1_tail_segnet_cuda(z1, k2, b2)),
        "pool_argmax": (lambda: pool.pool_argmax(x), lambda: pool._pool_argmax_cuda(x)),
        "pool_argmax via MaxPoolArgmax": (lambda: pool.MaxPoolArgmax.apply(x), None),
        "unpool": (lambda: pool.unpool(pooled, idx),
                   lambda: pool._unpool_cuda(pooled, idx)),
        "unpool via MaxUnpool": (lambda: pool.MaxUnpool.apply(pooled, idx), None),
        "overlay": (lambda: ov.argmax_colormap_overlay_cuda(img, logits, pal, 0.5),
                    lambda: ov._overlay_cuda(img, logits, pal, 0.5, False)),
        "winograd_fwd": (lambda: wg.winograd_fwd(wx, u, wb, None, "f2", "bias_relu"),
                         lambda: wg._winograd_fwd_cuda(wx, u, wb, None, "f2",
                                                       "bias_relu")),
    }


def per_call_us(torch, fn, calls: int) -> float:
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "op_dispatch.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("op_dispatch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    build.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    res = {}
    for mode in ("inference_mode", "autograd on"):
        ctx = torch.inference_mode if mode == "inference_mode" else torch.enable_grad
        with ctx():
            for name, (op, direct) in cases(torch).items():
                turns = {"op": [], "direct": []}
                for who in ("op", "direct", "direct", "op"):
                    fn = op if who == "op" else direct
                    if fn is not None:
                        turns[who].append(per_call_us(torch, fn, args.calls))
                res[f"{mode} {name}"] = turns
    print(f"host us per call, op vs its CUDA implementation directly ({smi}; torch "
          f"{torch.__version__}); turns op, direct, direct, op; {args.calls} calls")
    for key, t in res.items():
        print(f"  {key}: op " + " ".join(f"{v:.1f}" for v in t["op"])
              + ("" if not t["direct"] else
                 ", direct " + " ".join(f"{v:.1f}" for v in t["direct"])))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "calls": args.calls,
                   "turns": ["op", "direct", "direct", "op"], "us": res}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
