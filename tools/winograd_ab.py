#!/usr/bin/env python3
"""Kernel 6 of two checkouts of the port, timed in turns on one CUDA card.

    python tools/winograd_ab.py --base DIR [--turns 4] [--out chiprun_out/winograd_ab.json]
    python tools/winograd_ab.py --breakdown [--out ...]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), this one is the change. At every
Winograd conv shape of the FCN-8s and SegNet train steps
(``chip_smoke.WINOGRAD_TRAIN``), for f2 and f4, each checkout's kernel 6
times its three ops by CUDA events (5 calls after one warm-up, as
``chip_smoke.check_winograd``): ``fwd`` (the bias_relu forward), ``dgrad``
(the masked forward) and ``wgrad`` (dU and db). Each checkout runs in a
process of its own (its own kernel build under its ``build/``), in turns
base, change, change, base (``--turns 4``) or base, change (2); a
checkout's time is the mean of its turns. Beside them: cuDNN's time for the
same op (``F.conv2d`` with the bias; ``aten.convolution_backward`` for dx,
and for dw and db) and the bound (``chip_smoke.bound``: bytes of the inputs
and outputs over 3.35 TB/s, or the products over 989 TFLOP/s, the larger),
the change's TFLOP/s and share of the bound, and per train step of each
model the sums over its routed layers. Prints a table and writes JSON.
``--breakdown`` instead profiles this checkout's ops at two train shapes
and prints each kernel's device time (the transform pass, the products,
the sums). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("fwd", "dgrad", "wgrad")


def _inputs(torch, gen, shape, co, variant):
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw
    from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import rot180_swap

    def rand(s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    n, h, w, c = shape
    x = rand(shape).bfloat16()
    wt = rand((co, c, 3, 3), (1.0 / (9 * c)) ** 0.5)
    b = rand((co,), 0.1).bfloat16()
    g, o = rand((n, h, w, co)).bfloat16(), rand((n, h, w, co)).bfloat16()
    return dict(x=x, wt=wt, b=b, g=g, o=o,
                u=cw.u_for(wt, variant, torch.bfloat16),
                u2=cw.u_for(rot180_swap(wt), variant, torch.bfloat16))


def worker(root: str) -> dict:
    """The kernel ops' times of the checkout at ``root`` (ms by shape)."""
    sys.path[:0] = [root, REPO]
    import torch

    from chip_smoke import WINOGRAD_TRAIN, cuda_ms
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw

    assert os.path.abspath(cw.__file__).startswith(os.path.abspath(root))
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for variant in ("f2", "f4"):
        for shape, co, *_ in WINOGRAD_TRAIN:
            t = _inputs(torch, gen, shape, co, variant)
            fns = {"fwd": lambda: cw.winograd_fwd(t["x"], t["u"], t["b"], None, variant,
                                                  "bias_relu"),
                   "dgrad": lambda: cw.winograd_fwd(t["g"], t["u2"], None, t["o"], variant,
                                                    "none"),
                   "wgrad": lambda: cw.winograd_wgrad(t["x"], t["g"], t["o"], variant)}
            for op, fn in fns.items():
                times[f"{variant} {list(shape)}->{co} {op}"] = cuda_ms(fn, iters=5, warmup=1)
            del t
        torch.cuda.empty_cache()
    return times


def breakdown(torch, shapes) -> dict:
    """Device time of each kernel of one call of each op (the change's), by
    torch.profiler, mean of 5 calls: which pass takes the time."""
    from torch.profiler import ProfilerActivity, profile

    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for variant in ("f2", "f4"):
        for shape, co in shapes:
            t = _inputs(torch, gen, shape, co, variant)
            fns = {"fwd": lambda: cw.winograd_fwd(t["x"], t["u"], t["b"], None, variant,
                                                  "bias_relu"),
                   "dgrad": lambda: cw.winograd_fwd(t["g"], t["u2"], None, t["o"], variant,
                                                    "none"),
                   "wgrad": lambda: cw.winograd_wgrad(t["x"], t["g"], t["o"], variant)}
            for op, fn in fns.items():
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                by = {}
                for evt in prof.key_averages():
                    us = getattr(evt, "device_time_total", None)
                    if us is None:
                        us = evt.cuda_time_total
                    if us > 0:
                        found = re.search(r"(winograd_\w+|\w*elementwise\w*)", evt.key)
                        name = found.group(1) if found else evt.key[:60]
                        by[name] = by.get(name, 0.0) + us / 5e3
                key = f"{variant} {list(shape)}->{co} {op}"
                out[key] = by
                print(f"  {key}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                               sorted(by.items(), key=lambda kv: -kv[1])))
            del t
    torch.cuda.empty_cache()
    return out


def library(torch) -> dict:
    """cuDNN's time for each op at each train shape (ms)."""
    import torch.nn.functional as F

    from chip_smoke import WINOGRAD_TRAIN, cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for shape, co, *_ in WINOGRAD_TRAIN:
        t = _inputs(torch, gen, shape, co, "f2")
        xc = t["x"].permute(0, 3, 1, 2)
        gc = (t["g"] * (t["o"] > 0)).permute(0, 3, 1, 2)
        wc = t["wt"].bfloat16().contiguous(memory_format=torch.channels_last)
        conv_bwd = torch.ops.aten.convolution_backward
        fns = {"fwd": lambda: F.conv2d(xc, wc, t["b"], padding=1),
               "dgrad": lambda: conv_bwd(gc, xc, wc, None, [1, 1], [1, 1], [1, 1], False,
                                         [0, 0], 1, [True, False, False]),
               "wgrad": lambda: conv_bwd(gc, xc, wc, None, [1, 1], [1, 1], [1, 1], False,
                                         [0, 0], 1, [False, True, True])}
        for op, fn in fns.items():
            times[f"{list(shape)}->{co} {op}"] = cuda_ms(fn, iters=5, warmup=1)
        del t, xc, gc, wc
    torch.cuda.empty_cache()
    return times


def run_worker(root: str) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                         cwd=root, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"worker for {root} failed:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout (the parent)")
    ap.add_argument("--turns", type=int, default=4, choices=(2, 4))
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "winograd_ab.json"))
    ap.add_argument("--breakdown", action="store_true",
                    help="only the change's device time by kernel, at the first and "
                         "the seventh train shape")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("winograd_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.breakdown:
        sys.path.insert(0, REPO)
        from chip_smoke import WINOGRAD_TRAIN

        print("kernel 6 device ms by kernel (torch.profiler, mean of 5 calls):")
        shapes = [WINOGRAD_TRAIN[i][:2] for i in (0, 6)]
        by = breakdown(torch, shapes)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(by, f, indent=1)
        return 0
    if not args.base:
        ap.error("--base is required")
    sys.path.insert(0, REPO)
    from chip_smoke import WINOGRAD_TRAIN, bound, winograd_work

    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    order = ["base", "change"] if args.turns == 2 else ["base", "change", "change", "base"]
    roots = {"base": os.path.abspath(args.base), "change": REPO}
    runs = {"base": [], "change": []}
    for who in order:
        runs[who].append(run_worker(roots[who]))
    lib = library(torch)

    def mean(who, key):
        return sum(r[key] for r in runs[who]) / len(runs[who])

    rows, steps = [], {}
    print(f"kernel 6, base {roots['base']} vs change {roots['change']} ({smi}); ms by "
          f"CUDA events, turns {' '.join(order)}")
    for variant in ("f2", "f4"):
        for shape, co, n_fcn, n_seg in WINOGRAD_TRAIN:
            for op in OPS:
                key = f"{variant} {list(shape)}->{co} {op}"
                nbytes, flops = winograd_work(variant, shape, co, op)
                bd = bound(nbytes, flops)
                row = dict(key=key, base_ms=mean("base", key), ms=mean("change", key),
                           library_ms=lib[f"{list(shape)}->{co} {op}"], **bd)
                row["tflops"] = flops / row["ms"] / 1e9
                row["of_bound"] = bd["bound_ms"] / row["ms"]
                rows.append(row)
                print(f"  {key}: change {row['ms']:.4f}, base {row['base_ms']:.4f}, cuDNN "
                      f"{row['library_ms']:.4f}, bound {bd['bound_ms']:.4f} "
                      f"({bd['bound_by']}); {row['tflops']:.1f} TFLOP/s, "
                      f"{100 * row['of_bound']:.1f} % of the bound")
                for model, count in (("fcn8s", n_fcn), ("segnet", n_seg)):
                    acc = steps.setdefault(f"{model} {variant}", dict.fromkeys(
                        ("ms", "base_ms", "library_ms", "bytes", "flops"), 0.0))
                    for k, v in (("ms", row["ms"]), ("base_ms", row["base_ms"]),
                                 ("library_ms", row["library_ms"]), ("bytes", nbytes),
                                 ("flops", flops)):
                        acc[k] += count * v
    for name, acc in steps.items():
        acc.update(bound(acc.pop("bytes"), acc.pop("flops")))
        print(f"per {name} train step: change {acc['ms']:.4f} ms, base "
              f"{acc['base_ms']:.4f}, cuDNN {acc['library_ms']:.4f}, bound "
              f"{acc['bound_ms']:.4f}")
    slower = [r["key"] for r in rows if r["ms"] > r["base_ms"]]
    print(f"ops slower than the base: {slower or 'none'}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "turns": order, "rows": rows, "steps": steps}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
