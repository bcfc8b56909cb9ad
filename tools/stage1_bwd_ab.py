#!/usr/bin/env python3
"""Kernels 1b's and 1c's backward and the stage1 forward (kernels 1, 3 and
1c's forward) of two checkouts of the port, timed in turns on one CUDA card.

    python tools/stage1_bwd_ab.py --base DIR [--steps] [--out chiprun_out/stage1_bwd_ab.json]

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive``), this one is the change. At the
training shape [8,320,1152,64] (``chip_smoke.TRAIN_SHAPE``), on seeded
inputs, each checkout's kernels time by CUDA events (10 calls after two
warm-ups) the 1b backward (``stage1_tail_bwd``) and the 1c backward
(``stage1_tail_halo_bwd`` over the whole image, -inf halo rows), and by
torch.profiler the device time of each launch of the 1b backward (dgrad,
wgrad, sum); with ``--steps`` also the FCN and SegNet preset train steps
(``tools/profile_train.py``'s ``preset`` and ``segnet`` workloads by its
``time_train``: host ms per step and device ms per step, 8 steps each).
The forward rows time, by torch.profiler's device time per call, the
training forward with codes (``stage1_tail_train``, kernel 1) and SegNet's
(``stage1_tail_segnet``, kernel 3) at the training shape, the inference
forward (``stage1_tail``) and SegNet's at the inference shape
[1,384,1248,64] (``INFER_SHAPE``), and 1c's forward with codes
(``stage1_tail_halo`` over the whole image, -inf halo rows) at the training
shape; beside them their bounds (``fwd_work``) and a yardstick,
``cudnn_fwd``: cuDNN's bf16 channels_last ``F.conv2d`` of the same relu(z1)
without bias, which computes less than the kernels (no pool, bias or relu)
and writes the full-resolution conv output instead.
Each checkout runs in a process of its own (its own kernel
build under its ``build/``), in turns base, change, change, base; a
checkout's time is the mean of its turns. Beside them, in this
process: the plain version of 1b (autograd through the bf16 plain forward,
cuDNN's convs, the backward ``packed_stage1=False`` trains with), cuDNN's
weight gradient and data gradient of the same conv on the same dz2 (and
relu(z1)) in bf16 (``aten.convolution_backward``, output mask (False, True,
False) and (True, False, False); the data gradient without the relu' mask),
and the bounds of the wgrad and the dgrad (``chip_smoke.bound``: the wgrad's
217 GFLOP over 989 TFLOP/s against its 613 MB over 3.35 TB/s; the dgrad's
991 MB, dz1 written included, against the same GFLOP). Prints a table with
each launch's TFLOP/s and share of its bound, and writes JSON. Imports
nothing of JAX. ``launch_times``, ``cudnn_wgrad``, ``cudnn_dgrad``,
``dgrad_work``, ``cudnn_fwd`` and ``fwd_work`` are also what
``chip_smoke.py`` reads the backward's launches, the yardsticks and the
dgrad's and the forward's bounds with.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 320, 1152, 64)
INFER_SHAPE = (1, 384, 1248, 64)  # one KITTI image, padded


def events_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` in ms by CUDA events around
    ``iters`` calls back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(torch, shape=SHAPE):
    """Seeded inputs at ``shape`` on the card: z1 (with b1 for 1b, without
    for 1c), k2, b1, the pooled gradient g and the training forward's out
    and codes (from the plain forward, so both checkouts route alike)."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        stage1_tail_codes_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w, c = shape

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)

    z1, b1 = rand((n, h, w, c), 1.0), rand((c,), 0.5)
    k2 = rand((c, c, 3, 3), (1.0 / (9 * c)) ** 0.5).contiguous(
        memory_format=torch.channels_last)
    b2, g = rand((c,), 0.1), rand((n, h // 2, w // 2, c), 1.0)
    zb = (z1 + b1).contiguous()
    out, codes = stage1_tail_codes_plain(zb, k2, b2)
    return dict(z1=z1, zb=zb, b1=b1, k2=k2, b2=b2, g=g, out=out, codes=codes)


def launch_times(by_op: dict) -> dict:
    """Device ms of the stage1 backward's launches (``dgrad``, ``wgrad``,
    ``sum``) from torch.profiler's ms by op name; a launch the profiler did
    not see is missing."""
    out = {}
    for op, ms in by_op.items():
        for key, name in (("dgrad", "dgrad"), ("wgrad_sum", "sum"), ("wgrad", "wgrad")):
            if f"stage1_{key}_kernel" in op:
                out[name] = out.get(name, 0.0) + ms
                break
    return out


def worker(root: str, steps: bool = False) -> dict:
    """The backward times of the checkout at ``root`` (ms); with ``steps``
    also its preset train steps."""
    sys.path[:0] = [root, os.path.join(REPO, "tools")]
    import torch

    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import stage1 as s1

    # after the port: profile_train puts the change's checkout first on the path
    from profile_train import profile_device

    assert os.path.abspath(s1.__file__).startswith(os.path.abspath(root))
    t = inputs(torch)
    n, h, w, c = SHAPE
    edge = torch.full((n, 1, w, c), float("-inf"), device="cuda", dtype=torch.bfloat16)
    zero = torch.zeros((n, 1, w // 2, c), device="cuda", dtype=torch.bfloat16)
    halos = s1.BwdHalos(zero, zero, zero, zero, zero.to(torch.uint8),
                        zero.to(torch.uint8), edge, edge)
    bwd = lambda: s1.stage1_tail_bwd(t["g"], t["out"], t["codes"], t["zb"], t["k2"])
    halo = lambda: s1.stage1_tail_halo_bwd(t["g"], t["out"], t["codes"], t["z1"],
                                           t["k2"], t["b1"], halos)
    res = {"1b": events_ms(torch, bwd), "1c": events_ms(torch, halo),
           **launch_times(profile_device(torch, bwd, 10)["by_op"])}
    fwd = {"fwd1_train": lambda: s1.stage1_tail_train(t["zb"], t["k2"], t["b2"]),
           "fwd3_train": lambda: s1.stage1_tail_segnet(t["zb"], t["k2"], t["b2"]),
           "fwd1c_train": lambda: s1.stage1_tail_halo(t["z1"], edge, edge, t["k2"],
                                                      t["b2"], t["b1"], "codes")}
    for k, fn in fwd.items():
        res[k] = profile_device(torch, fn, 10)["device_ms"]
    del t, edge, zero, halos, bwd, halo, fwd
    t = inputs(torch, INFER_SHAPE)
    fwd = {"fwd1_infer": lambda: s1.stage1_tail(t["zb"], t["k2"], t["b2"]),
           "fwd3_infer": lambda: s1.stage1_tail_segnet(t["zb"], t["k2"], t["b2"])}
    for k, fn in fwd.items():
        res[k] = profile_device(torch, fn, 10)["device_ms"]
    del t, fwd
    if steps:
        from profile_train import WORKLOADS, time_train, train_workload

        for name in ("preset", "segnet"):
            torch.cuda.empty_cache()
            wl = WORKLOADS[name]
            r = time_train(torch, train_workload(torch, wl), wl["n"], iters=8)
            res[f"{name}_host"], res[f"{name}_device"] = r["host_ms"], r["device_ms"]
    return res


def library(torch) -> dict:
    """In this process: 1b's plain version and cuDNN's weight and data
    gradients of the same conv, by CUDA events; cuDNN's forward conv at the
    training and inference shapes, by torch.profiler's device time."""
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]
    from profile_train import profile_device

    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import stage1 as s1

    t = inputs(torch)
    leaves = [x.detach().clone().requires_grad_() for x in (t["zb"], t["k2"], t["b2"])]
    ref_out = s1.stage1_tail_plain(*leaves)
    plain = events_ms(torch, lambda: torch.autograd.grad(ref_out, leaves, t["g"],
                                                        retain_graph=True))
    wgrad = cudnn_wgrad(torch, t["g"], t["out"], t["codes"], t["zb"], t["k2"])
    dgrad = cudnn_dgrad(torch, t["g"], t["out"], t["codes"], t["zb"], t["k2"])
    res = {"plain_1b": plain, "cudnn_wgrad": events_ms(torch, wgrad),
           "cudnn_dgrad": events_ms(torch, dgrad),
           "cudnn_fwd_train": profile_device(
               torch, cudnn_fwd(torch, t["zb"], t["k2"]), 10)["device_ms"]}
    del t, leaves, ref_out, wgrad, dgrad
    t = inputs(torch, INFER_SHAPE)
    res["cudnn_fwd_infer"] = profile_device(
        torch, cudnn_fwd(torch, t["zb"], t["k2"]), 10)["device_ms"]
    return res


def cudnn_fwd(torch, z1, k2):
    """The stage1 forward's yardstick: one PyTorch call (cuDNN's bf16
    ``F.conv2d``, channels_last) for the conv of the same relu(z1), without
    bias: a callable returning the NCHW view of the full-resolution conv.
    It computes less than the kernels (no pool, bias or relu) and writes the
    conv output that they keep in registers. z1 carries b1."""
    import torch.nn.functional as F

    y = torch.relu(z1).permute(0, 3, 1, 2)
    w = k2.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(y, w, padding=1)


def fwd_work(n: int, h: int, w: int, c: int, codes: bool = True
             ) -> tuple[float, float]:
    """Bytes and FLOPs of the stage1 forward at [n,h,w,c]: z1 (bf16) read
    once, the pooled out (bf16) and, with ``codes``, the codes (u8) written
    once, the bf16 weights and b2 read; the conv's multiply-adds, 2 FLOP
    each (the pool, bias and relu are not counted)."""
    nhwc = n * h * w * c
    return (2 * nhwc + (3 if codes else 2) * nhwc / 4 + 2 * 9 * c * c + 2 * c,
            2.0 * n * h * w * 9 * c * c)


def cudnn_wgrad(torch, g, out, codes, z1, k2):
    """One PyTorch call computing the backward's weight gradient (cuDNN's
    ``aten.convolution_backward``, output mask (False, True, False)) on the
    same routed dz2 and relu(z1) in bf16, NCHW views of channels_last
    tensors: a callable. z1 carries b1."""
    dz2 = _dz2_nchw(torch, g, out, codes)
    y = torch.relu(z1).permute(0, 3, 1, 2)
    w = k2.contiguous(memory_format=torch.channels_last)
    return lambda: torch.ops.aten.convolution_backward(
        dz2, y, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [False, True, False])


def _dz2_nchw(torch, g, out, codes):
    """The routed conv gradient dz2 in bf16, an NCHW view of NHWC."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import _route

    gr = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return _route(gr, codes).to(torch.bfloat16).permute(0, 3, 1, 2)


def cudnn_dgrad(torch, g, out, codes, z1, k2):
    """One PyTorch call computing the conv's data gradient (cuDNN's
    ``aten.convolution_backward``, output mask (True, False, False)) on the
    same routed dz2 and k2 in bf16: a callable returning the NCHW view of
    the unmasked dz1 first. The relu'(z1) mask is not applied (no one call
    fuses it); z1 gives only the input's shape."""
    dz2 = _dz2_nchw(torch, g, out, codes)
    x = z1.permute(0, 3, 1, 2)
    w = k2.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return lambda: torch.ops.aten.convolution_backward(
        dz2, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, False, False])


def dgrad_work(n: int, h: int, w: int, c: int) -> tuple[float, float]:
    """Bytes and FLOPs of the dgrad launch at [n,h,w,c]: z1 (bf16) and the
    pooled g, out (bf16) and codes (u8) read once, dz1 (bf16) written once,
    the bf16 weights read; the conv's multiply-adds, 2 FLOP each."""
    nhwc = n * h * w * c
    return 4 * nhwc + 5 * nhwc / 4 + 2 * 9 * c * c, 2.0 * n * h * w * 9 * c * c


# the forward rows: (shape, whether the launch writes codes)
FWD_ROWS = {"fwd1_train": (SHAPE, True), "fwd3_train": (SHAPE, True),
            "fwd1c_train": (SHAPE, True), "fwd1_infer": (INFER_SHAPE, False),
            "fwd3_infer": (INFER_SHAPE, True)}


def run_worker(root: str, steps: bool) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root]
                         + (["--steps"] if steps else []),
                         cwd=root, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"worker for {root} failed:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout (the parent)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "stage1_bwd_ab.json"))
    ap.add_argument("--steps", action="store_true",
                    help="also time the FCN and SegNet preset train steps")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.steps)))
        return 0
    import torch

    if not args.base:
        ap.error("--base is required")
    if not torch.cuda.is_available():
        print("stage1_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import bound, conv3x3_flops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    who = ["base", "change", "change", "base"]
    roots = {"base": os.path.abspath(args.base), "change": REPO}
    runs = {"base": [], "change": []}
    for w in who:
        runs[w].append(run_worker(roots[w], args.steps))
    lib = library(torch)
    n, h, w, c = SHAPE
    flops = conv3x3_flops(n, h, w, c)
    wb = bound(2 * n * h * w * c + 5 * n * h * w * c / 4 + 4 * 9 * c * c + 4 * c, flops)
    db = bound(*dgrad_work(n, h, w, c))

    def mean(who_, key):
        vals = [r[key] for r in runs[who_] if key in r]
        return sum(vals) / len(vals) if vals else None

    rows = {k: {who_: mean(who_, k) for who_ in ("base", "change")}
            for k in ("1b", "1c", "dgrad", "wgrad", "sum", *FWD_ROWS, "preset_host",
                      "preset_device", "segnet_host", "segnet_device")
            if any(k in r for rs in runs.values() for r in rs)}
    print(f"stage1 backward at {list(SHAPE)} and forward, change {REPO} vs base "
          f"{roots['base']} ({smi}); turns {' '.join(who)}; "
          "ms (1b, 1c: CUDA events; launches and forwards: torch.profiler; steps "
          "per step, host clock and device sum)")
    for k, v in rows.items():
        print(f"  {k}: " + ", ".join(
            f"{who_} {ms:.4f} (turns " + " ".join(f"{r[k]:.4f}" for r in runs[who_] if k in r)
            + ")" if ms is not None else f"{who_} not measured" for who_, ms in v.items()))
    print(f"  plain 1b (autograd through cuDNN) {lib['plain_1b']:.4f}; cuDNN weight "
          f"gradient {lib['cudnn_wgrad']:.4f}, data gradient (unmasked) "
          f"{lib['cudnn_dgrad']:.4f}")
    for k, b in (("wgrad", wb), ("dgrad", db)):
        print(f"  {k} bound {b['bound_ms']:.4f} ({b['bound_by']}); " + ", ".join(
            f"{who_} {flops / ms / 1e9:.1f} TFLOP/s, {100 * b['bound_ms'] / ms:.1f} % "
            "of the bound" for who_, ms in rows[k].items() if ms))
    fwd_bounds = {}
    for k, (shape, codes) in FWD_ROWS.items():
        if k not in rows:
            continue
        nbytes, fl = fwd_work(*shape, codes=codes)
        b = fwd_bounds[k] = bound(nbytes, fl)
        lib_ms = lib["cudnn_fwd_" + k.rsplit("_", 1)[1]]
        print(f"  {k} at {list(shape)}: bound {b['bound_ms']:.4f} ({b['bound_by']}, "
              f"{nbytes / 1e6:.1f} MB, {fl / 1e9:.1f} GFLOP); " + ", ".join(
                  f"{who_} {fl / ms / 1e9:.1f} TFLOP/s, {100 * b['bound_ms'] / ms:.1f} % "
                  "of the bound" for who_, ms in rows[k].items() if ms)
              + f"; yardstick cuDNN conv only (no pool, bias, relu; writes the "
              f"full-resolution output) {lib_ms:.4f}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "turns": who, "runs": runs, "rows": rows, **lib,
                   "wgrad_bound": wb, "dgrad_bound": db, "fwd_bounds": fwd_bounds},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
