#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one CUDA card.

    python tools/profile_train.py [--iters 5] [--top 15] [--workloads a,b] \
        [--out chiprun_out/profile_train.json]

Six workloads, each with seeded random weights and a uint8 batch
resident on the card, Adam 1e-4 (FCN-8s and DeepLab with dropout 0.5):

- ``preset``: fcn8s_kitti (fc 1024), batch 8 of 384x1248, 320x1152 crops,
  train-time confusion matrix on (what ``scripts/train.py`` runs);
- ``bench``: bench.py's workload (fc 4096, batch 16, 384x1248, flip only,
  loss only);
- ``segnet``: segnet_kitti (SegNet, full width), batch 8 of 384x1248,
  320x1152 crops, metrics on;
- ``deeplab`` and ``deeplab_os16``: deeplab_kitti_dp (DeepLab-ASPP at output
  stride 8) and deeplab_kitti_os16, batch 16 of 384x1248, 320x1152 crops,
  metrics on; for these the device time of the convs also goes by kernel
  size and dilation (``conv_ms_by_dilation``: the dilated convs' share).

- ``unet``: unet_cityscapes (U-Net, 19 classes), batch 8 of 512x1024,
  256x512 crops, metrics on;

and five Winograd forms of them: ``preset_f2`` (``winograd="f2"``),
``segnet_f2``, ``segnet_f4``, ``bench_fc6`` (``winograd_fc6=True``) and
``unet_f2``.

For each of the six workloads, two builds of the same weights in turns
kernel, plain, plain, kernel: "kernel" (the stage1 training forward and
backward kernels, for SegNet the SegNet stage1 forward and the argmax
pool/unpool kernels, and the preprocess kernel) and "plain" (stage1 as cuDNN convs and a max pool, for
SegNet a ConvBlock and the pool/unpool plain versions, and the preprocess
kernel's plain version); for a Winograd form, "winograd" (the flag on,
kernel 6 on the routed layers) and "direct" (the flag off), both with the
kernels. It prints the host ms per step (mean of
``--iters``, after two warm-up steps), then, from one run of ``--iters``
steps under torch.profiler, the device ms (summed over ops) and ops per
step, the device's busy ms (the union of the ops' intervals), the wall per
step of that same run and the idle share (1 - busy / wall); then the
kernel build's device time by op name, largest first, by group
(convolutions and GEMMs, the port's kernels, the optimizer, the rest), and
the device time of each conv op's kernels with the op's input shapes
(which conv takes the time). The same numbers go to ``--out`` as JSON.
Imports nothing of JAX.

``train_workload`` and ``time_train`` are also what ``chip_smoke.py``
times training with.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from functools import partial
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from semanticsegmentation_tensorflow_tpu_torch.models.registry import (  # noqa: E402
    quant_safe_kwargs,
)

MEAN, STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)
WORKLOADS = {
    "preset": dict(fc=1024, n=8, crop=(320, 1152), metrics=True,
                   what="fcn8s_kitti preset (fc 1024, batch 8, 384x1248 -> "
                        "320x1152 crops, metrics on)"),
    "bench": dict(fc=4096, n=16, crop=None, metrics=False,
                  what="bench.py workload (fc 4096, batch 16, 384x1248, flip "
                       "only, loss only)"),
    "segnet": dict(model="segnet", n=8, crop=(320, 1152), metrics=True,
                   what="segnet_kitti preset (SegNet, batch 8, 384x1248 -> "
                        "320x1152 crops, metrics on)"),
}
WORKLOADS["deeplab"] = dict(model="deeplab", n=16, crop=(320, 1152), metrics=True,
                           what="deeplab_kitti_dp preset (DeepLab-ASPP os8, batch 16, "
                                "384x1248 -> 320x1152 crops, metrics on)")
WORKLOADS["deeplab_os16"] = dict(WORKLOADS["deeplab"], base_kw={"output_stride": 16},
                                 what="deeplab_kitti_os16 preset (DeepLab-ASPP os16, "
                                      "batch 16, 384x1248 -> 320x1152 crops, "
                                      "metrics on)")
# U-Net on Cityscapes (unet_cityscapes): 19 classes, batch 8 of 512x1024,
# 256x512 crops
WORKLOADS["unet"] = dict(model="unet", n=8, hw=(512, 1024), classes=19,
                         crop=(256, 512), metrics=True,
                         what="unet_cityscapes preset (U-Net, 19 classes, batch 8, "
                              "512x1024 -> 256x512 crops, metrics on)")
# the Winograd forms: the workload named by "base" with these model flags,
# timed against the same workload without them
WINOGRAD_FORMS = {
    "preset_f2": ("preset", {"winograd": "f2"}),
    "segnet_f2": ("segnet", {"winograd": "f2"}),
    "segnet_f4": ("segnet", {"winograd": "f4"}),
    "bench_fc6": ("bench", {"winograd_fc6": True}),
    "unet_f2": ("unet", {"winograd": "f2"}),
}
WORKLOADS.update({name: dict(WORKLOADS[base], model_kw=kw,
                             what=f"{WORKLOADS[base]['what']}, {kw}")
                  for name, (base, kw) in WINOGRAD_FORMS.items()})
# SegNet as published: BatchNorm after every conv (use_bn; no fused stage1)
WORKLOADS["segnet_bn"] = dict(WORKLOADS["segnet"], base_kw={"use_bn": True},
                              what=WORKLOADS["segnet"]["what"] + ", use_bn")
# the preset with its forward recomputed in the backward (train.remat)
WORKLOADS["preset_remat"] = dict(WORKLOADS["preset"], remat=True,
                                 what=WORKLOADS["preset"]["what"] + ", remat")
# the preset under the quant-safe kwargs (every conv a module: no fused
# stage1), and quantization-aware training on them (train.py --qat: the
# activation scales calibrated on two of the batch's images)
WORKLOADS["preset_quant_safe"] = dict(
    WORKLOADS["preset"], model_kw=quant_safe_kwargs("fcn8s"),
    what=WORKLOADS["preset"]["what"] + ", quant-safe kwargs")
WORKLOADS["preset_qat"] = dict(WORKLOADS["preset_quant_safe"], qat=True,
                               what=WORKLOADS["preset"]["what"] + ", --qat")


@contextlib.contextmanager
def plain_pools():
    """Within it, SegNet's argmax pools and unpools run their plain PyTorch
    versions (differentiable, the same function and gradients) on any
    device instead of the kernels: the plain build of the kernel-vs-plain
    comparisons. Nothing on the port's own path uses it."""
    from semanticsegmentation_tensorflow_tpu_torch.models import segnet
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
        pool_argmax_plain, unpool_plain,
    )

    with mock.patch.object(segnet, "max_pool_with_argmax",
                           lambda x, window=2: pool_argmax_plain(x)), \
            mock.patch.object(segnet, "max_unpool",
                              lambda p, idx, window=2: unpool_plain(p, idx)):
        yield


def in_plain_pools(fn):
    """``fn`` wrapped to run inside :func:`plain_pools`."""
    def call(*args, **kwargs):
        with plain_pools():
            return fn(*args, **kwargs)
    return call


def busy_ms(intervals: list[tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals: the time at
    least one of them was running."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_device(torch, fn, iters: int) -> dict:
    """``fn()`` ``iters`` times under torch.profiler, after one warm-up
    call. Per call: ``device_ms``, the summed durations of every GPU op
    (kernels, copies); ``busy_ms``, the time at least one of them ran (less
    than the sum where ops overlap); ``ops``; ``by_op``, device ms by op
    name; and ``wall_ms``, the host clock over the same profiled calls,
    ending in a synchronize.

    torch.profiler has lost every device event of a session on the H100, at
    random after tens to hundreds of short sessions in one process. A
    session that sees no device op is run again, twice at most; then the
    calls are timed by CUDA events instead: ``device_ms`` and ``busy_ms``
    are the events' time per call (host gaps between calls included),
    ``ops`` 0, ``by_op`` empty and ``events_only`` True."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with warnings.catch_warnings(), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("ignore")  # "clears events at each cycle"
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        by_op: dict[str, float] = defaultdict(float)
        spans = []
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_op[e.name] += e.self_device_time_total / 1e3 / iters
                spans.append((e.time_range.start, e.time_range.end))
        if spans:
            return {"device_ms": sum(by_op.values()),
                    "busy_ms": busy_ms(spans) / 1e3 / iters,
                    "ops": len(spans) // iters, "by_op": dict(by_op),
                    "wall_ms": wall, "events_only": False}
    print("profile_device: torch.profiler saw no device op in 3 sessions; "
          "timing by CUDA events (host gaps included, no per-op split)", flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    ms = start.elapsed_time(end) / iters
    return {"device_ms": ms, "busy_ms": ms, "ops": 0, "by_op": {},
            "wall_ms": wall, "events_only": True}


def idle_share(busy_ms: float, wall_ms: float) -> float | None:
    """1 - busy / wall of one profiled run; None (unresolved) where the
    device's busy time exceeds the wall, which a clock mismatch between the
    two would make."""
    return None if busy_ms > wall_ms else 1 - busy_ms / wall_ms


def show_idle(share: float | None) -> str:
    return ("unresolved (device busy > wall, or no profiler events)"
            if share is None else f"{share:.4f}")


def train_workload(torch, wl: dict, packed: bool = True, weights=None,
                   model_kw: dict | None = None):
    """A train step of no arguments for workload ``wl`` (a ``WORKLOADS``
    entry) on the card: FCN-8s at fc width ``wl["fc"]`` (or the model
    ``wl["model"]`` names, with ``wl["base_kw"]``) with the model flags
    ``model_kw`` (default ``wl["model_kw"]``, if any), seeded random
    weights (or ``weights``, a state dict), Adam 1e-4, dropout 0.5, a batch
    of ``wl["n"]`` uint8 images of ``wl["hw"]`` (default 384x1248) with
    labels of ``wl["classes"]`` (default 2) resident on the card, flip and
    ``wl["crop"]`` by the preprocess kernel (``packed``) or its plain
    version (stage1 then as cuDNN convs and a max pool, SegNet's pools and
    unpools their plain versions; U-Net has neither); ``wl["qat"]``: the
    model in quantization-aware training (``infer.quant.fake_quantize``)."""
    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.data.augment import Augment
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
        make_preprocess_augment_fn, preprocess_normalize_plain,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.state import (
        create_train_state, make_lr_schedule, make_optimizer,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

    dev = torch.device("cuda")
    name = wl.get("model", "fcn8s")
    classes, (h, w) = wl.get("classes", 2), wl.get("hw", (384, 1248))
    kw = {"fc_features": wl["fc"]} if name == "fcn8s" else {}
    if name != "unet":          # the models with a fused stage1
        kw["packed_stage1"] = packed
    kw.update(wl.get("base_kw", {}))
    kw.update(wl.get("model_kw", {}) if model_kw is None else model_kw)
    model = build_model(name, classes, device=dev, **kw)
    if weights is None:
        init_params(model, torch.Generator(device=dev).manual_seed(0))
    else:
        model.load_state_dict(weights)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 256, (wl["n"], h, w, 3), np.uint8)).to(dev),
             "label": torch.from_numpy(rng.integers(
                 0, classes, (wl["n"], h, w)).astype(np.int32)).to(dev)}
    if wl.get("qat"):
        from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
            normalize_images,
        )
        from semanticsegmentation_tensorflow_tpu_torch.infer import quant

        calib = [normalize_images(batch["image"][:2], MEAN, STD)]
        quant.fake_quantize(model, quant.calibrate_act_scales(model, calib))
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-4),
                               make_lr_schedule(1e-4), seed=0)
    aug = (make_preprocess_augment_fn(MEAN, STD, wl["crop"]) if packed
           else Augment(partial(preprocess_normalize_plain, crop_hw=wl["crop"],
                                mean=MEAN, std=STD), wl["crop"], True))
    step = partial(make_train_step(classes, augment_fn=aug,
                                   with_metrics=wl["metrics"],
                                   remat=wl.get("remat", False)),
                   state, batch)
    return in_plain_pools(step) if name == "segnet" and not packed else step


def time_train(torch, step, n: int, iters: int) -> dict:
    """Steady-state numbers of ``step()`` on ``n`` images: after two warm-up
    steps, ``iters`` steps on the host clock (ending in a synchronize):
    ``host_ms`` per step, ``images_per_s``, ``peak_gib`` of device memory
    and the last ``loss``; then one profiled run of ``iters`` steps:
    ``device_ms``, ``busy_ms``, ``ops``, ``by_op`` per step, its own
    ``profiled_wall_ms`` and the ``idle_share`` (None: unresolved)."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / iters
    r = {"host_ms": host, "images_per_s": n / host * 1e3,
         "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
         "loss": out["loss"].item()}
    prof = profile_device(torch, step, iters)
    r.update(device_ms=prof["device_ms"], busy_ms=prof["busy_ms"], ops=prof["ops"],
             by_op=prof["by_op"], profiled_wall_ms=prof["wall_ms"],
             idle_share=None if prof["events_only"]
             else idle_share(prof["busy_ms"], prof["wall_ms"]))
    return r


def group(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("stage1_", "preprocess_kernel", "pool_argmax",
                              "unpool", "winograd_")):
        return "port kernels"
    if any(k in low for k in ("conv", "cudnn", "xmma", "cutlass", "gemm",
                              "wgrad", "dgrad", "fprop")):
        return "convolutions and GEMMs"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    return "elementwise, reductions, copies"


def conv_kernels_by_shape(torch, fn) -> dict[str, float]:
    """Device ms of one ``fn()`` spent in the kernels of each conv op
    (forward or backward), keyed by op, input shapes and kernel name."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        warnings.simplefilter("ignore")
        fn()
        torch.cuda.synchronize()
    rows: dict[str, float] = defaultdict(float)
    for e in prof.events():
        if e.name in ("aten::cudnn_convolution", "aten::convolution_backward"):
            for k in e.kernels:
                rows[f"{e.name} {e.input_shapes[:2]} {k.name[:60]}"] += \
                    k.duration / 1e3
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]))


def conv_ms_by_dilation(torch, fn) -> dict:
    """Device ms of one ``fn()`` in its convolutions, forward and backward
    (each ``aten::convolution`` / ``aten::convolution_backward`` op with its
    children's kernels), keyed ``"fwd 3x3 d2"`` by pass, kernel size and
    dilation, largest first; ``dilated_ms`` and ``undilated_ms`` sum them."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=True) as prof:
        warnings.simplefilter("ignore")
        fn()
        torch.cuda.synchronize()
    rows: dict[str, float] = defaultdict(float)
    split = {"dilated_ms": 0.0, "undilated_ms": 0.0}
    for e in prof.events():
        # the op's arguments: the weight's shape, then its dilation
        at = {"aten::convolution": ("fwd", 1, 5),
              "aten::convolution_backward": ("bwd", 2, 6)}.get(e.name)
        if at is None:
            continue
        what, wi, di = at
        kh, kw = e.input_shapes[wi][2:4]
        dil = max(e.concrete_inputs[di])
        ms = getattr(e, "device_time_total", None)
        ms = (e.cuda_time_total if ms is None else ms) / 1e3
        rows[f"{what} {kh}x{kw} d{dil}"] += ms
        split["dilated_ms" if dil > 1 else "undilated_ms"] += ms
    return dict(split, by_kind=dict(sorted(rows.items(), key=lambda kv: -kv[1])))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--workloads", default=",".join(WORKLOADS),
                   help=f"comma-separated, of {list(WORKLOADS)}")
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "profile_train.json"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    result = {"device": smi, "iters": args.iters}
    for wname in args.workloads.split(","):
        wl = WORKLOADS[wname]
        steps, weights = {}, None
        forms = ((("winograd", True, None), ("direct", True, {}))
                 if "model_kw" in wl else
                 (("kernel", True, None), ("plain", False, None)))
        for form, packed, model_kw in forms:
            steps[form] = train_workload(torch, wl, packed, weights, model_kw)
            if weights is None:
                weights = steps[form].args[0].model.state_dict()
        first, second = forms[0][0], forms[1][0]
        runs = defaultdict(list)
        for form in (first, second, second, first):
            r = time_train(torch, steps[form], wl["n"], args.iters)
            by_op = r.pop("by_op")
            runs[form].append(r)
            print(f"{wname} {form}: {r['host_ms']:.2f} ms/step host, "
                  f"{r['images_per_s']:.1f} images/s; profiled: device "
                  f"{r['device_ms']:.2f} ms in {r['ops']} ops, busy "
                  f"{r['busy_ms']:.2f} ms, wall "
                  f"{r['profiled_wall_ms']:.2f} ms, idle share "
                  f"{show_idle(r['idle_share'])}", flush=True)
            if form == first:
                top = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:args.top])
                groups: dict[str, float] = defaultdict(float)
                for name, ms in by_op.items():
                    groups[group(name)] += ms
        convs = dict(list(conv_kernels_by_shape(torch, steps[first]).items())
                     [:args.top])
        result[wname] = {"runs": runs, f"{first}_by_op_ms": top,
                         f"{first}_by_group_ms": dict(groups),
                         f"{first}_conv_ms_by_shape": convs}
        if wl.get("model") == "deeplab":
            dil = conv_ms_by_dilation(torch, steps[first])
            result[wname][f"{first}_conv_ms_by_dilation"] = dil
            print(f"{wname}, {first} build, conv ms per step by kind: "
                  + json.dumps({k: round(v, 3) for k, v in dil["by_kind"].items()})
                  + f"; dilated {dil['dilated_ms']:.3f}, undilated "
                  f"{dil['undilated_ms']:.3f}")
        print(f"{wname}, {first} build, device ms per step by group: "
              + json.dumps({k: round(v, 3) for k, v in groups.items()}))
        for name, ms in top.items():
            print(f"  {ms:9.4f}  {name[:100]}")
        print(f"{wname}, {first} build, conv ops' kernels by input shapes:")
        for name, ms in convs.items():
            print(f"  {ms:9.4f}  {name[:140]}")
        del steps, weights
        torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
