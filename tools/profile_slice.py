#!/usr/bin/env python3
"""Where the time of the port's inference slice goes, on one CUDA card.

    python tools/profile_slice.py [--preset fcn8s_kitti] [--iters 30] \
        [--out chiprun_out/profile_slice.json]

At batch 1, the preset's image size and seeded random weights, it prints:

- the card's name and power limit;
- the host legs of a ``/segment`` request, each the median of ``--iters``:
  PNG decode, the numpy blend (``host_overlay``), PNG encode of the overlay
  and of the label map;
- for two builds of the same weights, "kernel" (stage1 through the
  stage1-tail kernel, the default) and "plain" (stage1 as cuDNN convs and
  a max pool), measured in turns kernel, plain, plain, kernel: the
  Predictor's overlay call and packed-label fetch on the host clock
  (median and best of ``--iters``), and the overlay call's device time,
  device ops and idle share from torch.profiler;
- the kernel build's overlay call, device time by op name, largest first.

The same numbers go to ``--out`` as JSON. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time
import warnings
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def host_ms(fn, iters: int) -> list[float]:
    fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def summary(ts: list[float]) -> dict:
    import numpy as np

    return {"median_ms": float(np.median(ts)), "best_ms": float(min(ts))}


def profile_device(torch, fn, iters: int) -> tuple[float, int, dict]:
    """Device ms per call, device ops per call, device ms per call by op."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("ignore")
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_op: dict[str, float] = defaultdict(float)
    n_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_op[e.name] += e.self_device_time_total / 1e3 / iters
            n_ops += 1
    if not n_ops:
        raise AssertionError("the profiler saw no device op")
    return sum(by_op.values()), n_ops // iters, dict(by_op)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="fcn8s_kitti")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                 "profile_slice.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts.serve import encode_png

    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_preset(args.preset)
    dc = cfg.data
    h, w = dc.image_size

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(np.stack([xx * 255 // w, yy * 255 // h,
                            (xx + yy) * 255 // (h + w)], -1)
                  + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)
    png = encode_png(img)

    preds = {}
    state = None
    for form, kw in (("kernel", {}), ("plain", {"packed_stage1": False})):
        model = build_model(cfg.model, num_classes=dc.num_classes, device=dev,
                            **dict(cfg.model_kwargs, **kw))
        if state is None:
            init_params(model, torch.Generator(device=dev).manual_seed(0))
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        preds[form] = Predictor(model, (h, w), device=dev, mean=dc.mean,
                                std=dc.std)

    labels = preds["kernel"]._fetch_labels(img[None])[0]
    pred = preds["kernel"]
    legs = {
        "png_decode": lambda: np.asarray(
            Image.open(io.BytesIO(png)).convert("RGB")),
        "host_overlay": lambda: host_overlay(img, labels, pred._palette,
                                             pred._alpha),
        "png_encode_overlay": lambda: encode_png(
            host_overlay(img, labels, pred._palette, pred._alpha)),
        "png_encode_labels": lambda: encode_png(
            np.repeat(labels.astype(np.uint8)[..., None], 3, -1)),
    }
    result = {"device": smi, "preset": args.preset, "iters": args.iters,
              "host_legs_ms": {k: summary(host_ms(f, args.iters))["median_ms"]
                               for k, f in legs.items()}}
    print("host legs of /segment, median ms: "
          + json.dumps(result["host_legs_ms"]), flush=True)

    runs = defaultdict(list)
    for form in ("kernel", "plain", "plain", "kernel"):
        pr = preds[form]
        call = summary(host_ms(lambda: pr(img), args.iters))
        fetch = summary(host_ms(lambda: pr._fetch_labels(img[None]),
                                args.iters))
        dev_ms, n_ops, by_op = profile_device(torch, lambda: pr(img),
                                              args.iters)
        run = {"overlay_call": call, "labels_fetch": fetch,
               "overlay_device_ms": dev_ms, "device_ops": n_ops,
               "idle_share": 1 - dev_ms / call["median_ms"]}
        runs[form].append(run)
        print(f"{form}: overlay call {call['median_ms']:.3f} ms median, "
              f"{call['best_ms']:.3f} best; labels fetch "
              f"{fetch['median_ms']:.3f} / {fetch['best_ms']:.3f}; device "
              f"{dev_ms:.4f} ms in {n_ops} ops, idle share "
              f"{run['idle_share']:.3f}", flush=True)
        if form == "kernel":
            result["kernel_by_op_ms"] = dict(sorted(
                by_op.items(), key=lambda kv: -kv[1])[:args.top])
    result["runs"] = runs
    print("kernel build, overlay call, device ms by op:")
    for name, ms in result["kernel_by_op_ms"].items():
        print(f"  {ms:9.4f}  {name[:90]}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
