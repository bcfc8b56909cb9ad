#!/usr/bin/env python3
"""DeepLab-ASPP's and DeepLab-v2 ASPP-L's dilated convs on one CUDA card:
cuDNN's direct dilated conv against the same conv by phases
(``models/common.py`` ``conv_by_phases``, d x d undilated convs), by batch,
and the training shapes' backward by pass.

    python tools/dilated_convs.py [--out build/dilated_convs.json]

For each dilated conv of DeepLab at KITTI's padded size (output stride 8:
376x1248, so 47x156 at 1/8; stride 16: 24x78 at 1/16), bf16 NHWC with
f32 accumulation: the forward's device ms (CUDA events, mean of 5 after 2
warm-up calls, under ``inference_mode``) at batch 1, 2, 3, 4, 8 and 16,
direct (``F.conv2d(..., dilation=d)``) and by phases, which was faster
and which form ``models.common.by_phases`` picks (marked where that is not
the faster one). Then at the training shapes (320x1152 crops: 40x144 at
1/8, 20x72 at 1/16; ASPP-L's fc6 branches, 512 -> 1024 at rates 6-24, at
1/8) the forward with both gradients, direct and by phases, at batch 1, 2,
3, 4, 10 (``deeplab_v2_kitti``'s batch) and 16 (a data rank's batch of
``deeplab_kitti_dp``'s 16), with the same verdict; and at batch 10 and 16
the forward alone, the forward with the input gradient and the forward
with the weight gradient, direct, to show which pass is slow. Prints the card's name and power limit first. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name, H, W at the model's stride, Cin, Cout, kernel, dilation
INFER = (("conv6 os8", 47, 156, 512, 512, 7, 4),
         ("conv6 os16", 24, 78, 512, 512, 7, 2),
         ("stage5 os8", 47, 156, 512, 512, 3, 2),
         ("aspp rate6 os8", 47, 156, 512, 256, 3, 6),
         ("aspp rate12 os8", 47, 156, 512, 256, 3, 12),
         ("aspp rate18 os8", 47, 156, 512, 256, 3, 18),
         ("aspp rate18 os16", 24, 78, 512, 256, 3, 18))
TRAIN = (("conv6 os8", 40, 144, 512, 512, 7, 4),
         ("conv6 os16", 20, 72, 512, 512, 7, 2),
         ("aspp rate12 os8", 40, 144, 512, 256, 3, 12),
         ("aspp rate18 os8", 40, 144, 512, 256, 3, 18),
         ("aspp rate18 os16", 20, 72, 512, 256, 3, 18),
         ("aspp-l fc6_6", 40, 144, 512, 1024, 3, 6),
         ("aspp-l fc6_12", 40, 144, 512, 1024, 3, 12),
         ("aspp-l fc6_18", 40, 144, 512, 1024, 3, 18),
         ("aspp-l fc6_24", 40, 144, 512, 1024, 3, 24))
INFER_BATCHES = (1, 2, 3, 4, 8, 16)
TRAIN_BATCHES = (1, 2, 3, 4, 10, 16)
SPLIT_BATCHES = (10, 16)   # the presets' batches: each pass timed as well


def events_ms(torch, fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def verdict(r: dict) -> str:
    """Which form was faster here and which one ``by_phases`` picks."""
    faster = "phases" if r["phases_ms"] < r["direct_ms"] else "direct"
    return (f"faster {faster}, by_phases picks {r['picks']}"
            + ("" if faster == r["picks"] else " (not the faster)"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=os.path.join(REPO, "build",
                                                 "dilated_convs.json"))
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from semanticsegmentation_tensorflow_tpu_torch.models.common import (
        by_phases, conv_by_phases,
    )

    if not torch.cuda.is_available():
        print("dilated_convs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cudnn {torch.backends.cudnn.version()}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result: dict = {"device": smi, "infer": {}, "train": {}}
    with torch.inference_mode():
        for name, h, w, ci, co, k, d in INFER:
            pad = d * (k - 1) // 2
            wt = (torch.randn(co, ci, k, k, generator=gen, device="cuda")
                  / (ci * k * k) ** 0.5).bfloat16()
            for n in INFER_BATCHES:
                x = torch.randn(n, h, w, ci, generator=gen, device="cuda").bfloat16()
                r = {"direct_ms": events_ms(torch, lambda: F.conv2d(
                         x.permute(0, 3, 1, 2), wt, padding=pad, dilation=d)),
                     "phases_ms": events_ms(torch, lambda: conv_by_phases(
                         x, wt, pad, pad, d)),
                     "picks": "phases" if by_phases(n, h, wt.shape, d, False)
                     else "direct"}
                result["infer"][f"{name} n{n}"] = r
                print(f"{name} [{n},{h},{w},{ci}] -> {co}, {k}x{k} d{d}: direct "
                      f"{r['direct_ms']:.4f} ms, by phases {r['phases_ms']:.4f} ms; "
                      f"{verdict(r)}", flush=True)
    for name, h, w, ci, co, k, d in TRAIN:
        pad = d * (k - 1) // 2
        wt = (torch.randn(co, ci, k, k, generator=gen, device="cuda")
              / (ci * k * k) ** 0.5).bfloat16().requires_grad_()
        r = {}
        for n in TRAIN_BATCHES:
            x = torch.randn(n, h, w, ci, generator=gen, device="cuda").bfloat16()
            x.requires_grad_()
            gy = torch.randn(n, h, w, co, generator=gen, device="cuda").bfloat16()

            def direct(wrt=(x, wt)):
                y = F.conv2d(x.permute(0, 3, 1, 2), wt, padding=pad,
                             dilation=d).permute(0, 2, 3, 1)
                torch.autograd.grad(y, wrt, gy)

            def phases():
                torch.autograd.grad(conv_by_phases(x, wt, pad, pad, d), (x, wt), gy)

            row = {"direct_ms": events_ms(torch, direct, 3),
                   "phases_ms": events_ms(torch, phases, 3),
                   "picks": "phases" if by_phases(n, h, wt.shape, d, True)
                   else "direct"}
            if n in SPLIT_BATCHES:
                row.update(
                    fwd_ms=events_ms(torch, lambda: F.conv2d(
                        x.detach().permute(0, 3, 1, 2), wt.detach(), padding=pad,
                        dilation=d), 3),
                    fwd_dx_ms=events_ms(torch, lambda: direct([x]), 3),
                    fwd_dw_ms=events_ms(torch, lambda: direct([wt]), 3),
                    pass_bound_ms=2.0 * n * h * w * ci * co * k * k / 989e12 * 1e3)
            r[f"n{n}"] = row
            print(f"train {name} [{n},{h},{w},{ci}] -> {co}, {k}x{k} d{d}, forward + "
                  f"both gradients: direct {row['direct_ms']:.4f} ms, by phases "
                  f"{row['phases_ms']:.4f} ms; {verdict(row)}", flush=True)
            if n in SPLIT_BATCHES:
                print(f"train {name} [{n},{h},{w},{ci}] direct: forward "
                      f"{row['fwd_ms']:.4f} ms, forward + input gradient "
                      f"{row['fwd_dx_ms']:.4f}, forward + weight gradient "
                      f"{row['fwd_dw_ms']:.4f} (one pass's bound "
                      f"{row['pass_bound_ms']:.4f} ms at 989 TFLOP/s) | {smi}",
                      flush=True)
            del x, gy
        result["train"][name] = r
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
