#!/usr/bin/env python3
"""Every dilated conv of DeepLab-ASPP and DeepLab-v2 ASPP-L on one CUDA
card, each pass (forward, input gradient, weight gradient) timed in both
forms: cuDNN's direct dilated conv and the conv by phases (d x d undilated
convs, ``ops/conv.py`` ``conv_by_phases`` and ``dilated_backward``).

    python tools/dilated_convs.py [--out build/dilated_convs.json]

Shapes, bf16 NHWC with f32 accumulation, at KITTI's inference size (the
padded 376x1248 frame: 47x156 at 1/8, 24x78 at 1/16) and at the training
crop (320x1152: 40x144 at 1/8, 20x72 at 1/16): DeepLab-ASPP's conv6 (7x7
at d4 at output stride 8, d2 at 16, 512 -> 512) and its ASPP rates 6, 12
and 18 (512 -> 256) at both strides, stage 5 at output stride 8 (3x3 at d2,
512 -> 512; DeepLab-v2's stage 5 too), and DeepLab-v2 ASPP-L's fc6 branches
at rates 6, 12, 18 and 24 (512 -> 1024). For each shape and batch: each
pass's device ms in each form (CUDA events: mean of 5 calls after a warm-up
call, or one more call where the warm-up took over 25 ms), which form
``ops.conv.dilated_form`` picks for the pass, marked "(not the
faster)" where the other form was faster and "LOSES" where by more than
max(10 %, 0.3 ms); then the picked forward and backward through
``conv_nhwc`` (``DilatedConv``), timed, and the passes it counted in
``DILATED_PASSES``. Prints the card's name and power limit first and the
counter's totals and the rows that lose last. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name, Cin, Cout, kernel, dilation, output stride
CONVS = (("stage5 os8", 512, 512, 3, 2, 8),
         ("conv6 os8", 512, 512, 7, 4, 8),
         ("conv6 os16", 512, 512, 7, 2, 16),
         ("aspp rate6 os8", 512, 256, 3, 6, 8),
         ("aspp rate12 os8", 512, 256, 3, 12, 8),
         ("aspp rate18 os8", 512, 256, 3, 18, 8),
         ("aspp rate6 os16", 512, 256, 3, 6, 16),
         ("aspp rate12 os16", 512, 256, 3, 12, 16),
         ("aspp rate18 os16", 512, 256, 3, 18, 16),
         ("aspp-l fc6_6", 512, 1024, 3, 6, 8),
         ("aspp-l fc6_12", 512, 1024, 3, 12, 8),
         ("aspp-l fc6_18", 512, 1024, 3, 18, 8),
         ("aspp-l fc6_24", 512, 1024, 3, 24, 8))
# the map at each output stride: a padded inference frame, a training crop
SIZES = {"infer": {8: (47, 156), 16: (24, 78)},
         "train": {8: (40, 144), 16: (20, 72)}}
BATCHES = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)
PASSES = ("forward", "input_grad", "weight_grad")
FORMS = ("direct", "phases")


def events_ms(torch, fn, iters: int = 5, slow_ms: float = 25.0) -> float:
    """Device ms of one ``fn()``: a warm-up call, then the mean of ``iters``
    calls, or one call where the warm-up took over ``slow_ms``."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    n = 1 if a.elapsed_time(b) > slow_ms else iters
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def loses(pick_ms: float, other_ms: float) -> bool:
    """The picked form slower than the other by more than max(10 %, 0.3 ms)."""
    return pick_ms - other_ms > max(0.1 * other_ms, 0.3)


def verdict(r: dict) -> str:
    """A pass's two times, the form picked and whether it was the faster."""
    pick, other = r["picks"], "phases" if r["picks"] == "direct" else "direct"
    mark = ("" if r[pick] <= r[other] else " (not the faster)"
            + (" LOSES" if loses(r[pick], r[other]) else ""))
    return (f"direct {r['direct']:.4f} / phases {r['phases']:.4f}, picks "
            f"{pick}{mark}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=os.path.join(REPO, "build",
                                                 "dilated_convs.json"))
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from semanticsegmentation_tensorflow_tpu_torch.ops import conv

    if not torch.cuda.is_available():
        print("dilated_convs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | torch {torch.__version__} cudnn {torch.backends.cudnn.version()}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result: dict = {"device": smi, "rows": []}
    lost = []
    counted0 = conv.DILATED_PASSES.copy()
    for size, maps in SIZES.items():
        for name, ci, co, k, d, stride in CONVS:
            h, w = maps[stride]
            pad = d * (k - 1) // 2
            wt = (torch.randn(co, ci, k, k, generator=gen, device="cuda")
                  / (ci * k * k) ** 0.5).bfloat16()
            for n in BATCHES:
                x = torch.randn(n, h, w, ci, generator=gen, device="cuda").bfloat16()
                gy = torch.randn(n, h, w, co, generator=gen, device="cuda").bfloat16()
                run = {
                    ("forward", "direct"): lambda: F.conv2d(
                        x.permute(0, 3, 1, 2), wt, padding=pad, dilation=d),
                    ("forward", "phases"): lambda: conv.conv_by_phases(
                        x, wt, pad, pad, d)}
                for form in FORMS:
                    for i, pass_ in enumerate(PASSES[1:]):
                        mask = (i == 0, i == 1)
                        run[pass_, form] = (
                            lambda form=form, mask=mask: conv.dilated_backward(
                                form, x, wt, gy, pad, pad, d, mask))
                row = {"size": size, "conv": name, "shape": [n, h, w, ci], "cout": co,
                       "k": k, "d": d}
                with torch.no_grad():
                    for pass_ in PASSES:
                        r = {form: events_ms(torch, run[pass_, form]) for form in FORMS}
                        r["picks"] = conv.dilated_form(pass_, n, h, wt.shape, d)
                        row[pass_] = r
                        other = "phases" if r["picks"] == "direct" else "direct"
                        if loses(r[r["picks"]], r[other]):
                            lost.append(f"{size} {name} n{n} {pass_}")
                xg, wg = x.detach().requires_grad_(), wt.detach().requires_grad_()

                def picked():
                    y = conv.conv_nhwc(xg, wg, dtype=torch.bfloat16, padding=pad,
                                       dilation=d)
                    torch.autograd.grad(y, (xg, wg), gy)

                before = conv.DILATED_PASSES.copy()
                picked()
                row["counted"] = {f"{a}/{b}": v for (a, b), v in
                                  (conv.DILATED_PASSES - before).items()}
                row["picked_ms"] = events_ms(torch, picked)
                result["rows"].append(row)
                print(f"{size} {name} [{n},{h},{w},{ci}] -> {co}, {k}x{k} d{d} | "
                      + " | ".join(f"{pass_} {verdict(row[pass_])}" for pass_ in PASSES)
                      + f" | picked forward + backward {row['picked_ms']:.4f} ms, "
                      f"counted {row['counted']}", flush=True)
                del x, gy, xg
    counted = conv.DILATED_PASSES - counted0
    result["counted"] = {f"{a}/{b}": v for (a, b), v in sorted(counted.items())}
    result["loses"] = lost
    print(f"DILATED_PASSES over the run: {result['counted']}")
    print(f"rows where the pick loses by more than max(10 %, 0.3 ms): "
          f"{len(lost)} {lost} | {smi}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
