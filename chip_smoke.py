#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``semanticsegmentation_tensorflow_tpu_torch/csrc``
into ``build/kernels/`` and checks each against its plain PyTorch version on
the card at the shapes its path gives it: the stage1 tail (inference and
training forward, backward), the preprocess kernel and the overlay, with
exact integer tie cases. Then it drives both of the port's paths at the full
width of the ``fcn8s_kitti`` preset, each with the launch counters set to 0
just before it and read just after:

* inference (seeded random weights, full KITTI resolution): ``infer_image``
  on a generated PNG, the ``serve`` handler answering requests, one forward
  at ``fcn8s_kitti_parity`` (fc 4096), then the whole forward with the
  kernels against plain PyTorch;
* the host IO of serving and the sweep (the port's native ``segio`` on this
  host, with no Python fallback: PNG encode against numpy + zlib and PIL,
  the LUT blend against the numpy blend, decode against PIL where libpng
  is there), then the test-set sweep through ``scripts/test.py`` over 16
  generated KITTI-like images at ``--batch 1``, ``--batch 8`` and
  ``--confidence --batch 8``, and ``segnet_kitti`` at ``--batch 8`` over 8,
  every file checked against the Predictor (its own counters per run);
* training: ``scripts/train.py`` for 3 steps on a generated synthetic KITTI
  set with ``--pallas-preprocess``, ``--resume``, and ``infer_image`` on the
  checkpoint; then one train step with the kernels against plain PyTorch,
  ten steps on a fixed batch (the loss must fall), and train timings at the
  preset and at bench.py's workload.

Then validated training and evaluation: ``scripts/train.py`` at
``fcn8s_kitti`` for one epoch with ``--val-frac 0.25 --keep-best``, scale
and color jitter, 2 decode workers, EMA and a strict import of a seeded
VGG16 archive, then ``scripts/eval.py --road-metrics`` on its checkpoint
(raw and ``--ema``) and at ``segnet_kitti``; the eval step with the kernels
against plain PyTorch on the trained weights.

Then the same two paths at the full width of the ``segnet_kitti`` preset
(SegNet), after the SegNet stage1 tail and the argmax pool/unpool kernels
are checked against their plain versions at the shapes SegNet gives them.
Then the Winograd paths, after kernel 6 is checked against its plain
version at every Winograd conv shape of both train steps and of a
full-resolution forward: FCN-8s with ``--model-kw winograd=f2`` through
infer_image, serve and train.py (3 steps, --resume), its logits against the
float32 direct model, and SegNet with ``winograd=f4`` (a Predictor call and
a train step).
Then kernel 1c (the halo mode of the stage1 tail, ``pallas_spmd``) against
its plain version at the training and inference shapes, whole and as two
halves with real halo rows, and beside kernels 1/1b; ``train.main --spatial
2`` at one rank for ``fcn8s_kitti`` and ``segnet_kitti`` (launches of the
halo kernels > 0, of the single-device stage1 kernels 0); the preset step
with 1c beside the default; and a 2-rank grid (data 1 x spatial 2, gloo on
cuda:0, this script re-run as ``--grid-rank``) at full ``fcn8s_kitti`` width
and 384x1248, two steps held against the single-process step.
Then DeepLab-ASPP (``deeplab_phase``): the kernels are also held against
their plain versions at the shapes DeepLab's paths give them (kernel 1 at
the os8 Predictor's [1,376,1248,64] and eval's [4,376,1248,64], kernels 1,
1b and 1c at batch 16's [16,320,1152,64], kernel 4 at [16,384,1248,3]);
both presets through infer_image, serve and the Predictor, the os8 forward
with the kernels against plain PyTorch, ``train.py`` at
``deeplab_kitti_dp`` (batch 16, ``--val-frac 0.25 --keep-best``, EMA, 3
steps, ``--resume``, infer_image on the checkpoint), one preset train step
with the kernels against plain PyTorch, ``eval.py --road-metrics`` (raw and
``--ema``) on the checkpoint and its eval step against plain PyTorch,
``deeplab_kitti_os16 --spatial 2`` at one rank, and both preset steps timed
with the dilated convs' device time.

Then U-Net on Cityscapes (``unet_phase``, ``unet_cityscapes``: 19 classes,
512x1024, full width): kernels 2, 4 and 6 held against their plain versions
at U-Net's shapes (the overlay at [1,512,1024] C=19, the preprocess kernel
at [8,512,1024,3] -> 256x512, kernel 6 at its 13 full-lane convs, f2);
infer_image, serve and the Predictor; ``scripts/test.py`` over 16 generated
val images; ``train.py --synthetic``, then validated training (3 steps of 8,
``--pallas-preprocess``, ``--resume``, infer_image) and ``eval.py`` on the
checkpoint; a train step with the kernels against plain PyTorch; the
``winograd=f2`` Predictor and train step; ``--spatial 2`` at one rank; the
preset step timed, direct and f2 in turns; and the 2-rank grid on 496 rows,
split unevenly (256 + 240) at U-Net's stride 16.

Then BatchNorm (``bn_phase``, ``segnet_kitti`` with ``use_bn=True`` at full
width): its train step with kernels 4 and 5 against plain PyTorch;
``train.py`` (3 steps, ``--resume``, infer_image), infer_image, serve and the
Predictor from that checkpoint, ``eval.py --tta --tta-scales
0.75,1.0,1.25`` on it; the 2-rank grid on 352 rows (192 + 160); the preset
step timed. Then TTA and tiles (``tta_tiled_phase``): ``infer_image
--tiled`` on a 1024x2048 frame at ``unet_cityscapes`` and a 750x2484 image at
``fcn8s_kitti``, ``eval.py --tta`` at ``fcn8s_kitti``, the TTA step at one
scale without flip against the eval step and one tile against the
Predictor. Then int8 serving, BatchNorm folding and quantization-aware
training (``int8_phase``): the int8 product against an exact float64 conv
of the same int8 tensors; ``fcn8s_kitti`` through ``infer_image --int8``,
serve ``--int8 --calib-dir``, ``test.py --int8 --calib 4`` (every file
against the int8 Predictor) and ``eval.py --int8 --calib-batches 2``;
``train.py --qat`` (3 steps, ``--pallas-preprocess``, ``--resume`` reading
back ``qat_scales.json``), then ``eval.py`` on its checkpoint with
``--int8`` (its QAT scales) and without (the QAT warning);
``segnet_kitti`` with ``use_bn`` (26 BatchNorms folded) and
``unet_cityscapes`` with ``--int8``; every quantized layer's int32
accumulator of three int8 Predictors held bit-equal; the int8 forward
against the fake-quant one and the folded SegNet against the unfolded one
in float32; the bf16 and int8 Predictors timed in turns and the QAT train
step beside the plain ones.
Then serving artifacts and per-stage remat (``export_phase``):
``scripts/export_model.py --platforms cuda`` at ``fcn8s_kitti``,
``segnet_kitti`` (symbolic batch), ``deeplab_kitti_dp`` (fixed batch) and
``fcn8s_kitti --int8 --calib-dir``, each artifact served by ``serve.py
--artifact`` (/segment and /labels equal to the in-process Predictor's
answer), its outputs bit-equal to the in-process Predictor's, the launches
of its own calls (kernels 1 and 2 at FCN and DeepLab, 3, 5 and 2 at SegNet)
> 0, export and load seconds, size, and device and host ms beside the
Predictor's; then the FCN preset step with ``remat`` (one recompute per
stage) beside the default, its peak device memory below the default's.

Any failure exits non-zero. The last three lines are the kernels' JSON
record (each kernel's launches on the paths, error against its plain
version, device times of the kernel, its plain version and the one PyTorch
call computing the same function where there is one (for the stage1
forward, a yardstick that computes less: cuDNN's conv alone), and the least
time the card could take for the work), the card's name and power limit, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "semanticsegmentation_tensorflow_tpu_torch"
IMAGE_HW = (375, 1242)      # KITTI road; the model sees it padded to 384x1248
PADDED_HW = (384, 1248)
DEEPLAB_OS8_HW = (376, 1248)  # KITTI padded to DeepLab's output stride 8
# PADDED_HW at TTA scales 0.75 and 1.25, rounded to stride 32 (infer/tta.py
# _scale_hw): the variants that eval.py --tta --tta-scales 0.75,1.0,1.25 runs
TTA_VARIANT_HW = ((288, 928), (480, 1568))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one ``fn()`` in ms, by CUDA events around ``iters``
    calls back to back. Where a call's host work (Python, launches) takes
    longer than its device work, this is the host's time per call."""
    import torch

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


def device_ms(fn, iters: int = 20) -> tuple[float, int]:
    """Device time of one ``fn()`` in ms: the summed duration of every GPU
    op it launches (kernels, copies), from torch.profiler, mean over
    ``iters`` calls; host launch cost excluded. Also the ops per call."""
    import torch
    from profile_train import profile_device

    prof = profile_device(torch, fn, iters)
    return prof["device_ms"], prof["ops"]


def ab_ms(plain, kernel) -> dict:
    """Kernel against plain, in turns (plain, kernel, kernel, plain): device
    time per call (the reported number) and event-timed wall per call."""
    p1, k1, k2, p2 = (device_ms(f)[0] for f in (plain, kernel, kernel, plain))
    w = [cuda_ms(f) for f in (plain, kernel, kernel, plain)]
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "wall_ms": (w[1] + w[2]) / 2, "plain_wall_ms": (w[0] + w[3]) / 2}


def show_ab(what: str, t: dict) -> None:
    log(f"{what}: device kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; "
        f"wall per call {t['wall_ms']:.4f} ms, plain {t['plain_wall_ms']:.4f} ms")


# H100 SXM peaks (NVIDIA's published figures): HBM bytes/s, dense
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float = 0.0,
          flop_rate: float = BF16_FLOP_PER_S) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``:
    the larger of the two times, and which one sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def conv3x3_flops(n: int, h: int, w: int, c: int) -> float:
    """2 FLOP per multiply-add of a 3x3 SAME conv, C -> C, on n x h x w."""
    return 2.0 * n * h * w * 9 * c * c


def forward_rate(torch, what: str, ms: float, z1, k2, codes: bool = True) -> dict:
    """The stage1 forward's TFLOP/s and share of its bound at z1's shape
    (``fwd_work``), beside its yardstick ``cudnn_fwd`` (cuDNN's conv of the
    same relu(z1) alone, by the same device clock): the row's bound and
    ``library_ms``. z1 carries b1."""
    from stage1_bwd_ab import cudnn_fwd, fwd_work

    nbytes, flops = fwd_work(*z1.shape, codes=codes)
    b = bound(nbytes, flops)
    lib = device_ms(cudnn_fwd(torch, z1, k2))[0]
    log(f"stage1 forward {what} at {list(z1.shape)}: {ms:.4f} ms, "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * b['bound_ms'] / ms:.1f} % of its bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); yardstick cuDNN conv only (no pool, "
        f"bias, relu; writes the full-resolution output) {lib:.4f} ms")
    return {"library_ms": lib, **b}


def check_stage1(torch, gen) -> dict:
    """Kernel A against its plain version: the slice's shape, small ragged
    shapes (odd batch, partial tiles, narrow channels) and an exact tie case.

    Tolerance (random cases): both versions accumulate in f32 and round the
    conv to bf16, in another order, so a conv value may differ by one bf16
    ulp (<= 2^-7 relative); the bf16 bias add may add one more. Bound:
    |kernel - plain| <= 2^-6 * (|plain| + |b2|) + 1e-6, element-wise."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        stage1_tail, stage1_tail_plain,
    )

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)

    def compare(n, h, w, c, what):
        z1 = rand((n, h, w, c), 1.0)
        # channels_last, as the Predictor's cast leaves the model's weights
        k2 = rand((c, c, 3, 3), (1.0 / (9 * c)) ** 0.5).contiguous(
            memory_format=torch.channels_last)
        b2 = rand((c,), 0.1)
        got = stage1_tail(z1, k2, b2).float()
        want = stage1_tail_plain(z1, k2, b2).float()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"stage1 {what}: bad output {tuple(got.shape)}")
        err = (got - want).abs()
        bound = 2 ** -6 * (want.abs() + b2.float().abs()) + 1e-6
        bad = int((err > bound).sum())
        log(f"stage1 {what} [{n},{h},{w},{c}]: max_abs_err {err.max().item():.6g}"
            f" (max |plain| {want.abs().max().item():.4g}), {bad} outside the bound")
        if bad:
            raise AssertionError(f"stage1 {what}: {bad} elements outside the bound")
        return z1, k2, b2, err.max().item()

    z1, k2, b2, main_err = compare(1, *PADDED_HW, 64, "main")
    # DeepLab at output stride 8 pads 375 rows to 376 (188 pooled rows)
    zd, kd, bd, dl_err = compare(1, DEEPLAB_OS8_HW[0], DEEPLAB_OS8_HW[1], 64,
                                 "DeepLab os8 Predictor")
    # and eval.py's batches of 4 at that height
    dl_err = max(dl_err, compare(4, *DEEPLAB_OS8_HW, 64, "DeepLab os8 eval")[3])
    # fcn8s_kitti's TTA eval (batches of 4 at 384x1248, scaled by 0.75 and
    # 1.25 to the stride) and its tiled path (3x3 tiles of 384x1248 in one
    # batch)
    for n, (h, w) in ((4, TTA_VARIANT_HW[0]), (4, TTA_VARIANT_HW[1]), (9, PADDED_HW)):
        main_err = max(main_err, compare(n, h, w, 64, "TTA / tiled")[3])
    compare(3, 12, 40, 64, "odd batch, partial tiles")
    compare(1, 6, 34, 16, "C=16")
    compare(1, 8, 64, 32, "C=32")
    compare(2, 10, 66, 48, "C=48")

    # integer-valued inputs: every sum is exact in f32 and in bf16's integer
    # range, so both versions must agree bit for bit, ties included
    ig = torch.Generator().manual_seed(1)
    zi = torch.randint(-2, 3, (2, 16, 48, 64), generator=ig).to("cuda", torch.bfloat16)
    ki = torch.randint(-1, 2, (64, 64, 3, 3), generator=ig)
    ki[:, :, 1] = ki[:, :, 0]          # repeated taps -> many pooling ties
    ki = ki.to("cuda", torch.bfloat16)
    bi = torch.randint(-1, 2, (64,), generator=ig).to("cuda", torch.bfloat16)
    got, want = stage1_tail(zi, ki, bi), stage1_tail_plain(zi, ki, bi)
    if not torch.equal(got, want):
        raise AssertionError("stage1 tie case: kernel != plain "
                             f"({int((got != want).sum())} elements)")
    log("stage1 integer tie case: exact")

    t = ab_ms(lambda: stage1_tail_plain(z1, k2, b2),
              lambda: stage1_tail(z1, k2, b2))
    show_ab(f"stage1 at [1,{PADDED_HW[0]},{PADDED_HW[1]},64]", t)
    td = ab_ms(lambda: stage1_tail_plain(zd, kd, bd),
               lambda: stage1_tail(zd, kd, bd))
    show_ab(f"stage1 at [1,{DEEPLAB_OS8_HW[0]},{DEEPLAB_OS8_HW[1]},64] (DeepLab os8)",
            td)
    # no one PyTorch call fuses the conv, pool, bias and relu: the yardstick
    # is cuDNN's conv alone; z1 in, the pooled bf16 out, the bf16 weights
    return {"max_abs_err": max(main_err, dl_err), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "deeplab_os8_ms": td["ms"],
            "deeplab_os8_plain_ms": td["plain_ms"],
            **forward_rate(torch, "(inference)", t["ms"], z1, k2, codes=False)}


# (batch, H, W, padded H, padded W, classes, alpha, blend_class0): the FCN
# Predictor's image and batch, 5 and 19 classes (the Cityscapes palette),
# and a ragged shape (W not a multiple of 4, H*W not of a warp's 128-pixel
# tile)
OVERLAY_CASES = ((1, *IMAGE_HW, *PADDED_HW, 2, 0.5, False),
                 (1, *IMAGE_HW, *PADDED_HW, 5, 0.7, True),
                 (8, *IMAGE_HW, *PADDED_HW, 2, 0.5, False),
                 (1, *IMAGE_HW, *PADDED_HW, 19, 0.5, True),
                 (2, 37, 1238, 64, 1248, 2, 0.5, False),
                 (2, 37, 1238, 64, 1248, 5, 0.7, True))


def check_overlay(torch, gen) -> dict:
    """Kernel B against its plain version at ``OVERLAY_CASES``: exact labels
    and exact bytes (the kernel rounds the blend like the plain version,
    without FMA). At the C=2 image and batch of 8, its device time beside the
    plain version's, the bound and a yardstick: a device-to-device ``copy_``
    of half the kernel's bytes (as many bytes read and written, nothing
    computed; no one PyTorch call computes the overlay)."""
    from overlay_ab import work

    from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
        CITYSCAPES_PALETTE, KITTI_OVERLAY_PALETTE,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
        argmax_colormap_overlay_cuda, argmax_colormap_overlay_plain,
    )

    result = {}
    for n, h, w, hp, wp, c, alpha, blend0 in OVERLAY_CASES:
        img = torch.randint(0, 256, (n, h, w, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
        logits = torch.randn((n, hp, wp, c), generator=gen, device="cuda")
        tie = torch.rand((n, hp, wp), generator=gen, device="cuda") < 0.1
        logits[..., 1] = torch.where(tie, logits[..., 0], logits[..., 1])
        pal = torch.as_tensor(KITTI_OVERLAY_PALETTE if c == 2
                              else CITYSCAPES_PALETTE[:c], device="cuda")
        ov_k, lab_k = argmax_colormap_overlay_cuda(img, logits, pal, alpha, blend0)
        ov_p, lab_p = argmax_colormap_overlay_plain(
            img, logits[:, :h, :w], pal, alpha, blend0)
        torch.cuda.synchronize()
        what = f"overlay C={c} [{n},{h},{w}] from [{n},{hp},{wp},{c}] logits"
        if not torch.equal(lab_k, lab_p):
            raise AssertionError(f"{what}: labels differ at "
                                 f"{int((lab_k != lab_p).sum())} pixels")
        err = (ov_k.int() - ov_p.int()).abs().max().item()
        if err:
            raise AssertionError(f"{what}: bytes differ (max {err})")
        log(f"{what}: labels and bytes exact ({int(tie[:, :h, :w].sum())} tied "
            "pixels injected)")
        if c == 2 and (h, w) == IMAGE_HW:
            t = ab_ms(
                lambda: argmax_colormap_overlay_plain(
                    img, logits[:, :h, :w], pal, alpha, blend0),
                lambda: argmax_colormap_overlay_cuda(img, logits, pal, alpha, blend0))
            src = torch.empty(work(n, h, w, c) // 2, dtype=torch.uint8, device="cuda")
            dst = torch.empty_like(src)
            copy = device_ms(lambda: dst.copy_(src))[0]
            b = bound(work(n, h, w, c))
            show_ab(f"overlay at [{n},{h},{w}], C=2", t)
            log(f"overlay at [{n},{h},{w}], C=2: {100 * b['bound_ms'] / t['ms']:.1f} % "
                f"of its bound {b['bound_ms']:.4f} ms ({work(n, h, w, c) / 1e6:.2f} MB); "
                f"yardstick copy_ of {work(n, h, w, c) / 2e6:.2f} MB {copy:.4f} ms")
            row = {"ms": t["ms"], "plain_ms": t["plain_ms"], **b, "copy_ms": copy}
            if n == 1:
                result.update(max_abs_err=float(err), library_ms=None, **row)
            else:
                result.update({f"b{n}_{k}": v for k, v in row.items()
                               if k != "bound_by"})
    return result


TRAIN_SHAPE = (8, 320, 1152, 64)   # fcn8s_kitti batch 8, 320x1152 crops
DEEPLAB_TRAIN_SHAPE = (16, 320, 1152, 64)   # deeplab_kitti_dp's batch 16
MEAN, STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)


def check_stage1_train(torch, gen) -> dict:
    """Kernel A's training variant and kernel 1b (the backward) on the
    card: the training shapes (FCN's and SegNet's batch 8, DeepLab's batch
    16), the ragged and narrow shapes of check_stage1, and exact integer tie
    cases.

    Forward: ``out`` equals the inference kernel's bit for bit; the codes
    equal the plain first-max codes except where the two conv values of a
    tie differ by the one bf16 ulp that check_stage1 allows (>= 99.9 %).

    Backward, random cases, against the f32 reference
    ``stage1_tail_bwd_plain`` (TF32 off) on the same (g, out, codes): both
    route identically and sum the same bf16 products in f32, in another
    order. dz1 is one bf16 rounding of a sum of 9*C products in both, so
    they may differ by one bf16 ulp (<= 2^-7 |ref|) where the two f32 sums
    straddle a rounding boundary, and near zero by the f32 order difference
    itself; bound 2^-7 |ref| + 2^-12 max |ref|. dk2 and db2 are f32 sums of
    up to N*H*W products; each add rounds by <= 2^-24 of the running sum,
    over chains of ~2000 adds at the training shape (a block's 262 tiles of
    8 mma steps, then the 88 partials; cuBLAS's own split in the
    reference): a random walk of a few 1e-6 of the largest element, 1.3e-5
    measured on an H100. Bound: 1e-4 max |ref|, element-wise (a kernel that
    lost 1 % of the pixels would be off by ~10 % of an element).

    Integer cases, at a shape where every block takes one tile and at one
    where each dgrad and wgrad block walks several: every sum is exact in
    f32, so the kernel equals the reference bit for bit (dz1, dk2, db2), and
    at the small shape the autograd Function equals autograd through the
    plain forward."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        Stage1Tail, stage1_tail, stage1_tail_bwd, stage1_tail_bwd_plain,
        stage1_tail_codes_plain, stage1_tail_plain, stage1_tail_train,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.tie_cases import (
        int_case, tie_windows,
    )

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)

    def inputs(n, h, w, c):
        return (rand((n, h, w, c), 1.0),
                rand((c, c, 3, 3), (1.0 / (9 * c)) ** 0.5).contiguous(
                    memory_format=torch.channels_last),
                rand((c,), 0.1), rand((n, h // 2, w // 2, c), 1.0))

    result = {}
    for n, h, w, c in (TRAIN_SHAPE, DEEPLAB_TRAIN_SHAPE, (3, 12, 40, 64),
                       (1, 6, 34, 16), (1, 8, 64, 32), (2, 10, 66, 48)):
        z1, k2, b2, g = inputs(n, h, w, c)
        out, codes = stage1_tail_train(z1, k2, b2)
        out_p, codes_p = stage1_tail_codes_plain(z1, k2, b2)
        if not torch.equal(out, stage1_tail(z1, k2, b2)):
            raise AssertionError("stage1 training forward: out differs from "
                                 "the inference kernel")
        agree = (codes == codes_p).float().mean().item()
        fwd_err = (out.float() - out_p.float()).abs().max().item()
        want = stage1_tail_bwd_plain(g, out_p, codes_p, z1, k2)
        got = stage1_tail_bwd(g, out_p, codes_p, z1, k2)
        errs = []
        for name, a, b, rel, near0 in zip(("dz1", "dk2", "db2"), got, want,
                                          (2 ** -7, 0.0, 0.0),
                                          (2 ** -12, 1e-4, 1e-4)):
            a, b = a.float(), b.float()
            err = (a - b).abs()
            bad = int((err > rel * b.abs() + near0 * b.abs().max()).sum())
            errs.append(err.max().item())
            if bad or not torch.isfinite(a).all():
                raise AssertionError(f"stage1 bwd [{n},{h},{w},{c}] {name}: {bad} "
                                     f"elements outside the bound")
        again = stage1_tail_bwd(g, out_p, codes_p, z1, k2)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("stage1 bwd: two runs differ")
        log(f"stage1 train [{n},{h},{w},{c}]: fwd max_abs_err {fwd_err:.6g}, codes "
            f"agree {100 * agree:.4f} %; bwd against the f32 reference: max_abs_err"
            f" dz1 {errs[0]:.6g} dk2 {errs[1]:.6g} db2 {errs[2]:.6g} (max |ref| "
            f"{[round(t.abs().max().item(), 4) for t in want]}), bit-identical rerun")
        if agree < 0.999:
            raise AssertionError(f"stage1 codes agree on only {agree:.6f}")
        if (n, h, w, c) == TRAIN_SHAPE:
            result = {"max_abs_err": max(errs), "dz1_err": errs[0],
                      "dk2_err": errs[1], "db2_err": errs[2]}
            # plain: autograd through the plain forward in bf16 (cuDNN), the
            # backward that packed_stage1=False trains with
            leaves = [t.detach().clone().requires_grad_() for t in (z1, k2, b2)]
            ref_out = stage1_tail_plain(*leaves)
            t = ab_ms(lambda: torch.autograd.grad(ref_out, leaves, g,
                                                  retain_graph=True),
                      lambda: stage1_tail_bwd(g, out_p, codes_p, z1, k2))
            show_ab(f"stage1 backward at {list(TRAIN_SHAPE)}", t)
            # g, out (bf16) and codes (u8) pooled, z1 in; dz1, dk2, db2 out;
            # dgrad and wgrad are a conv's worth of math each
            result.update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=None,
                          **bound(5 * n * h * w * c / 4 + 4 * n * h * w * c
                                  + 4 * 9 * c * c + 4 * c,
                                  2 * conv3x3_flops(n, h, w, c)))
            result.update(backward_by_launch(
                torch, lambda: stage1_tail_bwd(g, out_p, codes_p, z1, k2),
                g, out_p, codes_p, z1, k2))
            tf = ab_ms(lambda: stage1_tail_codes_plain(z1, k2, b2),
                       lambda: stage1_tail_train(z1, k2, b2))
            show_ab(f"stage1 training forward (with codes) at {list(TRAIN_SHAPE)}",
                    tf)
            fr = forward_rate(torch, "(training, codes)", tf["ms"], z1, k2)
            result.update(train_fwd_ms=tf["ms"], train_fwd_plain_ms=tf["plain_ms"],
                          train_fwd_library_ms=fr["library_ms"],
                          train_fwd_bound_ms=fr["bound_ms"])
            del leaves, ref_out
        del z1, k2, b2, g, out, codes, out_p, codes_p, want, got, again

    lib = build.lib()
    for n, h, w, c in ((2, 16, 48, 64), (8, 64, 256, 64)):
        tiles = n * -(-h // 4) * -(-w // 64)  # dgrad and wgrad tiles of 4x64 pixels
        parts = lib.seg_stage1_bwd_parts(n, h, w, c)
        for case in (tie_windows, int_case):
            z1, k2, b2 = (t.to("cuda", torch.bfloat16)
                          for t in case(n, h, w, c, 1))
            out, codes = stage1_tail_train(z1, k2, b2)
            out_p, codes_p = stage1_tail_codes_plain(z1, k2, b2)
            if not (torch.equal(out, out_p) and torch.equal(codes, codes_p)):
                raise AssertionError(f"stage1 {case.__name__}: forward not exact")
            if case is tie_windows and not bool((codes_p == 1).any()):
                raise AssertionError("the tie case holds no c = b > a window")
            cot = torch.randint(-3, 4, out.shape, generator=torch.Generator()
                                .manual_seed(2)).to("cuda", torch.bfloat16)
            got = stage1_tail_bwd(cot, out, codes, z1, k2)
            want = stage1_tail_bwd_plain(cot, out, codes, z1, k2)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"stage1 {case.__name__} [{n},{h},{w},{c}]: "
                                     "kernel gradients not exact")
            what = "the kernel against the f32 reference"
            if n == 2:
                leaves = [t.clone().requires_grad_() for t in (z1, k2, b2)]
                got = torch.autograd.grad(Stage1Tail.apply(*leaves), leaves, cot)
                want = torch.autograd.grad(stage1_tail_plain(*leaves), leaves, cot)
                if not all(torch.equal(a.float(), b.float())
                           for a, b in zip(got, want)):
                    raise AssertionError(f"stage1 {case.__name__}: gradients "
                                         "through the Function not exact")
                what += ", and through the autograd Function"
            log(f"stage1 {case.__name__} [{n},{h},{w},{c}] (integer, ties incl. "
                f"c = b > a; {tiles} dgrad and wgrad tiles over {parts} blocks): codes, out, "
                f"dz1, dk2, db2 exact, {what}")
        # each dgrad and wgrad block walks more tiles than its two stages
        if n == 8 and tiles <= 2 * parts:
            raise AssertionError(f"the multi-tile case gives {tiles} tiles "
                                 f"to {parts} blocks")
    return result


def backward_by_launch(torch, fn, g, out, codes, z1, k2, what: str = "1b") -> dict:
    """The device time of each launch of the stage1 backward ``fn`` (kernel
    1b, or 1c as ``what``; dgrad, wgrad, sum; torch.profiler, by kernel
    name) and, beside the dgrad and the wgrad, cuDNN's data and weight
    gradients of the same conv on the same dz2 (and relu(z1)) in bf16
    (``aten.convolution_backward``, output masks (True, False, False) and
    (False, True, False); the data gradient without the relu' mask), by the
    same device clock, with each launch's TFLOP/s and share of its bound.
    z1 carries b1."""
    from profile_train import profile_device
    from stage1_bwd_ab import cudnn_dgrad, cudnn_wgrad, dgrad_work, launch_times

    by = launch_times(profile_device(torch, fn, 10)["by_op"])
    lib_w = device_ms(cudnn_wgrad(torch, g, out, codes, z1, k2))[0]
    lib_d = device_ms(cudnn_dgrad(torch, g, out, codes, z1, k2))[0]
    n, h, wd, c = z1.shape
    flops = conv3x3_flops(n, h, wd, c)
    # wgrad: z1 and the pooled g, out, codes in; dk2, db2 out
    wb = bound(2 * n * h * wd * c + 5 * n * h * wd * c / 4 + 4 * 9 * c * c + 4 * c, flops)
    db = bound(*dgrad_work(n, h, wd, c))
    res = {"dgrad_ms": by.get("dgrad"), "library_dgrad_ms": lib_d,
           "dgrad_bound_ms": db["bound_ms"], "wgrad_ms": by.get("wgrad"),
           "library_wgrad_ms": lib_w}
    if "wgrad" not in by or "dgrad" not in by:
        log(f"stage1 backward {what} by launch: not measured (the profiler saw no "
            f"kernel); cuDNN data gradient {lib_d:.4f} ms, weight gradient {lib_w:.4f}")
        return res

    def rate(ms, b):
        return (f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * b['bound_ms'] / ms:.1f} % of "
                f"its bound {b['bound_ms']:.4f} ms ({b['bound_by']})")

    log(f"stage1 backward {what} at {list(z1.shape)} by launch (device ms): dgrad "
        f"{by['dgrad']:.4f}, wgrad {by['wgrad']:.4f}, sum "
        f"{by.get('sum', float('nan')):.4f}; cuDNN data gradient (unmasked) "
        f"{lib_d:.4f}, weight gradient {lib_w:.4f}; dgrad {rate(by['dgrad'], db)}; "
        f"wgrad {rate(by['wgrad'], wb)}")
    return res


def check_preprocess(torch, gen) -> dict:
    """Kernel 4 against its plain version: the grids' uncropped row shards,
    then [8,384,1248,3] and DeepLab's [16,384,1248,3] u8 batches, mixed
    flips and crop offsets, 320x1152 crops; the f32 bytes must be equal.
    Timed at batch 8."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
        preprocess_normalize, preprocess_normalize_plain,
    )

    # the grids' uncropped row shards: fcn8s_kitti's 192 + 192 rows of 8
    # images, unet_cityscapes' 256 + 240 of 4 at 1024, segnet_kitti use_bn's
    # 192 + 160 of 4 at 1248
    for n, h, w in ((8, 192, 1248), (4, 256, 1024), (4, 240, 1024), (4, 192, 1248),
                    (4, 160, 1248)):
        img = torch.randint(0, 256, (n, h, w, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
        flip = torch.tensor([True, False] * (n // 2))
        zero = torch.zeros(n, dtype=torch.int64)
        args = (img, flip, zero, zero, None, MEAN, STD)
        got, want = preprocess_normalize(*args), preprocess_normalize_plain(*args)
        torch.cuda.synchronize()
        if got.shape != (n, h, w, 3) or not torch.equal(got, want):
            raise AssertionError(f"preprocess at [{n},{h},{w},3] uncropped: kernel "
                                 "bytes differ from plain")
    log("preprocess at the grids' uncropped row shards, mixed flips: bytes exact")
    (h, w), crop = PADDED_HW, (320, 1152)
    for n in (16, 8):
        img = torch.randint(0, 256, (n, h, w, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
        flip = torch.tensor([True, False] * (n // 2))
        oy = torch.tensor([0, 64, 13, 37, 64, 1, 50, 0] * (n // 8))
        ox = torch.tensor([96, 0, 5, 71, 96, 0, 33, 60] * (n // 8)).roll(n // 8 - 1)
        args = (img, flip, oy, ox, crop, MEAN, STD)
        got, want = preprocess_normalize(*args), preprocess_normalize_plain(*args)
        torch.cuda.synchronize()
        if got.shape != (n, *crop, 3) or not torch.equal(got, want):
            raise AssertionError(f"preprocess at batch {n}: kernel bytes differ "
                                 "from plain")
        log(f"preprocess [{n},{h},{w},3] u8 -> [{n},{crop[0]},{crop[1]},3] f32, "
            "mixed flips and offsets: bytes exact")
    t = ab_ms(lambda: preprocess_normalize_plain(*args),
              lambda: preprocess_normalize(*args))
    show_ab(f"preprocess at [{n},{h},{w},3]", t)
    # the cropped u8 pixels in, f32 out; a subtract and a multiply each
    px = n * crop[0] * crop[1] * 3
    return {"max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
            **bound(px + 4 * px, 2 * px, F32_FLOP_PER_S), "library_ms": None}


def kitti_like(seed: int, hw=IMAGE_HW):
    """A [375, 1242, 3] (or ``hw``) u8 image: smooth structure plus noise,
    so the labels are not all one class."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 255 // w), (yy * 255 // h),
                     ((xx + yy) * 255 // (h + w))], -1)
    noise = rng.integers(-40, 41, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def write_png(path: str, seed: int, hw=IMAGE_HW) -> None:
    from PIL import Image

    Image.fromarray(kitti_like(seed, hw)).save(path)


HOST_ITERS = 20


def host_median_ms(fn, iters: int = HOST_ITERS) -> float:
    """Median host-clock ms of ``iters`` calls of ``fn`` after one warm-up."""
    import numpy as np

    fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def check_host_io() -> dict:
    """The port's native host IO (``native/segio.cpp``) on this machine's
    host, at one KITTI image (375x1242): it must load (no leg may pass on a
    Python fallback); each PNG encoder's output, decoded by PIL, equals its
    input; the LUT blend equals the numpy blend bit for bit (C=2, and C=19
    with ``blend_class0``); native decode equals PIL where segio was built
    with libpng, and raises saying why where it was not. Host-clock medians
    of ``HOST_ITERS`` calls: the native fixed-Huffman encode (what
    ``fastpng.encode_png`` runs at level 1), the numpy + zlib encode at
    level 1, PIL's encode at level 1 (what the server used before), the LUT
    blend and the numpy blend. Returns the numbers."""
    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch import native
    from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
        CITYSCAPES_PALETTE, KITTI_OVERLAY_PALETTE,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
        blend_numpy, host_overlay,
    )
    from semanticsegmentation_tensorflow_tpu_torch.utils.fastpng import (
        encode_png, encode_png_numpy,
    )

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"native segio did not load: {native.why_unavailable()}")
    res = {"segio_load_s": time.perf_counter() - t0,
           "segio_decode": native.decode_available()}
    log(f"host IO: segio loaded in {res['segio_load_s']:.2f} s (g++ build "
        f"included), decode {'built' if res['segio_decode'] else 'not built'}")
    img = kitti_like(seed=1)
    rng = np.random.default_rng(1)
    labels = (img[..., 1] > 160).astype(np.uint8)   # a road-like binary map
    overlay = host_overlay(img, labels, KITTI_OVERLAY_PALETTE)

    def pil_png(arr, level=1):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG", compress_level=level)
        return buf.getvalue()

    if encode_png(overlay) != native.encode_png(overlay, "fixed"):
        raise AssertionError("fastpng.encode_png did not run the native encoder")
    for name, fn in (("encode_native_fixed", lambda: encode_png(overlay)),
                     ("encode_numpy_zlib1", lambda: encode_png_numpy(overlay, 1)),
                     ("encode_pil_level1", lambda: pil_png(overlay))):
        data = fn()
        back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        if not np.array_equal(back, overlay):
            raise AssertionError(f"{name}: PIL decodes other pixels")
        res[f"{name}_ms"] = host_median_ms(fn)
        res[f"{name}_bytes"] = len(data)
        log(f"host IO {name}: {res[f'{name}_ms']:.3f} ms (median of "
            f"{HOST_ITERS}), {len(data)} bytes, round trip exact")
    for nc, palette, blend0 in ((2, KITTI_OVERLAY_PALETTE, False),
                                (19, CITYSCAPES_PALETTE, True)):
        lab = labels if nc == 2 else rng.integers(0, nc, IMAGE_HW).astype(np.uint8)
        lut = lambda: host_overlay(img, lab, palette, 0.5, blend0)
        ref = lambda: blend_numpy(img, lab, palette, 0.5, blend0)
        if not np.array_equal(lut(), ref()):
            raise AssertionError(f"LUT blend differs from the numpy blend at C={nc}")
        res[f"blend_lut_c{nc}_ms"] = host_median_ms(lut)
        res[f"blend_numpy_c{nc}_ms"] = host_median_ms(ref)
        log(f"host IO blend C={nc}: LUT {res[f'blend_lut_c{nc}_ms']:.3f} ms, numpy "
            f"{res[f'blend_numpy_c{nc}_ms']:.3f} ms (medians of {HOST_ITERS}), "
            "bit-equal")
    png = pil_png(img, 6)
    pil_decode = lambda: np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
    res["decode_pil_ms"] = host_median_ms(pil_decode)
    if native.decode_available():
        if not np.array_equal(native.decode_png(png), pil_decode()):
            raise AssertionError("native decode differs from PIL")
        res["decode_native_ms"] = host_median_ms(lambda: native.decode_png(png))
        log(f"host IO decode: native {res['decode_native_ms']:.3f} ms, PIL "
            f"{res['decode_pil_ms']:.3f} ms, equal")
    else:
        try:
            native.decode_png(png)
        except RuntimeError as e:
            log(f"host IO decode: no native decode in this build ({e}); PIL "
                f"{res['decode_pil_ms']:.3f} ms")
        else:
            raise AssertionError("decode_png ran in a build without libpng")
    log("host IO: " + json.dumps(res))
    return res


SWEEP_N = 16            # KITTI-like test images of the FCN sweeps
SWEEP_SEGNET_N = 8      # and of the SegNet sweep (one batch of 8)


def _sweep_predictor(preset: str):
    """The Predictor ``scripts/test.py`` builds at ``preset`` (the same
    seeded random weights)."""
    import torch
    from argparse import ArgumentParser

    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor,
    )

    p = ArgumentParser()
    add_model_args(p)
    return build_predictor(p.parse_args(["--preset", preset, "--device", "cuda"]),
                           torch.device("cuda"))


def drive_sweep(torch, tmp: str, counters: dict) -> dict:
    """The test-set sweep through ``scripts/test.py``'s ``main``: FCN-8s
    (fcn8s_kitti, random weights) over ``SWEEP_N`` generated KITTI-like test
    images at --batch 1, --batch 8 and --confidence --batch 8, then SegNet
    (segnet_kitti) at --batch 8 over ``SWEEP_SEGNET_N``. Each run must launch
    its model's stage1 kernel (and SegNet's pool kernels) and write one file
    of the right name per image; each overlay must equal ``host_overlay``
    of its image with the Predictor's labels at the sweep's batch, those
    labels the device path's (``Predictor.__call__``, kernel 2), and the
    overlay the device path's within 1 count a byte; each confidence map
    must lie within 1 count of round(softmax64 * 255) of the Predictor's
    f32 logits. Returns img/s (the CLI's own count, after the model build)
    and the launches of each run."""
    import contextlib

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import test as test_cli

    h, w = IMAGE_HW
    res = {}
    runs = (("fcn8s_kitti", SWEEP_N, "b1", ["--batch", "1"], ("stage1_tail",)),
            ("fcn8s_kitti", SWEEP_N, "b8", ["--batch", "8"], ("stage1_tail",)),
            ("fcn8s_kitti", SWEEP_N, "conf_b8", ["--batch", "8", "--confidence"],
             ("stage1_tail",)),
            ("segnet_kitti", SWEEP_SEGNET_N, "segnet_b8", ["--batch", "8"],
             ("stage1_tail_segnet", "pool_argmax", "unpool")))
    data, pred = {}, {}
    for preset, n, name, extra, kernels in runs:
        if n not in data:
            data[n] = generate_synthetic_kitti(os.path.join(tmp, f"kitti{n}"),
                                               n_train=0, n_test=n)
        test_dir = os.path.join(data[n], "testing", "image_2")
        srcs = sorted(os.listdir(test_dir))
        before = {k: counters[k].launches for k in kernels}
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = test_cli.main(["--preset", preset, "--device", "cuda",
                                "--data-dir", data[n], "--runs-dir",
                                os.path.join(tmp, name), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: counters[k].launches - before[k] for k in kernels}
        last = out.getvalue().strip().splitlines()[-1]
        if rc != 0 or not last.startswith(f"{n} images in "):
            raise AssertionError(f"sweep {name}: rc {rc}, last line {last!r}")
        if not all(launched.values()):
            raise AssertionError(f"sweep {name}: kernels not launched {launched}")
        img_s = float(last.split("(")[1].split()[0])
        conf = "--confidence" in extra
        (run_dir,) = os.listdir(os.path.join(tmp, name))
        run_dir = os.path.join(tmp, name, run_dir)
        want_names = [s.replace("um_", "um_road_") if conf else s for s in srcs]
        if sorted(os.listdir(run_dir)) != want_names:
            raise AssertionError(f"sweep {name}: wrote {sorted(os.listdir(run_dir))}")
        if preset not in pred:
            pred[preset] = _sweep_predictor(preset)
        pr = pred[preset]
        imgs = np.stack([load_image(os.path.join(test_dir, s)) for s in srcs])
        got = np.stack([np.asarray(Image.open(os.path.join(run_dir, f)))
                        for f in want_names])
        batch = int(extra[1])
        worst = 0
        for i in range(0, n, batch):
            x = imgs[i:i + batch]
            if conf:
                logits = pr._padded_logits(pr._to_device(x))[:, :h, :w]
                p = torch.softmax(logits.double(), -1)[..., 1]
                want = torch.round(p * 255).cpu().numpy()
                d = np.abs(got[i:i + batch].astype(np.float64) - want).max()
                if d > 1:
                    raise AssertionError(f"sweep {name}: confidence off by {d}")
                worst = max(worst, d)
                continue
            labels = pr._fetch_labels(x)
            ov_dev, lab_dev = pr(x)
            if not np.array_equal(labels, lab_dev):
                raise AssertionError(f"sweep {name}: labels differ from the "
                                     "device path's")
            for j in range(len(x)):
                if not np.array_equal(got[i + j], host_overlay(
                        x[j], labels[j], pr._palette, pr._alpha)):
                    raise AssertionError(f"sweep {name}: {want_names[i + j]} "
                                         "differs from host_overlay")
            d = np.abs(got[i:i + batch].astype(np.int16) - ov_dev).max()
            if d > 1:
                raise AssertionError(f"sweep {name}: overlay off the device "
                                     f"path's by {d}")
            worst = max(worst, int(d))
        # the producer's leg alone: one image's decode (load_image, PIL here)
        decode_ms = host_median_ms(
            lambda: load_image(os.path.join(test_dir, srcs[0])), iters=5)
        res[name] = {"images": n, "img_per_s": img_s, "main_wall_s": wall,
                     "launches": launched, "max_count_diff": float(worst),
                     "decode_ms": decode_ms}
        log(f"sweep {preset} {' '.join(extra)}: {n} files checked, {img_s:.2f} "
            f"img/s (the CLI's count), main() {wall:.2f} s with the model build; "
            f"launches {launched}; max |diff| {worst} count "
            f"({'round(softmax64*255)' if conf else 'device overlay'}); "
            f"load_image {decode_ms:.2f} ms an image (median of 5)")
    del pred
    torch.cuda.empty_cache()
    return res


def drive_slice(torch, tmp: str, preset: str, model_kw: str | None = None,
                extra: tuple = (), serve_extra: tuple = ()) -> dict:
    """The inference path through the user's entry points at ``preset``
    (random weights, or ``extra``'s ``--checkpoint-dir``; ``model_kw`` as
    ``--model-kw`` takes it; ``serve_extra``: flags of the server alone) on
    a generated image of the preset's size: infer_image, the server
    answering requests, the Predictor's steady state. Returns timings."""
    import http.client

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image, serve

    times = {}
    hw = get_preset(preset).data.image_size
    png = os.path.join(tmp, "kitti_like.png")
    out = os.path.join(tmp, "overlay.png")
    write_png(png, seed=0, hw=hw)
    kw = (["--model-kw", model_kw] if model_kw else []) + list(extra)
    what = f"{preset} {model_kw}" if model_kw else preset

    # 1. infer_image, as a user runs it (random weights)
    t0 = time.perf_counter()
    rc = infer_image.main(["--preset", preset, "--image", png, "--out", out,
                           "--device", "cuda", *kw])
    torch.cuda.synchronize()
    times["infer_image_main_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"infer_image returned {rc}")
    ov = np.asarray(Image.open(out))
    if ov.shape != (*hw, 3) or ov.dtype != np.uint8:
        raise AssertionError(f"infer_image wrote {ov.shape} {ov.dtype}")
    log(f"infer_image: wrote {ov.shape} overlay in "
        f"{times['infer_image_main_s']:.3f} s (model build, random init, "
        "decode, forward, encode)")

    # 2. the server, in a thread, answering real HTTP requests
    server, _ = serve.make_server(["--preset", preset, "--device", "cuda",
                                   "--port", "0", *kw, *serve_extra])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        pred = server.predictor
        body = open(png, "rb").read()
        img = np.asarray(Image.open(png).convert("RGB"))
        want_labels = pred._fetch_labels(img[None])[0]
        want_overlay = host_overlay(img, want_labels, pred._palette, pred._alpha)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=300)
        req_ms = {"/segment": [], "/labels": []}
        for path in ["/segment"] * 3 + ["/labels"] * 2:
            t0 = time.perf_counter()
            conn.request("POST", path, body=body)
            r = conn.getresponse()
            data = r.read()
            req_ms[path].append((time.perf_counter() - t0) * 1e3)
            if r.status != 200:
                raise AssertionError(f"{path}: HTTP {r.status}")
            got = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            want = (want_overlay if path == "/segment"
                    else np.repeat(want_labels[..., None], 3, -1))
            if not np.array_equal(got, want):
                raise AssertionError(f"{path}: response differs from the "
                                     "Predictor's answer")
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        conn.close()
        if r.status != 200 or health.get("status") != "ok" \
                or health.get("requests") != 5:
            raise AssertionError(f"/healthz: {r.status} {health}")
        log(f"serve: 3x /segment {['%.2f' % t for t in req_ms['/segment']]} ms, "
            f"2x /labels {['%.2f' % t for t in req_ms['/labels']]} ms "
            f"(client wall, PNG decode + forward + label fetch + host blend + "
            f"PNG encode); /healthz {health}")
        times["segment_ms"] = float(np.median(req_ms["/segment"]))
        times["labels_ms"] = float(np.median(req_ms["/labels"]))

        # steady-state Predictor calls on the same model (host clock around
        # work that ends in a device->host copy)
        for name, fn in (("predictor_overlay_ms", lambda: pred(img)),
                         ("predictor_labels_ms",
                          lambda: pred._fetch_labels(img[None]))):
            fn()
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            times[name] = float(np.median(ts))
        dev, ops = device_ms(lambda: pred(img), iters=10)
        times["predictor_overlay_device_ms"] = dev
        log(f"Predictor {what}, 1x{hw[0]}x{hw[1]}: overlay "
            f"{times['predictor_overlay_ms']:.3f} ms/image, packed labels "
            f"{times['predictor_labels_ms']:.3f} ms/image (host clock, median "
            f"of 10); overlay call on the device {dev:.3f} ms in {ops} ops, "
            f"idle share {1 - dev / times['predictor_overlay_ms']:.2f}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return times


def drive_fcn_inference(torch, tmp: str) -> dict:
    """FCN-8s's inference path: drive_slice at fcn8s_kitti, then one
    Predictor forward at the reference-exact width (fcn8s_kitti_parity,
    fc 4096). Returns timings."""
    from argparse import ArgumentParser

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor,
    )

    times = drive_slice(torch, tmp, "fcn8s_kitti")
    img = np.asarray(Image.open(os.path.join(tmp, "kitti_like.png")).convert("RGB"))
    p = ArgumentParser()
    add_model_args(p)
    args = p.parse_args(["--preset", "fcn8s_kitti_parity", "--device", "cuda"])
    pred = build_predictor(args, torch.device("cuda"))
    overlay, labels = pred(img)
    if overlay.shape != (*IMAGE_HW, 3) or labels.shape != IMAGE_HW:
        raise AssertionError("fcn8s_kitti_parity: bad output shapes")
    t0 = time.perf_counter()
    pred(img)
    times["parity_overlay_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"Predictor fcn8s_kitti_parity (fc 4096): overlay "
        f"{times['parity_overlay_ms']:.3f} ms/image (second call)")
    del pred
    return times


def check_end_to_end(torch, name: str = "fcn8s", padded_hw=PADDED_HW, **kw) -> None:
    """The full forward of model ``name`` (model flags ``kw``; fcn8s_kitti
    by default) with the kernels against the same forward on plain PyTorch
    (stage1 as a PooledConvBlock of cuDNN convs and max_pool, overlay by the
    plain version), same weights, same image, bf16 on the card; the logits
    padded to ``padded_hw``.

    Tolerance: the two differ only where a stage1 conv value rounds to the
    neighbouring bf16 value; that one-ulp change then passes through 13 more
    bf16 layers. Bound: max |dlogits| <= 0.03 * max |logits|, and labels
    agreeing on >= 99.5 % of pixels (a pixel whose two logits are nearly
    equal may flip); exactly on every pixel whose plain logits differ by
    more than twice the largest logit difference (none of those can
    flip)."""
    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
        argmax_colormap_overlay_plain,
    )

    dev = torch.device("cuda")
    fused = build_model(name, 2, device=dev, **kw)
    init_params(fused, torch.Generator(device=dev).manual_seed(3))
    plain = build_model(name, 2, device=dev, packed_stage1=False, **kw)
    plain.load_state_dict(fused.state_dict())
    pk = Predictor(fused, IMAGE_HW, device=dev)
    pp = Predictor(plain, IMAGE_HW, device=dev)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1, *IMAGE_HW, 3), np.uint8)
    x = pk._to_device(img)
    lk = pk._padded_logits(x)
    lp = pp._padded_logits(x)
    if lk.shape != (1, *padded_hw, 2) or not torch.isfinite(lk).all():
        raise AssertionError(f"logits {tuple(lk.shape)} not finite/expected")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    ov_k, lab_k = pk._fwd(x)
    h, w = IMAGE_HW
    ov_p, lab_p = argmax_colormap_overlay_plain(x, lp[:, :h, :w], pp._palette_dev,
                                                pp._alpha)
    agree = (lab_k == lab_p).float().mean().item()
    crop = lp[:, :h, :w]
    decided = (crop[..., 1] - crop[..., 0]).abs() > 2 * (lk - lp).abs().max()
    flips = int((decided & (lab_k != lab_p)).sum())
    log(f"end to end {name} {kw}, kernels vs plain: max |dlogits| / max |logits| "
        f"= {rel:.4g} (bound 0.03), labels agree on {100 * agree:.4f} % "
        f"(bound 99.5 %), {flips} of {int(decided.sum())} decided pixels differ "
        f"(bound 0), road fraction {lab_k.float().mean().item():.3f}")
    if rel > 0.03 or agree < 0.995 or flips:
        raise AssertionError("end-to-end check failed")


def drive_training(torch, tmp: str, preset: str = "fcn8s_kitti",
                   model_kw: str | None = None, data: str | None = None,
                   extra: tuple = (), expect_resume: str | None = None) -> dict:
    """The training path through the user's entry points: the port's
    scripts/train.py on a generated synthetic KITTI set at 375x1242 (24
    images, or ``data``, the preset's dataset: as many as 3 steps take after
    any ``extra`` flags' validation split) at ``preset`` (its batch and
    crops, full width, 3 steps; ``model_kw`` as ``--model-kw`` takes it)
    with --pallas-preprocess, then --resume (whose output must hold
    ``expect_resume``), then infer_image on the checkpoint it wrote (on the
    dataset's first test image). Returns timings, and the data and
    checkpoint directories."""
    import contextlib
    import math

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image, train

    if data is None:
        data = generate_synthetic_kitti(os.path.join(tmp, "data_road"), n_train=24,
                                        n_test=1, h=IMAGE_HW[0], w=IMAGE_HW[1],
                                        seed=0)
    dc = get_preset(preset).data
    batch, hw = get_preset(preset).train.batch_size, dc.image_size
    ck = os.path.join(tmp, "ckpt")
    kw = ["--model-kw", model_kw] if model_kw else []
    what = f"{preset} {model_kw}" if model_kw else preset
    argv = ["--preset", preset, "--data-dir", data, "--epochs", "1",
            "--pallas-preprocess", "--checkpoint-dir", ck, "--device", "cuda", *kw,
            *extra]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if train.main(argv) != 0:
        raise AssertionError("train.main failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(ck, "logs", "train.jsonl")) as f:
        epoch = [json.loads(line) for line in f][-1]
    loss = epoch.get("epoch/loss", float("nan"))
    if not math.isfinite(loss) or epoch.get("step") != 3:
        raise AssertionError(f"train: loss {loss} at step {epoch.get('step')}")
    if not os.path.exists(os.path.join(ck, "ckpt_3.pt")):
        raise AssertionError(f"train wrote no checkpoint: {os.listdir(ck)}")
    log(f"train.main {what} {' '.join(extra)}, batch {batch}, "
        f"{'x'.join(map(str, dc.crop_size))} crops: 3 steps, "
        f"loss {loss:.4f}, miou {epoch.get('epoch/miou', float('nan')):.4f}, "
        f"{wall:.1f} s wall (data decode, model build, cuDNN setup included), "
        f"peak device memory {peak:.2f} GiB")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv[:5] + ["0"] + argv[6:] + ["--resume"])
    print(buf.getvalue(), end="")
    if rc != 0 or "resumed at step 3" not in buf.getvalue():
        raise AssertionError("train --resume did not restore step 3")
    if expect_resume is not None and expect_resume not in buf.getvalue():
        raise AssertionError(f"train --resume printed no {expect_resume!r}")
    out = os.path.join(tmp, "trained_overlay.png")
    src = build_dataset(dc.dataset, data, hw).test_images[0]
    if infer_image.main(["--preset", preset, "--checkpoint-dir", ck, "--image",
                         src, "--out", out, "--device", "cuda", *kw]) != 0:
        raise AssertionError("infer_image on the trained checkpoint failed")
    ov = np.asarray(Image.open(out))
    if ov.shape != (*hw, 3):
        raise AssertionError(f"infer_image wrote {ov.shape}")
    log(f"train --resume: restored step 3; infer_image --checkpoint-dir wrote a "
        f"{ov.shape} overlay from the trained weights")
    return {"train_cli_wall_s": wall, "train_cli_peak_gib": peak,
            "train_cli_loss": loss, "data": data, "ckpt": ck}


def hold_train_steps(what: str, kern, out_k: dict, plain, out_p: dict) -> None:
    """Hold one train step with the kernels (state ``kern``, output
    ``out_k``) against the same step on plain PyTorch: the loss within 1e-3
    relative, each parameter's gradient within 5e-2 of its L2 norm, and
    the confusion matrices nearly equal (labels agree on >= 99.5 % of the
    valid pixels). Logs the numbers; raises outside the bounds."""
    from semanticsegmentation_tensorflow_tpu_torch.models.common import bn_fed_biases

    lk, lp = out_k["loss"].item(), out_p["loss"].item()
    worst, worst_name = 0.0, ""
    fed = bn_fed_biases(kern.model)
    for (name, pk), pp in zip(kern.model.named_parameters(),
                              plain.model.parameters()):
        if name in fed:
            continue
        rel = ((pk.grad - pp.grad).norm() / pp.grad.norm().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    cm_k, cm_p = out_k["cm"].cpu(), out_p["cm"].cpu()
    agree = 1 - (cm_k - cm_p).abs().sum().item() / (2 * cm_p.sum().item())
    log(f"train step {what}, kernels vs plain: loss {lk:.6f} vs {lp:.6f} (rel "
        f"{abs(lk - lp) / abs(lp):.3g}, bound 1e-3); worst gradient |dg|/|g| "
        f"{worst:.4g} ({worst_name}, bound 5e-2); labels agree >= "
        f"{100 * agree:.4f} % (bound 99.5 %)")
    if not (abs(lk - lp) <= 1e-3 * abs(lp) and worst <= 5e-2 and agree >= 0.995):
        raise AssertionError(f"train step {what}: kernels vs plain outside the bound")


def check_train_step(torch, preset: str = "fcn8s_kitti", fixed: bool = True) -> None:
    """One train step at ``preset``'s model and batch (fcn8s_kitti: 8;
    deeplab_kitti_dp: 16) with the kernels (stage1 training forward and
    backward, preprocess) against the same step on plain PyTorch
    (packed_stage1=False: stage1 as cuDNN convs + max_pool, and the
    preprocess kernel's plain version, bit-equal), same weights, same batch
    of 384x1248 images cropped to 320x1152, dropout 0, bf16 on the card;
    then (``fixed``) ten steps on one fixed batch.

    Bound: the two differ where a stage1 conv value rounds to the
    neighbouring bf16 value (and a near-tied window routes the other way);
    that moves a few gradient elements of stage1 and, through 13 more bf16
    layers (FCN; DeepLab's encoder, ASPP and head are as deep), the rest by a
    few bf16 ulps: ``hold_train_steps``'s bounds."""
    from functools import partial

    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import Augment
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import _road_scene
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
    cfg = get_preset(preset)
    rng = np.random.default_rng(1)
    imgs, lbls = zip(*(_road_scene(rng, *PADDED_HW)
                       for _ in range(cfg.train.batch_size)))
    batch = {"image": torch.from_numpy(np.stack(imgs)).to(dev),
             "label": torch.from_numpy(np.stack(lbls)).to(dev)}
    crop = (320, 1152)

    def state_for(packed):
        model = build_model(cfg.model, 2, device=dev,
                            **dict(cfg.model_kwargs, dropout_rate=0.0,
                                   packed_stage1=packed))
        init_params(model, torch.Generator(device=dev).manual_seed(7))
        opt = make_optimizer("adam", model.parameters(), 1e-4)
        return create_train_state(model, opt, make_lr_schedule(1e-4), seed=0)

    kern, plain = state_for(True), state_for(False)
    plain.model.load_state_dict(kern.model.state_dict())
    aug_k = make_preprocess_augment_fn(MEAN, STD, crop)
    aug_p = Augment(partial(preprocess_normalize_plain, crop_hw=crop, mean=MEAN,
                            std=STD), crop, True)
    out_k = make_train_step(2, augment_fn=aug_k)(kern, batch)
    out_p = make_train_step(2, augment_fn=aug_p)(plain, batch)
    hold_train_steps(f"{preset} (batch {cfg.train.batch_size})", kern, out_k,
                     plain, out_p)
    del plain
    if not fixed:
        return

    one = aug_k(torch.Generator().manual_seed(3), batch)  # one fixed crop
    step = make_train_step(2, with_metrics=False)
    losses = [step(kern, one)["loss"].item() for _ in range(10)]
    log(f"ten steps on one fixed batch: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
        f"({['%.4f' % v for v in losses]})")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall on a fixed batch")


# --- validated training and evaluation (scripts/train.py --val-frac, eval.py) --


def vgg_archive(path: str, seed: int) -> int:
    """An ``.npz`` of VGG16 weights at the fcn8s_kitti preset's shapes (fc
    1024), as ``--vgg-weights`` reads it: flax paths, HWIO kernels drawn
    He-normal from ``seed``, biases 0.01. Returns its entry count."""
    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.convert import flax_key, flax_layout
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    rng = np.random.default_rng(seed)
    blob = {}
    for k, t in build_model("fcn8s", 2, device="meta").state_dict().items():
        if not k.startswith("vgg16."):
            continue
        shape = flax_layout(np.broadcast_to(np.float32(0), tuple(t.shape)), False).shape
        if len(shape) == 4:
            std = np.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
            blob[flax_key(k)] = rng.standard_normal(shape, np.float32) * np.float32(std)
        else:
            blob[flax_key(k)] = np.full(shape, 0.01, np.float32)
    np.savez(path, **blob)
    return len(blob)


def run_cli(main, argv: list[str]) -> str:
    """``main(argv)`` with its standard output captured (and echoed);
    raises unless it returns 0."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    print(buf.getvalue(), end="")
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv} returned {rc}")
    return buf.getvalue()


def parse_eval(out: str, road: bool = True) -> dict:
    """The numbers of scripts/eval.py's lines (the JAX CLI's format); the
    KITTI road line only with ``road``."""
    import re

    m = re.search(r"^loss=(\S+) miou=(\S+) pixel_acc=(\S+) iou=", out, re.M)
    r = re.search(r"^kitti-road: MaxF=(\S+) AP=(\S+) .*@tau=(\S+)$", out, re.M)
    t = re.search(r"^(\d+) images in (\S+)s \((\S+) img/s\)$", out, re.M)
    if not (m and t and (r or not road)):
        raise AssertionError(f"eval printed no metrics: {out!r}")
    vals = dict(loss=float(m[1]), miou=float(m[2]), pixel_acc=float(m[3]),
                images=int(t[1]), seconds=float(t[2]), img_per_s=float(t[3]))
    if road:
        vals.update(maxf=float(r[1]), ap=float(r[2]), tau=float(r[3]))
    if not all(v == v and abs(v) != float("inf") for v in vals.values()):
        raise AssertionError(f"eval printed a non-finite number: {vals}")
    return vals


def drive_validated_training(torch, tmp: str) -> dict:
    """The validated-training path and the eval CLI at fcn8s_kitti's full
    width, through the user's entry points: scripts/train.py for one epoch
    (3 steps of batch 8) on 40 generated KITTI-like images with 10 held out
    for validation, keep-best, both jitters, 2 decode workers, EMA and a
    strict import of a seeded VGG16 archive at the preset's shapes; then
    scripts/eval.py --road-metrics on the checkpoint it wrote, raw and
    --ema (40 images at batch 4)."""
    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        checkpoint_steps,
    )

    data = generate_synthetic_kitti(os.path.join(tmp, "data_road"), n_train=40,
                                    n_test=1, h=IMAGE_HW[0], w=IMAGE_HW[1], seed=2)
    npz = os.path.join(tmp, "vgg16.npz")
    n_vgg = vgg_archive(npz, seed=4)
    ck = os.path.join(tmp, "ckpt")
    t0 = time.perf_counter()
    out = run_cli(train.main, [
        "--preset", "fcn8s_kitti", "--data-dir", data, "--epochs", "1",
        "--val-frac", "0.25", "--val-every", "1", "--keep-best",
        "--scale-jitter", "0.75,1.0,1.25", "--color-jitter", "0.2,0.2,0.2",
        "--loader-workers", "2", "--ema-decay", "0.99", "--vgg-weights", npz,
        "--strict-import", "--checkpoint-dir", ck, "--device", "cuda"])
    wall = time.perf_counter() - t0
    for want in ("val split: 10 images held out, 30 train",
                 f"imported {n_vgg} VGG16 tensors", "scale jitter: [0.75, 1.0, 1.25]",
                 "color jitter: b/c/s = [0.2, 0.2, 0.2]"):
        if want not in out:
            raise AssertionError(f"train.main did not print {want!r}")
    with open(os.path.join(ck, "logs", "train.jsonl")) as f:
        epoch = [json.loads(line) for line in f][-1]
    if epoch.get("step") != 3 or not all(
            k in epoch for k in ("epoch/val_loss", "epoch/val_miou",
                                 "epoch/val_best", "epoch/val_seconds")):
        raise AssertionError(f"validated epoch summary: {epoch}")
    if checkpoint_steps(os.path.join(ck, "best")) != [3]:
        raise AssertionError(f"no best/ checkpoint: {os.listdir(ck)}")
    log(f"train.main validated: 3 steps, val_loss {epoch['epoch/val_loss']:.4f}, "
        f"val_miou {epoch['epoch/val_miou']:.4f}, best/ at step 3, validation "
        f"{epoch['epoch/val_seconds']:.3f} s for 10 images, {wall:.1f} s wall")
    common = ["--preset", "fcn8s_kitti", "--data-dir", data, "--checkpoint-dir",
              ck, "--road-metrics", "--device", "cuda"]
    raw = parse_eval(run_cli(eval_cli.main, common))
    ema = parse_eval(run_cli(eval_cli.main, common + ["--ema"]))
    if raw["images"] != 40 or ema["images"] != 40:
        raise AssertionError(f"eval counted {raw['images']} / {ema['images']} images")
    ds = build_dataset("kitti_road", data, IMAGE_HW)
    decode_ms = host_median_ms(lambda: ds.load_example(ds.train_images[0]), 5)
    log(f"eval's loader: load_example (PNG decode of image and GT, resize, "
        f"label encode) {decode_ms:.2f} ms an image (median of 5, one thread)")
    return {"data": data, "ckpt": ck, "train_wall_s": wall,
            "load_example_ms": decode_ms,
            "val_seconds": epoch["epoch/val_seconds"],
            "val_loss": epoch["epoch/val_loss"], "val_miou": epoch["epoch/val_miou"],
            "eval": raw, "eval_ema": ema}


def drive_segnet_eval(torch, tmp: str, data: str) -> dict:
    """scripts/eval.py --road-metrics at segnet_kitti's full width on a
    checkpoint of seeded random weights, over the 40 images of ``data``."""
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.state import (
        create_train_state, make_lr_schedule, make_optimizer,
    )

    dev = torch.device("cuda")
    model = init_params(build_model("segnet", 2, device=dev),
                        torch.Generator(device=dev).manual_seed(3))
    ck = os.path.join(tmp, "segnet_ckpt")
    CheckpointManager(ck).save(create_train_state(
        model, make_optimizer("adam", model.parameters(), 1e-4),
        make_lr_schedule(1e-4), seed=0))
    return parse_eval(run_cli(eval_cli.main, [
        "--preset", "segnet_kitti", "--data-dir", data, "--checkpoint-dir", ck,
        "--road-metrics", "--device", "cuda"]))


DEEPLAB_N = 64          # 48 train (3 steps of 16) + 16 held out for validation


def drive_deeplab_training(torch, tmp: str) -> dict:
    """DeepLab's training path at deeplab_kitti_dp (batch 16, 320x1152
    crops, dropout from the step's generator) through drive_training, on
    64 generated images with 16 held out for validation (--val-frac 0.25
    --keep-best) and EMA: 3 steps, --resume, infer_image on the checkpoint.
    Returns its timings, data and checkpoint."""
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        checkpoint_steps,
    )

    data = generate_synthetic_kitti(os.path.join(tmp, "data_road"), n_train=DEEPLAB_N,
                                    n_test=1, h=IMAGE_HW[0], w=IMAGE_HW[1], seed=5)
    r = drive_training(torch, tmp, "deeplab_kitti_dp", data=data, extra=(
        "--val-frac", "0.25", "--keep-best", "--ema-decay", "0.99"))
    if checkpoint_steps(os.path.join(r["ckpt"], "best")) != [3]:
        raise AssertionError("deeplab: no best/ checkpoint at step 3")
    return r


def drive_deeplab_eval(torch, data: str, ck: str) -> dict:
    """scripts/eval.py --road-metrics at deeplab_kitti_dp on the trained
    checkpoint, raw and --ema, over the 64 images of ``data`` (batch 4)."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli

    common = ["--preset", "deeplab_kitti_dp", "--data-dir", data, "--checkpoint-dir",
              ck, "--road-metrics", "--device", "cuda"]
    raw = parse_eval(run_cli(eval_cli.main, common))
    ema = parse_eval(run_cli(eval_cli.main, common + ["--ema"]))
    if raw["images"] != DEEPLAB_N or ema["images"] != DEEPLAB_N:
        raise AssertionError(f"eval counted {raw['images']} / {ema['images']} images")
    return {"eval": raw, "eval_ema": ema}


def time_deeplab(torch, smi: str, workload: str) -> dict:
    """time_train at a DeepLab workload, and the step's conv device time by
    kernel size and dilation (``profile_train.conv_ms_by_dilation``)."""
    from profile_train import WORKLOADS, conv_ms_by_dilation, train_workload

    r = time_train(torch, smi, workload)
    torch.cuda.empty_cache()
    step = train_workload(torch, WORKLOADS[workload])
    dil = conv_ms_by_dilation(torch, step)
    del step
    torch.cuda.empty_cache()
    share = dil["dilated_ms"] / r["device_ms"] if r["device_ms"] else float("nan")
    log(f"{workload}: convs by kind (device ms per step) "
        + json.dumps({k: round(v, 3) for k, v in dil["by_kind"].items()})
        + f"; dilated {dil['dilated_ms']:.3f} ms ({100 * share:.1f} % of the step's "
        f"device {r['device_ms']:.2f} ms), undilated {dil['undilated_ms']:.3f} | {smi}")
    return dict(r, conv_ms_by_dilation=dil, dilated_share=share)


def check_eval_against_plain(torch, data: str, ck: str, cli: dict,
                             preset: str = "fcn8s_kitti") -> dict:
    """The eval step on the card over the eval CLI's batches (every image of
    ``data``, batch 4, the same loader) with the checkpoint trained at
    ``preset`` (FCN's, or DeepLab's at 376x1248), kernels against plain
    PyTorch (stage1 as cuDNN convs and a max pool), same weights, bf16.

    Tolerance: the two differ only where a stage1 conv value rounds to the
    neighbouring bf16 value, a few bf16 ulps in the logits after 13 more
    bf16 layers; only pixels whose two logits lie that close can flip. At
    most 0.5 % of the valid pixels may take another class (the end-to-end
    check's bound). Exact: the road histogram's total and each confusion
    matrix's total equal the valid-pixel count; the kernel build's mIoU
    equals the CLI's printed one (4 decimals)."""
    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import normalize_images
    from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import BatchLoader
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import load_weights
    from semanticsegmentation_tensorflow_tpu_torch.train.metrics import iou_from_confusion
    from semanticsegmentation_tensorflow_tpu_torch.train.step import make_eval_step

    dev = torch.device("cuda")
    cfg = get_preset(preset)
    weights = load_weights(ck, map_location=dev)
    kern = build_model(cfg.model, 2, device=dev, **cfg.model_kwargs)
    plain = build_model(cfg.model, 2, device=dev,
                        **dict(cfg.model_kwargs, packed_stage1=False))
    kern.load_state_dict(weights)
    plain.load_state_dict(weights)
    loader = BatchLoader(build_dataset("kitti_road", data, IMAGE_HW), 4,
                         pad_multiple=getattr(kern, "total_stride", 32), device=dev,
                         drop_remainder=False)
    step = make_eval_step(2, road_hist=True)
    cm_k = cm_p = 0
    moved = valid = hist = images = 0
    for b in loader.epoch():
        images += b["image"].shape[0]
        b = dict(b, image=normalize_images(b["image"], MEAN, STD))
        ok, op = step(kern, b), step(plain, b)
        moved += ((ok["pred"] != op["pred"]) & b["valid"]).sum().item()
        valid += b["valid"].sum().item()
        hist += ok["road_hist"].sum().item()
        cm_k, cm_p = cm_k + ok["cm"], cm_p + op["cm"]
    share = moved / valid
    miou = iou_from_confusion(cm_k)[1].item()
    log(f"eval kernels vs plain, {preset} trained checkpoint, {images} images "
        f"{list(b['image'].shape[1:3])}: "
        f"{moved} of {valid} valid pixels change class ({100 * share:.4f} %, "
        f"bound 0.5 %); confusion matrices {cm_k.tolist()} vs {cm_p.tolist()}; "
        f"road histogram total {hist}; mIoU {miou:.4f} (CLI {cli['miou']:.4f})")
    if not (share <= 0.005 and hist == valid == cm_k.sum().item() == cm_p.sum().item()
            and abs(miou - cli["miou"]) <= 1e-4 and images == cli["images"]):
        raise AssertionError("eval: kernels vs plain outside the bound")
    return {"moved_share": share, "valid_pixels": valid}


# --- SegNet (segnet_kitti): kernels 3 and 5, then its two paths -------------


def segnet_unpools(n: int, h: int, w: int) -> tuple:
    """The full-resolution [N,H,W,C] of each SegNet decoder unpool's output
    (dec1..dec5) for an n x h x w input. Each but dec1's is also a pool's
    input (enc2..enc5) and the shape of that pool's backward unpool; every
    decoder unpool has its backward."""
    return tuple((n, h >> i, w >> i, c)
                 for i, c in enumerate((64, 128, 256, 512, 512)))


# one SegNet train step at segnet_kitti (batch 8, 320x1152 crops), and one
# Predictor forward at full KITTI resolution (batch 1, 384x1248; the
# enc5 pool's output is 12x39, an odd width)
SEGNET_UNPOOLS = segnet_unpools(*TRAIN_SHAPE[:3])
SEGNET_POOLS = SEGNET_UNPOOLS[1:]
SEGNET_INFER_UNPOOLS = segnet_unpools(1, *PADDED_HW)
# SegNet with use_bn: eval.py --tta's batches of 4 at each scale, and the
# grid's 4 images of 352 rows whole and as its two ranks' 192 + 160 rows
SEGNET_BN_UNPOOLS = sum((segnet_unpools(4, *hw) for hw in (
    *TTA_VARIANT_HW, PADDED_HW, (352, 1248), (192, 1248), (160, 1248))), ())


def check_segnet_stage1(torch, gen) -> dict:
    """Kernel 3 (SegNet's stage1 tail) against its plain version at the
    inference shape [1,384,1248,64] and the training shape [8,320,1152,64],
    its backward (kernel 1b fed SegNet's index) against the f32 reference,
    and exact integer tie cases.

    Forward, random inputs: both versions round the f32 conv to bf16 in
    another summation order, then add b2 in bf16 and take the relu, so
    ``out`` may differ by one bf16 ulp of the conv value plus one of the
    bias add: |kernel - plain| <= 2^-6 (|plain| + |b2|) + 1e-6. The index
    equals the plain one except where that ulp reorders two window values
    within it; required on >= 99.9 % of elements, as for FCN's codes.
    Backward, on the plain forward's (out, idx) so that both route alike:
    kernel 1b's bounds (check_stage1_train). Integer cases: every sum exact,
    so out, idx and the gradients through SegNetStage1Tail equal the plain
    versions bit for bit, ties after the bf16 bias add, all-zero windows
    and c = b > a included."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        SegNetStage1Tail, stage1_tail_bwd, stage1_tail_bwd_plain,
        stage1_tail_segnet, stage1_tail_segnet_plain,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.tie_cases import (
        int_case, segnet_tie_windows,
    )

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)

    result = {}
    for n, h, w, c in ((1, *PADDED_HW, 64), TRAIN_SHAPE):
        z1 = rand((n, h, w, c), 1.0)
        k2 = rand((c, c, 3, 3), (1.0 / (9 * c)) ** 0.5).contiguous(
            memory_format=torch.channels_last)
        b2 = rand((c,), 0.1)
        out, idx = stage1_tail_segnet(z1, k2, b2)
        out_p, idx_p = stage1_tail_segnet_plain(z1, k2, b2)
        torch.cuda.synchronize()
        err = (out.float() - out_p.float()).abs()
        bad = int((err > 2 ** -6 * (out_p.float().abs() + b2.float().abs())
                   + 1e-6).sum())
        agree = (idx == idx_p).float().mean().item()
        log(f"segnet stage1 [{n},{h},{w},{c}]: max_abs_err {err.max().item():.6g} "
            f"(max |plain| {out_p.float().abs().max().item():.4g}), {bad} outside "
            f"the bound; idx agree {100 * agree:.4f} % (bound 99.9 %), "
            f"{100 * (idx_p == 0).float().mean().item():.1f} % index 0")
        if bad or agree < 0.999 or not torch.isfinite(out.float()).all():
            raise AssertionError(f"segnet stage1 [{n},{h},{w},{c}] outside the bound")
        t = ab_ms(lambda: stage1_tail_segnet_plain(z1, k2, b2),
                  lambda: stage1_tail_segnet(z1, k2, b2))
        show_ab(f"segnet stage1 at [{n},{h},{w},{c}]", t)
        # z1 in; out (bf16) and idx (u8) pooled out; the yardstick is
        # cuDNN's conv alone
        fr = forward_rate(torch, "(SegNet)", t["ms"], z1, k2)
        if (n, h, w, c) != TRAIN_SHAPE:
            result.update(infer_ms=t["ms"], infer_plain_ms=t["plain_ms"],
                          infer_library_ms=fr["library_ms"])
            continue
        result.update(max_abs_err=err.max().item(), idx_agree=agree, ms=t["ms"],
                      plain_ms=t["plain_ms"], **fr)
        g = rand(out.shape, 1.0)
        got = stage1_tail_bwd(g, out_p, idx_p, z1, k2)
        want = stage1_tail_bwd_plain(g, out_p, idx_p, z1, k2)
        errs = []
        for name, a, b, rel, near0 in zip(("dz1", "dk2", "db2"), got, want,
                                          (2 ** -7, 0.0, 0.0),
                                          (2 ** -12, 1e-4, 1e-4)):
            a, b = a.float(), b.float()
            e = (a - b).abs()
            errs.append(e.max().item())
            if int((e > rel * b.abs() + near0 * b.abs().max()).sum()):
                raise AssertionError(f"segnet stage1 bwd {name} outside the bound")
        log(f"segnet stage1 backward (kernel 1b on SegNet's index) [{n},{h},{w},"
            f"{c}] against the f32 reference: max_abs_err dz1 {errs[0]:.6g} dk2 "
            f"{errs[1]:.6g} db2 {errs[2]:.6g}")
        del z1, k2, b2, out, idx, out_p, idx_p, g, got, want

    for n, h, w, c in ((2, 16, 48, 64), (8, 64, 256, 64)):
        for case in (segnet_tie_windows, int_case):
            z1, k2, b2 = (t.to("cuda", torch.bfloat16)
                          for t in case(n, h, w, c, 1))
            out, idx = stage1_tail_segnet(z1, k2, b2)
            out_p, idx_p = stage1_tail_segnet_plain(z1, k2, b2)
            if not (torch.equal(out, out_p) and torch.equal(idx, idx_p)):
                raise AssertionError(f"segnet stage1 {case.__name__}: forward "
                                     "not exact")
            if case is segnet_tie_windows and not (
                    bool((idx_p[..., 1::4] == 0).all())
                    and bool((idx_p == 1).any())):
                raise AssertionError("the segnet tie case lacks its windows")
            cot = torch.randint(-3, 4, out.shape, generator=torch.Generator()
                                .manual_seed(2)).to("cuda", torch.bfloat16)
            leaves = [t.clone().requires_grad_() for t in (z1, k2, b2)]
            got = torch.autograd.grad(SegNetStage1Tail.apply(*leaves)[0], leaves,
                                      cot)
            want = stage1_tail_bwd_plain(cot, out_p, idx_p, z1, k2)
            if not all(torch.equal(a.float(), b.to(a.dtype).float())
                       for a, b in zip(got, want)):
                raise AssertionError(f"segnet stage1 {case.__name__} [{n},{h},{w},"
                                     f"{c}]: gradients not exact")
            log(f"segnet stage1 {case.__name__} [{n},{h},{w},{c}] (integer; ties "
                "after the bias add, all-zero windows, c = b > a): out, idx and "
                "the autograd Function's dz1, dk2, db2 exact")
    return result


def check_pool(torch, gen) -> dict:
    """Kernel 5's three entry points against their plain versions at every
    SegNet pool and unpool of a train step and of a full-resolution
    Predictor forward, random bf16 inputs plus a tie-rich integer case:
    they only select, so the bytes must be equal. Each is timed at the
    train step's shapes against its plain version and the one PyTorch call
    that computes the same function on the channels_last NCHW view:
    ``F.max_pool2d(return_indices=True)``, ``F.max_unpool2d`` with its
    int64 indices, and for the unpool's backward ``torch.gather`` by them.
    Returns the totals over one train step's pools and unpools."""
    import torch.nn.functional as F

    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
        pool_argmax, pool_argmax_plain, unpool, unpool_bwd, unpool_bwd_plain,
        unpool_plain,
    )

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "elems": 0.0}

    def add(what, shape, count, times):
        k, p, lib = times
        log(f"  {what} at {list(shape)} (x{count} per step): kernel {k:.4f} ms, "
            f"plain {p:.4f} ms, library {lib:.4f} ms")
        total["ms"] += count * k
        total["plain_ms"] += count * p
        total["library_ms"] += count * lib
        # each entry point moves 2.75 bytes per full-resolution element: the
        # bf16 full-size tensor, a quarter of it bf16 pooled, a quarter u8
        total["elems"] += count * shape[0] * shape[1] * shape[2] * shape[3]

    integer = torch.randint(-2, 3, (2, 16, 24, 64), generator=gen, device="cuda")
    for shape in ((2, 16, 24, 64),) + SEGNET_UNPOOLS + SEGNET_INFER_UNPOOLS \
            + SEGNET_BN_UNPOOLS:
        x = (integer.bfloat16() if shape == integer.shape
             else torch.randn(shape, generator=gen, device="cuda").bfloat16())
        p, idx = pool_argmax(x)
        pp, ip = pool_argmax_plain(x)
        g = torch.randn(x.shape, generator=gen, device="cuda").bfloat16()
        checks = {"pool_argmax": torch.equal(p, pp) and torch.equal(idx, ip),
                  "unpool": torch.equal(unpool(p, idx), unpool_plain(p, idx)),
                  "unpool_bwd": torch.equal(unpool_bwd(g, idx),
                                            unpool_bwd_plain(g, idx))}
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"pool kernels {bad} differ from plain at "
                                 f"{list(x.shape)}")
        del x, p, idx, pp, ip, g
    log(f"argmax pool, unpool, unpool backward at the {len(SEGNET_UNPOOLS)} "
        f"SegNet shapes of a train step {[list(s) for s in SEGNET_UNPOOLS]}, "
        f"the {len(SEGNET_INFER_UNPOOLS)} of a full-resolution forward "
        f"{[list(s) for s in SEGNET_INFER_UNPOOLS]}, the {len(SEGNET_BN_UNPOOLS)} of "
        f"use_bn's TTA eval and grid {[list(s) for s in SEGNET_BN_UNPOOLS]} and an "
        "integer tie case: "
        "bytes exact against the plain versions")

    log("argmax pool / unpool timings (device ms per call, mean of two turns):")
    for shape in SEGNET_UNPOOLS:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        xc = x.permute(0, 3, 1, 2)                    # channels_last view
        p, idx = pool_argmax(x)
        pc, ind = F.max_pool2d(xc, 2, return_indices=True)
        g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        gc = g.permute(0, 3, 1, 2)
        if shape in SEGNET_POOLS:
            add("pool_argmax", shape, 1, time3(
                lambda: pool_argmax_plain(x), lambda: pool_argmax(x),
                lambda: F.max_pool2d(xc, 2, return_indices=True)))
        # decoder unpool, plus the pool's backward at the pool shapes
        add("unpool", shape, 1 + (shape in SEGNET_POOLS), time3(
            lambda: unpool_plain(p, idx), lambda: unpool(p, idx),
            lambda: F.max_unpool2d(pc, ind, 2)))
        add("unpool_bwd", shape, 1, time3(
            lambda: unpool_bwd_plain(g, idx), lambda: unpool_bwd(g, idx),
            lambda: torch.gather(gc.flatten(2), 2, ind.flatten(2))))
        del x, xc, p, idx, pc, ind, g, gc
    log(f"argmax pool / unpool per SegNet train step: kernel {total['ms']:.4f} ms, "
        f"plain {total['plain_ms']:.4f} ms, library {total['library_ms']:.4f} ms")
    return {"max_abs_err": 0.0, "ms": total["ms"], "plain_ms": total["plain_ms"],
            "library_ms": total["library_ms"], **bound(2.75 * total["elems"])}


def rel_l2(a, ref) -> float:
    return ((a.float() - ref.float()).norm()
            / ref.float().norm().clamp(min=1e-30)).item()


def check_segnet_end_to_end(torch) -> None:
    """The full segnet_kitti forward with the kernels against the same
    forward on plain PyTorch (enc1 as a ConvBlock of cuDNN convs, the pools,
    unpools and overlay by their plain versions), same weights, same image,
    bf16, and both against the float32 model (plain, TF32 off).

    SegNet's pools route by argmax indices, and a one-ulp difference in a
    bf16 value can flip one, which moves a value within its window and on
    through the decoder: on the CPU, the bf16 and f32 runs of SegNet
    differ by a relative L2 of 0.18 to 0.32 in the logits (labels 89-92 %
    equal), against 0.014 for FCN-8s, and the JAX package's own SegNet in
    bf16 by 0.30 to 0.31 from its f32 run on the same weights and input
    (tools/rounding_sensitivity.py --jax): the spread is the model's in
    bf16. So the two bf16 builds are not
    held to each other but to f32: the kernel build's relative L2 distance
    to the f32 logits at most 1.5x the plain build's plus 0.02, and its
    labels' agreement with f32 at least the plain build's less 1 point."""
    import numpy as np

    from profile_train import plain_pools

    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    dev = torch.device("cuda")
    weights = init_params(build_model("segnet", 2, device=dev),
                          torch.Generator(device=dev).manual_seed(3)).state_dict()

    def predictor(**kw):
        model = build_model("segnet", 2, device=dev, **kw)
        model.load_state_dict(weights)
        return Predictor(model, IMAGE_HW, device=dev)

    pk = predictor()
    pp = predictor(packed_stage1=False)
    pr = predictor(packed_stage1=False, dtype=torch.float32)
    img = np.random.default_rng(5).integers(0, 256, (1, *IMAGE_HW, 3), np.uint8)
    x = pk._to_device(img)
    lk = pk._padded_logits(x)
    with plain_pools():
        lp = pp._padded_logits(x)
        lr = pr._padded_logits(x)
    if lk.shape != (1, *PADDED_HW, 2) or not torch.isfinite(lk).all():
        raise AssertionError(f"segnet logits {tuple(lk.shape)} not finite/expected")

    def labels(t):
        return t[..., 1] > t[..., 0]

    ek, ep = rel_l2(lk, lr), rel_l2(lp, lr)
    ak = (labels(lk) == labels(lr)).float().mean().item()
    ap = (labels(lp) == labels(lr)).float().mean().item()
    akp = (labels(lk) == labels(lp)).float().mean().item()
    log(f"end to end segnet_kitti: relative L2 to the f32 logits, kernels "
        f"{ek:.4g}, plain {ep:.4g} (bound 1.5x + 0.02); labels equal to f32's, "
        f"kernels {100 * ak:.3f} %, plain {100 * ap:.3f} % (bound plain - 1); "
        f"kernels vs plain: relative L2 {rel_l2(lk, lp):.4g}, labels "
        f"{100 * akp:.3f} % equal")
    if ek > 1.5 * ep + 0.02 or ak < ap - 0.01:
        raise AssertionError("segnet end-to-end check failed")


def check_segnet_train_step(torch) -> None:
    """One segnet_kitti train step with the kernels (SegNet stage1 forward,
    kernel 1b, the argmax pool/unpool kernels, preprocess) against the same
    step on plain PyTorch (packed_stage1=False, the pool/unpool and
    preprocess plain versions) and on the float32 plain model, same weights,
    same batch; then ten steps on a fixed batch.

    Both bf16 builds are held to the f32 step, as in
    check_segnet_end_to_end, leaf by leaf, so that a small leaf (enc1's
    conv1, which kernel 1b computes on SegNet's index, the biases) is not
    lost in the norm of the large ones. Each leaf's gradient: its relative
    L2 distance to the f32 step's at most 2x the plain build's, plus
    2^-8 / sqrt(numel). The floor is one bf16 rounding (half an ulp is at
    most 2^-8 relative) spread over the leaf: a leaf of a few elements may
    round one of them to the other neighbour where the plain build did not;
    in a leaf of 10^5 elements it is 1e-5, nothing. Both builds' distances
    are bf16's own rounding of the step: 0.002 over all gradients joined,
    up to 0.03 leaf by leaf, the kernel build's at most 1.17x the plain
    build's (0.0160 against 0.0158 for enc1.conv1's weight), on an H100. A kernel 1b that routed by a wrong index or lost a tenth of
    the pixels would put enc1.conv1's gradient ~0.1 or more off, 3x its
    bound. The loss within 2x the plain build's distance to the f32 loss
    plus 1e-6 relative (the f32 summation order over 2.9 M pixels; at these
    weights the logits are small and the loss is ~ln 2, so this check is
    weak). The labels' agreement with f32 (from the confusion matrices) at
    least the plain build's less 0.1 point. The loss falling over ten steps
    on a fixed batch."""
    from functools import partial

    import numpy as np

    from profile_train import plain_pools

    from semanticsegmentation_tensorflow_tpu_torch.data.augment import Augment
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import _road_scene
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
    rng = np.random.default_rng(1)
    imgs, lbls = zip(*(_road_scene(rng, *PADDED_HW) for _ in range(8)))
    batch = {"image": torch.from_numpy(np.stack(imgs)).to(dev),
             "label": torch.from_numpy(np.stack(lbls)).to(dev)}
    crop = (320, 1152)
    weights = init_params(build_model("segnet", 2, device=dev),
                          torch.Generator(device=dev).manual_seed(7)).state_dict()
    aug_p = Augment(partial(preprocess_normalize_plain, crop_hw=crop, mean=MEAN,
                            std=STD), crop, True)

    def run(augment, **kw):
        model = build_model("segnet", 2, device=dev, **kw)
        model.load_state_dict(weights)
        state = create_train_state(model, make_optimizer("adam", model.parameters(),
                                                         1e-4),
                                   make_lr_schedule(1e-4), seed=0)
        out = make_train_step(2, augment_fn=augment)(state, batch)
        grads = {k: p.grad.float() for k, p in model.named_parameters()}
        return state, out["loss"].item(), grads, out["cm"].cpu()

    kern, lk, gk, cm_k = run(make_preprocess_augment_fn(MEAN, STD, crop))
    with plain_pools():
        _, lp, gp, cm_p = run(aug_p, packed_stage1=False)
        _, lr, gr, cm_r = run(aug_p, packed_stage1=False, dtype=torch.float32)

    def agree(a, b):  # a lower bound of the labels' agreement, from the counts
        return 1 - (a - b).abs().sum().item() / (2 * b.sum().item())

    leaves = []        # (kernels' distance over its bound, name, ek, ep, bound)
    for name, r in gr.items():
        ek, ep = rel_l2(gk[name], r), rel_l2(gp[name], r)
        b = 2 * ep + 2 ** -8 / r.numel() ** 0.5
        leaves.append((ek / b, name, ek, ep, b))
    leaves.sort(reverse=True)
    ak, ap = agree(cm_k, cm_r), agree(cm_p, cm_r)
    loss_bound = 2 * abs(lp - lr) + 1e-6 * abs(lr)
    log(f"train step segnet_kitti: loss kernels {lk:.8f}, plain {lp:.8f}, f32 "
        f"{lr:.8f} (kernels' distance to f32 {abs(lk - lr):.3g}, bound "
        f"{loss_bound:.3g}); labels agree with f32's >= {100 * ak:.4f} % "
        f"(kernels), {100 * ap:.4f} % (plain; bound plain - 0.1)")
    log("gradients' relative L2 to the f32 step, leaf by leaf (bound 2x plain "
        "+ 2^-8/sqrt(numel)); the worst five, and enc1's:")
    for i, (frac, name, ek, ep, b) in enumerate(leaves):
        if i < 5 or name.startswith("enc1."):
            log(f"  {name}: kernels {ek:.5g}, plain {ep:.5g}, bound {b:.5g} "
                f"({100 * frac:.1f} % of it)")
    if not (leaves[0][0] <= 1 and abs(lk - lr) <= loss_bound
            and ak >= ap - 0.001):
        raise AssertionError("segnet train step: outside the bound")
    del gk, gp, gr

    fixed = make_preprocess_augment_fn(MEAN, STD, crop)(
        torch.Generator().manual_seed(3), batch)
    step = make_train_step(2, with_metrics=False)
    losses = [step(kern, fixed)["loss"].item() for _ in range(10)]
    log(f"segnet, ten steps on one fixed batch: loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} ({['%.4f' % v for v in losses]})")
    if not losses[-1] < losses[0]:
        raise AssertionError("the segnet loss did not fall on a fixed batch")


# --- kernel 6: Winograd F(2,3) / F(4,3) ------------------------------------

# The distinct eligible 3x3 convs of one train step at the presets (batch 8,
# 320x1152 crops, full width) as ((N, H, W, Cin), Cout, FCN-8s layers,
# SegNet layers), counted from the models' routing (models.common.
# winograd_impl); and of one full-resolution Predictor forward (batch 1,
# 384x1248), where f4 is ineligible at stage 5 (W = 78).
WINOGRAD_TRAIN = (
    ((8, 160, 576, 128), 128, 1, 1),
    ((8, 80, 288, 128), 256, 1, 1),
    ((8, 80, 288, 256), 256, 2, 2),
    ((8, 80, 288, 128), 128, 0, 2),
    ((8, 80, 288, 256), 128, 0, 1),
    ((8, 40, 144, 256), 512, 1, 1),
    ((8, 40, 144, 512), 512, 2, 2),
    ((8, 40, 144, 256), 256, 0, 2),
    ((8, 40, 144, 512), 256, 0, 1),
    ((8, 20, 72, 512), 512, 3, 6),
)
WINOGRAD_INFER = (
    ((1, 192, 624, 128), 128), ((1, 96, 312, 128), 256), ((1, 96, 312, 256), 256),
    ((1, 96, 312, 128), 128), ((1, 96, 312, 256), 128), ((1, 48, 156, 256), 512),
    ((1, 48, 156, 512), 512), ((1, 48, 156, 256), 256), ((1, 48, 156, 512), 256),
    ((1, 24, 78, 512), 512),
)


def time3(plain, kernel, library, timer=None) -> tuple[float, float, float]:
    """ms per call of the kernel, its plain version and the library call, in
    turns (plain, kernel, library, kernel, plain, library), each the mean of
    two turns; by ``timer`` (default: the profiler's device time)."""
    timer = timer or (lambda f: device_ms(f)[0])
    t = [timer(f) for f in (plain, kernel, library, kernel, plain, library)]
    return (t[1] + t[3]) / 2, (t[0] + t[4]) / 2, (t[2] + t[5]) / 2


def winograd_work(variant: str, shape, co: int, op: str) -> tuple[float, float]:
    """(bytes, FLOP) of one kernel-6 op: each input read once and each
    output written once (x, out, U; the dgrad also reads o; the wgrad
    reads x, g, o and writes dU, db in f32), and the products,
    2*a^2*tiles*C*Co."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import VARIANTS

    m, a2 = VARIANTS[variant].m, VARIANTS[variant].a ** 2
    n, h, w, c = shape
    px, tiles = n * h * w, n * (h // m) * (w // m)
    nbytes = {"fwd": 2 * px * (c + co) + 2 * a2 * c * co,
              "dgrad": 2 * px * (2 * co + c) + 2 * a2 * c * co,
              "wgrad": 2 * px * (c + 2 * co) + 4 * a2 * c * co + 4 * co}[op]
    return nbytes, 2.0 * a2 * tiles * c * co


def winograd_held(got, want, rel: float, near0: float, what: str) -> float:
    """Raise unless every element of kernel 6's ``got`` lies within ``rel``
    of its plain ``want`` plus ``near0`` of max |want| (and is finite);
    returns the largest error."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > rel * want.abs() + near0 * want.abs().max()).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"winograd {what}: {bad} elements outside the bound")
    return err.max().item()


def winograd_ops(torch, x, wt, b, g, o, variant: str) -> dict:
    """Kernel 6's three train-step ops on one conv (input ``x``, OIHW
    weight ``wt``, bias ``b``, cotangent ``g``, relu output ``o``), each as
    (plain, kernel, library) calls: the bias_relu forward beside cuDNN's
    ``F.conv2d`` with the bias; the masked forward that is the input
    gradient, and the weight gradient, beside ``aten.convolution_backward``."""
    import torch.nn.functional as F

    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw
    from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import rot180_swap

    u = cw.u_for(wt, variant, torch.bfloat16)
    u2 = cw.u_for(rot180_swap(wt), variant, torch.bfloat16)
    xc, gc = x.permute(0, 3, 1, 2), (g * (o > 0)).permute(0, 3, 1, 2)
    wc = wt.bfloat16().contiguous(memory_format=torch.channels_last)

    def conv_bwd(mask):
        return lambda: torch.ops.aten.convolution_backward(
            gc, xc, wc, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)

    return {
        "fwd": (lambda: cw.winograd_fwd_plain(x, u, b, None, variant, "bias_relu"),
                lambda: cw.winograd_fwd(x, u, b, None, variant, "bias_relu"),
                lambda: F.conv2d(xc, wc, b, padding=1)),
        "dgrad": (lambda: cw.winograd_fwd_plain(g, u2, None, o, variant, "none"),
                  lambda: cw.winograd_fwd(g, u2, None, o, variant, "none"),
                  conv_bwd([True, False, False])),
        "wgrad": (lambda: cw.winograd_wgrad_plain(x, g, o, variant),
                  lambda: cw.winograd_wgrad(x, g, o, variant),
                  conv_bwd([False, True, True])),
    }


def check_winograd(torch, gen) -> dict:
    """Kernel 6 against its plain version at every eligible conv shape of
    the FCN-8s and SegNet train steps (WINOGRAD_TRAIN) for f2 and f4: the
    forward in both epilogues (bias_relu, none), the masked forward that is
    the bias_relu op's input gradient, and the wgrad with and without the
    mask; at the inference shapes (WINOGRAD_INFER) the bias_relu forward,
    for each variant where eligible. Then the forward, dgrad and wgrad of
    each train shape timed against the plain versions and the library
    calls (cuDNN through F.conv2d with the bias, and
    aten.convolution_backward for the input and for the weight and bias
    gradients), by CUDA events around 5 calls after one warm-up (each call
    is a large device-bound launch; the profiler lost its events over the
    hundreds of short sessions this would take), and summed over one train
    step of each model.

    Bounds, written before the first run: the forward and dgrad are one
    bf16 rounding of float32 sums taken in another order than the plain
    version's (the transforms round alike: same order, no fused
    multiply-add), so one bf16 ulp: |kernel - plain| <= 2^-7 |plain| +
    2^-12 max |plain|; dU and db are float32 sums over up to 184320 tiles
    in another order: 1e-4 of max |plain|, as kernel 1b's wgrad. A rerun of
    the wgrad gives the same bits."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw
    from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import (
        VARIANTS, rot180_swap,
    )

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def events(fn):
        return cuda_ms(fn, iters=5, warmup=1)

    held = winograd_held
    worst = 0.0
    for variant in ("f2", "f4"):
        m = VARIANTS[variant].m
        for shape, co in [(s, c) for s, c, *_ in WINOGRAD_TRAIN] + list(WINOGRAD_INFER):
            n, h, w, c = shape
            if h % m or w % m:
                continue
            x = rand(shape).bfloat16()
            wt = rand((co, c, 3, 3), (1.0 / (9 * c)) ** 0.5)
            b = rand((co,), 0.1).bfloat16()
            u = cw.u_for(wt, variant, torch.bfloat16)
            what = f"{variant} {list(shape)}->{co}"
            worst = max(worst, held(cw.winograd_fwd(x, u, b, None, variant, "bias_relu"),
                                    cw.winograd_fwd_plain(x, u, b, None, variant,
                                                          "bias_relu"),
                                    2 ** -7, 2 ** -12, what + " bias_relu"))
            if n == 1:
                log(f"winograd {what} (inference): bias_relu forward within the bound")
                continue
            held(cw.winograd_fwd(x, u, b, None, variant, "none"),
                 cw.winograd_fwd_plain(x, u, b, None, variant, "none"),
                 2 ** -7, 2 ** -12, what + " none")
            g, o = rand((n, h, w, co)).bfloat16(), rand((n, h, w, co)).bfloat16()
            u2 = cw.u_for(rot180_swap(wt), variant, torch.bfloat16)
            dx_err = held(cw.winograd_fwd(g, u2, None, o, variant, "none"),
                          cw.winograd_fwd_plain(g, u2, None, o, variant, "none"),
                          2 ** -7, 2 ** -12, what + " masked dgrad")
            errs = []
            for mask in (o, None):
                du, db = cw.winograd_wgrad(x, g, mask, variant)
                du_p, db_p = cw.winograd_wgrad_plain(x, g, mask, variant)
                errs += [held(du, du_p, 0.0, 1e-4, what + " dU"),
                         held(db, db_p, 0.0, 1e-4, what + " db")]
                again = cw.winograd_wgrad(x, g, mask, variant)
                if not (torch.equal(du, again[0]) and torch.equal(db, again[1])):
                    raise AssertionError(f"winograd {what}: two wgrad runs differ")
                del du, db, du_p, db_p, again
            log(f"winograd {what}: forward (both epilogues), masked dgrad (max_abs_err "
                f"{dx_err:.4g}) and wgrad with and without the mask (dU, db max_abs_err "
                f"{max(errs[0], errs[2]):.4g}, {max(errs[1], errs[3]):.4g}) within the "
                "bounds; wgrad reruns bit-identical")
            del x, g, o, u, u2
        torch.cuda.empty_cache()

    log("winograd timings per call at the train shapes (ms by CUDA events; kernel, plain, "
        "library; bound; the kernel's TFLOP/s and share of the bound; ops fwd = "
        "bias_relu forward, dgrad = masked forward, wgrad = dU + db):")
    step = {(model, variant): {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                               "bytes": 0.0, "flops": 0.0}
            for model in ("fcn8s", "segnet") for variant in ("f2", "f4")}
    for variant in ("f2", "f4"):
        for shape, co, n_fcn, n_seg in WINOGRAD_TRAIN:
            n, h, w, c = shape
            x = rand(shape).bfloat16()
            wt = rand((co, c, 3, 3), (1.0 / (9 * c)) ** 0.5)
            b = rand((co,), 0.1).bfloat16()
            g, o = rand((n, h, w, co)).bfloat16(), rand((n, h, w, co)).bfloat16()
            ops = winograd_ops(torch, x, wt, b, g, o, variant)
            line = []
            for op, (plain, kernel, library) in ops.items():
                nbytes, flops = winograd_work(variant, shape, co, op)
                k, p, lib = time3(plain, kernel, library, timer=events)
                bd = bound(nbytes, flops)
                line.append(f"{op} {k:.4f} / {p:.4f} / {lib:.4f} (bound {bd['bound_ms']:.4f}"
                            f" {bd['bound_by']}; {flops / k / 1e9:.1f} TFLOP/s, "
                            f"{100 * bd['bound_ms'] / k:.1f} % of the bound)")
                for model, count in (("fcn8s", n_fcn), ("segnet", n_seg)):
                    acc = step[(model, variant)]
                    acc["ms"] += count * k
                    acc["plain_ms"] += count * p
                    acc["library_ms"] += count * lib
                    acc["bytes"] += count * nbytes
                    acc["flops"] += count * flops
            log(f"  {variant} {list(shape)}->{co}: " + "; ".join(line))
            del x, g, o, ops
        torch.cuda.empty_cache()
    for (model, variant), acc in step.items():
        log(f"winograd per {model} train step at {variant} (fwd + dgrad + wgrad over "
            f"its routed layers): kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} "
            f"ms, library {acc['library_ms']:.4f} ms, bound "
            f"{bound(acc['bytes'], acc['flops'])['bound_ms']:.4f} ms")
    main = step[("fcn8s", "f2")]
    return {"max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "library_ms": main["library_ms"], **bound(main["bytes"], main["flops"])}


def drive_segnet_winograd(torch, tmp: str) -> dict:
    """SegNet (segnet_kitti, full width) with ``--model-kw winograd=f4``:
    a Predictor built as the serving CLIs build it, called on a generated
    image, and one train step of the preset's workload
    (tools/profile_train.py's train_workload)."""
    import math
    from argparse import ArgumentParser

    import numpy as np
    from PIL import Image

    from profile_train import WORKLOADS, train_workload
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor,
    )

    png = os.path.join(tmp, "kitti_like.png")
    write_png(png, seed=0)
    img = np.asarray(Image.open(png).convert("RGB"))
    p = ArgumentParser()
    add_model_args(p)
    args = p.parse_args(["--preset", "segnet_kitti", "--model-kw", "winograd=f4",
                         "--device", "cuda"])
    pred = build_predictor(args, torch.device("cuda"))
    overlay, labels = pred(img)
    if overlay.shape != (*IMAGE_HW, 3) or labels.shape != IMAGE_HW:
        raise AssertionError("segnet f4 Predictor: bad output shapes")
    del pred
    step = train_workload(torch, WORKLOADS["segnet"], model_kw={"winograd": "f4"})
    loss = step()["loss"].item()
    torch.cuda.synchronize()
    if not math.isfinite(loss):
        raise AssertionError(f"segnet f4 train step: loss {loss}")
    log(f"segnet_kitti winograd=f4: Predictor overlay {overlay.shape}, road fraction "
        f"{float(labels.mean()):.3f}; one train step (batch 8, 320x1152), loss {loss:.5f}")
    return {"segnet_f4_loss": loss}


def check_winograd_end_to_end(torch) -> None:
    """The full fcn8s_kitti forward with winograd=f2 (bf16, kernel 6 on the
    routed layers) held against the float32 direct model (plain stage1, TF32
    off), beside the default bf16 build against the same f32 model, same
    weights and image.

    Bound, written before the first run: F(2,3) rounds V and U to bf16
    where the direct conv rounds only its inputs, measured at 1.5-1.7x the
    direct conv's bf16 error per layer (the JAX package's numerics harness);
    FCN-8s in bf16 sits ~0.014 relative L2 from f32 (tools/
    rounding_sensitivity.py). So the f2 build's relative L2 distance to the
    f32 logits at most 2x the default build's plus 0.005, and its labels'
    agreement with f32's at least the default build's less 0.5 point."""
    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    dev = torch.device("cuda")
    weights = init_params(build_model("fcn8s", 2, device=dev),
                          torch.Generator(device=dev).manual_seed(3)).state_dict()

    def logits(x, **kw):
        model = build_model("fcn8s", 2, device=dev, **kw)
        model.load_state_dict(weights)
        return Predictor(model, IMAGE_HW, device=dev)._padded_logits(x)

    img = np.random.default_rng(5).integers(0, 256, (1, *IMAGE_HW, 3), np.uint8)
    x = torch.from_numpy(img).to(dev)
    lw = logits(x, winograd="f2")
    ld = logits(x)
    lr = logits(x, packed_stage1=False, dtype=torch.float32)
    if lw.shape != (1, *PADDED_HW, 2) or not torch.isfinite(lw).all():
        raise AssertionError(f"winograd logits {tuple(lw.shape)} not finite/expected")

    def labels(t):
        return t[..., 1] > t[..., 0]

    ew, ed = rel_l2(lw, lr), rel_l2(ld, lr)
    aw = (labels(lw) == labels(lr)).float().mean().item()
    ad = (labels(ld) == labels(lr)).float().mean().item()
    log(f"end to end fcn8s_kitti winograd=f2: relative L2 to the f32 direct logits "
        f"{ew:.4g}, default bf16 build {ed:.4g} (bound 2x + 0.005); labels equal to "
        f"f32's {100 * aw:.3f} %, default {100 * ad:.3f} % (bound default - 0.5)")
    if ew > 2 * ed + 0.005 or aw < ad - 0.005:
        raise AssertionError("winograd end-to-end check failed")


# --- kernel 1c (the halo mode of the stage1 tail) and the spatial grid -------


def _band(t, parts, i, fill):
    """Rows band i of ``parts`` of ``t`` and its halo rows (the neighbours'
    boundary rows, ``fill`` at the image's edge), each contiguous."""
    rows = t.shape[1] // parts
    lo, hi = i * rows, (i + 1) * rows
    edge = t[:, :1].clone().fill_(fill)
    top = t[:, lo - 1:lo] if i else edge
    bot = t[:, hi:hi + 1] if i < parts - 1 else edge
    return t[:, lo:hi].contiguous(), top.contiguous(), bot.contiguous()


def _halo_fwd(torch, fn, z1, k2, b2, b1, mode, parts):
    outs = [fn(*_band(z1, parts, i, float("-inf")), k2, b2, b1, mode)
            for i in range(parts)]
    if parts == 1:            # no copy of a single band
        return (outs[0], None) if mode == "infer" else outs[0]
    if mode == "infer":
        return torch.cat(outs, 1), None
    return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)


def _halo_bwd(torch, fn, g, out, codes, z1, k2, b1, parts):
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import BwdHalos

    res = []
    for i in range(parts):
        gb, gt, gbt = _band(g, parts, i, 0.0)
        ob, ot, obt = _band(out, parts, i, 0.0)
        cb, ct, cbt = _band(codes, parts, i, 0)
        zb, zt, zbt = _band(z1, parts, i, float("-inf"))
        res.append(fn(gb, ob, cb, zb, k2, b1,
                      BwdHalos(gt, gbt, ot, obt, ct, cbt, zt, zbt)))
    if parts == 1:
        return res[0]
    return (torch.cat([r[0] for r in res], 1),
            *(sum(r[k] for r in res) for k in (1, 2, 3)))


def check_stage1_halo(torch, gen) -> dict:
    """Kernel 1c (the halo mode of kernels 1/1b and 3: z1 without b1, rows
    -1 and H from halo rows) on the card, at the training shapes
    [8,320,1152,64] and [16,320,1152,64] (deeplab_kitti_os16 --spatial, codes
    only) and the inference shape [1,384,1248,64], over the whole image
    (-inf halo rows) and as two halves with real halo rows.

    Forward, all three epilogues: bit-equal to the single-device kernel on
    z1 + b1 (the same bf16 add), codes included; against the plain version
    within check_stage1's bf16 bound, codes on >= 99.9 %; the halves joined
    bit-equal to the whole image. Backward: against its f32 plain version
    with kernel 1b's bounds (dz1 one bf16 ulp + 2^-12 of the scale; dk2,
    db2, db1 1e-4 of the scale); the halves' dz1 bit-equal to the whole
    image's, their summed dk2, db2, db1 within 1e-4 of its scale; reruns
    bit-identical. Integer inputs with an integer b1 (every sum exact),
    whole and as halves, at a shape where each block takes one tile and at
    one where it walks several: every output bit-equal to the plain
    versions. Then 1c's forward and backward timed against their plain
    versions and beside kernels 1 and 1b on the same inputs, in turns."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        stage1_tail, stage1_tail_bwd, stage1_tail_halo, stage1_tail_halo_bwd,
        stage1_tail_halo_bwd_plain, stage1_tail_halo_plain, stage1_tail_segnet,
        stage1_tail_train,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.tie_cases import (
        int_case, tie_windows,
    )

    single = {"infer": lambda z, k, b: (stage1_tail(z, k, b), None),
              "codes": stage1_tail_train, "segnet": stage1_tail_segnet}

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)

    result = {}
    for (n, h, w, c), modes in ((TRAIN_SHAPE, ("codes", "segnet")),
                                (DEEPLAB_TRAIN_SHAPE, ("codes",)),
                                ((1, *PADDED_HW, 64), ("infer", "codes", "segnet"))):
        z1, b1 = rand((n, h, w, c), 1.0), rand((c,), 0.5)
        k2 = rand((c, c, 3, 3), (1.0 / (9 * c)) ** 0.5).contiguous(
            memory_format=torch.channels_last)
        b2, g = rand((c,), 0.1), rand((n, h // 2, w // 2, c), 1.0)
        fwd_err = 0.0
        for mode in modes:
            out, codes = _halo_fwd(torch, stage1_tail_halo, z1, k2, b2, b1, mode, 1)
            ref_out, ref_codes = single[mode]((z1 + b1).contiguous(), k2, b2)
            p_out, p_codes = _halo_fwd(torch, stage1_tail_halo_plain, z1, k2, b2, b1,
                                       mode, 1)
            h_out, h_codes = _halo_fwd(torch, stage1_tail_halo, z1, k2, b2, b1, mode, 2)
            torch.cuda.synchronize()
            err = (out.float() - p_out.float()).abs()
            bad = int((err > 2 ** -6 * (p_out.float().abs() + b2.float().abs())
                       + 1e-6).sum())
            agree = 1.0 if codes is None else (codes == p_codes).float().mean().item()
            exact = torch.equal(out, ref_out) and torch.equal(h_out, out) and (
                codes is None or (torch.equal(codes, ref_codes)
                                  and torch.equal(h_codes, codes)))
            log(f"stage1 halo {mode} [{n},{h},{w},{c}]: max_abs_err {err.max().item():.6g}"
                f" vs plain ({bad} outside the bf16 bound), codes agree "
                f"{100 * agree:.4f} %; bit-equal to the single-device kernel on "
                f"z1 + b1 and, as two halves, to the whole image: {exact}")
            if bad or agree < 0.999 or not exact:
                raise AssertionError(f"stage1 halo {mode} forward [{n},{h},{w},{c}]")
            fwd_err = max(fwd_err, err.max().item())
        out, codes = _halo_fwd(torch, stage1_tail_halo, z1, k2, b2, b1, "codes", 1)
        got = _halo_bwd(torch, stage1_tail_halo_bwd, g, out, codes, z1, k2, b1, 1)
        want = _halo_bwd(torch, stage1_tail_halo_bwd_plain, g, out, codes, z1, k2,
                         b1, 1)
        halves = _halo_bwd(torch, stage1_tail_halo_bwd, g, out, codes, z1, k2, b1, 2)
        again = _halo_bwd(torch, stage1_tail_halo_bwd, g, out, codes, z1, k2, b1, 1)
        errs = []
        for name, a, b, rel, near0 in zip(("dz1", "dk2", "db2", "db1"), got, want,
                                          (2 ** -7, 0, 0, 0),
                                          (2 ** -12, 1e-4, 1e-4, 1e-4)):
            a, b = a.float(), b.float()
            e = (a - b).abs()
            errs.append(e.max().item())
            if int((e > rel * b.abs() + near0 * b.abs().max()).sum()) or \
                    not torch.isfinite(a).all():
                raise AssertionError(f"stage1 halo bwd [{n},{h},{w},{c}] {name}")
        halves_ok = torch.equal(halves[0], got[0]) and all(
            bool(((a - b).abs() <= 1e-4 * b.abs().max()).all())
            for a, b in zip(halves[1:], got[1:]))
        rerun = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"stage1 halo bwd [{n},{h},{w},{c}] against the f32 reference: max_abs_err "
            f"dz1 {errs[0]:.6g} dk2 {errs[1]:.6g} db2 {errs[2]:.6g} db1 {errs[3]:.6g} "
            f"(max |ref| {[round(t.abs().max().item(), 4) for t in want]}); halves: "
            f"dz1 bit-equal, dk2/db2/db1 within 1e-4 of scale: {halves_ok}; "
            f"bit-identical rerun: {rerun}")
        if not (halves_ok and rerun):
            raise AssertionError(f"stage1 halo bwd [{n},{h},{w},{c}]: halves or rerun")
        if (n, h, w, c) == TRAIN_SHAPE:
            result = {"max_abs_err": max(fwd_err, *errs), "fwd_err": fwd_err,
                      "dz1_err": errs[0], "dk2_err": errs[1], "db2_err": errs[2],
                      "db1_err": errs[3]}
            zb = (z1 + b1).contiguous()
            ob, cb = stage1_tail_train(zb, k2, b2)
            tf = ab_ms(lambda: _halo_fwd(torch, stage1_tail_halo_plain, z1, k2, b2,
                                         b1, "codes", 1),
                       lambda: _halo_fwd(torch, stage1_tail_halo, z1, k2, b2, b1,
                                         "codes", 1))
            tb = ab_ms(lambda: _halo_bwd(torch, stage1_tail_halo_bwd_plain, g, out,
                                         codes, z1, k2, b1, 1),
                       lambda: _halo_bwd(torch, stage1_tail_halo_bwd, g, out, codes,
                                         z1, k2, b1, 1))
            show_ab(f"stage1 halo forward (codes) at {list(TRAIN_SHAPE)}", tf)
            fr = forward_rate(torch, "1c (codes)", tf["ms"], zb, k2)
            show_ab(f"stage1 halo backward at {list(TRAIN_SHAPE)}", tb)
            # kernels 1 (training forward) and 1b on the same inputs, in turns
            # with 1c: forward 1, 1c, 1c, 1; backward likewise
            one = [device_ms(f)[0] for f in (
                lambda: stage1_tail_train(zb, k2, b2),
                lambda: _halo_fwd(torch, stage1_tail_halo, z1, k2, b2, b1, "codes", 1),
                lambda: _halo_fwd(torch, stage1_tail_halo, z1, k2, b2, b1, "codes", 1),
                lambda: stage1_tail_train(zb, k2, b2),
                lambda: stage1_tail_bwd(g, ob, cb, zb, k2),
                lambda: _halo_bwd(torch, stage1_tail_halo_bwd, g, out, codes, z1,
                                  k2, b1, 1),
                lambda: _halo_bwd(torch, stage1_tail_halo_bwd, g, out, codes, z1,
                                  k2, b1, 1),
                lambda: stage1_tail_bwd(g, ob, cb, zb, k2))]
            log(f"beside kernels 1/1b at {list(TRAIN_SHAPE)} (device ms, in turns): "
                f"forward 1 {(one[0] + one[3]) / 2:.4f} vs 1c {(one[1] + one[2]) / 2:.4f},"
                f" backward 1b {(one[4] + one[7]) / 2:.4f} vs 1c "
                f"{(one[5] + one[6]) / 2:.4f}")
            halo_launch = backward_by_launch(
                torch, lambda: _halo_bwd(torch, stage1_tail_halo_bwd, g, out, codes,
                                         z1, k2, b1, 1), g, out, codes, zb, k2, "1c")
            nhwc = n * h * w * c
            # forward: z1 and its halo rows, b1, b2, weights in; out, codes out
            bf = bound(2 * nhwc + 4 * n * w * c + 3 * nhwc / 4 + 2 * 9 * c * c + 4 * c,
                       conv3x3_flops(n, h, w, c))
            # backward: g, out, codes and their halo rows, z1 and its halo
            # rows, b1, weights in; dz1, dk2, db2, db1 out; dgrad + wgrad
            bb = bound(5 * nhwc / 4 + 5 * n * w * c + 4 * nhwc + 4 * n * w * c
                       + 2 * 9 * c * c + 4 * 9 * c * c + 8 * c + 2 * c,
                       2 * conv3x3_flops(n, h, w, c))
            result.update(ms=tf["ms"] + tb["ms"], plain_ms=tf["plain_ms"] + tb["plain_ms"],
                          bound_ms=bf["bound_ms"] + bb["bound_ms"],
                          bound_by="operations", library_ms=None,
                          fwd_ms=tf["ms"], fwd_plain_ms=tf["plain_ms"],
                          fwd_bound_ms=bf["bound_ms"], fwd_library_ms=fr["library_ms"],
                          bwd_ms=tb["ms"],
                          bwd_plain_ms=tb["plain_ms"], bwd_bound_ms=bb["bound_ms"],
                          kernel1_fwd_ms=(one[0] + one[3]) / 2,
                          kernel1b_bwd_ms=(one[4] + one[7]) / 2,
                          bwd_dgrad_ms=halo_launch["dgrad_ms"],
                          bwd_library_dgrad_ms=halo_launch["library_dgrad_ms"])
        del z1, k2, b2, b1, g, out, codes, got, want, halves, again

    for n, h, w, c in ((2, 16, 48, 64), (8, 64, 256, 64)):
        for case in (tie_windows, int_case):
            z1, k2, b2 = (t.to("cuda", torch.bfloat16) for t in case(n, h, w, c, 1))
            b1 = torch.randint(-1, 2, (c,), generator=torch.Generator().manual_seed(3)
                               ).to("cuda", torch.bfloat16)
            z1 = (z1 - b1).contiguous()               # pre-bias, still integer
            cot = torch.randint(-3, 4, (n, h // 2, w // 2, c), generator=torch.Generator()
                                .manual_seed(2)).to("cuda", torch.bfloat16)
            p_out, p_codes = _halo_fwd(torch, stage1_tail_halo_plain, z1, k2, b2, b1,
                                       "codes", 1)
            want = _halo_bwd(torch, stage1_tail_halo_bwd_plain, cot, p_out, p_codes,
                             z1, k2, b1, 1)
            for parts in (1, 2):
                out, codes = _halo_fwd(torch, stage1_tail_halo, z1, k2, b2, b1,
                                       "codes", parts)
                got = _halo_bwd(torch, stage1_tail_halo_bwd, cot, out, codes, z1, k2,
                                b1, parts)
                if not (torch.equal(out, p_out) and torch.equal(codes, p_codes)
                        and all(torch.equal(a, b) for a, b in zip(got, want))):
                    raise AssertionError(f"stage1 halo {case.__name__} [{n},{h},{w},"
                                         f"{c}] in {parts} part(s): not exact")
            log(f"stage1 halo {case.__name__} [{n},{h},{w},{c}] (integer, integer b1):"
                " codes, out, dz1, dk2, db2, db1 exact, whole and as halves")
    return result


def drive_spatial_training(torch, tmp: str, preset: str, data: str | None = None,
                           steps: int = 3) -> dict:
    """``train.main --spatial 2`` at one rank, through the entry point: the
    SPMD-safe kwargs merge in and the step runs unsharded through kernel 1c
    (``steps`` steps at ``preset`` over 24 generated images or ``data``, its
    crops kept as the JAX script keeps them on one device,
    --pallas-preprocess, then --resume)."""
    import math

    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train

    if data is None:
        data = generate_synthetic_kitti(os.path.join(tmp, "data_road"), n_train=24,
                                        n_test=1, h=IMAGE_HW[0], w=IMAGE_HW[1], seed=0)
    ck = os.path.join(tmp, "ckpt")
    argv = ["--preset", preset, "--data-dir", data, "--epochs", "1", "--spatial", "2",
            "--pallas-preprocess", "--checkpoint-dir", ck, "--device", "cuda"]
    t0 = time.perf_counter()
    if train.main(argv) != 0:
        raise AssertionError(f"train.main --spatial 2 {preset} failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(ck, "logs", "train.jsonl")) as f:
        epoch = [json.loads(line) for line in f][-1]
    loss = epoch.get("epoch/loss", float("nan"))
    if not math.isfinite(loss) or epoch.get("step") != steps:
        raise AssertionError(f"train --spatial 2: loss {loss} at {epoch.get('step')}")
    if train.main(argv[:5] + ["0"] + argv[6:] + ["--resume"]) != 0:
        raise AssertionError(f"train.main --spatial 2 {preset} --resume failed")
    log(f"train.main --spatial 2 {preset} at one rank: {steps} steps, loss {loss:.4f}, then "
        f"--resume; {wall:.1f} s wall")
    return {"spatial_cli_wall_s": wall, "spatial_cli_loss": loss}


# the grid phase's workloads: fcn8s_kitti at full width on 8 full 384x1248
# images (192 + 192 rows at stride 32), and unet_cityscapes at full width on
# 4 images of 496x1024: 31 blocks of 16 rows, which split unevenly, 256 + 240
GRID = {"fcn8s_kitti": dict(model="fcn8s", classes=2, n=8, hw=PADDED_HW, stride=32,
                            seed=11, kernels=("stage1_tail_halo", "stage1_tail_halo_bwd")),
        "unet_cityscapes": dict(model="unet", classes=19, n=4, hw=(496, 1024),
                                stride=16, seed=12, kernels=("preprocess_normalize",)),
        # SegNet with BatchNorm: 352 rows, 11 blocks of 32 -> 192 + 160;
        # its gradients are held to the f32 step's (check_grid)
        "segnet_kitti_bn": dict(model="segnet", preset="segnet_kitti",
                                model_kw={"use_bn": True}, classes=2, n=4,
                                hw=(352, 1248), stride=32, seed=13, f32_ref=True,
                                kernels=("pool_argmax", "unpool", "unpool_bwd"))}


def _grid_state(torch, dev, workload, weights=None, dtype=None):
    """The grid workload's preset model at full width with the SPMD-safe
    kwargs (for FCN pallas_spmd; no Winograd), dropout 0, Adam 1e-4, seeded
    (or given) weights; ``dtype`` the compute dtype (default bf16)."""
    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
        build_model, merge_spmd_safe_kwargs,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.state import (
        create_train_state, make_lr_schedule, make_optimizer,
    )

    g = GRID[workload]
    kw = merge_spmd_safe_kwargs(g["model"], dict(
        get_preset(g.get("preset", workload)).model_kwargs, **g.get("model_kw", {})))
    if g["model"] == "fcn8s":
        kw["dropout_rate"] = 0.0
    if dtype is not None:
        kw["dtype"] = dtype
    model = build_model(g["model"], g["classes"], device=dev, **kw)
    if weights is None:
        init_params(model, torch.Generator(device=dev).manual_seed(g["seed"]))
    else:
        model.load_state_dict(weights)
    return create_train_state(model, make_optimizer("adam", model.parameters(), 1e-4),
                              make_lr_schedule(1e-4), seed=0)


def _grid_batch(torch, dev, workload):
    """FCN and SegNet: generated road scenes; U-Net: random images and
    19-class labels (seeded)."""
    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import _road_scene

    g = GRID[workload]
    rng = np.random.default_rng(4)
    if g["model"] != "unet":
        imgs, lbls = zip(*(_road_scene(rng, *g["hw"]) for _ in range(g["n"])))
        imgs, lbls = np.stack(imgs), np.stack(lbls)
    else:
        imgs = rng.integers(0, 256, (g["n"], *g["hw"], 3), np.uint8)
        lbls = rng.integers(0, g["classes"], (g["n"], *g["hw"])).astype(np.int32)
    return {"image": torch.from_numpy(imgs).to(dev),
            "label": torch.from_numpy(lbls).to(dev)}


def grid_rank(rank: int, world: int, store: str, job: str, out: str) -> int:
    """One rank of the grid phase (``chip_smoke.py --grid-rank``): gloo on
    cuda:0, a data 1 x spatial 2 grid with the rows split at the model's
    stride (``Grid.at_height``: unevenly where the blocks do not divide),
    two train steps of the job's workload on this rank's rows of its batch
    from the job's weights, then timed steps and one profiled step; rank 0
    saves the first step's gradients. A job with ``control`` (check_grid's
    negative control) makes every BatchNorm take its statistics over this
    rank's rows alone and runs the two steps only."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    sys.path[:0] = [REPO]
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import (
        pool as cuda_pool, preprocess as cuda_preprocess, stage1 as cuda_stage1,
    )
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import make_grid
    from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step
    from semanticsegmentation_tensorflow_tpu_torch.utils import tracing

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    spec = torch.load(job, map_location=dev)
    g = GRID[spec["workload"]]
    if spec.get("control"):
        from semanticsegmentation_tensorflow_tpu_torch.models.common import BatchNorm

        BatchNorm._group = lambda self, grid: False     # the rank's own pixels
    grid = make_grid(1, world).at_height(g["hw"][0], g["stride"])
    state = _grid_state(torch, dev, spec["workload"], spec["weights"])
    rows = grid.rows(g["hw"][0], g["stride"])
    batch = {k: v[:, rows].contiguous()
             for k, v in _grid_batch(torch, dev, spec["workload"]).items()}
    step = make_train_step(g["classes"], mesh=grid,
                           augment_fn=cuda_preprocess.make_preprocess_augment_fn(
                               MEAN, STD, None))
    wrappers = [getattr(cuda_preprocess if k.startswith("preprocess") else
                        cuda_pool if "pool" in k else cuda_stage1, k)
                for k in g["kernels"]]
    for w in wrappers:
        w.launches = 0
    losses, cms = [], []
    for i in range(2):
        o = step(state, batch)
        losses.append(o["loss"].item())
        cms.append(o["cm"].cpu())
        if i == 0 and rank == 0:
            torch.save({k: p.grad.float().cpu() for k, p in
                        state.model.named_parameters()}, out + ".grads")
    launches = tuple(w.launches for w in wrappers)
    if spec.get("control"):
        torch.save({"losses": losses, "cms": cms}, out)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    ms = cuda_ms(lambda: step(state, batch), iters=4, warmup=1)
    tracing.enable()        # the spans enter record_function only when on
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        tracing.disable()
    spans = {k: 0.0 for k in ("halo_exchange", "grid_all_reduce")}
    for e in prof.key_averages():
        if e.key in spans:
            spans[e.key] = e.cpu_time_total / 1e3
    torch.save({"losses": losses, "cms": cms, "launches": launches, "ms": ms,
                "rows": rows.stop - rows.start, "profiled_wall_ms": wall,
                "spans_ms": spans,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _spawn_ranks(tmp: str, workload: str, weights,
                 control: bool = False) -> tuple[list, list[str]]:
    """Start check_grid's two ranks (``chip_smoke.py --grid-rank``) on a job
    of ``workload`` from ``weights``; returns the processes and each rank's
    output file."""
    import torch

    tag = f"{workload}_control" if control else workload
    job = os.path.join(tmp, f"grid_{tag}.pt")
    torch.save({"workload": workload, "weights": weights, "control": control}, job)
    store = os.path.join(tmp, f"grid_store_{tag}")
    outs = [os.path.join(tmp, f"grid_{tag}_rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--grid-rank",
                               str(r), "2", store, job, outs[r]]) for r in range(2)]
    return procs, outs


def _wait_ranks(procs) -> None:
    for p in procs:
        if p.wait(timeout=600) != 0:
            raise AssertionError(f"grid rank exited with {p.returncode}")


def _kill_ranks(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()


def _grid_numbers(torch, g: dict, outs: list, ref: dict, fed: set) -> dict:
    """check_grid's numbers for the ranks' outputs ``outs`` against the
    single-process reference ``ref`` (its losses, confusion matrices, first
    gradients and, with ``f32_ref``, the f32 step's gradients): the worst
    loss's relative distance, the worst first gradient (the conv biases in
    ``fed`` left out) and the share of labels that agree."""
    ranks = [torch.load(o) for o in outs]
    grads = torch.load(outs[0] + ".grads")
    worst, worst_name = 0.0, ""
    for k, gr in ref["grads"].items():
        if k in fed:
            continue
        if g.get("f32_ref"):    # the distance to f32 over its bound
            r = ref["f32_grads"][k]
            rel = rel_l2(grads[k], r) / (2 * rel_l2(gr, r) + 2 ** -8 / r.numel() ** 0.5)
        else:
            rel = ((grads[k] - gr).norm() / gr.norm().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, k
    agree = min(1 - (a - b).abs().sum().item() / (2 * b.sum().item())
                for a, b in zip(ranks[0]["cms"], ref["cms"]))
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], ref["losses"]))
    return {"ranks": ranks, "worst": worst, "worst_name": worst_name, "agree": agree,
            "rel_loss": rel_loss, "same": ranks[0]["losses"] == ranks[1]["losses"]}


def check_grid(torch, tmp: str, smi: str, workload: str = "fcn8s_kitti") -> dict:
    """The 2-rank grid (data 1 x spatial 2) with gloo on cuda:0: two ranks
    sharing one GPU, each holding its rows of the workload's batch (``GRID``:
    fcn8s_kitti's 8 full 384x1248 images, 192 rows each; unet_cityscapes' 4
    images of 496x1024, 256 and 240 rows), flips by the preprocess kernel,
    two Adam steps through the halo exchange (and kernel 1c for FCN), held
    against the single-process run of the same step (pallas_spmd at one
    rank for FCN) with check_train_step's bounds: both losses within 1e-3
    relative, each parameter's first gradient within 5e-2 of its L2 norm
    (with ``f32_ref``, BatchNorm's SegNet, whose BN biases' gradients are
    sums that nearly cancel, so that bf16's rounding moves them by their
    own size between two cuDNN plans: each leaf's distance to the f32
    single-process step's within 2x the bf16 single-process step's own
    plus 2^-8/sqrt(numel), as check_segnet_train_step holds SegNet; a conv
    bias that feeds a BatchNorm left out either way: ``bn_fed_biases``),
    the confusion matrices on >= 99.5 % of the labels. With ``f32_ref`` a
    negative control follows: the same two ranks with every BatchNorm's
    statistics over the rank's own rows (the data-grid semantics, wrong on
    a grid that splits rows) must fall outside those bounds. Then ms per
    step (4 steps, CUDA events) and the exchange's and the gradient
    all-reduce's share of one profiled step. Two ranks on one card over
    gloo: not a multi-GPU number."""
    from semanticsegmentation_tensorflow_tpu_torch.models.common import bn_fed_biases
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
        make_preprocess_augment_fn,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

    g = GRID[workload]
    dev = torch.device("cuda")
    ref_state = _grid_state(torch, dev, workload)
    weights = {k: v.clone() for k, v in ref_state.model.state_dict().items()}
    fed = bn_fed_biases(ref_state.model)
    procs, outs = _spawn_ranks(tmp, workload, weights)
    try:
        # the single-process reference runs while the ranks start
        batch = _grid_batch(torch, dev, workload)
        step = make_train_step(g["classes"],
                               augment_fn=make_preprocess_augment_fn(MEAN, STD, None))
        ref = {"losses": [], "cms": []}
        for i in range(2):
            o = step(ref_state, batch)
            ref["losses"].append(o["loss"].item())
            ref["cms"].append(o["cm"].cpu())
            if i == 0:
                ref["grads"] = {k: p.grad.float().cpu()
                                for k, p in ref_state.model.named_parameters()}
        single_ms = cuda_ms(lambda: step(ref_state, batch), iters=4, warmup=1)
        del ref_state
        if g.get("f32_ref"):
            from profile_train import plain_pools

            f32 = _grid_state(torch, dev, workload, weights, dtype=torch.float32)
            with plain_pools():     # the pool kernels take bf16
                step(f32, batch)
            ref["f32_grads"] = {k: p.grad.float().cpu()
                                for k, p in f32.model.named_parameters()}
            del f32
        del batch
        torch.cuda.empty_cache()
        _wait_ranks(procs)
    finally:
        _kill_ranks(procs)
    got = _grid_numbers(torch, g, outs, ref, fed)
    ranks, worst, agree, rel_loss = got["ranks"], got["worst"], got["agree"], got["rel_loss"]
    gbound, gwhat = ((1.0, "distance to f32 over its bound") if g.get("f32_ref")
                     else (5e-2, "|dg|/|g|"))
    r0 = ranks[0]
    n, (h, w) = g["n"], g["hw"]
    share = {k: v / r0["profiled_wall_ms"] for k, v in r0["spans_ms"].items()}
    log(f"grid data1 x spatial2 (2 gloo ranks sharing cuda:0), {workload}, {n} x "
        f"{h}x{w}, rows {[r['rows'] for r in ranks]}: losses {r0['losses']} vs "
        f"single-process {ref['losses']} (max rel {rel_loss:.3g}, bound 1e-3); worst "
        f"first gradient {gwhat} {worst:.4g} ({got['worst_name']}, bound {gbound:g}); "
        f"labels agree >= {100 * agree:.4f} % (bound 99.5 %); both ranks' losses "
        f"equal: {got['same']}; launches on rank 0 "
        f"{dict(zip(g['kernels'], r0['launches']))}")
    log(f"grid step {workload}: {r0['ms']:.2f} ms/step, {n / r0['ms'] * 1e3:.2f} "
        f"images/s (two ranks sharing one GPU over gloo, not a multi-GPU number; the "
        f"single-process step of the same model {single_ms:.2f} ms); one profiled "
        f"step {r0['profiled_wall_ms']:.2f} ms: halo exchange "
        f"{r0['spans_ms']['halo_exchange']:.2f} ms ({100 * share['halo_exchange']:.1f} %)"
        f", gradient all-reduce {r0['spans_ms']['grid_all_reduce']:.2f} ms "
        f"({100 * share['grid_all_reduce']:.1f} %); peak memory per rank "
        f"{r0['peak_gib']:.2f} GiB | {smi}")
    if not (rel_loss <= 1e-3 and worst <= gbound and agree >= 0.995 and got["same"]
            and all(r0["launches"])
            and sum(r["rows"] for r in ranks) == h):
        raise AssertionError(f"the {workload} grid step is outside the bounds")
    res = {"grid_ms": r0["ms"], "grid_images_per_s": n / r0["ms"] * 1e3,
           "grid_single_ms": single_ms, "grid_exchange_share": share["halo_exchange"],
           "grid_all_reduce_share": share["grid_all_reduce"],
           "grid_rows": [r["rows"] for r in ranks],
           "grid_launches": list(r0["launches"]),
           "grid_loss_rel": rel_loss, "grid_worst": worst, "grid_agree": agree}
    if g.get("f32_ref"):
        procs, outs = _spawn_ranks(tmp, workload, weights, control=True)
        try:
            _wait_ranks(procs)
        finally:
            _kill_ranks(procs)
        bad = _grid_numbers(torch, g, outs, ref, fed)
        caught = [name for name, v, b in (("loss", bad["rel_loss"], 1e-3),
                                          ("gradient", bad["worst"], gbound))
                  if v > b] + (["labels"] if bad["agree"] < 0.995 else [])
        log(f"grid {workload} negative control (each rank's BatchNorm statistics "
            f"over its own rows): losses {bad['ranks'][0]['losses']}, max rel "
            f"{bad['rel_loss']:.3g} (bound 1e-3); worst first gradient {gwhat} "
            f"{bad['worst']:.4g} ({bad['worst_name']}, bound {gbound:g}); labels "
            f"agree >= {100 * bad['agree']:.4f} % (bound 99.5 %); outside the bounds: "
            f"{caught or 'none'}")
        if not caught:
            raise AssertionError(f"the {workload} grid check passes a grid whose "
                                 "BatchNorm takes each rank's own statistics")
        res.update(control_loss_rel=bad["rel_loss"], control_worst=bad["worst"],
                   control_worst_name=bad["worst_name"], control_agree=bad["agree"],
                   control_caught=caught)
    return res


def time_train(torch, smi: str, workload: str) -> dict:
    """Steady-state train images/s, peak device memory and the device's
    idle share at one of tools/profile_train.py's workloads (FCN-8s or
    SegNet, uint8 batch on the device, Adam 1e-4, the preprocess kernel), by
    that tool's own timing code."""
    import math

    from profile_train import WORKLOADS, show_idle, time_train, train_workload

    wl = WORKLOADS[workload]
    torch.cuda.empty_cache()
    step = train_workload(torch, wl)
    r = time_train(torch, step, wl["n"], iters=8)
    del r["by_op"], step
    torch.cuda.empty_cache()
    log(f"train timing, {wl['what']}: {r['images_per_s']:.2f} images/s "
        f"({r['host_ms']:.2f} ms/step host clock, mean of 8), peak device "
        f"memory {r['peak_gib']:.2f} GiB, loss {r['loss']:.4f}; under the "
        f"profiler: device {r['device_ms']:.2f} ms/step in {r['ops']} ops, busy "
        f"{r['busy_ms']:.2f} ms/step, wall "
        f"{r['profiled_wall_ms']:.2f} ms/step, idle share "
        f"{show_idle(r['idle_share'])} | {smi}")
    if not math.isfinite(r["loss"]):
        raise AssertionError(f"train timing {workload}: loss {r['loss']}")
    return r


def deeplab_phase(torch, smi: str, drive) -> list[dict]:
    """DeepLab-ASPP through the user's entry points, each path run by
    ``drive`` (the launch counters at 0 just before, read just after):
    both presets through infer_image, serve and the Predictor, then the
    os8 forward with the kernels against plain PyTorch; deeplab_kitti_dp's
    training (batch 16, validation, EMA, --resume, infer_image), its train
    step with the kernels against plain PyTorch, and eval.py on its
    checkpoint, whose eval step is then held against plain PyTorch;
    deeplab_kitti_os16 --spatial 2 at one rank (kernel
    1c; os8's 376 rows do not split at 1/8); the preset steps timed with the
    dilated convs' share. Returns each path's launches."""
    single_stage1 = ("stage1_tail", "stage1_tail_train", "stage1_tail_bwd",
                     "stage1_tail_segnet")
    t_phase = time.perf_counter()
    dl_runs, dl = [], {}
    for dl_preset in ("deeplab_kitti_dp", "deeplab_kitti_os16"):
        with tempfile.TemporaryDirectory() as tmp:
            dl[dl_preset], launches = drive(f"{dl_preset} inference", drive_slice,
                                            torch, tmp, dl_preset)
        dl_runs.append(launches)
        missing = [k for k in ("stage1_tail", "overlay") if not launches[k]]
        if missing:
            raise AssertionError(f"not launched on the {dl_preset} inference path: "
                                 f"{missing}")
        torch.cuda.empty_cache()
    check_end_to_end(torch, "deeplab", DEEPLAB_OS8_HW)
    with tempfile.TemporaryDirectory() as tmp:
        dl_train, launches = drive("deeplab_kitti_dp training", drive_deeplab_training,
                                   torch, tmp)
        dl_runs.append(launches)
        missing = [k for k in ("stage1_tail_train", "stage1_tail_bwd",
                               "preprocess_normalize") if not launches[k]]
        if missing:
            raise AssertionError(f"not launched on the deeplab training path: {missing}")
        torch.cuda.empty_cache()
        check_train_step(torch, "deeplab_kitti_dp", fixed=False)
        torch.cuda.empty_cache()
        dl_eval, launches = drive("deeplab_kitti_dp eval", drive_deeplab_eval, torch,
                                  dl_train["data"], dl_train["ckpt"])
        dl_runs.append(launches)
        if not launches["stage1_tail"]:
            raise AssertionError(f"not launched on the deeplab eval path: {launches}")
        dl_eval["plain"] = check_eval_against_plain(
            torch, dl_train["data"], dl_train["ckpt"], dl_eval["eval"], "deeplab_kitti_dp")
        torch.cuda.empty_cache()
        sp_tmp = os.path.join(tmp, "spatial")
        os.makedirs(sp_tmp)
        dl_sp, launches = drive("deeplab_kitti_os16 --spatial 2 training",
                                drive_spatial_training, torch, sp_tmp,
                                "deeplab_kitti_os16", dl_train["data"], DEEPLAB_N // 16)
        dl_runs.append(launches)
        missing = [k for k in ("stage1_tail_halo", "stage1_tail_halo_bwd",
                               "preprocess_normalize") if not launches[k]]
        if missing or any(launches[k] for k in single_stage1):
            raise AssertionError(f"deeplab_kitti_os16 --spatial 2: launches {launches}")
    torch.cuda.empty_cache()
    dl_steps = {w: time_deeplab(torch, smi, w) for w in ("deeplab", "deeplab_os16")}
    log(f"DeepLab: Predictor overlay ms/image os8 "
        f"{dl['deeplab_kitti_dp']['predictor_overlay_ms']:.3f}, os16 "
        f"{dl['deeplab_kitti_os16']['predictor_overlay_ms']:.3f}; preset step os8 "
        f"{dl_steps['deeplab']['images_per_s']:.2f} images/s "
        f"({dl_steps['deeplab']['host_ms']:.2f} ms/step, peak "
        f"{dl_steps['deeplab']['peak_gib']:.2f} GiB), os16 "
        f"{dl_steps['deeplab_os16']['images_per_s']:.2f} images/s "
        f"({dl_steps['deeplab_os16']['host_ms']:.2f} ms/step, peak "
        f"{dl_steps['deeplab_os16']['peak_gib']:.2f} GiB); train.main peak "
        f"{dl_train['train_cli_peak_gib']:.2f} GiB; eval "
        f"{dl_eval['eval']['img_per_s']:.2f} img/s, --ema "
        f"{dl_eval['eval_ema']['img_per_s']:.2f} | {smi}")
    log(f"DeepLab phase: {time.perf_counter() - t_phase:.1f} s")
    log("deeplab timings: " + json.dumps(dict(
        dl, train={k: v for k, v in dl_train.items() if k not in ("data", "ckpt")},
        eval=dl_eval, spatial=dl_sp,
        steps={w: {k: v for k, v in r.items() if k != "by_op"}
               for w, r in dl_steps.items()})))
    torch.cuda.empty_cache()
    return dl_runs


# --- U-Net on Cityscapes (unet_cityscapes): kernels 2, 4 and 6 at its shapes --

UNET_HW, UNET_CROP = (512, 1024), (256, 512)   # stride 16 divides the images
UNET_TRAIN, UNET_VAL = 32, 16   # generated Cityscapes-layout images
# kernel 6 (winograd=f2) on U-Net's train step (batch 8, 256x512 crops): each
# eligible 3x3 conv's input shape (both widths multiples of 128), its output
# channels and how many of the step's 13 routed convs have it
UNET_WINOGRAD_TRAIN = (
    ((8, 128, 256, 128), 128, 2), ((8, 64, 128, 128), 256, 1),
    ((8, 64, 128, 256), 256, 2), ((8, 32, 64, 256), 512, 1),
    ((8, 32, 64, 512), 512, 2), ((8, 16, 32, 512), 1024, 1),
    ((8, 16, 32, 1024), 1024, 1), ((8, 32, 64, 1024), 512, 1),
    ((8, 64, 128, 512), 256, 1), ((8, 128, 256, 256), 128, 1))


def check_unet_kernels(torch, gen) -> dict:
    """Kernels 2, 4 and 6 against their plain versions at the shapes U-Net's
    paths give them: the overlay at [1,512,1024] C=19 (the Predictor's call,
    logits unpadded at stride 16; bytes and labels exact, timed beside the
    plain version and its bound), the preprocess kernel at [8,512,1024,3] ->
    256x512 crops (bytes exact, timed), and kernel 6 (F(2,3)) at every
    eligible conv of the train step (UNET_WINOGRAD_TRAIN: the bias_relu
    forward, the masked dgrad and the masked wgrad, with check_winograd's
    bounds) and of the 512x1024 Predictor forward (the bias_relu forward),
    then each train shape's three ops timed by CUDA events (kernel, plain,
    cuDNN) and summed over one U-Net f2 step."""
    from overlay_ab import work

    from semanticsegmentation_tensorflow_tpu_torch.data.palette import CITYSCAPES_PALETTE
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
        argmax_colormap_overlay_cuda, argmax_colormap_overlay_plain,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
        preprocess_normalize, preprocess_normalize_plain,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import rot180_swap

    res = {}
    (h, w), c = UNET_HW, 19
    img = torch.randint(0, 256, (1, h, w, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    logits = torch.randn((1, h, w, c), generator=gen, device="cuda")
    pal = torch.as_tensor(CITYSCAPES_PALETTE, device="cuda")
    ov_k, lab_k = argmax_colormap_overlay_cuda(img, logits, pal, 0.5)
    ov_p, lab_p = argmax_colormap_overlay_plain(img, logits, pal, 0.5)
    if not (torch.equal(lab_k, lab_p) and torch.equal(ov_k, ov_p)):
        raise AssertionError("overlay at U-Net's [1,512,1024] C=19: not exact")
    t = ab_ms(lambda: argmax_colormap_overlay_plain(img, logits, pal, 0.5),
              lambda: argmax_colormap_overlay_cuda(img, logits, pal, 0.5))
    b = bound(work(1, h, w, c))
    show_ab("overlay at U-Net's [1,512,1024], C=19 (labels and bytes exact)", t)
    res["overlay"] = dict(t, **b)
    log(f"overlay [1,512,1024] C=19: {100 * b['bound_ms'] / t['ms']:.1f} % of its "
        f"bound {b['bound_ms']:.4f} ms")

    n = 8
    x8 = torch.randint(0, 256, (n, h, w, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)
    args = (x8, torch.tensor([True, False] * 4), torch.tensor([0, 256, 13, 37, 256, 1, 50, 0]),
            torch.tensor([512, 0, 5, 71, 96, 511, 33, 60]), UNET_CROP, MEAN, STD)
    if not torch.equal(preprocess_normalize(*args), preprocess_normalize_plain(*args)):
        raise AssertionError("preprocess at U-Net's [8,512,1024,3] -> 256x512: "
                             "kernel bytes differ from plain")
    t = ab_ms(lambda: preprocess_normalize_plain(*args), lambda: preprocess_normalize(*args))
    px = n * UNET_CROP[0] * UNET_CROP[1] * 3
    b = bound(px + 4 * px, 2 * px, F32_FLOP_PER_S)
    show_ab("preprocess at U-Net's [8,512,1024,3] -> 256x512 (bytes exact)", t)
    res["preprocess"] = dict(t, **b)
    del x8, args

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    held = winograd_held
    worst, acc = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flops=0.0)
    infer = [((1, 2 * s[1], 2 * s[2], s[3]), co) for s, co, _ in UNET_WINOGRAD_TRAIN]
    for shape, co in infer:
        xi = rand(shape).bfloat16()
        u = cw.u_for(rand((co, shape[3], 3, 3), (1.0 / (9 * shape[3])) ** 0.5), "f2",
                     torch.bfloat16)
        bi = rand((co,), 0.1).bfloat16()
        worst = max(worst, held(cw.winograd_fwd(xi, u, bi, None, "f2", "bias_relu"),
                                cw.winograd_fwd_plain(xi, u, bi, None, "f2", "bias_relu"),
                                2 ** -7, 2 ** -12, f"f2 {list(shape)}->{co}"))
        del xi, u
    log(f"winograd f2 at U-Net's {len(infer)} Predictor shapes ([1,512,1024] input): "
        "bias_relu forward within the bound")
    for shape, co, count in UNET_WINOGRAD_TRAIN:
        nn_, hh, ww, cc = shape
        x = rand(shape).bfloat16()
        wt = rand((co, cc, 3, 3), (1.0 / (9 * cc)) ** 0.5)
        bb = rand((co,), 0.1).bfloat16()
        g, o = rand((nn_, hh, ww, co)).bfloat16(), rand((nn_, hh, ww, co)).bfloat16()
        u = cw.u_for(wt, "f2", torch.bfloat16)
        u2 = cw.u_for(rot180_swap(wt), "f2", torch.bfloat16)
        what = f"f2 {list(shape)}->{co}"
        worst = max(worst, held(cw.winograd_fwd(x, u, bb, None, "f2", "bias_relu"),
                                cw.winograd_fwd_plain(x, u, bb, None, "f2", "bias_relu"),
                                2 ** -7, 2 ** -12, what + " bias_relu"))
        held(cw.winograd_fwd(g, u2, None, o, "f2", "none"),
             cw.winograd_fwd_plain(g, u2, None, o, "f2", "none"),
             2 ** -7, 2 ** -12, what + " masked dgrad")
        du, db = cw.winograd_wgrad(x, g, o, "f2")
        du_p, db_p = cw.winograd_wgrad_plain(x, g, o, "f2")
        held(du, du_p, 0.0, 1e-4, what + " dU")
        held(db, db_p, 0.0, 1e-4, what + " db")
        del du, db, du_p, db_p
        ops = winograd_ops(torch, x, wt, bb, g, o, "f2")
        line = []
        for op, (plain, kernel, library) in ops.items():
            nbytes, flops = winograd_work("f2", shape, co, op)
            k, pl, lib = time3(plain, kernel, library,
                               timer=lambda f: cuda_ms(f, iters=5, warmup=1))
            acc["ms"] += count * k
            acc["plain_ms"] += count * pl
            acc["library_ms"] += count * lib
            acc["bytes"] += count * nbytes
            acc["flops"] += count * flops
            line.append(f"{op} {k:.4f} / {pl:.4f} / {lib:.4f}")
        log(f"  winograd {what} x{count} (held to plain; ms kernel / plain / cuDNN): "
            + "; ".join(line))
        del x, g, o, u, u2, ops
    torch.cuda.empty_cache()
    bd = bound(acc["bytes"], acc["flops"])
    log(f"winograd per U-Net f2 train step (13 routed convs, fwd + dgrad + wgrad): "
        f"kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f}, cuDNN "
        f"{acc['library_ms']:.4f}, bound {bd['bound_ms']:.4f} ({bd['bound_by']})")
    res["winograd"] = dict(acc, max_abs_err=worst, **bd)
    return res


def drive_unet_sweep(torch, tmp: str, data: str) -> dict:
    """The sweep through ``scripts/test.py`` at unet_cityscapes over the
    fixture's val images (Cityscapes' test images) at --batch 1 and 8: one
    file of the source's name per image, each equal to ``host_overlay`` of
    its image with the Predictor's labels (Cityscapes' palette). Returns
    img/s by the CLI's own count."""
    import contextlib

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import test as test_cli

    srcs = build_dataset("cityscapes", data, UNET_HW).test_images
    pr = _sweep_predictor("unet_cityscapes")
    res = {}
    for batch in (1, 8):
        out = io.StringIO()
        runs = os.path.join(tmp, f"unet_runs_b{batch}")
        with contextlib.redirect_stdout(out):
            rc = test_cli.main(["--preset", "unet_cityscapes", "--device", "cuda",
                                "--data-dir", data, "--runs-dir", runs,
                                "--batch", str(batch)])
        last = out.getvalue().strip().splitlines()[-1]
        if rc != 0 or not last.startswith(f"{len(srcs)} images in "):
            raise AssertionError(f"unet sweep --batch {batch}: rc {rc}, {last!r}")
        (run_dir,) = os.listdir(runs)
        names = [os.path.basename(q) for q in srcs]
        if sorted(os.listdir(os.path.join(runs, run_dir))) != sorted(names):
            raise AssertionError(f"unet sweep --batch {batch}: wrong files")
        imgs = np.stack([load_image(q, UNET_HW) for q in srcs])
        for i in range(0, len(srcs), batch):   # the labels at the sweep's batch
            labels = pr._fetch_labels(imgs[i:i + batch])
            for j, name in enumerate(names[i:i + batch]):
                got = np.asarray(Image.open(os.path.join(runs, run_dir, name)))
                if not np.array_equal(got, host_overlay(imgs[i + j], labels[j],
                                                        pr._palette, pr._alpha)):
                    raise AssertionError(f"unet sweep --batch {batch}: {name} differs")
        res[f"b{batch}_img_per_s"] = float(last.split("(")[1].split()[0])
        log(f"sweep unet_cityscapes --batch {batch}: {len(srcs)} val images, every "
            f"file equal to host_overlay of the Predictor's labels; "
            f"{res[f'b{batch}_img_per_s']:.2f} img/s (the CLI's count)")
    del pr
    torch.cuda.empty_cache()
    return res


def drive_unet_training(torch, tmp: str, data: str) -> dict:
    """U-Net's training path: ``train.py --preset unet_cityscapes
    --synthetic`` (the Cityscapes fixture it writes: 8 images, one step of
    8), then drive_training on ``data`` (32 train images, 8 held out by
    --val-frac 0.25 --keep-best: 3 steps of 8 at 256x512 crops of 512x1024,
    --pallas-preprocess, --resume, infer_image), then eval.py on its
    checkpoint (the val split by default, 16 images at batch 4)."""
    import math

    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        checkpoint_steps,
    )

    ck0 = os.path.join(tmp, "ckpt_synthetic")
    out = run_cli(train.main, ["--preset", "unet_cityscapes", "--synthetic", "--epochs",
                               "1", "--pallas-preprocess", "--checkpoint-dir", ck0,
                               "--device", "cuda"])
    with open(os.path.join(ck0, "logs", "train.jsonl")) as f:
        epoch = [json.loads(line) for line in f][-1]
    if "train_images=8" not in out or epoch.get("step") != 1 or \
            not math.isfinite(epoch.get("epoch/loss", float("nan"))):
        raise AssertionError(f"train --synthetic unet_cityscapes: {epoch}")
    log(f"train.main unet_cityscapes --synthetic: 1 step of 8, loss "
        f"{epoch['epoch/loss']:.4f}")
    r = drive_training(torch, tmp, "unet_cityscapes", data=data,
                       extra=("--val-frac", "0.25", "--keep-best"))
    if checkpoint_steps(os.path.join(r["ckpt"], "best")) != [3]:
        raise AssertionError("unet: no best/ checkpoint at step 3")
    text = run_cli(eval_cli.main, ["--preset", "unet_cityscapes", "--data-dir", data,
                                   "--checkpoint-dir", r["ckpt"], "--device", "cuda"])
    ev = parse_eval(text, road=False)
    iou = text.split("iou=")[-1].split("]")[0].split(",")
    if ev["images"] != UNET_VAL or "split='val'" not in text or len(iou) != 19:
        raise AssertionError(f"eval unet_cityscapes: {ev}, {len(iou)} IoUs")
    r["eval"] = ev
    return r


def check_unet_train_step(torch) -> None:
    """One unet_cityscapes train step (batch 8 of random 512x1024 images and
    19-class labels, 256x512 crops, Adam 1e-4) with the preprocess kernel
    against the same step with its plain version, same weights, bf16 on the
    card, with ``hold_train_steps``'s bounds. (Kernel 4 is bit-exact, so the
    two differ only by cuDNN's own run-to-run order.)"""
    from functools import partial

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
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (8, *UNET_HW, 3),
                                                    np.uint8)).to(dev),
             "label": torch.from_numpy(rng.integers(0, 19, (8, *UNET_HW))
                                       .astype(np.int32)).to(dev)}
    states = []
    for _ in range(2):
        model = build_model("unet", 19, device=dev)
        init_params(model, torch.Generator(device=dev).manual_seed(7))
        states.append(create_train_state(model, make_optimizer(
            "adam", model.parameters(), 1e-4), make_lr_schedule(1e-4), seed=0))
    aug_p = Augment(partial(preprocess_normalize_plain, crop_hw=UNET_CROP, mean=MEAN,
                            std=STD), UNET_CROP, True)
    out_k = make_train_step(19, augment_fn=make_preprocess_augment_fn(
        MEAN, STD, UNET_CROP))(states[0], batch)
    out_p = make_train_step(19, augment_fn=aug_p)(states[1], batch)
    hold_train_steps("unet_cityscapes (batch 8, 256x512)", states[0], out_k,
                     states[1], out_p)


def drive_unet_winograd(torch, tmp: str) -> dict:
    """U-Net with ``--model-kw winograd=f2`` (kernel 6 on its 13 full-lane
    convs): a Predictor built as the serving CLIs build it, called on a
    generated 512x1024 image, and one train step of the preset's workload
    (tools/profile_train.py's ``unet``)."""
    import math
    from argparse import ArgumentParser

    from profile_train import WORKLOADS, train_workload
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor,
    )

    p = ArgumentParser()
    add_model_args(p)
    pred = build_predictor(p.parse_args(["--preset", "unet_cityscapes", "--model-kw",
                                         "winograd=f2", "--device", "cuda"]),
                           torch.device("cuda"))
    overlay, labels = pred(kitti_like(1, UNET_HW))
    if overlay.shape != (*UNET_HW, 3) or labels.shape != UNET_HW:
        raise AssertionError("unet f2 Predictor: bad output shapes")
    del pred
    step = train_workload(torch, WORKLOADS["unet"], model_kw={"winograd": "f2"})
    loss = step()["loss"].item()
    torch.cuda.synchronize()
    if not math.isfinite(loss):
        raise AssertionError(f"unet f2 train step: loss {loss}")
    log(f"unet_cityscapes winograd=f2: Predictor overlay {overlay.shape}, "
        f"{len(set(labels.ravel().tolist()))} classes present; one train step "
        f"(batch 8, 256x512), loss {loss:.5f}")
    return {"unet_f2_loss": loss}


def unet_phase(torch, smi: str, drive, gen) -> tuple[list[dict], dict]:
    """U-Net on Cityscapes (unet_cityscapes, 19 classes, full width) through
    the user's entry points, each path run by ``drive`` (the launch counters
    at 0 just before, read just after), after kernels 2, 4 and 6 are held
    against their plain versions at U-Net's shapes (check_unet_kernels):
    infer_image, serve (/segment, /labels) and the Predictor at 512x1024;
    the sweep (scripts/test.py) over 16 generated val images; train.py
    --synthetic, then validated training (3 steps of 8, 256x512 crops,
    --pallas-preprocess, --resume, infer_image) and eval.py on its
    checkpoint; a train step with the kernels against plain PyTorch; the
    winograd=f2 Predictor and train step; --spatial 2 at one rank; the
    preset step timed, direct and f2 in turns; the 2-rank grid on 496 rows
    (256 + 240). Returns each path's launches and the phase's numbers."""
    from profile_train import show_idle

    from semanticsegmentation_tensorflow_tpu_torch.data.cityscapes import (
        generate_synthetic_cityscapes,
    )

    t_phase = time.perf_counter()
    kernels = check_unet_kernels(torch, gen)
    torch.cuda.empty_cache()
    runs, res = [], {"kernels": kernels}
    with tempfile.TemporaryDirectory() as tmp:
        res["inference"], launches = drive("unet_cityscapes inference", drive_slice,
                                           torch, tmp, "unet_cityscapes")
        runs.append(launches)
        if not launches["overlay"]:
            raise AssertionError(f"not launched on the unet inference path: {launches}")
        data = generate_synthetic_cityscapes(os.path.join(tmp, "cityscapes"),
                                             n_train=UNET_TRAIN, n_val=UNET_VAL,
                                             h=UNET_HW[0], w=UNET_HW[1], seed=6)
        res["sweep"], launches = drive("unet_cityscapes sweep", drive_unet_sweep,
                                       torch, tmp, data)
        runs.append(launches)
        train_tmp = os.path.join(tmp, "train")
        os.makedirs(train_tmp)
        tr, launches = drive("unet_cityscapes training", drive_unet_training, torch,
                             train_tmp, data)
        runs.append(launches)
        if not launches["preprocess_normalize"]:
            raise AssertionError(f"not launched on the unet training path: {launches}")
        res["train"] = {k: v for k, v in tr.items() if k not in ("data", "ckpt")}
        torch.cuda.empty_cache()
        check_unet_train_step(torch)
        torch.cuda.empty_cache()
        res["winograd"], launches = drive("unet_cityscapes winograd=f2",
                                          drive_unet_winograd, torch, tmp)
        runs.append(launches)
        missing = [k for k in ("winograd_fwd", "winograd_wgrad", "overlay",
                               "preprocess_normalize") if not launches[k]]
        if missing:
            raise AssertionError(f"not launched on the unet winograd=f2 path: {missing}")
        torch.cuda.empty_cache()
        sp_tmp = os.path.join(tmp, "spatial")
        os.makedirs(sp_tmp)
        res["spatial"], launches = drive("unet_cityscapes --spatial 2 training",
                                         drive_spatial_training, torch, sp_tmp,
                                         "unet_cityscapes", data, UNET_TRAIN // 8)
        runs.append(launches)
        if not launches["preprocess_normalize"] or launches["winograd_fwd"]:
            raise AssertionError(f"unet_cityscapes --spatial 2: launches {launches}")
    torch.cuda.empty_cache()
    steps = {}
    for w in ("unet", "unet_f2", "unet_f2", "unet"):
        steps.setdefault(w, []).append(time_train(torch, smi, w))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res["grid"] = check_grid(torch, tmp, smi, "unet_cityscapes")
    torch.cuda.empty_cache()
    res["steps"] = steps
    direct, f2 = steps["unet"][0], steps["unet_f2"][0]
    log(f"U-Net: preset step (batch 8, 256x512) {direct['images_per_s']:.2f} images/s, "
        f"{direct['host_ms']:.2f} ms/step host, device {direct['device_ms']:.2f} ms, idle "
        f"share {show_idle(direct['idle_share'])}, peak {direct['peak_gib']:.2f} GiB; "
        f"winograd=f2 in turns {[round(r['host_ms'], 2) for r in steps['unet_f2']]} vs "
        f"direct {[round(r['host_ms'], 2) for r in steps['unet']]} ms/step; Predictor "
        f"{res['inference']['predictor_overlay_ms']:.3f} ms/image (device "
        f"{res['inference']['predictor_overlay_device_ms']:.3f}); /segment "
        f"{res['inference']['segment_ms']:.2f} ms, /labels "
        f"{res['inference']['labels_ms']:.2f}; sweep {res['sweep']['b8_img_per_s']:.2f} "
        f"img/s at --batch 8; eval {res['train']['eval']['img_per_s']:.2f} img/s; "
        f"train.main peak {res['train']['train_cli_peak_gib']:.2f} GiB | {smi}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"U-Net phase: {res['phase_s']:.1f} s")
    log("unet timings: " + json.dumps(res))
    return runs, res


# --- BatchNorm (use_bn) at full width: segnet_kitti as published ------------

BN_PRESET, BN_KW = "segnet_kitti", "use_bn=True"
TTA_SCALES = "0.75,1.0,1.25"


def check_bn_train_step(torch) -> dict:
    """One segnet_kitti train step with ``use_bn`` (BatchNorm after every
    conv, no fused stage1: the argmax pool and unpool kernels and the
    preprocess kernel) against the same step on plain PyTorch (the pools'
    and the preprocess kernel's plain versions), same weights, same batch of
    8 road scenes at 384x1248 cropped to 320x1152, bf16 on the card:
    hold_train_steps's bounds (the conv biases that feed a BatchNorm left
    out: ``bn_fed_biases``), and every BatchNorm's running statistics
    after the step within 1e-3 of their L2 norm (the kernels are
    bit-equal to their plain versions; cuDNN's choices may differ between
    two builds' convs). Returns the worst statistics' distance."""
    from functools import partial

    import numpy as np

    from profile_train import plain_pools

    from semanticsegmentation_tensorflow_tpu_torch.data.augment import Augment
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import _road_scene
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
    rng = np.random.default_rng(1)
    imgs, lbls = zip(*(_road_scene(rng, *PADDED_HW) for _ in range(8)))
    batch = {"image": torch.from_numpy(np.stack(imgs)).to(dev),
             "label": torch.from_numpy(np.stack(lbls)).to(dev)}
    crop = (320, 1152)
    weights = init_params(build_model("segnet", 2, device=dev, use_bn=True),
                          torch.Generator(device=dev).manual_seed(7)).state_dict()

    def run(augment):
        model = build_model("segnet", 2, device=dev, use_bn=True)
        model.load_state_dict(weights)
        state = create_train_state(model, make_optimizer("adam", model.parameters(),
                                                         1e-4),
                                   make_lr_schedule(1e-4), seed=0)
        return state, make_train_step(2, augment_fn=augment)(state, batch)

    kern, out_k = run(make_preprocess_augment_fn(MEAN, STD, crop))
    with plain_pools():
        plain, out_p = run(Augment(partial(preprocess_normalize_plain, crop_hw=crop,
                                           mean=MEAN, std=STD), crop, True))
    hold_train_steps("segnet_kitti use_bn (batch 8)", kern, out_k, plain, out_p)
    bk, bp = dict(kern.model.named_buffers()), dict(plain.model.named_buffers())
    worst = max(((bk[k] - b).norm() / b.norm().clamp(min=1e-30)).item()
                for k, b in bp.items())
    moved = max((b - weights[k]).abs().max().item() for k, b in bk.items())
    log(f"segnet use_bn step: running statistics kernels vs plain, worst |ds|/|s| "
        f"{worst:.3g} (bound 1e-3), {len(bk)} buffers; the step moved them by up "
        f"to {moved:.3g} (momentum 0.99)")
    if not (worst <= 1e-3 and moved > 0):
        raise AssertionError("segnet use_bn: running statistics outside the bound")
    return {"stats_rel": worst}


def drive_bn_training(torch, tmp: str) -> dict:
    """segnet_kitti with ``use_bn`` through the user's entry points:
    train.py (3 steps of 8, --pallas-preprocess, --resume, infer_image on
    the checkpoint), then infer_image, serve (/segment, /labels) and the
    Predictor from that checkpoint (its running statistics), then
    ``eval.py --tta --tta-scales 0.75,1.0,1.25 --road-metrics`` on it."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli

    r = drive_training(torch, tmp, BN_PRESET, BN_KW)
    ck = r["ckpt"]
    serve_tmp = os.path.join(tmp, "serve")
    os.makedirs(serve_tmp)
    r["serve"] = drive_slice(torch, serve_tmp, BN_PRESET, BN_KW,
                             extra=("--checkpoint-dir", ck))
    text = run_cli(eval_cli.main, ["--preset", BN_PRESET, "--model-kw", BN_KW,
                                   "--data-dir", r["data"], "--checkpoint-dir", ck,
                                   "--device", "cuda", "--road-metrics", "--tta",
                                   "--tta-scales", TTA_SCALES])
    if "TTA eval: scales=[0.75, 1.0, 1.25] flip=True" not in text:
        raise AssertionError(f"eval --tta printed no TTA line: {text!r}")
    r["tta_eval"] = parse_eval(text)
    return r


def bn_phase(torch, smi: str, drive) -> tuple[list[dict], dict]:
    """BatchNorm at full width on segnet_kitti (SegNet as published): the
    train step with the kernels against plain PyTorch (check_bn_train_step);
    train.main to a checkpoint, the Predictor and /segment from it, and
    eval.py --tta on it (drive_bn_training); the 2-rank gloo --spatial 2
    step on this card against one process (BatchNorm's statistics over both
    ranks' rows, 192 + 160 of 352); the preset step timed. Returns each
    path's launches and the phase's numbers."""
    from profile_train import show_idle

    t_phase = time.perf_counter()
    runs, res = [], {}
    res["step"] = check_bn_train_step(torch)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tr, launches = drive("segnet_kitti use_bn training, serving and TTA eval",
                             drive_bn_training, torch, tmp)
        runs.append(launches)
        missing = [k for k in ("pool_argmax", "unpool", "unpool_bwd",
                               "preprocess_normalize", "overlay") if not launches[k]]
        if missing or launches["stage1_tail_segnet"]:
            raise AssertionError(f"segnet use_bn path: launches {launches}")
        res["train"] = {k: v for k, v in tr.items() if k not in ("data", "ckpt")}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res["grid"] = check_grid(torch, tmp, smi, "segnet_kitti_bn")
    torch.cuda.empty_cache()
    res["steps"] = time_train(torch, smi, "segnet_bn")
    st, sv = res["steps"], res["train"]["serve"]
    log(f"segnet_kitti use_bn: preset step (batch 8, 320x1152) "
        f"{st['images_per_s']:.2f} images/s, {st['host_ms']:.2f} ms/step host, device "
        f"{st['device_ms']:.2f} ms, idle share {show_idle(st['idle_share'])}, peak "
        f"{st['peak_gib']:.2f} GiB; Predictor {sv['predictor_overlay_ms']:.3f} "
        f"ms/image host (device {sv['predictor_overlay_device_ms']:.3f}); /segment "
        f"{sv['segment_ms']:.2f} ms; TTA eval (6 variants) "
        f"{res['train']['tta_eval']['img_per_s']:.2f} img/s; grid "
        f"{res['grid']['grid_ms']:.2f} ms/step | {smi}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"BN phase: {res['phase_s']:.1f} s")
    log("bn timings: " + json.dumps(res))
    return runs, res


# --- test-time augmentation and tiled native-resolution inference ----------

def drive_tiled(torch, tmp: str, preset: str, hw: tuple[int, int],
                grid: tuple[int, int]) -> dict:
    """``infer_image --tiled`` at ``preset`` (random weights) on a generated
    image of ``hw``: the JAX CLI's ``tiled:`` line with ``grid`` tiles of the
    preset's size rounded to the stride, an overlay of ``hw``; then the
    TiledPredictor's steady state on that image (host clock, and the device
    time of one call). Kernel 2 is held against its plain version on the
    path's own summed probabilities: exact labels and bytes (a comparison
    launch, taken out of the path's count)."""
    import re

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.data.palette import overlay_palette
    from semanticsegmentation_tensorflow_tpu_torch.infer import TiledPredictor
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
        build_model, padded_input_hw,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
        argmax_colormap_overlay_cuda, argmax_colormap_overlay_plain,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image

    cfg = get_preset(preset)
    dc = cfg.data
    png, out = os.path.join(tmp, f"{preset}_big.png"), os.path.join(tmp, "tiled.png")
    write_png(png, seed=3, hw=hw)
    t0 = time.perf_counter()
    text = run_cli(infer_image.main, ["--preset", preset, "--image", png, "--out",
                                      out, "--device", "cuda", "--tiled"])
    wall = time.perf_counter() - t0
    model = build_model(cfg.model, dc.num_classes, device="cuda", **cfg.model_kwargs)
    tile = padded_input_hw(model, dc.image_size)
    want = f"tiled: input {hw[0]}x{hw[1]}, grid {grid[0]}x{grid[1]} tiles of " \
           f"{tile[0]}x{tile[1]}"
    ov = np.asarray(Image.open(out))
    if not re.search("^" + re.escape(want) + "$", text, re.M) or ov.shape != (*hw, 3):
        raise AssertionError(f"infer_image --tiled {preset}: {text!r}, {ov.shape}")
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    tp = TiledPredictor(model, dc.image_size, device="cuda", mean=dc.mean, std=dc.std,
                        overlay_palette=overlay_palette(dc.dataset))
    img = np.asarray(Image.open(png).convert("RGB"))
    tp(img)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        tp(img)
        ts.append((time.perf_counter() - t0) * 1e3)
    dev, ops = device_ms(lambda: tp(img), iters=5)
    x = torch.from_numpy(img.copy()).to("cuda")
    acc = tp.summed_probs(x)
    launched = argmax_colormap_overlay_cuda.launches
    ov_k, lab_k = argmax_colormap_overlay_cuda(x[None].contiguous(), acc, tp._palette,
                                               tp._alpha)
    argmax_colormap_overlay_cuda.launches = launched
    ov_p, lab_p = argmax_colormap_overlay_plain(x[None], acc[:, :hw[0], :hw[1]],
                                                tp._palette, tp._alpha)
    torch.cuda.synchronize()
    what = f"overlay C={acc.shape[-1]} [1,{hw[0]},{hw[1]}] on the tiled path's summed " \
           f"probabilities {list(acc.shape)}"
    if not torch.equal(lab_k, lab_p):
        raise AssertionError(f"{what}: labels differ at {int((lab_k != lab_p).sum())} "
                             "pixels")
    if not torch.equal(ov_k, ov_p):
        raise AssertionError(f"{what}: bytes differ (max "
                             f"{(ov_k.int() - ov_p.int()).abs().max().item()})")
    log(f"{what}: labels and bytes exact against the plain version")
    r = {"cli_s": wall, "tiled_ms": float(np.median(ts)), "tiled_device_ms": dev}
    log(f"infer_image --tiled {preset}: {want}; CLI {wall:.2f} s (model build "
        f"included); TiledPredictor {r['tiled_ms']:.2f} ms/image (host clock, median "
        f"of 5), device {dev:.2f} ms in {ops} ops")
    return r


def drive_tta_eval(torch, tmp: str) -> dict:
    """``eval.py --tta --tta-scales 0.75,1.0,1.25 --road-metrics`` at
    fcn8s_kitti (full width, seeded weights saved as a step-0 checkpoint) on
    8 generated images."""
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli

    data = generate_synthetic_kitti(os.path.join(tmp, "data_road"), n_train=8,
                                    n_test=1, h=IMAGE_HW[0], w=IMAGE_HW[1], seed=5)
    ck = tta_checkpoint(torch, tmp)
    text = run_cli(eval_cli.main, ["--data-dir", data, "--checkpoint-dir", ck,
                                   "--device", "cuda", "--road-metrics", "--tta",
                                   "--tta-scales", TTA_SCALES])
    if "TTA eval: scales=[0.75, 1.0, 1.25] flip=True" not in text:
        raise AssertionError(f"eval --tta printed no TTA line: {text!r}")
    return {"eval": parse_eval(text), "data": data, "ckpt": ck}


def tta_checkpoint(torch, tmp: str) -> str:
    """A port checkpoint (step 0) of fcn8s_kitti at seeded random weights."""
    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.state import (
        create_train_state, make_lr_schedule, make_optimizer,
    )

    cfg = get_preset("fcn8s_kitti")
    model = init_params(build_model(cfg.model, 2, device="cuda", **cfg.model_kwargs),
                        torch.Generator(device="cuda").manual_seed(9))
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-4),
                               make_lr_schedule(1e-4), seed=0)
    ck = os.path.join(tmp, "ckpt_tta")
    CheckpointManager(ck).save(state)
    return ck


def check_tta_and_tiles(torch, data: str, ck: str) -> dict:
    """On the card at fcn8s_kitti (the checkpoint's weights): the TTA eval
    step at ``scales=(1.0,)`` without flip against ``make_eval_step`` on two
    batches of 4 (the same road histogram and pixel count, the loss within
    1e-6 relative, the same predictions wherever the two logits differ by
    more than 1e-6), and the TiledPredictor on a 375x1242 image (one
    384x1248 tile, a 1x1 grid) against the Predictor's labels there too.
    Below that margin the two softmax probabilities of a pixel can round to
    one value (exp of a difference under 2^-24 is 1.0 in f32), and the
    first-max argmax of a tie says class 0 where the logits say 1; random
    weights give logits of ~1e-2, where such near-ties are common."""
    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import normalize_images
    from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import BatchLoader
    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor, TiledPredictor
    from semanticsegmentation_tensorflow_tpu_torch.infer.tta import make_tta_eval_step
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import load_weights
    from semanticsegmentation_tensorflow_tpu_torch.train.step import make_eval_step

    cfg = get_preset("fcn8s_kitti")
    dc = cfg.data
    dev = torch.device("cuda")

    def model():
        m = build_model(cfg.model, 2, device=dev, **cfg.model_kwargs)
        m.load_state_dict(load_weights(ck, map_location=dev))
        return m.eval()

    m = model()
    ds = build_dataset(dc.dataset, data, dc.image_size, split="train")
    loader = BatchLoader(ds, 4, pad_multiple=32, device=dev, drop_remainder=False)
    tta = make_tta_eval_step(2, scales=(1.0,), flip=False, road_hist=True)
    plain = make_eval_step(2, road_hist=True)
    worst, ties, pixels = 0.0, 0, 0
    for b in loader.epoch():
        b = dict(b, image=normalize_images(b["image"], dc.mean, dc.std))
        got, want = tta(m, b), plain(m, b)
        with torch.no_grad():
            lg = m(b["image"]).float()
        decided = (lg[..., 1] - lg[..., 0]).abs() > 1e-6
        ties += int((~decided).sum())
        pixels += decided.numel()
        if not (torch.equal(got["pred"][decided], want["pred"][decided])
                and torch.equal(got["road_hist"], want["road_hist"])
                and got["cm"].sum() == want["cm"].sum()):
            raise AssertionError("TTA at scale 1.0 without flip differs from the "
                                 "eval step")
        worst = max(worst, abs(got["loss"].item() - want["loss"].item())
                    / abs(want["loss"].item()))
    if worst > 1e-6:
        raise AssertionError(f"TTA at scale 1.0: loss rel {worst:.3g} > 1e-6")
    img = kitti_like(seed=8)
    pred = Predictor(model(), dc.image_size, device=dev)
    logits = pred._padded_logits(torch.from_numpy(img[None]).to(dev))[0].float().cpu()
    _, want = pred(img)
    tp = TiledPredictor(model(), dc.image_size, device=dev)
    _, got = tp(img)
    lg = logits.numpy()[:img.shape[0], :img.shape[1]]
    decided = np.abs(lg[..., 1] - lg[..., 0]) > 1e-6
    same = int((got == want)[decided].sum())
    log(f"TTA eval step at scale 1.0, no flip, vs the eval step: road histogram "
        f"equal, predictions equal on the {pixels - ties} of {pixels} pixels whose "
        f"logits differ by more than 1e-6, loss rel {worst:.3g} (bound 1e-6); tiled "
        f"grid {tp.grid} vs the Predictor: {same} of {int(decided.sum())} such labels "
        f"equal ({img.shape[0] * img.shape[1] - int(decided.sum())} pixels within "
        "1e-6 of a tie)")
    if tp.grid != (1, 1) or same != int(decided.sum()):
        raise AssertionError("the 1x1 tiled grid differs from the Predictor")
    return {"tta_identity_loss_rel": worst, "tta_identity_ties": ties,
            "tiled_vs_predictor_ties": int(img.shape[0] * img.shape[1] - decided.sum())}


def tta_tiled_phase(torch, smi: str, drive) -> tuple[list[dict], dict]:
    """Tiled native-resolution inference and test-time augmentation through
    the user's entry points, each path run by ``drive``: ``infer_image
    --tiled`` on a 1024x2048 Cityscapes frame at unet_cityscapes (3x3 tiles
    of 512x1024; kernel 2 at [1,1024,2048] C=19) and on a 750x2484 image at
    fcn8s_kitti (3x3 tiles of 384x1248); ``eval.py --tta`` at fcn8s_kitti
    (kernel 1 on every variant); then check_tta_and_tiles on the card."""
    t_phase = time.perf_counter()
    runs, res = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for preset, hw in (("unet_cityscapes", (1024, 2048)), ("fcn8s_kitti", (750, 2484))):
            res[f"tiled_{preset}"], launches = drive(
                f"{preset} infer_image --tiled", drive_tiled, torch, tmp, preset, hw,
                (3, 3))
            runs.append(launches)
            if not launches["overlay"]:
                raise AssertionError(f"overlay not launched on the tiled path: {launches}")
            torch.cuda.empty_cache()
        tta, launches = drive("fcn8s_kitti eval --tta", drive_tta_eval, torch, tmp)
        runs.append(launches)
        if not launches["stage1_tail"]:
            raise AssertionError(f"stage1_tail not launched on the TTA path: {launches}")
        res["tta_eval"] = tta["eval"]
        res["checks"] = check_tta_and_tiles(torch, tta["data"], tta["ckpt"])
    torch.cuda.empty_cache()
    u, f = res["tiled_unet_cityscapes"], res["tiled_fcn8s_kitti"]
    log(f"tiled: unet_cityscapes 1024x2048 (3x3 tiles) {u['tiled_ms']:.2f} ms/image "
        f"(device {u['tiled_device_ms']:.2f}), fcn8s_kitti 750x2484 (3x3 tiles) "
        f"{f['tiled_ms']:.2f} ms/image (device {f['tiled_device_ms']:.2f}); TTA eval "
        f"fcn8s_kitti (6 variants) {res['tta_eval']['img_per_s']:.2f} img/s | {smi}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"TTA and tiled phase: {res['phase_s']:.1f} s")
    log("tta/tiled timings: " + json.dumps(res))
    return runs, res


# --- int8 serving, BatchNorm folding and quantization-aware training -------

INT8_CALIB_N = 4        # test.py --int8 --calib 4 over INT8_SWEEP_N images
INT8_SWEEP_N = 8
# the int8 product at shapes the driven paths do not give it, each held
# bit-equal to a float64 conv of the same int8 tensors: (what, x shape,
# weight shape, dilation, transposed stride or 0)
INT8_GEMM_CASES = (
    ("conv1_2 at eval's batch 4 (patches split over rows)", (4, *PADDED_HW, 64),
     (64, 64, 3, 3), 1, 0),
    ("DeepLab's image branch at one pixel (M = 1, padded to 32 rows)",
     (1, 1, 1, 512), (256, 512, 1, 1), 1, 0),
    ("conv6 of deeplab_kitti_os16, 7x7 at dilation 2", (1, 24, 78, 512),
     (512, 512, 7, 7), 2, 0),
    ("FCN's up2 4/2 up-conv", (1, 12, 39, 2), (2, 2, 4, 4), 1, 2),
)


def _exact_int8(torch, xq, wq, dilation: int, stride: int):
    """The int8 product of ``xq`` (NHWC) by ``wq`` (the port's layout) in
    float64 with cuDNN off (PyTorch's own im2col GEMM, cuBLAS's float64
    GEMM): every partial sum is an integer below 2^53, so it is exact.
    NHWC float64 out."""
    import torch.nn.functional as F

    from semanticsegmentation_tensorflow_tpu_torch.ops.quant import transpose_padding

    x = xq.double().permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=False):
        if stride:
            y = F.conv_transpose2d(x, wq.double(), stride=stride,
                                   padding=transpose_padding(wq.shape[-1], stride))
        else:
            y = F.conv2d(x, wq.double(), padding=dilation * (wq.shape[-1] - 1) // 2,
                         dilation=dilation)
    return y.permute(0, 2, 3, 1)


def _int8_product(xq, wq, dilation: int, stride: int):
    from semanticsegmentation_tensorflow_tpu_torch.ops import quant as oq

    return (oq.int8_conv_transpose2d(xq, wq, stride) if stride
            else oq.int8_conv2d(xq, wq, dilation))


def check_int8_gemm(torch, gen) -> dict:
    """The int8 product (``ops/quant.py``: ``torch._int_mm`` on cuBLASLt over
    the patch matrix, K and N padded to multiples of 8) on random int8
    tensors at ``INT8_GEMM_CASES``: bit-equal to the exact float64 conv;
    each timed by CUDA events beside the bf16 cuDNN conv of the same shape
    (a yardstick: it has no quantize or rescale either)."""
    import torch.nn.functional as F

    res = {}
    for what, xs, ws, dil, stride in INT8_GEMM_CASES:
        xq = torch.randint(-127, 128, xs, generator=gen, device="cuda",
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, ws, generator=gen, device="cuda",
                           dtype=torch.int8)
        got = _int8_product(xq, wq, dil, stride)
        if not torch.equal(got.double(), _exact_int8(torch, xq, wq, dil, stride)):
            raise AssertionError(f"int8 product, {what}: differs from the exact conv")
        xb, wb = xq.bfloat16().permute(0, 3, 1, 2), wq.bfloat16()
        if stride:
            from semanticsegmentation_tensorflow_tpu_torch.ops.quant import (
                transpose_padding,
            )
            cudnn = lambda: F.conv_transpose2d(  # noqa: E731
                xb, wb, stride=stride, padding=transpose_padding(ws[-1], stride))
        else:
            cudnn = lambda: F.conv2d(xb, wb, padding=dil * (ws[-1] - 1) // 2,  # noqa: E731
                                     dilation=dil)
        ms = cuda_ms(lambda: _int8_product(xq, wq, dil, stride), iters=5, warmup=1)
        bf16 = cuda_ms(cudnn, iters=5, warmup=1)
        res[what] = {"int8_ms": ms, "cudnn_bf16_ms": bf16,
                     "max_abs_acc": int(got.abs().max())}
        log(f"int8 product, {what}: x {list(xs)}, w {list(ws)}: int32 bit-equal to "
            f"the float64 conv (max |acc| {res[what]['max_abs_acc']}); {ms:.3f} ms "
            f"(CUDA events, int8 in, int32 out) vs cuDNN's bf16 conv {bf16:.3f} ms")
    return res


def hold_int8_layers(torch, model, x, what: str) -> list[dict]:
    """One forward of the quantized ``model`` on ``x`` with every quantized
    conv's int32 accumulator, on the input it is given, held against the
    exact float64 conv of the same int8 tensors: bit-equal (raises
    otherwise). Returns a row per layer."""
    from semanticsegmentation_tensorflow_tpu_torch.ops import quant as oq

    rows = []

    def hold(name, m, args):
        if m.act_scale is None:
            return
        xq = oq.quantize_act(args[0], m.act_scale)
        stride = m.stride if isinstance(m, oq.QuantConvTranspose) else 0
        dil = 1 if stride else m.dilation
        got = _int8_product(xq, m.weight, dil, stride)
        ok = torch.equal(got.double(), _exact_int8(torch, xq, m.weight, dil, stride))
        rows.append({"layer": name, "x": list(xq.shape), "w": list(m.weight.shape),
                     "k": int(m.weight[0].numel() if not stride
                              else m.weight.shape[0]), "equal": ok})
        if not ok:
            raise AssertionError(f"{what}: {name}'s int32 accumulator differs from "
                                 "the exact conv")

    handles = [m.register_forward_pre_hook(
                   lambda m, args, name=name: hold(name, m, args))
               for name, m in model.named_modules()
               if isinstance(m, (oq.QuantConv, oq.QuantConvTranspose))]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()
    log(f"{what}: the int32 accumulators of all {len(rows)} quantized convs "
        "bit-equal to the float64 conv of the same int8 tensors: " + ", ".join(
            f"{r['layer']} {r['x']} K={r['k']}" for r in rows))
    return rows


def _int8_predictor(torch, preset: str, calib: list[str], model_kw: str | None = None):
    """The Predictor ``infer_image``/``serve`` build at ``preset`` (its
    seeded random weights) with ``--int8``, calibrated on the images
    ``calib`` (weight-only with none); without ``calib`` the bf16 one."""
    from argparse import ArgumentParser

    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor,
    )

    p = ArgumentParser()
    add_model_args(p)
    argv = ["--preset", preset, "--device", "cuda", *(["--int8"] if calib else []),
            *(["--model-kw", model_kw] if model_kw else [])]
    return build_predictor(p.parse_args(argv), torch.device("cuda"),
                           calib_paths=calib or ())


def drive_int8_fcn(torch, tmp: str) -> dict:
    """fcn8s_kitti int8 serving through the entry points: ``infer_image
    --int8`` and the server with ``--int8 --calib-dir`` (drive_slice: its
    requests checked against its Predictor), ``test.py --int8 --calib 4``
    over 8 generated test images (each file equal to ``host_overlay`` of
    the labels of the int8 Predictor calibrated on the same 4), ``eval.py
    --int8 --calib-batches 2`` on a step-0 checkpoint of seeded weights."""
    import contextlib

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli
    from semanticsegmentation_tensorflow_tpu_torch.scripts import test as test_cli

    data = generate_synthetic_kitti(os.path.join(tmp, "data_road"), n_train=8,
                                    n_test=INT8_SWEEP_N, seed=7)
    calib_dir = os.path.join(data, "testing", "image_2")
    r = {"slice": drive_slice(torch, tmp, "fcn8s_kitti", extra=("--int8",),
                              serve_extra=("--calib-dir", calib_dir))}
    runs = os.path.join(tmp, "int8_runs")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = test_cli.main(["--device", "cuda", "--data-dir", data, "--runs-dir", runs,
                            "--int8", "--calib", str(INT8_CALIB_N), "--batch", "4"])
    wall = time.perf_counter() - t0
    text = out.getvalue()
    print(text, end="")
    if rc or "int8 serving: 21 activation scales" not in text.splitlines():
        raise AssertionError(f"test.py --int8: rc {rc}, {text[-500:]!r}")
    srcs = build_dataset("kitti_road", data, IMAGE_HW).test_images
    pred = _int8_predictor(torch, "fcn8s_kitti", list(srcs[:INT8_CALIB_N]))
    (run_dir,) = os.listdir(runs)
    imgs = np.stack([load_image(q) for q in srcs])
    for i in range(0, len(srcs), 4):
        labels = pred._fetch_labels(imgs[i:i + 4])
        for j, q in enumerate(srcs[i:i + 4]):
            got = np.asarray(Image.open(os.path.join(runs, run_dir, os.path.basename(q))))
            if not np.array_equal(got, host_overlay(imgs[i + j], labels[j], pred._palette,
                                                    pred._alpha)):
                raise AssertionError(f"test.py --int8: {q} differs from the int8 "
                                     "Predictor's overlay")
    r["sweep_img_per_s"] = float(text.strip().splitlines()[-1].split("(")[1].split()[0])
    log(f"test.py --int8 --calib {INT8_CALIB_N} --batch 4: {len(srcs)} files, each "
        f"equal to host_overlay of the int8 Predictor's labels; {r['sweep_img_per_s']:.2f}"
        f" img/s (the CLI's count), main() {wall:.2f} s")
    del pred
    ck = tta_checkpoint(torch, tmp)
    text = run_cli(eval_cli.main, ["--data-dir", data, "--checkpoint-dir", ck,
                                   "--device", "cuda", "--road-metrics", "--int8",
                                   "--calib-batches", "2"])
    if "int8: 21 convs quantized, 21 activation scales" not in text.splitlines():
        raise AssertionError(f"eval.py --int8 printed no int8 line: {text!r}")
    r["eval"] = parse_eval(text)
    return r


def drive_int8_qat(torch, tmp: str) -> dict:
    """``train.py --qat`` at fcn8s_kitti (3 steps of 8, --pallas-preprocess,
    then --resume, which must read back qat_scales.json; drive_training),
    then ``eval.py --int8`` on that checkpoint (which must take the QAT
    scales) and ``eval.py`` without it (which must warn)."""
    import contextlib

    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli

    r = drive_training(torch, tmp, extra=("--qat",),
                       expect_resume="QAT: 21 activation scales from ")
    sp = os.path.join(r["ckpt"], "qat_scales.json")
    if not os.path.exists(sp):
        raise AssertionError("train --qat wrote no qat_scales.json")
    argv = ["--data-dir", r["data"], "--checkpoint-dir", r["ckpt"], "--device", "cuda"]
    text = run_cli(eval_cli.main, argv + ["--int8"])
    if f"int8: QAT scales from {sp}" not in text.splitlines():
        raise AssertionError(f"eval.py --int8 on the QAT checkpoint: {text!r}")
    r["eval_int8"] = parse_eval(text, road=False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        text = run_cli(eval_cli.main, argv)
    if "evaluating WITHOUT --int8 removes the activation clamps" not in err.getvalue():
        raise AssertionError(f"eval.py without --int8 gave no QAT warning: {err.getvalue()!r}")
    r["eval_fp"] = parse_eval(text, road=False)
    log(f"QAT checkpoint: eval --int8 loss {r['eval_int8']['loss']:.4f} miou "
        f"{r['eval_int8']['miou']:.4f}; eval without --int8 (warned) loss "
        f"{r['eval_fp']['loss']:.4f} miou {r['eval_fp']['miou']:.4f}")
    return {k: v for k, v in r.items() if k not in ("data", "ckpt")}


def drive_unet_int8(torch, tmp: str) -> dict:
    """``infer_image --int8`` at unet_cityscapes (19 classes, transposed
    2x2/2 up-convs) on a generated 1024x2048 frame, resized to 512x1024."""
    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image

    png, out = os.path.join(tmp, "city.png"), os.path.join(tmp, "city_int8.png")
    write_png(png, seed=11, hw=(1024, 2048))
    text = run_cli(infer_image.main, ["--preset", "unet_cityscapes", "--image", png,
                                      "--out", out, "--device", "cuda", "--int8"])
    if "int8: 23 activation scales" not in text.splitlines() \
            or np.asarray(Image.open(out)).shape != (*UNET_HW, 3):
        raise AssertionError(f"infer_image --int8 unet_cityscapes: {text!r}")
    return {"png": png}


def check_int8_forms(torch, png: str) -> dict:
    """At fcn8s_kitti's full width in float32 (TF32 off), seeded weights,
    scales calibrated on a generated image: each quantized conv's output
    against its fake-quant (QAT) form on the same input (the same quantized
    product; bound 1e-4 of the layer's largest output), and the whole int8
    forward against the fake-quant forward (every layer's input on its int8
    grid: a value that lands within rounding of a grid midpoint may take the
    other step and move the logits by up to a few steps of the score maps'
    grid; bound 5 % of the largest logit, labels on >= 99.5 % of pixels);
    then segnet_kitti with use_bn in float32, its 26 BatchNorms given drawn
    statistics and their folds, both with the plain argmax pools: each conv
    with its BatchNorm, folded against unfolded on the same input (bound
    1e-4 of the largest output), and the eval logits (relative L2 within
    1e-2, labels on >= 99.9 % of pixels: an argmax pool whose window holds
    a near-tie may route the other way once the fold moves it by a
    rounding)."""
    import copy

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch import convert
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import normalize_images
    from semanticsegmentation_tensorflow_tpu_torch.infer import quant
    from semanticsegmentation_tensorflow_tpu_torch.models.common import (
        BatchNorm, Conv, init_params,
    )
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
        build_model, quant_safe_kwargs,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.shape import pad_to_multiple

    dev = torch.device("cuda")
    mean, std = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)
    img = np.asarray(Image.open(png).convert("RGB"))
    x = pad_to_multiple(normalize_images(torch.from_numpy(img[None].copy()).to(dev),
                                         mean, std), 32)
    res = {}
    model = build_model("fcn8s", 2, device=dev, dtype=torch.float32,
                        **quant_safe_kwargs("fcn8s"))
    init_params(model, torch.Generator(device=dev).manual_seed(4))
    model.eval()
    scales = quant.calibrate_act_scales(model, [x])
    q8 = quant.quantize_model(copy.deepcopy(model), scales)
    fq = quant.fake_quantize(model, scales)
    inputs = {}
    handles = [m.register_forward_pre_hook(
                   lambda m, a, n=n: inputs.__setitem__(n, a[0]))
               for n, m in fq.named_modules() if getattr(m, "qat", False)]
    with torch.inference_mode():
        want = fq(x)
        for h in handles:
            h.remove()
        qmods = dict(q8.named_modules())
        worst = max(((qmods[n](t) - m(t)).abs().max() / m(t).abs().max()).item()
                    for n, m in fq.named_modules() if n in inputs
                    for t in (inputs[n],))
        got = q8(x)
    del inputs
    rel = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"int8 vs fake-quant (QAT) forms, fcn8s_kitti f32 [1,384,1248]: per layer on "
        f"the same input max |d| / max |y| = {worst:.3g} (bound 1e-4) over "
        f"{len(scales)} convs; whole forward max |dlogits| / max |logits| = {rel:.4g} "
        f"(bound 0.05), labels agree on {100 * agree:.4f} % (bound 99.5 %)")
    if worst > 1e-4 or rel > 0.05 or agree < 0.995:
        raise AssertionError("the int8 forward differs from the fake-quant forward")
    res.update(int8_vs_fq_layer=worst, int8_vs_fq_logits=rel, int8_vs_fq_labels=agree)
    del model, q8, fq
    torch.cuda.empty_cache()

    seg = build_model("segnet", 2, device=dev, dtype=torch.float32, use_bn=True)
    init_params(seg, torch.Generator(device=dev).manual_seed(5))
    rng = np.random.default_rng(5)
    with torch.no_grad():        # BatchNorm away from its init (drawn, seeded)
        for m in seg.modules():
            if isinstance(m, BatchNorm):
                c = m.mean.numel()
                for t, v in ((m.mean, rng.normal(0, 0.1, c)), (m.var, rng.uniform(0.5, 2, c)),
                             (m.scale, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0, 0.1, c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    seg.eval()
    from profile_train import plain_pools

    state, n = quant.fold_batchnorm(seg.state_dict(), convert.transposed_weights(seg))
    folded = copy.deepcopy(seg)
    folded.load_state_dict(state)
    def bn_of(conv: str) -> str:         # enc1.conv0 -> enc1.bn0
        head, _, leaf = conv.rpartition(".")
        return f"{head}.bn{leaf[4:]}"

    inputs = {}
    handles = [m.register_forward_pre_hook(lambda m, a, k=k: inputs.__setitem__(k, a[0]))
               for k, m in seg.named_modules()
               if type(m) is Conv and f"{bn_of(k)}.mean" in state]
    # float32 SegNet: its argmax pools in their plain versions (the kernels
    # take bf16); the fold is what is compared here
    with torch.inference_mode(), plain_pools():
        before = seg(x)
        for h in handles:
            h.remove()
        after = folded(x)
        layer = 0.0
        for k, t in inputs.items():
            y = seg.get_submodule(bn_of(k))(seg.get_submodule(k)(t))
            yf = folded.get_submodule(bn_of(k))(folded.get_submodule(k)(t))
            layer = max(layer, ((yf - y).abs().max() / y.abs().max()).item())
    del inputs
    l2 = ((after - before).norm() / before.norm()).item()
    agree = (after.argmax(-1) == before.argmax(-1)).float().mean().item()
    log(f"BatchNorm folding, segnet_kitti use_bn f32 [1,384,1248]: {n} pairs folded; "
        f"each conv + BN on the same input, folded vs unfolded, max |d| / max |y| = "
        f"{layer:.3g} (bound 1e-4); eval logits relative L2 {l2:.3g} (bound 1e-2), max "
        f"|d| / max |logits| {((after - before).abs().max() / before.abs().max()).item():.3g}"
        f" (unbounded: an argmax pool's near-tie may route either way), labels agree on "
        f"{100 * agree:.4f} % (bound 99.9 %)")
    if n != 26 or len(handles) != 26 or layer > 1e-4 or l2 > 1e-2 or agree < 0.999:
        raise AssertionError("the folded SegNet differs from the unfolded one")
    res.update(fold_pairs=n, fold_layer=layer, fold_logits_l2=l2, fold_labels=agree)
    del seg, folded
    torch.cuda.empty_cache()
    return res


def time_int8_predictor(torch, smi: str, preset: str, png: str,
                        model_kw: str | None = None) -> dict:
    """The bf16 and the int8 Predictor at ``preset`` (the same seeded
    weights; int8 calibrated on ``png``) on ``png``: every quantized
    layer's accumulator held (hold_int8_layers), the overlay kernel held
    against its plain version on the int8 logits (labels and bytes exact),
    then in turns bf16, int8, int8, bf16: ms/image on the host clock
    (median of 5 calls, each ending in the overlay's device->host copy) and
    device ms per call (torch.profiler, 5 calls), the int8 call's device
    time by op; then each one's weight bytes and the peak device memory of
    a call above what was allocated before it."""
    import numpy as np
    from PIL import Image

    from profile_train import profile_device

    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
        argmax_colormap_overlay_cuda, argmax_colormap_overlay_plain,
    )
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import normalize_images
    from semanticsegmentation_tensorflow_tpu_torch.ops.shape import pad_to_multiple

    preds = {"bf16": _int8_predictor(torch, preset, [], model_kw),
             "int8": _int8_predictor(torch, preset, [png], model_kw)}
    q8 = preds["int8"]
    img = np.asarray(Image.open(png).convert("RGB").resize(q8.image_size[::-1],
                                                          Image.BILINEAR))
    xd = q8._to_device(img[None].copy())
    x = pad_to_multiple(normalize_images(xd, q8._mean, q8._std), q8._stride)
    res = {"layers": len(hold_int8_layers(torch, q8.model, x,
                                          f"int8 Predictor {preset}"))}
    logits = q8._padded_logits(xd)
    launched = argmax_colormap_overlay_cuda.launches
    ov_k, lab_k = argmax_colormap_overlay_cuda(xd, logits, q8._palette_dev, q8._alpha)
    argmax_colormap_overlay_cuda.launches = launched
    h, w = img.shape[:2]
    ov_p, lab_p = argmax_colormap_overlay_plain(xd, logits[:, :h, :w], q8._palette_dev,
                                                q8._alpha)
    if not (torch.equal(lab_k, lab_p) and torch.equal(ov_k, ov_p)):
        raise AssertionError(f"overlay on the int8 {preset} logits differs from plain")
    log(f"overlay C={logits.shape[-1]} [1,{h},{w}] on the int8 {preset} logits: labels "
        "and bytes exact against the plain version")
    t = {k: {"host": [], "device": []} for k in preds}
    for name in ("bf16", "int8", "int8", "bf16"):
        p = preds[name]
        p(img)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            p(img)
            ts.append((time.perf_counter() - t0) * 1e3)
        t[name]["host"].append(float(np.median(ts)))
        prof = profile_device(torch, lambda: p(img), 5)
        t[name]["device"].append(prof["device_ms"])
        if name == "int8":
            by_op = prof["by_op"]
    for name, p in preds.items():
        res[f"{name}_ms"] = float(np.mean(t[name]["host"]))
        res[f"{name}_device_ms"] = float(np.mean(t[name]["device"]))
        res[f"{name}_weight_mib"] = sum(
            b.numel() * b.element_size()
            for b in [*p.model.parameters(), *p.model.buffers()]) / 2 ** 20
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        p(img)
        torch.cuda.synchronize()
        res[f"{name}_call_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:6]
    res["int8_top_ops"] = {k: v for k, v in top}
    log(f"Predictor {preset}{' ' + model_kw if model_kw else ''}, 1 image: bf16 "
        f"{res['bf16_ms']:.3f} ms host, device {res['bf16_device_ms']:.3f} ms; int8 "
        f"{res['int8_ms']:.3f} ms host, device {res['int8_device_ms']:.3f} ms (turns "
        f"bf16/int8/int8/bf16, host median of 5, device by torch.profiler); weights "
        f"bf16 {res['bf16_weight_mib']:.1f} MiB, int8 {res['int8_weight_mib']:.1f} MiB; "
        f"a call's peak above its start bf16 {res['bf16_call_peak_gib']:.3f} GiB, int8 "
        f"{res['int8_call_peak_gib']:.3f} GiB; int8 device time by op: "
        + ", ".join(f"{k[:60]} {v:.3f}" for k, v in top) + f" | {smi}")
    del preds, q8
    torch.cuda.empty_cache()
    return res


def int8_phase(torch, smi: str, drive, gen) -> tuple[list[dict], dict]:
    """int8 serving, BatchNorm folding and quantization-aware training
    (``infer/quant.py``, ``ops/quant.py``) at full width, each path run by
    ``drive``: fcn8s_kitti ``infer_image --int8``, serve ``--int8
    --calib-dir``, ``test.py --int8 --calib 4`` and ``eval.py --int8
    --calib-batches 2`` (drive_int8_fcn); ``train.py --qat`` with
    --pallas-preprocess and --resume, then eval.py with and without --int8
    on its checkpoint (drive_int8_qat); segnet_kitti with use_bn (26
    BatchNorms folded) through infer_image, serve and the Predictor with
    --int8; unet_cityscapes ``infer_image --int8``. The int8 product at
    shapes the paths do not give it (check_int8_gemm), the int8 and
    fake-quant forms and BN folding (check_int8_forms), then the bf16 and
    int8 Predictors of fcn8s_kitti, segnet_kitti use_bn and unet_cityscapes
    (every quantized layer's accumulator held, the times; SegNet's int8
    forward with the pool kernels equal to the one with their plain
    versions), and the QAT train step beside the plain ones."""
    import numpy as np
    from PIL import Image

    from profile_train import plain_pools

    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )

    t_phase = time.perf_counter()
    runs, res = [], {}
    res["gemm"] = check_int8_gemm(torch, gen)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        fcn, launches = drive("fcn8s_kitti --int8 serving, sweep and eval",
                              drive_int8_fcn, torch, tmp)
        runs.append(launches)
        if not launches["overlay"] or any(launches[k] for k in (
                "stage1_tail", "stage1_tail_train", "stage1_tail_bwd")):
            raise AssertionError(f"fcn8s_kitti --int8 path: launches {launches}")
        res["fcn"] = fcn
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(tmp, "qat"))
        qat, launches = drive("fcn8s_kitti train.py --qat and eval", drive_int8_qat,
                              torch, os.path.join(tmp, "qat"))
        runs.append(launches)
        # the fused stage1 trains nowhere under the quant-safe flags; the
        # float infer_image and eval on the checkpoint run kernel 1
        if not launches["preprocess_normalize"] or any(launches[k] for k in (
                "stage1_tail_train", "stage1_tail_bwd")):
            raise AssertionError(f"train --qat path: launches {launches}")
        res["qat"] = qat
        torch.cuda.empty_cache()
        seg_tmp = os.path.join(tmp, "segnet")
        os.makedirs(seg_tmp)
        calib = generate_synthetic_kitti(os.path.join(tmp, "calib"), n_train=0, n_test=2,
                                         seed=9)
        seg, launches = drive("segnet_kitti use_bn --int8", drive_slice, torch, seg_tmp,
                              BN_PRESET, BN_KW, ("--int8",),
                              ("--calib-dir", os.path.join(calib, "testing", "image_2")))
        runs.append(launches)
        if not all(launches[k] for k in ("pool_argmax", "unpool", "overlay")) \
                or launches["stage1_tail_segnet"]:
            raise AssertionError(f"segnet_kitti use_bn --int8 path: launches {launches}")
        res["segnet"] = seg
        torch.cuda.empty_cache()
        unet, launches = drive("unet_cityscapes infer_image --int8", drive_unet_int8,
                               torch, tmp)
        runs.append(launches)
        if not launches["overlay"]:
            raise AssertionError(f"unet_cityscapes --int8 path: launches {launches}")
        torch.cuda.empty_cache()

        png = os.path.join(tmp, "kitti_int8.png")
        write_png(png, seed=12)
        res["forms"] = check_int8_forms(torch, png)
        res["fcn8s_kitti"] = time_int8_predictor(torch, smi, "fcn8s_kitti", png)
        res["unet_cityscapes"] = time_int8_predictor(torch, smi, "unet_cityscapes",
                                                     unet["png"])
        res["segnet_kitti_bn"] = time_int8_predictor(torch, smi, BN_PRESET, png, BN_KW)
        pred = _int8_predictor(torch, BN_PRESET, [png], BN_KW)
        x = pred._to_device(np.asarray(Image.open(png).convert("RGB"))[None].copy())
        # the same forward with the pool kernels and with their plain versions
        with torch.inference_mode():
            a = pred._padded_logits(x)
            with plain_pools():
                b = pred._padded_logits(x)
        if not torch.equal(a, b):
            raise AssertionError("segnet int8: the pool kernels change the logits")
        log("segnet_kitti use_bn int8 forward with the argmax pool/unpool kernels: "
            "logits bit-equal to the same forward with their plain versions")
        del pred
        torch.cuda.empty_cache()
    res["steps"] = {w: time_train(torch, smi, w)
                    for w in ("preset_quant_safe", "preset_qat", "preset")}
    for r in res["steps"].values():
        r.pop("by_op", None)
    st = res["steps"]
    log(f"int8 and QAT: Predictor device ms bf16 -> int8: fcn8s_kitti "
        f"{res['fcn8s_kitti']['bf16_device_ms']:.3f} -> "
        f"{res['fcn8s_kitti']['int8_device_ms']:.3f}, unet_cityscapes "
        f"{res['unet_cityscapes']['bf16_device_ms']:.3f} -> "
        f"{res['unet_cityscapes']['int8_device_ms']:.3f}, segnet_kitti use_bn "
        f"{res['segnet_kitti_bn']['bf16_device_ms']:.3f} -> "
        f"{res['segnet_kitti_bn']['int8_device_ms']:.3f}; train step device ms: preset "
        f"{st['preset']['device_ms']:.2f}, quant-safe {st['preset_quant_safe']['device_ms']:.2f}"
        f", --qat {st['preset_qat']['device_ms']:.2f} | {smi}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"int8 phase: {res['phase_s']:.1f} s")
    log("int8 timings: " + json.dumps(res))
    return runs, res


# the export phase's artifacts: (preset, export flags, the kernels the
# artifact's own calls must launch); the int8 artifact also gets
# --calib-dir (generated images)
EXPORT_CASES = (
    ("fcn8s_kitti", (), ("stage1_tail", "overlay")),
    ("segnet_kitti", (), ("stage1_tail_segnet", "pool_argmax", "unpool", "overlay")),
    ("deeplab_kitti_dp", (), ("stage1_tail", "overlay")),
    ("fcn8s_kitti", ("--int8",), ("overlay",)),
)


def _served_predictor(torch, preset: str, extra: tuple, calib: list[str]):
    """The in-process Predictor that ``serve``/``infer_image`` build at
    ``preset`` with ``extra``'s flags (seeded random weights; with
    ``--int8`` calibrated on ``calib``), the export CLI's twin."""
    from argparse import ArgumentParser

    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor,
    )

    p = ArgumentParser()
    add_model_args(p)
    flags = [f for f in extra if f == "--int8"]
    args = p.parse_args(["--preset", preset, "--device", "cuda", *flags])
    return build_predictor(args, torch.device("cuda"), calib_paths=calib)


def drive_artifact(torch, tmp: str, preset: str, extra: tuple, counters: dict,
                   calib: list[str]) -> dict:
    """One serving artifact through the user's entry points:
    ``scripts/export_model.py --platforms cuda`` at ``preset`` (seeded random
    weights; ``extra``: e.g. ``--int8 --calib-dir``), ``serve.py --artifact``
    answering /segment and /labels, each response equal to the in-process
    Predictor's answer (the same flags, ``_served_predictor``); the
    artifact's overlay, labels and label fetch bit-equal to the Predictor's
    at batch 1 and, with a symbolic batch, 2; the launches of the artifact's
    own calls; export and load seconds, the file's size, and the artifact
    against the Predictor in device ms (torch.profiler) and host ms (median
    of 10, in turns Predictor, artifact, artifact, Predictor)."""
    import http.client
    import zipfile

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.infer.export import (
        ExportedPredictor,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import export_model, serve

    hw = get_preset(preset).data.image_size
    tag = preset + ("_int8" if "--int8" in extra else "")
    path = os.path.join(tmp, f"{tag}.segx")
    r = {}
    t0 = time.perf_counter()
    text = run_cli(export_model.main, ["--preset", preset, "--device", "cuda",
                                       "--platforms", "cuda", "--out", path, *extra])
    r["export_s"] = time.perf_counter() - t0
    r["size_mib"] = os.path.getsize(path) / 2 ** 20
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
    if meta["platforms"] != ["cuda"] or f"wrote {path}" not in text:
        raise AssertionError(f"export_model {preset}: {meta} {text!r}")
    r["batch"] = meta["batch_size"] or "symbolic"
    t0 = time.perf_counter()
    art = ExportedPredictor(path, "cuda")
    r["load_s"] = time.perf_counter() - t0
    pred = _served_predictor(torch, preset, extra, calib)
    imgs = np.stack([kitti_like(s, hw) for s in (0, 1)])

    def on_artifact(fn):
        before = {k: w.launches for k, w in counters.items()}
        out = fn()
        torch.cuda.synchronize()
        for k, w in counters.items():
            r["artifact_launches"][k] += w.launches - before[k]
        return out

    r["artifact_launches"] = {k: 0 for k in counters}
    for n in ((1, 2) if meta["batch_size"] is None else (1,)):
        ov, lab = on_artifact(lambda: art(imgs[:n]))
        want_ov, want_lab = pred(imgs[:n])
        labels = on_artifact(lambda: art._fetch_labels(imgs[:n]))
        if not (np.array_equal(ov, want_ov) and np.array_equal(lab, want_lab)
                and np.array_equal(labels, pred._fetch_labels(imgs[:n]))):
            raise AssertionError(f"{tag} artifact: batch {n} differs from the "
                                 "in-process Predictor")
    log(f"{tag} artifact: overlay, labels and label fetch bit-equal to the "
        f"in-process Predictor at batch {'1 and 2' if meta['batch_size'] is None else 1}"
        f"; launches of the artifact's calls {r['artifact_launches']}")

    server, _ = serve.make_server(["--artifact", path, "--device", "cuda",
                                   "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        png = os.path.join(tmp, f"{tag}.png")
        Image.fromarray(imgs[0]).save(png)
        body = open(png, "rb").read()
        labels = pred._fetch_labels(imgs[:1])[0]
        want = {"/segment": host_overlay(imgs[0], labels, pred._palette, pred._alpha),
                "/labels": np.repeat(labels[..., None], 3, -1)}
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=300)
        req_ms = {"/segment": [], "/labels": []}
        for route in ["/segment", "/labels"] * 3:
            t0 = time.perf_counter()
            conn.request("POST", route, body=body)
            resp = conn.getresponse()
            data = resp.read()
            req_ms[route].append((time.perf_counter() - t0) * 1e3)
            got = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            if resp.status != 200 or not np.array_equal(got, want[route]):
                raise AssertionError(f"{tag} serve --artifact {route}: HTTP "
                                     f"{resp.status} or an answer that differs")
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    r["segment_ms"] = float(np.median(req_ms["/segment"]))
    r["labels_ms"] = float(np.median(req_ms["/labels"]))

    one = imgs[:1]
    host = {"pred": [], "art": []}
    for who in ("pred", "art", "art", "pred"):
        f = pred if who == "pred" else art
        host[who].append(host_median_ms(lambda: f._fetch_labels(one), iters=10))
    r["predictor_labels_host_ms"] = host["pred"]
    r["artifact_labels_host_ms"] = host["art"]
    r["predictor_device_ms"], r["predictor_ops"] = device_ms(lambda: pred(one), iters=10)
    r["artifact_device_ms"], r["artifact_ops"] = device_ms(lambda: art(one), iters=10)
    log(f"{tag} artifact: export {r['export_s']:.2f} s, load {r['load_s']:.2f} s, "
        f"{r['size_mib']:.1f} MiB, batch {r['batch']}; serve --artifact /segment "
        f"{r['segment_ms']:.2f} ms, /labels {r['labels_ms']:.2f} ms (median of 3); "
        f"label fetch host ms Predictor {host['pred']}, artifact {host['art']}; "
        f"overlay call device ms Predictor {r['predictor_device_ms']:.3f} "
        f"({r['predictor_ops']} ops), artifact {r['artifact_device_ms']:.3f} "
        f"({r['artifact_ops']} ops)")
    del art, pred, server
    os.remove(path)
    return r


def export_phase(torch, smi: str, drive, counters: dict) -> tuple[list[dict], dict]:
    """Serving artifacts (``infer/export.py``) and per-stage remat: each of
    EXPORT_CASES through drive_artifact (fcn8s_kitti and segnet_kitti at a
    symbolic batch, deeplab_kitti_dp at its fixed batch 1, fcn8s_kitti
    ``--int8 --calib-dir`` over two generated images), each run by
    ``drive``, with the kernels its artifact's calls must launch; then the
    FCN preset step with ``remat`` (one recompute per stage) beside the
    default, whose peak device memory it must stay below. Returns each
    path's launches and the phase's numbers."""
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )

    t_phase = time.perf_counter()
    runs, res = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        data = generate_synthetic_kitti(os.path.join(tmp, "calib"), n_train=0,
                                        n_test=2, seed=9)
        calib_dir = os.path.join(data, "testing", "image_2")
        calib = sorted(os.path.join(calib_dir, f) for f in os.listdir(calib_dir))
        for preset, flags, need in EXPORT_CASES:
            extra = flags + (("--calib-dir", calib_dir) if "--int8" in flags else ())
            r, launches = drive(f"{preset} {' '.join(flags)} artifact".replace("  ", " "),
                                drive_artifact, torch, tmp, preset, extra, counters,
                                calib if flags else [])
            runs.append(launches)
            missing = [k for k in need if not r["artifact_launches"][k]]
            if missing:
                raise AssertionError(f"{preset} {flags} artifact: not launched by "
                                     f"its calls: {missing}")
            res[preset + ("_int8" if flags else "")] = r
            torch.cuda.empty_cache()
    res["remat"] = time_train(torch, smi, "preset_remat")
    res["default"] = time_train(torch, smi, "preset")
    for r in (res["remat"], res["default"]):
        r.pop("by_op", None)
    rm, df = res["remat"], res["default"]
    log(f"preset step, per-stage remat beside the default: peak {rm['peak_gib']:.3f} "
        f"vs {df['peak_gib']:.3f} GiB, {rm['host_ms']:.2f} vs {df['host_ms']:.2f} "
        f"ms/step host, device {rm['device_ms']:.2f} vs {df['device_ms']:.2f} | {smi}")
    if not rm["peak_gib"] < df["peak_gib"]:
        raise AssertionError("remat: the preset step's peak memory did not fall")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"export phase: {res['phase_s']:.1f} s")
    log("export timings: " + json.dumps(res))
    return runs, res


def launch_counters() -> dict:
    """Every kernel wrapper by its counter's name (each adds one to its
    ``launches`` where it launches its kernel)."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
        argmax_colormap_overlay_cuda,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
        pool_argmax, unpool, unpool_bwd,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
        preprocess_normalize,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        stage1_tail, stage1_tail_bwd, stage1_tail_halo, stage1_tail_halo_bwd,
        stage1_tail_segnet, stage1_tail_train,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.winograd import (
        winograd_fwd, winograd_wgrad,
    )

    return {"stage1_tail": stage1_tail, "stage1_tail_train": stage1_tail_train,
            "stage1_tail_bwd": stage1_tail_bwd,
            "preprocess_normalize": preprocess_normalize,
            "overlay": argmax_colormap_overlay_cuda,
            "stage1_tail_segnet": stage1_tail_segnet,
            "pool_argmax": pool_argmax, "unpool": unpool,
            "unpool_bwd": unpool_bwd, "winograd_fwd": winograd_fwd,
            "winograd_wgrad": winograd_wgrad, "stage1_tail_halo": stage1_tail_halo,
            "stage1_tail_halo_bwd": stage1_tail_halo_bwd}


# the multi-rank phase's ZeRO-1 steps: fcn8s_kitti_parity (fc 4096, ~134 M
# parameters) at full width, 8 images of 384x1248 a rank, Adam 1e-4
MULTIRANK_N = 8


def _multirank_zero1(torch, rank: int, world: int) -> dict:
    """One rank's ZeRO-1 check: two Adam steps of the replicated data-grid
    step, then two of the ``shard_opt`` step, from the same seeded weights
    on this rank's 8 images (cuDNN deterministic, so that two runs of one
    step are comparable bit for bit); the parameters after each, each
    run's ms for its second step (CUDA events), optimizer bytes and peak
    device memory, and every kernel's launches over each run's steps."""
    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import _road_scene
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import (
        preprocess as cuda_preprocess,
    )
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import make_grid
    from semanticsegmentation_tensorflow_tpu_torch.train.state import (
        create_train_state, make_lr_schedule, make_optimizer, shard_state_zero1,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

    dev = torch.device("cuda", 0)
    grid = make_grid(world, 1)
    rng = np.random.default_rng(40 + rank)
    imgs, lbls = zip(*(_road_scene(rng, *PADDED_HW) for _ in range(MULTIRANK_N)))
    batch = {"image": torch.from_numpy(np.stack(imgs)).to(dev),
             "label": torch.from_numpy(np.stack(lbls)).to(dev)}
    aug = cuda_preprocess.make_preprocess_augment_fn(MEAN, STD, None)
    wrappers = launch_counters()

    def fresh(shard):
        model = build_model("fcn8s", 2, device=dev,
                            **get_preset("fcn8s_kitti_parity").model_kwargs)
        init_params(model, torch.Generator(device=dev).manual_seed(3))
        st = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-4),
                                make_lr_schedule(1e-4), seed=0)
        return shard_state_zero1(st, grid) if shard else st

    res = {}
    for kind in ("replicated", "zero1"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        st = fresh(kind == "zero1")
        step = make_train_step(2, mesh=grid, augment_fn=aug,
                               shard_opt=kind == "zero1")
        for w in wrappers.values():
            w.launches = 0
        losses = [step(st, batch)["loss"].item()]
        ms = cuda_ms(lambda: losses.append(step(st, batch)["loss"].item()),
                     iters=1, warmup=0)
        launches = {k: w.launches for k, w in wrappers.items()}
        params = {k: p.detach().cpu() for k, p in st.model.named_parameters()}
        opt_bytes = sum(v.numel() * v.element_size()
                        for s in st.optimizer.state.values() for v in s.values()
                        if torch.is_tensor(v))
        res[kind] = dict(losses=losses, params=params, opt_bytes=opt_bytes, ms=ms,
                         peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                         launches=launches)
        del st, step
    a, b = res["replicated"], res["zero1"]
    differ = [k for k, v in a["params"].items() if not torch.equal(v, b["params"][k])]
    out = {"bit_equal": not differ and a["losses"] == b["losses"], "differ": differ[:5],
           "losses": a["losses"], "zero1_losses": b["losses"],
           "checksum": sum(v.double().sum().item() for v in b["params"].values())}
    for kind in res:
        out.update({f"{kind}_{k}": res[kind][k]
                    for k in ("opt_bytes", "ms", "peak_gib", "launches")})
    return out


def multirank_rank(rank: int, world: int, store: str, job: str, out: str) -> int:
    """One rank of the multi-rank phase (``chip_smoke.py --multirank-rank``):
    gloo on cuda:0, then the ZeRO-1 check (``_multirank_zero1``) and the
    job's entry-point calls with ``--distributed`` (the group is up, so
    ``initialize_distributed`` finds it), each with the kernels' launches
    counted around it and this rank's output kept."""
    import contextlib
    import datetime
    import importlib

    import torch
    import torch.distributed as dist

    sys.path[:0] = [REPO]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    torch.cuda.set_device(0)
    spec = torch.load(job)
    res = {"zero1": _multirank_zero1(torch, rank, world), "calls": {}}
    wrappers = launch_counters()
    for name, (script, argv) in spec["calls"].items():
        torch.cuda.empty_cache()
        main = importlib.import_module(f"{PKG}.scripts.{script}").main
        for w in wrappers.values():
            w.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main([*argv, "--distributed"])
        res["calls"][name] = {"rc": rc, "out": buf.getvalue(),
                              "s": time.perf_counter() - t0,
                              "launches": {k: w.launches for k, w in wrappers.items()}}
    torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def check_replicas(torch) -> dict:
    """``Predictor(mesh=[cuda:0, cuda:0])`` (one replica of fcn8s_kitti at
    full width per device, a ragged batch padded to the replica count by
    repeating its last image) against the one-device Predictor on the same
    weights at batches 1, 2 and 3: overlays, labels, fetched label maps
    and road confidence bit-equal to the one-device Predictor's on each
    replica's part (cuDNN picks its algorithms by batch size, so one call
    on 2 images and two on 1 each may round bf16 otherwise); each replica's
    device ms beside the one-device Predictor's."""
    import copy

    import numpy as np

    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset

    dev = torch.device("cuda", 0)
    model = build_model("fcn8s", 2, device=dev,
                        **get_preset("fcn8s_kitti").model_kwargs)
    init_params(model, torch.Generator(device=dev).manual_seed(6))
    one = Predictor(copy.deepcopy(model), IMAGE_HW, device=dev)
    two = Predictor(model, IMAGE_HW, device=dev, mesh=[dev, dev])
    rng = np.random.default_rng(8)
    def by_parts(fn, imgs):
        """``fn`` of the one-device Predictor on each replica's part."""
        x = np.concatenate([imgs, np.repeat(imgs[-1:], len(imgs) % 2, 0)])
        k = len(x) // 2
        outs = [fn(x[i * k:(i + 1) * k]) for i in range(2)]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        return tuple(np.concatenate(o)[:len(imgs)] for o in zip(*outs))

    for n in (1, 2, 3):
        imgs = np.stack([kitti_like(int(s)) for s in rng.integers(0, 1000, n)])
        for what, a, b in (("call", by_parts(one, imgs), two(imgs)),
                           ("labels", by_parts(one._fetch_labels, imgs),
                            (two._fetch_labels(imgs),)),
                           ("confidence", by_parts(one.confidence, imgs),
                            (two.confidence(imgs),))):
            if not all(np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"replicas: {what} at batch {n} differs from "
                                     "one device on the same parts")
    x = torch.from_numpy(kitti_like(1)[None]).to(dev)
    ms_one = cuda_ms(lambda: one._fwd(x), iters=10)
    ms_rep = cuda_ms(lambda: two._replicas[0]._fwd(x), iters=10)
    return {"ms_one_device": ms_one, "ms_replica": ms_rep}


def multirank_phase(torch, smi: str, drive) -> tuple[list[dict], dict]:
    """The multi-rank leftovers, with two gloo ranks sharing cuda:0 (this
    script re-run as ``--multirank-rank``; two ranks on one card over gloo,
    whose collectives pass through host memory: a path check, not a
    multi-GPU number). ZeRO-1: each rank's two replicated and two
    ``shard_opt`` steps at fcn8s_kitti_parity bit-equal, its optimizer bytes
    about half, kernels 1, 1b and 4 launched; then the ranks' entry points:
    ``train --shard-opt`` (one step of 16 at fcn8s_kitti), ``train --qat
    --pallas-preprocess`` (one step, calibrated on one global batch of 16)
    and ``eval --distributed --road-metrics`` (batch 4) on the --shard-opt
    run's checkpoint over the 16 generated images. Then the replicas
    (check_replicas, run by ``drive``) and the one-process references,
    with the ranks' deterministic cuDNN: the QAT scales equal to one
    process's calibration on the same global batches, the eval's metric lines
    (from the confusion matrix and road histogram) equal to one process's
    at batch 2, which runs the forwards of the ranks' batch 4 shards, the
    loss within 1e-3. Returns the launches of the paths and the numbers."""
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.infer import quant
    from semanticsegmentation_tensorflow_tpu_torch.scripts import (
        eval as eval_cli, train as train_cli,
    )

    t_phase = time.perf_counter()
    res: dict = {}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        data = generate_synthetic_kitti(os.path.join(tmp, "kitti"), n_train=16,
                                        n_test=1, seed=12)
        base = ["--preset", "fcn8s_kitti", "--data-dir", data, "--device", "cuda",
                "--epochs", "1", "--batch-size", "16", "--pallas-preprocess"]
        zck, qck = os.path.join(tmp, "zero1_ck"), os.path.join(tmp, "qat_ck")
        ev = ["--preset", "fcn8s_kitti", "--data-dir", data, "--device", "cuda",
              "--checkpoint-dir", zck, "--road-metrics"]
        calls = {"shard_opt": ("train", [*base, "--shard-opt", "--checkpoint-dir", zck]),
                 "qat": ("train", [*base, "--qat", "--qat-calib-batches", "1",
                                   "--checkpoint-dir", qck]),
                 "eval": ("eval", [*ev, "--batch-size", "4"])}
        job = os.path.join(tmp, "multirank_job.pt")
        torch.save({"calls": calls}, job)
        store = os.path.join(tmp, "multirank_store")
        outs = [os.path.join(tmp, f"multirank_rank{r}.pt") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--multirank-rank", str(r), "2", store, job, outs[r]])
                 for r in range(2)]
        try:
            _wait_ranks(procs)
        finally:
            _kill_ranks(procs)
        res["replicas"], launches = drive("replicas", check_replicas, torch)
        runs.append(launches)
        missing = [k for k in ("stage1_tail", "overlay") if not launches[k]]
        if missing:
            raise AssertionError(f"not launched by the replicas: {missing}")
        ranks = [torch.load(o) for o in outs]
        for r, rk in enumerate(ranks):
            z = rk["zero1"]
            if not z["bit_equal"]:
                raise AssertionError(f"rank {r}: ZeRO-1 differs from the replicated "
                                     f"step: losses {z['losses']} vs "
                                     f"{z['zero1_losses']}, params {z['differ']}")
            half = z["zero1_opt_bytes"] / z["replicated_opt_bytes"]
            if not 0.45 < half < 0.55:
                raise AssertionError(f"rank {r}: ZeRO-1 optimizer bytes {half:.3f} "
                                     "of the replicated run's")
            missing = [k for k in ("stage1_tail_train", "stage1_tail_bwd",
                                   "preprocess_normalize") if not z["zero1_launches"][k]]
            if missing:
                raise AssertionError(f"rank {r}: not launched by the ZeRO-1 steps: "
                                     f"{missing}")
            for name, c in rk["calls"].items():
                if c["rc"] != 0:
                    raise AssertionError(f"rank {r}: {name} returned {c['rc']}")
        if ranks[0]["zero1"]["checksum"] != ranks[1]["zero1"]["checksum"]:
            raise AssertionError("ZeRO-1: the ranks' parameters differ")
        calls0 = ranks[0]["calls"]
        print(calls0["shard_opt"]["out"] + calls0["qat"]["out"] + calls0["eval"]["out"],
              end="")
        if "ZeRO-1: optimizer state sharded over 2 devices" not in calls0["shard_opt"]["out"]:
            raise AssertionError("train --shard-opt printed no ZeRO-1 line")
        for name, need in (("shard_opt", ("stage1_tail_train", "stage1_tail_bwd",
                                          "preprocess_normalize")),
                           ("qat", ("preprocess_normalize",)),
                           ("eval", ("stage1_tail",))):
            missing = [k for k in need if not calls0[name]["launches"][k]]
            if missing:
                raise AssertionError(f"{name} on two ranks: not launched {missing}")
        runs.extend({k: sum(rk["calls"][name]["launches"][k] for rk in ranks)
                     for k in ranks[0]["calls"][name]["launches"]}
                    for name in calls)
        runs.extend(rk["zero1"]["zero1_launches"] for rk in ranks)
        # the one-process references, with the ranks' deterministic cuDNN
        torch.backends.cudnn.deterministic = True
        try:
            one_q = os.path.join(tmp, "qat_one")
            run_cli(train_cli.main, [*calls["qat"][1][:-1], one_q])
            one_ev = run_cli(eval_cli.main, [*ev, "--batch-size", "2"])
        finally:
            torch.backends.cudnn.deterministic = False
        got = quant.load_act_scales(os.path.join(qck, "qat_scales.json"))
        want = quant.load_act_scales(os.path.join(one_q, "qat_scales.json"))
        if got != want:
            rel = max((abs(got[k] - want[k]) / want[k] for k in set(got) & set(want)),
                      default=None)
            raise AssertionError(f"QAT scales on two ranks differ from one process's: "
                                 f"layers {sorted(set(got) ^ set(want))} apart, worst "
                                 f"relative {rel}")
        two_ev = calls0["eval"]["out"]

        def lines(text):
            return [x.split(" iou=")[1] if x.startswith("loss=") else x
                    for x in text.splitlines() if x.startswith(("loss=", "kitti-road:"))]

        a, b = parse_eval(two_ev), parse_eval(one_ev)
        if lines(two_ev) != lines(one_ev) or a["miou"] != b["miou"] \
                or a["pixel_acc"] != b["pixel_acc"] or abs(a["loss"] - b["loss"]) > 1e-3:
            raise AssertionError(f"eval --distributed {lines(two_ev)} {a} vs one "
                                 f"process {lines(one_ev)} {b}")
        z = ranks[0]["zero1"]
        res.update(zero1={k: z[k] for k in z if k not in ("differ", "checksum")},
                   zero1_rank1_peak_gib=(ranks[1]["zero1"]["replicated_peak_gib"],
                                         ranks[1]["zero1"]["zero1_peak_gib"]),
                   qat_scales_equal=True,
                   eval_two_ranks=a, eval_one=b,
                   call_s={k: c["s"] for k, c in calls0.items()})
    log(f"ZeRO-1 at fcn8s_kitti_parity, 2 gloo ranks on cuda:0, 8 images of "
        f"384x1248 a rank: bit-equal to the replicated step; optimizer "
        f"{z['zero1_opt_bytes'] / 1e9:.3f} vs {z['replicated_opt_bytes'] / 1e9:.3f} GB "
        f"a rank; {z['zero1_ms']:.1f} vs {z['replicated_ms']:.1f} ms/step; peak "
        f"{z['zero1_peak_gib']:.2f} vs {z['replicated_peak_gib']:.2f} GiB (rank 0) | {smi}")
    log(f"QAT scales on two ranks equal one process's; eval --distributed "
        f"metrics equal one process's; "
        f"replicas {res['replicas']['ms_replica']:.3f} vs one device "
        f"{res['replicas']['ms_one_device']:.3f} ms | {smi}")
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"multirank phase: {res['phase_s']:.1f} s")
    log("multirank timings: " + json.dumps(res))
    return runs, res


def main() -> int:
    if sys.argv[1:2] == ["--grid-rank"]:     # a rank of check_grid's phase
        rank, world, store, job, out = sys.argv[2:7]
        return grid_rank(int(rank), int(world), store, job, out)
    if sys.argv[1:2] == ["--multirank-rank"]:     # a rank of multirank_phase
        rank, world, store, job, out = sys.argv[2:7]
        return multirank_rank(int(rank), int(world), store, job, out)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tools")]  # the package, profile_train
    try:
        from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build
        counters = launch_counters()
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    if not os.path.abspath(build.__file__).startswith(os.path.join(REPO, PKG)):
        print(f"chip_smoke: the port package was imported from {build.__file__},"
              " not from this checkout", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.lib()
    log(f"kernels built from {[s.name for s in build.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s -> {build.library_path()}")
    for line in build.build_log().splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    stage1 = check_stage1(torch, gen)
    overlay = check_overlay(torch, gen)
    stage1_bwd = check_stage1_train(torch, gen)
    preprocess = check_preprocess(torch, gen)
    segnet_stage1 = check_segnet_stage1(torch, gen)
    pool = check_pool(torch, gen)
    torch.cuda.empty_cache()
    winograd = check_winograd(torch, gen)
    torch.cuda.empty_cache()
    halo = check_stage1_halo(torch, gen)
    torch.cuda.empty_cache()

    def drive(path, fn, *args):
        """Run one main path with every launch counter at 0 just before it
        and return the counts read just after."""
        for wrapper in counters.values():
            wrapper.launches = 0
        result = fn(*args)
        launches = {k: w.launches for k, w in counters.items()}
        log(f"kernel launches on the {path} path: {launches}")
        return result, launches

    with tempfile.TemporaryDirectory() as tmp:
        times, infer_launches = drive("inference", drive_fcn_inference, torch,
                                      tmp)
    if not (infer_launches["stage1_tail"] and infer_launches["overlay"]):
        raise AssertionError("a kernel was not launched on the inference path: "
                             f"{infer_launches}")
    check_end_to_end(torch)
    log("timings (s or ms as named): " + json.dumps(times))

    # the host IO of the serving path and the sweep, then the test-set sweep
    # (scripts/test.py) at both models
    host_io = check_host_io()
    with tempfile.TemporaryDirectory() as tmp:
        sweep, sweep_launches = drive("test-set sweep", drive_sweep, torch, tmp,
                                      counters)
    log("sweep timings: " + json.dumps(dict(sweep, host_io=host_io)))

    with tempfile.TemporaryDirectory() as tmp:
        train_times, train_launches = drive("training", drive_training, torch, tmp)
    missing = [k for k in ("stage1_tail_train", "stage1_tail_bwd",
                           "preprocess_normalize") if not train_launches[k]]
    if missing:
        raise AssertionError(f"not launched on the training path: {missing}")
    check_train_step(torch)
    preset = time_train(torch, smi, "preset")
    bench = time_train(torch, smi, "bench")
    log("training timings: " + json.dumps(
        dict(train_times, preset=preset, bench_workload=bench)))
    torch.cuda.empty_cache()

    # validated training (--val-frac, --keep-best, both jitters, decode
    # workers, a strict VGG16 import) and the eval CLI at fcn8s_kitti, the
    # eval CLI at segnet_kitti and the eval step held against plain PyTorch
    # (the preset step with remat beside the one without: export_phase)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        val_run, val_launches = drive("validated training and eval",
                                      drive_validated_training, torch, tmp)
        missing = [k for k in ("stage1_tail", "stage1_tail_train", "stage1_tail_bwd")
                   if not val_launches[k]]
        if missing:
            raise AssertionError(f"not launched on the validated training and "
                                 f"eval path: {missing}")
        seg_eval, seg_eval_launches = drive("segnet eval", drive_segnet_eval, torch,
                                            tmp, val_run["data"])
        missing = [k for k in ("stage1_tail_segnet", "pool_argmax", "unpool")
                   if not seg_eval_launches[k]]
        if missing:
            raise AssertionError(f"not launched on the segnet eval path: {missing}")
        plain_eval = check_eval_against_plain(torch, val_run["data"], val_run["ckpt"],
                                              val_run["eval"])
    torch.cuda.empty_cache()
    log(f"eval img/s by the CLI's clock after the model build (40 images, batch "
        f"4): fcn8s_kitti {val_run['eval']['img_per_s']:.2f}, --ema "
        f"{val_run['eval_ema']['img_per_s']:.2f}, segnet_kitti "
        f"{seg_eval['img_per_s']:.2f}; validation {val_run['val_seconds']:.3f} s "
        f"per epoch (10 images) | {smi}")
    log(f"validated training and eval phase: {time.perf_counter() - t_phase:.1f} s")
    log("eval timings: " + json.dumps(dict(
        {k: v for k, v in val_run.items() if k not in ("data", "ckpt")},
        segnet_eval=seg_eval, plain=plain_eval)))
    torch.cuda.empty_cache()

    # --spatial: at one rank through train.main (kernel 1c, no single-device
    # stage1 kernel), the preset step with 1c beside the one with 1/1b, and
    # the 2-rank grid on this card
    single_stage1 = ("stage1_tail", "stage1_tail_train", "stage1_tail_bwd",
                     "stage1_tail_segnet")
    spatial_runs = []
    for sp_preset in ("fcn8s_kitti", "segnet_kitti"):
        with tempfile.TemporaryDirectory() as tmp:
            sp_times, sp_launches = drive(f"{sp_preset} --spatial 2 training",
                                          drive_spatial_training, torch, tmp, sp_preset)
        spatial_runs.append(sp_launches)
        missing = [k for k in ("stage1_tail_halo", "stage1_tail_halo_bwd",
                               "preprocess_normalize") if not sp_launches[k]]
        if missing or any(sp_launches[k] for k in single_stage1):
            raise AssertionError(f"{sp_preset} --spatial 2: launches {sp_launches}")
        torch.cuda.empty_cache()
    spmd = time_train(torch, smi, "preset_spmd")
    preset_again = time_train(torch, smi, "preset")
    log("--spatial at one rank, preset step (1c) beside the default (1/1b): "
        f"{spmd['host_ms']:.2f} vs {preset['host_ms']:.2f} and "
        f"{preset_again['host_ms']:.2f} ms/step")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        grid = check_grid(torch, tmp, smi)
    log("grid timings: " + json.dumps(grid))
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        seg_times, seg_infer_launches = drive("segnet inference", drive_slice,
                                              torch, tmp, "segnet_kitti")
    missing = [k for k in ("stage1_tail_segnet", "pool_argmax", "unpool", "overlay")
               if not seg_infer_launches[k]]
    if missing:
        raise AssertionError(f"not launched on the segnet inference path: {missing}")
    check_segnet_end_to_end(torch)
    log("segnet timings (s or ms as named): " + json.dumps(seg_times))
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        seg_train_times, seg_train_launches = drive(
            "segnet training", drive_training, torch, tmp, "segnet_kitti")
    missing = [k for k in ("stage1_tail_segnet", "stage1_tail_bwd", "pool_argmax",
                           "unpool", "unpool_bwd", "preprocess_normalize")
               if not seg_train_launches[k]]
    if missing:
        raise AssertionError(f"not launched on the segnet training path: {missing}")
    check_segnet_train_step(torch)
    torch.cuda.empty_cache()
    segnet = time_train(torch, smi, "segnet")
    log("segnet training timings: " + json.dumps(dict(seg_train_times,
                                                      segnet=segnet)))
    torch.cuda.empty_cache()

    # the Winograd paths: FCN-8s winograd=f2 serving and training through the
    # entry points, SegNet winograd=f4 (a Predictor call and a train step)
    with tempfile.TemporaryDirectory() as tmp:
        w_times, w_infer_launches = drive("fcn8s winograd=f2 inference", drive_slice,
                                          torch, tmp, "fcn8s_kitti", "winograd=f2")
    missing = [k for k in ("winograd_fwd", "stage1_tail", "overlay")
               if not w_infer_launches[k]]
    if missing:
        raise AssertionError(f"not launched on the winograd inference path: {missing}")
    check_winograd_end_to_end(torch)
    log("fcn8s winograd=f2 timings (s or ms as named): " + json.dumps(w_times))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        w_train_times, w_train_launches = drive(
            "fcn8s winograd=f2 training", drive_training, torch, tmp, "fcn8s_kitti",
            "winograd=f2")
    missing = [k for k in ("winograd_fwd", "winograd_wgrad", "stage1_tail_train",
                           "stage1_tail_bwd") if not w_train_launches[k]]
    if missing:
        raise AssertionError(f"not launched on the winograd training path: {missing}")
    log("fcn8s winograd=f2 training: " + json.dumps(w_train_times))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        _, w_seg_launches = drive("segnet winograd=f4", drive_segnet_winograd, torch,
                                  tmp)
    missing = [k for k in ("winograd_fwd", "winograd_wgrad", "stage1_tail_segnet")
               if not w_seg_launches[k]]
    if missing:
        raise AssertionError(f"not launched on the segnet winograd=f4 path: {missing}")
    torch.cuda.empty_cache()

    dl_runs = deeplab_phase(torch, smi, drive)
    unet_runs, unet = unet_phase(torch, smi, drive, gen)
    bn_runs, bn = bn_phase(torch, smi, drive)
    tta_runs, _ = tta_tiled_phase(torch, smi, drive)
    int8_runs, _ = int8_phase(torch, smi, drive, gen)
    export_runs, _ = export_phase(torch, smi, drive, counters)
    multirank_runs, _ = multirank_phase(torch, smi, drive)

    def total(*keys):
        return sum(runs[k] for runs in (infer_launches, sweep_launches,
                                        train_launches, val_launches,
                                        seg_eval_launches,
                                        seg_infer_launches, seg_train_launches,
                                        w_infer_launches, w_train_launches,
                                        w_seg_launches, *spatial_runs, *dl_runs,
                                        *unet_runs, *bn_runs, *tta_runs,
                                        *int8_runs, *export_runs,
                                        *multirank_runs)
                   for k in keys)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name="stage1_tail", route="cuda",
             source=f"{PKG}/csrc/stage1_tail.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/stage1.py:155",
             launches=total("stage1_tail", "stage1_tail_train"), **stage1,
             **{k: stage1_bwd[k] for k in ("train_fwd_ms", "train_fwd_library_ms",
                                           "train_fwd_bound_ms")}),
        dict(name="stage1_tail_bwd", route="cuda",
             source=f"{PKG}/csrc/stage1_bwd.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/stage1.py:271",
             launches=total("stage1_tail_bwd"),
             **{k: stage1_bwd[k] for k in keys + (
                 "dgrad_ms", "library_dgrad_ms", "dgrad_bound_ms", "wgrad_ms",
                 "library_wgrad_ms")}),
        dict(name="preprocess_normalize", route="cuda",
             source=f"{PKG}/csrc/preprocess.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/preprocess.py:40",
             launches=total("preprocess_normalize")
             + sum(unet["grid"]["grid_launches"]), **preprocess),
        dict(name="argmax_colormap_overlay", route="cuda",
             source=f"{PKG}/csrc/overlay.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/overlay.py:29",
             launches=total("overlay"), **overlay),
        dict(name="stage1_tail_segnet", route="cuda",
             source=f"{PKG}/csrc/stage1_tail.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/stage1.py:235",
             launches=total("stage1_tail_segnet"),
             **{k: segnet_stage1[k] for k in keys}),
        dict(name="argmax_pool_unpool", route="cuda",
             source=f"{PKG}/csrc/pool.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/pool.py:44",
             launches=total("pool_argmax", "unpool", "unpool_bwd")
             + sum(bn["grid"]["grid_launches"]), **pool),
        dict(name="winograd", route="cuda",
             source=f"{PKG}/csrc/winograd.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/winograd.py:146 "
                      "and :231",
             launches=total("winograd_fwd", "winograd_wgrad"),
             **{k: winograd[k] for k in keys}),
        # the --spatial train.main runs, and the grid phase's rank 0
        dict(name="stage1_tail_halo", route="cuda",
             source=f"{PKG}/csrc/stage1_tail.cu and {PKG}/csrc/stage1_bwd.cu",
             replaces="semanticsegmentation_tensorflow_tpu/ops/pallas/stage1.py:636 "
                      "and :652",
             launches=total("stage1_tail_halo", "stage1_tail_halo_bwd")
             + sum(grid["grid_launches"]),
             **{k: halo[k] for k in keys + ("fwd_ms", "fwd_library_ms", "bwd_dgrad_ms",
                                            "bwd_library_dgrad_ms")}),
    ]

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
