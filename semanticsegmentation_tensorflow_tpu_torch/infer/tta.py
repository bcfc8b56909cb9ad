"""Test-time augmentation: horizontal flip and multi-scale probability
averaging for evaluation (counterpart of the JAX package's
``infer/tta.py``).

Each (scale, flip) variant runs the model at a stride-aligned scaled size,
edge-padded to the model's stride and cropped back; the flipped variant's
logits are flipped back; each variant's f32 softmax is resized back to the
input grid and the probabilities (not the logits) are averaged. Resizes are
bilinear with half-pixel centres and, when shrinking, antialiased, as
``jax.image.resize(..., "bilinear")`` computes them (the call of
``data/augment.py``'s scale jitter); a scale of exactly 1.0 does no resize.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import labels_from_logits
from semanticsegmentation_tensorflow_tpu_torch.ops.shape import (
    crop_to, pad_to_multiple,
)
from semanticsegmentation_tensorflow_tpu_torch.train.metrics import (
    binary_confidence_histogram, confusion_matrix,
)


def _scale_hw(h: int, w: int, scale: float, stride: int) -> tuple[int, int]:
    """The size of a scale's variant: at least one stride tile, rounded to
    a stride multiple."""
    return (max(stride, int(round(h * scale / stride)) * stride),
            max(stride, int(round(w * scale / stride)) * stride))


def _resize(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """NHWC f32 ``x`` to ``hw``: ``jax.image.resize``'s bilinear."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def make_tta_logits_fn(model, scales: Sequence[float] = (1.0,),
                       flip: bool = True) -> Callable:
    """Build ``fn(x) -> mean class probabilities``: ``x`` [N,H,W,3] float,
    already normalized; the result [N,H,W,C] f32, the softmax averaged over
    every (scale, flip) variant. The caller sets the model's mode (the
    eval step runs it in ``eval()``, BatchNorm on its running statistics)."""
    stride = getattr(model, "total_stride", 32)
    scales = tuple(float(s) for s in scales) or (1.0,)

    def logits_at(x: torch.Tensor) -> torch.Tensor:
        return crop_to(model(pad_to_multiple(x, stride)), x.shape[1], x.shape[2])

    def fn(x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        total = None
        for s in scales:
            xs = x if s == 1.0 else _resize(x.float(), _scale_hw(h, w, s, stride))
            variants = [xs] + ([xs.flip(2)] if flip else [])
            for i, xv in enumerate(variants):
                lg = logits_at(xv.contiguous())
                if i == 1:             # the flipped variant, flipped back
                    lg = lg.flip(2)
                p = torch.softmax(lg.float(), dim=-1)
                if p.shape[1:3] != (h, w):
                    p = _resize(p, (h, w))
                total = p if total is None else total + p
        return total / (len(scales) * (2 if flip else 1))

    return fn


def make_tta_eval_step(num_classes: int, scales: Sequence[float] = (1.0,),
                       flip: bool = True, mesh=None,
                       road_hist: bool = False) -> Callable:
    """The eval step with TTA, ``step(state, batch) -> {"loss", "cm",
    "pred"[, "road_hist"]}``: a drop-in for ``train.step.make_eval_step``,
    with its signature (``state`` a TrainState or the model itself, whose
    forward runs and whose mode is restored; the JAX step's architecture
    argument has no counterpart, as the port's model holds its weights).
    ``pred`` is the first-max argmax of the ensemble probabilities (``p1 >
    p0`` at C == 2), ``loss`` the ensemble's NLL ``-log(max(p, 1e-30))`` at
    the label, as a masked sum over ``max(valid_sum, 1)``; at ``scales=(1.0,)``
    without flip it is the plain eval step's. ``road_hist`` (binary models)
    histograms the ensemble's probability of class 1. ``mesh``: a data-only
    ``parallel.mesh.Grid``; one ``all_reduce(SUM)`` covers cm, the loss
    sums and the histogram."""
    from semanticsegmentation_tensorflow_tpu_torch.train.step import (
        _all_reduce_sums,
    )

    if road_hist and num_classes != 2:
        raise ValueError("road_hist needs a binary (num_classes=2) model")
    if mesh is not None and mesh.spatial > 1:
        raise ValueError("the eval step shards over a data-only grid")

    def step(state, batch: dict) -> dict:
        m = getattr(state, "model", state)
        was_training = m.training
        m.eval()
        try:
            with torch.no_grad():
                probs = make_tta_logits_fn(m, scales, flip)(batch["image"])
        finally:
            m.train(was_training)
        label, valid = batch["label"], batch.get("valid")
        pred = labels_from_logits(probs)
        cm = confusion_matrix(label, pred, num_classes, valid)
        hist = (binary_confidence_histogram(probs[..., 1], label == 1, valid)
                if road_hist else None)
        logp = torch.log(torch.clamp(probs, min=1e-30))
        inside = (label >= 0) & (label < num_classes)
        ce = -logp.gather(-1, label.long().clamp(0, num_classes - 1)
                          .unsqueeze(-1)).squeeze(-1) * inside
        if valid is not None:
            v = valid.to(ce.dtype)
            ce_sum, valid_sum = (ce * v).sum(), v.sum()
        else:
            ce_sum = ce.sum()
            valid_sum = torch.tensor(float(ce.numel()), device=ce.device)
        if mesh is not None and mesh.world > 1:
            ce_sum, valid_sum, cm, hist = _all_reduce_sums(ce_sum, valid_sum,
                                                           cm, hist)
        out = {"loss": ce_sum / valid_sum.clamp(min=1.0), "cm": cm, "pred": pred,
               "ce_sum": ce_sum, "valid_sum": valid_sum}
        if hist is not None:
            out["road_hist"] = hist
        return out

    return step
