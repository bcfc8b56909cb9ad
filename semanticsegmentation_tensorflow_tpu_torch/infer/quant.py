"""Post-training int8 quantization, BatchNorm folding and quantization-aware
training of the port's models (counterpart of the JAX package's
``infer/quant.py``; the numbers are ``ops/quant.py``'s).

The convs that quantize are those the JAX package's ``conv_paths`` lists:
every ``Conv`` and ``ConvTranspose`` module the forward calls, of exactly
those types (DeepLab's ``project``, a ``Conv`` subclass that reads its
weight itself, stays float, as the JAX ``_ASPPProject`` does), in call
order, keyed by their flax paths (``vgg16/stage1/conv0``) so that scales
and trees are the JAX package's strings. The model must be built with
``models.registry.merge_quant_safe_kwargs``, or the fused and packed paths
call their convs outside the modules and those stay float.

* :func:`quantize_model` puts a ``QuantConv`` / ``QuantConvTranspose`` in
  place of each listed conv, at the same attribute name: int8 weights
  (per output channel) and an activation scale each (weight-only where it
  has none). :func:`quantize_for_inference` folds BatchNorm, calibrates (or
  takes given scales) and quantizes.
* :func:`calibrate_act_scales`: ``amax(|input|) / 127`` per conv
  over calibration batches (1.0 where the amax is 0).
* :func:`fold_batchnorm`: inference BatchNorm into the preceding conv, on a
  ``state_dict``, in float64, the BatchNorm then the identity.
* :func:`fake_quantize`: quantization-aware training, a mode of the same
  modules (``Conv.qat``), so the parameters, the optimizer and the
  checkpoints do not change.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Iterable, Sequence

import numpy as np
import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    BN_EPSILON, Conv,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import (
    ConvTranspose,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.quant import (
    QuantConv, QuantConvTranspose,
)

_QUANTIZED = {Conv: QuantConv, ConvTranspose: QuantConvTranspose}


def flax_path(module_name: str) -> str:
    """``vgg16.stage1.conv0`` -> ``vgg16/stage1/conv0``."""
    return module_name.replace(".", "/")


def _recorded_forward(model: nn.Module, batches: Iterable[torch.Tensor],
                      record, grid=None) -> int:
    """Run ``model`` in eval mode without gradients over ``batches``,
    calling ``record(path, input)`` before every call of a conv of exactly
    one of ``_QUANTIZED``'s types. Returns the batch count; the model's mode
    is restored. ``grid``: the active grid of the forwards
    (``parallel.mesh.use_grid``), where each batch is this rank's share."""
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import use_grid

    hooks = []
    for name, m in model.named_modules():
        if type(m) in _QUANTIZED:
            path = flax_path(name)
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, path=path: record(path, args[0])))
    training = model.training
    model.eval()
    n = 0
    try:
        with torch.no_grad(), use_grid(grid):
            for x in batches:
                model(x)
                n += 1
    finally:
        for h in hooks:
            h.remove()
        model.train(training)
    return n


def conv_paths(model: nn.Module, sample_shape: Sequence[int] | None = None
               ) -> list[str]:
    """The flax paths of the supported convs the forward calls, in call
    order: one no-grad eval forward at ``sample_shape`` (default: one
    stride-sized image) with forward pre-hooks."""
    found: list[str] = []

    def record(path, _x):
        if path not in found:
            found.append(path)

    if sample_shape is None:
        stride = getattr(model, "total_stride", 32)
        sample_shape = (1, stride, stride, 3)
    device = next(model.parameters()).device
    _recorded_forward(model, [torch.zeros(tuple(sample_shape), device=device)],
                      record)
    return found


def _submodule(model: nn.Module, path: str) -> tuple[nn.Module, str]:
    *head, leaf = path.split("/")
    parent = model
    for part in head:
        parent = getattr(parent, part)
    return parent, leaf


def quantize_model(model: nn.Module, act_scales: dict[str, float] | None = None,
                   sample_shape: Sequence[int] | None = None) -> nn.Module:
    """Replace every conv of :func:`conv_paths` by its quantized module (in
    place; returns ``model``): int8 weights per output channel, the
    activation scale ``act_scales[path]``, weight-only where there is none.
    The rest of the model (BatchNorm, DeepLab's projection) stays float."""
    scales = dict(act_scales or {})
    for path in conv_paths(model, sample_shape):
        parent, leaf = _submodule(model, path)
        conv = getattr(parent, leaf)
        setattr(parent, leaf, _QUANTIZED[type(conv)](conv, scales.get(path)))
    return model


def calibrate_act_scales(model: nn.Module, batches: Iterable[torch.Tensor],
                         grid=None) -> dict[str, float]:
    """Per-tensor activation scales: ``amax(|conv input|) / 127`` over the
    calibration ``batches`` (normalized, stride-padded model input), 1.0
    where a conv's amax is 0: the JAX function at its default margin of 1,
    which every caller there uses. The maxima stay on the device until the
    end.

    With a ``grid`` of ranks (``parallel.mesh.Grid``) each batch is this
    rank's images and rows of a global batch and the forward runs with the
    grid active; each rank records the maxima of its own inputs (a halo row
    is a copy of a row another rank holds, and a conv module's input holds
    none), then one MAX all-reduce over the world gives every rank the
    scales one process computes over the global batches."""
    amax: dict[str, torch.Tensor] = {}

    def record(path, x):
        a = x.detach().float().abs().amax()
        amax[path] = torch.maximum(amax[path], a) if path in amax else a

    if _recorded_forward(model, batches, record, grid) == 0:
        raise ValueError("calibration needs at least one batch")
    if grid is not None and grid.world > 1:
        import torch.distributed as dist

        keys = sorted(amax)
        flat = torch.stack([amax[k] for k in keys])
        dist.all_reduce(flat, op=dist.ReduceOp.MAX)
        amax = dict(zip(keys, flat.unbind()))
    return {k: float(v) / 127.0 if float(v) > 0 else 1.0
            for k, v in amax.items()}


def quantized_count(model: nn.Module) -> int:
    """The model's int8 convs."""
    return sum(isinstance(m, (QuantConv, QuantConvTranspose))
               for m in model.modules())


def fold_batchnorm(state_dict: dict[str, torch.Tensor],
                   transposed: Iterable[str] = (), eps: float = BN_EPSILON
                   ) -> tuple[dict[str, torch.Tensor], int]:
    """Inference BatchNorm folded into the preceding conv of a port
    ``state_dict`` (the JAX ``fold_batchnorm``, bit for bit): with ``g =
    scale / sqrt(var + eps)`` in float64, ``w' = w * g`` along the output
    channels (OIHW dim 0; dim 1 of a key in ``transposed``) and ``b' = (b -
    mean) * g + bn_bias``, each rounded back to float32; the BatchNorm is
    then the identity (scale 1, bias 0, mean 0, var ``1 - eps``). Pairs
    ``conv{i}``/``bn{i}`` (``ConvBlock``) and ``{name}``/``{name}_bn`` (the
    ASPP head), when the conv has a bias, is not int8 and has the BN's
    channels. Returns ``(new state_dict, pairs folded)``; the input is left
    as it was."""
    out = dict(state_dict)
    transposed = set(transposed)
    n = 0
    for key in state_dict:
        if not key.endswith(".mean"):
            continue
        bn = key[:-len(".mean")]
        head, _, leaf = bn.rpartition(".")
        if leaf.startswith("bn"):
            conv = "conv" + leaf[2:]
        elif leaf.endswith("_bn"):
            conv = leaf[:-3]
        else:
            continue
        conv = f"{head}.{conv}" if head else conv
        w, b = state_dict.get(f"{conv}.weight"), state_dict.get(f"{conv}.bias")
        scale = state_dict.get(f"{bn}.scale")
        if w is None or b is None or scale is None or w.dim() < 2 \
                or w.dtype == torch.int8:
            continue
        cout = 1 if f"{conv}.weight" in transposed else 0
        if w.shape[cout] != scale.shape[0]:
            continue
        cpu = {k: state_dict[f"{bn}.{k}"].detach().cpu().double()
               for k in ("scale", "bias", "mean", "var")}
        g = cpu["scale"] / torch.sqrt(cpu["var"] + eps)
        shape = [1] * w.dim()
        shape[cout] = -1
        out[f"{conv}.weight"] = (w.detach().cpu().double() * g.view(shape)).to(
            w.dtype).to(w.device)
        out[f"{conv}.bias"] = ((b.detach().cpu().double() - cpu["mean"]) * g
                               + cpu["bias"]).to(b.dtype).to(b.device)
        for k, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                        ("var", 1.0 - eps)):
            t = state_dict[f"{bn}.{k}"]
            out[f"{bn}.{k}"] = torch.full_like(t, fill)
        n += 1
    return out, n


def quantize_for_inference(model: nn.Module,
                           calib_batches: Iterable[torch.Tensor] | None,
                           act_scales: dict[str, float] | None = None,
                           grid=None) -> tuple[nn.Module, dict[str, float]]:
    """One-call post-training quantization, in place: BatchNorm folded
    first (so calibration sees, and the int8 grid scales, the folded
    weights), then the activation scales (``act_scales`` as given, e.g. a
    QAT run's; else calibrated on ``calib_batches``, this rank's shares on
    a ``grid``; none, weight-only, without batches), then
    :func:`quantize_model`. Returns ``(model, scales)``."""
    from semanticsegmentation_tensorflow_tpu_torch.convert import (
        transposed_weights,
    )

    state, n = fold_batchnorm(model.state_dict(), transposed_weights(model))
    if n:
        model.load_state_dict(state)
    if act_scales is not None:
        scales = dict(act_scales)
    else:
        scales = (calibrate_act_scales(model, calib_batches, grid)
                  if calib_batches is not None else {})
    return quantize_model(model, scales), scales


def fake_quantize(model: nn.Module, act_scales: dict[str, float]) -> nn.Module:
    """Quantization-aware training (the JAX ``make_fake_quant_apply``):
    each conv of :func:`conv_paths` fake-quantizes its live weight and, at
    ``act_scales[path]`` where there is one, its input, with
    straight-through gradients (``Conv.qat``). In place; returns
    ``model``. Serving the same scales (:func:`quantize_for_inference` with
    ``act_scales``) computes the product this forward sees."""
    for path in conv_paths(model):
        m = getattr(*_submodule(model, path))
        m.qat, m.act_scale = True, act_scales.get(path)
    return model


QAT_SCALES = "qat_scales.json"


def save_act_scales(path: str, scales: dict[str, float]) -> None:
    """The scales as JSON beside a checkpoint (the JAX package's file)."""
    with open(path, "w") as f:
        json.dump(scales, f, indent=1, sort_keys=True)


def load_act_scales(path: str) -> dict[str, float]:
    with open(path) as f:
        return {str(k): float(v) for k, v in json.load(f).items()}


def checkpoint_act_scales(checkpoint_dir: str | None
                          ) -> tuple[str | None, dict[str, float] | None]:
    """The path of ``checkpoint_dir``'s :data:`QAT_SCALES` file (None
    without a directory) and the scales in it, None while it does not exist.
    A ``--qat`` run writes it; int8 serving, test and eval on the checkpoint
    take these scales before any calibration."""
    if checkpoint_dir is None:
        return None, None
    path = os.path.join(checkpoint_dir, QAT_SCALES)
    return path, load_act_scales(path) if os.path.exists(path) else None


def warn_qat_fp_eval(checkpoint_dir: str | None, int8: bool, *,
                     verb: str = "evaluating", file=None) -> bool:
    """Warn when a checkpoint trained with ``--qat`` (its
    ``qat_scales.json`` present) is about to run without ``--int8``: the
    float forward drops the activation clamps it was trained under, and the
    logits can grow far beyond the trained ones. Returns whether it
    warned."""
    if int8 or checkpoint_act_scales(checkpoint_dir)[1] is None:
        return False
    print(f"warning: checkpoint was trained with --qat "
          f"(qat_scales.json present); {verb} WITHOUT --int8 removes "
          f"the activation clamps the model was trained under and can "
          f"inflate the loss", file=file if file is not None else sys.stderr)
    return True


def calib_batches_from_files(paths: Sequence[str], image_size: tuple[int, int],
                             mean: Sequence[float], std: Sequence[float],
                             stride: int = 32, batch: int = 4,
                             device="cpu") -> list[torch.Tensor]:
    """Image files as normalized, stride-padded model input on ``device``,
    ``batch`` at a time: the Predictor's preprocessing, so the calibrated
    ranges are serving's."""
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
        normalize_images,
    )
    from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
    from semanticsegmentation_tensorflow_tpu_torch.ops.shape import pad_to_multiple

    out = []
    for i in range(0, len(paths), batch):
        imgs = np.stack([load_image(p, image_size) for p in paths[i:i + batch]])
        x = normalize_images(torch.from_numpy(imgs).to(device), mean, std)
        out.append(pad_to_multiple(x, stride))
    return out
