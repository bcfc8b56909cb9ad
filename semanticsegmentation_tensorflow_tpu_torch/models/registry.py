"""Name -> model constructor registry (counterpart of the JAX package's
``models/registry.py``): the FCN family, SegNet, DeepLab-ASPP and U-Net;
and the port's own DeepLab-v2 ASPP-L (``deeplab_v2``). Every conv of that
one runs as its ``Conv`` module, so it needs no SPMD- or quant-safe kwargs;
under a grid that splits rows it raises."""

from __future__ import annotations

from typing import Any, Callable

import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.models.deeplab import DeepLabASPP
from semanticsegmentation_tensorflow_tpu_torch.models.deeplab_v2 import DeepLabV2
from semanticsegmentation_tensorflow_tpu_torch.models.fcn8s import FCN8s
from semanticsegmentation_tensorflow_tpu_torch.models.segnet import SegNet
from semanticsegmentation_tensorflow_tpu_torch.models.unet import UNet
from semanticsegmentation_tensorflow_tpu_torch.ops.shape import round_up

MODELS: dict[str, Callable[..., nn.Module]] = {
    "fcn8s": FCN8s,
    "fcn16s": lambda **kw: FCN8s(variant=16, **kw),
    "fcn32s": lambda **kw: FCN8s(variant=32, **kw),
    "segnet": SegNet,
    "deeplab": DeepLabASPP,
    "unet": UNet,
    "deeplab_v2": DeepLabV2,
}

# The JAX package's flags that name no choice in the port: ``pallas_spmd``
# (stage1 takes its halo mode from the active grid) and TPU lane layouts of
# the same function with the same parameters. Accepted so that the JAX
# package's presets, ``--model-kw`` and the tables below build a model.
TPU_ONLY_KWARGS = frozenset({
    "pallas_spmd", "packed_stage2_entry", "fast_upsample", "packed_dec1",
    "packed_dec2", "fast_upconv", "packed_stage0",
})


def build_model(name: str, num_classes: int, *, device,
                **kwargs: Any) -> nn.Module:
    """Build a model with uninitialized params on ``device`` (load a state
    dict or call ``models.common.init_params`` next). The names in
    :data:`TPU_ONLY_KWARGS` are dropped (``packed_stage0`` must still be
    True, False or ``"mixed"``, as the JAX package checks), and the JAX
    flag ``pallas_pool=False``, which turns the fused stage1 kernel off,
    becomes ``packed_stage1=False``; any other ``pallas_pool`` is dropped."""
    try:
        cls = MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    if kwargs.get("packed_stage0", True) not in (True, False, "mixed"):
        raise ValueError(f"packed_stage0 must be True, False or 'mixed', "
                         f"got {kwargs['packed_stage0']!r}")
    if kwargs.pop("pallas_pool", None) is False:
        kwargs["packed_stage1"] = False
    kwargs = {k: v for k, v in kwargs.items() if k not in TPU_ONLY_KWARGS}
    return cls(num_classes=num_classes, device=device, **kwargs)


def spmd_safe_kwargs(name: str) -> dict[str, Any]:
    """Model kwargs required under a height-partitioned (spatial) grid (the
    JAX package's table, ``models/registry.py:43-61``): no Winograd forms
    (they exchange no halo rows), and ``pallas_spmd=True``, which
    :func:`build_model` drops: the port's stage1 takes its halo mode
    (kernel 1c) from the grid. Every entry point that builds a model for
    a spatial grid merges these in (setdefault, so explicit user choices
    still win)."""
    if name in ("fcn8s", "fcn16s", "fcn32s", "segnet", "deeplab"):
        return {"winograd": None, "pallas_spmd": True}
    if name == "unet":
        return {"winograd": None}
    return {}


def _merge_safe(table: dict[str, Any], kwargs: dict[str, Any],
                 conflict: str) -> dict[str, Any]:
    """``table`` into ``kwargs`` with setdefault semantics (the user's
    explicit value wins), warning with ``conflict`` (formatted with ``k``,
    ``mine`` and ``safe``) on each flag whose explicit value differs."""
    import warnings

    for k, v in table.items():
        if k in kwargs and kwargs[k] != v:
            warnings.warn(conflict.format(k=k, mine=kwargs[k], safe=v),
                          stacklevel=3)
        kwargs.setdefault(k, v)
    return kwargs


def merge_spmd_safe_kwargs(name: str, kwargs: dict[str, Any]) -> dict[str, Any]:
    """Merge :func:`spmd_safe_kwargs` into user kwargs for a spatial grid,
    warning on any conflict instead of silently dropping or silently keeping
    the user's choice. The user's explicit value still wins (setdefault
    semantics), so the failure, if any, is the raise of a layer that cannot
    run on split rows, preceded by a warning that names the flag."""
    return _merge_safe(
        spmd_safe_kwargs(name), kwargs,
        "model kwarg {k}={mine!r} has no halo exchange under a "
        "spatially-partitioned (2-D) grid; the SPMD-safe value is "
        "{k}={safe!r}. Keeping your explicit choice; expect an error "
        "if this path is exercised.")


def quant_safe_kwargs(name: str) -> dict[str, Any]:
    """Model kwargs under which every conv runs as its ``Conv`` /
    ``ConvTranspose`` module, where int8 serving and quantization-aware
    training find it (``infer/quant.py``); the JAX package's table
    (``models/registry.py:79-102``). In the port they turn off the fused
    stage1 kernels (``packed_stage1``; kernels 1, 1b and 3), the Winograd
    forms (``winograd``, ``winograd_fc6``), the deferred pool bias and the
    ASPP's split projection, each of which reads its conv's weight outside
    the module. The :data:`TPU_ONLY_KWARGS` in it stay so that a conflict is
    named as the JAX package names it. The parameters, and so the
    checkpoints, are the same either way."""
    if name in ("fcn8s", "fcn16s", "fcn32s"):
        return {"packed_stage1": False, "packed_stage2_entry": False,
                "deferred_pool_bias": False, "fast_upsample": False,
                "winograd": None, "winograd_fc6": False}
    if name == "segnet":
        return {"packed_stage1": False, "packed_dec1": False,
                "packed_dec2": False, "winograd": None}
    if name == "unet":
        return {"packed_stage0": False, "fast_upconv": False,
                "winograd": None}
    if name == "deeplab":
        return {"packed_stage1": False, "deferred_pool_bias": False,
                "aspp_split_proj": False, "winograd": None}
    return {}


def merge_quant_safe_kwargs(name: str, kwargs: dict[str, Any]) -> dict[str, Any]:
    """Merge :func:`quant_safe_kwargs` into user kwargs for an int8 or QAT
    path (as :func:`merge_spmd_safe_kwargs`: warn on a conflict, the user's
    explicit value wins)."""
    return _merge_safe(
        quant_safe_kwargs(name), kwargs,
        "model kwarg {k}={mine!r} keeps a packed/fused path the int8/QAT "
        "module swap cannot see; quantization will skip those convs. The "
        "quant-safe value is {k}={safe!r}. Keeping your explicit choice.")


def padded_input_hw(model: nn.Module,
                    image_size: tuple[int, int]) -> tuple[int, int]:
    """(H, W) of ``image_size`` ceil-padded to the model's total stride."""
    stride = getattr(model, "total_stride", 32)
    return round_up(image_size[0], stride), round_up(image_size[1], stride)
