"""Name -> model constructor registry (counterpart of the JAX package's
``models/registry.py``): the FCN family, SegNet, DeepLab-ASPP and U-Net."""

from __future__ import annotations

from typing import Any, Callable

import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.models.deeplab import DeepLabASPP
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
}


def build_model(name: str, num_classes: int, *, device,
                **kwargs: Any) -> nn.Module:
    """Build a model with uninitialized params on ``device`` (load a state
    dict or call ``models.common.init_params`` next)."""
    try:
        cls = MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return cls(num_classes=num_classes, device=device, **kwargs)


def spmd_safe_kwargs(name: str) -> dict[str, Any]:
    """Model kwargs required under a height-partitioned (spatial) grid (the
    JAX package's table, ``models/registry.py:43-61``): the fused stage1 in
    its halo mode (``pallas_spmd=True``, kernel 1c) and no Winograd forms
    (they exchange no halo rows). Every entry point that builds a model for
    a spatial grid merges these in (setdefault, so explicit user choices
    still win)."""
    if name in ("fcn8s", "fcn16s", "fcn32s", "segnet", "deeplab"):
        return {"winograd": None, "pallas_spmd": True}
    if name == "unet":
        return {"winograd": None}
    return {}


def merge_spmd_safe_kwargs(name: str, kwargs: dict[str, Any]) -> dict[str, Any]:
    """Merge :func:`spmd_safe_kwargs` into user kwargs for a spatial grid,
    warning on any conflict instead of silently dropping or silently keeping
    the user's choice. The user's explicit value still wins (setdefault
    semantics), so the failure, if any, is the raise of a layer that cannot
    run on split rows, preceded by a warning that names the flag."""
    import warnings

    for k, v in spmd_safe_kwargs(name).items():
        if k in kwargs and kwargs[k] != v:
            warnings.warn(
                f"model kwarg {k}={kwargs[k]!r} has no halo exchange under a "
                f"spatially-partitioned (2-D) grid; the SPMD-safe value is "
                f"{k}={v!r}. Keeping your explicit choice; expect an error "
                f"if this path is exercised.",
                stacklevel=2)
        kwargs.setdefault(k, v)
    return kwargs


def padded_input_hw(model: nn.Module,
                    image_size: tuple[int, int]) -> tuple[int, int]:
    """(H, W) of ``image_size`` ceil-padded to the model's total stride."""
    stride = getattr(model, "total_stride", 32)
    return round_up(image_size[0], stride), round_up(image_size[1], stride)
