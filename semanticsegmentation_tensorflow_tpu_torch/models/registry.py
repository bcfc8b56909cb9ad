"""Name -> model constructor registry (counterpart of the JAX package's
``models/registry.py``). Only the FCN family is ported so far."""

from __future__ import annotations

from typing import Any, Callable

import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.models.fcn8s import FCN8s
from semanticsegmentation_tensorflow_tpu_torch.ops.shape import round_up

MODELS: dict[str, Callable[..., nn.Module]] = {
    "fcn8s": FCN8s,
    "fcn16s": lambda **kw: FCN8s(variant=16, **kw),
    "fcn32s": lambda **kw: FCN8s(variant=32, **kw),
}
_NOT_YET = ("unet", "segnet", "deeplab")


def build_model(name: str, num_classes: int, *, device,
                **kwargs: Any) -> nn.Module:
    """Build a model with uninitialized params on ``device`` (load a state
    dict or call ``models.common.init_params`` next)."""
    if name in _NOT_YET:
        raise NotImplementedError(f"model {name!r} is not yet ported; "
                                  f"available: {sorted(MODELS)}")
    try:
        cls = MODELS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    return cls(num_classes=num_classes, device=device, **kwargs)


def padded_input_hw(model: nn.Module,
                    image_size: tuple[int, int]) -> tuple[int, int]:
    """(H, W) of ``image_size`` ceil-padded to the model's total stride."""
    stride = getattr(model, "total_stride", 32)
    return round_up(image_size[0], stride), round_up(image_size[1], stride)
