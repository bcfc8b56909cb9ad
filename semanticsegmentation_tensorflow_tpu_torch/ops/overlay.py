"""Argmax + colormap overlay, plain PyTorch, and its numpy host mirror.

Counterpart of ``semanticsegmentation_tensorflow_tpu/ops/overlay.py``. The
fused CUDA kernel that computes the same thing in one pass lives in
``ops/cuda/overlay.py``; :func:`argmax_colormap_overlay` here is its plain
version.
"""

from __future__ import annotations

import numpy as np
import torch


def labels_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """[..., C] logits -> [...] int64 class ids; ties go to the lowest class.
    For C == 2 this is ``l1 > l0`` (equal to argmax, ties -> class 0)."""
    if logits.shape[-1] == 2:
        return (logits[..., 1] > logits[..., 0]).long()
    return torch.argmax(logits, dim=-1)


def palette_tensor(palette, device) -> torch.Tensor:
    """[C, 3] palette (array or tensor) as an f32 tensor on ``device``."""
    if not torch.is_tensor(palette):
        palette = torch.as_tensor(np.asarray(palette))
    return palette.to(device, torch.float32)


def argmax_colormap_overlay(image_u8: torch.Tensor, logits: torch.Tensor,
                            palette, alpha: float = 0.5,
                            blend_class0: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blend a class colormap over an image.

    image_u8 [..., H, W, 3] uint8, logits [..., H, W, C], palette [C, 3]
    (uint8, array or tensor). Class-0 pixels keep the image unless
    ``blend_class0``. Returns (overlay u8 [..., H, W, 3], labels i32 [..., H, W]).
    """
    labels = labels_from_logits(logits)
    colors = palette_tensor(palette, image_u8.device)[labels]
    img = image_u8.float()
    blended = img * (1.0 - alpha) + colors * alpha
    if not blend_class0:
        blended = torch.where((labels == 0)[..., None], img, blended)
    return blended.clamp(0, 255).to(torch.uint8), labels.to(torch.int32)


def host_overlay(image_u8: np.ndarray, labels_u8: np.ndarray, palette,
                 alpha: float = 0.5, blend_class0: bool = False) -> np.ndarray:
    """Numpy mirror of the blend in :func:`argmax_colormap_overlay`, for the
    serving path, which fetches only the label map and composites on the
    host from the image it already decoded. Same f32 arithmetic."""
    img = image_u8.astype(np.float32)
    colors = np.asarray(palette).astype(np.float32)[labels_u8]
    blended = img * np.float32(1.0 - alpha) + colors * np.float32(alpha)
    if not blend_class0:
        blended = np.where((labels_u8 == 0)[..., None], img, blended)
    return np.clip(blended, 0, 255).astype(np.uint8)
