"""Input normalization (counterpart of the JAX package's
``data/augment.py:normalize_images``). Flip, crop and jitter belong to the
training path and are not ported yet."""

from __future__ import annotations

from typing import Sequence

import torch


def normalize_images(images: torch.Tensor,
                     mean: Sequence[float] | torch.Tensor,
                     std: Sequence[float] | torch.Tensor) -> torch.Tensor:
    """uint8/float [..., 3] -> float32 per-channel (x - mean) / std.
    Divides by std, as the JAX package does (not a reciprocal multiply).
    ``mean``/``std`` already on the device cost no host->device copy."""
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) - mean_t) / std_t
