"""Static-shape utilities (counterpart of the JAX package's ``ops/shape.py``).

Inputs are padded at the bottom/right up to the model's total stride with
edge replication (375x1242 -> 384x1248 for stride 32), and logits cropped
back. Tensors are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_to_multiple(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Edge-pad NHWC spatial dims up to a multiple (bottom/right only).
    Returns a contiguous NHWC tensor."""
    n, h, w, c = x.shape
    ph, pw = round_up(h, multiple) - h, round_up(w, multiple) - w
    if ph == 0 and pw == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
    return y.permute(0, 2, 3, 1).contiguous()


def crop_to(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Crop NHWC spatial dims back to (height, width) from the top-left."""
    return x[:, :height, :width, :]
