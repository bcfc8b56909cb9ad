"""Max pooling (counterpart of the JAX package's ``ops/pool.py:max_pool``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """NHWC window x window max pool, stride = window, with the JAX
    package's SAME padding: a ragged edge is pooled over the pixels it has
    (``ceil_mode``), never over padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, ceil_mode=True)
    return y.permute(0, 2, 3, 1)
