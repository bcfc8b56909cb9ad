"""Max pooling (counterpart of the JAX package's ``ops/pool.py``): the plain
max pool, and SegNet's max pool with its within-window argmax and the
unpool that routes by it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
    MaxPoolArgmax, MaxUnpool,
)


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """NHWC window x window max pool, stride = window, with the JAX
    package's SAME padding: a ragged edge is pooled over the pixels it has
    (``ceil_mode``), never over padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def _check_window(window: int) -> None:
    if window != 2:
        raise NotImplementedError(f"the argmax pool is ported for 2x2 windows "
                                  f"(SegNet's), got {window}")


def max_pool_with_argmax(x: torch.Tensor, window: int = 2
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-overlapping 2x2 max pool of NHWC ``x`` (H and W even) returning
    (pooled, idx): idx is the u8 within-window position ``2*dy + dx`` of the
    first maximum in row-major order (the JAX package returns it as int8).
    The gradient goes to the recorded position only, ties unsplit (TF's
    MaxPoolGradWithArgmax). CUDA tensors run the kernels of
    ``ops/cuda/pool.py``, CPU tensors their plain versions."""
    _check_window(window)
    return MaxPoolArgmax.apply(x)


def max_unpool(pooled: torch.Tensor, idx: torch.Tensor,
               window: int = 2) -> torch.Tensor:
    """Inverse of :func:`max_pool_with_argmax`: each pooled value at its
    recorded window position, zeros elsewhere; [N,Hp,Wp,C] -> [N,2Hp,2Wp,C].
    The gradient is the output's gradient at the index; ``idx`` takes
    none."""
    _check_window(window)
    return MaxUnpool.apply(pooled, idx)
