"""Transposed conv for the FCN decoder (counterpart of the JAX package's
``ops/fast_upsample.py`` and of flax ``nn.ConvTranspose``).

flax ``ConvTranspose(F, (2s, 2s), strides=(s, s), padding="SAME")`` does not
flip its kernel (``transpose_kernel=False``), and its SAME padding for a
2s-wide kernel is (3s-2)/2 on each side of the dilated input. That is
``F.conv_transpose2d(x, w, stride=s, padding=s//2)`` with ``w`` the flax
kernel flipped in space and permuted to [Cin, Cout, kh, kw]; ``convert.py``
does that permutation when weights cross between the two packages. The
TPU's pixel-shuffle decomposition is a lane trick and is not carried over.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import fill_init


class ConvTranspose(nn.Module):
    """Stride-s transposed conv with a 2s x 2s kernel, SAME placement, NHWC.

    ``weight`` is [in_features, features, 2s, 2s] (PyTorch's layout, already
    flipped relative to flax's kernel); ``bias`` [features]. Init is
    normal(0, init_std) kernels and zero biases (the FCN decoder's)."""

    def __init__(self, in_features: int, features: int, stride: int, *,
                 dtype: torch.dtype = DEFAULT_DTYPE, init_std: float = 0.01,
                 device=None):
        super().__init__()
        if stride % 2:
            raise ValueError(f"SAME placement needs an even stride, got {stride}")
        k = 2 * stride
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.stride = stride
        self.dtype = dtype
        self.init_std = init_std

    def reset_parameters(self, generator: torch.Generator) -> None:
        fill_init(self.weight, generator, self.init_std, truncated=False)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        y = F.conv_transpose2d(x.to(self.dtype).permute(0, 3, 1, 2),
                               self.weight.to(self.dtype), stride=s,
                               padding=s // 2)
        return y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)
