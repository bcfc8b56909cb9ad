"""Transposed conv for the FCN decoder (counterpart of the JAX package's
``ops/fast_upsample.py`` and of flax ``nn.ConvTranspose``).

flax ``ConvTranspose(F, (2s, 2s), strides=(s, s), padding="SAME")`` does not
flip its kernel (``transpose_kernel=False``), and its SAME padding for a
2s-wide kernel is (3s-2)/2 on each side of the dilated input. That is
``F.conv_transpose2d(x, w, stride=s, padding=s//2)`` with ``w`` the flax
kernel flipped in space and permuted to [Cin, Cout, kh, kw]; ``convert.py``
does that permutation when weights cross between the two packages. The
TPU's pixel-shuffle decomposition is a lane trick and is not carried over.

Under an active grid that splits rows (``parallel.mesh.spatial_grid``), each
rank takes one halo row from each neighbour, runs the transposed conv on the
extended rows and keeps its own output rows: an output row reads input rows
within one row of its own, so the result is the whole image's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import fill_init
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import exchange_rows
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import spatial_grid


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
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        grid = spatial_grid()
        if grid is None:
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=s,
                                   padding=s // 2)
        else:
            h = x.shape[1]
            xe = exchange_rows(x, 1, 1, grid)          # input rows -1..H
            y = F.conv_transpose2d(xe.permute(0, 3, 1, 2), w, stride=s,
                                   padding=(0, s // 2))
            # extended output row o' is the image's row o' - s - s/2
            y = y[:, :, s + s // 2:s + s // 2 + h * s]
        return y.permute(0, 2, 3, 1) + self.bias.to(self.dtype)
