"""Transposed convs of the FCN and U-Net decoders (counterpart of the JAX
package's ``ops/fast_upsample.py`` and of flax ``nn.ConvTranspose``).

flax ``ConvTranspose(F, (k, k), strides=(s, s), padding="SAME")`` does not
flip its kernel (``transpose_kernel=False``). For FCN's 2s-wide kernel its
SAME padding is (3s-2)/2 on each side of the dilated input: that is
``F.conv_transpose2d(x, w, stride=s, padding=s//2)``. For U-Net's kernel
equal to the stride (2x2/2) the padding is (s-1, s-1) and output row s*i + a
reads input row i alone, through tap s-1-a: ``F.conv_transpose2d(x, w,
stride=s)``. In both, ``w`` is the flax kernel flipped in space and permuted
to [Cin, Cout, kh, kw]; ``convert.py`` does that permutation when weights
cross between the two packages. The TPU's pixel-shuffle and 1x1 +
depth-to-space decompositions (``FastConvTranspose``,
``fast_conv_transpose_2x2``) compute the same function as lane tricks and
are not carried over.

Under an active grid that splits rows (``parallel.mesh.spatial_grid``), the
2s-wide kernel takes one halo row from each neighbour, runs the transposed
conv on the extended rows and keeps its own output rows: an output row
reads input rows within one row of its own, so the result is the whole
image's. The s-wide kernel needs no halo: each rank's output rows read its
own input rows only.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.ops.conv import _TRUNC_STD, fill_init
from semanticsegmentation_tensorflow_tpu_torch.ops.quant import (
    fake_quant_act, fake_quant_weight,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import exchange_rows
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import spatial_grid


class ConvTranspose(nn.Module):
    """Stride-s transposed conv with a 2s x 2s kernel (FCN's decoder) or,
    with ``kernel_size=s``, an s x s kernel (U-Net's 2x2/2 up-convs), SAME
    placement, NHWC.

    ``weight`` is [in_features, features, k, k] (PyTorch's layout, already
    flipped relative to flax's kernel); ``bias`` [features]. Init:
    normal(0, init_std) kernels (the FCN decoder's), or with ``init_std``
    None flax's lecun_normal over the fan-in k * k * in_features (flax
    ``nn.ConvTranspose``'s default); zero biases. ``qat`` and
    ``act_scale``: quantization-aware training, as ``models.common.Conv``
    has them (the weight's grid per output channel, dim 1)."""

    def __init__(self, in_features: int, features: int, stride: int, *,
                 kernel_size: int | None = None,
                 dtype: torch.dtype = DEFAULT_DTYPE, init_std: float | None = 0.01,
                 device=None):
        super().__init__()
        k = 2 * stride if kernel_size is None else kernel_size
        if k not in (stride, 2 * stride):
            raise ValueError(f"kernel {k} at stride {stride}: only the stride or "
                             "twice it is ported")
        if k == 2 * stride and stride % 2:
            raise ValueError(f"SAME placement needs an even stride, got {stride}")
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.stride = stride
        self.kernel_size = k
        self.dtype = dtype
        self.init_std = init_std
        self.qat = False
        self.act_scale: float | None = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init_std is None:
            fan_in = self.weight.shape[0] * self.kernel_size ** 2
            fill_init(self.weight, generator,
                      math.sqrt(1.0 / fan_in) / _TRUNC_STD, truncated=True)
        else:
            fill_init(self.weight, generator, self.init_std, truncated=False)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qat:
            y = self.transpose(fake_quant_act(x, self.act_scale),
                               fake_quant_weight(self.weight, transposed=True))
            return (y.float() + self.bias.float()).to(self.dtype)
        return self.transpose(x, self.weight) + self.bias.to(self.dtype)

    def transpose(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The transposed conv of NHWC ``x`` by ``w`` without the bias, both
        in the compute dtype; NHWC out."""
        s = self.stride
        x = x.to(self.dtype)
        w = w.to(self.dtype)
        grid = spatial_grid()
        if self.kernel_size == s:          # no tap overlap: rows stay local
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=s)
        elif grid is None:
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=s,
                                   padding=s // 2)
        else:
            h = x.shape[1]
            xe = exchange_rows(x, 1, 1, grid)          # input rows -1..H
            y = F.conv_transpose2d(xe.permute(0, 3, 1, 2), w, stride=s,
                                   padding=(0, s // 2))
            # extended output row o' is the image's row o' - s - s/2
            y = y[:, :, s + s // 2:s + s // 2 + h * s]
        return y.permute(0, 2, 3, 1)
