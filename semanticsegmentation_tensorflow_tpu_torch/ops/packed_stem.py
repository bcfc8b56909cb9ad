"""VGG stage blocks with the pool inside (counterpart of the JAX package's
``ops/packed_stem.py``).

On the TPU, stage1 packed width pairs into the 128-lane channel dim. That is
a lane trick of the TPU and is not carried over: on the H100, :class:`Stage1`
runs conv1_1 with cuDNN, adds b1, and hands the NHWC result to the fused
stage1-tail kernel (``ops/cuda/stage1.py``). Parameter names and shapes are
the JAX package's (``stage1/conv0``, ``stage1/conv1``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    ConvBlock, conv3x3_bias_relu,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import stage1_tail
from semanticsegmentation_tensorflow_tpu_torch.ops.pool import max_pool


class PooledConvBlock(ConvBlock):
    """ConvBlock + 2x2/2 max pool with the last bias+relu AFTER the pool.

    Exact: ``relu(pool(z) + b) == pool(relu(z + b))`` bit for bit (the max
    commutes with the per-channel bias add, with its monotone rounding and
    with the relu), while the bias add and relu run at 1/4 resolution.
    Same parameters as ``ConvBlock(features, n_convs)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *head, last = self.convs()
        for conv in head:
            x = conv3x3_bias_relu(x, conv.weight, conv.bias, dtype=conv.dtype,
                                  dilation=conv.dilation)
        z = last.conv(x)
        return torch.relu(max_pool(z, 2) + last.bias.to(last.dtype))


class Stage1(ConvBlock):
    """VGG stage1: conv3x3 -> relu -> conv3x3 -> relu -> maxpool 2x2.

    conv1_1 (``conv0``) runs as a plain conv plus b1 in the compute dtype;
    the rest (relu, conv1_2, pool, +b2, relu) is one call of the fused
    stage1 tail: the CUDA kernel for CUDA tensors, its plain version on the
    CPU. Drop-in for ``ConvBlock(features, 2)`` + ``max_pool``, same params.
    Needs even H and W."""

    def __init__(self, in_features: int, features: int = 64, *,
                 dtype: torch.dtype = DEFAULT_DTYPE, device=None):
        super().__init__(in_features, features, 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"stage1 needs even H, W; got {tuple(x.shape[1:3])}")
        # NHWC-contiguous for the kernel (a no-op for channels_last output)
        z1 = self.conv0(x).contiguous()
        return stage1_tail(z1, self.conv1.weight, self.conv1.bias)
