"""VGG stage blocks with the pool inside (counterpart of the JAX package's
``ops/packed_stem.py``).

On the TPU, stage1 packed width pairs into the 128-lane channel dim. That is
a lane trick of the TPU and is not carried over: on the H100, :class:`Stage1`
runs conv1_1 with cuDNN, adds b1, and hands the NHWC result to the fused
stage1-tail kernels (``ops/cuda/stage1.py``): the inference kernel, or, when
autograd records, the training forward and its backward (``Stage1Tail``).
:class:`SegNetStage1` does the same for SegNet's encoder stage1, whose tail
returns the argmax pool's index. Parameter names and shapes are the JAX
package's (``stage1/conv0``, ``stage1/conv1``; ``enc1/...`` for SegNet).

``pallas_spmd=True`` (the JAX flag's name) selects the halo mode of the tail
(kernel 1c): conv1_1 runs without its bias, its rows go to
:class:`Stage1TailHalo` (or its inference wrapper), which folds b1 in and
exchanges the boundary rows with the neighbouring ranks of an active spatial
grid (``parallel/``); with no such grid the halo rows are the image's edge,
so one process runs 1c over the whole image.
"""

from __future__ import annotations

import torch

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    ConvBlock, conv3x3_bias_relu, conv3x3_raw,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    SegNetStage1Tail, SegNetStage1TailHalo, Stage1Tail, Stage1TailHalo,
    stage1_tail, stage1_tail_halo, stage1_tail_segnet,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.pool import max_pool
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import boundary_rows
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import spatial_grid


def _halo_tail(conv0, conv1, x, function, mode):
    """conv1_1 without its bias, then the halo-mode tail (kernel 1c): the
    autograd ``function`` when autograd records, else the inference
    wrapper. The tail folds b1 in and exchanges its own halo rows."""
    z1 = conv0.conv(x).contiguous()
    k2, b2, b1 = conv1.weight, conv1.bias, conv0.bias
    grid = spatial_grid()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (z1, k2, b2, b1)):
        return function.apply(z1, k2, b2, b1, grid)
    [(top, bot)] = boundary_rows([z1], [float("-inf")], grid)
    return stage1_tail_halo(z1, top, bot, k2, b2, b1, mode)


class PooledConvBlock(ConvBlock):
    """ConvBlock + 2x2/2 max pool with the last bias+relu AFTER the pool.

    Exact: ``relu(pool(z) + b) == pool(relu(z + b))`` bit for bit (the max
    commutes with the per-channel bias add, with its monotone rounding and
    with the relu), while the bias add and relu run at 1/4 resolution.
    Same parameters as ``ConvBlock(features, n_convs)``. With ``winograd``
    (the JAX package's ``PooledConvBlock``, ``ops/packed_stem.py:190-256``)
    the inner convs take the fused bias+relu form and the last conv the raw
    one, so its bias and relu stay deferred past the pool."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *head, last = self.convs()
        for conv in head:
            x = conv3x3_bias_relu(x, conv.weight, conv.bias, dtype=conv.dtype,
                                  dilation=conv.dilation,
                                  winograd=self.winograd)
        z = conv3x3_raw(x, last, self.winograd)
        return torch.relu(max_pool(z, 2) + last.bias.to(last.dtype))


class Stage1(PooledConvBlock):
    """VGG stage1: conv3x3 -> relu -> conv3x3 -> relu -> maxpool 2x2.

    conv1_1 (``conv0``) runs as a plain conv plus b1 in the compute dtype;
    the rest (relu, conv1_2, pool, +b2, relu) is one call of the fused
    stage1 tail: the CUDA kernels for CUDA tensors, their plain versions on
    the CPU. When autograd records, the tail is :class:`Stage1Tail` (the
    training forward, which also writes the pool's routing codes, and the
    backward kernel); b1 stays in conv1_1, so autograd gives db1 = sum(dz1).
    An odd H or W runs the same params as the plain :class:`PooledConvBlock`
    (with ``winograd``), as the JAX package's VGG16 does
    (``models/vgg16.py:97-118``). ``pallas_spmd``: the halo mode (module
    docstring)."""

    def __init__(self, in_features: int, features: int = 64, *,
                 winograd: str | None = None, pallas_spmd: bool = False,
                 dtype: torch.dtype = DEFAULT_DTYPE, device=None):
        super().__init__(in_features, features, 2, winograd=winograd,
                         dtype=dtype, device=device)
        self.pallas_spmd = pallas_spmd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 2 or x.shape[2] % 2:
            return super().forward(x)
        if self.pallas_spmd:
            return _halo_tail(self.conv0, self.conv1, x, Stage1TailHalo, "infer")
        # NHWC-contiguous for the kernel (a no-op for channels_last output)
        z1 = self.conv0(x).contiguous()
        k2, b2 = self.conv1.weight, self.conv1.bias
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (z1, k2, b2)):
            return Stage1Tail.apply(z1, k2, b2)
        return stage1_tail(z1, k2, b2)


class SegNetStage1(ConvBlock):
    """SegNet encoder stage1: conv3x3 -> relu -> conv3x3 -> +b2 -> relu ->
    2x2 argmax pool, returning (pooled, u8 idx) (counterpart of the JAX
    package's ``PackedSegNetStage1``, ``ops/packed_stem.py:327-386``).

    conv1_1 (``conv0``) runs as a plain conv plus b1 in the compute dtype;
    the rest is one call of the SegNet stage1 tail
    (``ops/cuda/stage1.py:stage1_tail_segnet``), or :class:`SegNetStage1Tail`
    when autograd records. Same parameters as ``ConvBlock(features, 2)``;
    an odd H or W raises, as the JAX module does. ``pallas_spmd``: the halo
    mode (module docstring)."""

    def __init__(self, in_features: int, features: int = 64, *,
                 pallas_spmd: bool = False,
                 dtype: torch.dtype = DEFAULT_DTYPE, device=None):
        super().__init__(in_features, features, 2, dtype=dtype, device=device)
        self.pallas_spmd = pallas_spmd

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"SegNet stage1 needs even H, W; got "
                             f"{tuple(x.shape[1:3])}")
        if self.pallas_spmd:
            return _halo_tail(self.conv0, self.conv1, x, SegNetStage1TailHalo,
                              "segnet")
        z1 = self.conv0(x).contiguous()
        k2, b2 = self.conv1.weight, self.conv1.bias
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (z1, k2, b2)):
            return SegNetStage1Tail.apply(z1, k2, b2)
        return stage1_tail_segnet(z1, k2, b2)
