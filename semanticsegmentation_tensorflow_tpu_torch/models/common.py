"""Shared building blocks + the dtype policy (counterpart of the JAX
package's ``models/common.py``).

Policy: params in float32; conv inputs and kernels cast to the compute dtype
(bf16 by default) with f32 accumulation; the bias is added in the compute
dtype AFTER the conv, as flax's ``nn.Conv(dtype=bf16)`` does. Activations
are NHWC at every module boundary; the convs run on NCHW views of them,
which for contiguous NHWC tensors are ``torch.channels_last`` memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE

# flax lecun_normal: truncated normal on [-2, 2] std units, rescaled by this
# constant so the truncated distribution has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def fill_init(t: torch.Tensor, generator: torch.Generator, std: float,
              truncated: bool) -> None:
    """Fill ``t`` from ``generator``; values are drawn on the generator's
    device and copied when the parameter lives elsewhere."""
    dst = t if t.device == generator.device else torch.empty(
        t.shape, device=generator.device)
    with torch.no_grad():
        if truncated:
            nn.init.trunc_normal_(dst, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        else:
            dst.normal_(0.0, std, generator=generator)
        if dst is not t:
            t.copy_(dst)


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, *, dtype: torch.dtype,
              padding: int, dilation: int = 1) -> torch.Tensor:
    """Stride-1 conv of NHWC ``x`` with OIHW ``kernel``, both cast to
    ``dtype``; accumulates in f32 and returns NHWC in ``dtype``."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), kernel.to(dtype),
                 padding=padding, dilation=dilation)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME", dtype=...)``, NHWC.

    ``weight`` is OIHW [features, in_features, k, k]; ``bias`` [features].
    ``init_std``: None gives flax's lecun_normal kernel init, a number a
    normal(0, init_std) init (the FCN score convs). Biases start at zero.
    Parameters are created uninitialized: call :func:`init_params`.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 *, dilation: int = 1, dtype: torch.dtype = DEFAULT_DTYPE,
                 init_std: float | None = None, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            features, in_features, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.dilation = dilation
        self.padding = dilation * (kernel_size - 1) // 2
        self.dtype = dtype
        self.init_std = init_std

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init_std is None:
            fan_in = self.weight[0].numel()
            fill_init(self.weight, generator,
                      math.sqrt(1.0 / fan_in) / _TRUNC_STD, truncated=True)
        else:
            fill_init(self.weight, generator, self.init_std, truncated=False)
        with torch.no_grad():
            self.bias.zero_()

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The conv alone (no bias), in the compute dtype. NHWC in/out."""
        return conv_nhwc(x, self.weight, dtype=self.dtype,
                         padding=self.padding, dilation=self.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.bias.to(self.dtype)


class ConvBlock(nn.Module):
    """n x (3x3 conv -> ReLU), params ``conv0``..``conv{n-1}``. Direct conv
    only: BatchNorm and Winograd are not ported."""

    def __init__(self, in_features: int, features: int, n_convs: int = 2, *,
                 dilation: int = 1, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"conv{i}", Conv(
                in_features if i == 0 else features, features, 3,
                dilation=dilation, dtype=dtype, device=device))

    def convs(self) -> list[Conv]:
        return [getattr(self, f"conv{i}") for i in range(self.n_convs)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs():
            x = conv3x3_bias_relu(x, conv.weight, conv.bias, dtype=conv.dtype,
                                  dilation=conv.dilation)
        return x


def conv3x3_bias_relu(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor, *, dtype: torch.dtype,
                      dilation: int = 1) -> torch.Tensor:
    """relu(SAME-conv3x3(x, kernel) + bias), the VGG workhorse layer.
    Direct conv only (Winograd is not ported); ``kernel`` is OIHW."""
    z = conv_nhwc(x, kernel, dtype=dtype, padding=dilation, dilation=dilation)
    return torch.relu(z + bias.to(dtype))


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init mirroring flax's distributions, in module order, from an
    explicit generator. Returns ``module``."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
