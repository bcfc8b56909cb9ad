"""U-Net: a symmetric encoder-decoder with channel-concat skips (counterpart
of the JAX package's ``models/unet.py``).

``depth`` down stages (two 3x3 conv + relu, then a 2x2/2 max pool), a
bottleneck ``ConvBlock``, ``depth`` up stages (a 2x2/2 transposed conv, the
concat ``[skip, up]`` along channels, two 3x3 convs) and a 1x1 ``head``;
widths ``base_features * 2**i``. NHWC in, float32 NHWC logits out. Parameter
names are the JAX package's (``down{i}/conv{j}``, ``bottleneck/conv{j}``,
``up{i}``, ``upconv{i}/conv{j}``, ``head``), so ``convert.py`` maps the flax
tree strictly.

``winograd`` routes each eligible 3x3 conv (both widths multiples of
128) through kernel 6. On a grid that splits rows the convs take their halo
through ``conv_nhwc``; the pools and the up-convs stay within a rank's rows.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    Conv, ConvBlock, region,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import ConvTranspose
from semanticsegmentation_tensorflow_tpu_torch.ops.pool import max_pool

class UNet(nn.Module):
    """U-Net of ``depth`` stages from ``base_features`` channels (module
    docstring); total stride ``2 ** depth``. ``use_bn`` puts a
    ``BatchNorm`` after every conv of every ``ConvBlock`` (``bn{j}`` beside
    ``conv{j}``); the up-convs and the head have none."""

    def __init__(self, num_classes: int = 2, base_features: int = 64,
                 depth: int = 4, *, use_bn: bool = False,
                 winograd: str | None = None, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None):
        super().__init__()
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.num_classes = num_classes
        self.depth = depth
        self.dtype = dtype
        kw = dict(winograd=winograd, use_bn=use_bn, dtype=dtype, device=device)
        cin, feats = 3, base_features
        for i in range(depth):
            self.add_module(f"down{i}", ConvBlock(cin, feats, **kw))
            cin, feats = feats, feats * 2
        self.bottleneck = ConvBlock(cin, feats, **kw)
        for i in reversed(range(depth)):
            self.add_module(f"up{i}", ConvTranspose(
                feats, feats // 2, 2, kernel_size=2, init_std=None, dtype=dtype,
                device=device))
            feats //= 2
            self.add_module(f"upconv{i}", ConvBlock(2 * feats, feats, **kw))
        self.head = Conv(feats, num_classes, 1, dtype=dtype, device=device)

    @property
    def total_stride(self) -> int:
        return 2 ** self.depth

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is accepted for the train step's call and unused
        (U-Net has no dropout). Each down stage with its pool, the
        bottleneck and each up stage is one :func:`region` (the unit a
        train step with ``remat`` recomputes)."""
        skips = []
        for i in range(self.depth):
            skip, x = region(self._down, i, x)
            skips.append(skip)
        x = region(self.bottleneck, x)
        for i in reversed(range(self.depth)):
            x = region(self._up, i, x, skips[i])
        return self.head(x).float()

    def _down(self, i: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        skip = getattr(self, f"down{i}")(x)
        return skip, max_pool(skip, 2)

    def _up(self, i: int, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = getattr(self, f"up{i}")(x)
        x = torch.cat([skip.to(x.dtype), x], -1)
        return getattr(self, f"upconv{i}")(x)
