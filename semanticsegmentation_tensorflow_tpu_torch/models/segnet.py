"""SegNet: VGG-style encoder + max-pool-index unpooling decoder (counterpart
of the JAX package's ``models/segnet.py``).

The encoder records the within-window argmax of every 2x2 max pool; the
decoder upsamples by placing each value back at its recorded position (zeros
elsewhere), then convolves; a 1x1 head gives float32 logits. Input NHWC with
H, W divisible by 32 (``ops.shape.pad_to_multiple``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    Conv, ConvBlock, region,
)
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import (
    VGG16_STAGES, _halo_tail,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    SegNetStage1Tail, SegNetStage1TailHalo, stage1_tail_segnet,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.pool import (
    max_pool_with_argmax, max_unpool,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import spatial_grid


class SegNetStage1(ConvBlock):
    """SegNet encoder stage1: conv3x3 -> relu -> conv3x3 -> +b2 -> relu ->
    2x2 argmax pool, returning (pooled, u8 idx) (counterpart of the JAX
    package's ``PackedSegNetStage1``, ``ops/packed_stem.py:327-386``).

    conv1_1 (``conv0``) runs as a plain conv plus b1 in the compute dtype;
    the rest is one call of the SegNet stage1 tail
    (``ops/cuda/stage1.py:stage1_tail_segnet``), or :class:`SegNetStage1Tail`
    when autograd records; under an active grid that splits rows, its halo
    mode (``models.vgg16._halo_tail``, kernel 1c). Same parameters as
    ``ConvBlock(features, 2)``; an odd H or W raises, as the JAX module
    does."""

    def __init__(self, in_features: int, features: int = 64, *,
                 dtype: torch.dtype = DEFAULT_DTYPE, device=None):
        super().__init__(in_features, features, 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"SegNet stage1 needs even H, W; got "
                             f"{tuple(x.shape[1:3])}")
        grid = spatial_grid()
        if grid is not None:
            return _halo_tail(self.conv0, self.conv1, x, grid,
                              SegNetStage1TailHalo, "segnet")
        z1 = self.conv0(x).contiguous()
        k2, b2 = self.conv1.weight, self.conv1.bias
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (z1, k2, b2)):
            return SegNetStage1Tail.apply(z1, k2, b2)
        return stage1_tail_segnet(z1, k2, b2)


class SegNet(nn.Module):
    """Encoder ``enc1``..``enc5`` (VGG16's stages), decoder ``dec5``..``dec1``
    (``ConvBlock``s with stage i's conv count, each giving the width of the
    previous encoder stage), 1x1 ``head``; the JAX package's parameter names.

    ``packed_stage1`` (the JAX flag's name): ``enc1`` is
    :class:`SegNetStage1`, conv1_1 then the fused SegNet stage1 tail kernel
    (``ops/cuda/stage1.py``); otherwise a ``ConvBlock`` followed by
    ``max_pool_with_argmax``, as the JAX package's jnp path. Same params and
    the same function either way. ``winograd`` (``"f2"``, ``"f4"``,
    ``"f2x"``, ``"f4x"``) goes to every ``ConvBlock`` (enc2-enc5,
    dec5-dec1; ``ops.conv.winograd_impl`` picks the eligible layers), as in
    the JAX package; the parameters do not change. ``use_bn=True`` puts a
    ``BatchNorm`` after every encoder and decoder conv (SegNet as
    published); ``enc1`` is then a ``ConvBlock`` and the argmax pool, as
    the JAX package leaves its packed enc1 under BN
    (``models/segnet.py:78``); the argmax pool and unpool stay kernel 5.
    ``forward`` takes a ``generator`` for the train step's calling
    convention; SegNet has no dropout and draws nothing.
    """

    total_stride = 32

    def __init__(self, num_classes: int = 2, width_mult: float = 1.0, *,
                 use_bn: bool = False, packed_stage1: bool = True,
                 winograd: str | None = None,
                 dtype: torch.dtype = DEFAULT_DTYPE, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.fused_stage1 = packed_stage1 and not use_bn
        feats = [max(8, int(f * width_mult)) for _, f in VGG16_STAGES]
        kw = dict(dtype=dtype, device=device)
        wkw = dict(kw, winograd=winograd, use_bn=use_bn)
        cin = 3
        for i, (n_convs, _) in enumerate(VGG16_STAGES, start=1):
            f = feats[i - 1]
            self.add_module(f"enc{i}", SegNetStage1(cin, f, **kw)
                            if i == 1 and self.fused_stage1
                            else ConvBlock(cin, f, n_convs, **wkw))
            cin = f
        for i in range(len(VGG16_STAGES), 0, -1):
            out = feats[max(i - 2, 0)]
            self.add_module(f"dec{i}", ConvBlock(cin, out, VGG16_STAGES[i - 1][0],
                                                 **wkw))
            cin = out
        self.head = Conv(cin, num_classes, 1, **kw)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Each encoder stage with its pool and each unpool with its decoder
        stage is one :func:`region` (the unit a train step with ``remat``
        recomputes)."""
        indices = []
        for i in range(1, len(VGG16_STAGES) + 1):
            x, idx = region(self._encode, i, x)
            indices.append(idx)
        for i in range(len(VGG16_STAGES), 0, -1):
            x = region(self._decode, i, x, indices[i - 1])
        return self.head(x).float()

    def _encode(self, i: int, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        block = getattr(self, f"enc{i}")
        if i == 1 and self.fused_stage1:
            return block(x)
        return max_pool_with_argmax(block(x), 2)

    def _decode(self, i: int, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"dec{i}")(max_unpool(x, idx, 2))
