"""FCN-8s/16s/32s: VGG16 encoder + transposed-conv decoder with add skips
(counterpart of the JAX package's ``models/fcn8s.py``).

1x1 score convs on pool3 / pool4 / conv7, 2x -> +pool4, 2x -> +pool3, 8x ->
full-resolution logits. Input NHWC float with H, W divisible by 32
(``ops.shape.pad_to_multiple``); output NHWC float32 logits.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import Conv
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import (
    VGG16, VGG16_STAGES, reject_unported,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import (
    ConvTranspose,
)

_SCORE_STD = 0.01  # normal(0.01) init of the score and upsample kernels


class FCN8s(nn.Module):
    """FCN, all three paper variants via ``variant``: 32 = direct 32x
    upsample of conv7 scores; 16 = fuse pool4, 16x up; 8 (default) = fuse
    pool4 + pool3, 8x up.

    ``fast_upsample`` is accepted for preset compatibility: on the TPU it
    chose between two implementations of the same function; the port has
    one (``F.conv_transpose2d``). Flags the port does not implement raise.
    """

    total_stride = 32

    def __init__(self, num_classes: int = 2, fc_features: int = 1024,
                 width_mult: float = 1.0, *, dropout_rate: float = 0.5,
                 variant: int = 8, dtype: torch.dtype = DEFAULT_DTYPE,
                 packed_stage1: bool = True, deferred_pool_bias: bool = True,
                 fast_upsample: bool = True, use_bn: bool = False,
                 winograd: str | None = None, winograd_fc6: bool | None = None,
                 packed_stage2_entry: bool = False, pallas_spmd: bool = False,
                 pallas_pool: bool | None = None, device=None):
        super().__init__()
        if variant not in (8, 16, 32):
            raise ValueError(f"FCN variant must be 8/16/32, got {variant}")
        reject_unported(pallas_pool=pallas_pool is not None)
        self.num_classes = num_classes
        self.variant = variant
        self.dtype = dtype
        self.vgg16 = VGG16(fc_features, width_mult,
                           packed_stage1=packed_stage1,
                           deferred_pool_bias=deferred_pool_bias,
                           dropout_rate=dropout_rate, dtype=dtype,
                           use_bn=use_bn, winograd=winograd,
                           winograd_fc6=winograd_fc6,
                           packed_stage2_entry=packed_stage2_entry,
                           pallas_spmd=pallas_spmd, device=device)
        feats = [max(8, int(f * width_mult)) for _, f in VGG16_STAGES]
        kw = dict(dtype=dtype, device=device)
        nc = num_classes
        self.score_conv7 = Conv(fc_features, nc, 1, init_std=_SCORE_STD, **kw)
        if variant == 32:
            self.up32_final = ConvTranspose(nc, nc, 32, **kw)
            return
        self.score_pool4 = Conv(feats[3], nc, 1, init_std=_SCORE_STD, **kw)
        self.up2_conv7 = ConvTranspose(nc, nc, 2, **kw)
        if variant == 16:
            self.up16_final = ConvTranspose(nc, nc, 16, **kw)
            return
        self.score_pool3 = Conv(feats[2], nc, 1, init_std=_SCORE_STD, **kw)
        self.up2_fuse4 = ConvTranspose(nc, nc, 2, **kw)
        self.up8_final = ConvTranspose(nc, nc, 8, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ends = self.vgg16(x)
        s7 = self.score_conv7(ends["conv7"])              # /32
        if self.variant == 32:
            return self.up32_final(s7).float()            # /1
        x = self.up2_conv7(s7) + self.score_pool4(ends["pool4"])   # /16
        if self.variant == 16:
            return self.up16_final(x).float()
        x = self.up2_fuse4(x) + self.score_pool3(ends["pool3"])    # /8
        return self.up8_final(x).float()                  # /1
