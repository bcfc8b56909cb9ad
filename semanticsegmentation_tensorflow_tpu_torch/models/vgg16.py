"""VGG16 feature extractor (counterpart of the JAX package's
``models/vgg16.py``): stages 1-5 with 2x2 pools, then fc6 (7x7 SAME) and
fc7 (1x1) as convs with dropout. NHWC in, dict of NHWC endpoints out."""

from __future__ import annotations

import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import Conv
from semanticsegmentation_tensorflow_tpu_torch.ops.packed_stem import (
    PooledConvBlock, Stage1,
)

# (n_convs, features) per VGG16 stage.
VGG16_STAGES: tuple[tuple[int, int], ...] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512),
)


def reject_unported(**flags) -> None:
    """Raise on a JAX-package model flag the port does not implement,
    rather than ignoring it. Each keyword is true when its flag was set
    away from the port's only form."""
    on = sorted(k for k, v in flags.items() if v)
    if on:
        raise NotImplementedError(
            f"not ported yet: {', '.join(on)} (the port implements only "
            "the default of each)")


class VGG16(nn.Module):
    """Returns a dict of endpoints: pool1..pool5, conv7.

    ``packed_stage1`` (the JAX flag's name, kept so presets and
    ``--model-kw`` carry over): stage1 runs as :class:`Stage1`, conv1_1 then
    the fused stage1-tail kernel. False runs it as a
    :class:`PooledConvBlock`, like stages 2-5 (the last bias added after the
    pool, bit-exact). Same params either way. ``deferred_pool_bias`` is
    accepted only at its JAX default (True): the port has no other form.
    """

    def __init__(self, fc_features: int = 1024, width_mult: float = 1.0, *,
                 packed_stage1: bool = True, deferred_pool_bias: bool = True,
                 dropout_rate: float = 0.5, dtype: torch.dtype = DEFAULT_DTYPE,
                 use_bn: bool = False, dilated_last_stages: bool = False,
                 winograd: str | None = None, winograd_fc6: bool | None = None,
                 packed_stage2_entry: bool = False, pallas_spmd: bool = False,
                 device=None):
        super().__init__()
        reject_unported(use_bn=use_bn, dilated_last_stages=dilated_last_stages,
                        winograd=winograd, winograd_fc6=winograd_fc6,
                        packed_stage2_entry=packed_stage2_entry,
                        pallas_spmd=pallas_spmd,
                        deferred_pool_bias=not deferred_pool_bias)
        cin = 3
        for i, (n_convs, feats) in enumerate(VGG16_STAGES, start=1):
            feats = max(8, int(feats * width_mult))
            if i == 1 and packed_stage1:
                block = Stage1(cin, feats, dtype=dtype, device=device)
            else:
                block = PooledConvBlock(cin, feats, n_convs, dtype=dtype,
                                        device=device)
            self.add_module(f"stage{i}", block)
            cin = feats
        self.conv6 = Conv(cin, fc_features, 7, dtype=dtype, device=device)
        self.conv7 = Conv(fc_features, fc_features, 1, dtype=dtype,
                          device=device)
        self.drop6 = nn.Dropout(dropout_rate)
        self.drop7 = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        ends: dict[str, torch.Tensor] = {}
        for i in range(1, len(VGG16_STAGES) + 1):
            x = getattr(self, f"stage{i}")(x)
            ends[f"pool{i}"] = x
        x = self.drop6(torch.relu(self.conv6(x)))
        x = self.drop7(torch.relu(self.conv7(x)))
        ends["conv7"] = x
        return ends
