"""VGG16 feature extractor (counterpart of the JAX package's
``models/vgg16.py``): stages 1-5 with 2x2 pools, then fc6 (7x7 SAME) and
fc7 (1x1) as convs with dropout. NHWC in, dict of NHWC endpoints out.
Dropout draws its masks from the generator passed to ``forward`` (flax's
semantics, ``models.common.dropout``)."""

from __future__ import annotations

import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    Conv, ConvBlock, dropout,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.packed_stem import (
    PooledConvBlock, Stage1,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.pool import max_pool
from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import (
    winograd_conv_large,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import spatial_grid

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


class ConvPoolBlock(ConvBlock):
    """ConvBlock (conv + bias + relu for every conv) then a 2x2/2 max pool:
    the JAX package's VGG16 stage with ``deferred_pool_bias=False``
    (``models/vgg16.py:105-116``). Same parameters as
    :class:`PooledConvBlock`, which computes the same function bit for bit
    with the last bias and relu after the pool."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(super().forward(x), 2)


class VGG16(nn.Module):
    """Returns a dict of endpoints: pool1..pool5, conv7.

    ``packed_stage1`` (the JAX flag's name, kept so presets and
    ``--model-kw`` carry over): stage1 runs as :class:`Stage1`, conv1_1 then
    the fused stage1-tail kernels (on even H and W), unless ``pallas_pool``
    is False (the JAX flag that selects the fused kernel; None and True
    select it here). Otherwise it runs as a :class:`PooledConvBlock`, like
    stages 2-5 (the last bias added after the pool, bit-exact). Same params
    either way. ``deferred_pool_bias=False`` runs every stage that is not
    :class:`Stage1` as a :class:`ConvPoolBlock` (each conv's bias and relu
    before the pool, as the JAX flag does), bit-equal to the default.
    ``packed_stage2_entry`` is a TPU layout of conv2_1 (width pairs packed
    into the 128 lanes) computing the same function: accepted, and a no-op
    here, as SegNet's ``packed_dec1``/``packed_dec2`` are.
    ``dropout_rate`` applies to fc6 and fc7 in ``train()`` mode, with masks
    from the ``generator`` given to :meth:`forward`. ``pallas_spmd`` goes to
    :class:`Stage1` (its halo mode, kernel 1c).
    """

    def __init__(self, fc_features: int = 1024, width_mult: float = 1.0, *,
                 packed_stage1: bool = True, deferred_pool_bias: bool = True,
                 dropout_rate: float = 0.5, dtype: torch.dtype = DEFAULT_DTYPE,
                 use_bn: bool = False, dilated_last_stages: bool = False,
                 winograd: str | None = None, winograd_fc6: bool | None = None,
                 packed_stage2_entry: bool = False, pallas_spmd: bool = False,
                 pallas_pool: bool | None = None, device=None):
        super().__init__()
        reject_unported(use_bn=use_bn, dilated_last_stages=dilated_last_stages)
        cin = 3
        for i, (n_convs, feats) in enumerate(VGG16_STAGES, start=1):
            feats = max(8, int(feats * width_mult))
            if i == 1 and packed_stage1 and pallas_pool is not False:
                block = Stage1(cin, feats, winograd=winograd,
                               pallas_spmd=pallas_spmd, dtype=dtype,
                               device=device)
            else:
                kind = PooledConvBlock if deferred_pool_bias else ConvPoolBlock
                block = kind(cin, feats, n_convs, winograd=winograd,
                             dtype=dtype, device=device)
            self.add_module(f"stage{i}", block)
            cin = feats
        self.conv6 = Conv(cin, fc_features, 7, dtype=dtype, device=device)
        self.conv7 = Conv(fc_features, fc_features, 1, dtype=dtype,
                          device=device)
        self.dropout_rate = dropout_rate
        self.winograd_fc6 = bool(winograd_fc6)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
        ends: dict[str, torch.Tensor] = {}
        for i in range(1, len(VGG16_STAGES) + 1):
            x = getattr(self, f"stage{i}")(x)
            ends[f"pool{i}"] = x
        drop = dict(training=self.training, generator=generator)
        if self.winograd_fc6:
            if spatial_grid() is not None:
                raise NotImplementedError(
                    "winograd_fc6 exchanges no halo rows: train a spatial "
                    "grid without it")
            c6 = self.conv6
            x = winograd_conv_large(x.to(c6.dtype), c6.weight, c6.bias, "f3", True)
        else:
            x = torch.relu(self.conv6(x))
        x = dropout(x, self.dropout_rate, **drop)
        x = dropout(torch.relu(self.conv7(x)), self.dropout_rate, **drop)
        ends["conv7"] = x
        return ends
