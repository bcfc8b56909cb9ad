"""DeepLab-v2 "DeepLab-ASPP-L" on VGG16 (Chen, Papandreou, Kokkinos, Murphy,
Yuille, arXiv:1606.00915, section 3.3, Fig. 4(b), Table 3): a port-only
model, with no counterpart in the JAX package.

Backbone: VGG16's 13 convs (3x3, bias, relu) in its five stages, each
closed by a 3x3 max pool with padding 1, stride 2 after stages 1-3 and
stride 1 after stages 4 and 5; stage 5 runs at dilation 2. Output stride 8.
Head: four parallel branches on pool5, one a rate r of :data:`RATES` (6,
12, 18, 24 as published), each ``fc6_r`` (3x3 at dilation r, padding r,
``fc_features`` wide: 1024), relu, dropout, ``fc7_r`` (1x1, 1024), relu,
dropout, ``fc8_r`` (1x1 to the classes); the logits are the sum of the four
``fc8_r`` outputs, upsampled x8 bilinearly. NHWC in, float32 NHWC logits
out. The DenseCRF is post-processing and stays out.

The pools run in floor mode, so an input whose sides are multiples of 8
gives exactly an eighth (320x1152 -> 40x144); Caffe's ceil mode and its
321-pixel crops are a departure. The backbone keeps VGG16's parameter
names (``vgg16.stage{i}.conv{j}``), so ``models.vgg16.load_npz_weights``
imports an ImageNet VGG16 archive into it unchanged.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    Conv, ConvBlock, dropout, region, upsample_bilinear,
)
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import VGG16_STAGES
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import spatial_grid
from semanticsegmentation_tensorflow_tpu_torch.utils import tracing

# ASPP-L's atrous rates (the paper's Table 3)
RATES = (6, 12, 18, 24)
# (pool stride, conv dilation) of each of VGG16's stages
POOL_STRIDES = (2, 2, 2, 1, 1)
DILATIONS = (1, 1, 1, 1, 2)


def max_pool3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 max pool of NHWC ``x`` with padding 1 and ``stride``, floor mode,
    on its channels-last memory."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


class _PoolStage(ConvBlock):
    """A :class:`ConvBlock` (3x3 conv, bias, relu for each conv) closed by
    :func:`max_pool3` at ``stride``."""

    def __init__(self, *args, stride: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool3(super().forward(x), self.stride)


class DilatedVGG16(nn.Module):
    """DeepLab-v2's VGG16: ``stage1``..``stage5`` (:class:`_PoolStage`,
    widths scaled by ``width_mult`` as ``models.vgg16.VGG16`` scales them),
    each a :func:`region`. Returns pool5, at an eighth of the input."""

    def __init__(self, width_mult: float = 1.0, *,
                 dtype: torch.dtype = DEFAULT_DTYPE, device=None):
        super().__init__()
        cin = 3
        for i, ((n_convs, feats), stride, d) in enumerate(
                zip(VGG16_STAGES, POOL_STRIDES, DILATIONS), start=1):
            feats = max(8, int(feats * width_mult))
            self.add_module(f"stage{i}", _PoolStage(
                cin, feats, n_convs, dilation=d, stride=stride, dtype=dtype,
                device=device))
            cin = feats
        self.features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, len(VGG16_STAGES) + 1):
            x = region(getattr(self, f"stage{i}"), x)
        return x


class ASPPL(nn.Module):
    """The ASPP-L head: for each rate r, ``fc6_{r}`` (3x3, dilation r),
    relu, dropout, ``fc7_{r}`` (1x1), relu, dropout, ``fc8_{r}`` (1x1 to the
    classes); returns the sum of the branches' ``fc8_{r}`` outputs in
    float32. In ``train()`` mode the keep-masks are drawn from
    ``generator``, fc6_r's then fc7_r's, branch by branch in the order of
    :data:`RATES`. Each branch runs inside a ``tracing.span("aspp.branch")``."""

    def __init__(self, in_features: int, num_classes: int, fc_features: int,
                 dropout_rate: float, *, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dropout_rate = dropout_rate
        for r in RATES:
            self.add_module(f"fc6_{r}", Conv(in_features, fc_features, 3,
                                             dilation=r, **kw))
            self.add_module(f"fc7_{r}", Conv(fc_features, fc_features, 1, **kw))
            self.add_module(f"fc8_{r}", Conv(fc_features, num_classes, 1, **kw))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        drop = dict(training=self.training, generator=generator)
        out = None
        for r in RATES:
            with tracing.span("aspp.branch"):
                y = dropout(torch.relu(getattr(self, f"fc6_{r}")(x)),
                            self.dropout_rate, **drop)
                y = dropout(torch.relu(getattr(self, f"fc7_{r}")(y)),
                            self.dropout_rate, **drop)
                y = getattr(self, f"fc8_{r}")(y).float()
                out = y if out is None else out + y
        return out


class DeepLabV2(nn.Module):
    """DeepLab-v2 ASPP-L on VGG16 (module docstring): ``vgg16``
    (:class:`DilatedVGG16`) and ``aspp`` (:class:`ASPPL`), the head one
    :func:`region` inside ``tracing.span("aspp")``.

    Under a grid that splits rows (``parallel.mesh.spatial_grid``) the
    forward raises NotImplementedError: the 3x3 pools exchange no halo
    rows."""

    total_stride = 8

    def __init__(self, num_classes: int = 2, fc_features: int = 1024,
                 width_mult: float = 1.0, *, dropout_rate: float = 0.5, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.vgg16 = DilatedVGG16(width_mult, dtype=dtype, device=device)
        self.aspp = ASPPL(self.vgg16.features, num_classes, fc_features,
                          dropout_rate, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the dropout masks' source in ``train()`` mode."""
        if spatial_grid() is not None:
            raise NotImplementedError(
                "deeplab_v2's 3x3 pools exchange no halo rows: train it "
                "without --spatial")
        x = self.vgg16(x)
        with tracing.span("aspp"):
            y = region(self.aspp, x, generator)
        return upsample_bilinear(y, self.total_stride)
