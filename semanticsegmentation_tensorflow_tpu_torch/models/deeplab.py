"""DeepLab-ASPP: a dilated VGG16 encoder and an atrous spatial pyramid pooling
head (counterpart of the JAX package's ``models/deeplab.py``).

The encoder runs at output stride 8 (stages 4-5 dilated instead of pooled)
or 16 (stage 5 only); the head runs parallel atrous 3x3 convs at several
rates beside a 1x1 conv and an image-level feature (the mean over H and W,
then a 1x1 conv), projects them with one 1x1 conv, scores the classes with
a 1x1 conv and resizes the logits bilinearly to the input's size. NHWC in,
float32 NHWC logits out. Parameter names are the JAX package's
(``vgg16/...``, ``aspp/b0``, ``aspp/b_rate{r}``, ``aspp/b_image``,
``aspp/project``, ``head``), so ``convert.py`` maps the flax tree strictly.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    BatchNorm, Conv, region, upsample_bilinear,
)
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import VGG16
from semanticsegmentation_tensorflow_tpu_torch.ops.conv import conv_nhwc
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import spatial_sum
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import spatial_grid

def image_mean(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,1,1,C]: the mean over H and W summed in float32 and
    rounded once to ``x``'s dtype, as ``jnp.mean`` does for bf16. Under an
    active grid that splits rows, the ranks' sums are added
    (``parallel.halo.spatial_sum``) and divided by the whole image's H x W
    (H the sum of the ranks' rows)."""
    grid = spatial_grid()
    total = x.float().sum((1, 2), keepdim=True)
    count = x.shape[1] * x.shape[2]
    if grid is not None:
        total = spatial_sum(total, grid)
        count = sum(r for _, r in grid.level_splits(x.shape[1])) * x.shape[2]
    return (total / count).to(x.dtype)


class _ASPPProject(Conv):
    """The 1x1 projection over the branches' concat: one conv named
    ``project``, weight [F, (2 + len(rates)) F, 1, 1], with the image-level
    feature [N,1,1,F] broadcast over the grid (the JAX ``_ASPPProject``).

    ``split=False``: the concat of the branches and the broadcast image
    feature, one 1x1 conv, then the bias. ``split=True``
    (``aspp_split_proj``): the sum of per-branch 1x1 convs on column slices
    of the weight, in the order b0, b_rate{r}..., then the image slice
    projected at 1x1 and broadcast-added; the same function in another
    summation order."""

    def __init__(self, in_features: int, features: int, *, split: bool = False,
                 dtype: torch.dtype = DEFAULT_DTYPE, device=None):
        super().__init__(in_features, features, 1, dtype=dtype, device=device)
        self.split = split

    def forward(self, branches: list[torch.Tensor], img: torch.Tensor
                ) -> torch.Tensor:
        w = self.weight
        if not self.split:
            x = torch.cat([*branches, img.expand(branches[0].shape)], -1)
            y = conv_nhwc(x, w, dtype=self.dtype, padding=0)
        else:
            y, off = None, 0
            for t in branches:
                c = t.shape[-1]
                p = conv_nhwc(t, w[:, off:off + c], dtype=self.dtype, padding=0)
                y = p if y is None else y + p
                off += c
            y = y + conv_nhwc(img, w[:, off:], dtype=self.dtype, padding=0)
        return y + self.bias.to(self.dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (the JAX ``ASPP``): ``b0`` (1x1),
    ``b_rate{r}`` (3x3 at dilation r, padding r) for each rate, ``b_image``
    (the mean over H and W, :func:`image_mean`, then 1x1),
    each followed by a relu, then ``project`` (:class:`_ASPPProject`) and a
    relu. Under a grid that splits rows the mean sums over the ranks.
    ``use_bn``: a ``BatchNorm`` before each of those relus (``b0_bn``,
    ``b_rate{r}_bn``, ``b_image_bn``, ``project_bn``; the JAX ``bn_relu``,
    ``models/deeplab.py:95-117``); the image branch's takes its statistics
    over the images at 1x1, each image once on a grid that splits rows
    (``BatchNorm(whole_image=True)``)."""

    def __init__(self, in_features: int, features: int = 256,
                 rates: Sequence[int] = (6, 12, 18), *, use_bn: bool = False,
                 split_proj: bool = False, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.rates = tuple(rates)
        self.use_bn = use_bn
        self.b0 = Conv(in_features, features, 1, **kw)
        for r in self.rates:
            self.add_module(f"b_rate{r}", Conv(in_features, features, 3,
                                               dilation=r, **kw))
        self.b_image = Conv(in_features, features, 1, **kw)
        self.project = _ASPPProject(features * (2 + len(self.rates)), features,
                                    split=split_proj, **kw)
        if use_bn:
            for name in ("b0", *(f"b_rate{r}" for r in self.rates), "b_image",
                         "project"):
                self.add_module(f"{name}_bn", BatchNorm(
                    features, whole_image=name == "b_image", **kw))

    def _bn_relu(self, t: torch.Tensor, name: str) -> torch.Tensor:
        if self.use_bn:
            t = getattr(self, f"{name}_bn")(t)
        return torch.relu(t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self._bn_relu(self.b0(x), "b0")]
        branches += [self._bn_relu(getattr(self, f"b_rate{r}")(x), f"b_rate{r}")
                     for r in self.rates]
        img = self._bn_relu(self.b_image(image_mean(x)), "b_image")
        return self._bn_relu(self.project(branches, img), "project")


class DeepLabASPP(nn.Module):
    """DeepLab-ASPP on a dilated VGG16 (fc6/fc7 at 512 channels).

    ``output_stride`` 8 dilates stages 4-5, 16 stage 5 only (``dilate_from``
    {8: 4, 16: 5}); any other value raises ValueError. The stage flags
    (``packed_stage1``, ``deferred_pool_bias``) and ``winograd`` go to
    :class:`VGG16` as for FCN; ``aspp_split_proj`` selects the concat-free
    projection. ``use_bn`` puts BatchNorm in the backbone's stages and in
    the ASPP head."""

    def __init__(self, num_classes: int = 2, aspp_features: int = 256,
                 rates: Sequence[int] = (6, 12, 18), width_mult: float = 1.0, *,
                 use_bn: bool = False, dropout_rate: float = 0.5,
                 winograd: str | None = None, aspp_split_proj: bool = False,
                 deferred_pool_bias: bool = True, packed_stage1: bool = True,
                 dtype: torch.dtype = DEFAULT_DTYPE, output_stride: int = 8,
                 device=None):
        super().__init__()
        if output_stride not in (8, 16):
            raise ValueError(f"output_stride must be 8 or 16, got {output_stride}")
        self.num_classes = num_classes
        self.output_stride = output_stride
        self.dtype = dtype
        self.vgg16 = VGG16(512, width_mult, dilated_last_stages=True,
                           dilate_from={8: 4, 16: 5}[output_stride],
                           dropout_rate=dropout_rate, winograd=winograd,
                           use_bn=use_bn,
                           deferred_pool_bias=deferred_pool_bias,
                           packed_stage1=packed_stage1, dtype=dtype,
                           device=device)
        self.aspp = ASPP(512, aspp_features, rates, use_bn=use_bn,
                         split_proj=aspp_split_proj, dtype=dtype, device=device)
        self.head = Conv(aspp_features, num_classes, 1, dtype=dtype, device=device)

    @property
    def total_stride(self) -> int:
        return self.output_stride

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the dropout masks' source in ``train()`` mode. The
        ASPP head is one :func:`region` (the unit a train step with
        ``remat`` recomputes), after the backbone's."""
        x = region(self.aspp, self.vgg16(x, generator)["conv7"])
        return upsample_bilinear(self.head(x).float(), self.output_stride)
