"""Shared building blocks + the dtype policy (counterpart of the JAX
package's ``models/common.py``).

Policy: params in float32; conv inputs and kernels cast to the compute dtype
(bf16 by default) with f32 accumulation; the bias is added in the compute
dtype AFTER the conv, as flax's ``nn.Conv(dtype=bf16)`` does. Activations
are NHWC at every module boundary; the convs run on NCHW views of them,
which for contiguous NHWC tensors are ``torch.channels_last`` memory.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.dtypes import DEFAULT_DTYPE
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import exchange_rows
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (
    Grid, current_grid, spatial_grid,
)

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
    ``dtype``; accumulates in f32 and returns NHWC in ``dtype``.

    Under an active grid that splits rows (``parallel.mesh.spatial_grid``),
    the ``padding`` rows above and below are the neighbouring ranks' rows
    (``parallel.halo.exchange_rows``; zero at the image's edge) instead of
    zeros, so each rank computes its rows of the whole image's conv; the
    columns keep their zero padding. A halo taller than a rank's rows (a
    dilated conv on a fine grid) takes rows from the ranks beyond. Some
    dilated convs run as :func:`conv_by_phases` (:func:`by_phases`)."""
    x = x.to(dtype)
    rows = x.shape[1]
    grid = spatial_grid()
    pad_h = padding
    if grid is not None and padding:
        x = exchange_rows(x, padding, padding, grid)
        pad_h = 0
    kernel = kernel.to(dtype)
    grad = torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad)
    if by_phases(x.shape[0], rows, kernel.shape, dilation, grad):
        return conv_by_phases(x, kernel, pad_h, padding, dilation)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=(pad_h, padding),
                 dilation=dilation)
    return y.permute(0, 2, 3, 1)


def by_phases(batch: int, rows: int, kernel_shape, dilation: int, grad: bool) -> bool:
    """Whether :func:`conv_nhwc` runs a dilated conv as :func:`conv_by_phases`
    (``rows``: the input rows this rank convolves; ``grad``: a backward will
    follow). Only where cuDNN 9.2's dilated bf16 conv was measured 10-1000x
    slower on an H100 (``tools/dilated_convs.py``, DeepLab at KITTI's shapes):
    a kernel wider than 3x3 at a batch of up to three, or four with a
    backward (conv6: 88-942 ms forward, 68-1013 forward and backward, against
    2.7-41 by phases); and a 3x3 at a dilation above 6 at a batch of one whose
    dilated window fits in the rows (the os8 ASPP's rates 12 and 18: 19-29 ms
    against 0.11-0.62). Elsewhere the direct conv was faster or within a few
    ms of the phases (PERF.md lists those measured cases)."""
    if dilation == 1:
        return False
    k = kernel_shape[-1]
    if k > 3:
        return batch <= (4 if grad else 3)
    return batch == 1 and dilation > 6 and dilation * (k - 1) + 1 <= rows


def conv_by_phases(x: torch.Tensor, kernel: torch.Tensor, pad_h: int, pad_w: int,
                   dilation: int) -> torch.Tensor:
    """A stride-1 conv of NHWC ``x`` with OIHW ``kernel`` at ``dilation`` d,
    zero-padded by ``pad_h`` rows and ``pad_w`` columns on each side, as d x d
    undilated convs, one for each phase (i mod d, j mod d) of the output:
    TensorFlow's ``atrous_conv2d`` form (space to batch, conv, batch to
    space). The same products as the dilated conv; NHWC out, in ``x``'s
    dtype."""
    d = dilation
    n, h, w, c = x.shape
    kh, kw = kernel.shape[2:]
    ho, wo = h + 2 * pad_h - d * (kh - 1), w + 2 * pad_w - d * (kw - 1)
    hp, wp = -(-(h + 2 * pad_h) // d) * d, -(-(w + 2 * pad_w) // d) * d
    x = F.pad(x, (0, 0, pad_w, wp - w - pad_w, pad_h, hp - h - pad_h))
    x = (x.reshape(n, hp // d, d, wp // d, d, c).permute(0, 2, 4, 1, 3, 5)
         .reshape(n * d * d, hp // d, wp // d, c))
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel)
    co, hq, wq = y.shape[1:]
    y = (y.permute(0, 2, 3, 1).reshape(n, d, d, hq, wq, co).permute(0, 3, 1, 4, 2, 5)
         .reshape(n, hq * d, wq * d, co))
    return y[:, :ho, :wo]


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), padding="SAME", dtype=...)``, NHWC.

    ``weight`` is OIHW [features, in_features, k, k]; ``bias`` [features].
    ``init_std``: None gives flax's lecun_normal kernel init, a number a
    normal(0, init_std) init (the FCN score convs). Biases start at zero.
    Parameters are created uninitialized: call :func:`init_params`.

    ``qat`` (set by ``infer.quant.fake_quantize``): quantization-aware
    training, the JAX package's ``make_fake_quant_apply`` for this conv: the
    weight on its per-channel int8 grid and the input on its per-tensor grid
    at ``act_scale`` (none where that is None), both with straight-through
    gradients (``ops.quant``), then the conv in the compute dtype, the bias
    added in float32 and one rounding. The parameters stay the same.
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
        self.qat = False
        self.act_scale: float | None = None

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
        if self.qat:
            from semanticsegmentation_tensorflow_tpu_torch.ops.quant import (
                fake_quant_act, fake_quant_weight,
            )
            y = conv_nhwc(fake_quant_act(x, self.act_scale),
                          fake_quant_weight(self.weight), dtype=self.dtype,
                          padding=self.padding, dilation=self.dilation)
            return (y.float() + self.bias.float()).to(self.dtype)
        return self.conv(x) + self.bias.to(self.dtype)


def winograd_impl(x_shape, kernel_shape, winograd: str | None,
                  dilation: int = 1) -> str | None:
    """Per-layer Winograd routing (the JAX package's ``winograd_impl``,
    ``models/common.py:22-59``, with its gate, so that the same layers take
    the same numerics): ``"kernel"`` (kernel 6, ``ops/cuda/winograd.py``),
    ``"materialized"`` (``ops/winograd.winograd_conv2d``; a variant with the
    suffix ``x``, e.g. ``"f2x"``, asks for it) or None (the direct conv).
    ``kernel_shape`` is OIHW. Routing depends on the shape alone; an unknown
    variant raises. Ineligible layers take the direct conv: the flag picks
    an implementation, never an architecture."""
    if not winograd or dilation != 1:
        return None
    if spatial_grid() is not None:
        raise NotImplementedError(
            "the Winograd forms exchange no halo rows: train a spatial grid "
            "with winograd=None (what --spatial merges in)")
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.winograd import (
        eligible,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import (
        VARIANTS, xla_eligible,
    )
    materialized = winograd.endswith("x")
    base = winograd[:-1] if materialized else winograd
    if base not in VARIANTS:
        raise ValueError(f"unknown winograd variant {winograd!r}")
    if materialized:
        return ("materialized" if xla_eligible(x_shape, kernel_shape, base)
                else None)
    return "kernel" if eligible(x_shape, kernel_shape, base) else None


def conv3x3_bias_relu(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor, *, dtype: torch.dtype,
                      dilation: int = 1,
                      winograd: str | None = None) -> torch.Tensor:
    """relu(SAME-conv3x3(x, kernel) + bias), the VGG workhorse layer, with
    the Winograd form :func:`winograd_impl` routes the layer to. ``kernel``
    is OIHW. The direct conv adds the bias in the compute dtype; the
    Winograd forms add it (rounded to that dtype) in float32 before the
    relu and round once, as in the JAX package."""
    x = x.to(dtype)
    impl = winograd_impl(x.shape, kernel.shape, winograd, dilation)
    if impl == "materialized":
        from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import (
            winograd_conv2d,
        )
        return winograd_conv2d(x, kernel, bias, winograd[:-1], True)
    if impl == "kernel":
        from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.winograd import (
            winograd_conv_bias_relu,
        )
        return winograd_conv_bias_relu(x, kernel, bias, winograd)
    z = conv_nhwc(x, kernel, dtype=dtype, padding=dilation, dilation=dilation)
    return torch.relu(z + bias.to(dtype))


def conv3x3_raw(x: torch.Tensor, conv: Conv,
                winograd: str | None = None) -> torch.Tensor:
    """``conv``'s 3x3 SAME conv without its bias, in its compute dtype,
    through the Winograd form :func:`winograd_impl` routes it to (the raw
    kernel form, or the materialized one with a zero bias and no relu)."""
    x = x.to(conv.dtype)
    impl = winograd_impl(x.shape, conv.weight.shape, winograd, conv.dilation)
    if impl == "materialized":
        from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import (
            winograd_conv2d,
        )
        zero = torch.zeros(conv.weight.shape[0], device=x.device)
        return winograd_conv2d(x, conv.weight, zero, winograd[:-1], False)
    if impl == "kernel":
        from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.winograd import (
            winograd_conv3x3,
        )
        return winograd_conv3x3(x, conv.weight, winograd)
    return conv.conv(x)


# flax nn.BatchNorm's defaults, which every BatchNorm of the JAX models uses
BN_MOMENTUM, BN_EPSILON = 0.99, 1e-5
_FROZEN_STATS: list[bool] = []


@contextlib.contextmanager
def frozen_batch_stats() -> Iterator[None]:
    """Within it, a :class:`BatchNorm` in training mode normalizes by the
    batch's statistics but leaves its running statistics as they are: the
    recompute of a rematerialized forward (``train/step.py``) replays the
    forward without updating them a second time."""
    _FROZEN_STATS.append(True)
    try:
        yield
    finally:
        _FROZEN_STATS.pop()


_REGIONS: list = []


@contextlib.contextmanager
def remat_regions(wrap) -> Iterator[None]:
    """Within it, every :func:`region` of a model's forward runs as
    ``wrap(fn, *args)``: the rematerializing train step (``train/step.py``)
    passes a wrap that recomputes the region in the backward."""
    _REGIONS.append(wrap)
    try:
        yield
    finally:
        _REGIONS.pop()


def region(fn, *args):
    """``fn(*args)``: one stage of a model (a VGG16 stage, the fc6/fc7 head,
    a SegNet or U-Net block, the ASPP head), the unit that a train step with
    ``remat`` recomputes in the backward (:func:`remat_regions`). Regions
    do not nest."""
    if _REGIONS:
        return _REGIONS[-1](fn, *args)
    return fn(*args)


def _sum_over(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """``tensors`` (f32) summed over ``group`` by one all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


class _BatchNormTrain(torch.autograd.Function):
    """flax's training-mode BatchNorm over NHWC ``x`` with the statistics
    of every pixel of every image in ``group``'s ranks (one rank: ``group``
    False). Forward: the f32 sums of x, x^2 and the pixel count, one
    all-reduce of the three over the group, ``mean = s1 / n``, ``var =
    max(0, s2 / n - mean^2)`` (flax's fast variance), then ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in f32, rounded to x's dtype.
    Backward: the two sums the input gradient needs, ``sum(dy)`` and
    ``sum(dy * (x - mean))``, by one all-reduce over the same group (the
    parameters' gradients stay this rank's share: the step sums them over
    the world). A clamped variance passes no gradient, as ``jnp.maximum``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        count = torch.full((1,), float(xf.numel() // xf.shape[-1]),
                           device=x.device)
        s1, s2 = xf.sum(dims), (xf * xf).sum(dims)
        if group is not False:
            s1, s2, count = _sum_over([s1, s2, count], group)
        mean = s1 / count
        raw = s2 / count - mean * mean
        var = torch.clamp(raw, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = ((xf - mean) * (inv * scale) + bias).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, scale, count, raw > 0)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, scale, count, live = ctx.saved_tensors
        dims = tuple(range(x.dim() - 1))
        dyf = dy.float()
        centred = x.float() - mean
        a, b = dyf.sum(dims), (dyf * centred).sum(dims)
        dscale, dbias = b * inv, a
        if ctx.group is not False:
            a, b = _sum_over([a.clone(), b.clone()], ctx.group)
        k = scale * inv
        dx = k * (dyf - a / count) - (k * inv * inv * live * b / count) * centred
        return dx.to(x.dtype), dscale, dbias, None, None


class BatchNorm(nn.Module):
    """flax 0.12's ``nn.BatchNorm(use_running_average=not train,
    dtype=dtype)`` over the channels of NHWC input: momentum
    ``BN_MOMENTUM`` (0.99), epsilon ``BN_EPSILON`` (1e-5); ``scale`` (ones)
    and ``bias`` (zeros) f32 parameters, ``mean`` (zeros) and ``var`` (ones)
    f32 buffers (flax's ``batch_stats``). In
    ``train()`` mode it normalizes by the batch's f32 statistics,
    ``mean(x)`` and ``max(0, mean(x^2) - mean(x)^2)``, and updates the
    running ones ``r = 0.99 r + 0.01 s`` with that (biased) variance, unless
    :func:`frozen_batch_stats`; in ``eval()`` mode by the running ones. The
    output is ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32,
    rounded to ``dtype``. Its tensors stay f32 when the module is cast to
    another dtype (``Module.to``), as flax keeps them.

    Under an active grid that splits rows (``parallel.mesh``) the
    statistics are the whole world's, every image and every row (JAX's 2-D
    mesh runs one global program): one all-reduce of (sum, sum of squares,
    count) over the default group, so uneven row shards weigh by their real
    rows. ``whole_image`` marks input that every spatial rank holds whole
    (ASPP's image-level branch, at 1x1): its statistics sum over the ranks
    of other images only (``Grid.data_group``), counting each image once.
    On a data-only grid each rank normalizes by its own images (JAX's 1-D
    mesh, a ``shard_map`` whose BatchNorm has no ``axis_name``); the train
    step averages the running statistics over the ranks afterwards
    (:func:`average_batch_stats`)."""

    def __init__(self, features: int, *, dtype: torch.dtype = DEFAULT_DTYPE,
                 whole_image: bool = False, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.dtype = dtype
        self.whole_image = whole_image

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: ones, zeros and the stats (0, 1); draws nothing."""
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def _apply(self, fn, recurse=True):
        def keep_f32(t: torch.Tensor) -> torch.Tensor:
            """``fn``'s move of ``t``, without its cast to another dtype."""
            out = fn(t)
            if t.dtype == torch.float32 and out.dtype != torch.float32:
                return t.to(out.device)
            return out

        return super()._apply(keep_f32, recurse)

    def _group(self, grid: Grid | None):
        """The ranks whose pixels the statistics cover (False: this rank's
        own; None: the default group)."""
        if grid is None or grid.spatial == 1:
            return False
        if self.whole_image:
            return False if grid.data == 1 else grid.data_group
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.training:
            mul = torch.rsqrt(self.var + BN_EPSILON) * self.scale
            return ((x.float() - self.mean) * mul + self.bias).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             BN_EPSILON,
                                             self._group(current_grid()))
        if not _FROZEN_STATS:
            m = BN_MOMENTUM
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        return y


def average_batch_stats(model: nn.Module, grid: Grid) -> None:
    """Every :class:`BatchNorm`'s running statistics averaged over the
    world, by one all-reduce: the ``lax.pmean`` of the new statistics that
    ends the JAX package's data-parallel step (``train/step.py:275``)."""
    bufs = [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.mean, m.var)]
    if not bufs or grid.world == 1:
        return
    with torch.no_grad():
        for b, s in zip(bufs, _sum_over(bufs, None)):
            b.copy_(s / grid.world)


def bn_fed_biases(model: nn.Module) -> set[str]:
    """The names of the conv biases whose output goes straight into a
    :class:`BatchNorm` (``conv{i}`` -> ``bn{i}`` in a block, ``name`` ->
    ``name_bn`` in the ASPP head). The BatchNorm subtracts the batch mean,
    so such a bias has no gradient in exact arithmetic: what a step computes
    for it is rounding noise."""
    fed = set()
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            head, _, leaf = name.rpartition(".")
            conv = (f"conv{leaf[2:]}" if leaf.startswith("bn")
                    else leaf[:-len("_bn")])
            fed.add(f"{head}.{conv}.bias" if head else f"{conv}.bias")
    return fed


class ConvBlock(nn.Module):
    """n x (3x3 conv -> [BN] -> ReLU), params ``conv0``..``conv{n-1}`` (and
    ``bn0``..``bn{n-1}`` with ``use_bn``).

    ``winograd``: ``"f2"`` / ``"f4"`` route each eligible layer through
    kernel 6, ``"f2x"`` / ``"f4x"`` through the materialized form
    (:func:`winograd_impl`); the same parameters either way. A BN block
    keeps the direct conv (conv + bias, :class:`BatchNorm`, relu), as the
    JAX package's does (``models/common.py:113-138``). Without a Winograd
    flag, or with BN, each conv runs as its module (``relu(conv(x))``, the
    arithmetic of :func:`conv3x3_bias_relu`'s direct conv), where int8
    serving and quantization-aware training find it, as the JAX block calls
    ``nn.Conv``."""

    def __init__(self, in_features: int, features: int, n_convs: int = 2, *,
                 dilation: int = 1, winograd: str | None = None,
                 use_bn: bool = False, dtype: torch.dtype = DEFAULT_DTYPE,
                 device=None):
        super().__init__()
        self.n_convs = n_convs
        self.winograd = winograd
        self.use_bn = use_bn
        for i in range(n_convs):
            self.add_module(f"conv{i}", Conv(
                in_features if i == 0 else features, features, 3,
                dilation=dilation, dtype=dtype, device=device))
            if use_bn:
                self.add_module(f"bn{i}", BatchNorm(features, dtype=dtype,
                                                    device=device))

    def convs(self) -> list[Conv]:
        return [getattr(self, f"conv{i}") for i in range(self.n_convs)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs()):
            if self.use_bn:
                x = torch.relu(getattr(self, f"bn{i}")(conv(x)))
            elif self.winograd:
                x = conv3x3_bias_relu(x, conv.weight, conv.bias, dtype=conv.dtype,
                                      dilation=conv.dilation,
                                      winograd=self.winograd)
            else:
                x = torch.relu(conv(x))
        return x


def dropout(x: torch.Tensor, rate: float, *, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(bernoulli(1 - rate), x / (1 - rate), 0)``
    in x's dtype, the mask drawn from ``generator`` (on x's device). The
    identity in eval or at rate 0; in training with rate > 0 it needs a
    generator (it never draws from the global one). Under an active grid of
    several ranks the mask is drawn at the global batch's shape (every rank
    holds the same generator state; the height is the sum of the ranks'
    rows) and each rank keeps its images and rows, so the grid step equals
    the single-process step."""
    if not training or rate == 0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit generator "
                         "(model(x, generator=g))")
    keep = 1.0 - rate
    grid = current_grid()
    if grid is None or grid.world == 1:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    else:
        n, h = x.shape[:2]
        splits = grid.level_splits(h)
        start = splits[grid.spatial_index][0]
        shape = (n * grid.data, sum(r for _, r in splits), *x.shape[2:])
        mask = (torch.rand(shape, generator=generator, device=x.device)
                [grid.images(shape[0]), start:start + h] < keep)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NHWC ``x`` resized by ``factor`` in H and W, bilinear with half-pixel
    centres and edge clamping: the JAX package's ``upsample_bilinear``
    (``jax.image.resize(..., "bilinear")``, ``models/common.py:140-144``),
    in ``x``'s dtype.

    Under an active grid that splits rows, each rank resizes its rows with
    one row of each neighbour around them (the image's own edge row at the
    image's edge, where the resize clamps), so its output rows are its share
    of the whole image's."""
    n, h, w, c = x.shape
    grid = spatial_grid()
    pad = 0
    if grid is not None:
        x = exchange_rows(x, 1, 1, grid)
        if grid.spatial_index == 0:
            x = torch.cat([x[:, 1:2], x[:, 1:]], 1)
        if grid.spatial_index == grid.spatial - 1:
            x = torch.cat([x[:, :-1], x[:, -2:-1]], 1)
        pad = factor          # one input row on each side: factor output rows
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(x.shape[1] * factor, w * factor),
                      mode="bilinear", align_corners=False)
    return y[:, :, pad:pad + h * factor].permute(0, 2, 3, 1)


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init mirroring flax's distributions, in module order, from an
    explicit generator. Returns ``module``."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
