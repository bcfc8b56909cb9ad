"""How a conv of the models runs, decided from its shape and the active
grid: :func:`conv_nhwc` (the stride-1 conv, with halo rows under a grid
that splits rows and a dilated conv in the form :func:`dilated_form` picks
for each pass), :func:`conv3x3_bias_relu` and :func:`conv3x3_raw` (the
Winograd routing of :func:`winograd_impl`), and :func:`fill_init`, flax's
initial kernels.

Conv inputs and kernels are cast to the compute dtype (bf16 by default)
and accumulate in f32. Activations are NHWC; the convs run on NCHW views
of them, which for contiguous NHWC tensors are ``torch.channels_last``
memory.
"""

from __future__ import annotations

import collections
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.winograd import (
    eligible, winograd_conv3x3, winograd_conv_bias_relu,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import (
    VARIANTS, winograd_conv2d, xla_eligible,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import exchange_rows
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import spatial_grid

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
    dilated conv on a fine grid) takes rows from the ranks beyond. A dilated
    conv runs each pass in the form :func:`dilated_form` picks: by
    :class:`DilatedConv` where a backward will follow, else by
    :func:`dilated_forward`."""
    x = x.to(dtype)
    rows = x.shape[1]
    grid = spatial_grid()
    pad_h = padding
    if grid is not None and padding:
        x = exchange_rows(x, padding, padding, grid)
        pad_h = 0
    kernel = kernel.to(dtype)
    if dilation == 1:
        y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=(pad_h, padding))
        return y.permute(0, 2, 3, 1)
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return DilatedConv.apply(x, kernel, rows, pad_h, padding, dilation)
    return dilated_forward(x, kernel, rows, pad_h, padding, dilation)


# the dilated convs' passes as they ran, by (pass, form): dilated_form's
# picks, counted on the host when a pass is issued
DILATED_PASSES: collections.Counter = collections.Counter()


# ASPP's rates above 6 (DeepLab-ASPP, 512 -> 256) and ASPP-L's (DeepLab-v2,
# 512 -> 1024), the dilations _PHASES_AT was measured at for those widths
_ASPP, _ASPP_L = (12, 18), (12, 18, 24)

# Where a pass of a dilated conv runs by phases, by (pass, kernel size, Cin,
# Cout, input rows): the dilations measured there and the batches, as
# (first, last) ranges, that run by phases at them. Fitted to every pass of
# DeepLab-ASPP's and DeepLab-v2's dilated convs at KITTI's inference rows
# (47 at output stride 8, 24 at 16) and training rows (40, 20), batches
# 1-16, timed in both forms on an H100 with cuDNN 9.2
# (tools/dilated_convs.py; PERF.md). cuDNN's heuristics send its dilated
# conv, by batch and differently for each pass, either to fast kernels or
# to one 3-1000x slower; the undilated convs by phases never met the slow
# one. Where the forms were within 10 % the pick is the one before the
# per-pass rule. A shape or dilation not listed: dilated_form's general
# cases.
_PHASES_AT = {
    ("forward", 3, 512, 256, 20): (_ASPP, ((3, 3),)),
    ("input_grad", 7, 512, 512, 47): ((4,), ((2, 2),)),
    ("input_grad", 7, 512, 512, 40): ((4,), ((1, 8),)),
    ("input_grad", 7, 512, 512, 24): ((2,), ((2, 2), (4, 4), (8, 8), (12, math.inf))),
    ("input_grad", 7, 512, 512, 20): ((2,), ((1, 2), (4, 4), (6, 6), (8, math.inf))),
    ("input_grad", 3, 512, 1024, 47): (_ASPP_L, ((2, 6),)),
    ("input_grad", 3, 512, 1024, 40): (_ASPP_L, ((1, 8),)),
    ("input_grad", 3, 512, 256, 47): (_ASPP, ((3, 6),)),
    ("input_grad", 3, 512, 256, 40): (_ASPP, ()),
    ("input_grad", 3, 512, 256, 24): (_ASPP, ((1, 1), (5, 5))),
    ("weight_grad", 7, 512, 512, 24): ((2,), ((1, 1), (3, 4))),
    ("weight_grad", 7, 512, 512, 20): ((2,), ((1, 2), (4, 4))),
    ("weight_grad", 3, 512, 1024, 47): (_ASPP_L, ((1, 9), (11, math.inf))),
    ("weight_grad", 3, 512, 1024, 40): (_ASPP_L, ((1, 11), (13, math.inf))),
    ("weight_grad", 3, 512, 256, 47): (_ASPP, ((2, 6),)),
    ("weight_grad", 3, 512, 256, 40): (_ASPP, ((3, 6),)),
    ("weight_grad", 3, 512, 256, 24): (_ASPP, ((8, math.inf),)),
    ("weight_grad", 3, 512, 256, 20): (_ASPP, ((12, math.inf),)),
}


def dilated_form(pass_: str, batch: int, rows: int, kernel_shape,
                 dilation: int) -> str:
    """The form in which a pass of a dilated conv runs: ``"direct"``
    (cuDNN's dilated conv) or ``"phases"`` (the same products as d x d
    undilated convs, :func:`conv_by_phases`, :func:`dilated_backward`).
    ``pass_``: ``"forward"``, ``"input_grad"`` or ``"weight_grad"``;
    ``rows``: the input rows this rank convolves; ``kernel_shape``: OIHW.
    Depends on the shape alone: a 3x3 at a dilation up to 6 runs direct;
    otherwise the batches :data:`_PHASES_AT` lists for the shape and the
    dilation run by phases, and for those it does not list a 7x7's forward
    where batch x rows is at most 40 x the dilation, its gradients up to a
    batch of 4, a 3x3's forward and weight gradient at 1024 or more output
    channels, and a 3x3's passes at a batch of one whose dilated window
    fits in the rows."""
    cout, cin, k = kernel_shape[0], kernel_shape[1], kernel_shape[-1]
    if k <= 3 and dilation <= 6:
        return "direct"
    dilations, spans = _PHASES_AT.get((pass_, k, cin, cout, rows), ((), ()))
    if dilation in dilations:
        phases = any(lo <= batch <= hi for lo, hi in spans)
    elif k > 3:
        phases = (batch * rows <= 40 * dilation if pass_ == "forward"
                  else batch <= 4)
    elif cout >= 1024 and pass_ != "input_grad":
        phases = True
    else:
        phases = batch == 1 and dilation * (k - 1) + 1 <= rows
    return "phases" if phases else "direct"


def dilated_forward(x: torch.Tensor, kernel: torch.Tensor, rows: int, pad_h: int,
                    pad_w: int, dilation: int) -> torch.Tensor:
    """The forward of :func:`conv_nhwc` at ``dilation`` > 1 in the form
    :func:`dilated_form` picks (``rows``: the rows before a halo exchange),
    counted in :data:`DILATED_PASSES`. NHWC in and out."""
    form = dilated_form("forward", x.shape[0], rows, kernel.shape, dilation)
    DILATED_PASSES["forward", form] += 1
    if form == "phases":
        return conv_by_phases(x, kernel, pad_h, pad_w, dilation)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=(pad_h, pad_w),
                 dilation=dilation)
    return y.permute(0, 2, 3, 1)


def _to_phases(x: torch.Tensor, d: int) -> torch.Tensor:
    """Space to batch: NHWC [n, h, w, c] with h and w multiples of ``d`` ->
    [n * d * d, h / d, w / d, c], image-major, then the phase (i mod d,
    j mod d)."""
    n, h, w, c = x.shape
    return (x.reshape(n, h // d, d, w // d, d, c).permute(0, 2, 4, 1, 3, 5)
            .reshape(n * d * d, h // d, w // d, c))


def _from_phases(y: torch.Tensor, d: int) -> torch.Tensor:
    """Batch to space, the inverse of :func:`_to_phases`."""
    m, h, w, c = y.shape
    return (y.reshape(m // (d * d), d, d, h, w, c).permute(0, 3, 1, 4, 2, 5)
            .reshape(m // (d * d), h * d, w * d, c))


def _phase_size(size: int, pad: int, d: int) -> int:
    """``size`` padded by ``pad`` on each side, up to a multiple of ``d``."""
    return -(-(size + 2 * pad) // d) * d


def _phase_pad(x: torch.Tensor, pad_h: int, pad_w: int, d: int) -> torch.Tensor:
    """NHWC ``x`` zero-padded by ``pad_h`` rows and ``pad_w`` columns before,
    and after up to :func:`_phase_size`."""
    h, w = x.shape[1:3]
    hp, wp = _phase_size(h, pad_h, d), _phase_size(w, pad_w, d)
    return F.pad(x, (0, 0, pad_w, wp - w - pad_w, pad_h, hp - h - pad_h))


def conv_by_phases(x: torch.Tensor, kernel: torch.Tensor, pad_h: int, pad_w: int,
                   dilation: int) -> torch.Tensor:
    """A stride-1 conv of NHWC ``x`` with OIHW ``kernel`` at ``dilation`` d,
    zero-padded by ``pad_h`` rows and ``pad_w`` columns on each side, as d x d
    undilated convs, one for each phase (i mod d, j mod d) of the output:
    TensorFlow's ``atrous_conv2d`` form (space to batch, conv, batch to
    space). The same products as the dilated conv; NHWC out, in ``x``'s
    dtype."""
    d = dilation
    h, w = x.shape[1:3]
    kh, kw = kernel.shape[2:]
    ho, wo = h + 2 * pad_h - d * (kh - 1), w + 2 * pad_w - d * (kw - 1)
    x = _to_phases(_phase_pad(x, pad_h, pad_w, d), d)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel)
    return _from_phases(y.permute(0, 2, 3, 1), d)[:, :ho, :wo]


def dilated_backward(form: str, x: torch.Tensor, kernel: torch.Tensor,
                     dy: torch.Tensor, pad_h: int, pad_w: int, dilation: int,
                     mask) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(input gradient, weight gradient) of :func:`conv_nhwc`'s dilated
    conv of NHWC ``x`` with OIHW ``kernel`` for the NHWC output gradient
    ``dy``, each computed where ``mask`` (input, weight) asks, in ``form``;
    None for the other. ``"direct"``: one ``aten.convolution_backward`` at
    the dilation. ``"phases"``: ``dy`` (zero below and right of the output,
    up to the phases' grid) and, for the weight gradient, the padded ``x``
    go to their phases once (:func:`_to_phases`), one undilated
    ``aten.convolution_backward`` runs over them, and the input gradient
    comes back by batch to space, cropped to ``x``. In the dtype of the
    tensors, as autograd's conv backward."""
    d = dilation
    if form == "direct":
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), kernel, None, [1, 1],
            [pad_h, pad_w], [d, d], False, [0, 0], 1, [mask[0], mask[1], False])
        return (None if dx is None else dx.permute(0, 2, 3, 1)), dw
    n, h, w, c = x.shape
    kh, kw = kernel.shape[2:]
    hp, wp = _phase_size(h, pad_h, d), _phase_size(w, pad_w, d)
    hq, wq = hp // d - (kh - 1), wp // d - (kw - 1)
    dy = F.pad(dy, (0, 0, 0, wq * d - dy.shape[2], 0, hq * d - dy.shape[1]))
    dy = _to_phases(dy, d).permute(0, 3, 1, 2)
    if mask[1]:
        xp = _to_phases(_phase_pad(x, pad_h, pad_w, d), d).permute(0, 3, 1, 2)
    else:   # the input gradient reads the input's shape alone
        xp = torch.empty((n * d * d, c, hp // d, wp // d), dtype=x.dtype,
                         device=x.device, memory_format=torch.channels_last)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy, xp, kernel, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
        [mask[0], mask[1], False])
    if dx is not None:
        dx = _from_phases(dx.permute(0, 2, 3, 1), d)[:, pad_h:pad_h + h,
                                                   pad_w:pad_w + w]
    return dx, dw


class DilatedConv(torch.autograd.Function):
    """:func:`conv_nhwc`'s dilated conv where a backward follows:
    ``apply(x, kernel, rows, pad_h, pad_w, dilation)``, NHWC ``x`` and OIHW
    ``kernel`` in the compute dtype. The forward runs in the form
    :func:`dilated_form` picks for it (:func:`dilated_forward`) and saves
    ``x`` and ``kernel``; the backward computes the gradients asked for
    alone, each in the form picked for its pass (one
    :func:`dilated_backward` a form), counted in :data:`DILATED_PASSES`."""

    @staticmethod
    def forward(ctx, x, kernel, rows, pad_h, pad_w, dilation):
        ctx.save_for_backward(x, kernel)
        ctx.geometry = (rows, pad_h, pad_w, dilation)
        return dilated_forward(x, kernel, rows, pad_h, pad_w, dilation)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        rows, pad_h, pad_w, dilation = ctx.geometry
        masks: dict[str, list[bool]] = {}
        for i, pass_ in enumerate(("input_grad", "weight_grad")):
            if ctx.needs_input_grad[i]:
                form = dilated_form(pass_, x.shape[0], rows, kernel.shape, dilation)
                DILATED_PASSES[pass_, form] += 1
                masks.setdefault(form, [False, False])[i] = True
        grads = [None, None]
        for form, mask in masks.items():
            for i, g in enumerate(dilated_backward(form, x, kernel, dy, pad_h,
                                                   pad_w, dilation, mask)):
                if mask[i]:
                    grads[i] = g
        return (*grads, None, None, None, None)


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
        return winograd_conv2d(x, kernel, bias, winograd[:-1], True)
    if impl == "kernel":
        return winograd_conv_bias_relu(x, kernel, bias, winograd)
    z = conv_nhwc(x, kernel, dtype=dtype, padding=dilation, dilation=dilation)
    return torch.relu(z + bias.to(dtype))


def conv3x3_raw(x: torch.Tensor, conv: nn.Module,
                winograd: str | None = None) -> torch.Tensor:
    """``conv``'s (a ``models.common.Conv``) 3x3 SAME conv without its
    bias, in its compute dtype, through the Winograd form
    :func:`winograd_impl` routes it to (the raw kernel form, or the
    materialized one with a zero bias and no relu)."""
    x = x.to(conv.dtype)
    impl = winograd_impl(x.shape, conv.weight.shape, winograd, conv.dilation)
    if impl == "materialized":
        zero = torch.zeros(conv.weight.shape[0], device=x.device)
        return winograd_conv2d(x, conv.weight, zero, winograd[:-1], False)
    if impl == "kernel":
        return winograd_conv3x3(x, conv.weight, winograd)
    return conv.conv(x)
