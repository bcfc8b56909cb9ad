"""The numerical core of symmetric int8 quantization (counterpart of the
JAX package's ``infer/quant.py`` ``quantize_kernel``, ``_quantized_conv``
and the fake-quant forward of ``make_fake_quant_apply``).

* Weights: per output channel, ``s = amax / 127`` in float32 (1 where the
  channel is all zero), ``q = clip(round(w / s), -127, 127)`` in int8;
  ``torch.round`` rounds half to even, as ``jnp.round`` does. A conv's OIHW
  weight reduces over dims 1-3, a transposed conv's [Cin, Cout, kh, kw]
  over dims 0, 2 and 3.
* Activations: per tensor, ``q = clip(round(x * (1 / s)), -127, 127)`` at a
  calibrated scale ``s``, the reciprocal rounded once to float32 (the JAX
  package multiplies by a weakly typed Python float).
* The product: int8 x int8 summed in int32, exactly: a GEMM of the patch
  matrix by the kernel matrix through ``torch._int_mm`` (cuBLASLt on the
  card, an exact integer GEMM on the CPU). A conv builds the SAME-padded
  patches (``as_strided`` on the int8 input, split over rows where the
  matrix would pass ``PATCH_BYTES``); a transposed conv multiplies the
  undilated input by every tap at once and adds the taps' blocks into the
  output (the same integer sums as ``lax.conv_transpose`` over the input
  dilated by its stride). No TPU kernel stands behind this product: the
  JAX package computes it with XLA's conv.
* The rescale: ``y32 * (kscale * s)`` in float32, plus the float32 bias,
  one rounding to the module's dtype. Without an activation scale (weight
  only): the dequantized kernel ``(q * kscale)`` in the compute dtype, the
  conv in that dtype, then the float32 bias and one more rounding.

:class:`QuantConv` and :class:`QuantConvTranspose` are the modules that
``infer.quant.quantize_model`` puts in place of the model's convs; their
``weight`` (int8, the port's layout), ``weight_scale`` and ``bias`` (float32)
are buffers that stay float32 when the model is cast (``Module.to``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.ops.conv import conv_nhwc

QMAX = 127
# the largest int8 patch matrix built in one piece (bytes)
PATCH_BYTES = 1 << 30


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _channel_shape(transposed: bool) -> tuple[int, ...]:
    return (1, -1, 1, 1) if transposed else (-1, 1, 1, 1)


def quantize_kernel(weight: torch.Tensor, transposed: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a conv weight (OIHW, or a
    transposed conv's [Cin, Cout, kh, kw]): ``(q int8 of the same layout,
    scale [Cout] float32)``, ``q * scale ~= weight``. Divisions are tensor
    by tensor (IEEE), never a multiply by a reciprocal."""
    wf = weight.detach().float()
    amax = wf.abs().amax((0, 2, 3) if transposed else (1, 2, 3))
    s = amax / torch.full_like(amax, float(QMAX))
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(wf / s.view(_channel_shape(transposed))),
                    -QMAX, QMAX)
    return q.to(torch.int8), s


def _recip(scale: float, device) -> torch.Tensor:
    """``1 / scale`` as the JAX package multiplies by it: the Python float
    quotient rounded once to float32."""
    return torch.tensor(1.0 / scale, dtype=torch.float32, device=device)


def quantize_act(x: torch.Tensor, scale: float,
                 recip: torch.Tensor | None = None) -> torch.Tensor:
    """Per-tensor symmetric int8 of ``x`` at ``scale``; ``recip``, where
    given, is ``_recip(scale)`` already on ``x``'s device (a quantized
    module's buffer: no copy from the host a call)."""
    q = torch.round(x.float() * (_recip(scale, x.device) if recip is None
                                 else recip))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def int8_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b_t [N, K]^T`` of int8 matrices in int32, exact (K and
    N multiples of 8; ``b_t`` goes to ``torch._int_mm`` column-major). The
    card's GEMM needs more than 16 rows: fewer are padded with zero rows."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros(32 - m, a.shape[1])])
    return torch._int_mm(a, b_t.t())[:m]


def _kernel_matrix(w: torch.Tensor, rows: int, k: int) -> torch.Tensor:
    """[rows, k] int8 ``w`` zero-padded to multiples of 8 in both dims."""
    out = w.new_zeros(_round8(rows), _round8(k))
    out[:rows, :k] = w
    return out


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, dilation: int = 1,
                patch_bytes: int = PATCH_BYTES) -> torch.Tensor:
    """The stride-1 SAME conv of NHWC int8 ``xq`` by OIHW int8 ``wq`` at
    ``dilation``, zero-padded in the int8 domain (flax's SAME: the low side
    gets the smaller half), summed exactly in int32. NHWC int32 out."""
    n, h, w, c = xq.shape
    o, ci, kh, kw = wq.shape
    if ci != c:
        raise ValueError(f"input has {c} channels, the kernel {ci}")
    k = kh * kw * c
    b_t = _kernel_matrix(wq.permute(0, 2, 3, 1).reshape(o, k), o, k)
    kp = b_t.shape[1]
    if kh == kw == 1 and kp == k:
        y = int8_mm(xq.contiguous().view(n * h * w, c), b_t)
        return y[:, :o].view(n, h, w, o)
    th, tw = dilation * (kh - 1), dilation * (kw - 1)
    xp = xq.new_zeros(n, h + th, w + tw, c)
    xp[:, th // 2:th // 2 + h, tw // 2:tw // 2 + w] = xq
    # the patches move as 8-byte words where the channels allow it
    word = torch.int64 if c % 8 == 0 else torch.int8
    unit = 8 if word is torch.int64 else 1
    src_all = xp.view(word)
    s_n, s_h, s_w, s_c = src_all.stride()
    out = torch.empty(n, h, w, b_t.shape[0], dtype=torch.int32, device=xq.device)

    def gemm(src, rows, img, dst):
        patches = src.as_strided((img, rows, w, kh, kw, c // unit),
                                 (s_n, s_h, s_w, dilation * s_h, dilation * s_w, s_c))
        a = xq.new_empty(img * rows * w, kp)
        if kp > k:
            a[:, k:].zero_()
        a.view(word)[:, :k // unit].view(img, rows, w, kh, kw, c // unit).copy_(patches)
        dst.copy_(int8_mm(a, b_t).view(img, rows, w, -1))

    if n * h * w * kp <= patch_bytes:
        gemm(src_all, h, n, out)
    else:
        step = max(1, patch_bytes // (w * kp))
        for i in range(n):
            for r0 in range(0, h, step):
                r = min(step, h - r0)
                gemm(src_all[i:i + 1, r0:], r, 1, out[i:i + 1, r0:r0 + r])
    return out[..., :o]


def transpose_padding(k: int, s: int) -> int:
    """The low padding of flax's SAME transposed conv (``lax.conv_transpose``
    over the input dilated by ``s``) as PyTorch's ``conv_transpose2d``
    padding: ``k - 1 - pad_low``."""
    pad_len = k + s - 2
    pad_lo = k - 1 if s > k - 1 else -(-pad_len // 2)
    return k - 1 - pad_lo


def int8_conv_transpose2d(xq: torch.Tensor, wq: torch.Tensor, stride: int
                          ) -> torch.Tensor:
    """flax's SAME ``ConvTranspose`` (stride ``stride``, kernel the stride or
    twice it) of NHWC int8 ``xq`` by the port's int8 weight ``wq`` [Cin,
    Cout, k, k] (flipped, as ``F.conv_transpose2d`` takes it), summed exactly
    in int32: one GEMM of the input by every tap, then each tap's block added
    at its offset. NHWC int32 [N, H*s, W*s, Cout] out."""
    n, h, w, c = xq.shape
    ci, o, k, _ = wq.shape
    s = stride
    m = k // s
    if ci != c or k % s or m not in (1, 2):
        raise ValueError(f"transposed conv of kernel {k} at stride {s} on {c} "
                         f"channels (weight {tuple(wq.shape)})")
    cols = k * k * o
    b_t = _kernel_matrix(wq.permute(2, 3, 1, 0).reshape(cols, c), cols, c)
    a = xq.contiguous().view(n * h * w, c)
    if b_t.shape[1] > c:
        a = torch.cat([a, a.new_zeros(a.shape[0], b_t.shape[1] - c)], 1)
    taps = int8_mm(a, b_t)[:, :cols].view(n, h, w, m, s, m, s, o)
    blocks = torch.zeros(n, h + m - 1, s, w + m - 1, s, o, dtype=torch.int32,
                         device=xq.device)
    for bh in range(m):
        for bw in range(m):
            blocks[:, bh:bh + h, :, bw:bw + w] += taps[:, :, :, bh, :, bw].permute(
                0, 1, 3, 2, 4, 5)
    off = transpose_padding(k, s)
    full = blocks.view(n, (h + m - 1) * s, (w + m - 1) * s, o)
    return full[:, off:off + h * s, off:off + w * s]


def rescale(y32: torch.Tensor, weight_scale: torch.Tensor,
            act_scale: float | torch.Tensor, bias: torch.Tensor | None,
            dtype: torch.dtype) -> torch.Tensor:
    """``y32 * (kscale * s) + bias`` in float32, rounded once to ``dtype``;
    ``act_scale`` a float or, copied from the host once, a float32 tensor
    on ``weight_scale``'s device."""
    mul = weight_scale * torch.as_tensor(act_scale, dtype=torch.float32,
                                         device=weight_scale.device)
    y = y32.float() * mul
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through: the value of ``x + (q - x)``, the gradient of ``x``."""
    return x + (q - x).detach()


def fake_quant_weight(weight: torch.Tensor, transposed: bool = False
                      ) -> torch.Tensor:
    """The live float32 weight on its per-channel int8 grid (recomputed
    each call), with a straight-through gradient."""
    k = weight.float()
    q, s = quantize_kernel(k, transposed)
    return _ste(k, q.float() * s.view(_channel_shape(transposed)))


def fake_quant_act(x: torch.Tensor, scale: float | None) -> torch.Tensor:
    """``x`` on its per-tensor int8 grid at ``scale`` (float32, with a
    straight-through gradient); ``x`` itself where there is no scale."""
    if scale is None:
        return x
    xf = x.float()
    q = torch.clamp(torch.round(xf * _recip(scale, x.device)), -QMAX, QMAX)
    return _ste(xf, q * torch.tensor(scale, dtype=torch.float32, device=x.device))


class _QuantBase(nn.Module):
    """The buffers and dtype policy of a quantized conv."""

    transposed = False

    def __init__(self, conv: nn.Module, act_scale: float | None):
        super().__init__()
        q, s = quantize_kernel(conv.weight, self.transposed)
        self.register_buffer("weight", q)
        self.register_buffer("weight_scale", s)
        self.register_buffer("bias", conv.bias.detach().float().clone())
        self.dtype = conv.dtype
        self.act_scale = act_scale
        if act_scale is not None:
            # the integer product's per-call constants, moved with the
            # module, so a forward copies nothing from the host
            self.register_buffer("act_scale32", torch.tensor(
                act_scale, dtype=torch.float32), persistent=False)
            self.register_buffer("act_recip32", _recip(act_scale, "cpu"),
                                 persistent=False)

    def _apply(self, fn, recurse=True):
        def keep_f32(t: torch.Tensor) -> torch.Tensor:
            """``fn``'s move of ``t``, without its cast to another dtype."""
            out = fn(t)
            if t.dtype == torch.float32 and out.dtype != torch.float32:
                return t.to(out.device)
            return out

        return super()._apply(keep_f32, recurse)

    def dequantized(self) -> torch.Tensor:
        """``q * kscale`` in the compute dtype (the weight-only form)."""
        s = self.weight_scale.view(_channel_shape(self.transposed))
        return (self.weight.float() * s).to(self.dtype)


class QuantConv(_QuantBase):
    """A ``models.common.Conv`` with int8 weights: the integer product at
    ``act_scale``, or weight-only where it is None (module docstring)."""

    def __init__(self, conv: nn.Module, act_scale: float | None = None):
        super().__init__(conv, act_scale)
        self.dilation = conv.dilation
        self.padding = conv.padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_scale is None:
            y = conv_nhwc(x, self.dequantized(), dtype=self.dtype,
                          padding=self.padding, dilation=self.dilation).float()
            return (y + self.bias.float()).to(self.dtype)
        xq = quantize_act(x, self.act_scale, self.act_recip32)
        y32 = int8_conv2d(xq, self.weight, self.dilation)
        return rescale(y32, self.weight_scale, self.act_scale32, self.bias,
                       self.dtype)


class QuantConvTranspose(_QuantBase):
    """An ``ops.fast_upsample.ConvTranspose`` with int8 weights (module
    docstring)."""

    transposed = True

    def __init__(self, conv: nn.Module, act_scale: float | None = None):
        super().__init__(conv, act_scale)
        self.stride = conv.stride
        self.kernel_size = conv.kernel_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act_scale is None:
            y = F.conv_transpose2d(
                x.to(self.dtype).permute(0, 3, 1, 2), self.dequantized(),
                stride=self.stride,
                padding=transpose_padding(self.kernel_size, self.stride))
            y = y.permute(0, 2, 3, 1).float()
            return (y + self.bias.float()).to(self.dtype)
        xq = quantize_act(x, self.act_scale, self.act_recip32)
        y32 = int8_conv_transpose2d(xq, self.weight, self.stride)
        return rescale(y32, self.weight_scale, self.act_scale32, self.bias,
                       self.dtype)
