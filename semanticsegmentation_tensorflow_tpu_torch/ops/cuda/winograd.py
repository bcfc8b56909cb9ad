"""Winograd F(2,3) / F(4,3) 3x3 SAME conv, fused: kernel 6.

The port of ``ops/pallas/winograd.py`` (``_fwd_kernel`` :146 and
``_wgrad_kernel`` :231 behind ``winograd_conv_bias_relu`` :467 and
``winograd_conv3x3`` :512). ``csrc/winograd.cu`` runs two passes: the
transformed input V = B^T d B (and, for the weight gradient, the transformed
cotangent dM) of every tile, computed once from input rows staged in shared
memory and written to a bf16 scratch, then the (m+2)^2 per-coordinate
products on wgmma, fed by TMA, with the output transform folded into the
registers so M never reaches device memory. Two wrappers on NHWC tensors,
each with a plain PyTorch version that it takes only for tensors on the CPU;
for CUDA tensors each launches its kernel or raises:

* ``winograd_fwd(x, u, b, o, variant, epilogue)``: the SAME conv of x with
  the transformed kernel u ``[a*a, Cin, Cout]``, epilogue ``"bias_relu"``
  (``relu(y + b)``) or ``"none"``. With ``o`` (the masked mode) x is a
  cotangent and loads as ``x * (o > 0)``: the input gradient of the
  bias_relu op, whose forward output is ``o``.
* ``winograd_wgrad(x, g, o, variant)``: dU ``[a*a, Cin, Cout]`` =
  sum over tiles of V^T dM (dM the A-side transform of the cotangent, masked
  by ``o > 0`` when given) and db = sum of the masked cotangent, both
  float32, summed in a fixed order (two runs give the same bits).

Numerics (the TPU kernel's): transforms in float32 in the TPU kernel's
order, V and U (and dM) rounded to x's dtype for the products, float32
sums; the bias is x's dtype, added in float32 before the relu.
``WinogradConvBiasRelu`` and ``WinogradConv3x3`` are the autograd Functions
(the ``jax.custom_vjp``s); dw = G^T dU G runs in PyTorch after the kernel,
as ``_dw_from_du`` runs in XLA. Each wrapper counts its kernel launches in
``<wrapper>.launches``. The forward is the registered torch op
``segport::winograd_fwd``: the dispatcher picks the plain version or the
launch by the tensors' device when the op runs, also inside an exported
program (``infer/export.py``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.library import (
    register_plain_autograd,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import (
    VARIANTS, combine, device_table, rot180_swap, transform_kernel,
)

EPILOGUES = ("bias_relu", "none")
_CHUNK = 32  # Cin and Cout must be multiples of this


def eligible(x_shape, w_shape, variant: str = "f2", min_ch: int = 128) -> bool:
    """Whether the fused kernel applies (``ops/pallas/winograd.py:455-464``,
    the same gate so that the same layers take it): a 3x3 kernel, H and W
    multiples of the output tile, both channel widths multiples of
    ``min_ch``. ``w_shape`` is OIHW."""
    var = VARIANTS[variant]
    _, h, w, c = x_shape
    co, ci, kh, kw = w_shape
    return (kh == 3 and kw == 3 and ci == c and h % var.m == 0
            and w % var.m == 0 and c % min_ch == 0 and co % min_ch == 0)


def u_for(w: torch.Tensor, variant: str, dtype: torch.dtype) -> torch.Tensor:
    """U ``[a*a, Cin, Cout]`` of OIHW w: transformed in float32, then cast
    to ``dtype`` (``_u_for``, ``ops/pallas/winograd.py:449``)."""
    a = VARIANTS[variant].a
    return transform_kernel(w, variant).reshape(
        a * a, w.shape[1], w.shape[0]).to(dtype)


def dw_from_du(du: torch.Tensor, w: torch.Tensor, variant: str) -> torch.Tensor:
    """dU ``[a*a, Cin, Cout]`` float32 -> dw = G^T dU G, OIHW in w's dtype."""
    var = VARIANTS[variant]
    g = device_table(var.G, du)
    du = du.reshape(var.a, var.a, du.shape[1], du.shape[2])
    return torch.einsum("ir,js,ijcf->fcrs", g, g, du).to(w.dtype)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _masked(x: torch.Tensor, o: torch.Tensor | None) -> torch.Tensor:
    if o is None:
        return x
    return torch.where(o.float() > 0, x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))


def _v_plain(x: torch.Tensor, variant: str) -> torch.Tensor:
    """V ``[a*a, N*ht*wt, C]`` float32 = B^T d B of every tile, width
    first, in the TPU kernel's order (``_width_transform``, then the rows)."""
    var = VARIANTS[variant]
    m, a, bt = var.m, var.a, var.BT
    n, h, w, c = x.shape
    ht, wt = h // m, w // m
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    rows = [[xp[:, r:r + m * ht:m, s:s + m * wt:m] for s in range(a)]
            for r in range(a)]
    tw = [[combine(bt[j], rows[r]) for j in range(a)] for r in range(a)]
    v = [combine(bt[i], [tw[r][j] for r in range(a)])
         for i in range(a) for j in range(a)]
    return torch.stack(v).reshape(a * a, n * ht * wt, c)


def winograd_fwd_plain(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor | None,
                       o: torch.Tensor | None, variant: str,
                       epilogue: str) -> torch.Tensor:
    """Plain version: x NHWC (H, W multiples of m), u ``[a*a, Cin, Cout]``,
    b ``[Cout]`` (read for ``"bias_relu"``), o x's shape or None. Returns
    NHWC in x's dtype: V and u rounded to x's dtype, float32 sums, the
    output transform and epilogue in float32."""
    var = VARIANTS[variant]
    m, a, at = var.m, var.a, var.AT
    dt = x.dtype
    n, h, w, _ = x.shape
    ht, wt = h // m, w // m
    v = _v_plain(_masked(x, o), variant).to(dt)
    mm = torch.bmm(v.float(), u.to(dt).float())
    co = mm.shape[-1]
    mm = mm.reshape(a, a, n, ht, wt, co)
    macc = [[combine(at[l], [mm[i, j] for j in range(a)]) for l in range(m)]
            for i in range(a)]
    y = torch.stack([torch.stack([combine(at[p], [macc[i][l] for i in range(a)])
                                  for l in range(m)]) for p in range(m)])
    if epilogue == "bias_relu":
        y = torch.relu(y + b.to(dt).float().view(1, 1, 1, 1, 1, -1))
    return y.permute(2, 3, 0, 4, 1, 5).reshape(n, h, w, co).to(dt)


def winograd_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                         o: torch.Tensor | None, variant: str
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the weight gradient: (dU ``[a*a, Cin, Cout]``,
    db ``[Cout]``), both float32. dz = g in x's dtype, masked by o > 0;
    dM[i,j] = sum_p AT[p,i] sum_l AT[l,j] dz[p,l] per tile; V and dM
    rounded to x's dtype, float32 sums."""
    var = VARIANTS[variant]
    m, a, at = var.m, var.a, var.AT
    dt = x.dtype
    n, h, w, _ = x.shape
    ht, wt = h // m, w // m
    dz = _masked(g.to(dt), o).float()
    co = dz.shape[-1]
    taps = dz.reshape(n, ht, m, wt, m, co)
    dmw = [[combine(at[:, j], [taps[:, :, p, :, l] for l in range(m)])
            for j in range(a)] for p in range(m)]
    dm = torch.stack([combine(at[:, i], [dmw[p][j] for p in range(m)])
                      for i in range(a) for j in range(a)])
    dm = dm.reshape(a * a, n * ht * wt, co).to(dt).float()
    v = _v_plain(x, variant).to(dt).float()
    return torch.bmm(v.transpose(1, 2), dm), dz.sum((0, 1, 2))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_device(t: torch.Tensor, what: str) -> None:
    """Raise for a device other than the CPU (the plain version) and CUDA
    (the kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {t.device}")


def _nhwc_bf16(t: torch.Tensor, name: str, shape=None) -> torch.Tensor:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"the Winograd kernels take bf16 {name}, got {t.dtype}")
    if t.dim() != 4 or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name} must be [N,H,W,C]"
                         + (f" {list(shape)}" if shape is not None else "")
                         + f", got {list(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def _check_geometry(x: torch.Tensor, co: int, variant: str) -> None:
    if variant not in ("f2", "f4"):
        raise ValueError(f"the Winograd kernel takes f2 or f4, got {variant!r}")
    m = VARIANTS[variant].m
    _, h, w, c = x.shape
    if h % m or w % m:
        raise ValueError(f"H and W must be multiples of {m} for {variant}, "
                         f"got {(h, w)}")
    if c % _CHUNK or co % _CHUNK:
        raise ValueError(f"Cin and Cout must be multiples of {_CHUNK}, got "
                         f"{(c, co)}")


def winograd_fwd(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor | None,
                 o: torch.Tensor | None, variant: str,
                 epilogue: str) -> torch.Tensor:
    """The fused forward (or, with ``o``, the masked input gradient); see
    :func:`winograd_fwd_plain`. CUDA: x (and o) bf16 NHWC, H and W
    multiples of m, Cin and Cout multiples of 32; u and b are cast to
    bf16."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    _check_device(x, "Winograd")
    return torch.ops.segport.winograd_fwd(x, u, b, o, variant, epilogue)


@torch.library.custom_op("segport::winograd_fwd", mutates_args=(),
                         device_types="cpu")
def _winograd_fwd_op(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor | None,
                     o: torch.Tensor | None, variant: str,
                     epilogue: str) -> torch.Tensor:
    return winograd_fwd_plain(x, u, b, o, variant, epilogue).contiguous()


@_winograd_fwd_op.register_kernel("cuda")
def _winograd_fwd_cuda(x, u, b, o, variant, epilogue):
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    x = _nhwc_bf16(x, "x")
    n, h, w, c = x.shape
    a2 = VARIANTS[variant].a ** 2
    if u.dim() != 3 or tuple(u.shape[:2]) != (a2, c):
        raise ValueError(f"u must be [{a2}, {c}, Cout], got {list(u.shape)}")
    co = u.shape[2]
    _check_geometry(x, co, variant)
    # the kernel reads U as [a*a][Cout][Cin]: K contiguous per output channel
    ut = u.to(torch.bfloat16).transpose(1, 2).contiguous()
    bk = None
    if epilogue == "bias_relu":
        if b is None or tuple(b.shape) != (co,):
            raise ValueError(f"bias_relu needs b [{co}]")
        bk = b.to(torch.bfloat16).contiguous()
    if o is not None:
        o = _nhwc_bf16(o, "o", x.shape)
    for t in (ut, bk, o):
        if t is not None and t.device != x.device:
            raise ValueError("x, u, b and o must be on one device")
    m = VARIANTS[variant].m
    out = torch.empty((n, h, w, co), dtype=torch.bfloat16, device=x.device)
    # V of every tile, [a*a][tiles][Cin]: the kernel's first pass writes it
    v = torch.empty((a2, n * (h // m) * (w // m), c), dtype=torch.bfloat16,
                    device=x.device)
    lib = build.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seg_winograd_fwd(
            x.data_ptr(), ut.data_ptr(), None if bk is None else bk.data_ptr(),
            None if o is None else o.data_ptr(), v.data_ptr(), out.data_ptr(), n, h,
            w, c, co, m, int(epilogue == "bias_relu"), stream)
    build.check(err, "seg_winograd_fwd")
    winograd_fwd.launches += 1
    return out


@_winograd_fwd_op.register_fake
def _(x, u, b, o, variant, epilogue):
    n, h, w, _ = x.shape
    return x.new_empty((n, h, w, u.shape[2]))


register_plain_autograd(_winograd_fwd_op, winograd_fwd_plain)


def winograd_wgrad(x: torch.Tensor, g: torch.Tensor, o: torch.Tensor | None,
                   variant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight gradient (dU, db), float32; see
    :func:`winograd_wgrad_plain`. CUDA: x bf16 NHWC as for
    :func:`winograd_fwd`, g cast to bf16, o (when given) g's shape."""
    _check_device(x, "Winograd weight gradient")
    if x.device.type == "cpu":
        return winograd_wgrad_plain(x, g, o, variant)
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    x = _nhwc_bf16(x, "x")
    n, h, w, c = x.shape
    g = _nhwc_bf16(g.to(torch.bfloat16), "g")
    if tuple(g.shape[:3]) != (n, h, w) or g.device != x.device:
        raise ValueError(f"g must be [{n},{h},{w},Cout] on {x.device}, got "
                         f"{list(g.shape)} on {g.device}")
    co = g.shape[3]
    _check_geometry(x, co, variant)
    if o is not None:
        o = _nhwc_bf16(o, "o", g.shape)
        if o.device != x.device:
            raise ValueError("x, g and o must be on one device")
    m = VARIANTS[variant].m
    a2 = VARIANTS[variant].a ** 2
    lib = build.lib()
    dev = x.device
    with torch.cuda.device(dev):
        sizes = (ctypes.c_longlong * 3)()
        build.check(lib.seg_winograd_wgrad_scratch(n, h, w, c, co, m, sizes),
                    "seg_winograd_wgrad_scratch")
        parts, db_blocks, t8 = sizes
        du = torch.empty((a2, c, co), dtype=torch.float32, device=dev)
        db = torch.empty((co,), dtype=torch.float32, device=dev)
        # V^T and dM^T of every tile ([a*a][channels][tiles], each tile row
        # padded to a multiple of 8 tiles) and the partial sums, summed in a
        # fixed order
        vt = torch.empty((a2, c, t8), dtype=torch.bfloat16, device=dev)
        dmt = torch.empty((a2, co, t8), dtype=torch.bfloat16, device=dev)
        du_part = torch.empty((parts, a2, c, co), dtype=torch.float32, device=dev)
        db_part = torch.empty((db_blocks, co), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seg_winograd_wgrad(
            x.data_ptr(), g.data_ptr(), None if o is None else o.data_ptr(),
            vt.data_ptr(), dmt.data_ptr(), du_part.data_ptr(), db_part.data_ptr(),
            parts, du.data_ptr(), db.data_ptr(), n, h, w, c, co, m, stream)
    build.check(err, "seg_winograd_wgrad")
    winograd_wgrad.launches += 1
    return du, db


winograd_fwd.launches = 0
winograd_wgrad.launches = 0


class WinogradConvBiasRelu(torch.autograd.Function):
    """``relu(conv3x3(x, w) + b)`` through kernel 6 (the ``jax.custom_vjp``
    of ``winograd_conv_bias_relu``, ``ops/pallas/winograd.py:467-509``).
    Forward saves x, w and the output; the backward casts the cotangent to
    x's dtype, runs the masked forward kernel with rot180_swap(w)'s U for
    dx and the wgrad kernel for dU and db, then dw = G^T dU G."""

    @staticmethod
    def forward(ctx, x, w, b, variant):
        dt = x.dtype
        out = winograd_fwd(x, u_for(w, variant, dt), b.to(dt), None, variant,
                           "bias_relu")
        ctx.save_for_backward(x, w, out)
        ctx.variant, ctx.b_dtype = variant, b.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        dt, v = x.dtype, ctx.variant
        g = g.to(dt)
        dx = winograd_fwd(g, u_for(rot180_swap(w), v, dt), None, out, v, "none")
        du, db = winograd_wgrad(x, g, out, v)
        return dx, dw_from_du(du, w, v), db.to(ctx.b_dtype), None


class WinogradConv3x3(torch.autograd.Function):
    """The raw ``conv3x3(x, w)`` through kernel 6 (``winograd_conv3x3``,
    ``ops/pallas/winograd.py:512-545``): the deferred-bias form of the
    pooled VGG stages."""

    @staticmethod
    def forward(ctx, x, w, variant):
        ctx.save_for_backward(x, w)
        ctx.variant = variant
        return winograd_fwd(x, u_for(w, variant, x.dtype), None, None, variant,
                            "none")

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dt, v = x.dtype, ctx.variant
        g = g.to(dt)
        dx = winograd_fwd(g, u_for(rot180_swap(w), v, dt), None, None, v, "none")
        du, _ = winograd_wgrad(x, g, None, v)
        return dx, dw_from_du(du, w, v), None


def winograd_conv_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                            variant: str = "f2") -> torch.Tensor:
    """``relu(SAME-conv3x3(x, w) + b)`` through kernel 6: x NHWC, w OIHW
    (the canonical parameters), b ``[Cout]``; x's dtype out."""
    return WinogradConvBiasRelu.apply(x, w, b, variant)


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor,
                     variant: str = "f2") -> torch.Tensor:
    """The raw ``SAME-conv3x3(x, w)`` through kernel 6; x's dtype out."""
    return WinogradConv3x3.apply(x, w, variant)
