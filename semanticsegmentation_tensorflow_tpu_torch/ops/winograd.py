"""Winograd fast convolution for 3x3 SAME convs (counterpart of the JAX
package's ``ops/winograd.py``): the transform tables, the reference, and
two materialized forms in plain PyTorch.

Winograd F(m,3) computes each m x m output tile of a 3x3 conv as

    Y = A^T [ (G g G^T) (.) (B^T d B) ] A        per m x m tile,

d the (m+2) x (m+2) input tile, g the 3x3 kernel; with channels the
elementwise product becomes one [tiles, Cin] @ [Cin, Cout] contraction per
Winograd coordinate, (m+2)^2 of them. ``f2`` (points {0, +-1}) does 2.25x
fewer multiplies than the direct conv and rounds like it; ``f4`` (points
{0, -1, 1, 1/2, -2}) 4x fewer, at 5.6-7.3x the direct conv's bf16 error.

Numerics, as in the JAX package: transforms in float32, only the
contraction in bf16 with float32 sums. Layouts: activations NHWC,
kernels the port's OIHW ``[Cout, Cin, r, r]``; ``U`` is ``[a, a, Cin,
Cout]`` (the JAX package's order, so the tests compare like with like).

* :func:`winograd_conv2d_ref`: the oracle (einsums, optionally bf16
  contraction).
* :func:`winograd_conv2d`: the materialized "x" form (``winograd="f2x"``):
  V and M stored in bf16, one batched product per coordinate, with the JAX
  custom VJP's backward (dx through the rotated kernel, dU = V^T dM, dw =
  G^T dU G).
* :func:`winograd_conv_large`: fc6's 7x7 through F(3,3) blocks on one tile
  grid (``winograd_fc6``), the per-coordinate tile conv one grouped
  ``F.conv2d``.

The fused kernel form (kernel 6) is ``ops/cuda/winograd.py``. Imports
nothing of JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

R = 3  # default kernel size (VGG 3x3 stacks)


class WinogradVariant(NamedTuple):
    name: str
    m: int                # output tile
    r: int                # kernel size
    a: int                # input tile = m + r - 1
    BT: np.ndarray        # [a, a] input transform (d -> B^T d B)
    G: np.ndarray         # [a, r] kernel transform (g -> G g G^T)
    AT: np.ndarray        # [m, a] output transform (M -> A^T M A)


def _toom_cook(points: list[float], m: int, r: int = R) -> WinogradVariant:
    """F(m,r) matrices from m+r-2 finite interpolation points (the last is
    infinity): A^T and G from Vandermonde rows, B^T solved exactly from
    A^T[(G e_l) (.) (B^T e_k)] = conv(e_k, e_l), snapped to dyadic
    rationals and checked."""
    n = m + r - 1
    assert len(points) == n - 1
    at = np.zeros((m, n))
    for i in range(m):
        for j, p in enumerate(points):
            at[i, j] = p ** i
    at[m - 1, n - 1] = 1.0
    g = np.zeros((n, r))
    for j, p in enumerate(points):
        norm = np.prod([p - q for q in points if q != p])
        g[j] = [p ** i for i in range(r)]
        g[j] /= norm
    g[n - 1] = [0.0] * (r - 1) + [1.0]
    bt = np.zeros((n, n))
    for k in range(n):
        rows, rhs = [], []
        for i in range(m):
            for l in range(r):
                rows.append(at[i] * g[:, l])
                rhs.append(1.0 if k == i + l else 0.0)
        sol, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(rhs), rcond=None)
        bt[:, k] = sol
    for s in (6, 8, 10, 12):
        snapped = np.round(bt * 2 ** s) / 2 ** s
        if np.allclose(snapped, bt, atol=1e-9):
            bt = snapped
            break
    for k in range(n):
        for i in range(m):
            for l in range(r):
                want = 1.0 if k == i + l else 0.0
                got = float(np.sum(at[i] * g[:, l] * bt[:, k]))
                assert abs(got - want) < 1e-6, (points, m, k, i, l, got)
    name = f"f{m}" if r == R else f"f{m}r{r}"
    return WinogradVariant(name, m, r, n, bt.astype(np.float32),
                           g.astype(np.float32), at.astype(np.float32))


F2 = _toom_cook([0.0, 1.0, -1.0], m=2)
# fc6's building block: m = 3 equals the 3-row offsets of the 7x7's blocks
F3 = _toom_cook([1.0, -1.0, 0.5, -0.5], m=3)
F4 = _toom_cook([0.0, -1.0, 1.0, 0.5, -2.0], m=4)
F2R7 = _toom_cook([0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0], m=2, r=7)

VARIANTS: dict[str, WinogradVariant] = {
    "f2": F2, "f3": F3, "f4": F4, "f2r7": F2R7,
}


_DEVICE_TABLES: dict = {}


def device_table(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``table`` as a float32 tensor on ``like``'s device, copied there
    once per device: a copy from host memory on every call would make the
    host wait for the device each time. Do not modify the result."""
    key = (table.shape, table.tobytes(), like.device)
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = _DEVICE_TABLES[key] = torch.as_tensor(table, dtype=torch.float32,
                                                  device=like.device)
    return t


def combine(coeffs, tensors):
    """``sum_i coeffs[i] * tensors[i]`` in float32, in order, skipping the
    structural zeros and taking +-1 as a sign (the TPU kernel's
    ``_combine``, so the transforms round as there)."""
    acc = None
    for c, t in zip(coeffs, tensors):
        c = float(c)
        if c == 0.0:
            continue
        term = t if c == 1.0 else (-t if c == -1.0 else c * t)
        acc = term if acc is None else acc + term
    assert acc is not None
    return acc


def transform_kernel(w: torch.Tensor, variant: str = "f2") -> torch.Tensor:
    """OIHW ``[Cout, Cin, r, r]`` -> U ``[a, a, Cin, Cout]`` = G w G^T,
    float32."""
    g = device_table(VARIANTS[variant].G, w)
    return torch.einsum("ir,js,cdrs->ijdc", g, g, w.float())


def rot180_swap(w: torch.Tensor) -> torch.Tensor:
    """OIHW kernel -> the kernel whose SAME conv computes the input
    gradient of w's SAME conv: spatially flipped, in/out channels swapped
    (exact for odd r)."""
    return w.flip((2, 3)).transpose(0, 1)


def _tile_input(x: torch.Tensor, ht: int, wt: int, m: int, a: int) -> torch.Tensor:
    """Padded NHWC -> overlapping a x a tiles d ``[a, a, N, ht, wt, C]``."""
    return torch.stack([torch.stack([x[:, r:r + m * ht:m, s:s + m * wt:m]
                                     for s in range(a)]) for r in range(a)])


def _pad_nhwc(x: torch.Tensor, top: int, bottom: int, left: int,
              right: int) -> torch.Tensor:
    return F.pad(x, (0, 0, left, right, top, bottom))


def winograd_conv2d_ref(x: torch.Tensor, w: torch.Tensor, variant: str = "f2",
                        mxu_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Reference Winograd F(m,r) SAME conv, NHWC, stride 1, float32 out.
    The contraction runs in ``mxu_dtype`` (None: float32) with float32
    sums; exact up to summation order."""
    var = VARIANTS[variant]
    m, a, r = var.m, var.a, var.r
    n, h, wd, c = x.shape
    assert tuple(w.shape[2:]) == (r, r) and w.shape[1] == c
    co = w.shape[0]
    ht, wt = -(-h // m), -(-wd // m)
    p0 = r // 2
    xp = _pad_nhwc(x.float(), p0, p0 + m * ht - h, p0, p0 + m * wt - wd)
    d = _tile_input(xp, ht, wt, m, a)
    bt = device_table(var.BT, x)
    v = torch.einsum("ir,js,rsnhwc->ijnhwc", bt, bt, d)
    u = transform_kernel(w, variant)
    if mxu_dtype is not None:
        v, u = v.to(mxu_dtype).float(), u.to(mxu_dtype).float()
    mm = torch.einsum("ijnhwc,ijco->ijnhwo", v, u)
    at = device_table(var.AT, x)
    y = torch.einsum("pi,lj,ijnhwo->nhpwlo", at, at, mm)
    return y.reshape(n, m * ht, m * wt, co)[:, :h, :wd]


def _bmm_bf16(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype
              ) -> torch.Tensor:
    """Batched product of bf16 operands with float32 sums, in ``out_dtype``
    (the JAX package's ``dot_general(..., preferred_element_type=f32)``).
    The bf16 values are exact in float32 (and in TF32), so the products
    are exact on every device."""
    return torch.bmm(a.float(), b.float()).to(out_dtype)


# ---------------------------------------------------------------------------
# the materialized "x" form
# ---------------------------------------------------------------------------

def _pad_to_tiles(x: torch.Tensor, m: int, r: int) -> torch.Tensor:
    """SAME halo (r//2 each side) plus zero fill up to whole m x m tiles."""
    n, h, wd, c = x.shape
    ht, wt = -(-h // m), -(-wd // m)
    p0 = r // 2
    return _pad_nhwc(x, p0, m * ht + r - 1 - h - p0, p0, m * wt + r - 1 - wd - p0)


def _transform_input(xp: torch.Tensor, var: WinogradVariant) -> torch.Tensor:
    """Padded NHWC -> V ``[a*a, N*ht*wt, C]`` bf16."""
    m, a = var.m, var.a
    n, hp, wp, c = xp.shape
    ht, wt = (hp - (a - m)) // m, (wp - (a - m)) // m
    d = _tile_input(xp.float(), ht, wt, m, a)
    bt = device_table(var.BT, xp)
    v = torch.einsum("ir,js,rsnhwc->ijnhwc", bt, bt, d)
    return v.to(torch.bfloat16).reshape(a * a, n * ht * wt, c)


def _transform_cotangent(g: torch.Tensor, var: WinogradVariant) -> torch.Tensor:
    """dz NHWC (padded to m-multiples, no halo) -> dM ``[a*a, N*ht*wt, F]``
    bf16: dM[i,j] = sum_{p,l} AT[p,i] AT[l,j] dz[p,l] per tile."""
    m, a = var.m, var.a
    n, h, wd, f = g.shape
    ht, wt = h // m, wd // m
    gt = g.reshape(n, ht, m, wt, m, f).float()
    at = device_table(var.AT, g)
    dm = torch.einsum("pi,lj,nhpwlf->ijnhwf", at, at, gt)
    return dm.to(torch.bfloat16).reshape(a * a, n * ht * wt, f)


def _untransform_output(mm: torch.Tensor, var: WinogradVariant, n: int, h: int,
                        wd: int) -> torch.Tensor:
    """M ``[a*a, N*ht*wt, F]`` -> y ``[N, h, wd, F]`` float32 (cropped)."""
    m, a = var.m, var.a
    ht, wt = -(-h // m), -(-wd // m)
    f = mm.shape[-1]
    at = device_table(var.AT, mm)
    y = torch.einsum("pi,lj,ijnhwf->nhpwlf", at, at,
                     mm.reshape(a, a, n, ht, wt, f).float())
    return y.reshape(n, m * ht, m * wt, f)[:, :h, :wd]


def _u_of(w: torch.Tensor, var: WinogradVariant) -> torch.Tensor:
    """U ``[a*a, Cin, Cout]`` bf16 from OIHW w."""
    a = var.a
    return transform_kernel(w, var.name).reshape(
        a * a, w.shape[1], w.shape[0]).to(torch.bfloat16)


def _winograd_raw(x: torch.Tensor, u: torch.Tensor, var: WinogradVariant):
    """x NHWC, u ``[a*a, C, F]`` bf16 -> (y float32 ``[N,h,w,F]``, V)."""
    n, h, wd, _ = x.shape
    v = _transform_input(_pad_to_tiles(x, var.m, var.r), var)
    mm = _bmm_bf16(v, u, torch.bfloat16)
    return _untransform_output(mm, var, n, h, wd), v


def _dw_of(du: torch.Tensor, var: WinogradVariant) -> torch.Tensor:
    """dU ``[a*a, C, F]`` float32 -> dw = G^T dU G as OIHW float32."""
    a = var.a
    g = device_table(var.G, du)
    du = du.reshape(a, a, du.shape[1], du.shape[2])
    return torch.einsum("ir,js,ijcf->fcrs", g, g, du)


class _WinogradConv2d(torch.autograd.Function):
    """The JAX custom VJP of ``ops/winograd.py:winograd_conv2d``: V is
    rebuilt in the backward, not saved."""

    @staticmethod
    def forward(ctx, x, w, b, variant, relu):
        var = VARIANTS[variant]
        y, _ = _winograd_raw(x, _u_of(w, var), var)
        y = y + b.float()
        if relu:
            y = torch.relu(y)
        y = y.to(x.dtype)
        ctx.save_for_backward(x, w, y if relu else None)
        ctx.variant, ctx.relu, ctx.b_dtype = variant, relu, b.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        var = VARIANTS[ctx.variant]
        m = var.m
        n, h, wd, _ = x.shape
        g = g.to(x.dtype)
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        db = g.float().sum((0, 1, 2))
        dx, _ = _winograd_raw(g, _u_of(rot180_swap(w), var), var)
        v = _transform_input(_pad_to_tiles(x, m, var.r), var)
        ht, wt = -(-h // m), -(-wd // m)
        dm = _transform_cotangent(_pad_nhwc(g, 0, m * ht - h, 0, m * wt - wd), var)
        du = _bmm_bf16(v.transpose(1, 2), dm, torch.float32)
        return (dx.to(x.dtype), _dw_of(du, var).to(w.dtype), db.to(ctx.b_dtype),
                None, None)


def winograd_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    variant: str = "f4", relu: bool = False) -> torch.Tensor:
    """The materialized Winograd SAME conv (stride 1, odd r): x NHWC, w OIHW
    (the canonical parameters), b ``[Cout]`` (zeros for a raw conv).
    ``relu(conv(x, w) + b)`` (or without the relu) in x's dtype; V and M
    are bf16 whatever x's dtype, as in the JAX package."""
    return _WinogradConv2d.apply(x, w, b, variant, relu)


# ---------------------------------------------------------------------------
# decomposed large kernel (fc6's 7x7): the Winograd-domain tile conv
# ---------------------------------------------------------------------------
#
# The r x r kernel splits into 3x3 blocks at offsets {0, 3, 6, ..}; with
# F(3,3) every block lives on the same tile grid, shifted by whole tiles, so
# one input transform serves them all and the per-coordinate contraction is
# an nb x nb VALID conv over tile indices: a grouped conv, one group per
# Winograd coordinate.

def _conv_tiles(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """v ``[a2, N, th, tw, C]`` bf16, u ``[a2, nb, nb, C, F]`` bf16 ->
    ``[a2, N, th-nb+1, tw-nb+1, F]`` bf16 (float32 sums): a VALID conv per
    coordinate, as one grouped conv."""
    a2, n, th, tw, c = v.shape
    nb, f = u.shape[1], u.shape[4]
    vi = v.permute(1, 0, 4, 2, 3).reshape(n, a2 * c, th, tw)
    wi = u.permute(0, 4, 3, 1, 2).reshape(a2 * f, c, nb, nb)
    if v.is_cuda:  # cuDNN sums bf16 products in float32
        y = F.conv2d(vi, wi, groups=a2)
    else:
        y = F.conv2d(vi.float(), wi.float(), groups=a2).to(v.dtype)
    return y.reshape(n, a2, f, th - nb + 1, tw - nb + 1).permute(1, 0, 3, 4, 2)


def _dwm_kernel(w: torch.Tensor, var: WinogradVariant) -> torch.Tensor:
    """OIHW ``[F, C, r, r]`` -> U ``[a*a, nb, nb, C, F]`` float32: r padded
    up to 3*nb, split into 3x3 blocks, each transformed (G g G^T)."""
    f, c, r, _ = w.shape
    nb = -(-r // 3)
    wpad = F.pad(w.float(), (0, 3 * nb - r, 0, 3 * nb - r))
    blocks = wpad.reshape(f, c, nb, 3, nb, 3).permute(2, 4, 3, 5, 1, 0)
    g = device_table(var.G, w)
    u = torch.einsum("ir,js,derscf->ijdecf", g, g, blocks)
    return u.reshape(var.a * var.a, nb, nb, c, f)


def _dwm_geometry(h: int, wd: int, r: int, m: int):
    nb = -(-r // 3)
    tho, two = -(-h // m), -(-wd // m)
    th, tw = tho + nb - 1, two + nb - 1
    return nb, tho, two, th, tw, m * th + 2, m * tw + 2


def _dwm_v(x: torch.Tensor, r: int, var: WinogradVariant) -> torch.Tensor:
    """V ``[a*a, N, th, tw, C]`` bf16 of the tile conv's input."""
    m, a = var.m, var.a
    n, h, wd, c = x.shape
    _, _, _, th, tw, hp, wp = _dwm_geometry(h, wd, r, m)
    p0 = r // 2
    xp = _pad_nhwc(x.float(), p0, hp - p0 - h, p0, wp - p0 - wd)
    d = _tile_input(xp, th, tw, m, a)
    bt = device_table(var.BT, x)
    v = torch.einsum("ir,js,rsnhwc->ijnhwc", bt, bt, d)
    return v.to(torch.bfloat16).reshape(a * a, n, th, tw, c)


def _dwm_conv_raw(x: torch.Tensor, w: torch.Tensor, var: WinogradVariant
                  ) -> torch.Tensor:
    """SAME r x r conv (odd r >= 5) through the tile conv: x NHWC, w OIHW;
    float32 out."""
    assert (var.r, var.m) == (3, 3), "the tile-conv decomposition needs F(3,3)"
    m, a = var.m, var.a
    n, h, wd, _ = x.shape
    f, _, r, _ = w.shape
    _, tho, two, _, _, _, _ = _dwm_geometry(h, wd, r, m)
    v = _dwm_v(x, r, var)
    mm = _conv_tiles(v, _dwm_kernel(w, var).to(torch.bfloat16))
    at = device_table(var.AT, x)
    y = torch.einsum("pi,lj,ijnhwf->nhpwlf", at, at,
                     mm.reshape(a, a, n, tho, two, f).float())
    return y.reshape(n, m * tho, m * two, f)[:, :h, :wd]


class _WinogradConvLarge(torch.autograd.Function):
    """The JAX custom VJP of ``ops/winograd.py:winograd_conv_large``: dx is
    the SAME conv with the rotated kernel through the same tile conv, dU
    the per-block products V^T dM, dw = G^T dU G."""

    @staticmethod
    def forward(ctx, x, w, b, variant, relu):
        r = w.shape[-1]
        assert w.shape[-2] == r and r % 2 == 1 and r >= 5, tuple(w.shape)
        var = VARIANTS[variant]
        y = _dwm_conv_raw(x.to(torch.bfloat16), w, var) + b.float()
        if relu:
            y = torch.relu(y)
        y = y.to(x.dtype)
        ctx.save_for_backward(x, w, y if relu else None)
        ctx.variant, ctx.relu, ctx.b_dtype = variant, relu, b.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        var = VARIANTS[ctx.variant]
        m, a = var.m, var.a
        n, h, wd, c = x.shape
        f, _, r, _ = w.shape
        nb, tho, two, _, _, _, _ = _dwm_geometry(h, wd, r, m)
        g = g.to(x.dtype)
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        db = g.float().sum((0, 1, 2))
        dx = _dwm_conv_raw(g, rot180_swap(w), var).to(x.dtype)
        v = _dwm_v(x, r, var)
        dm = _transform_cotangent(
            _pad_nhwc(g, 0, m * tho - h, 0, m * two - wd), var)
        du = torch.stack([
            _bmm_bf16(v[:, :, dh:dh + tho, dw:dw + two].reshape(
                a * a, n * tho * two, c).transpose(1, 2), dm, torch.float32)
            for dh in range(nb) for dw in range(nb)]).reshape(nb, nb, a, a, c, f)
        gm = device_table(var.G, du)
        dwp = torch.einsum("ir,js,deijcf->drescf", gm, gm, du)
        dwp = dwp.reshape(3 * nb, 3 * nb, c, f)[:r, :r].permute(3, 2, 0, 1)
        return dx, dwp.to(w.dtype), db.to(ctx.b_dtype), None, None


def winograd_conv_large(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        variant: str = "f3", relu: bool = True) -> torch.Tensor:
    """SAME conv with an odd r >= 5 square kernel (fc6's 7x7) through the
    Winograd-domain tile conv: x NHWC, w OIHW ``[F, C, r, r]`` (the
    canonical parameters), b ``[F]``. Returns x's dtype."""
    return _WinogradConvLarge.apply(x, w, b, variant, relu)


def xla_eligible(x_shape, w_shape, variant: str) -> bool:
    """Whether the materialized form applies (the JAX package's gate, kept
    so the same layers take it): an odd square kernel of the variant's r,
    and, for r = 3, Cin >= 256 and Cout >= 512. ``w_shape`` is OIHW."""
    var = VARIANTS[variant]
    co, ci, kh, kw = w_shape
    if not (kh == kw == var.r and ci == x_shape[3]):
        return False
    if var.r != 3:
        return True
    return ci >= 256 and co >= 512
