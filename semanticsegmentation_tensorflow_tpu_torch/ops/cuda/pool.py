"""2x2/2 max pool with its within-window argmax, and the unpool routed by it.

The port of ``ops/pallas/pool.py:pool_pairs_pallas`` by function: a 2x2/2
max pool whose gradient goes to the FIRST maximum in (dy, dx) row-major
window order. Here the forward writes that routing as a u8 index
``2*dy + dx``, the index of SegNet's ``max_pool_with_argmax`` (the JAX
package's ``ops/pool.py:70-164``), and the kernels of ``csrc/pool.cu`` route
by it. Three wrappers on NHWC tensors, each with a plain PyTorch version that
it takes only for tensors on the CPU; for CUDA tensors each launches its
kernel or raises:

* ``pool_argmax``: (pooled, idx) from x, one read of the input;
* ``unpool``: place the pooled value at its index, zeros elsewhere in the
  window. It is the pool's backward (TF's MaxPoolGradWithArgmax: ties are
  not split) and the decoder's forward unpool;
* ``unpool_bwd``: the gradient at the index, the unpool's backward.

All three only select, so the kernels equal their plain versions bit for
bit. :class:`MaxPoolArgmax` and :class:`MaxUnpool` are the autograd
Functions over them (the ``jax.custom_vjp``s of ``ops/pool.py``); the index
takes no gradient. Each wrapper counts its kernel launches in
``<wrapper>.launches``. The two forwards are registered torch ops,
``segport::pool_argmax`` and ``segport::unpool``: the dispatcher picks the
plain version or the launch by the tensors' device when the op runs, also
inside an exported program (``infer/export.py``).
"""

from __future__ import annotations

import torch

from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.library import (
    register_plain_autograd,
)

_U8 = torch.uint8


def _windows(t: torch.Tensor) -> list[torch.Tensor]:
    """The four strided views t[:, dy::2, dx::2] in (dy, dx) row-major order."""
    return [t[:, dy::2, dx::2] for dy in (0, 1) for dx in (0, 1)]


def pool_argmax_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: [N,H,W,C] -> (pooled [N,H/2,W/2,C] in x's dtype, idx
    u8), idx the position ``2*dy + dx`` of the first maximum of each window
    in row-major order (a later value replaces the running maximum only if
    strictly greater), pooled the value there. Differentiable: autograd
    through the selects routes the gradient to the indexed element only."""
    _check_even(x)
    win = _windows(x)
    best = win[0]
    idx = torch.zeros(best.shape, dtype=_U8, device=x.device)
    for k in (1, 2, 3):
        gt = win[k] > best
        best = torch.where(gt, win[k], best)
        idx = torch.where(gt, torch.tensor(k, dtype=_U8, device=x.device), idx)
    return best.contiguous(), idx.contiguous()


def unpool_plain(pooled: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: [N,Hp,Wp,C] + u8 idx -> [N,2Hp,2Wp,C], the pooled value
    at window position ``idx``, zeros elsewhere. Differentiable in
    ``pooled`` (the gradient is g at the index)."""
    n, hp, wp, c = pooled.shape
    zero = torch.zeros((), dtype=pooled.dtype, device=pooled.device)
    parts = torch.stack([torch.where(idx == k, pooled, zero) for k in range(4)], 3)
    return (parts.reshape(n, hp, wp, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, 2 * hp, 2 * wp, c))


def unpool_bwd_plain(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: [N,2Hp,2Wp,C] + u8 idx [N,Hp,Wp,C] -> g at window
    position ``idx`` (index 3 for any index above 2, as the kernel reads)."""
    _check_even(g)
    win = _windows(g)
    out = win[3]
    for k in (2, 1, 0):
        out = torch.where(idx == k, win[k], out)
    return out.contiguous()


def _check_even(t: torch.Tensor) -> None:
    if t.dim() != 4 or t.shape[1] % 2 or t.shape[2] % 2:
        raise ValueError(f"the 2x2 pool takes [N,H,W,C] with H and W even, got "
                         f"{tuple(t.shape)}")


def _check_device(t: torch.Tensor, what: str) -> None:
    """Raise for a device other than the CPU (the plain version) and CUDA
    (the kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {t.device}")


def _cuda_in(t: torch.Tensor, name: str, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as the kernels read it: contiguous NHWC (copied only if it is
    not), 16-byte aligned, C a multiple of 8."""
    if t.dtype != dtype:
        raise TypeError(f"the CUDA pool kernels take {dtype} {name}, got {t.dtype}")
    if t.dim() != 4 or t.shape[-1] % 8:
        raise ValueError(f"{name} must be [N,H,W,C] with C a multiple of 8, got "
                         f"{tuple(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def _pooled_index(idx: torch.Tensor, shape, device) -> torch.Tensor:
    idx = _cuda_in(idx, "idx", _U8)
    if tuple(idx.shape) != tuple(shape) or idx.device != device:
        raise ValueError(f"idx must be {list(shape)} on {device}, got "
                         f"{list(idx.shape)} on {idx.device}")
    return idx


def _launch(name: str, *args) -> None:
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    lib = build.lib()
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        shape = args[-1]
        err = getattr(lib, name)(*(a.data_ptr() for a in args[:-1]), *shape, stream)
    build.check(err, name)


def pool_argmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pooled, idx) of the 2x2/2 max pool; see :func:`pool_argmax_plain`.
    CUDA: bf16 NHWC, C a multiple of 8, H and W even. Runs the op
    ``segport::pool_argmax``."""
    _check_device(x, "pool")
    return torch.ops.segport.pool_argmax(x)


@torch.library.custom_op("segport::pool_argmax", mutates_args=(),
                         device_types="cpu")
def _pool_argmax_op(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return pool_argmax_plain(x)


@_pool_argmax_op.register_kernel("cuda")
def _pool_argmax_cuda(x):
    _check_even(x)
    x = _cuda_in(x, "x", torch.bfloat16)
    n, h, w, c = x.shape
    out = torch.empty((n, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    idx = torch.empty(out.shape, dtype=_U8, device=x.device)
    _launch("seg_pool_argmax", x, out, idx, (n, h // 2, w // 2, c))
    pool_argmax.launches += 1
    return out, idx


@_pool_argmax_op.register_fake
def _(x):
    _check_even(x)
    n, h, w, c = x.shape
    out = x.new_empty((n, h // 2, w // 2, c))
    return out, out.new_empty(out.shape, dtype=_U8)


register_plain_autograd(_pool_argmax_op, pool_argmax_plain)


def unpool(pooled: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Place-or-zero into the 2x2 windows; see :func:`unpool_plain`. CUDA:
    bf16 NHWC ``pooled``, C a multiple of 8, u8 ``idx`` of its shape. Runs
    the op ``segport::unpool``."""
    _check_device(pooled, "unpool")
    return torch.ops.segport.unpool(pooled, idx)


@torch.library.custom_op("segport::unpool", mutates_args=(), device_types="cpu")
def _unpool_op(pooled: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return unpool_plain(pooled, idx)


@_unpool_op.register_kernel("cuda")
def _unpool_cuda(pooled, idx):
    pooled = _cuda_in(pooled, "pooled", torch.bfloat16)
    n, hp, wp, c = pooled.shape
    idx = _pooled_index(idx, pooled.shape, pooled.device)
    y = torch.empty((n, 2 * hp, 2 * wp, c), dtype=pooled.dtype, device=pooled.device)
    _launch("seg_unpool", pooled, idx, y, (n, hp, wp, c))
    unpool.launches += 1
    return y


@_unpool_op.register_fake
def _(pooled, idx):
    n, hp, wp, c = pooled.shape
    return pooled.new_empty((n, 2 * hp, 2 * wp, c))


register_plain_autograd(_unpool_op, unpool_plain)


def unpool_bwd(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gradient at each window's index; see :func:`unpool_bwd_plain`.
    CUDA: ``g`` is cast to bf16 (NHWC, H and W even), ``idx`` u8 of the
    pooled shape."""
    _check_device(g, "unpool backward")
    if g.device.type == "cpu":
        return unpool_bwd_plain(g, idx)
    _check_even(g)
    g = _cuda_in(g.to(torch.bfloat16), "g", torch.bfloat16)
    n, h, w, c = g.shape
    idx = _pooled_index(idx, (n, h // 2, w // 2, c), g.device)
    d = torch.empty(idx.shape, dtype=g.dtype, device=g.device)
    _launch("seg_unpool_bwd", g, idx, d, (n, h // 2, w // 2, c))
    unpool_bwd.launches += 1
    return d


pool_argmax.launches = 0
unpool.launches = 0
unpool_bwd.launches = 0


class MaxPoolArgmax(torch.autograd.Function):
    """(pooled, idx) = :func:`pool_argmax` (x); the backward places the
    pooled gradient at the recorded index (:func:`unpool`), ties unsplit, as
    the JAX package's ``max_pool_with_argmax`` VJP does."""

    @staticmethod
    def forward(ctx, x):
        out, idx = pool_argmax(x)
        ctx.save_for_backward(idx)
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g, _g_idx):
        (idx,) = ctx.saved_tensors
        return unpool(g, idx)


class MaxUnpool(torch.autograd.Function):
    """y = :func:`unpool` (pooled, idx); the backward is the gradient at the
    index (:func:`unpool_bwd`), and none for idx."""

    @staticmethod
    def forward(ctx, pooled, idx):
        ctx.save_for_backward(idx)
        return unpool(pooled, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return unpool_bwd(g, idx), None
