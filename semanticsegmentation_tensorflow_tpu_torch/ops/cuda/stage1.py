"""VGG stage1 tail: relu -> 3x3 SAME conv -> 2x2 max pool -> +b2 -> relu,
forward and backward, and SegNet's relu -> conv -> +b2 -> relu -> 2x2
argmax pool.

The port of ``ops/pallas/stage1.py:fused_stage1_tail`` (FCN mode) and
``fused_segnet_stage1_tail`` (SegNet mode), single device. On the TPU the
kernels packed width pairs into 128 lanes; on the H100 they are plain NHWC
implicit GEMMs (``csrc/stage1_tail.cu``, ``csrc/stage1_bwd.cu``) that never
write the full-resolution conv output (forward) or its gradient (backward)
to device memory.

Three wrappers, each with a plain PyTorch version that it takes only for
tensors on the CPU; for CUDA tensors each launches its kernel or raises:

* ``stage1_tail`` (inference): the pooled output.
* ``stage1_tail_train``: the pooled output and the u8 routing codes, the
  index ``2*dy + dx`` of the first maximum of each 2x2 window.
* ``stage1_tail_bwd``: the gradients of z1, k2 and b2 from the output's
  gradient, routed by the codes (its plain version is also the f32
  reference the kernel is checked against on the card).
* ``stage1_tail_segnet``: SegNet's encoder stage1 tail, (pooled, idx) with
  the bias and relu before the pool; idx is ``max_pool_with_argmax``'s
  index, which the decoder unpools by.

:class:`Stage1Tail` is the autograd Function over the training forward and
the backward, :class:`SegNetStage1Tail` over the SegNet forward and the same
backward. Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
    pool_argmax_plain,
)

_WIDTHS = (16, 32, 48, 64)


def stage1_tail_plain(z1: torch.Tensor, k2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in ``z1``'s dtype.

    z1: [N,H,W,C] conv1_1 output WITH its bias b1 (pre-relu), NHWC.
    k2: [C,C,3,3] conv1_2 kernel, OIHW (the port's parameter layout).
    b2: [C]. Returns [N,H/2,W/2,C]: relu(maxpool2(conv(relu(z1), k2)) + b2).
    With bf16 inputs the conv output is bf16 before the pool, as on the TPU.
    Differentiable: autograd through it defines the backward, which
    :func:`stage1_tail_bwd_plain` computes from the kernel's inputs.
    """
    dt = z1.dtype
    y = torch.relu(z1).permute(0, 3, 1, 2)
    z = F.conv2d(y, k2.to(dt), padding=1)
    p = F.max_pool2d(z, 2, ceil_mode=True)
    return torch.relu(p + b2.to(dt).view(1, -1, 1, 1)).permute(0, 2, 3, 1)


def stage1_tail_codes_plain(z1: torch.Tensor, k2: torch.Tensor,
                            b2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: (out, codes), both
    [N,H/2,W/2,C]; ``out`` equals :func:`stage1_tail_plain`'s, ``codes``
    (u8) is the position ``2*dy + dx`` of the first maximum of each 2x2
    window in row-major order, on the conv values in ``z1``'s dtype
    (``ops/pallas/stage1.py:252-257``). H and W even."""
    dt = z1.dtype
    n, h, w, c = z1.shape
    z = F.conv2d(torch.relu(z1).permute(0, 3, 1, 2), k2.to(dt), padding=1)
    win = (z.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
           .reshape(n, h // 2, w // 2, c, 4))
    m = win.amax(-1)
    codes = (win == m.unsqueeze(-1)).to(torch.uint8).argmax(-1)  # first max
    out = torch.relu(m + b2.to(dt))
    return out, codes.to(torch.uint8)


def stage1_tail_segnet_plain(z1: torch.Tensor, k2: torch.Tensor,
                             b2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the SegNet forward, in ``z1``'s dtype: conv of
    relu(z1), +b2, relu, then the 2x2 argmax pool's plain version (the
    function ``ops/pool.py:max_pool_with_argmax`` runs on the CPU). Returns
    (pooled [N,H/2,W/2,C], u8 idx, the first maximum of relu(conv + b2) in
    row-major window order: ``ops/pallas/stage1.py:235-260``). H, W even."""
    dt = z1.dtype
    z = F.conv2d(torch.relu(z1).permute(0, 3, 1, 2), k2.to(dt), padding=1)
    s = torch.relu(z + b2.to(dt).view(1, -1, 1, 1)).permute(0, 2, 3, 1)
    return pool_argmax_plain(s)


def stage1_tail_bwd_plain(g: torch.Tensor, out: torch.Tensor,
                          codes: torch.Tensor, z1: torch.Tensor,
                          k2: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel, on the kernel's inputs:
    (dz1 in z1's dtype, dk2 f32 OIHW, db2 f32). The pooled gradient, masked
    by ``out > 0``, goes to the one conv pixel its code names (in z1's
    dtype); the conv gradients accumulate in f32 from the z1-dtype values
    (``ops/pallas/stage1.py:_bwd_kernel``), as nine GEMMs over the pixels,
    one per tap, so that no transform (cuDNN's FFT or Winograd algorithms)
    rounds in between.

    It routes by the given codes and keeps dk2 and db2 in f32, so it is the
    reference the kernel is held against on the card (there with
    ``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default):
    the same bf16 products, summed in another order. On the CPU it is
    tested against autograd through :func:`stage1_tail_plain`."""
    dt = z1.dtype
    n, h, w, c = z1.shape
    gr = torch.where(out > 0, g.to(dt), torch.zeros((), dtype=dt))
    pos = torch.arange(4, device=g.device).view(1, 1, 1, 1, 4)
    dz2 = torch.where(codes.long().unsqueeze(-1) == pos, gr.unsqueeze(-1),
                      torch.zeros((), dtype=dt))            # [N,Ho,Wo,C,4]
    dz2 = (dz2.reshape(n, h // 2, w // 2, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
           .reshape(n, h, w, c).float())                    # NHWC
    ypad = F.pad(torch.relu(z1).float(), (0, 0, 1, 1, 1, 1))
    dzpad = F.pad(dz2, (0, 0, 1, 1, 1, 1))
    kf = k2.to(dt).float()
    dk2 = torch.empty((c, c, 3, 3), dtype=torch.float32, device=z1.device)
    dy = torch.zeros((n, h, w, c), dtype=torch.float32, device=z1.device)
    rows = dz2.reshape(-1, c).t()
    for i in range(3):
        for j in range(3):
            dk2[:, :, i, j] = rows @ ypad[:, i:i + h, j:j + w].reshape(-1, c)
            dy += dzpad[:, 2 - i:2 - i + h, 2 - j:2 - j + w] @ kf[:, :, i, j]
    dz1 = torch.where(z1 > 0, dy, 0.0).to(dt)
    return dz1, dk2, gr.float().sum((0, 1, 2))


def _check(z1: torch.Tensor, k2: torch.Tensor,
           b2: torch.Tensor | None = None) -> None:
    if z1.dim() != 4:
        raise ValueError(f"z1 must be [N,H,W,C], got {tuple(z1.shape)}")
    n, h, w, c = z1.shape
    if z1.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA stage1 tail takes bf16 z1, got {z1.dtype}")
    if c not in _WIDTHS:
        raise ValueError(f"the CUDA stage1 tail takes C in 16, 32, 48, 64 (the "
                         f"stage1 widths; its weights sit whole in shared "
                         f"memory), got {c}")
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got {(h, w)}")
    if not z1.is_contiguous() or z1.data_ptr() % 16:
        raise ValueError("z1 must be a contiguous, 16-byte aligned NHWC tensor")
    if tuple(k2.shape) != (c, c, 3, 3):
        raise ValueError(f"k2 must be [{c},{c},3,3] (OIHW), got {tuple(k2.shape)}")
    if b2 is not None and tuple(b2.shape) != (c,):
        raise ValueError(f"b2 must be [{c}], got {tuple(b2.shape)}")
    for t in (k2,) if b2 is None else (k2, b2):
        if t.device != z1.device:
            raise ValueError("z1, k2 and b2 must be on one device")


def _on_cuda(z1: torch.Tensor, what: str) -> bool:
    """True for CUDA tensors, False for CPU ones (the plain version);
    any other device raises."""
    if z1.device.type == "cpu":
        return False
    if z1.device.type != "cuda":
        raise ValueError(f"no {what} for device {z1.device}")
    return True


def _forward(z1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor,
             with_codes: bool, segnet: bool = False):
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    _check(z1, k2, b2)
    n, h, w, c = z1.shape
    lib = build.lib()
    # [Cout,3,3,Cin] memory: no copy for a bf16 channels_last k2 (the form
    # Predictor casts the model to once), one copy otherwise
    wk = k2.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
    bk = b2.to(torch.bfloat16).contiguous()
    if wk.data_ptr() % 16:
        raise ValueError("k2 must be 16-byte aligned")
    out = torch.empty((n, h // 2, w // 2, c), dtype=torch.bfloat16,
                      device=z1.device)
    codes = torch.empty(out.shape, dtype=torch.uint8,
                        device=z1.device) if with_codes else None
    entry = "seg_stage1_tail_segnet" if segnet else "seg_stage1_tail"
    with torch.cuda.device(z1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(z1.data_ptr(), wk.data_ptr(), bk.data_ptr(),
                                  out.data_ptr(),
                                  codes.data_ptr() if with_codes else None,
                                  n, h, w, c, stream)
    build.check(err, entry)
    return out, codes


def stage1_tail(z1: torch.Tensor, k2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """The fused stage1 tail; see :func:`stage1_tail_plain` for the contract.

    CUDA: z1 must be bf16, contiguous NHWC, C one of 16/32/48/64, H and W
    even. k2 and b2 may be f32 (the port's params); they are cast to bf16.
    The kernel reads k2 in ``torch.channels_last`` memory.
    """
    if not _on_cuda(z1, "stage1 tail"):
        return stage1_tail_plain(z1, k2, b2)
    out, _ = _forward(z1, k2, b2, with_codes=False)
    stage1_tail.launches += 1
    return out


def stage1_tail_train(z1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out, codes) as :func:`stage1_tail_codes_plain`
    defines them; on CUDA as :func:`stage1_tail` takes its inputs."""
    if not _on_cuda(z1, "stage1 tail"):
        return stage1_tail_codes_plain(z1, k2, b2)
    out, codes = _forward(z1, k2, b2, with_codes=True)
    stage1_tail_train.launches += 1
    return out, codes


def stage1_tail_segnet(z1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """SegNet's stage1 tail: (pooled, u8 idx) as
    :func:`stage1_tail_segnet_plain` defines them; on CUDA as
    :func:`stage1_tail` takes its inputs."""
    if not _on_cuda(z1, "stage1 tail"):
        return stage1_tail_segnet_plain(z1, k2, b2)
    out, idx = _forward(z1, k2, b2, with_codes=True, segnet=True)
    stage1_tail_segnet.launches += 1
    return out, idx


def stage1_tail_bwd(g: torch.Tensor, out: torch.Tensor, codes: torch.Tensor,
                    z1: torch.Tensor, k2: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel: (dz1, dk2 f32 OIHW, db2 f32) from the output's
    gradient ``g`` and the training forward's ``out`` and ``codes``; see
    :func:`stage1_tail_bwd_plain`. CUDA: z1 as :func:`stage1_tail` takes it,
    ``out`` and ``codes`` as :func:`stage1_tail_train` made them; ``g`` is
    cast to bf16. Two calls on the same inputs give the same bits (no float
    atomics)."""
    if not _on_cuda(z1, "stage1 tail backward"):
        return stage1_tail_bwd_plain(g, out, codes, z1, k2)
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    _check(z1, k2)
    n, h, w, c = z1.shape
    pooled = (n, h // 2, w // 2, c)
    gk = g.to(torch.bfloat16).contiguous()
    for name, t, dt in (("g", gk, torch.bfloat16), ("out", out, torch.bfloat16),
                        ("codes", codes, torch.uint8)):
        if tuple(t.shape) != pooled or t.dtype != dt or t.device != z1.device:
            raise ValueError(f"{name} must be {dt} {list(pooled)} on {z1.device}, "
                             f"got {t.dtype} {list(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    # dgrad is the forward conv of dz2 with wt[ci][dy][dx][co] = k2[co][ci][2-dy][2-dx]
    wt = (k2.to(torch.bfloat16).flip((2, 3)).transpose(0, 1)
          .permute(0, 2, 3, 1).contiguous())
    lib = build.lib()
    dev = z1.device
    with torch.cuda.device(dev):
        parts = lib.seg_stage1_bwd_parts(n, h, w, c)
        if parts <= 0:
            build.check(-parts, "seg_stage1_bwd_parts")
        dz1 = torch.empty_like(z1)
        dk2 = torch.empty((c, 3, 3, c), dtype=torch.float32, device=dev)
        db2 = torch.empty((c,), dtype=torch.float32, device=dev)
        dk_part = torch.empty((parts, 9 * c * c), dtype=torch.float32, device=dev)
        db_part = torch.empty((parts, c), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seg_stage1_tail_bwd(
            gk.data_ptr(), out.data_ptr(), codes.data_ptr(), z1.data_ptr(),
            wt.data_ptr(), dz1.data_ptr(), dk_part.data_ptr(), db_part.data_ptr(),
            parts, dk2.data_ptr(), db2.data_ptr(), n, h, w, c, stream)
    build.check(err, "seg_stage1_tail_bwd")
    stage1_tail_bwd.launches += 1
    return dz1, dk2.permute(0, 3, 1, 2).contiguous(), db2


stage1_tail.launches = 0
stage1_tail_train.launches = 0
stage1_tail_bwd.launches = 0
stage1_tail_segnet.launches = 0


class Stage1Tail(torch.autograd.Function):
    """The stage1 tail with its hand-written backward (the port of the
    ``jax.custom_vjp`` around ``fused_stage1_tail``). Forward saves z1, k2,
    the pooled output and the codes; backward returns (dz1, dk2 in k2's
    dtype, db2 in b2's dtype). b1 stays in conv1_1, so autograd gives
    db1 = sum(dz1), as the JAX wrapper does on one device
    (``stage1.py:760-764``)."""

    @staticmethod
    def forward(ctx, z1, k2, b2):
        out, codes = stage1_tail_train(z1, k2, b2)
        ctx.save_for_backward(z1, k2, out, codes)
        ctx.b2_dtype = b2.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        z1, k2, out, codes = ctx.saved_tensors
        dz1, dk2, db2 = stage1_tail_bwd(g, out, codes, z1, k2)
        return dz1, dk2.to(k2.dtype), db2.to(ctx.b2_dtype)


class SegNetStage1Tail(torch.autograd.Function):
    """SegNet's stage1 tail with the hand-written backward (the port of the
    ``jax.custom_vjp`` around ``fused_segnet_stage1_tail``): forward
    :func:`stage1_tail_segnet`, returning (out, idx) with idx
    non-differentiable; backward :func:`stage1_tail_bwd` fed the SegNet
    index as its codes, as ``_fused_seg_bwd`` does
    (``ops/pallas/stage1.py:819-826``): the ``out > 0`` mask is the selected
    element's relu mask, and the index routes the gradient to it."""

    @staticmethod
    def forward(ctx, z1, k2, b2):
        out, idx = stage1_tail_segnet(z1, k2, b2)
        ctx.save_for_backward(z1, k2, out, idx)
        ctx.mark_non_differentiable(idx)
        ctx.b2_dtype = b2.dtype
        return out, idx

    @staticmethod
    def backward(ctx, g, _g_idx):
        z1, k2, out, idx = ctx.saved_tensors
        dz1, dk2, db2 = stage1_tail_bwd(g, out, idx, z1, k2)
        return dz1, dk2.to(k2.dtype), db2.to(ctx.b2_dtype)
