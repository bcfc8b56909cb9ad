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

The two inference forwards are registered torch ops, ``segport::stage1_tail``
and ``segport::stage1_tail_segnet`` (``torch.library.custom_op``): the
dispatcher picks the CPU implementation (the plain version) or the CUDA one
(the launch, which counts it) by the tensors' device when the op runs, so an
exported program (``infer/export.py``) that calls them launches the kernel on
the card. Their fake implementations give the outputs' shapes and dtypes.

The halo mode (kernel 1c, the port of the same two Pallas calls with
``spmd=True``: ``fused_stage1_tail(..., spmd=True)`` and
``fused_segnet_stage1_tail(..., spmd=True)``) serves an image whose rows are
split across ranks: z1 arrives WITHOUT the conv1_1 bias b1, which the kernel
folds in as relu(z + b1), and rows -1 and H come from the halo rows ``top``
and ``bot`` [N,1,W,C] (a neighbour's boundary row, or ``-inf`` at the image's
edge, so that relu(z + b1) is exactly 0 there). ``stage1_tail_halo`` runs the
three epilogues (``mode`` "infer", "codes", "segnet"); ``stage1_tail_halo_bwd``
returns (dz1, dk2, db2, db1), db1 included, from the neighbours' boundary
pooled rows of g, out and codes (:class:`BwdHalos`). :class:`Stage1TailHalo`
and :class:`SegNetStage1TailHalo` take (z1, k2, b2, b1) and a spatial grid (or
None for a whole image) and exchange the halo rows themselves
(``parallel/halo.py``). The TPU's per-block halo arrays came from its VMEM
blocking; the H100 kernels read their neighbours inside a rank's rows and
need halo rows only at its edge.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.library import (
    register_plain_autograd,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
    pool_argmax_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import boundary_rows

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
    z = F.conv2d(torch.relu(z1).permute(0, 3, 1, 2), k2.to(z1.dtype), padding=1)
    return _pool_codes(z, b2)


def _pool_codes(z: torch.Tensor, b2: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """NCHW conv output -> (relu(maxpool2(z) + b2), first-max codes), NHWC."""
    n, c, h, w = z.shape
    win = (z.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
           .reshape(n, h // 2, w // 2, c, 4))
    m = win.amax(-1)
    codes = (win == m.unsqueeze(-1)).to(torch.uint8).argmax(-1)  # first max
    out = torch.relu(m + b2.to(z.dtype))
    return out, codes.to(torch.uint8)


def stage1_tail_segnet_plain(z1: torch.Tensor, k2: torch.Tensor,
                             b2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the SegNet forward, in ``z1``'s dtype: conv of
    relu(z1), +b2, relu, then the 2x2 argmax pool's plain version (the
    function ``ops/pool.py:max_pool_with_argmax`` runs on the CPU). Returns
    (pooled [N,H/2,W/2,C], u8 idx, the first maximum of relu(conv + b2) in
    row-major window order: ``ops/pallas/stage1.py:235-260``). H, W even."""
    z = F.conv2d(torch.relu(z1).permute(0, 3, 1, 2), k2.to(z1.dtype), padding=1)
    return _segnet_pool(z, b2)


def _segnet_pool(z: torch.Tensor, b2: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """NCHW conv output -> the argmax pool of relu(z + b2), NHWC."""
    s = torch.relu(z + b2.to(z.dtype).view(1, -1, 1, 1)).permute(0, 2, 3, 1)
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
    gr = torch.where(out > 0, g.to(dt), torch.zeros((), dtype=dt))
    dz2 = F.pad(_route(gr, codes), (0, 0, 0, 0, 1, 1))   # rows -1..H, zero
    y = F.pad(torch.relu(z1).float(), (0, 0, 0, 0, 1, 1))
    dk2, dy = _conv_grads(dz2, y, k2.to(dt).float())
    dz1 = torch.where(z1 > 0, dy, 0.0).to(dt)
    return dz1, dk2, gr.float().sum((0, 1, 2))


def _route(gr: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Each pooled gradient [N,Hp,Wp,C] to the conv pixel its code names:
    [N,2Hp,2Wp,C] f32 (the values in gr's dtype, zero elsewhere)."""
    n, hp, wp, c = gr.shape
    pos = torch.arange(4, device=gr.device).view(1, 1, 1, 1, 4)
    dz2 = torch.where(codes.long().unsqueeze(-1) == pos, gr.unsqueeze(-1),
                      torch.zeros((), dtype=gr.dtype))      # [N,Hp,Wp,C,4]
    return (dz2.reshape(n, hp, wp, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
            .reshape(n, 2 * hp, 2 * wp, c).float())


def _conv_grads(dz2: torch.Tensor, y: torch.Tensor, kf: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3x3 SAME conv's gradients as nine per-tap f32 GEMMs. dz2 and y
    (the conv's relu'd input) are f32 NHWC with rows -1..H (the halo rows,
    zero at an image edge); the columns are zero-padded here. Returns (dk2
    OIHW over the conv rows 0..H-1, the input gradient dy of rows 0..H-1)."""
    n, h2, w, c = dz2.shape
    h = h2 - 2
    ypad = F.pad(y, (0, 0, 1, 1))
    dzpad = F.pad(dz2, (0, 0, 1, 1))
    dk2 = torch.empty((c, c, 3, 3), dtype=torch.float32, device=dz2.device)
    dy = torch.zeros((n, h, w, c), dtype=torch.float32, device=dz2.device)
    rows = dz2[:, 1:h + 1].reshape(-1, c).t()
    for i in range(3):
        for j in range(3):
            dk2[:, :, i, j] = rows @ ypad[:, i:i + h, j:j + w].reshape(-1, c)
            dy += dzpad[:, 2 - i:2 - i + h, 2 - j:2 - j + w] @ kf[:, :, i, j]
    return dk2, dy


_HALO_MODES = ("infer", "codes", "segnet")


def stage1_tail_halo_plain(z1: torch.Tensor, top: torch.Tensor,
                           bot: torch.Tensor, k2: torch.Tensor,
                           b2: torch.Tensor, b1: torch.Tensor, mode: str):
    """Plain version of the halo mode, in ``z1``'s dtype. z1 [N,H,W,C]
    WITHOUT b1; top, bot [N,1,W,C] the pre-bias rows -1 and H (``-inf`` at
    the image's edge). The conv input is relu(z + b1) with the bias added
    in z1's dtype (``ops/pallas/stage1.py:213``). ``mode``: "infer" returns
    the pooled output as :func:`stage1_tail_plain`; "codes" (out, codes) as
    :func:`stage1_tail_codes_plain`; "segnet" (out, idx) as
    :func:`stage1_tail_segnet_plain`."""
    if mode not in _HALO_MODES:
        raise ValueError(f"mode must be one of {_HALO_MODES}, got {mode!r}")
    dt = z1.dtype
    y = torch.relu(torch.cat([top, z1, bot], 1).to(dt) + b1.to(dt))
    z = F.conv2d(y.permute(0, 3, 1, 2), k2.to(dt), padding=(0, 1))
    if mode == "codes":
        return _pool_codes(z, b2)
    if mode == "segnet":
        return _segnet_pool(z, b2)
    p = F.max_pool2d(z, 2, ceil_mode=True)
    return torch.relu(p + b2.to(dt).view(1, -1, 1, 1)).permute(0, 2, 3, 1)


class BwdHalos(NamedTuple):
    """The halo rows of the backward: the pooled row just above this rank's
    rows (``*_top``) and just below them (``*_bot``) of g, out and codes
    [N,1,W/2,C] (zero at the image's edge), and of z1 [N,1,W,C] (pre-bias,
    ``-inf`` at the edge)."""
    g_top: torch.Tensor
    g_bot: torch.Tensor
    out_top: torch.Tensor
    out_bot: torch.Tensor
    codes_top: torch.Tensor
    codes_bot: torch.Tensor
    z1_top: torch.Tensor
    z1_bot: torch.Tensor


def stage1_tail_halo_bwd_plain(g: torch.Tensor, out: torch.Tensor,
                               codes: torch.Tensor, z1: torch.Tensor,
                               k2: torch.Tensor, b1: torch.Tensor,
                               halos: BwdHalos):
    """Plain version of the halo-mode backward: (dz1 in z1's dtype, dk2 f32
    OIHW, db2 f32, db1 f32) of this rank's rows. As
    :func:`stage1_tail_bwd_plain`, with the routed gradient of conv rows -1
    and H rebuilt from the halo rows of g, out and codes, relu(z1 + b1) read
    with the z1 halo rows, and the relu mask of dz1 taken on z1 + b1
    (``ops/pallas/stage1.py:375-381``). dk2 sums over this rank's conv rows,
    db2 over its pooled rows and db1 = sum(dz1) over its rows: the sums over
    the ranks are the whole image's."""
    dt = z1.dtype
    h = z1.shape[1]
    gx = torch.cat([halos.g_top, g, halos.g_bot], 1).to(dt)
    ox = torch.cat([halos.out_top, out, halos.out_bot], 1)
    cx = torch.cat([halos.codes_top, codes, halos.codes_bot], 1)
    gr = torch.where(ox > 0, gx, torch.zeros((), dtype=dt))
    dz2 = _route(gr, cx)[:, 1:h + 3]                      # conv rows -1..H
    zx = torch.cat([halos.z1_top, z1, halos.z1_bot], 1).to(dt) + b1.to(dt)
    dk2, dy = _conv_grads(dz2, torch.relu(zx).float(), k2.to(dt).float())
    dz1 = torch.where(zx[:, 1:h + 1] > 0, dy, 0.0).to(dt)
    return dz1, dk2, gr[:, 1:-1].float().sum((0, 1, 2)), dz1.float().sum((0, 1, 2))


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


def _check_device(z1: torch.Tensor, what: str) -> None:
    """Raise for a device other than the CPU (the plain version) and
    CUDA (the kernel)."""
    if z1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {z1.device}")


def _on_cuda(z1: torch.Tensor, what: str) -> bool:
    """True for CUDA tensors, False for CPU ones (the plain version);
    any other device raises."""
    _check_device(z1, what)
    return z1.device.type == "cuda"


def _check_like(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be {dtype} {list(shape)} on {device}, "
                         f"got {t.dtype} {list(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _forward(z1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor,
             with_codes: bool, segnet: bool = False, halo=None):
    """Launch the forward kernel; ``halo`` = (top, bot, b1) selects the
    halo mode (tensors already checked and in bf16)."""
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
    entry = ("seg_stage1_tail" + ("_halo" if halo else "")
             + ("_segnet" if segnet else ""))
    ptrs = [z1.data_ptr(), wk.data_ptr(), bk.data_ptr()]
    if halo:
        top, bot, b1 = halo
        ptrs = [z1.data_ptr(), top.data_ptr(), bot.data_ptr(), wk.data_ptr(),
                bk.data_ptr(), b1.data_ptr()]
    with torch.cuda.device(z1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*ptrs, out.data_ptr(),
                                  codes.data_ptr() if with_codes else None,
                                  n, h, w, c, stream)
    build.check(err, entry)
    return out, codes


def stage1_tail(z1: torch.Tensor, k2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """The fused stage1 tail; see :func:`stage1_tail_plain` for the contract.

    CUDA: z1 must be bf16, contiguous NHWC, C one of 16/32/48/64, H and W
    even. k2 and b2 may be f32 (the port's params); they are cast to bf16.
    The kernel reads k2 in ``torch.channels_last`` memory. Runs the op
    ``segport::stage1_tail``.
    """
    _check_device(z1, "stage1 tail")
    return torch.ops.segport.stage1_tail(z1, k2, b2)


def _pooled_like(z1: torch.Tensor, dtype=None) -> torch.Tensor:
    """An empty [N,ceil(H/2),ceil(W/2),C] tensor: the fake outputs."""
    n, h, w, c = z1.shape
    return z1.new_empty((n, (h + 1) // 2, (w + 1) // 2, c),
                        dtype=dtype or z1.dtype)


@torch.library.custom_op("segport::stage1_tail", mutates_args=(),
                         device_types="cpu")
def _stage1_tail_op(z1: torch.Tensor, k2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    return stage1_tail_plain(z1, k2, b2).contiguous()


@_stage1_tail_op.register_kernel("cuda")
def _stage1_tail_cuda(z1, k2, b2):
    out, _ = _forward(z1, k2, b2, with_codes=False)
    stage1_tail.launches += 1
    return out


@_stage1_tail_op.register_fake
def _(z1, k2, b2):
    return _pooled_like(z1)


register_plain_autograd(_stage1_tail_op, stage1_tail_plain)


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
    :func:`stage1_tail` takes its inputs. Runs the op
    ``segport::stage1_tail_segnet``."""
    _check_device(z1, "stage1 tail")
    return torch.ops.segport.stage1_tail_segnet(z1, k2, b2)


@torch.library.custom_op("segport::stage1_tail_segnet", mutates_args=(),
                         device_types="cpu")
def _stage1_tail_segnet_op(z1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    return stage1_tail_segnet_plain(z1, k2, b2)


@_stage1_tail_segnet_op.register_kernel("cuda")
def _stage1_tail_segnet_cuda(z1, k2, b2):
    out, idx = _forward(z1, k2, b2, with_codes=True, segnet=True)
    stage1_tail_segnet.launches += 1
    return out, idx


@_stage1_tail_segnet_op.register_fake
def _(z1, k2, b2):
    return _pooled_like(z1), _pooled_like(z1, torch.uint8)


register_plain_autograd(_stage1_tail_segnet_op, stage1_tail_segnet_plain)


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
    dz1, dk2, db2, _ = _backward(g, out, codes, z1, k2)
    stage1_tail_bwd.launches += 1
    return dz1, dk2, db2


def _backward(g, out, codes, z1, k2, b1=None, halos: BwdHalos | None = None):
    """Launch the backward kernels; with ``halos`` (and b1) the halo mode,
    which also returns db1 (None otherwise)."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    _check(z1, k2)
    n, h, w, c = z1.shape
    dev = z1.device
    pooled = (n, h // 2, w // 2, c)
    bf = torch.bfloat16
    gk = g.to(bf).contiguous()
    for name, t, dt in (("g", gk, bf), ("out", out, bf), ("codes", codes, torch.uint8)):
        _check_like(name, t, pooled, dt, dev)
    ptrs = [gk.data_ptr(), out.data_ptr(), codes.data_ptr()]
    if halos is not None:
        halos = BwdHalos(*(t.to(bf).contiguous() if i < 4 or i > 5 else t
                           for i, t in enumerate(halos)))
        for i, (name, t) in enumerate(zip(BwdHalos._fields, halos)):
            _check_like(name, t, (n, 1, w, c) if i > 5 else (n, 1, w // 2, c),
                        torch.uint8 if i in (4, 5) else bf, dev)
        b1k = b1.to(bf).contiguous()
        _check_like("b1", b1k, (c,), bf, dev)
        ptrs += [halos.g_top.data_ptr(), halos.out_top.data_ptr(),
                 halos.codes_top.data_ptr(), halos.g_bot.data_ptr(),
                 halos.out_bot.data_ptr(), halos.codes_bot.data_ptr(),
                 z1.data_ptr(), halos.z1_top.data_ptr(), halos.z1_bot.data_ptr(),
                 b1k.data_ptr()]
    else:
        ptrs.append(z1.data_ptr())
    # dgrad is the SAME conv of dz2 with wt[ty][tx][co][ci] = k2[co][ci][2-ty][2-tx]
    wt = k2.to(bf).flip((2, 3)).permute(2, 3, 0, 1).contiguous()
    lib = build.lib()
    with torch.cuda.device(dev):
        parts = lib.seg_stage1_bwd_parts(n, h, w, c)
        if parts <= 0:
            build.check(-parts, "seg_stage1_bwd_parts")
        f32 = dict(dtype=torch.float32, device=dev)
        dz1 = torch.empty_like(z1)
        dk2 = torch.empty((c, 3, 3, c), **f32)
        db2 = torch.empty((c,), **f32)
        dk_part = torch.empty((parts, 9 * c * c), **f32)
        db_part = torch.empty((parts, c), **f32)
        stream = torch.cuda.current_stream().cuda_stream
        if halos is None:
            db1 = None
            entry = "seg_stage1_tail_bwd"
            err = lib.seg_stage1_tail_bwd(
                *ptrs, wt.data_ptr(), dz1.data_ptr(), dk_part.data_ptr(),
                db_part.data_ptr(), parts, dk2.data_ptr(), db2.data_ptr(),
                n, h, w, c, stream)
        else:
            dparts = lib.seg_stage1_bwd_dgrad_parts(n, h, w, c)
            if dparts <= 0:
                build.check(-dparts, "seg_stage1_bwd_dgrad_parts")
            db1 = torch.empty((c,), **f32)
            db1_part = torch.empty((dparts, c), **f32)
            entry = "seg_stage1_tail_bwd_halo"
            err = lib.seg_stage1_tail_bwd_halo(
                *ptrs, wt.data_ptr(), dz1.data_ptr(), dk_part.data_ptr(),
                db_part.data_ptr(), db1_part.data_ptr(), parts, dparts,
                dk2.data_ptr(), db2.data_ptr(), db1.data_ptr(), n, h, w, c, stream)
    build.check(err, entry)
    return dz1, dk2.permute(0, 3, 1, 2).contiguous(), db2, db1


def stage1_tail_halo(z1: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
                     k2: torch.Tensor, b2: torch.Tensor, b1: torch.Tensor,
                     mode: str):
    """Kernel 1c's forward: as :func:`stage1_tail_halo_plain` defines it
    ("infer": out; "codes", "segnet": (out, codes)). CUDA: z1 as
    :func:`stage1_tail` takes it (bf16, contiguous NHWC), top and bot bf16
    contiguous [N,1,W,C]; k2, b2, b1 may be f32 (cast to bf16)."""
    if not _on_cuda(z1, "stage1 tail (halo mode)"):
        return stage1_tail_halo_plain(z1, top, bot, k2, b2, b1, mode)
    if mode not in _HALO_MODES:
        raise ValueError(f"mode must be one of {_HALO_MODES}, got {mode!r}")
    n, h, w, c = z1.shape
    for name, t in (("top", top), ("bot", bot)):
        _check_like(name, t, (n, 1, w, c), torch.bfloat16, z1.device)
    b1k = b1.to(torch.bfloat16).contiguous()
    _check_like("b1", b1k, (c,), torch.bfloat16, z1.device)
    out, codes = _forward(z1, k2, b2, with_codes=mode != "infer",
                          segnet=mode == "segnet", halo=(top, bot, b1k))
    stage1_tail_halo.launches += 1
    return out if mode == "infer" else (out, codes)


def stage1_tail_halo_bwd(g: torch.Tensor, out: torch.Tensor, codes: torch.Tensor,
                         z1: torch.Tensor, k2: torch.Tensor, b1: torch.Tensor,
                         halos: BwdHalos):
    """Kernel 1c's backward: (dz1, dk2 f32 OIHW, db2 f32, db1 f32) as
    :func:`stage1_tail_halo_bwd_plain` defines them. CUDA: z1 as
    :func:`stage1_tail_halo` takes it, out and codes as it made them; g and
    the float halos are cast to bf16. Two calls on the same inputs give the
    same bits (no float atomics)."""
    if not _on_cuda(z1, "stage1 tail backward (halo mode)"):
        return stage1_tail_halo_bwd_plain(g, out, codes, z1, k2, b1, halos)
    result = _backward(g, out, codes, z1, k2, b1, halos)
    stage1_tail_halo_bwd.launches += 1
    return result


stage1_tail.launches = 0
stage1_tail_train.launches = 0
stage1_tail_bwd.launches = 0
stage1_tail_segnet.launches = 0
stage1_tail_halo.launches = 0
stage1_tail_halo_bwd.launches = 0


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


def _halo_forward(ctx, z1, k2, b2, b1, grid, mode):
    [(top, bot)] = boundary_rows([z1], [float("-inf")], grid)
    out, codes = stage1_tail_halo(z1, top, bot, k2, b2, b1, mode)
    ctx.save_for_backward(z1, top, bot, k2, b1, out, codes)
    ctx.grid = grid
    ctx.dtypes = (k2.dtype, b2.dtype, b1.dtype)
    return out, codes


def _halo_backward(ctx, g):
    z1, top, bot, k2, b1, out, codes = ctx.saved_tensors
    g = g.to(z1.dtype).contiguous()
    (gt, gb), (ot, ob), (ct, cb) = boundary_rows([g, out, codes], [0, 0, 0],
                                                 ctx.grid)
    dz1, dk2, db2, db1 = stage1_tail_halo_bwd(
        g, out, codes, z1, k2, b1, BwdHalos(gt, gb, ot, ob, ct, cb, top, bot))
    kd, b2d, b1d = ctx.dtypes
    return dz1, dk2.to(kd), db2.to(b2d), db1.to(b1d), None


class Stage1TailHalo(torch.autograd.Function):
    """The stage1 tail in halo mode (the port of the ``jax.custom_vjp``
    around ``fused_stage1_tail(..., spmd=True)``, ``stage1.py:731-768``):
    ``apply(z1, k2, b2, b1, grid)`` with z1 this rank's rows of the conv1_1
    output WITHOUT b1 and ``grid`` the spatial grid the rows are split over
    (``parallel/mesh.py``; None for a whole image). Forward exchanges z1's
    boundary rows (``-inf`` at the image's edge) and runs
    :func:`stage1_tail_halo`; backward exchanges the boundary pooled rows of
    g, out and codes (0 at the edge) and returns (dz1, dk2, db2, db1) of this
    rank's rows. No gradient flows into the halo rows."""

    @staticmethod
    def forward(ctx, z1, k2, b2, b1, grid=None):
        out, codes = _halo_forward(ctx, z1, k2, b2, b1, grid, "codes")
        ctx.mark_non_differentiable(codes)
        return out

    @staticmethod
    def backward(ctx, g):
        return _halo_backward(ctx, g)


class SegNetStage1TailHalo(torch.autograd.Function):
    """SegNet's stage1 tail in halo mode (``fused_segnet_stage1_tail(...,
    spmd=True)``): ``apply(z1, k2, b2, b1, grid)`` returns (out, idx), idx
    non-differentiable; the backward is :class:`Stage1TailHalo`'s, routed by
    the index (``ops/pallas/stage1.py:819-826``)."""

    @staticmethod
    def forward(ctx, z1, k2, b2, b1, grid=None):
        out, idx = _halo_forward(ctx, z1, k2, b2, b1, grid, "segnet")
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g, _g_idx):
        return _halo_backward(ctx, g)
