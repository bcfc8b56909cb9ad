"""VGG stage1 tail: relu -> 3x3 SAME conv -> 2x2 max pool -> +b2 -> relu.

The port of ``ops/pallas/stage1.py:fused_stage1_tail`` (forward, FCN mode).
On the TPU the kernel packed width pairs into 128 lanes; on the H100 it is a
plain NHWC implicit GEMM (``csrc/stage1_tail.cu``) that never writes the
full-resolution conv output to device memory.

``stage1_tail`` launches the CUDA kernel for CUDA tensors (or raises) and
takes the plain PyTorch version, ``stage1_tail_plain``, only for tensors on
the CPU. ``stage1_tail.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stage1_tail_plain(z1: torch.Tensor, k2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in ``z1``'s dtype.

    z1: [N,H,W,C] conv1_1 output WITH its bias b1 (pre-relu), NHWC.
    k2: [C,C,3,3] conv1_2 kernel, OIHW (the port's parameter layout).
    b2: [C]. Returns [N,H/2,W/2,C]: relu(maxpool2(conv(relu(z1), k2)) + b2).
    With bf16 inputs the conv output is bf16 before the pool, as on the TPU.
    """
    dt = z1.dtype
    y = torch.relu(z1).permute(0, 3, 1, 2)
    z = F.conv2d(y, k2.to(dt), padding=1)
    p = F.max_pool2d(z, 2, ceil_mode=True)
    return torch.relu(p + b2.to(dt).view(1, -1, 1, 1)).permute(0, 2, 3, 1)


def _check(z1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor) -> None:
    if z1.dim() != 4:
        raise ValueError(f"z1 must be [N,H,W,C], got {tuple(z1.shape)}")
    n, h, w, c = z1.shape
    if z1.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA stage1 tail takes bf16 z1, got {z1.dtype}")
    if c not in (16, 32, 48, 64):
        raise ValueError(f"the CUDA stage1 tail takes C in 16, 32, 48, 64 (the "
                         f"stage1 widths; its weights sit whole in shared "
                         f"memory), got {c}")
    if h % 2 or w % 2:
        raise ValueError(f"H and W must be even, got {(h, w)}")
    if not z1.is_contiguous() or z1.data_ptr() % 16:
        raise ValueError("z1 must be a contiguous, 16-byte aligned NHWC tensor")
    if tuple(k2.shape) != (c, c, 3, 3):
        raise ValueError(f"k2 must be [{c},{c},3,3] (OIHW), got {tuple(k2.shape)}")
    if tuple(b2.shape) != (c,):
        raise ValueError(f"b2 must be [{c}], got {tuple(b2.shape)}")
    for t in (k2, b2):
        if t.device != z1.device:
            raise ValueError("z1, k2 and b2 must be on one device")


def stage1_tail(z1: torch.Tensor, k2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """The fused stage1 tail; see :func:`stage1_tail_plain` for the contract.

    CUDA: z1 must be bf16, contiguous NHWC, C one of 16/32/48/64, H and W
    even. k2 and b2 may be f32 (the port's params); they are cast to bf16.
    The kernel reads k2 in ``torch.channels_last`` memory.
    """
    if z1.device.type == "cpu":
        return stage1_tail_plain(z1, k2, b2)
    if z1.device.type != "cuda":
        raise ValueError(f"no stage1 tail for device {z1.device}")
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
    with torch.cuda.device(z1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seg_stage1_tail(z1.data_ptr(), wk.data_ptr(), bk.data_ptr(),
                                  out.data_ptr(), n, h, w, c, stream)
    build.check(err, "seg_stage1_tail")
    stage1_tail.launches += 1
    return out


stage1_tail.launches = 0
