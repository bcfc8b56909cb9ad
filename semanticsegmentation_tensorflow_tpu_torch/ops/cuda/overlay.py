"""Fused argmax + colormap + alpha blend (one pass over the logits).

The port of ``ops/pallas/overlay.py:argmax_colormap_overlay_pallas``; the
kernel is ``csrc/overlay.cu``. Its plain PyTorch version is
``ops/overlay.py:argmax_colormap_overlay`` (the counterpart of the JAX
package's reference in ``ops/overlay.py``), imported here as
``argmax_colormap_overlay_plain``.

``argmax_colormap_overlay_cuda`` launches the kernel for CUDA tensors (or
raises) and takes the plain version only for tensors on the CPU.
``argmax_colormap_overlay_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
    argmax_colormap_overlay as argmax_colormap_overlay_plain,
    palette_tensor,
)


def argmax_colormap_overlay_cuda(image_u8: torch.Tensor, logits: torch.Tensor,
                                 palette, alpha: float = 0.5,
                                 blend_class0: bool = False
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """image_u8 [N,H,W,3] u8, logits [N,Hp,Wp,C] f32 with Hp >= H, Wp >= W
    (the padded model output: the top-left [H,W] window is read in place),
    palette [C,3] -> (overlay [N,H,W,3] u8, labels [N,H,W] i32).

    Bit-equal to the plain version: the blend is rounded like PyTorch's
    separate multiply, multiply and add (no FMA contraction)."""
    n, h, w, _ = image_u8.shape
    if logits.dim() != 4 or logits.shape[0] != n or logits.shape[1] < h \
            or logits.shape[2] < w:
        raise ValueError(f"logits {tuple(logits.shape)} do not cover the "
                         f"image {tuple(image_u8.shape)}")
    if image_u8.device.type == "cpu":
        return argmax_colormap_overlay_plain(
            image_u8, logits[:, :h, :w], palette, alpha, blend_class0)
    if image_u8.device.type != "cuda":
        raise ValueError(f"no overlay kernel for device {image_u8.device}")
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    c = logits.shape[-1]
    if image_u8.dtype != torch.uint8 or image_u8.shape[-1] != 3:
        raise TypeError(f"image must be [N,H,W,3] uint8, got "
                        f"{tuple(image_u8.shape)} {image_u8.dtype}")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if logits.device != image_u8.device:
        raise ValueError("image and logits must be on one device")
    if not (image_u8.is_contiguous() and logits.is_contiguous()) \
            or logits.data_ptr() % 8:
        raise ValueError("image and logits must be contiguous; logits "
                         "8-byte aligned")
    pal = palette_tensor(palette, image_u8.device).contiguous()
    if tuple(pal.shape) != (c, 3):
        raise ValueError(f"palette must be [{c},3], got {tuple(pal.shape)}")
    lib = build.lib()
    out = torch.empty_like(image_u8)
    labels = torch.empty((n, h, w), dtype=torch.int32, device=image_u8.device)
    with torch.cuda.device(image_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seg_overlay(image_u8.data_ptr(), logits.data_ptr(),
                              pal.data_ptr(), out.data_ptr(), labels.data_ptr(),
                              n, h, w, logits.shape[1], logits.shape[2], c,
                              float(alpha), float(1.0 - alpha),
                              int(blend_class0), stream)
    build.check(err, "seg_overlay")
    argmax_colormap_overlay_cuda.launches += 1
    return out, labels


argmax_colormap_overlay_cuda.launches = 0
