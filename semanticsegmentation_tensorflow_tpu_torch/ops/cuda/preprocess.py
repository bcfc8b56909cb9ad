"""Training input preprocess: flip + crop + uint8 -> normalized float32.

The port of ``ops/pallas/preprocess.py:pallas_normalize`` and its wrapper
``make_pallas_augment_fn``. On the TPU only the normalize was a kernel; the
CUDA kernel (``csrc/preprocess.cu``) fuses the per-example flip and crop
into the same pass and writes the cropped float32 batch once.

``preprocess_normalize`` launches the kernel for CUDA tensors (or raises)
and takes the plain PyTorch version, ``preprocess_normalize_plain``, only
for tensors on the CPU. Both multiply by the float32 rounding of 1/std
computed in double, as the TPU kernel does (``preprocess.py:46``), and are
bit-equal. ``preprocess_normalize.launches`` counts kernel launches.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch

from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
    Augment, flip_crop,
)


def _constants(mean: Sequence[float], std: Sequence[float]
               ) -> tuple[list[float], list[float]]:
    """(mean, 1/std) as the float32 values the kernel uses."""
    mean32 = torch.tensor([float(m) for m in mean], dtype=torch.float32)
    inv32 = torch.tensor([1.0 / float(s) for s in std], dtype=torch.float32)
    return mean32.tolist(), inv32.tolist()


def _check(images: torch.Tensor, crop_hw) -> tuple[int, int]:
    if images.dtype != torch.uint8:
        raise TypeError(f"the preprocess kernel takes uint8 images, got "
                        f"{images.dtype}; use data.augment.make_augment_fn "
                        "for float inputs")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [N,H,W,3], got {tuple(images.shape)}")
    return crop_hw or tuple(images.shape[1:3])


def preprocess_normalize_plain(images: torch.Tensor, flip: torch.Tensor,
                               oy: torch.Tensor, ox: torch.Tensor,
                               crop_hw: tuple[int, int] | None,
                               mean: Sequence[float],
                               std: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version: [N,H,W,3] u8 -> [N,ch,cw,3] f32,
    ``(flip_crop(images) - mean) * (1/std)``."""
    _check(images, crop_hw)
    mean32, inv32 = _constants(mean, std)
    x = flip_crop(images, flip, oy, ox, crop_hw).to(torch.float32)
    return ((x - torch.tensor(mean32, device=x.device))
            * torch.tensor(inv32, device=x.device))


def preprocess_normalize(images: torch.Tensor, flip: torch.Tensor,
                         oy: torch.Tensor, ox: torch.Tensor,
                         crop_hw: tuple[int, int] | None,
                         mean: Sequence[float],
                         std: Sequence[float]) -> torch.Tensor:
    """Flip, crop and normalize in one pass; see
    :func:`preprocess_normalize_plain`. ``flip``, ``oy``, ``ox`` are [N]
    tensors on any device (the offsets are checked on the host)."""
    if images.device.type == "cpu":
        return preprocess_normalize_plain(images, flip, oy, ox, crop_hw,
                                          mean, std)
    if images.device.type != "cuda":
        raise ValueError(f"no preprocess kernel for device {images.device}")
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build

    ch, cw = _check(images, crop_hw)
    n, h, w, _ = images.shape
    params = torch.stack([flip.to(torch.int64), oy.to(torch.int64),
                          ox.to(torch.int64)], 1).cpu()
    if tuple(params.shape) != (n, 3):
        raise ValueError(f"flip, oy, ox must each be [{n}]")
    if bool((params[:, 1] < 0).any() or (params[:, 1] + ch > h).any()
            or (params[:, 2] < 0).any() or (params[:, 2] + cw > w).any()):
        raise ValueError(f"crop {(ch, cw)} at offsets {params[:, 1:].tolist()} "
                         f"leaves the {(h, w)} images")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous NHWC")
    mean32, inv32 = _constants(mean, std)
    lib = build.lib()
    dev_params = params.to(images.device, torch.int32)
    out = torch.empty((n, ch, cw, 3), dtype=torch.float32, device=images.device)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.seg_preprocess(images.data_ptr(), dev_params.data_ptr(),
                                 out.data_ptr(), n, h, w, ch, cw, *mean32,
                                 *inv32, stream)
    build.check(err, "seg_preprocess")
    preprocess_normalize.launches += 1
    return out


preprocess_normalize.launches = 0


def make_preprocess_augment_fn(mean: Sequence[float], std: Sequence[float],
                               crop_size: tuple[int, int] | None = None,
                               random_flip: bool = True) -> Augment:
    """Drop-in for ``data.augment.make_augment_fn`` (the same draws) with
    the image leg through :func:`preprocess_normalize`; uint8 images only
    (``--pallas-preprocess``)."""
    return Augment(partial(preprocess_normalize, crop_hw=crop_size, mean=mean,
                           std=std), crop_size, random_flip)
