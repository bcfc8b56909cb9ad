"""Argmax + colormap overlay, plain PyTorch, and its numpy host mirror.

Counterpart of ``semanticsegmentation_tensorflow_tpu/ops/overlay.py``. The
fused CUDA kernel that computes the same thing in one pass lives in
``ops/cuda/overlay.py``; :func:`argmax_colormap_overlay` here is its plain
version.
"""

from __future__ import annotations

import numpy as np
import torch


def labels_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """[..., C] logits -> [...] int64 class ids; ties go to the lowest class.
    For C == 2 this is ``l1 > l0`` (equal to argmax, ties -> class 0)."""
    if logits.shape[-1] == 2:
        return (logits[..., 1] > logits[..., 0]).long()
    return torch.argmax(logits, dim=-1)


def palette_tensor(palette, device) -> torch.Tensor:
    """[C, 3] palette (array or tensor) as an f32 tensor on ``device``."""
    if not torch.is_tensor(palette):
        palette = torch.as_tensor(np.asarray(palette))
    return palette.to(device, torch.float32)


def argmax_colormap_overlay(image_u8: torch.Tensor, logits: torch.Tensor,
                            palette, alpha: float = 0.5,
                            blend_class0: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blend a class colormap over an image.

    image_u8 [..., H, W, 3] uint8, logits [..., H, W, C], palette [C, 3]
    (uint8, array or tensor). Class-0 pixels keep the image unless
    ``blend_class0``. Returns (overlay u8 [..., H, W, 3], labels i32 [..., H, W]).
    """
    labels = labels_from_logits(logits)
    colors = palette_tensor(palette, image_u8.device)[labels]
    img = image_u8.float()
    blended = img * (1.0 - alpha) + colors * alpha
    if not blend_class0:
        blended = torch.where((labels == 0)[..., None], img, blended)
    return blended.clamp(0, 255).to(torch.uint8), labels.to(torch.int32)


_BLEND_LUT_CACHE: dict = {}


def _blend_lut(palette: np.ndarray, alpha: float,
               blend_class0: bool) -> np.ndarray:
    """lut[class, channel, byte]: the blend of :func:`host_overlay` for
    every image byte, with its own f32 arithmetic. The blend is a function
    of (byte, class, channel) alone, so a walk through this table is
    bit-equal to it."""
    key = (palette.tobytes(), palette.shape[0], float(alpha),
           bool(blend_class0))
    lut = _BLEND_LUT_CACHE.get(key)
    if lut is None:
        nc = palette.shape[0]
        img = np.broadcast_to(np.arange(256, dtype=np.float32), (nc, 3, 256))
        colors = palette.astype(np.float32)[:, :, None]
        blended = img * np.float32(1.0 - alpha) + colors * np.float32(alpha)
        if not blend_class0:
            blended = np.where((np.arange(nc) == 0)[:, None, None], img,
                               blended)
        lut = np.ascontiguousarray(np.clip(blended, 0, 255).astype(np.uint8))
        _BLEND_LUT_CACHE[key] = lut
    return lut


def host_overlay(image_u8: np.ndarray, labels_u8: np.ndarray, palette,
                 alpha: float = 0.5, blend_class0: bool = False) -> np.ndarray:
    """Numpy mirror of the blend in :func:`argmax_colormap_overlay`, for the
    serving path and the test-set sweep, which fetch only the label map and
    composite on the host from the image they already decoded. Same f32
    arithmetic.

    Where the native library is built (``native/``), a u8 [H, W, 3] image
    with u8 labels is blended by a walk through :func:`_blend_lut`'s table in
    C++, bit-equal to :func:`blend_numpy`."""
    from semanticsegmentation_tensorflow_tpu_torch import native

    palette = np.asarray(palette)
    if (native.available() and image_u8.ndim == 3
            and image_u8.dtype == np.uint8 and labels_u8.dtype == np.uint8
            and palette.shape[0] <= 256):
        return native.overlay_lut(image_u8, labels_u8,
                                  _blend_lut(palette, alpha, blend_class0))
    return blend_numpy(image_u8, labels_u8, palette, alpha, blend_class0)


def blend_numpy(image_u8: np.ndarray, labels_u8: np.ndarray,
                palette: np.ndarray, alpha: float = 0.5,
                blend_class0: bool = False) -> np.ndarray:
    """:func:`host_overlay`'s numpy branch: the blend in f32 per pixel."""
    img = image_u8.astype(np.float32)
    colors = palette.astype(np.float32)[labels_u8]
    blended = img * np.float32(1.0 - alpha) + colors * np.float32(alpha)
    if not blend_class0:
        blended = np.where((labels_u8 == 0)[..., None], img, blended)
    return np.clip(blended, 0, 255).astype(np.uint8)
