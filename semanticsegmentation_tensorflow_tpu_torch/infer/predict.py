"""Prediction: overlay and label maps for a fixed image size (counterpart of
the JAX package's ``infer/predict.py:Predictor``).

Per batch: normalize, edge-pad to the model's stride, forward, then either
the fused argmax + colormap + blend (``__call__``: the CUDA overlay kernel
reads the padded logits in place, so the crop is free) or the label map,
bit-packed on the device for the fetch (``_fetch_labels``, the serving
path, which blends on the host). Only uint8 crosses the host boundary.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.data.augment import normalize_images
from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    KITTI_OVERLAY_PALETTE,
)
from semanticsegmentation_tensorflow_tpu_torch.ops import labelpack
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
    argmax_colormap_overlay_cuda,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
    labels_from_logits, palette_tensor,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.shape import (
    crop_to, pad_to_multiple,
)


class Predictor:
    """Forward + overlay for a fixed image size on an explicit ``device``.

    ``model`` maps NHWC float input to NHWC float32 logits and carries
    ``num_classes`` (and ``total_stride``, default 32; ``dtype``, its
    compute dtype).

    The Predictor takes ownership of ``model``: it moves it to ``device``,
    puts it in eval mode and casts its parameters once, in place, to the
    compute dtype and to channels_last memory, the form every conv (and the
    stage1 kernel) would otherwise convert them to on each call: the same
    outputs, without ~40 copy kernels per image. The caller's module then
    holds bf16 parameters, an inference-only form; to keep the f32 ones
    (for training, or to save them), pass a copy."""

    def __init__(self, model: nn.Module, image_size: tuple[int, int], *,
                 device, mean: Sequence[float] = (123.68, 116.779, 103.939),
                 std: Sequence[float] = (58.393, 57.12, 57.375),
                 overlay_palette: np.ndarray = KITTI_OVERLAY_PALETTE,
                 alpha: float = 0.5):
        self.device = torch.device(device)
        self.model = model.to(self.device, getattr(model, "dtype", None),
                              memory_format=torch.channels_last).eval()
        self.image_size = tuple(image_size)
        self._stride = getattr(model, "total_stride", 32)
        self._mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(std, dtype=torch.float32, device=self.device)
        self._palette = np.asarray(overlay_palette)
        self._palette_dev = palette_tensor(self._palette, self.device)
        self._alpha = alpha
        self._pack_mode = labelpack.pack_mode(model.num_classes)

    def _to_device(self, image_u8: np.ndarray) -> torch.Tensor:
        if tuple(image_u8.shape[1:3]) != self.image_size:
            raise ValueError(f"images must be {self.image_size}, got "
                             f"{tuple(image_u8.shape[1:3])}")
        # writable + contiguous (PIL arrays are read-only): copies only then
        return torch.from_numpy(np.require(image_u8, np.uint8, "CW")).to(
            self.device)

    @torch.inference_mode()
    def _padded_logits(self, image_u8: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] u8 on the device -> padded [N,Hp,Wp,C] f32 logits."""
        x = normalize_images(image_u8, self._mean, self._std)
        x = pad_to_multiple(x, self._stride)
        return self.model(x).contiguous()

    @torch.inference_mode()
    def _fwd(self, image_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return argmax_colormap_overlay_cuda(
            image_u8, self._padded_logits(image_u8), self._palette_dev,
            self._alpha)

    @torch.inference_mode()
    def _packed_labels(self, image_u8: torch.Tensor) -> torch.Tensor:
        """[N,H,W,3] u8 on the device -> the label map packed on the device
        (1 bit/px for 2 classes, a nibble up to 16, raw beyond)."""
        logits = crop_to(self._padded_logits(image_u8), *self.image_size)
        labels = labels_from_logits(logits)
        labels = labels.to(torch.uint8 if logits.shape[-1] <= 256
                           else torch.int32)
        return labelpack.pack_labels(labels, self._pack_mode)

    def _fetch_labels(self, image_u8: np.ndarray) -> np.ndarray:
        """[N,H,W,3] u8 -> [N,H,W] label map: forward, pack on the device,
        fetch, unpack on the host."""
        packed = self._packed_labels(self._to_device(image_u8))
        return labelpack.unpack_labels(packed.cpu().numpy(),
                                       self.image_size[1], self._pack_mode)

    def __call__(self, image_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """[H,W,3] or [N,H,W,3] uint8 -> (overlay u8, labels i32), same rank."""
        squeeze = image_u8.ndim == 3
        if squeeze:
            image_u8 = image_u8[None]
        overlay, labels = self._fwd(self._to_device(image_u8))
        overlay, labels = overlay.cpu().numpy(), labels.cpu().numpy()
        return (overlay[0], labels[0]) if squeeze else (overlay, labels)

    def predict_file(self, path: str) -> tuple[np.ndarray, np.ndarray]:
        return self(load_image(path, self.image_size))
