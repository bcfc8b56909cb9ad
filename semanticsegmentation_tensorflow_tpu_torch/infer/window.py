"""Sliding-window (tiled) inference at an image's native resolution
(counterpart of the JAX package's ``infer/window.py``).

The image is edge-padded up to at least one tile, cut into overlapping
tiles of the training resolution (the last tile of a row or column
right-aligned), and all tiles go through one batched forward. Each tile's
f32 softmax probabilities are added into the full image in tile order; the
sum needs no divide, since the argmax of a sum of probabilities is that of
their average. The fused argmax + colormap + blend (``ops/cuda/overlay.py``,
kernel 2 on the card) then reads the summed probabilities in place.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.data.augment import normalize_images
from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    KITTI_OVERLAY_PALETTE,
)
from semanticsegmentation_tensorflow_tpu_torch.infer.predict import inference_form
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
    argmax_colormap_overlay_cuda,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import palette_tensor
from semanticsegmentation_tensorflow_tpu_torch.ops.shape import round_up


def tile_offsets(full: int, tile: int, overlap: int) -> list[int]:
    """Window start offsets covering [0, full) with at least ``overlap``
    pixels shared by neighbours; the last window is right-aligned, so the
    windows cover ``full`` exactly."""
    if full <= tile:
        return [0]
    step = max(1, tile - overlap)
    offs = list(range(0, full - tile, step))
    offs.append(full - tile)
    return offs


class TiledPredictor:
    """Native-resolution inference by overlapped tiles on ``device``.

    ``tile_size`` (the training resolution) is rounded up to the model's
    stride; ``overlap`` in pixels defaults to a quarter of the shorter tile
    side and must lie in [0, that side). ``__call__`` takes one [H, W, 3]
    uint8 image of any size and returns (overlay, labels) at its size. The
    model is taken over as the Predictor takes it (``inference_form``).
    ``grid`` is the (rows, cols) of the tile grid of the last call."""

    def __init__(self, model: nn.Module, tile_size: tuple[int, int], *,
                 device, overlap: int | None = None,
                 mean: Sequence[float] = (123.68, 116.779, 103.939),
                 std: Sequence[float] = (58.393, 57.12, 57.375),
                 overlay_palette: np.ndarray = KITTI_OVERLAY_PALETTE,
                 alpha: float = 0.5):
        self.device = torch.device(device)
        self.model = inference_form(model, self.device)
        stride = getattr(model, "total_stride", 32)
        self.tile = (round_up(tile_size[0], stride), round_up(tile_size[1], stride))
        self.overlap = min(self.tile) // 4 if overlap is None else int(overlap)
        if not 0 <= self.overlap < min(self.tile):
            raise ValueError(f"overlap {self.overlap} must be in "
                             f"[0, {min(self.tile)})")
        self._mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(std, dtype=torch.float32, device=self.device)
        self._palette = palette_tensor(np.asarray(overlay_palette), self.device)
        self._alpha = alpha
        self._cache: dict[tuple[int, int], tuple[list[int], list[int]]] = {}
        self.grid: tuple[int, int] | None = None

    def _offsets(self, h: int, w: int) -> tuple[list[int], list[int]]:
        """The tile rows' and columns' offsets for an (h, w) image, cached
        per shape."""
        if (h, w) not in self._cache:
            th, tw = self.tile
            self._cache[(h, w)] = (tile_offsets(max(h, th), th, self.overlap),
                                   tile_offsets(max(w, tw), tw, self.overlap))
        return self._cache[(h, w)]

    @torch.inference_mode()
    def summed_probs(self, image_u8: torch.Tensor) -> torch.Tensor:
        """[H,W,3] u8 on the device -> the tiles' f32 softmax probabilities
        summed into [1, max(H, tile H), max(W, tile W), C]."""
        h, w = image_u8.shape[:2]
        th, tw = self.tile
        ph, pw = max(h, th), max(w, tw)
        ys, xs = self._offsets(h, w)
        x = normalize_images(image_u8[None], self._mean, self._std)
        if (ph, pw) != (h, w):
            x = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                        (0, pw - w, 0, ph - h), mode="replicate"
                                        ).permute(0, 2, 3, 1)
        tiles = torch.stack([x[0, y:y + th, xo:xo + tw] for y in ys for xo in xs])
        probs = torch.softmax(self.model(tiles.contiguous()).float(), dim=-1)
        acc = torch.zeros((1, ph, pw, probs.shape[-1]), dtype=torch.float32,
                          device=self.device)
        for i, y in enumerate(ys):
            for j, xo in enumerate(xs):
                acc[0, y:y + th, xo:xo + tw] += probs[i * len(xs) + j]
        return acc

    @torch.inference_mode()
    def _fwd(self, image_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[H,W,3] u8 on the device -> (overlay [1,H,W,3], labels [1,H,W])."""
        return argmax_colormap_overlay_cuda(image_u8[None].contiguous(),
                                            self.summed_probs(image_u8),
                                            self._palette, self._alpha)

    def __call__(self, image_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if image_u8.ndim != 3:
            raise ValueError("TiledPredictor takes one [H, W, 3] image")
        ys, xs = self._offsets(*image_u8.shape[:2])
        self.grid = (len(ys), len(xs))
        img = torch.from_numpy(np.require(image_u8, np.uint8, "CW")).to(self.device)
        overlay, labels = self._fwd(img)
        return overlay[0].cpu().numpy(), labels[0].cpu().numpy()
