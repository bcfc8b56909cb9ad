"""Training augmentation on the device: random flip + random crop in the
uint8 domain, then per-channel normalize (counterpart of the JAX package's
``data/augment.py``).

The per-example parameters (flip, oy, ox) come from one place,
:func:`sample_augment_params`, drawn from an explicit ``torch.Generator``;
both augment paths (this module's, which divides by std like the JAX
package's ``make_augment_fn``, and ``ops.cuda.preprocess``'s kernel, which
multiplies by 1/std like ``make_pallas_augment_fn``) consume them. Scale and
color jitter are not ported yet.

Under an active grid of several ranks (``parallel/mesh.py``) each rank holds
its images and rows of the global batch: the flips are drawn for the global
batch from the shared generator and each rank keeps its images', so the grid
step equals the single-process step. A grid trains without crop (the JAX
package's ``scripts/train.py:265-269``); flip and normalize need no
neighbouring row, so the preprocess kernel runs on each rank's rows.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import current_grid


def normalize_images(images: torch.Tensor,
                     mean: Sequence[float] | torch.Tensor,
                     std: Sequence[float] | torch.Tensor) -> torch.Tensor:
    """uint8/float [..., 3] -> float32 per-channel (x - mean) / std.
    Divides by std, as the JAX package does (not a reciprocal multiply).
    ``mean``/``std`` already on the device cost no host->device copy."""
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) - mean_t) / std_t


def sample_augment_params(generator: torch.Generator, n: int, h: int, w: int,
                          crop_hw: tuple[int, int] | None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-example (flip [N] bool, oy [N] int64, ox [N] int64), drawn on
    ``generator``'s device: a fair coin per example, and crop offsets
    uniform over the positions where the crop fits (zeros without a crop)."""
    dev = generator.device
    flip = torch.rand(n, generator=generator, device=dev) < 0.5
    if crop_hw is None:
        zeros = torch.zeros(n, dtype=torch.int64, device=dev)
        return flip, zeros, zeros
    ch, cw = crop_hw
    if ch > h or cw > w:
        raise ValueError(f"crop {crop_hw} larger than the images {(h, w)}")
    oy = torch.randint(0, h - ch + 1, (n,), generator=generator, device=dev)
    ox = torch.randint(0, w - cw + 1, (n,), generator=generator, device=dev)
    return flip, oy, ox


def flip_crop(t: torch.Tensor, flip: torch.Tensor, oy: torch.Tensor,
              ox: torch.Tensor, crop_hw: tuple[int, int] | None) -> torch.Tensor:
    """[N,H,W,...] -> [N,ch,cw,...]: per example, mirror the full width where
    ``flip``, then take rows oy..oy+ch and columns ox..ox+cw (one gather; no
    crop keeps H and W)."""
    n, h, w = t.shape[:3]
    ch, cw = crop_hw or (h, w)
    dev = t.device
    flip, oy, ox = (a.to(dev) for a in (flip, oy, ox))
    rows = oy[:, None] + torch.arange(ch, device=dev)
    cols = ox[:, None] + torch.arange(cw, device=dev)
    cols = torch.where(flip[:, None], w - 1 - cols, cols)
    return t[torch.arange(n, device=dev)[:, None, None], rows[:, :, None],
             cols[:, None, :]]


ImageFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                   torch.Tensor]


class Augment:
    """``augment(generator, batch) -> batch`` for the train step: draws
    (flip, oy, ox) and applies them with :meth:`apply`. ``image_fn(images,
    flip, oy, ox)`` makes the normalized float32 image; labels and ``valid``
    (all-ones when absent) are flipped and cropped with :func:`flip_crop`."""

    def __init__(self, image_fn: ImageFn, crop_size: tuple[int, int] | None,
                 random_flip: bool):
        self.image_fn = image_fn
        self.crop_size = crop_size
        self.random_flip = random_flip

    def __call__(self, generator: torch.Generator, batch: dict) -> dict:
        n, h, w = batch["label"].shape
        grid = current_grid()
        if grid is None or grid.world == 1:
            return self.apply(batch, *sample_augment_params(
                generator, n, h, w, self.crop_size))
        if self.crop_size is not None:
            raise ValueError("a grid of ranks trains without random crop")
        flip, oy, ox = sample_augment_params(
            generator, n * grid.data, h * grid.spatial, w, None)
        mine = grid.images(n * grid.data)
        return self.apply(batch, flip[mine], oy[mine], ox[mine])

    def apply(self, batch: dict, flip: torch.Tensor, oy: torch.Tensor,
              ox: torch.Tensor) -> dict:
        lbl = batch["label"]
        val = batch.get("valid")
        if val is None:
            val = torch.ones(lbl.shape, dtype=torch.bool, device=lbl.device)
        if not self.random_flip:
            flip = torch.zeros_like(flip)
        return {"image": self.image_fn(batch["image"], flip, oy, ox),
                "label": flip_crop(lbl, flip, oy, ox, self.crop_size),
                "valid": flip_crop(val, flip, oy, ox, self.crop_size)}


def make_augment_fn(mean: Sequence[float], std: Sequence[float],
                    crop_size: tuple[int, int] | None = None,
                    random_flip: bool = True,
                    scale_jitter: Sequence[float] | None = None,
                    color_jitter: Sequence[float] | None = None) -> Augment:
    """Flip and crop in the uint8 domain, then :func:`normalize_images`
    (a spatial permutation commutes exactly with the per-channel
    normalize). Images may be uint8 or float; the output is float32
    [N, *crop_size, 3]."""
    if scale_jitter or color_jitter:
        raise NotImplementedError("scale and color jitter are not ported yet")

    def image_fn(images, flip, oy, ox):
        return normalize_images(flip_crop(images, flip, oy, ox, crop_size),
                                mean, std)

    return Augment(image_fn, crop_size, random_flip)
