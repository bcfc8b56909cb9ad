"""Training augmentation on the device: random flip + random crop in the
uint8 domain, then per-channel normalize (counterpart of the JAX package's
``data/augment.py``).

The per-example parameters (flip, oy, ox) come from one place,
:func:`sample_augment_params`, drawn from an explicit ``torch.Generator``;
both augment paths (this module's, which divides by std like the JAX
package's ``make_augment_fn``, and ``ops.cuda.preprocess``'s kernel, which
multiplies by 1/std like ``make_pallas_augment_fn``) consume them.

Scale jitter (one scale per batch, :func:`scale_jitter`) and color jitter
(per example, :func:`color_jitter`) run before flip and crop, in the JAX
package's order: scale on the full image, color in the 0..255 domain
rounded back to uint8, then flip and crop, then normalize. Each takes its
draws as arguments; :class:`Augment` draws them from its generator (scale
index and offsets, then brightness, contrast and saturation factors, then
flip and crop) only when the jitter is on, so with both off the
generator's stream is unchanged.

Under an active grid of several ranks (``parallel/mesh.py``) each rank holds
its images and rows of the global batch: the flips and crop offsets are
drawn for the global batch from the shared generator and each rank keeps
its images', so the grid step equals the single-process step. A grid that
splits rows trains without crop (the JAX package's
``scripts/train.py:262-269``; a data grid crops each rank's images, as the
JAX 1-D mesh does); flip and normalize need no neighbouring row, so the
preprocess kernel runs on each rank's rows.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (
    current_grid, spatial_grid,
)

LUMA = (0.299, 0.587, 0.114)


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


def scaled_hw(h: int, w: int, scale: float) -> tuple[int, int]:
    return max(1, int(round(h * scale))), max(1, int(round(w * scale)))


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize``'s "nearest": half-pixel centres, the source
    index ``floor((i + 0.5) * n_in / n_out)`` in float32."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).long()


def scale_jitter(img: torch.Tensor, lbl: torch.Tensor, val: torch.Tensor,
                 scale: float, oy: int, ox: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resize the whole batch by ``scale`` and back to its (H, W): a
    zoom-in takes the (H, W) window at (oy, ox) of the resized batch, a
    zoom-out places it at (oy, ox) on a zero canvas whose outside is
    ``valid=0``. Images resize bilinearly in f32 with antialiasing (as
    ``jax.image.resize``), rounded half-even and clipped back to uint8;
    labels and ``valid`` take the nearest pixel."""
    n, h, w = lbl.shape
    hs, ws = scaled_hw(h, w, scale)
    if (hs, ws) == (h, w):
        return img, lbl, val
    im = F.interpolate(img.float().permute(0, 3, 1, 2), size=(hs, ws),
                       mode="bilinear", align_corners=False, antialias=True
                       ).permute(0, 2, 3, 1)
    im = (torch.round(im).clamp(0, 255).to(img.dtype)
          if not img.is_floating_point() else im.to(img.dtype))
    rows = _nearest_index(h, hs, lbl.device)[:, None]
    cols = _nearest_index(w, ws, lbl.device)[None, :]
    lb, va = lbl[:, rows, cols], val[:, rows, cols]
    if hs >= h and ws >= w:                       # zoom in: crop back
        win = (slice(None), slice(oy, oy + h), slice(ox, ox + w))
        return im[win], lb[win], va[win]
    out = []                                       # zoom out: zero canvas
    for t in (im, lb, va):
        canvas = t.new_zeros((n, h, w, *t.shape[3:]))
        canvas[:, oy:oy + hs, ox:ox + ws] = t
        out.append(canvas)
    return tuple(out)


def sample_scale_params(generator: torch.Generator, scales: Sequence[float],
                        h: int, w: int) -> tuple[float, int, int]:
    """(scale, oy, ox) for :func:`scale_jitter`: a uniform scale index,
    then offsets uniform over the zoom-in's windows or the zoom-out's
    placements (none drawn at an identity scale)."""
    def randint(hi: int) -> int:
        return int(torch.randint(0, hi, (1,), generator=generator,
                                 device=generator.device).item())

    scale = float(scales[randint(len(scales))])
    hs, ws = scaled_hw(h, w, scale)
    if (hs, ws) == (h, w):
        return scale, 0, 0
    return scale, randint(abs(hs - h) + 1), randint(abs(ws - w) + 1)


def color_jitter(images: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor, saturation: torch.Tensor,
                 bcs: tuple[float, float, float]) -> torch.Tensor:
    """Per-example photometric jitter of [N, H, W, 3] images in the 0..255
    domain: saturation toward each pixel's luma by ``saturation`` [N],
    contrast about the image's mean luma by ``contrast`` [N], then
    ``brightness * 255`` [N] added (each step only where its magnitude in
    ``bcs`` is nonzero); clipped to 0..255 and, for uint8, rounded
    half-even. Under a grid that splits rows the mean luma is the whole
    image's (one SUM over the rank's spatial group)."""
    b, c, s = bcs
    dev = images.device
    x = images.float()
    luma_w = torch.tensor(LUMA, dtype=torch.float32, device=dev)
    per_image = (-1, 1, 1, 1)
    if s:
        luma = (x * luma_w).sum(-1, keepdim=True)
        x = luma + (x - luma) * saturation.to(dev).view(per_image)
    if c:
        total = (x * luma_w).sum(-1).sum((1, 2))
        count = x.shape[1] * x.shape[2]
        grid = spatial_grid()
        if grid is not None:
            dist.all_reduce(total, group=grid.spatial_group)
            count = sum(r for _, r in grid.level_splits(x.shape[1])) * x.shape[2]
        m = (total / count).view(per_image)
        x = m + (x - m) * contrast.to(dev).view(per_image)
    if b:
        x = x + brightness.to(dev).view(per_image) * 255.0
    x = x.clamp(0.0, 255.0)
    return (x.to(images.dtype) if images.is_floating_point()
            else torch.round(x).to(images.dtype))


def sample_color_params(generator: torch.Generator, n: int,
                        bcs: tuple[float, float, float]
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-example (brightness in [-b, b], contrast factor in [1-c, 1+c],
    saturation factor in [1-s, 1+s]), [N] each, drawn in that order."""
    b, c, s = bcs
    u = [torch.rand(n, generator=generator, device=generator.device)
         for _ in range(3)]
    return (u[0] * 2 * b - b, 1.0 - c + u[1] * 2 * c, 1.0 - s + u[2] * 2 * s)


def check_color_jitter(color_jitter: Sequence[float] | None
                       ) -> tuple[float, float, float] | None:
    """Validated (brightness, contrast, saturation); None when off (absent
    or all zero)."""
    if not color_jitter:
        return None
    color = tuple(float(v) for v in color_jitter)
    if len(color) != 3 or any(v < 0 for v in color):
        raise ValueError("color_jitter must be 3 non-negative magnitudes "
                         "(brightness, contrast, saturation)")
    return color if any(color) else None


ImageFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                   torch.Tensor]


class Augment:
    """``augment(generator, batch) -> batch`` for the train step: draws the
    jitters' parameters (when on) and (flip, oy, ox), and applies them with
    :meth:`apply`. ``image_fn(images, flip, oy, ox)`` makes the normalized
    float32 image; labels and ``valid`` (all-ones when absent) are flipped
    and cropped with :func:`flip_crop`."""

    def __init__(self, image_fn: ImageFn, crop_size: tuple[int, int] | None,
                 random_flip: bool, scale_jitter: Sequence[float] | None = None,
                 color_jitter: Sequence[float] | None = None):
        self.image_fn = image_fn
        self.crop_size = crop_size
        self.random_flip = random_flip
        self.scales = tuple(float(s) for s in scale_jitter) if scale_jitter else None
        self.color = check_color_jitter(color_jitter)

    def __call__(self, generator: torch.Generator, batch: dict) -> dict:
        n, h, w = batch["label"].shape
        grid = current_grid()
        data, spatial = (1, 1) if grid is None else (grid.data, grid.spatial)
        mine = slice(None) if grid is None else grid.images(n * data)
        if self.scales and spatial > 1:
            raise ValueError("scale jitter needs whole images (no spatial grid)")
        if spatial > 1 and self.crop_size is not None:
            raise ValueError("a grid that splits rows trains without random crop")
        scale = (sample_scale_params(generator, self.scales, h, w)
                 if self.scales else None)
        color = (tuple(t[mine] for t in sample_color_params(
            generator, n * data, self.color)) if self.color else None)
        h_all = h if spatial == 1 else sum(r for _, r in grid.level_splits(h))
        flip, oy, ox = sample_augment_params(generator, n * data, h_all, w,
                                             self.crop_size)
        return self.apply(batch, flip[mine], oy[mine], ox[mine], scale, color)

    def apply(self, batch: dict, flip: torch.Tensor, oy: torch.Tensor,
              ox: torch.Tensor, scale: tuple[float, int, int] | None = None,
              color: tuple[torch.Tensor, ...] | None = None) -> dict:
        """``scale``: (scale, oy, ox) of :func:`scale_jitter`; ``color``:
        (brightness, contrast, saturation) of :func:`color_jitter`."""
        img, lbl = batch["image"], batch["label"]
        val = batch.get("valid")
        if val is None:
            val = torch.ones(lbl.shape, dtype=torch.bool, device=lbl.device)
        if scale is not None:
            img, lbl, val = scale_jitter(img, lbl, val, *scale)
        if color is not None:
            img = color_jitter(img, *color, self.color)
        if not self.random_flip:
            flip = torch.zeros_like(flip)
        return {"image": self.image_fn(img, flip, oy, ox),
                "label": flip_crop(lbl, flip, oy, ox, self.crop_size),
                "valid": flip_crop(val, flip, oy, ox, self.crop_size)}


def make_augment_fn(mean: Sequence[float], std: Sequence[float],
                    crop_size: tuple[int, int] | None = None,
                    random_flip: bool = True,
                    scale_jitter: Sequence[float] | None = None,
                    color_jitter: Sequence[float] | None = None) -> Augment:
    """Scale and color jitter when given (module docstring), flip and crop
    in the uint8 domain, then :func:`normalize_images` (a spatial
    permutation commutes exactly with the per-channel normalize). Images
    may be uint8 or float; the output is float32 [N, *crop_size, 3]."""

    def image_fn(images, flip, oy, ox):
        return normalize_images(flip_crop(images, flip, oy, ox, crop_size),
                                mean, std)

    return Augment(image_fn, crop_size, random_flip, scale_jitter, color_jitter)
