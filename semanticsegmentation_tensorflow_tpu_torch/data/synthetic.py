"""Synthetic KITTI-shaped fixtures (copied from the JAX package's
``data/synthetic.py``; numpy only, so the same seed gives the same images).

Road-like trapezoids on noise backgrounds, with GT encoded in the real KITTI
color scheme. ``generate_synthetic_kitti`` writes an on-disk data_road/ tree
so the file-based path (glob -> decode -> encode) runs end to end.
"""

from __future__ import annotations

import os

import numpy as np

from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    KITTI_ROAD_PALETTE, decode_labels,
)


def _road_scene(rng: np.random.Generator, h: int, w: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (image u8 [h,w,3], label i32 [h,w]) with a road trapezoid."""
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    # vertical gradient sky/ground to give the net something learnable
    grad = np.linspace(180, 60, h, dtype=np.float32)[:, None, None]
    img = (img.astype(np.float32) * 0.3 + grad * 0.7).astype(np.uint8)

    label = np.zeros((h, w), np.int32)
    horizon = int(h * rng.uniform(0.35, 0.55))
    center = int(w * rng.uniform(0.3, 0.7))
    top_half = int(w * rng.uniform(0.02, 0.08))
    bot_half = int(w * rng.uniform(0.25, 0.45))
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    frac = np.clip((rows - horizon) / max(h - horizon, 1), 0, 1)
    half = top_half + (bot_half - top_half) * frac
    road = (rows >= horizon) & (np.abs(cols - center) <= half)
    label[road] = 1
    # paint the road darker in the image so it is visually separable
    img[road] = (img[road].astype(np.float32) * 0.4 + 80).astype(np.uint8)
    return img, label


def synthetic_batch(n: int, h: int = 384, w: int = 1248, seed: int = 0
                    ) -> dict[str, np.ndarray]:
    """In-memory batch: {image f32 normalized-ish, label i32, valid bool}."""
    rng = np.random.default_rng(seed)
    imgs, labels = zip(*(_road_scene(rng, h, w) for _ in range(n)))
    return {
        "image": (np.stack(imgs).astype(np.float32) - 127.5) / 58.0,
        "label": np.stack(labels),
        "valid": np.ones((n, h, w), np.bool_),
    }


def generate_synthetic_kitti(data_dir: str, n_train: int = 8, n_test: int = 4,
                             h: int = 375, w: int = 1242, seed: int = 0) -> str:
    """Write a KITTI-road directory tree with synthetic scenes. Returns dir."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    tr_img = os.path.join(data_dir, "training", "image_2")
    tr_gt = os.path.join(data_dir, "training", "gt_image_2")
    te_img = os.path.join(data_dir, "testing", "image_2")
    for d in (tr_img, tr_gt, te_img):
        os.makedirs(d, exist_ok=True)

    for i in range(n_train):
        img, label = _road_scene(rng, h, w)
        Image.fromarray(img).save(os.path.join(tr_img, f"um_{i:06d}.png"))
        gt_rgb = decode_labels(label, KITTI_ROAD_PALETTE)
        Image.fromarray(gt_rgb).save(os.path.join(tr_gt, f"um_road_{i:06d}.png"))
    for i in range(n_test):
        img, _ = _road_scene(rng, h, w)
        Image.fromarray(img).save(os.path.join(te_img, f"um_{i + n_train:06d}.png"))
    return data_dir
