"""KITTI road dataset: discovery, decode, label encode (counterpart of the JAX
package's ``data/kitti.py``, PIL path).

Layout:
  data_road/training/image_2/{um,umm,uu}_*.png
  data_road/training/gt_image_2/{um,umm,uu}_road_*.png   (RGB-coded labels)
  data_road/testing/image_2/{um,umm,uu}_*.png

Images are decoded on the host (PIL) and resized to a fixed (H, W), bilinear
for the image and nearest for the labels, which are encoded to class ids
and a valid mask.
"""

from __future__ import annotations

import dataclasses
import os
import re
from glob import glob

import numpy as np
from PIL import Image

from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    KITTI_ROAD_PALETTE, encode_labels,
)


def _gt_path_for(image_path: str) -> str:
    # um_000042.png -> um_road_000042.png (the road GT, not um_lane_*)
    d, name = os.path.split(image_path)
    gt_name = re.sub(r"^(um|umm|uu)_", r"\1_road_", name)
    return os.path.join(os.path.dirname(d), "gt_image_2", gt_name)


def load_image(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """Decode to RGB uint8 [H, W, 3], optionally bilinear-resized to (H, W)."""
    img = Image.open(path).convert("RGB")
    if size is not None and (img.height, img.width) != size:
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def load_gt(path: str, size: tuple[int, int] | None = None,
            palette: np.ndarray = KITTI_ROAD_PALETTE
            ) -> tuple[np.ndarray, np.ndarray]:
    """Decode + nearest-resize GT, return (ids [H,W] i32, valid [H,W] bool)."""
    img = Image.open(path).convert("RGB")
    if size is not None and (img.height, img.width) != size:
        img = img.resize((size[1], size[0]), Image.NEAREST)
    return encode_labels(np.asarray(img, dtype=np.uint8), palette)


@dataclasses.dataclass
class KittiRoadDataset:
    """Train/test example lists + decode helpers."""

    data_dir: str
    image_size: tuple[int, int] = (375, 1242)
    palette: np.ndarray = dataclasses.field(
        default_factory=lambda: KITTI_ROAD_PALETTE)

    @property
    def train_images(self) -> list[str]:
        paths = sorted(glob(os.path.join(
            self.data_dir, "training", "image_2", "*.png")))
        if not paths:
            raise FileNotFoundError(
                f"no KITTI training images under {self.data_dir!r} "
                "(expected training/image_2/*.png)")
        return paths

    @property
    def test_images(self) -> list[str]:
        return sorted(glob(os.path.join(
            self.data_dir, "testing", "image_2", "*.png")))

    def load_example(self, image_path: str
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(image u8 [H,W,3], label i32 [H,W], valid bool [H,W])"""
        img = load_image(image_path, self.image_size)
        ids, valid = load_gt(_gt_path_for(image_path), self.image_size,
                             self.palette)
        return img, ids, valid
