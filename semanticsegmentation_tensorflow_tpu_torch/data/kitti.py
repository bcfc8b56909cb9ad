"""KITTI road dataset: discovery, decode, label encode (counterpart of the JAX
package's ``data/kitti.py``).

Layout:
  data_road/training/image_2/{um,umm,uu}_*.png
  data_road/training/gt_image_2/{um,umm,uu}_road_*.png   (RGB-coded labels)
  data_road/testing/image_2/{um,umm,uu}_*.png

Images are decoded on the host and resized to a fixed (H, W), bilinear for
the image and nearest for the labels, which are encoded to class ids and a
valid mask. The GT's nearest resize runs in the native library
(``native/``) where it is built, bit-equal to PIL's NEAREST. The image's
bilinear resize is PIL's area-averaging filter unless ``SEG_NATIVE_RESIZE=1``
picks the native decode and half-pixel 2-tap bilinear (other, sharper
pixels). ``SEG_NATIVE=0`` switches every native path off.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
from glob import glob

import numpy as np
from PIL import Image

from semanticsegmentation_tensorflow_tpu_torch import native
from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    KITTI_ROAD_PALETTE, encode_labels,
)


def _native_resize_opted_in() -> bool:
    return (os.environ.get("SEG_NATIVE_RESIZE", "").strip().lower()
            in ("1", "true", "on"))


def _gt_path_for(image_path: str) -> str:
    # um_000042.png -> um_road_000042.png (the road GT, not um_lane_*)
    d, name = os.path.split(image_path)
    gt_name = re.sub(r"^(um|umm|uu)_", r"\1_road_", name)
    return os.path.join(os.path.dirname(d), "gt_image_2", gt_name)


def load_image(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """Decode to RGB uint8 [H, W, 3], optionally bilinear-resized to (H, W)."""
    if _native_resize_opted_in() and native.available():
        with open(path, "rb") as f:
            data = f.read()
        if data[:8] == b"\x89PNG\r\n\x1a\n":  # other formats: PIL below
            if native.decode_available():
                arr = native.decode_png(data)
            else:  # a build without libpng: PIL decodes the same pixels
                arr = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                                 dtype=np.uint8)
            if size is not None and arr.shape[:2] != size:
                arr = native.resize_bilinear(arr, size[0], size[1])
            return arr
    img = Image.open(path).convert("RGB")
    if size is not None and (img.height, img.width) != size:
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def load_gt(path: str, size: tuple[int, int] | None = None,
            palette: np.ndarray = KITTI_ROAD_PALETTE
            ) -> tuple[np.ndarray, np.ndarray]:
    """Decode + nearest-resize GT, return (ids [H,W] i32, valid [H,W] bool)."""
    img = Image.open(path).convert("RGB")
    needs_resize = size is not None and (img.height, img.width) != size
    if needs_resize and not native.available():
        img = img.resize((size[1], size[0]), Image.NEAREST)
        needs_resize = False
    arr = np.asarray(img, dtype=np.uint8)
    if needs_resize:  # native: bit-equal to PIL's NEAREST
        arr = native.resize_nearest(arr, size[0], size[1])
    return encode_labels(arr, palette)


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
