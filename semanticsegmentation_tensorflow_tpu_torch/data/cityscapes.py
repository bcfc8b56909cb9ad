"""Cityscapes dataset, 19 train classes (counterpart of the JAX package's
``data/cityscapes.py``).

Layout (the standard Cityscapes one):
  <root>/leftImg8bit/{train,val}/<city>/<city>_*_leftImg8bit.png
  <root>/gtFine/{train,val}/<city>/<city>_*_gtFine_labelIds.png

The GT holds labelIds (0..33); they map to the 19 train ids, with the ignored
ids (255) as ``valid=False``, per the official label definitions. Images
decode through ``data/kitti.py`` ``load_image``; the GT resizes with PIL's
NEAREST, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from glob import glob

import numpy as np
from PIL import Image

from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image

# official labelId -> trainId (255: ignore); index = labelId 0..33
_LABELID_TO_TRAINID = np.full(34, 255, np.uint8)
for label_id, train_id in [
    (7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5), (19, 6), (20, 7),
    (21, 8), (22, 9), (23, 10), (24, 11), (25, 12), (26, 13), (27, 14),
    (28, 15), (31, 16), (32, 17), (33, 18),
]:
    _LABELID_TO_TRAINID[label_id] = train_id

NUM_TRAIN_CLASSES = 19
IGNORE_ID = 255


def encode_cityscapes_gt(label_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """labelIds [H, W] -> (train ids int32 [H, W], valid bool [H, W]); ids
    above 33 clip to 33, as in the JAX package."""
    tid = _LABELID_TO_TRAINID[np.clip(label_ids, 0, 33)]
    valid = tid != IGNORE_ID
    return np.where(valid, tid, 0).astype(np.int32), valid


@dataclasses.dataclass
class CityscapesDataset:
    """The ``split``'s labeled images as ``train_images`` (what the loader
    iterates; ``train`` or ``val``), the val split as ``test_images`` (the
    sweep's), and ``load_example`` as ``KittiRoadDataset``'s."""

    data_dir: str
    split: str = "train"
    image_size: tuple[int, int] = (512, 1024)

    def _images(self, split: str) -> list[str]:
        return sorted(glob(os.path.join(
            self.data_dir, "leftImg8bit", split, "*", "*_leftImg8bit.png")))

    @property
    def train_images(self) -> list[str]:
        paths = self._images(self.split)
        if not paths:
            raise FileNotFoundError(
                f"no Cityscapes images under {self.data_dir!r} "
                f"(expected leftImg8bit/{self.split}/<city>/*_leftImg8bit.png)")
        return paths

    @property
    def test_images(self) -> list[str]:
        return self._images("val")

    def _gt_path_for(self, image_path: str) -> str:
        rel = os.path.relpath(image_path,
                              os.path.join(self.data_dir, "leftImg8bit"))
        rel = rel.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
        return os.path.join(self.data_dir, "gtFine", rel)

    def load_example(self, image_path: str
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(image u8 [H,W,3], train ids i32 [H,W], valid bool [H,W])"""
        img = load_image(image_path, self.image_size)
        gt = Image.open(self._gt_path_for(image_path))
        if (gt.height, gt.width) != self.image_size:
            gt = gt.resize((self.image_size[1], self.image_size[0]),
                           Image.NEAREST)
        ids, valid = encode_cityscapes_gt(np.asarray(gt))
        return img, ids, valid


def generate_synthetic_cityscapes(data_dir: str, n_train: int = 4,
                                  n_val: int = 2, h: int = 256, w: int = 512,
                                  seed: int = 0) -> str:
    """Cityscapes-layout fixtures: random images and blocky regions of
    random labelIds (ignored ids included) under one city, ``synthcity``;
    the same files as the JAX package's generator for the same arguments."""
    rng = np.random.default_rng(seed)

    def write(split: str, n: int) -> None:
        img_dir = os.path.join(data_dir, "leftImg8bit", split, "synthcity")
        gt_dir = os.path.join(data_dir, "gtFine", split, "synthcity")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        for i in range(n):
            stem = f"synthcity_{i:06d}_000019"
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            ids = np.zeros((h, w), np.uint8)
            for _ in range(6):
                y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
                y1, x1 = y0 + rng.integers(8, h // 2), x0 + rng.integers(8, w // 2)
                ids[y0:y1, x0:x1] = rng.integers(0, 34)
            Image.fromarray(img).save(
                os.path.join(img_dir, stem + "_leftImg8bit.png"))
            Image.fromarray(ids).save(
                os.path.join(gt_dir, stem + "_gtFine_labelIds.png"))

    write("train", n_train)
    write("val", n_val)
    return data_dir
