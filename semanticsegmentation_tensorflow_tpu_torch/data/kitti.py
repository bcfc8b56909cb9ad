"""KITTI road image decode (counterpart of the JAX package's
``data/kitti.py:load_image``, PIL path)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_image(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """Decode to RGB uint8 [H, W, 3], optionally bilinear-resized to (H, W)."""
    img = Image.open(path).convert("RGB")
    if size is not None and (img.height, img.width) != size:
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)
