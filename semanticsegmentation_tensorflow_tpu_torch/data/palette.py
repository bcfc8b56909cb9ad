"""Overlay palettes (copied from the JAX package's ``data/palette.py``; the
ground-truth palette and label codecs come with the training path)."""

from __future__ import annotations

import numpy as np

# overlay colors for visualization (class 0 transparent by convention)
KITTI_OVERLAY_PALETTE = np.array(
    [
        [0, 0, 0],      # 0: untouched
        [0, 255, 0],    # 1: green road mask (reference's overlay color)
    ],
    dtype=np.uint8,
)

# Cityscapes 19-class train-id palette (public color scheme)
CITYSCAPES_PALETTE = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
        [0, 80, 100], [0, 0, 230], [119, 11, 32],
    ],
    dtype=np.uint8,
)
