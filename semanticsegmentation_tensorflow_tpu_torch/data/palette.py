"""RGB <-> class-id codecs for ground-truth images and the overlay palettes
(copied from the JAX package's ``data/palette.py``).

KITTI road GT (gt_image_2) encodes labels as colors: red [255,0,0] marks
non-road background, magenta [255,0,255] the road surface, black the ignored
"other road" area.
"""

from __future__ import annotations

import numpy as np

# class id -> display color (uint8 RGB). Index 0 must be background.
KITTI_ROAD_PALETTE = np.array(
    [
        [255, 0, 0],    # 0: not road (KITTI GT background color)
        [255, 0, 255],  # 1: road
    ],
    dtype=np.uint8,
)

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


def overlay_palette(dataset: str) -> np.ndarray:
    """The overlay palette of a dataset's label space: the 19 Cityscapes
    train-id colours, or KITTI's green road mask (class 0 is never
    painted)."""
    return CITYSCAPES_PALETTE if dataset == "cityscapes" else KITTI_OVERLAY_PALETTE


def encode_labels(gt_rgb: np.ndarray, palette: np.ndarray = KITTI_ROAD_PALETTE
                  ) -> tuple[np.ndarray, np.ndarray]:
    """RGB GT image -> (class ids [H, W] int32, valid mask [H, W] bool).
    Pixels matching no palette color are invalid (class 0, valid=0), e.g.
    KITTI's black "ignore" region."""
    h, w, _ = gt_rgb.shape
    ids = np.zeros((h, w), np.int32)
    valid = np.zeros((h, w), bool)
    for cid, color in enumerate(palette):
        m = np.all(gt_rgb == color[None, None, :], axis=-1)
        ids[m] = cid
        valid |= m
    return ids, valid


def decode_labels(ids: np.ndarray, palette: np.ndarray = KITTI_ROAD_PALETTE
                  ) -> np.ndarray:
    """Class ids [H, W] -> RGB [H, W, 3] uint8."""
    return palette[np.clip(ids, 0, len(palette) - 1)]
