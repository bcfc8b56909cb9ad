"""Single-image inference with the PyTorch port: image in, overlay PNG out.

    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.infer_image \
        --preset fcn8s_kitti --image um_000000.png --weights fcn8s.pt \
        --out overlay.png [--tiled [--tile-overlap 96]]

The image is resized to the preset's size, or with ``--tiled`` kept at its
own size and covered by overlapped tiles of that size whose probabilities
are summed where they overlap (``infer/window.py``). ``--int8`` runs the
int8 forward with its activation scales calibrated on the input image
itself (``infer/quant.py``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor, build_served_model, check_model_args,
        resolve_device,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="overlay.png")
    p.add_argument("--tiled", action="store_true",
                   help="native-resolution sliding-window inference: keep "
                        "the input at its own size and tile it with "
                        "overlapped windows of the training resolution "
                        "(probability-summed seams) instead of resizing")
    p.add_argument("--tile-overlap", type=int, default=None,
                   help="overlap in px between tiles (default: tile/4)")
    args = p.parse_args(argv)
    check_model_args(args)
    device = resolve_device(args.device)

    from PIL import Image

    # --int8: the activation scales are calibrated on this image
    int8 = dict(calib_paths=[args.image], int8_label="int8")
    if args.tiled:
        from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
            overlay_palette,
        )
        from semanticsegmentation_tensorflow_tpu_torch.infer import TiledPredictor

        model, dc = build_served_model(args, device, **int8)
        predictor = TiledPredictor(model, dc.image_size, device=device,
                                   overlap=args.tile_overlap, mean=dc.mean,
                                   std=dc.std,
                                   overlay_palette=overlay_palette(dc.dataset),
                                   alpha=args.alpha)
        img = np.asarray(Image.open(args.image).convert("RGB"))
        overlay, labels = predictor(img)
        print(f"tiled: input {img.shape[0]}x{img.shape[1]}, "
              f"grid {predictor.grid[0]}x{predictor.grid[1]} tiles of "
              f"{predictor.tile[0]}x{predictor.tile[1]}")
    else:
        overlay, labels = build_predictor(args, device, **int8).predict_file(
            args.image)
    Image.fromarray(overlay).save(args.out)
    road_frac = float(np.mean(labels != 0))
    print(f"wrote {args.out} (non-background fraction {road_frac:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
