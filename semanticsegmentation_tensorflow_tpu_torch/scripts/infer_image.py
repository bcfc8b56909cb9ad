"""Single-image inference with the PyTorch port: image in, overlay PNG out.

    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.infer_image \
        --preset fcn8s_kitti --image um_000000.png --weights fcn8s.pt \
        --out overlay.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor, check_unported, resolve_device,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="overlay.png")
    args = p.parse_args(argv)
    check_unported(args)
    device = resolve_device(args.device)

    from PIL import Image

    predictor = build_predictor(args, device)
    overlay, labels = predictor.predict_file(args.image)
    Image.fromarray(overlay).save(args.out)
    road_frac = float(np.mean(labels != 0))
    print(f"wrote {args.out} (non-background fraction {road_frac:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
