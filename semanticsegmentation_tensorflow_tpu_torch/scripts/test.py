"""Test-set sweep of the PyTorch port: an overlay PNG for every test image
(KITTI's testing/image_2, or Cityscapes' val split for a Cityscapes preset)
into runs/<timestamp>/, or with --confidence (binary models) the KITTI road
devkit's confidence maps into runs/<timestamp>_conf/. Same flags as the JAX
package's scripts/test.py, which reads KITTI's layout for every preset.

    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.test \
        --preset fcn8s_kitti --data-dir data_road --weights fcn8s.pt --batch 8
"""

from __future__ import annotations

import argparse
import os
import sys
import time

JAX_CALIB_DEFAULT = 8


def devkit_name(image_path: str) -> str:
    """The devkit's file name of an image's confidence map:
    um_000000.png -> um_road_000000.png."""
    stem = os.path.splitext(os.path.basename(image_path))[0]
    parts = stem.split("_", 1)
    name = f"{parts[0]}_road_{parts[1]}" if len(parts) == 2 else f"{stem}_road"
    return name + ".png"


def main(argv=None) -> int:
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor, check_unported, resolve_device,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p, unported=("int8", "mesh"))
    p.add_argument("--data-dir", default=None)
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--batch", type=int, default=1,
                   help="images per forward (the reference runs one at a time)")
    p.add_argument("--calib", type=int, default=JAX_CALIB_DEFAULT,
                   help="calibration images for --int8 (not ported yet: raises "
                        "when set away from its default)")
    p.add_argument("--confidence", action="store_true",
                   help="KITTI road devkit submission mode: uint8 road "
                        "confidence PNGs (round(P(road)*255), named "
                        "um_000000 -> um_road_000000) instead of overlays "
                        "(binary models only)")
    args = p.parse_args(argv)
    check_unported(args)
    if args.calib != JAX_CALIB_DEFAULT:
        raise NotImplementedError("not ported yet: --calib (int8 calibration)")
    device = resolve_device(args.device)

    import numpy as np
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset
    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
    from semanticsegmentation_tensorflow_tpu_torch.infer import (
        save_inference_samples,
    )

    dc = get_preset(args.preset).data
    # the dataset's test images: KITTI's testing/image_2, Cityscapes' val split
    ds = build_dataset(dc.dataset, args.data_dir or dc.data_dir, dc.image_size)
    predictor = build_predictor(args, device)
    t0, n = time.perf_counter(), 0
    if args.confidence:
        out_dir = os.path.join(args.runs_dir,
                               time.strftime("%Y%m%d-%H%M%S") + "_conf")
        os.makedirs(out_dir, exist_ok=True)
        paths = ds.test_images
        for i in range(0, len(paths), args.batch):
            chunk = paths[i:i + args.batch]
            conf = predictor.confidence(
                np.stack([load_image(q, dc.image_size) for q in chunk]))
            for q, c in zip(chunk, conf):
                dst = os.path.join(out_dir, devkit_name(q))
                Image.fromarray(c).save(dst)  # 2-D uint8: mode "L"
                n += 1
                print(f"{q} -> {dst}")
    else:
        for src, dst in save_inference_samples(predictor, ds.test_images,
                                               args.runs_dir,
                                               batch_size=args.batch):
            n += 1
            print(f"{src} -> {dst}")
    dt = time.perf_counter() - t0
    if n:
        print(f"{n} images in {dt:.2f}s ({n / dt:.2f} img/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
