"""Test-set sweep of the PyTorch port: an overlay PNG for every test image
(KITTI's testing/image_2, or Cityscapes' val split for a Cityscapes preset)
into runs/<timestamp>/, or with --confidence (binary models) the KITTI road
devkit's confidence maps into runs/<timestamp>_conf/. Same flags as the JAX
package's scripts/test.py, which reads KITTI's layout for every preset.

    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.test \
        --preset fcn8s_kitti --data-dir data_road --weights fcn8s.pt --batch 8

``--int8`` sweeps with the int8 model (``infer/quant.py``): its activation
scales are the checkpoint's ``qat_scales.json`` where a ``--qat`` run wrote
one, else calibrated on the first ``--calib`` test images (0: weight-only).
``--mesh`` runs each batch on one replica of the model per visible card
(``--batch`` rounded up to a multiple of the cards); on one device it
changes nothing.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

def devkit_name(image_path: str) -> str:
    """The devkit's file name of an image's confidence map:
    um_000000.png -> um_road_000000.png."""
    stem = os.path.splitext(os.path.basename(image_path))[0]
    parts = stem.split("_", 1)
    name = f"{parts[0]}_road_{parts[1]}" if len(parts) == 2 else f"{stem}_road"
    return name + ".png"


def main(argv=None) -> int:
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_predictor, check_model_args, mesh_devices,
        resolve_device,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--runs-dir", default="runs")
    p.add_argument("--batch", type=int, default=1,
                   help="images per forward (the reference runs one at a time)")
    p.add_argument("--calib", type=int, default=8,
                   help="calibration images for --int8 (0 = weight-only)")
    p.add_argument("--confidence", action="store_true",
                   help="KITTI road devkit submission mode: uint8 road "
                        "confidence PNGs (round(P(road)*255), named "
                        "um_000000 -> um_road_000000) instead of overlays "
                        "(binary models only)")
    p.add_argument("--mesh", action="store_true",
                   help="shard each batch over every visible card (one "
                        "replica of the model each); pair with --batch >= "
                        "the card count")
    args = p.parse_args(argv)
    check_model_args(args)
    device = resolve_device(args.device)
    mesh = mesh_devices(device) if args.mesh else None
    if mesh:
        print(f"mesh inference over {len(mesh)} devices")
        if args.batch % len(mesh):
            args.batch += (-args.batch) % len(mesh)
            print(f"note: --batch rounded up to {args.batch} "
                  "(must be a mesh multiple)")

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
    from semanticsegmentation_tensorflow_tpu_torch.infer import quant

    quant.warn_qat_fp_eval(args.checkpoint_dir, args.int8, verb="running")
    calib, qat_scales = [], None
    if args.int8:
        sp, qat_scales = quant.checkpoint_act_scales(args.checkpoint_dir)
        if qat_scales is not None:
            print(f"int8: QAT scales from {sp}")
        elif args.calib > 0:
            calib = ds.test_images[:args.calib]
    predictor = build_predictor(args, device, calib_paths=calib,
                                act_scales=qat_scales, mesh=mesh)
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
