"""Export a model as a standalone serving artifact (the port's counterpart of
the JAX package's scripts/export_model.py).

    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.export_model \
        --preset fcn8s_kitti --checkpoint-dir checkpoints --out fcn8s.segx

The ``.segx`` file carries the inference programs (``torch.export``) for
each of ``--platforms`` (default cpu and cuda; each traced on its own
device, so ``cuda`` needs the card) with the weights in them; the serving
side needs no model code (``infer/export.py`` ExportedPredictor, ``serve.py
--artifact``). Weights come from ``--weights``, ``--checkpoint-dir`` (its
latest checkpoint; ``--ema`` its EMA parameters) or, with neither, a seeded
random init. ``--int8`` exports the quantized model: the quant-safe model
flags, then the activation scales of the checkpoint's ``qat_scales.json``
where a ``--qat`` run wrote one, else those calibrated on ``--calib-dir``'s
images, else weight-only.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None) -> int:
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        add_model_args, build_served_model, check_model_args, resolve_device,
    )

    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    p.add_argument("--out", default=None,
                   help="output path (default <preset>.segx)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated platforms whose programs the "
                        "artifact carries (cpu, cuda)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="fix the batch (default: symbolic where the model "
                        "traces so, else 1)")
    p.add_argument("--calib-dir", default=None,
                   help="directory of images (png/jpg) for --int8's "
                        "activation calibration")
    p.add_argument("--calib", type=int, default=16,
                   help="max calibration images read from --calib-dir")
    args = p.parse_args(argv)
    check_model_args(args)
    device = resolve_device(args.device)

    from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
        overlay_palette,
    )
    from semanticsegmentation_tensorflow_tpu_torch.infer import quant
    from semanticsegmentation_tensorflow_tpu_torch.infer.export import (
        export_model,
    )

    calib, qat_scales = [], None
    if args.int8:
        sp, qat_scales = quant.checkpoint_act_scales(args.checkpoint_dir)
        if qat_scales is not None:
            print(f"int8: QAT scales from {sp}")
        elif args.calib_dir:
            calib = sorted(q for ext in ("png", "jpg", "jpeg")
                           for q in glob.glob(os.path.join(args.calib_dir,
                                                           f"*.{ext}")))
            calib = calib[:args.calib]
            if not calib:
                raise SystemExit(f"--calib-dir {args.calib_dir}: no images")
    model, dc = build_served_model(args, device, calib_paths=calib,
                                   act_scales=qat_scales, int8_label="int8")
    out = args.out or f"{args.preset}.segx"
    meta = export_model(model, dc.image_size, out, mean=dc.mean, std=dc.std,
                        overlay_palette=overlay_palette(dc.dataset),
                        alpha=args.alpha,
                        platforms=[s for s in args.platforms.split(",") if s],
                        batch_size=args.batch_size,
                        num_classes=dc.num_classes)
    size = os.path.getsize(out)
    print(f"wrote {out} ({size / 1e6:.1f} MB): batch={meta['batch_mode']}"
          + (f" ({meta['batch_size']})" if meta["batch_size"] else "")
          + f" platforms={','.join(meta['platforms'])}"
          f" image_size={meta['image_size']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
