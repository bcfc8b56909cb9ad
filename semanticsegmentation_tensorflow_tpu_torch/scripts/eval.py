"""Evaluate mIoU / pixel accuracy, and with --road-metrics the KITTI road
devkit measures, on a labeled split with the PyTorch port (counterpart of
the JAX package's ``scripts/eval.py``; its output lines have the same
format).

    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.eval \
        --preset fcn8s_kitti --data-dir data_road --checkpoint-dir ckpts \
        [--ema] [--road-metrics]
    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.eval \
        --preset unet_cityscapes --data-dir cityscapes --checkpoint-dir ckpts
    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.eval \
        --preset fcn8s_kitti --data-dir data_road --checkpoint-dir ckpts \
        --tta --tta-scales 0.75,1.0,1.25

Reads the port's training checkpoints (``<checkpoint-dir>/ckpt_<step>.pt``,
the latest); an orbax checkpoint of the JAX package converts with
``tools/convert_checkpoint_to_torch.py``. ``--device`` defaults to cuda and
raises without a card. ``--tta`` averages the flipped variant's
probabilities with the plain one's, at each of ``--tta-scales`` (default
1.0; ``infer/tta.py``). ``--int8`` evaluates the int8 model
(``infer/quant.py``: BatchNorm folded, per-channel int8 weights, per-tensor
activations at the checkpoint's ``qat_scales.json`` where a ``--qat`` run
wrote one, else calibrated on the first ``--calib-batches`` batches, 0:
weight-only). The JAX CLI's multi-device flags parse with their defaults
and raise ``NotImplementedError`` when set away from them.
"""

from __future__ import annotations

import argparse
import sys
import time

# the JAX CLI's flags that the port does not implement yet, with their
# argparse settings there
UNPORTED = (("--mesh", dict(action="store_true")),
            ("--distributed", dict(action="store_true")),
            ("--coordinator", dict(default=None)),
            ("--num-processes", dict(type=int, default=None)),
            ("--process-id", dict(type=int, default=None)))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="fcn8s_kitti")
    p.add_argument("--model", default=None)
    p.add_argument("--model-kw", default=None,
                   help="comma-separated model kwargs (k=v) - must match "
                        "the flags the checkpoint was trained with")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--split", default=None,
                   help="labeled split to evaluate (default: 'val' for "
                        "cityscapes, 'train' for kitti_road, which has no "
                        "public val GT)")
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA params (trained with --ema-decay)")
    p.add_argument("--road-metrics", action="store_true",
                   help="also report the KITTI road devkit measures (MaxF, "
                        "AP, precision, recall, FPR, FNR at the best "
                        "threshold; binary models only)")
    p.add_argument("--tta", action="store_true",
                   help="test-time augmentation: average the softmax of the "
                        "image and its horizontal flip (at each of "
                        "--tta-scales)")
    p.add_argument("--tta-scales", default=None,
                   help="comma-separated TTA scales, e.g. 0.75,1.0,1.25 "
                        "(implies --tta; default 1.0)")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 quantization (per-channel "
                        "weights, calibrated per-tensor activations); reports "
                        "the int8 serving path's metrics")
    p.add_argument("--calib-batches", type=int, default=4,
                   help="calibration batches for --int8 (0 = weight-only)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises without a card")
    for flag, kw in UNPORTED:
        p.add_argument(flag, help="not ported yet (raises)", **kw)
    args = p.parse_args(argv)
    dests = {flag: flag[2:].replace("-", "_") for flag, _ in UNPORTED}
    used = [flag for flag, dest in dests.items()
            if getattr(args, dest) != p.get_default(dest)]
    if used:
        raise NotImplementedError(f"not ported yet: {', '.join(used)}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from semanticsegmentation_tensorflow_tpu_torch.config import (
        get_preset, parse_model_kw,
    )
    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
        normalize_images,
    )
    from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import BatchLoader
    from semanticsegmentation_tensorflow_tpu_torch.infer import quant
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
        build_model, merge_quant_safe_kwargs,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        load_checkpoint_weights, resolve_device,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        checkpoint_steps,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.metrics import (
        SegMetrics, kitti_road_metrics,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.step import make_eval_step

    device = resolve_device(args.device)
    cfg = get_preset(args.preset)
    dc = cfg.data
    name = args.model or cfg.model
    model_kwargs = dict(cfg.model_kwargs, **parse_model_kw(args.model_kw))
    if args.int8:   # every conv a module the quantization can replace
        model_kwargs = merge_quant_safe_kwargs(name, model_kwargs)
    model = build_model(name, num_classes=dc.num_classes, device=device,
                        **model_kwargs)
    model.load_state_dict(load_checkpoint_weights(args.checkpoint_dir, args.ema,
                                                  device))
    model.eval()
    t0 = time.perf_counter()
    print(f"evaluating checkpoint step {checkpoint_steps(args.checkpoint_dir)[-1]}"
          + (" (EMA params)" if args.ema else ""))

    split = args.split or ("val" if dc.dataset == "cityscapes" else "train")
    ds = build_dataset(dc.dataset, args.data_dir or dc.data_dir, dc.image_size,
                       split=split)
    n_images = len(ds.train_images)
    print(f"evaluating split={split!r} ({n_images} images)")

    def make_loader():
        return BatchLoader(ds, args.batch_size,
                           pad_multiple=getattr(model, "total_stride", 32),
                           device=device, drop_remainder=False)

    loader = make_loader()
    quant.warn_qat_fp_eval(args.checkpoint_dir, args.int8, verb="evaluating")
    if args.int8:
        calib = None
        scales_path, qat_scales = quant.checkpoint_act_scales(args.checkpoint_dir)
        if qat_scales is not None:
            # a QAT run persisted its training grid: evaluate on it
            print(f"int8: QAT scales from {scales_path}")
        elif args.calib_batches > 0:
            batches = make_loader().epoch()   # its own order, as JAX's
            try:
                calib = [normalize_images(b["image"], dc.mean, dc.std)
                         for _, b in zip(range(args.calib_batches), batches)]
            finally:
                batches.close()
        model, scales = quant.quantize_for_inference(model, calib,
                                                     act_scales=qat_scales)
        print(f"int8: {quant.quantized_count(model)} convs quantized, "
              f"{len(scales)} activation scales"
              + (" (weight-only)" if not scales else ""))
    if args.road_metrics and dc.num_classes != 2:
        print("note: --road-metrics needs a binary model; ignored")
        args.road_metrics = False
    if args.tta or args.tta_scales:
        from semanticsegmentation_tensorflow_tpu_torch.infer.tta import (
            make_tta_eval_step,
        )
        scales = (tuple(float(s) for s in args.tta_scales.split(","))
                  if args.tta_scales else (1.0,))
        print(f"TTA eval: scales={list(scales)} flip=True")
        eval_step = make_tta_eval_step(dc.num_classes, scales=scales, flip=True,
                                       road_hist=args.road_metrics)
    else:
        eval_step = make_eval_step(dc.num_classes, road_hist=args.road_metrics)

    metrics = SegMetrics(dc.num_classes, device)
    road_hist = (torch.zeros((2, 256), dtype=torch.int64, device=device)
                 if args.road_metrics else None)
    for batch in loader.epoch():
        out = eval_step(model, dict(batch, image=normalize_images(
            batch["image"], dc.mean, dc.std)))
        metrics.update(out["cm"], out["loss"])
        if road_hist is not None:
            road_hist += out["road_hist"]
    s = {k: v.tolist() for k, v in metrics.summary().items()}
    dt = time.perf_counter() - t0
    print(f"loss={float(s['loss']):.4f} miou={float(s['miou']):.4f} "
          f"pixel_acc={float(s['pixel_acc']):.4f} iou={s['iou']}")
    if road_hist is not None:
        m = kitti_road_metrics(road_hist)
        print("kitti-road: "
              f"MaxF={m['maxf']:.4f} AP={m['ap']:.4f} "
              f"PRE={m['precision']:.4f} REC={m['recall']:.4f} "
              f"FPR={m['fpr']:.4f} FNR={m['fnr']:.4f} "
              f"@tau={m['threshold']:.3f}")
    print(f"{n_images} images in {dt:.2f}s ({n_images / dt:.2f} img/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
