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
weight-only).

``--distributed`` evaluates on a process group (``parallel/launch.py``:
``--coordinator``, ``--num-processes``, ``--process-id`` or the env), one
device each, with ``--mesh`` implied: the batch, rounded up to a multiple
of the ranks, shards over a 1-D data grid, each rank evaluates its images,
and one SUM all-reduce a batch makes the confusion matrix (so the metrics)
the one-process eval's; ``--int8`` calibrates each rank's share with one MAX
all-reduce. Rank 0 prints. ``--mesh`` in one process runs one replica of
the model on each visible card (``train/step.py`` ``replicate_eval_step``,
the sums added); on one device it changes nothing.

    torchrun --nproc-per-node 2 -m \
        semanticsegmentation_tensorflow_tpu_torch.scripts.eval \
        --distributed --data-dir data_road --checkpoint-dir ckpts
"""

from __future__ import annotations

import argparse
import sys
import time

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
    p.add_argument("--mesh", action="store_true",
                   help="shard eval batches over the ranks (1-D data grid, "
                        "summed confusion matrix) or, in one process, over "
                        "every visible card: metrics exact incl. the "
                        "wrap-padded final batch (valid=0 rows)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process eval: join a torch.distributed "
                        "process group first (implies --mesh; see "
                        "scripts/train.py)")
    p.add_argument("--coordinator", default=None, help="rank 0's host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


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
    from semanticsegmentation_tensorflow_tpu_torch.parallel.launch import (
        barrier, initialize_distributed, is_primary, local_device,
    )
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import make_grid
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        load_checkpoint_weights, mesh_devices, resolve_device,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        checkpoint_steps,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.metrics import (
        SegMetrics, kitti_road_metrics,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.step import (
        make_eval_step, replicate_eval_step,
    )

    device = resolve_device(args.device)
    world = 1
    if args.distributed:
        proc, world = initialize_distributed(args.coordinator,
                                             args.num_processes,
                                             args.process_id, device=device)
        device = local_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        args.mesh = True
        print(f"distributed: process {proc}/{world}")
    log = print if is_primary() else (lambda *a, **k: None)
    cfg = get_preset(args.preset)
    dc = cfg.data
    name = args.model or cfg.model
    model_kwargs = dict(cfg.model_kwargs, **parse_model_kw(args.model_kw))
    if args.int8:   # every conv a module the quantization can replace
        model_kwargs = merge_quant_safe_kwargs(name, model_kwargs)
    model = build_model(name, num_classes=dc.num_classes, device=device,
                        **model_kwargs)
    barrier()   # every rank is up before any reads the checkpoint
    model.load_state_dict(load_checkpoint_weights(args.checkpoint_dir, args.ema,
                                                  device))
    model.eval()
    t0 = time.perf_counter()
    log(f"evaluating checkpoint step {checkpoint_steps(args.checkpoint_dir)[-1]}"
        + (" (EMA params)" if args.ema else ""))

    split = args.split or ("val" if dc.dataset == "cityscapes" else "train")
    ds = build_dataset(dc.dataset, args.data_dir or dc.data_dir, dc.image_size,
                       split=split)
    n_images = len(ds.train_images)
    log(f"evaluating split={split!r} ({n_images} images)")

    grid, devices = None, None
    if world > 1:
        grid = make_grid(world, 1)
    elif args.mesh:
        devices = mesh_devices(device)
    shards = grid.data if grid is not None else len(devices or [device])
    if args.batch_size % shards:
        args.batch_size += (-args.batch_size) % shards
        log(f"note: --batch-size rounded up to {args.batch_size} "
            "(must be a mesh multiple)")

    def make_loader():
        return BatchLoader(ds, args.batch_size,
                           pad_multiple=getattr(model, "total_stride", 32),
                           device=device, drop_remainder=False, mesh=grid)

    loader = make_loader()
    if is_primary():
        quant.warn_qat_fp_eval(args.checkpoint_dir, args.int8, verb="evaluating")
    if args.int8:
        calib = None
        scales_path, qat_scales = quant.checkpoint_act_scales(args.checkpoint_dir)
        if qat_scales is not None:
            # a QAT run persisted its training grid: evaluate on it
            log(f"int8: QAT scales from {scales_path}")
        elif args.calib_batches > 0:
            batches = make_loader().epoch()   # its own order, as JAX's
            try:
                calib = [normalize_images(b["image"], dc.mean, dc.std)
                         for _, b in zip(range(args.calib_batches), batches)]
            finally:
                batches.close()
        model, scales = quant.quantize_for_inference(model, calib,
                                                     act_scales=qat_scales,
                                                     grid=grid)
        log(f"int8: {quant.quantized_count(model)} convs quantized, "
            f"{len(scales)} activation scales"
            + (" (weight-only)" if not scales else ""))
    if grid is not None or devices:
        log(f"mesh eval over {shards} devices")
    if args.road_metrics and dc.num_classes != 2:
        log("note: --road-metrics needs a binary model; ignored")
        args.road_metrics = False
    if args.tta or args.tta_scales:
        from semanticsegmentation_tensorflow_tpu_torch.infer.tta import (
            make_tta_eval_step,
        )
        scales = (tuple(float(s) for s in args.tta_scales.split(","))
                  if args.tta_scales else (1.0,))
        log(f"TTA eval: scales={list(scales)} flip=True")
        eval_step = make_tta_eval_step(dc.num_classes, scales=scales, flip=True,
                                       road_hist=args.road_metrics, mesh=grid)
    else:
        eval_step = make_eval_step(dc.num_classes, road_hist=args.road_metrics,
                                   mesh=grid)
    if devices:
        import copy

        eval_step = replicate_eval_step(
            eval_step, [model] + [copy.deepcopy(model).to(d) for d in devices[1:]])

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
    log(f"loss={float(s['loss']):.4f} miou={float(s['miou']):.4f} "
        f"pixel_acc={float(s['pixel_acc']):.4f} iou={s['iou']}")
    if road_hist is not None:
        m = kitti_road_metrics(road_hist)
        log("kitti-road: "
            f"MaxF={m['maxf']:.4f} AP={m['ap']:.4f} "
            f"PRE={m['precision']:.4f} REC={m['recall']:.4f} "
            f"FPR={m['fpr']:.4f} FNR={m['fnr']:.4f} "
            f"@tau={m['threshold']:.3f}")
    log(f"{n_images} images in {dt:.2f}s ({n_images / dt:.2f} img/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
