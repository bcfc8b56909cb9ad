"""Train entry point of the PyTorch port (counterpart of the JAX package's
``scripts/train.py``): the flags of the JAX CLI, one process per GPU.

    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.train \
        --preset fcn8s_kitti --data-dir data_road --checkpoint-dir ckpts
    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.train \
        --synthetic --epochs 1 --device cpu \
        --model-kw fc_features=64,width_mult=0.25
    torchrun --nproc-per-node 4 -m \
        semanticsegmentation_tensorflow_tpu_torch.scripts.train \
        --distributed --spatial 2 --data-dir data_road --checkpoint-dir ckpts

``--distributed`` joins a process group (``parallel/launch.py``: the
coordinator, world size and rank from the flags, the ``SEG_*`` env vars or
torchrun's env; NCCL for CUDA, gloo for the CPU). Where the JAX script counts
devices, the port counts ranks: with more than one, the batch shards over a
``data x spatial`` grid (``--spatial S`` splits each image's height over S
ranks and turns random crop off; without it a 1-D data grid), unless
``--no-mesh``. ``--spatial S`` also merges the spatial-safe model kwargs
(no Winograd); at one rank the step then runs unsharded, as the JAX script
does on one device. The fused stage1 runs its halo mode (kernel 1c) under a
grid that splits rows, and kernel 1 otherwise. Only rank 0 writes
checkpoints and logs.

``--pallas-preprocess`` keeps the JAX flag's name: it selects the CUDA
preprocess kernel (``ops/cuda/preprocess.py``) for the image leg of the
augment; it computes flip, crop and normalize only, so the scale and color
jitters are ignored with it (as in the JAX CLI). ``--val-frac`` holds out
the last images of the train split for validation every ``--val-every``
epochs (sharded over a 1-D data grid, unsharded on every rank under a
spatial grid); ``--keep-best`` also saves ``<checkpoint-dir>/best``
whenever the validation mIoU improves. ``--vgg-weights`` imports an
``.npz`` of VGG16 weights (``models/vgg16.py:load_npz_weights``) before the
EMA copy is taken. Checkpoints (``<checkpoint-dir>/ckpt_<step>.pt``) are
read back by ``infer_image``/``serve``/``eval --checkpoint-dir``.
``--qat`` trains quantization-aware (``infer/quant.py`` ``fake_quantize``:
the quant-safe model kwargs, each conv's weight and input on their int8
grids with straight-through gradients) at the activation scales of
``<checkpoint-dir>/qat_scales.json``, which the first ``--qat`` run
calibrates on ``--qat-calib-batches`` batches and writes; ``eval``/``test``
``--int8`` read them. On a grid the calibration takes every rank's share of
the global batches and one MAX all-reduce (so the scales are one process's
on the same batches); rank 0 writes the file and every rank reads it after
a barrier. ``--shard-opt`` shards the optimizer's moments over a 1-D data
grid (ZeRO-1, ``train/state.py`` ``shard_state_zero1``); it is ignored with
a note under ``--spatial`` and silently on one rank, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="fcn8s_kitti")
    p.add_argument("--model", default=None, help="override preset model")
    p.add_argument("--model-kw", default=None,
                   help="comma-separated k=v model kwargs overriding the preset")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated synthetic fixtures of the "
                        "preset's dataset (KITTI road or Cityscapes)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--image-size", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="override the preset's pre-pad resize size (no crop)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-schedule", default=None,
                   choices=["constant", "poly", "cosine"])
    p.add_argument("--warmup-steps", type=int, default=None)
    p.add_argument("--class-balance", action="store_true",
                   help="median-frequency class balancing")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="track an exponential moving average of the params "
                        "(serve it with --ema)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="k sequential microbatches, one optimizer update")
    p.add_argument("--loss", default="ce", choices=("ce", "focal"))
    p.add_argument("--focal-gamma", type=float, default=2.0)
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware training: fake-quantize conv "
                        "weights (per-channel int8 grid) and inputs (the "
                        "calibrated per-tensor grid) with straight-through "
                        "gradients, so that --int8 serving matches the "
                        "trained forward; typically after float training "
                        "(--resume). Scales persist to "
                        "<checkpoint-dir>/qat_scales.json")
    p.add_argument("--qat-calib-batches", type=int, default=4,
                   help="batches that calibrate the QAT activation scales "
                        "when qat_scales.json does not exist yet")
    p.add_argument("--pallas-preprocess", action="store_true",
                   help="flip + crop + normalize with the CUDA preprocess "
                        "kernel (bit-equal to its plain version)")
    p.add_argument("--scale-jitter", default=None,
                   help="comma-separated random-scale set, e.g. 0.75,1.0,1.25: "
                        "one scale per step (zoom-out pads with valid=0); "
                        "not with --spatial or --pallas-preprocess")
    p.add_argument("--color-jitter", default=None,
                   help="per-example photometric magnitudes "
                        "'brightness,contrast,saturation', e.g. 0.2,0.2,0.2 "
                        "(not with --pallas-preprocess)")
    p.add_argument("--val-frac", type=float, default=0.0,
                   help="hold out this fraction of the train images as a "
                        "validation split, evaluated every --val-every epochs")
    p.add_argument("--val-every", type=int, default=1,
                   help="epochs between validation passes (--val-frac)")
    p.add_argument("--keep-best", action="store_true",
                   help="also checkpoint to <checkpoint-dir>/best whenever "
                        "the validation mIoU improves (needs --val-frac)")
    p.add_argument("--loader-workers", type=int, default=0,
                   help="decode each batch on N threads (0 = inline)")
    p.add_argument("--vgg-weights", default=None,
                   help=".npz of pretrained VGG16 weights (flax paths, HWIO "
                        "kernels; e.g. from tools/import_tf_vgg.py)")
    p.add_argument("--strict-import", action="store_true",
                   help="error unless --vgg-weights covers every backbone "
                        "param and every archive entry is used")
    p.add_argument("--cache-gb", type=float, default=None,
                   help="RAM budget for the decoded-image cache (0 disables)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; cuda raises without a card (with "
                        "--distributed, cuda:<local rank>)")
    p.add_argument("--spatial", type=int, default=1,
                   help="shard image height across N ranks (2-D data x "
                        "spatial grid; disables random crop)")
    p.add_argument("--no-mesh", action="store_true",
                   help="no grid (each rank trains alone) even with >1 rank")
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group before "
                        "touching devices (parallel/launch.py)")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--shard-opt", action="store_true",
                   help="ZeRO-1: shard the optimizer moments over the 1-D "
                        "data grid (each rank updates its slice, then the "
                        "parameters are all-gathered)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    error = build_parser().error
    if args.keep_best and not args.val_frac:
        error("--keep-best needs --val-frac")

    import torch

    from semanticsegmentation_tensorflow_tpu_torch.config import (
        get_preset, parse_model_kw,
    )
    from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
        check_color_jitter, make_augment_fn, normalize_images,
    )
    from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import (
        BatchLoader, subset_dataset,
    )
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.convert import transposed_weights
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import load_npz_weights
    from semanticsegmentation_tensorflow_tpu_torch.ops.shape import round_up
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        resolve_device,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.loop import LoopHooks, train
    from semanticsegmentation_tensorflow_tpu_torch.train.metrics import SegMetrics
    from semanticsegmentation_tensorflow_tpu_torch.train.state import (
        create_train_state, make_lr_schedule, make_optimizer,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.step import (
        make_eval_step, make_train_step,
    )
    from semanticsegmentation_tensorflow_tpu_torch.utils.logging import MetricsLogger

    from semanticsegmentation_tensorflow_tpu_torch.parallel.launch import (
        barrier, initialize_distributed, is_primary, local_device,
    )
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (
        check_rows, make_grid,
    )

    if args.spatial < 1:
        raise ValueError(f"--spatial must be >= 1, got {args.spatial}")
    jitter = (tuple(float(s) for s in args.scale_jitter.split(","))
              if args.scale_jitter else None)
    color = check_color_jitter(args.color_jitter.split(",")
                               if args.color_jitter else None)
    if jitter and (args.spatial > 1 or args.pallas_preprocess):
        print("note: --scale-jitter needs the plain augment path on an "
              "unsharded image; ignored")
        jitter = None
    if color and args.pallas_preprocess:
        print("note: --color-jitter needs the plain augment path; ignored")
        color = None
    device = resolve_device(args.device)
    world = 1
    if args.distributed:
        _, world = initialize_distributed(args.coordinator, args.num_processes,
                                          args.process_id, device=device)
        device = local_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    if world > 1 and world % args.spatial:
        raise ValueError(f"--spatial {args.spatial} does not divide the "
                         f"{world} ranks")
    primary = is_primary()
    cfg = get_preset(args.preset)
    if args.model:
        cfg = dataclasses.replace(cfg, model=args.model)
    tr = cfg.train
    for field, value in (("epochs", args.epochs), ("batch_size", args.batch_size),
                         ("learning_rate", args.lr),
                         ("lr_schedule", args.lr_schedule),
                         ("warmup_steps", args.warmup_steps),
                         ("checkpoint_dir", args.checkpoint_dir),
                         ("seed", args.seed)):
        if value is not None:
            tr = dataclasses.replace(tr, **{field: value})
    if args.class_balance:
        tr = dataclasses.replace(tr, class_balance=True)
    dc = cfg.data
    if args.image_size is not None:
        dc = dataclasses.replace(dc, image_size=tuple(args.image_size),
                                 crop_size=None)

    model_kwargs = dict(cfg.model_kwargs, **parse_model_kw(args.model_kw))
    if args.spatial > 1:
        from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
            merge_spmd_safe_kwargs,
        )
        model_kwargs = merge_spmd_safe_kwargs(cfg.model, model_kwargs)
    if args.qat:
        # QAT trains under the serving grid: every conv must be a module the
        # fake quantization reaches, as int8 serving rebuilds the model
        from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
            merge_quant_safe_kwargs,
        )
        model_kwargs = merge_quant_safe_kwargs(cfg.model, model_kwargs)
    # the model's total stride, from a build without storage
    stride = getattr(build_model(cfg.model, num_classes=dc.num_classes,
                                 device="meta", **model_kwargs),
                     "total_stride", 32)
    grid = None
    if world > 1 and not args.no_mesh:
        grid = make_grid(world // args.spatial, args.spatial)
        if args.spatial > 1 and dc.crop_size is not None:
            # random crops gather across spatial shards; train at full size
            dc = dataclasses.replace(dc, crop_size=None)
            print("note: --spatial disables random crop (full-size training)")
    if args.spatial > 1:   # before any work, at any world size
        rows = round_up(dc.image_size[0], stride)
        check_rows(rows, args.spatial, stride)
        if grid is not None:   # uneven where the stride blocks do not divide
            grid = grid.at_height(rows, stride)

    data_dir = args.data_dir or dc.data_dir
    if args.synthetic:
        if dc.dataset == "cityscapes":
            from semanticsegmentation_tensorflow_tpu_torch.data.cityscapes import (
                generate_synthetic_cityscapes,
            )
            data_dir = generate_synthetic_cityscapes(
                tempfile.mkdtemp(prefix="synth_cs_"),
                n_train=max(8, tr.batch_size), h=dc.image_size[0],
                w=dc.image_size[1])
        else:
            data_dir = generate_synthetic_kitti(
                tempfile.mkdtemp(prefix="synth_kitti_"),
                n_train=max(8, tr.batch_size), h=dc.image_size[0],
                w=dc.image_size[1])
    # a bad --data-dir fails here, before any device work
    ds = build_dataset(dc.dataset, data_dir, dc.image_size)
    val_ds = None
    if args.val_frac:
        paths = list(ds.train_images)
        k = max(1, int(round(len(paths) * args.val_frac)))
        if k >= len(paths):
            error(f"--val-frac {args.val_frac} leaves no training images")
        val_ds = subset_dataset(ds, paths[-k:])
        ds = subset_dataset(ds, paths[:-k])
        if primary:
            print(f"val split: {k} images held out, {len(paths) - k} train")
    n_train = len(ds.train_images)

    model = build_model(cfg.model, num_classes=dc.num_classes, device=device,
                        **model_kwargs)
    init_params(model, torch.Generator(device=device).manual_seed(tr.seed))
    if args.vgg_weights:        # before the EMA copy, which then starts from it
        report: dict = {}
        model.load_state_dict(load_npz_weights(
            model.state_dict(), args.vgg_weights, strict=args.strict_import,
            report=report, transposed=transposed_weights(model)))
        if primary:
            print(f"imported {len(report['matched'])} VGG16 tensors from "
                  f"{args.vgg_weights}"
                  + (f"; unmatched backbone params: {report['unmatched_params']}"
                     if report["unmatched_params"] else ""))
    mesh_kind = ("none" if grid is None else f"1d-data{grid.data}"
                 if grid.spatial == 1 else f"data{grid.data}xspatial{grid.spatial}")
    if primary:
        print(f"model={cfg.model} device={device} ranks={world} mesh={mesh_kind} "
              f"train_images={n_train}")

    cache_kw = {}
    if args.cache_gb is not None:
        if args.cache_gb <= 0:
            cache_kw["cache"] = False
        else:
            cache_kw["cache_bytes"] = int(args.cache_gb * (1 << 30))
    loader = BatchLoader(ds, tr.batch_size, pad_multiple=stride, seed=tr.seed,
                         device=device, mesh=grid, workers=args.loader_workers,
                         **cache_kw)
    if args.pallas_preprocess:
        from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
            make_preprocess_augment_fn,
        )
        aug = make_preprocess_augment_fn(dc.mean, dc.std, crop_size=dc.crop_size,
                                         random_flip=dc.random_flip)
    else:
        aug = make_augment_fn(dc.mean, dc.std, crop_size=dc.crop_size,
                              random_flip=dc.random_flip, scale_jitter=jitter,
                              color_jitter=color)
        if primary and jitter:
            print(f"scale jitter: {list(jitter)} (one scale per step)")
        if primary and color:
            print(f"color jitter: b/c/s = {list(color)}")

    total_steps = tr.epochs * loader.steps_per_epoch()
    lr_fn = make_lr_schedule(tr.learning_rate, tr.lr_schedule, total_steps,
                             tr.warmup_steps)
    if primary and (tr.lr_schedule != "constant" or tr.warmup_steps):
        print(f"lr schedule: {tr.lr_schedule} over {total_steps} steps"
              + (f" (+{tr.warmup_steps} warmup)" if tr.warmup_steps else ""))
    class_weights = None
    if tr.class_balance:
        from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import (
            class_pixel_counts,
        )
        from semanticsegmentation_tensorflow_tpu_torch.train.loss import (
            median_frequency_weights,
        )
        class_weights = median_frequency_weights(
            class_pixel_counts(ds, dc.num_classes))
        if primary:
            print("class balance (median-frequency): "
                  + " ".join(f"{float(w):.3f}" for w in class_weights))

    optimizer = make_optimizer(tr.optimizer, model.parameters(),
                               tr.learning_rate, tr.weight_decay)
    state = create_train_state(model, optimizer, lr_fn, tr.seed,
                               ema_decay=args.ema_decay)
    # rank 0 alone writes checkpoints; under ZeRO-1 every rank takes part
    # in gathering the moments
    ckpt = CheckpointManager(tr.checkpoint_dir, write=primary)
    if args.resume:
        state = ckpt.restore(state)
        if primary:
            print(f"resumed at step {state.step}")
    if args.qat:
        from semanticsegmentation_tensorflow_tpu_torch.infer import quant

        scales_path, scales = quant.checkpoint_act_scales(tr.checkpoint_dir)
        # every rank has looked for the file before rank 0 can write it, so
        # all of them take the same branch (and meet at the same barriers)
        barrier()
        if scales is not None:
            if primary:
                print(f"QAT: {len(scales)} activation scales from {scales_path}")
        else:
            batches = loader.epoch()
            try:
                calib = [normalize_images(b["image"], dc.mean, dc.std)
                         for _, b in zip(range(args.qat_calib_batches), batches)]
            finally:
                batches.close()
            scales = quant.calibrate_act_scales(model, calib, grid=grid)
            if primary:
                os.makedirs(tr.checkpoint_dir, exist_ok=True)
                quant.save_act_scales(scales_path, scales)
            barrier()      # every rank then trains on the file's scales
            scales = quant.load_act_scales(scales_path)
            if primary:
                print(f"QAT: calibrated {len(scales)} activation scales -> "
                      f"{scales_path}")
        quant.fake_quantize(model, scales)
    shard_opt = False
    if grid is not None:
        shard_opt = args.shard_opt and grid.spatial == 1
        if args.shard_opt and not shard_opt and primary:
            print("note: --shard-opt needs the 1-D data mesh; ignored")
        if shard_opt:
            from semanticsegmentation_tensorflow_tpu_torch.train.state import (
                shard_state_zero1,
            )
            state = shard_state_zero1(state, grid)
            if primary:
                print(f"ZeRO-1: optimizer state sharded over {grid.data} devices")

    logger = MetricsLogger(os.path.join(tr.checkpoint_dir, "logs")) if primary \
        else None

    def log_step(step, m):
        if logger is not None:
            logger.log(step, m)
            print(f"step {step}: " + " ".join(f"{k}={float(v):.4f}"
                                              for k, v in m.items()))

    hooks = LoopHooks(
        on_log=log_step,
        # epoch summaries keyed by the global step under epoch/ tags, so
        # they never collide with the per-step series
        on_epoch=lambda epoch, s: logger is not None and logger.log(
            s["step"], {f"epoch/{k}": v for k, v in s.items()
                        if isinstance(v, (int, float)) and k != "step"}))
    step_fn = make_train_step(dc.num_classes, mesh=grid, augment_fn=aug,
                              remat=tr.remat, class_weights=class_weights,
                              grad_accum=args.grad_accum, loss=args.loss,
                              focal_gamma=args.focal_gamma, shard_opt=shard_opt)
    val_fn = best_ckpt = None
    if val_ds is not None:
        vgrid = grid if grid is not None and grid.spatial == 1 else None
        if primary and grid is not None and vgrid is None:
            print("note: validation runs unsharded under this mesh")
        val_loader = BatchLoader(val_ds, tr.batch_size, pad_multiple=stride,
                                 device=device, drop_remainder=False,
                                 mesh=vgrid, workers=args.loader_workers,
                                 **cache_kw)
        veval = make_eval_step(dc.num_classes, mesh=vgrid)

        def val_fn(state):
            m = SegMetrics(dc.num_classes, device)
            for b in val_loader.epoch():
                out = veval(state, dict(b, image=normalize_images(
                    b["image"], dc.mean, dc.std)))
                m.update(out["cm"], out["loss"])
            s = m.summary()
            return {"val_loss": float(s["loss"]), "val_miou": float(s["miou"])}

        if args.keep_best:
            best_ckpt = CheckpointManager(os.path.join(tr.checkpoint_dir, "best"),
                                          max_to_keep=1, write=primary)
    try:
        state, summary = train(
            state, step_fn, loader.epoch, epochs=tr.epochs,
            num_classes=dc.num_classes, log_every=tr.log_every,
            checkpoint_every=tr.checkpoint_every, ckpt=ckpt, hooks=hooks,
            images_per_batch=tr.batch_size if grid is not None else None,
            val_every=args.val_every, val_fn=val_fn, best_ckpt=best_ckpt)
    finally:
        if logger is not None:
            logger.close()
    barrier()   # the ranks leave together, after rank 0's last checkpoint
    if primary:
        print("final:", summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
