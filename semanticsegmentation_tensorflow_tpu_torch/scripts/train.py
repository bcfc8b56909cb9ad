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
(``pallas_spmd=True``, no Winograd); at one rank the step then runs
unsharded, as the JAX script does on one device, and trains through the halo
mode of the fused stage1 (kernel 1c). Only rank 0 writes checkpoints and
logs.

``--pallas-preprocess`` keeps the JAX flag's name: it selects the CUDA
preprocess kernel (``ops/cuda/preprocess.py``) for the image leg of the
augment. Checkpoints (``<checkpoint-dir>/ckpt_<step>.pt``) are read back by
``infer_image``/``serve --checkpoint-dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

# flags of the JAX CLI that the port does not implement yet: each raises
# when set away from its default
UNPORTED = {"shard_opt": False,
            "qat": False, "scale_jitter": None, "color_jitter": None,
            "val_frac": 0.0, "val_every": 1, "keep_best": False,
            "qat_calib_batches": 4, "loader_workers": 0,
            "vgg_weights": None, "strict_import": False}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="fcn8s_kitti")
    p.add_argument("--model", default=None, help="override preset model")
    p.add_argument("--model-kw", default=None,
                   help="comma-separated k=v model kwargs overriding the preset")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated synthetic KITTI fixtures")
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
    p.add_argument("--pallas-preprocess", action="store_true",
                   help="flip + crop + normalize with the CUDA preprocess "
                        "kernel (bit-equal to its plain version)")
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
    for name, default in UNPORTED.items():
        flag = "--" + name.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(flag, action="store_true", help="not ported yet")
        else:
            p.add_argument(flag, type=type(default) if default is not None
                           else str, default=default, help="not ported yet")
    args = p.parse_args(argv)
    used = sorted("--" + k.replace("_", "-") for k, d in UNPORTED.items()
                  if getattr(args, k) != d)
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
        make_augment_fn,
    )
    from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import BatchLoader
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import (
        resolve_device,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.loop import LoopHooks, train
    from semanticsegmentation_tensorflow_tpu_torch.train.state import (
        create_train_state, make_lr_schedule, make_optimizer,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step
    from semanticsegmentation_tensorflow_tpu_torch.utils.logging import MetricsLogger

    from semanticsegmentation_tensorflow_tpu_torch.parallel.launch import (
        barrier, initialize_distributed, is_primary, local_device,
    )
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (
        check_rows, make_grid,
    )

    if args.spatial < 1:
        raise ValueError(f"--spatial must be >= 1, got {args.spatial}")
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

    grid = None
    if world > 1 and not args.no_mesh:
        grid = make_grid(world // args.spatial, args.spatial)
        if args.spatial > 1 and dc.crop_size is not None:
            # random crops gather across spatial shards; train at full size
            dc = dataclasses.replace(dc, crop_size=None)
            print("note: --spatial disables random crop (full-size training)")
    if args.spatial > 1:   # before any work, at any world size
        check_rows(-(-dc.image_size[0] // 32) * 32, args.spatial)

    data_dir = args.data_dir or dc.data_dir
    if args.synthetic:
        if dc.dataset == "cityscapes":
            raise NotImplementedError("the cityscapes dataset is not ported yet")
        data_dir = generate_synthetic_kitti(
            tempfile.mkdtemp(prefix="synth_kitti_"),
            n_train=max(8, tr.batch_size), h=dc.image_size[0],
            w=dc.image_size[1])
    # a bad --data-dir fails here, before any device work
    ds = build_dataset(dc.dataset, data_dir, dc.image_size)
    n_train = len(ds.train_images)

    model_kwargs = dict(cfg.model_kwargs, **parse_model_kw(args.model_kw))
    if args.spatial > 1:
        from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
            merge_spmd_safe_kwargs,
        )
        model_kwargs = merge_spmd_safe_kwargs(cfg.model, model_kwargs)
    model = build_model(cfg.model, num_classes=dc.num_classes, device=device,
                        **model_kwargs)
    init_params(model, torch.Generator(device=device).manual_seed(tr.seed))
    stride = getattr(model, "total_stride", 32)
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
                         device=device, mesh=grid, **cache_kw)
    if args.pallas_preprocess:
        from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
            make_preprocess_augment_fn,
        )
        aug = make_preprocess_augment_fn(dc.mean, dc.std, crop_size=dc.crop_size,
                                         random_flip=dc.random_flip)
    else:
        aug = make_augment_fn(dc.mean, dc.std, crop_size=dc.crop_size,
                              random_flip=dc.random_flip)

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
    ckpt = CheckpointManager(tr.checkpoint_dir)
    if args.resume:
        state = ckpt.restore(state)
        if primary:
            print(f"resumed at step {state.step}")
    if not primary:           # rank 0 alone writes checkpoints and logs
        ckpt = None

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
                              class_weights=class_weights,
                              grad_accum=args.grad_accum, loss=args.loss,
                              focal_gamma=args.focal_gamma)
    try:
        state, summary = train(
            state, step_fn, loader.epoch, epochs=tr.epochs,
            num_classes=dc.num_classes, log_every=tr.log_every,
            checkpoint_every=tr.checkpoint_every, ckpt=ckpt, hooks=hooks,
            images_per_batch=tr.batch_size if grid is not None else None)
    finally:
        if logger is not None:
            logger.close()
    barrier()   # the ranks leave together, after rank 0's last checkpoint
    if primary:
        print("final:", summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
