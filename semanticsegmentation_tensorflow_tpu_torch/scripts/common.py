"""Shared CLI pieces of the port's entry points: device selection, the
model flags, ``--mesh``'s devices, and building a Predictor from a preset
plus weights (a state_dict file, or the port's own training checkpoints),
int8-quantized with ``--int8`` (``infer/quant.py``)."""

from __future__ import annotations

import argparse
import os
import sys

import torch

def resolve_device(name: str) -> torch.device:
    """``--device`` -> torch.device. A CUDA device with no card raises: the
    CLIs never drop to the CPU on their own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return device


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="fcn8s_kitti")
    p.add_argument("--model", default=None)
    p.add_argument("--model-kw", default=None,
                   help="comma-separated model kwargs (k=v) - must match "
                        "the flags the weights were trained with")
    p.add_argument("--weights", default=None,
                   help="port state_dict (.pt), e.g. from "
                        "tools/convert_checkpoint_to_torch.py; without it "
                        "the model runs on random weights (seed 0)")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint-dir", default=None,
                   help="the port's training checkpoints (the latest is "
                        "served); an orbax checkpoint of the JAX package "
                        "converts with tools/convert_checkpoint_to_torch.py "
                        "to a --weights file")
    p.add_argument("--ema", action="store_true",
                   help="serve the EMA params of --checkpoint-dir (trained "
                        "with --ema-decay)")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 forward (per-channel weights, "
                        "per-tensor activations; infer/quant.py), BatchNorm "
                        "folded first")


def mesh_devices(device: torch.device) -> list[torch.device] | None:
    """``--mesh`` in one process: every visible device of ``device``'s type
    (each CUDA card; the CPU is one device), ``device`` first (its index
    filled in: ``cuda`` is the current card), or None where that is one
    device, as the JAX CLIs' ``len(jax.devices()) > 1`` check: the flag then
    changes nothing."""
    from semanticsegmentation_tensorflow_tpu_torch.parallel.replicas import indexed

    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    first = indexed(device)
    return [first] + [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count()) if i != first.index]


def check_model_args(args: argparse.Namespace) -> None:
    if args.checkpoint_dir is not None and args.weights:
        raise ValueError("pass --weights or --checkpoint-dir, not both")
    if args.ema and args.checkpoint_dir is None:
        raise ValueError("--ema reads the EMA params of --checkpoint-dir")


def load_checkpoint_weights(directory: str, use_ema: bool,
                            device) -> dict[str, torch.Tensor]:
    """The latest port checkpoint's model state_dict (EMA params with
    ``use_ema``). A directory of the JAX package's orbax checkpoints (step
    subdirectories) raises with the conversion hint."""
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        checkpoint_steps, load_weights,
    )

    if not checkpoint_steps(directory) and os.path.isdir(directory) and any(
            e.isdigit() for e in os.listdir(directory)):
        raise NotImplementedError(
            f"--checkpoint-dir {directory}: an orbax checkpoint of the JAX "
            "package; convert it with tools/convert_checkpoint_to_torch.py "
            "and pass --weights")
    return load_weights(directory, use_ema=use_ema, map_location=device)


def build_served_model(args: argparse.Namespace, device: torch.device, *,
                       calib_paths=(), act_scales=None,
                       int8_label: str = "int8 serving"):
    """Preset + ``--model-kw`` -> (model on ``device`` with ``--weights`` or
    ``--checkpoint-dir``, or seeded random init with a warning; the preset's
    DataConfig). A BatchNorm model's running statistics come with its
    weights (a port checkpoint's EMA parameters are served beside the live
    statistics).

    With ``--int8`` the model is built with the quant-safe kwargs and
    quantized (``infer.quant.quantize_for_inference``: BatchNorm folded,
    then the activation scales ``act_scales``, e.g. a QAT run's, or those
    calibrated on the images ``calib_paths``, weight-only with neither), and
    ``"<int8_label>: N activation scales"`` is printed."""
    from semanticsegmentation_tensorflow_tpu_torch.config import (
        get_preset, parse_model_kw,
    )
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
        build_model, merge_quant_safe_kwargs,
    )
    from semanticsegmentation_tensorflow_tpu_torch.models.common import (
        init_params,
    )

    cfg = get_preset(args.preset)
    dc = cfg.data
    name = args.model or cfg.model
    model_kwargs = dict(cfg.model_kwargs, **parse_model_kw(args.model_kw))
    if args.int8:   # every conv a module the quantization can replace
        model_kwargs = merge_quant_safe_kwargs(name, model_kwargs)
    model = build_model(name, num_classes=dc.num_classes, device=device,
                        **model_kwargs)
    if args.checkpoint_dir is not None:
        model.load_state_dict(load_checkpoint_weights(
            args.checkpoint_dir, args.ema, device), strict=True)
    elif args.weights:
        state = torch.load(args.weights, map_location=device,
                           weights_only=True)
        model.load_state_dict(state, strict=True)
    else:
        print("warning: no --weights given; using seeded random weights",
              file=sys.stderr)
        init_params(model, torch.Generator(device=device).manual_seed(0))
    if args.int8:
        from semanticsegmentation_tensorflow_tpu_torch.infer import quant

        calib = quant.calib_batches_from_files(
            list(calib_paths), dc.image_size, dc.mean, dc.std,
            getattr(model, "total_stride", 32), device=device) or None
        model, scales = quant.quantize_for_inference(model, calib,
                                                     act_scales=act_scales)
        print(f"{int8_label}: {len(scales)} activation scales"
              + (" (weight-only)" if not scales else ""))
    return model, dc


def build_predictor(args: argparse.Namespace, device: torch.device, *,
                    mesh=None, **int8):
    """:func:`build_served_model` (``int8``: its quantization arguments) ->
    Predictor (one replica on each of ``mesh``'s devices, when given),
    painting with the preset
    dataset's palette (Cityscapes' 19 colours for ``unet_cityscapes``; the
    JAX CLIs pass KITTI's two-colour palette whatever the model, which
    paints every class above 0 green)."""
    from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
        overlay_palette,
    )
    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor

    model, dc = build_served_model(args, device, **int8)
    return Predictor(model, dc.image_size, device=device, mean=dc.mean,
                     std=dc.std, overlay_palette=overlay_palette(dc.dataset),
                     alpha=args.alpha, mesh=mesh)
