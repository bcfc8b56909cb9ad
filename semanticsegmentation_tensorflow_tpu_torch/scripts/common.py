"""Shared CLI pieces of the port's entry points: device selection, the
model flags, and building a Predictor from a preset plus a weights file."""

from __future__ import annotations

import argparse
import sys

import torch

# flags of the JAX package's CLIs that the port does not implement yet
UNPORTED_FLAGS = ("int8", "tiled", "ema", "mesh", "artifact")


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
                   help="not supported: convert an orbax checkpoint with "
                        "tools/convert_checkpoint_to_torch.py, then pass "
                        "--weights")
    for flag in UNPORTED_FLAGS:
        p.add_argument(f"--{flag}", default=None, nargs="?", const=True,
                       help="not ported yet (raises)")


def check_unported(args: argparse.Namespace) -> None:
    used = [f for f in UNPORTED_FLAGS if getattr(args, f) is not None]
    if used:
        raise NotImplementedError(
            f"not ported yet: {', '.join('--' + f for f in used)}")
    if args.checkpoint_dir is not None:
        raise NotImplementedError(
            "--checkpoint-dir: the port reads a state_dict; convert the "
            "checkpoint with tools/convert_checkpoint_to_torch.py and pass "
            "--weights")


def build_predictor(args: argparse.Namespace, device: torch.device):
    """Preset + ``--model-kw`` -> model on ``device`` with ``--weights`` (or
    seeded random init, with a warning) -> Predictor."""
    from semanticsegmentation_tensorflow_tpu_torch.config import (
        get_preset, parse_model_kw,
    )
    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.models.common import (
        init_params,
    )

    cfg = get_preset(args.preset)
    dc = cfg.data
    model_kwargs = dict(cfg.model_kwargs, **parse_model_kw(args.model_kw))
    model = build_model(args.model or cfg.model, num_classes=dc.num_classes,
                        device=device, **model_kwargs)
    if args.weights:
        state = torch.load(args.weights, map_location=device,
                           weights_only=True)
        model.load_state_dict(state, strict=True)
    else:
        print("warning: no --weights given; using seeded random weights",
              file=sys.stderr)
        init_params(model, torch.Generator(device=device).manual_seed(0))
    return Predictor(model, dc.image_size, device=device, mean=dc.mean,
                     std=dc.std, alpha=args.alpha)
