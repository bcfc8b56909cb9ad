#!/usr/bin/env python
"""Convert a JAX-package orbax checkpoint into the PyTorch port's weights.

Restores the checkpoint with the JAX package (``train/checkpoint.py``) for a
preset's model, then writes the port's ``state_dict`` (``.pt``) through the
port's weight bridge (``semanticsegmentation_tensorflow_tpu_torch/convert.py``,
strict: every flax leaf lands on exactly one port parameter or, for a
BatchNorm model's ``batch_stats``, buffer). The result is what the port's
CLIs take as ``--weights``:

    python tools/convert_checkpoint_to_torch.py --preset fcn8s_kitti \
        --checkpoint-dir checkpoints --out fcn8s_kitti.pt
    python -m semanticsegmentation_tensorflow_tpu_torch.scripts.infer_image \
        --preset fcn8s_kitti --weights fcn8s_kitti.pt --image um_000000.png

This tool imports both JAX and PyTorch; the port itself imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="fcn8s_kitti")
    p.add_argument("--model", default=None)
    p.add_argument("--model-kw", default=None,
                   help="comma-separated model kwargs (k=v) the checkpoint "
                        "was trained with")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the latest)")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA params (trained with --ema-decay)")
    p.add_argument("--out", required=True, help="output .pt path")
    args = p.parse_args(argv)

    import jax
    import torch

    from semanticsegmentation_tensorflow_tpu.config import (
        get_preset, parse_model_kw,
    )
    from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
    from semanticsegmentation_tensorflow_tpu.models.registry import padded_input_hw
    from semanticsegmentation_tensorflow_tpu.train.checkpoint import CheckpointManager
    from semanticsegmentation_tensorflow_tpu.train.state import (
        create_abstract_state, make_optimizer,
    )
    from semanticsegmentation_tensorflow_tpu_torch import convert
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    cfg = get_preset(args.preset)
    name = args.model or cfg.model
    model_kwargs = dict(cfg.model_kwargs, **parse_model_kw(args.model_kw))
    jax_model = jax_build(name, num_classes=cfg.data.num_classes, **model_kwargs)
    h, w = padded_input_hw(jax_model, cfg.data.image_size)
    template = create_abstract_state(jax_model, (1, h, w, 3),
                                     make_optimizer("adam", 1e-4), ema=args.ema)
    ckpt = CheckpointManager(args.checkpoint_dir)
    try:
        if ckpt.latest_step() is None:
            raise FileNotFoundError(f"no checkpoint under {args.checkpoint_dir!r}")
        state = ckpt.restore(template, step=args.step)
    finally:
        ckpt.close()
    # a BatchNorm model's running statistics ride beside the (EMA) params,
    # as the JAX package serves them
    variables = {"params": state.eval_params(args.ema)}
    if jax.tree.leaves(state.batch_stats):
        variables["batch_stats"] = state.batch_stats
    flat = convert.flatten_params(jax.device_get(variables))

    port = build_model(name, num_classes=cfg.data.num_classes, device="meta",
                       **model_kwargs)
    state_dict = convert.to_state_dict(flat, port)
    torch.save(state_dict, args.out)
    n = sum(t.numel() for t in state_dict.values())
    print(f"wrote {args.out}: {len(state_dict)} tensors, {n} params "
          f"(step {int(state.step)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
