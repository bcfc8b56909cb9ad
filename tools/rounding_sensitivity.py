#!/usr/bin/env python3
"""How far a bf16 forward of the segmentation models lands from the float32
forward of the same weights, on the CPU.

    python tools/rounding_sensitivity.py          # the port alone
    python tools/rounding_sensitivity.py --jax    # and the JAX package beside it

For narrow FCN-8s and SegNet and a full-width SegNet, seeded random weights
and a seeded 2x40x70 image batch, normalized and padded as the Predictor
does, it prints the relative L2 distance of the bf16 logits to the f32 ones
and the share of equal labels: for the port's models (the plain versions of
the kernels) and, with ``--jax``, for the JAX package's models (production
flags, the Pallas kernels in interpret mode) on the same weights, carried
across by the port's weight bridge, and the same input. SegNet routes its
decoder by argmax indices, which a one-ulp difference can flip; this is the
spread any two bf16 runs of it show, and the reason chip_smoke holds SegNet's
kernel build against the f32 model rather than against the plain bf16 build.
The JAX reading is an independent witness that the spread belongs to the
model in bf16, not to the port. Only ``--jax`` imports JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = (("fcn8s", {"fc_features": 32, "width_mult": 0.25}),
         ("segnet", {"width_mult": 0.25}),
         ("segnet", {"width_mult": 1.0}))
MEAN, STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)


def distance(lb, lf) -> tuple[float, float]:
    """Relative L2 of bf16 logits ``lb`` to f32 logits ``lf`` (numpy or
    torch, [..., 2]) and the share of equal two-class labels."""
    import numpy as np

    lb, lf = np.asarray(lb, np.float64), np.asarray(lf, np.float64)
    rel = float(np.linalg.norm(lb - lf) / np.linalg.norm(lf))
    agree = float(((lb[..., 1] > lb[..., 0]) == (lf[..., 1] > lf[..., 0])).mean())
    return rel, agree


def case_input(seed: int = 0):
    """The Predictor's input path on a seeded [2,40,70,3] u8 batch: the
    normalized, stride-padded float32 NHWC tensor."""
    import numpy as np
    import torch

    from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
        normalize_images,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.shape import pad_to_multiple

    img = np.random.default_rng(seed).integers(0, 256, (2, 40, 70, 3), np.uint8)
    x = normalize_images(torch.from_numpy(img), torch.tensor(MEAN),
                         torch.tensor(STD))
    return pad_to_multiple(x, 32)


def port_spread(name: str, kw: dict, weights: dict, x) -> tuple[float, float]:
    import torch

    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    logits = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_model(name, 2, device="cpu", dtype=dtype, **kw)
        model.load_state_dict(weights)
        with torch.no_grad():
            logits[dtype] = model.to(dtype).eval()(x).float().numpy()
    return distance(logits[torch.bfloat16], logits[torch.float32])


def jax_spread(name: str, kw: dict, weights: dict, x) -> tuple[float, float]:
    """The JAX package's model (production flags) in bf16 and f32 on the
    port's ``weights`` and input."""
    import jax
    import jax.numpy as jnp

    from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
    from semanticsegmentation_tensorflow_tpu_torch import convert
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    jax.config.update("jax_platforms", "cpu")
    flat = convert.from_state_dict(weights, build_model(name, 2, device="meta",
                                                        **kw))
    variables = {"params": convert.unflatten_params(flat)}
    xj = jnp.asarray(x.numpy())
    logits = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        model = jax_build(name, num_classes=2, dtype=dtype, **kw)
        logits[dtype] = jax.jit(model.apply)(variables, xj).astype(jnp.float32)
    return distance(logits[jnp.bfloat16], logits[jnp.float32])


def case_weights(name: str, kw: dict, seed: int = 0) -> dict:
    import torch

    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    return init_params(build_model(name, 2, device="cpu", **kw),
                       torch.Generator().manual_seed(seed)).state_dict()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--jax", action="store_true",
                   help="also run the JAX package's models on the same weights")
    args = p.parse_args(argv)
    x = case_input()
    for name, kw in CASES:
        weights = case_weights(name, kw)
        rel, agree = port_spread(name, kw, weights, x)
        line = (f"{name} {kw}: bf16 vs f32 logits, port: relative L2 {rel:.4f}, "
                f"labels equal {100 * agree:.2f} %")
        if args.jax:
            rel, agree = jax_spread(name, kw, weights, x)
            line += (f"; JAX package: relative L2 {rel:.4f}, labels equal "
                     f"{100 * agree:.2f} %")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
