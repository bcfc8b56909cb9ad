"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
same model built in both packages, with one set of weights carried across
by the port's weight bridge. Both sides compute in float32, so differences
are summation order only."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.models.registry import quant_safe_kwargs
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

SMALL = dict(fc_features=32, width_mult=0.25)  # stage widths 16..128


def jax_fcn(name: str = "fcn8s", canonical: bool = False, **kw):
    """The JAX model in f32: production flags, or the canonical build
    (``registry.quant_safe_kwargs``: every perf-only flag off)."""
    extra = quant_safe_kwargs(name) if canonical else {}
    return jax_build(name, num_classes=kw.pop("num_classes", 2),
                     dtype=jnp.float32, **SMALL, **extra, **kw)


def jax_init(model, hw=(64, 96), seed=0):
    # jitted: the eager init runs op by op and takes several times longer
    return jax.jit(lambda k: model.init(k, jnp.zeros((1, *hw, 3), jnp.float32),
                                        train=False))(jax.random.key(seed))


def port_fcn(name: str = "fcn8s", variables=None, **kw):
    """The port's model on the CPU (f32 unless ``dtype`` is given), with
    the JAX ``variables`` converted through ``convert.to_state_dict``
    (strict)."""
    model = build_model(name, num_classes=kw.pop("num_classes", 2),
                        device="cpu", dtype=kw.pop("dtype", torch.float32),
                        **SMALL, **kw)
    if variables is not None:
        sd = convert.to_state_dict(convert.flatten_params(variables), model)
        model.load_state_dict(sd, strict=True)
    return model.eval()


def nhwc_input(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)
