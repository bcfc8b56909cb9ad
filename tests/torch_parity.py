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

# One intra-op thread per test process. The suite runs in several worker
# processes at once, and ATen's OpenMP pool (one thread per core in each)
# then spins the cores away from the threads doing work: on an 8-core host
# beside such a run a SMALL FCN train step took 4.5 s at 8 threads, 0.04 s
# at 1 or 2.
torch.set_num_threads(1)


def jax_fcn(name: str = "fcn8s", canonical: bool = False, **kw):
    """The JAX model in f32: production flags, or the canonical build
    (``registry.quant_safe_kwargs``: every perf-only flag off)."""
    extra = quant_safe_kwargs(name) if canonical else {}
    return jax_build(name, num_classes=kw.pop("num_classes", 2),
                     dtype=jnp.float32, **dict(SMALL, **extra, **kw))


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
                        **dict(SMALL, **kw))
    if variables is not None:
        sd = convert.to_state_dict(convert.flatten_params(variables), model)
        model.load_state_dict(sd, strict=True)
    return model.eval()


def draw_bn_state(model, seed: int, params: bool = False):
    """Every BatchNorm of ``model`` with running statistics drawn away from
    their init (mean ~ N(0, 0.1), var ~ U(0.5, 2)), and with ``params`` its
    scale ~ U(0.5, 1.5) and bias ~ N(0, 0.1), from a numpy seed, so that eval
    mode is no identity. Returns ``model``."""
    from semanticsegmentation_tensorflow_tpu_torch.models.common import BatchNorm

    rng = np.random.default_rng(seed)
    draws = {"mean": lambda c: rng.normal(0, 0.1, c),
             "var": lambda c: rng.uniform(0.5, 2.0, c)}
    if params:
        draws.update(scale=lambda c: rng.uniform(0.5, 1.5, c),
                     bias=lambda c: rng.normal(0, 0.1, c))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                for name in ("scale", "bias", "mean", "var"):
                    if name in draws:
                        t = getattr(m, name)
                        t.copy_(torch.from_numpy(draws[name](t.numel()).astype(np.float32)))
    return model


def nhwc_input(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def decided(jax_pred, images) -> np.ndarray:
    """Pixels whose JAX Predictor logits are not a near-tie: the two
    classes differ by more than 1e-4 of the logit scale. Within that margin
    the f32 sums of the two frameworks (another summation order) may order a
    near-tie either way; at most 0.5 % of pixels may fall in it."""
    logits = np.asarray(jax_pred._logits_fn(jax_pred._variables,
                                            jnp.asarray(images)))
    margin = np.abs(logits[..., 1] - logits[..., 0])
    ok = margin > 1e-4 * np.abs(logits).max()
    assert ok.mean() >= 0.995
    return ok
