"""FCN-8s and SegNet with the Winograd flags against the JAX models, on the
CPU in float32: the logits, the routing of every conv (kernel 6's plain
versions run exactly where the JAX package runs its Pallas kernel), and one
train step's gradients.

Width 0.5 at a 32x64 input puts stages 3-5 (and SegNet's matching decoder
stages) at 128-256 channels, so the gate (``min_ch=128``, H and W multiples
of m) opens. The JAX side runs the Pallas kernel in interpret mode, jitted.
Tolerance: float32 on both sides, the same function in another summation
order; 1e-5 of the logits' scale (their scale is small at random weights:
the score convs start at std 0.01), 1e-4 of each gradient's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.train import loss as jax_loss
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

from torch_parity import jax_init, nhwc_input

HW = (32, 64)


def _models(name, **kw):
    """(JAX model, its variables, the port's model on the same weights)."""
    kw = dict(width_mult=0.5, **({"fc_features": 32} if name == "fcn8s" else {}),
              **kw)
    jm = jax_build(name, num_classes=2, dtype=jnp.float32, **kw)
    variables = jax_init(jm, hw=HW)
    pm = build_model(name, 2, device="cpu", dtype=torch.float32, **kw)
    pm.load_state_dict(convert.to_state_dict(convert.flatten_params(variables), pm))
    return jm, variables, pm.eval()


@pytest.fixture
def routed(monkeypatch):
    """Counts the calls of kernel 6's plain forward (the CPU's kernel 6)."""
    calls = []
    fwd = cw.winograd_fwd_plain

    def spy(x, u, b, o, variant, epilogue):
        calls.append((tuple(x.shape), u.shape[-1], variant, epilogue))
        return fwd(x, u, b, o, variant, epilogue)

    monkeypatch.setattr(cw, "winograd_fwd_plain", spy)
    return calls


def _jax_routed(jm, variables, x, winograd):
    """The layers the JAX model runs in its Pallas kernel, as
    ((x shape), Cout, variant, epilogue), from a spy on its public ops."""
    from semanticsegmentation_tensorflow_tpu.ops.pallas import winograd as jpw

    seen = []
    orig = (jpw.winograd_conv_bias_relu, jpw.winograd_conv3x3)

    def cbr(x_, w_, b_, v, interp):
        seen.append((tuple(x_.shape), w_.shape[-1], v, "bias_relu"))
        return orig[0](x_, w_, b_, v, interp)

    def raw(x_, w_, v, interp):
        seen.append((tuple(x_.shape), w_.shape[-1], v, "none"))
        return orig[1](x_, w_, v, interp)

    jpw.winograd_conv_bias_relu, jpw.winograd_conv3x3 = cbr, raw
    try:
        out = jax.jit(lambda v, x_: jm.apply(v, x_, train=False))(variables, x)
    finally:
        jpw.winograd_conv_bias_relu, jpw.winograd_conv3x3 = orig
    return np.asarray(out), seen


@pytest.mark.parametrize("name,kw", [
    ("fcn8s", dict(winograd="f2")),
    ("fcn8s", dict(winograd="f4")),
    ("fcn8s", dict(winograd_fc6=True)),
    ("segnet", dict(winograd="f2")),
    ("segnet", dict(winograd="f4")),
])
def test_logits_and_routing_with_winograd_match_jax(name, kw, routed):
    jm, variables, pm = _models(name, **kw)
    x = nhwc_input((1, *HW, 3))
    want, jax_layers = _jax_routed(jm, variables, jnp.asarray(x), kw.get("winograd"))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and scale > 0
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    assert routed == jax_layers
    if "winograd" in kw:
        assert len(routed) >= 3  # stages 3-4 (and the decoder's) at least


def test_fcn_train_step_gradients_with_winograd_match_jax(routed):
    """One train step (dropout 0, Adam 1e-3, f32) of FCN-8s with
    winograd=f2: the loss and every parameter's gradient against jax.grad
    of the JAX model's loss on the same batch; the backward runs the masked
    forward (dx) and the wgrad plain versions."""
    jm, variables, pm = _models("fcn8s", winograd="f2", dropout_rate=0.0)
    rng = np.random.default_rng(3)
    batch = {"image": rng.normal(size=(2, *HW, 3)).astype(np.float32),
             "label": rng.integers(0, 2, (2, *HW)).astype(np.int32),
             "valid": rng.random((2, *HW)) > 0.25}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params):
        logits = jm.apply({"params": params}, jb["image"], train=False)
        ce, n = jax_loss.softmax_cross_entropy_sum(
            logits, jax.nn.one_hot(jb["label"], 2), jb["valid"], None)
        return ce / jnp.maximum(n, 1.0)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    jgrads = convert.flatten_params(jgrads)
    wgrads = []
    orig = cw.winograd_wgrad_plain
    cw.winograd_wgrad_plain = lambda *a: wgrads.append(a[-1]) or orig(*a)
    try:
        state = create_train_state(pm.train(), make_optimizer(
            "adam", pm.parameters(), 1e-3), make_lr_schedule(1e-3), seed=0)
        out = make_train_step(2)(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    finally:
        cw.winograd_wgrad_plain = orig
    np.testing.assert_allclose(out["loss"].item(), float(jl), rtol=1e-5)
    # every routed layer: one forward, one dgrad (the masked or raw
    # forward kernel) and one wgrad
    assert len(wgrads) >= 3 and len(routed) == 2 * len(wgrads)
    grads = convert.from_state_dict({k: p.grad for k, p in pm.named_parameters()}, pm)
    assert set(grads) == set(jgrads)
    for k, w in jgrads.items():
        np.testing.assert_allclose(grads[k], w, rtol=0,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-12),
                                   err_msg=k)
