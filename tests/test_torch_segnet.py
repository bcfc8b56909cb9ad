"""The port's SegNet slice against the JAX package on the CPU: the argmax
pool and unpool (ops/pool.py, ops/cuda/pool.py), the SegNet stage1 tail
(ops/cuda/stage1.py) against the fused Pallas tail in interpret mode and its
jnp reference, the whole model's logits (both JAX trees: the production
flags with the packed enc1/dec1, and the canonical build), one train step,
the weight bridge, the checkpoint converter and the CLIs.

Tolerances: integer-valued inputs make every sum exact, so the pools, the
tail and its gradients are held bit for bit. Random f32 inputs differ only by
summation order: the tail within 1e-5; whole-model logits within 1e-4 of the
largest logit (~20 layers of f32 convs, as for FCN-8s); gradients within
1e-4 of each parameter's largest gradient.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.models.registry import quant_safe_kwargs
from semanticsegmentation_tensorflow_tpu.ops.pallas.stage1 import (
    fused_segnet_stage1_tail, reference_segnet_stage1_tail,
)
from semanticsegmentation_tensorflow_tpu.ops.pool import (
    max_pool_with_argmax as jax_pool, max_unpool as jax_unpool,
)
from semanticsegmentation_tensorflow_tpu.train import loss as jax_loss
from semanticsegmentation_tensorflow_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu.train.step import (
    make_train_step as jax_train_step,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
    pool_argmax, pool_argmax_plain, unpool, unpool_bwd, unpool_bwd_plain,
    unpool_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    SegNetStage1Tail, stage1_tail_segnet, stage1_tail_segnet_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.tie_cases import (
    int_case, segnet_tie_windows, tie_windows,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.pool import (
    max_pool_with_argmax, max_unpool,
)
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_optimizer, make_lr_schedule,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

from torch_parity import nhwc_input

NARROW = dict(width_mult=0.25)  # encoder widths 16..128


def jax_segnet(canonical=False, **kw):
    extra = quant_safe_kwargs("segnet") if canonical else {}
    return jax_build("segnet", num_classes=2, dtype=jnp.float32,
                     **dict(NARROW, **extra, **kw))


def jax_init(model, hw=(32, 64), seed=0):
    return jax.jit(lambda k: model.init(k, jnp.zeros((1, *hw, 3), jnp.float32))
                   )(jax.random.key(seed))


def port_segnet(variables=None, **kw):
    model = build_model("segnet", 2, device="cpu", dtype=torch.float32,
                        **dict(NARROW, **kw))
    if variables is not None:
        model.load_state_dict(convert.to_state_dict(
            convert.flatten_params(variables), model), strict=True)
    return model.eval()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# module 1: max_pool_with_argmax / max_unpool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_argmax_pool_and_unpool_match_jax_exactly(dtype):
    """Tie-rich integer inputs: pooled values, indices (first maximum in
    row-major order), the pool's gradient (routed to the index, ties
    unsplit), the unpool and its gradient, all bit-equal to ops/pool.py."""
    rng = np.random.default_rng(0)
    x = rng.integers(-2, 3, (2, 8, 12, 16)).astype(np.float32)
    g_pool = rng.integers(-3, 4, (2, 4, 6, 16)).astype(np.float32)
    g_unpool = rng.integers(-3, 4, (2, 8, 12, 16)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    (jp, jidx), vjp = jax.vjp(lambda a: jax_pool(a, 2), jnp.asarray(x, jdt))
    (jgx,) = vjp((jnp.asarray(g_pool, jdt), np.zeros(jidx.shape, jax.dtypes.float0)))
    ju, uvjp = jax.vjp(lambda p: jax_unpool(p, jidx, 2), jp)
    (jgp,) = uvjp(jnp.asarray(g_unpool, jdt))

    xt = _t(x).to(tdt).requires_grad_()
    p, idx = max_pool_with_argmax(xt, 2)
    (gx,) = torch.autograd.grad(p, xt, _t(g_pool).to(tdt))
    pt = p.detach().requires_grad_()
    u = max_unpool(pt, idx, 2)
    (gp,) = torch.autograd.grad(u, pt, _t(g_unpool).to(tdt))
    assert idx.dtype == torch.uint8 and set(np.unique(idx.numpy())) == {0, 1, 2, 3}
    for got, want in ((p, jp), (idx, jidx), (gx, jgx), (u, ju), (gp, jgp)):
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want, np.float32))


def test_max_pool_with_argmax_grad_routes_by_index():
    """TF MaxPoolGradWithArgmax parity (tests/test_packed_stem.py:366): the
    gradient goes to the recorded position, not split across exact ties."""
    x = torch.tensor([[1.0, 1.0], [1.0, 0.0]])[None, :, :, None].requires_grad_()
    p, idx = max_pool_with_argmax(x)
    (g,) = torch.autograd.grad(p.sum(), x)
    assert int(idx) == 0
    np.testing.assert_array_equal(g[0, :, :, 0].numpy(), [[1.0, 0.0], [0.0, 0.0]])
    jx = jnp.asarray([[1.0, 1.0], [1.0, 0.0]])[None, :, :, None]
    jg = jax.grad(lambda a: jnp.sum(jax_pool(a, 2)[0]))(jx)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_pool_wrappers_take_plain_versions_only_on_cpu():
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(1, 4, 6, 8)).astype(np.float32))
    g = _t(rng.normal(size=(1, 4, 6, 8)).astype(np.float32))
    launches = pool_argmax.launches, unpool.launches, unpool_bwd.launches
    p, idx = pool_argmax(x)
    wp, widx = pool_argmax_plain(x)
    assert torch.equal(p, wp) and torch.equal(idx, widx)
    assert torch.equal(unpool(p, idx), unpool_plain(p, idx))
    assert torch.equal(unpool_bwd(g, idx), unpool_bwd_plain(g, idx))
    assert (pool_argmax.launches, unpool.launches, unpool_bwd.launches) == launches
    assert launches == (0, 0, 0)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="no pool kernel for device meta"):
        pool_argmax(meta)
    with pytest.raises(ValueError, match="no unpool kernel for device meta"):
        unpool(p.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="no unpool backward kernel"):
        unpool_bwd(meta, idx.to("meta"))
    with pytest.raises(ValueError, match="H and W even"):
        pool_argmax(x[:, :3])
    with pytest.raises(NotImplementedError, match="2x2"):
        max_pool_with_argmax(x, 3)


# ---------------------------------------------------------------------------
# module 3: the SegNet stage1 tail
# ---------------------------------------------------------------------------

def _int_args(rng, n=2):
    """tests/test_packed_stem.py:302-329's integer inputs (packed z1, HWIO
    k2 with repeated taps, b2, b1): many exact ties."""
    z1 = rng.integers(-2, 3, (n, 6, 8, 128)).astype(np.float32)
    k2 = rng.integers(-1, 2, (3, 3, 64, 64)).astype(np.float32)
    k2[1] = k2[0]
    return (z1, k2, rng.integers(-2, 3, (64,)).astype(np.float32),
            rng.integers(-2, 3, (64,)).astype(np.float32))


def _port_segnet_tail(z1_packed, k2_hwio, b2, b1, dtype=torch.float32):
    """The port's SegNetStage1 computation on the JAX tail's packed inputs:
    unpack (a reshape), +b1 as conv1_1's bias, then the autograd Function.
    Returns ((out, idx), leaves)."""
    leaves = [_t(a).to(dtype).requires_grad_() for a in (z1_packed, k2_hwio, b2, b1)]
    zp, k, b2_, b1_ = leaves
    n, h, wp, c2 = zp.shape
    z1 = (zp.reshape(n, h, 2 * wp, c2 // 2) + b1_).contiguous()
    return SegNetStage1Tail.apply(z1, k.permute(3, 2, 0, 1), b2_), leaves


def _jax_tail_grads(fn, args, cot):
    return [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.vdot(fn(*a)[0], jnp.asarray(cot)), (0, 1, 2, 3))(*args)]


def test_segnet_tail_exact_against_jax_with_ties():
    """Integer inputs at the JAX test's [2,6,8,128]: out, idx and the
    gradients of z1, k2, b2 and b1 through SegNetStage1Tail equal the fused
    Pallas tail (interpret mode) and its jnp reference bit for bit."""
    rng = np.random.default_rng(3)
    args = _int_args(rng)
    (out, idx), leaves = _port_segnet_tail(*args)
    cot = rng.integers(-3, 4, out.shape).astype(np.float32)
    got = torch.autograd.grad(out, leaves, _t(cot))
    jargs = [jnp.asarray(a) for a in args]
    fused = lambda *a: fused_segnet_stage1_tail(*a, True)  # noqa: E731
    for fn in (fused, reference_segnet_stage1_tail):
        want_out, want_idx = fn(*jargs)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        for g, w in zip(got, _jax_tail_grads(fn, jargs, cot)):
            np.testing.assert_array_equal(g.numpy(), w)
    assert set(np.unique(idx.numpy())) == {0, 1, 2, 3}


def _bias_tie_args():
    """bf16 windows whose ties appear only in relu(bf16(z + b2)): with a
    centre-tap identity k2 the conv is relu(z1); b2 = 256 rounds z + b2 of
    z = 0 and 1 to 256 (the bf16 spacing there is 2), b2 = -3 maps every
    value <= 3 to 0 (an all-zero window: index 0), b2 = 0 keeps c = b > a."""
    pats = np.array([[1, 0, 3, 2], [0, 1, 0, 1], [1, 2, 2, 0], [2, 1, 0, 2],
                     [0, 0, 0, 0], [3, 1, 3, 0]], np.float32)
    rng = np.random.default_rng(5)
    win = pats[rng.integers(0, len(pats), (1, 3, 8, 64))].reshape(1, 3, 8, 64, 2, 2)
    z1 = win.transpose(0, 1, 4, 2, 5, 3).reshape(1, 6, 8, 128)   # packed pairs
    k2 = np.zeros((3, 3, 64, 64), np.float32)
    k2[1, 1] = np.eye(64)
    b2 = np.array([256.0, -3.0, 0.0, 1.0] * 16, np.float32)
    return z1, k2, b2, np.zeros(64, np.float32)


def test_segnet_tail_bf16_ties_after_the_bias_match_jax():
    """In bf16 the bias add rounds: windows tied only after it, all-zero
    windows and c = b > a route as the TPU kernel (interpret mode) and the
    jnp reference route them; values, indices and gradients bit-equal."""
    args = _bias_tie_args()
    (out, idx), leaves = _port_segnet_tail(*args, dtype=torch.bfloat16)
    ref_idx = np.asarray(reference_segnet_stage1_tail(
        *[jnp.asarray(a, jnp.bfloat16) for a in args])[1])
    pre_bias = pool_argmax_plain(_t(args[0].reshape(1, 6, 16, 64)))[1].numpy()
    assert (ref_idx != pre_bias).any()          # the bias add made new ties
    assert (ref_idx[..., 1::4] == 0).all()      # b2 = -3: all-zero windows
    cot = np.random.default_rng(6).integers(-3, 4, out.shape).astype(np.float32)
    got = torch.autograd.grad(out, leaves, _t(cot).bfloat16())
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    fused = lambda *a: fused_segnet_stage1_tail(*a, True)  # noqa: E731
    for fn in (fused, reference_segnet_stage1_tail):
        want_out, want_idx = fn(*jargs)
        np.testing.assert_array_equal(out.detach().float().numpy(),
                                      np.asarray(want_out, np.float32))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        for g, w in zip(got, _jax_tail_grads(fn, jargs, cot.astype(jnp.bfloat16))):
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("case", [tie_windows, segnet_tie_windows, int_case],
                         ids=["tie_windows", "segnet_tie_windows", "int_case"])
def test_card_tie_cases_route_as_jax(case):
    """The integer inputs that hold the kernels bit for bit on the card
    (ops/cuda/tie_cases.py) are integer-valued in bf16, route through the
    port's plain SegNet tail as through the JAX jnp reference, and hold the
    ties they are meant for: c = b > a (index 1), and for SegNet's case
    all-zero windows on every b2 = -3 channel and windows tied only after
    the bias add."""
    n, h, w, c = 2, 8, 16, 64
    z1, k2, b2 = (t.bfloat16() for t in case(n, h, w, c, 1))
    assert all(torch.equal(t, t.round()) for t in (z1, k2, b2))
    out, idx = stage1_tail_segnet_plain(z1, k2, b2)
    want_out, want_idx = reference_segnet_stage1_tail(
        jnp.asarray(z1.float().numpy().reshape(n, h, w // 2, 2 * c), jnp.bfloat16),
        jnp.asarray(k2.float().permute(2, 3, 1, 0).numpy(), jnp.bfloat16),
        jnp.asarray(b2.float().numpy(), jnp.bfloat16), jnp.zeros(c, jnp.bfloat16))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want_out, np.float32))
    assert bool((idx == 1).any())
    if case is segnet_tie_windows:
        assert bool((idx[..., 1::4] == 0).all())
        pre_bias = pool_argmax_plain(torch.relu(z1))[1]
        assert bool((idx[..., 0::4] != pre_bias[..., 0::4]).any())


def test_segnet_tail_random_inputs_match_jax():
    """Random f32 inputs: values within 1e-5 of both JAX versions, the same
    indices, gradients within 1e-4."""
    rng = np.random.default_rng(7)
    args = (rng.normal(size=(2, 8, 16, 128)).astype(np.float32),
            (rng.normal(size=(3, 3, 64, 64)) * 0.1).astype(np.float32),
            (rng.normal(size=(64,)) * 0.1).astype(np.float32),
            (rng.normal(size=(64,)) * 0.1).astype(np.float32))
    (out, idx), leaves = _port_segnet_tail(*args)
    cot = rng.normal(size=out.shape).astype(np.float32)
    got = torch.autograd.grad(out, leaves, _t(cot))
    jargs = [jnp.asarray(a) for a in args]
    fused = lambda *a: fused_segnet_stage1_tail(*a, True)  # noqa: E731
    for fn in (fused, reference_segnet_stage1_tail):
        want_out, want_idx = fn(*jargs)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        for g, w in zip(got, _jax_tail_grads(fn, jargs, cot)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_segnet_tail_wrapper_takes_plain_version_only_on_cpu():
    rng = np.random.default_rng(8)
    z1 = _t(rng.normal(size=(1, 4, 8, 16)).astype(np.float32))
    k2 = _t(rng.normal(size=(16, 16, 3, 3)).astype(np.float32))
    b2 = _t(rng.normal(size=(16,)).astype(np.float32))
    out, idx = stage1_tail_segnet(z1, k2, b2)
    want = stage1_tail_segnet_plain(z1, k2, b2)
    assert torch.equal(out, want[0]) and torch.equal(idx, want[1])
    assert stage1_tail_segnet.launches == 0
    with pytest.raises(ValueError, match="no stage1 tail for device meta"):
        stage1_tail_segnet(z1.to("meta"), k2.to("meta"), b2.to("meta"))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _assert_logits_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("canonical", [False, True],
                         ids=["production_flags", "quant_safe"])
def test_segnet_logits_match_jax(canonical):
    model = jax_segnet(canonical)
    variables = jax_init(model)
    x = nhwc_input((2, 32, 64, 3), seed=1)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = port_segnet(variables)
    with torch.no_grad():
        got = port(_t(x)).numpy()
    assert got.shape == want.shape == (2, 32, 64, 2) and got.dtype == np.float32
    _assert_logits_close(got, want)


@pytest.mark.parametrize("pallas_pool", [True, False])
def test_segnet_full_width_logits_match_jax(pallas_pool):
    """Full width: the JAX production tree (the width-pair packed enc1 and
    dec1, the `_ConvParams` head) converts strictly, and the logits agree
    with the JAX model's, with the fused stage1 tail (pallas_pool=True; the
    Pallas kernel in interpret mode on the JAX side) and without it."""
    model = jax_segnet(width_mult=1.0, pallas_pool=pallas_pool)
    variables = jax_init(model, seed=2)
    x = nhwc_input((1, 32, 64, 3), seed=3)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = port_segnet(variables, width_mult=1.0, pallas_pool=pallas_pool)
    assert type(port.enc1).__name__ == ("SegNetStage1" if pallas_pool
                                        else "ConvBlock")
    with torch.no_grad():
        got = port(_t(x)).numpy()
    _assert_logits_close(got, want)


@pytest.mark.parametrize("canonical", [False, True],
                         ids=["production_tree", "canonical_tree"])
def test_segnet_weight_bridge_round_trip_is_bit_equal(canonical):
    variables = jax_init(jax_segnet(canonical, width_mult=1.0))
    flat = convert.flatten_params(variables)
    assert "head/kernel" in flat and "enc1/conv1/kernel" in flat
    model = build_model("segnet", 2, device="meta")
    sd = convert.to_state_dict(flat, model)
    assert set(sd) == set(model.state_dict()) and len(sd) == len(flat)
    back = convert.from_state_dict(sd, model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


@pytest.mark.parametrize("kw", [{"use_bn": True}])
def test_segnet_unported_flags_raise(kw):
    """``use_bn`` raised as not ported until BatchNorm was; SegNet now builds
    with a BatchNorm after every encoder and decoder conv, enc1 a plain
    ConvBlock before the argmax pool (no fused SegNet stage1)."""
    m = build_model("segnet", 2, device="meta", **kw)
    assert not m.fused_stage1 and type(m.enc1).__name__ == "ConvBlock"
    assert sum(type(mod).__name__ == "BatchNorm" for mod in m.modules()) == 26


def test_segnet_odd_size_raises_and_decoder_flags_are_layouts():
    x = torch.zeros(1, 32, 34, 3)
    with pytest.raises(ValueError, match="even"):
        port_segnet()(x[:, :, :33])
    a = init_params(port_segnet(), torch.Generator().manual_seed(0))
    b = port_segnet(packed_dec1=False, packed_dec2=True)
    b.load_state_dict(a.state_dict())
    x = _t(nhwc_input((1, 32, 64, 3), seed=4))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))


def _rounding_sensitivity():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import rounding_sensitivity
    return rounding_sensitivity


@pytest.mark.parametrize("case", range(3), ids=["fcn8s_narrow", "segnet_narrow",
                                                "segnet_full_width"])
def test_bf16_spread_is_the_models_not_the_ports(case):
    """The port's bf16 logits sit no further from its f32 logits than the
    JAX package's bf16 model from its own f32 model, on the same weights and
    input (tools/rounding_sensitivity.py --jax): SegNet's large spread
    (~0.3 relative L2, against ~0.014 for FCN-8s) belongs to the model in
    bf16, the index flips its decoder unpools by, not to the port. Bound:
    the port's distance at most 1.5x the JAX model's, its labels' agreement
    with f32 at most 2 points below."""
    rs = _rounding_sensitivity()
    name, kw = rs.CASES[case]
    weights, x = rs.case_weights(name, kw), rs.case_input()
    port_rel, port_agree = rs.port_spread(name, kw, weights, x)
    jax_rel, jax_agree = rs.jax_spread(name, kw, weights, x)
    assert port_rel <= 1.5 * jax_rel and port_agree >= jax_agree - 0.02
    if name == "segnet":
        assert jax_rel > 0.1          # the witness shows the spread itself
    else:
        assert jax_rel < 0.05


def test_segnet_train_step_matches_jax():
    """One Adam step (lr 1e-3, f32) from the same weights on the same batch:
    the loss, the confusion matrix (exact) and every parameter's gradient
    (jax.grad of the JAX step's loss)."""
    jm = jax_segnet()
    variables = jax_init(jm)
    rng = np.random.default_rng(9)
    batch = {"image": rng.normal(size=(2, 32, 64, 3)).astype(np.float32),
             "label": rng.integers(0, 2, (2, 32, 64)).astype(np.int32),
             "valid": rng.random((2, 32, 64)) > 0.25}
    tx = jax_optimizer("adam", 1e-3)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       opt_state=tx.init(variables["params"]), batch_stats={},
                       rng=jax.random.key(0), apply_fn=jm.apply, tx=tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params):
        logits = jm.apply({"params": params}, jb["image"])
        ce, n = jax_loss.softmax_cross_entropy_sum(
            logits, jax.nn.one_hot(jb["label"], 2), jb["valid"], None)
        return ce / jnp.maximum(n, 1.0)

    jgrads = convert.flatten_params(jax.grad(jloss)(variables["params"]))
    lp = np.asarray(jm.apply(variables, jb["image"]), np.float64)
    model = port_segnet(variables).train()
    _, jout = jax_train_step(2)(js, jb)       # donates the JAX params
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                               make_lr_schedule(1e-3), seed=0)
    out = make_train_step(2)(state, {k: _t(v) for k, v in batch.items()})
    # the logits are ~1e-5 (zero biases), so the loss is ln 2 to ~1e-5, and
    # JAX's f32 sum over the ~3000 valid pixels rounds 1.5e-5 of it away
    # (measured against float64); the port's sum stays within 1e-6 of the
    # float64 loss of the same logits
    np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]), rtol=5e-5)
    ce = (np.log(np.exp(lp).sum(-1))
          - np.take_along_axis(lp, batch["label"][..., None], -1)[..., 0])
    np.testing.assert_allclose(out["loss"].item(), ce[batch["valid"]].mean(),
                               rtol=1e-6)
    np.testing.assert_array_equal(out["cm"].numpy(), np.asarray(jout["cm"]))
    grads = convert.from_state_dict(
        {k: p.grad for k, p in model.named_parameters()}, model)
    assert set(grads) == set(jgrads)
    for k, w in jgrads.items():
        np.testing.assert_allclose(grads[k], w, rtol=0,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-12),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_segnet_train_cli_resume_then_infer_image(tmp_path, capsys):
    """train.py --preset segnet_kitti on the CPU at a tiny size, --resume,
    then infer_image from its checkpoint equals a Predictor on the same
    weights."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image, train
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
        load_weights,
    )

    ck = tmp_path / "ck"
    argv = ["--preset", "segnet_kitti", "--synthetic", "--device", "cpu",
            "--model-kw", "width_mult=0.25", "--image-size", "64", "96",
            "--batch-size", "4", "--checkpoint-dir", str(ck)]
    assert train.main(argv + ["--epochs", "1"]) == 0
    assert "model=segnet" in capsys.readouterr().out
    assert train.main(argv + ["--epochs", "1", "--resume"]) == 0
    assert "resumed at step 2" in capsys.readouterr().out
    assert "ckpt_4.pt" in os.listdir(ck)
    src = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (40, 70, 3), np.uint8)).save(src)
    out = tmp_path / "out.png"
    assert infer_image.main(["--preset", "segnet_kitti", "--model-kw",
                             "width_mult=0.25", "--checkpoint-dir", str(ck),
                             "--device", "cpu", "--image", str(src),
                             "--out", str(out)]) == 0
    model = build_model("segnet", 2, device="cpu", width_mult=0.25)
    model.load_state_dict(load_weights(str(ck)))
    want, _ = Predictor(model, (375, 1242), device="cpu").predict_file(str(src))
    np.testing.assert_array_equal(np.asarray(Image.open(out)), want)


def test_segnet_checkpoint_converts_and_matches_jax(tmp_path):
    """tools/convert_checkpoint_to_torch.py --preset segnet_kitti on an orbax
    checkpoint of the JAX SegNet: the port's forward on the result matches
    the JAX forward."""
    from semanticsegmentation_tensorflow_tpu.train.checkpoint import CheckpointManager
    from semanticsegmentation_tensorflow_tpu.train.state import create_train_state

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import convert_checkpoint_to_torch

    model = jax_build("segnet", num_classes=2, **NARROW)
    state = jax.jit(lambda k: create_train_state(
        model, k, (1, 32, 64, 3), jax_optimizer("adam", 1e-4)))(jax.random.key(4))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, wait=True)
    mgr.close()
    out = tmp_path / "w.pt"
    assert convert_checkpoint_to_torch.main(
        ["--preset", "segnet_kitti", "--checkpoint-dir", str(tmp_path / "ckpt"),
         "--model-kw", "width_mult=0.25", "--out", str(out)]) == 0
    port = port_segnet()
    port.load_state_dict(torch.load(out, weights_only=True), strict=True)
    x = nhwc_input((1, 32, 64, 3), seed=5)
    want = np.asarray(jax.jit(jax_segnet().apply)({"params": state.params},
                                                  jnp.asarray(x)))
    with torch.no_grad():
        _assert_logits_close(port(_t(x)).numpy(), want)
