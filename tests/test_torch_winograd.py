"""The port's Winograd ops (``ops/winograd.py``, kernel 6's plain versions
in ``ops/cuda/winograd.py``) and the modules that route to them, against
the JAX package on the same numpy inputs, on the CPU.

The JAX side of kernel 6 is the Pallas kernel in interpret mode (jitted: the
eager interpreter takes minutes). Tolerances: in float32 both sides compute
the same sums in another order (1e-5 of the scale); in bf16 the transforms
round alike (the same order, no fused multiply-add) and the products of
bf16 values are exact in float32, so only the float32 summation order of
the contraction differs, which may move an output by one bf16 rounding
(2^-8 of its value) and a float32 gradient by 1e-5 of its scale."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.models.common import (
    ConvBlock as JaxConvBlock, winograd_impl as jax_winograd_impl,
)
from semanticsegmentation_tensorflow_tpu.ops import winograd as jw
from semanticsegmentation_tensorflow_tpu.ops.packed_stem import (
    PooledConvBlock as JaxPooledConvBlock,
)
from semanticsegmentation_tensorflow_tpu.ops.pallas import winograd as jpw
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.models.common import ConvBlock
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import PooledConvBlock
from semanticsegmentation_tensorflow_tpu_torch.ops import winograd as tw
from semanticsegmentation_tensorflow_tpu_torch.ops.conv import winograd_impl
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import build
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _hwio(w_oihw: torch.Tensor) -> np.ndarray:
    return w_oihw.detach().permute(2, 3, 1, 0).numpy()


def _data(seed, n, h, w, c, co, r=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h, w, c)).astype(np.float32),
            (rng.normal(size=(r, r, c, co)) / np.sqrt(r * r * c)).astype(np.float32),
            (0.1 * rng.normal(size=(co,))).astype(np.float32))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err:.3g} > {tol} x {scale:.3g}"


# ---------------------------------------------------------------------------
# tables and weight-side transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["f2", "f3", "f4", "f2r7"])
def test_variant_tables_bit_equal_jax(variant):
    mine, ref = tw.VARIANTS[variant], jw.VARIANTS[variant]
    assert (mine.name, mine.m, mine.r, mine.a) == (ref.name, ref.m, ref.r, ref.a)
    for t in ("BT", "G", "AT"):
        a, b = getattr(mine, t), getattr(ref, t)
        assert a.dtype == b.dtype and np.array_equal(a, b), t


def test_cuda_source_tables_equal_variants():
    """The tables written out in ``csrc/winograd.cu`` are the variants'."""
    src = (build.CSRC / "winograd.cu").read_text()
    found = re.findall(r"float (bt|at)<(\d)>\(int i, int j\) \{\s*constexpr float "
                       r"t\[\d\]\[\d\] = (\{.*?\});", src)
    assert len(found) == 4
    for name, m, body in found:
        table = np.array(eval(body.replace("{", "[").replace("}", "]")
                              .replace("f", "")), np.float32)
        want = getattr(tw.VARIANTS[f"f{m}"], name.upper())
        assert np.array_equal(table, want), (name, m)


@pytest.mark.parametrize("variant", ["f2", "f3", "f4"])
def test_transform_kernel_and_rot180_swap_match_jax(variant):
    _, w, _ = _data(0, 1, 4, 4, 8, 16)
    got = tw.transform_kernel(_oihw(w), variant).numpy()
    want = np.asarray(jw.transform_kernel(jnp.asarray(w), variant))
    _close(got, want, 1e-6, "U")
    rot = tw.rot180_swap(_oihw(w))
    np.testing.assert_array_equal(_hwio(rot), np.asarray(jw.rot180_swap(jnp.asarray(w))))
    u = cw.u_for(_oihw(w), variant, torch.bfloat16)
    assert u.shape == (tw.VARIANTS[variant].a ** 2, 8, 16)
    _close(u.float().numpy(), np.asarray(
        jpw._u_for(jnp.asarray(w), variant, jnp.bfloat16), np.float32), 2 ** -7, "u")


@pytest.mark.parametrize("variant,mxu", [("f2", None), ("f4", None),
                                         ("f2", "bf16"), ("f4", "bf16")])
def test_winograd_conv2d_ref_matches_jax(variant, mxu):
    x, w, _ = _data(1, 2, 7, 10, 8, 12)  # ragged: H, W not multiples of m
    dt = (torch.bfloat16, jnp.bfloat16) if mxu else (None, None)
    got = tw.winograd_conv2d_ref(torch.from_numpy(x), _oihw(w), variant, dt[0])
    want = jw.winograd_conv2d_ref(jnp.asarray(x), jnp.asarray(w), variant, dt[1])
    _close(got.numpy(), want, 1e-5 if mxu is None else 2 ** -8, "ref")


def _jax_grads(fn, args):
    """fn(*args) and the gradients of sum(sin(fn(*args))), one jit."""
    def loss(*a):
        out = fn(*a)
        return jnp.sum(jnp.sin(out.astype(jnp.float32))), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return out, grads


def _port_grads(fn, args):
    leaves = [a.clone().requires_grad_() for a in args]
    out = fn(*leaves)
    torch.sin(out.float()).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("variant,relu", [("f2", True), ("f4", False)])
def test_materialized_form_matches_jax(variant, relu):
    """winograd_conv2d (the "x" form), values and dx, dw, db. V, M and dM
    are bf16 in both (whatever x's dtype), computed from float32 einsums in
    other orders, so an element near a rounding boundary may round to the
    other neighbour: 2^-8 of the scale; db is a float32 sum."""
    x, w, b = _data(2, 2, 6, 10, 16, 8)
    jout, jg = _jax_grads(lambda x_, w_, b_: jw.winograd_conv2d(
        x_, w_, b_, variant, relu), tuple(map(jnp.asarray, (x, w, b))))
    out, g = _port_grads(lambda x_, w_, b_: tw.winograd_conv2d(
        x_, w_, b_, variant, relu), [torch.from_numpy(x), _oihw(w), torch.from_numpy(b)])
    _close(out.numpy(), jout, 2 ** -8, "y")
    _close(g[0].numpy(), jg[0], 2 ** -8, "dx")
    _close(_hwio(g[1]), jg[1], 2 ** -8, "dw")
    _close(g[2].numpy(), jg[2], 1e-5, "db")


def test_conv_large_matches_jax():
    """fc6's tile-conv form (7x7, F(3,3)), values and dx, dw, db; bf16
    V and M as in the "x" form, so the same bounds."""
    x, w, b = _data(3, 2, 5, 8, 8, 16, r=7)
    jout, jg = _jax_grads(lambda x_, w_, b_: jw.winograd_conv_large(
        x_, w_, b_, "f3", True), tuple(map(jnp.asarray, (x, w, b))))
    out, g = _port_grads(lambda x_, w_, b_: tw.winograd_conv_large(
        x_, w_, b_, "f3", True), [torch.from_numpy(x), _oihw(w), torch.from_numpy(b)])
    _close(out.numpy(), jout, 2 ** -8, "y")
    _close(g[0].numpy(), jg[0], 2 ** -8, "dx")
    _close(_hwio(g[1]), jg[1], 2 ** -8, "dw")
    _close(g[2].numpy(), jg[2], 1e-5, "db")


# ---------------------------------------------------------------------------
# kernel 6: the plain versions against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["f2", "f4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_plain_versions_match_pallas(variant, dtype):
    """Both public ops, forward and dx, dw, db through the autograd
    Functions (the masked forward and the wgrad). bf16: the forward and dx
    are one bf16 rounding of sums that agree to float32 order, so they may
    differ by 2^-8 of the scale; dw and db are float32 sums."""
    x, w, b = _data(4, 2, 8, 12, 8, 16)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    y_tol = 1e-5 if dtype == "float32" else 2 ** -8
    jout, jg = _jax_grads(lambda x_, w_, b_: jpw.winograd_conv_bias_relu(
        x_, w_, b_, variant, True), (jx, jnp.asarray(w), jnp.asarray(b)))
    out, g = _port_grads(lambda x_, w_, b_: cw.winograd_conv_bias_relu(
        x_, w_, b_, variant), [tx, _oihw(w), torch.from_numpy(b)])
    assert out.dtype == tdt and float((out > 0).float().mean()) > 0.2
    _close(out.float().numpy(), jout, y_tol, "bias_relu y")
    _close(g[0].float().numpy(), jg[0], y_tol, "bias_relu dx")
    _close(_hwio(g[1]), jg[1], 1e-5, "bias_relu dw")
    _close(g[2].numpy(), jg[2], 1e-5, "bias_relu db")
    jout, jg = _jax_grads(lambda x_, w_: jpw.winograd_conv3x3(
        x_, w_, variant, True), (jx, jnp.asarray(w)))
    out, g = _port_grads(lambda x_, w_: cw.winograd_conv3x3(x_, w_, variant),
                         [tx, _oihw(w)])
    _close(out.float().numpy(), jout, y_tol, "raw y")
    _close(g[0].float().numpy(), jg[0], y_tol, "raw dx")
    _close(_hwio(g[1]), jg[1], 1e-5, "raw dw")


@pytest.mark.parametrize("variant", ["f2", "f4"])
def test_kernel_plain_versions_compute_the_conv(variant):
    """In float32 the forward is the direct SAME conv, the masked forward
    its input gradient and the wgrad's dU the gradient of U."""
    x, w, b = _data(5, 1, 8, 8, 8, 8)
    tx, tw_ = torch.from_numpy(x), _oihw(w)
    u = cw.u_for(tw_, variant, torch.float32).requires_grad_()
    direct = torch.nn.functional.conv2d(tx.permute(0, 3, 1, 2), tw_, padding=1
                                        ).permute(0, 2, 3, 1)
    y = cw.winograd_fwd(tx, u, None, None, variant, "none")
    _close(y.detach().numpy(), direct.numpy(), 1e-5, "fwd")
    g = torch.from_numpy(np.random.default_rng(6).normal(size=y.shape).astype(np.float32))
    o = torch.from_numpy(np.random.default_rng(7).normal(size=y.shape).astype(np.float32))
    du_auto, = torch.autograd.grad(y, u, g * (o > 0))
    du, db = cw.winograd_wgrad(tx, g, o, variant)
    _close(du.numpy(), du_auto.numpy(), 1e-5, "dU")
    _close(db.numpy(), (g * (o > 0)).sum((0, 1, 2)).numpy(), 1e-5, "db")
    xl = tx.clone().requires_grad_()
    dx_auto, = torch.autograd.grad(torch.nn.functional.conv2d(
        xl.permute(0, 3, 1, 2), tw_, padding=1).permute(0, 2, 3, 1), xl, g * (o > 0))
    dx = cw.winograd_fwd(g, cw.u_for(tw.rot180_swap(tw_), variant, torch.float32),
                         None, o, variant, "none")
    _close(dx.numpy(), dx_auto.numpy(), 1e-5, "dx")


def test_kernel_wrappers_refuse_other_devices_and_count_nothing_on_cpu():
    x = torch.zeros(1, 4, 4, 32, device="meta")
    u = torch.zeros(16, 32, 32, device="meta")
    with pytest.raises(ValueError, match="no Winograd kernel"):
        cw.winograd_fwd(x, u, None, None, "f2", "none")
    with pytest.raises(ValueError, match="weight gradient"):
        cw.winograd_wgrad(x, x, None, "f2")
    with pytest.raises(ValueError, match="epilogue"):
        cw.winograd_fwd(x, u, None, None, "f2", "relu")
    before = (cw.winograd_fwd.launches, cw.winograd_wgrad.launches)
    xc, wc, bc = (torch.from_numpy(a) for a in _data(8, 1, 4, 4, 8, 8))
    cw.winograd_conv_bias_relu(xc, _oihw(wc.numpy()), bc, "f2")
    assert (cw.winograd_fwd.launches, cw.winograd_wgrad.launches) == before


# ---------------------------------------------------------------------------
# routing and the modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("winograd", [None, "f2", "f4", "f3", "f2x", "f4x", "f3x",
                                      "f2r7x"])
def test_winograd_impl_routes_like_jax(winograd):
    names = {"pallas": "kernel", "xla": "materialized", None: None}
    for h, w in ((6, 8), (8, 12), (24, 78), (20, 72), (7, 9)):
        for c in (64, 128, 256, 512):
            for co in (64, 128, 256, 512):
                for r in (3, 7):
                    for d in (1, 2):
                        x_shape = (2, h, w, c)
                        want = jax_winograd_impl(x_shape, (r, r, c, co), winograd, d)
                        got = winograd_impl(x_shape, (co, c, r, r), winograd, d)
                        assert got == names[want], (x_shape, r, c, co, d)


def test_unknown_variant_raises():
    for fn, shape in ((jax_winograd_impl, (3, 3, 128, 128)),
                      (winograd_impl, (128, 128, 3, 3))):
        with pytest.raises(ValueError, match="unknown winograd variant"):
            fn((1, 8, 8, 128), shape, "f5")


def _flax_block(cls, features, n_convs, winograd, x):
    m = cls(features, n_convs=n_convs, winograd=winograd, dtype=jnp.float32)
    v = jax.jit(m.init)(jax.random.key(0), jnp.asarray(x))
    return m, v


@pytest.mark.parametrize("winograd", ["f2", "f4"])
def test_conv_block_matches_jax(winograd):
    x = np.random.default_rng(9).normal(size=(1, 8, 12, 128)).astype(np.float32)
    jm, v = _flax_block(JaxConvBlock, 128, 2, winograd, x)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = ConvBlock(128, 128, 2, winograd=winograd, dtype=torch.float32)
    pm.load_state_dict(convert.to_state_dict(convert.flatten_params(v), pm))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5, "ConvBlock")


@pytest.mark.parametrize("winograd,c,co", [("f2", 128, 128), ("f4x", 256, 512)])
def test_pooled_conv_block_matches_jax(winograd, c, co):
    """Values and the gradients of the input and every parameter (the raw
    form's backward on the last conv). f2 (kernel 6's plain versions, float32
    here): 1e-5 of the scale. f4x rounds V and M to bf16 whatever the dtype,
    and F(4,3)'s transform amplifies one rounding of M to the other
    neighbour into the output, so its bound is the JAX package's own error
    against the direct float32 block on the same inputs: the port within 2x
    of it (plus 1e-5 of the scale)."""
    x = np.random.default_rng(10).normal(size=(1, 8, 8, c)).astype(np.float32)
    jm, v = _flax_block(JaxPooledConvBlock, co, 2, winograd, x)
    jout, (jdx, jdp) = _jax_grads(lambda x_, p_: jm.apply({"params": p_}, x_),
                                  (jnp.asarray(x), v["params"]))
    jdp = convert.flatten_params(jdp)

    def port(flag):
        pm = PooledConvBlock(c, co, 2, winograd=flag, dtype=torch.float32)
        pm.load_state_dict(convert.to_state_dict(convert.flatten_params(v), pm))
        xl = torch.from_numpy(x).requires_grad_()
        out = pm(xl)
        torch.sin(out).sum().backward()
        grads = convert.from_state_dict(
            {k: p.grad for k, p in pm.named_parameters()}, pm)
        return {"y": out.detach().numpy(), "dx": xl.grad.numpy(), **grads}

    got, direct = port(winograd), port(None)
    want = {"y": np.asarray(jout), "dx": np.asarray(jdx), **jdp}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        if winograd.endswith("x"):
            bound = 2 * float(np.abs(w - direct[k]).max()) + 1e-5 * scale
        else:
            bound = 1e-5 * scale
        assert err <= bound, f"{k}: {err:.3g} > {bound:.3g}"


# ---------------------------------------------------------------------------
# checkpoints and the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("fcn8s", dict(winograd="f4", winograd_fc6=True)),
                                     ("segnet", dict(winograd="f2x"))])
def test_flags_are_checkpoint_neutral(name, kw):
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    base = dict(width_mult=0.5, **({"fc_features": 32} if name == "fcn8s" else {}))
    a = init_params(build_model(name, 2, device="cpu", **base),
                    torch.Generator().manual_seed(0)).state_dict()
    b = init_params(build_model(name, 2, device="cpu", **base, **kw),
                    torch.Generator().manual_seed(0)).state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_and_infer_image_clis_with_winograd_f2(tmp_path, monkeypatch, capsys):
    """train.py and infer_image with ``--model-kw ...,winograd=f2`` on the
    CPU, where eligible layers run kernel 6's plain versions."""
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image, train

    calls = {"fwd": 0, "wgrad": 0}
    fwd, wgrad = cw.winograd_fwd_plain, cw.winograd_wgrad_plain

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cw, "winograd_fwd_plain", count("fwd", fwd))
    monkeypatch.setattr(cw, "winograd_wgrad_plain", count("wgrad", wgrad))
    kw = "fc_features=32,width_mult=0.5,winograd=f2"
    ck = tmp_path / "ck"
    assert train.main(["--synthetic", "--epochs", "1", "--device", "cpu",
                       "--model-kw", kw, "--image-size", "64", "96",
                       "--batch-size", "8", "--checkpoint-dir", str(ck)]) == 0
    assert "final:" in capsys.readouterr().out and calls["wgrad"] > 0
    trained = dict(calls)
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (45, 70, 3), np.uint8)).save(src)
    assert infer_image.main(["--model-kw", kw, "--checkpoint-dir", str(ck),
                             "--device", "cpu", "--image", str(src),
                             "--out", str(out)]) == 0
    assert np.asarray(Image.open(out)).shape == (375, 1242, 3)  # the preset's
    assert calls["fwd"] > trained["fwd"]
    assert os.path.exists(ck / "ckpt_1.pt")
