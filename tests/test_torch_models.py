"""The port's FCN family, its layers and its weight bridge against the JAX
package, on the CPU in float32 at small widths (width_mult 0.25, fc 32).

Tolerance for whole-model logits: both sides compute in f32 with another
summation order (XLA vs oneDNN), and ~15 layers compound it, so logits
agree to ~1e-6 of their scale; the bound is 1e-4 of the largest logit.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.data.augment import (
    normalize_images as jax_normalize,
)
from semanticsegmentation_tensorflow_tpu.ops.fast_upsample import (
    FastConvTranspose,
)
from semanticsegmentation_tensorflow_tpu.ops.pool import max_pool as jax_max_pool
from semanticsegmentation_tensorflow_tpu.models.registry import (
    padded_input_hw as jax_padded_input_hw,
)
from semanticsegmentation_tensorflow_tpu.ops.shape import (
    crop_to as jax_crop_to, pad_to_multiple as jax_pad,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.data.augment import normalize_images
from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
    build_model, padded_input_hw,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import ConvTranspose
from semanticsegmentation_tensorflow_tpu_torch.ops.pool import max_pool
from semanticsegmentation_tensorflow_tpu_torch.ops.shape import crop_to, pad_to_multiple

from torch_parity import jax_fcn, jax_init, nhwc_input, port_fcn


def _assert_logits_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("canonical", [False, True],
                         ids=["production_flags", "quant_safe"])
@pytest.mark.parametrize("name", ["fcn8s", "fcn16s", "fcn32s"])
def test_fcn_logits_match_jax(name, canonical):
    model = jax_fcn(name, canonical=canonical)
    variables = jax_init(model)
    x = nhwc_input((2, 64, 96, 3), seed=1)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = port_fcn(name, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 96, 2) and got.dtype == np.float32
    _assert_logits_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_stage_forms_agree(dtype):
    """Stage1 (the fused tail) and PooledConvBlock compute the same function
    on the same params, in f32 and in the bf16 compute dtype."""
    ref = port_fcn("fcn8s", dtype=dtype)
    init_params(ref, torch.Generator().manual_seed(0))
    other = port_fcn("fcn8s", dtype=dtype, packed_stage1=False)
    other.load_state_dict(ref.state_dict())
    x = torch.from_numpy(nhwc_input((1, 64, 64, 3), seed=2))
    with torch.no_grad():
        torch.testing.assert_close(other(x), ref(x), rtol=1e-5, atol=1e-6)


def test_weight_bridge_round_trip_is_bit_equal():
    variables = jax_init(jax_fcn("fcn8s"))
    flat = convert.flatten_params(variables)
    model = port_fcn("fcn8s")
    sd = convert.to_state_dict(flat, model)
    assert set(sd) == set(model.state_dict())   # every param filled
    assert len(sd) == len(flat)                  # every leaf used once
    back = convert.from_state_dict(sd, model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    tree = convert.unflatten_params(back)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                 tree, jax.device_get(variables["params"]))


def test_weight_bridge_strict_mode():
    flat = convert.flatten_params(jax_init(jax_fcn("fcn8s")))
    model = port_fcn("fcn8s")
    extra = dict(flat, **{"vgg16/stage9/conv0/kernel": np.zeros((1,))})
    with pytest.raises(KeyError, match="stage9"):
        convert.to_state_dict(extra, model)
    missing = {k: v for k, v in flat.items() if "up8_final" not in k}
    with pytest.raises(KeyError, match="up8_final"):
        convert.to_state_dict(missing, model)
    assert "vgg16.stage1.conv0.weight" in convert.to_state_dict(
        missing, model, strict=False)
    bad = dict(flat, **{"score_pool3/kernel": np.zeros((1, 1, 5, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.to_state_dict(bad, model)


@pytest.mark.parametrize("s", [2, 8, 16])
def test_conv_transpose_matches_flax(s):
    """The decoder's transposed conv against flax nn.ConvTranspose (and the
    JAX package's FastConvTranspose) with the same converted kernel."""
    x = nhwc_input((1, 3, 5, 4), seed=s)
    ref_mod = nn.ConvTranspose(3, (2 * s, 2 * s), strides=(s, s),
                               padding="SAME", dtype=jnp.float32)
    v = ref_mod.init(jax.random.key(s), jnp.asarray(x))
    v = jax.tree.map(lambda a: a + 0.1, v)       # nonzero bias too
    want = np.asarray(ref_mod.apply(v, jnp.asarray(x)))
    fast = np.asarray(FastConvTranspose(3, s, dtype=jnp.float32).apply(
        v, jnp.asarray(x)))
    port = ConvTranspose(4, 3, s, dtype=torch.float32)
    port.weight.data = torch.from_numpy(np.ascontiguousarray(
        np.flip(np.asarray(v["params"]["kernel"]), (0, 1)).transpose(2, 3, 0, 1)))
    port.bias.data = torch.from_numpy(np.array(v["params"]["bias"]))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (1, 3 * s, 5 * s, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, fast, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_input_path_ops_match_jax(hw):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, *hw, 3)).astype(np.uint8)
    mean, std = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)
    x = normalize_images(torch.from_numpy(img), mean, std)
    jx = jax_normalize(jnp.asarray(img), mean, std)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    padded = pad_to_multiple(x, 8)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jax_pad(jx, 8)))
    np.testing.assert_array_equal(crop_to(padded, *hw).numpy(),
                                  np.asarray(jax_crop_to(jax_pad(jx, 8), *hw)))
    np.testing.assert_array_equal(max_pool(x, 2).numpy(),
                                  np.asarray(jax_max_pool(jx, 2)))


def test_init_mirrors_flax_distributions():
    model = build_model("fcn8s", 2, device="cpu", fc_features=256)
    init_params(model, torch.Generator().manual_seed(0))
    w6 = model.vgg16.conv6.weight
    std = (1.0 / w6[0].numel()) ** 0.5          # lecun_normal: 1/fan_in
    assert abs(w6.std().item() / std - 1) < 0.02
    assert w6.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    for name in ("score_pool3", "up8_final"):
        w = getattr(model, name).weight
        assert abs(w.std().item() / 0.01 - 1) < 0.05, name
    assert all(float(b.detach().abs().max()) == 0
               for k, b in model.named_parameters()
               if k.endswith("bias"))
    again = build_model("fcn8s", 2, device="cpu", fc_features=256)
    init_params(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


@pytest.mark.parametrize("kw", [{"use_bn": True}])
def test_unported_flags_raise(kw):
    """``use_bn`` raised as not ported until BatchNorm was; it now builds
    FCN-8s with a BatchNorm after every backbone conv and no fused stage1
    (the JAX package's BN form)."""
    m = build_model("fcn8s", 2, device="meta", **kw)
    bns = [n for n, mod in m.named_modules() if type(mod).__name__ == "BatchNorm"]
    assert len(bns) == 13 and bns[0] == "vgg16.stage1.bn0"
    assert type(m.vgg16.stage1).__name__ == "ConvPoolBlock"


def test_packed_stage2_entry_matches_jax():
    """``packed_stage2_entry=True`` (a TPU layout of conv2_1) builds and
    gives the JAX FCN-8s's logits with the same flag, same weights, within
    2e-4 of their scale (the JAX packed form sums in another order; its own
    test holds it to the unpacked one within 2e-4)."""
    kw = dict(packed_stage2_entry=True, packed_stage1=False)
    model = jax_fcn("fcn8s", **kw)
    variables = jax_init(model, hw=(32, 64))
    x = nhwc_input((1, 32, 64, 3), seed=7)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = port_fcn("fcn8s", variables, **kw)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deferred_pool_bias_off_matches(dtype):
    """``deferred_pool_bias=False`` (each conv's bias and relu before the
    pool) gives the port's default build's logits bit for bit, in f32 and
    bf16, with random biases (zeros would make it trivial); in f32 also the
    JAX model's with the same flag, within the logits bound."""
    kw = dict(deferred_pool_bias=False, packed_stage1=False)
    model = jax_fcn("fcn8s", **kw)
    variables = jax_init(model, hw=(32, 64))
    rng = np.random.default_rng(8)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(0.1 * rng.normal(size=v.shape), v.dtype)
                         if path[-1].key == "bias" else v), variables)
    x = nhwc_input((1, 32, 64, 3), seed=8)
    off = port_fcn("fcn8s", variables, dtype=dtype, **kw)
    ref = port_fcn("fcn8s", variables, dtype=dtype, packed_stage1=False)
    assert type(off.vgg16.stage2).__name__ == "ConvPoolBlock"
    with torch.no_grad():
        got = off(torch.from_numpy(x))
        torch.testing.assert_close(got, ref(torch.from_numpy(x)), rtol=0, atol=0)
    if dtype == torch.float32:
        want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
        _assert_logits_close(got.numpy(), want)


@pytest.mark.parametrize("pallas_pool", [True, False])
def test_pallas_pool_flag_matches_jax(pallas_pool):
    """``pallas_pool`` as the JAX package takes it: True runs the fused
    stage1 tail (in JAX the Pallas kernel, interpret mode here, which needs
    the full stage1 width 64), False the plain pooled stage1; the logits
    equal the JAX model's with the same flag."""
    kw = dict(width_mult=1.0, pallas_pool=pallas_pool)
    model = jax_fcn("fcn8s", **kw)
    variables = jax_init(model, hw=(32, 64))
    x = nhwc_input((1, 32, 64, 3), seed=6)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = port_fcn("fcn8s", variables, **kw)
    assert type(port.vgg16.stage1).__name__ == ("Stage1" if pallas_pool
                                                else "PooledConvBlock")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _assert_logits_close(got, want)


@pytest.mark.parametrize("hw", [(375, 1242), (64, 96), (1, 33)])
def test_padded_input_hw_matches_jax(hw):
    port = build_model("fcn8s", 2, device="meta")
    assert padded_input_hw(port, hw) == jax_padded_input_hw(jax_fcn(), hw)
    assert padded_input_hw(port, (375, 1242)) == (384, 1248)


@pytest.mark.parametrize("name", ["unet"])
def test_unported_models_raise(name):
    """U-Net builds since its slice was ported, and with ``use_bn`` (which
    raised, naming the flag, until BatchNorm was ported) since then."""
    assert build_model(name, 19, device="meta").total_stride == 16
    m = build_model(name, 2, device="meta", use_bn=True)
    assert "down0.bn1.var" in m.state_dict()


# The JAX package's TPU-only flags and the port models that took each as a
# constructor keyword before build_model took them all
JAX_FLAG_MODELS = {
    "pallas_spmd": ("fcn8s", "segnet", "deeplab"),
    "packed_stage2_entry": ("fcn8s",),
    "fast_upsample": ("fcn8s",),
    "packed_dec1": ("segnet",),
    "packed_dec2": ("segnet",),
    "fast_upconv": ("unet",),
    "packed_stage0": ("unet",),
    "pallas_pool": ("fcn8s", "segnet", "deeplab"),
}
_STAGE1 = {"fcn8s": "vgg16.stage1", "deeplab": "vgg16.stage1", "segnet": "enc1",
           "unet": "down0"}


@pytest.mark.parametrize("flag,model,value", [
    (flag, model, value) for flag, models in JAX_FLAG_MODELS.items()
    for model in models
    for value in (True, False, *(("mixed",) if flag == "packed_stage0" else ()))])
def test_build_model_takes_the_jax_flags(flag, model, value):
    """``build_model`` accepts each JAX flag the port decides for itself
    (``registry.TPU_ONLY_KWARGS``) and ``pallas_pool``: the same state_dict
    keys and shapes as without it, and the same stage1, except that
    ``pallas_pool=False`` turns the fused stage1 off (the plain
    ``PooledConvBlock``, or SegNet's ``ConvBlock``)."""
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
        TPU_ONLY_KWARGS,
    )

    assert TPU_ONLY_KWARGS == set(JAX_FLAG_MODELS) - {"pallas_pool"}
    base = build_model(model, 2, device="meta")
    got = build_model(model, 2, device="meta", **{flag: value})
    shapes = {k: v.shape for k, v in base.state_dict().items()}
    assert {k: v.shape for k, v in got.state_dict().items()} == shapes
    stage1 = type(got.get_submodule(_STAGE1[model])).__name__
    if flag == "pallas_pool" and value is False:
        assert stage1 == ("ConvBlock" if model == "segnet" else "PooledConvBlock")
    else:
        assert stage1 == type(base.get_submodule(_STAGE1[model])).__name__


def test_ops_import_nothing_of_models():
    """Imports point one way, ``models -> ops``: no module under ``ops/``
    (``ops/cuda`` included) imports the port's ``models``, at module level
    or inside a function."""
    import ast
    import pathlib

    import semanticsegmentation_tensorflow_tpu_torch as port

    pkg = port.__name__
    root = pathlib.Path(port.__file__).parent / "ops"
    files = sorted(root.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            bad = [n for n in names if n.startswith(f"{pkg}.models")]
            assert not bad, f"{path.relative_to(root.parent)}:{node.lineno} imports {bad}"
