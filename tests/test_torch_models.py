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


@pytest.mark.parametrize("kw", [{"use_bn": True}, {"winograd": "f2"},
                                {"winograd_fc6": True},
                                {"packed_stage2_entry": True},
                                {"pallas_spmd": True}, {"pallas_pool": True},
                                {"deferred_pool_bias": False}])
def test_unported_flags_raise(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model("fcn8s", 2, device="meta", **kw)


@pytest.mark.parametrize("hw", [(375, 1242), (64, 96), (1, 33)])
def test_padded_input_hw_matches_jax(hw):
    port = build_model("fcn8s", 2, device="meta")
    assert padded_input_hw(port, hw) == jax_padded_input_hw(jax_fcn(), hw)
    assert padded_input_hw(port, (375, 1242)) == (384, 1248)


@pytest.mark.parametrize("name", ["unet", "segnet", "deeplab"])
def test_unported_models_raise(name):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model(name, 2, device="meta")
