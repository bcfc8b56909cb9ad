"""int8 quantization, BatchNorm folding and quantization-aware training of
the port (``ops/quant.py``, ``infer/quant.py``) against the JAX package's
``infer/quant.py`` on the CPU, at narrow widths (inputs from numpy seeds,
weights carried across by the port's weight bridge).

Tolerances: the integer product is exact on both sides and the rescale is
the same float32 arithmetic, so ``quantize_kernel``, each quantized conv
(conv and transposed conv, int8 activations) and ``fold_batchnorm`` are
bit-equal. The weight-only form runs a bf16 conv in each framework: within
one bf16 rounding of the output's scale (2^-7). Calibration in float32:
each scale within 1e-5 relative. A whole int8 forward (bf16 between the
layers): logits within 2^-6 of their scale, labels on at least 99 % of
pixels (the models whose every op rounds as the JAX one does are
bit-equal). One QAT step in float32: the loss within 1e-4 relative, the
parameters after an SGD step within rtol 1e-3 / atol 1e-5.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.infer import quant as jq
from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.models.registry import (
    quant_safe_kwargs as jax_quant_safe,
)
from semanticsegmentation_tensorflow_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu.train.step import (
    make_train_step as jax_train_step,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.infer import quant as pq
from semanticsegmentation_tensorflow_tpu_torch.models.common import Conv, init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
    build_model, merge_quant_safe_kwargs, quant_safe_kwargs,
)
from semanticsegmentation_tensorflow_tpu_torch.ops import quant as oq
from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import ConvTranspose
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

from torch_parity import draw_bn_state

MODELS = {
    "fcn8s": dict(fc_features=16, width_mult=0.125),
    "segnet": dict(width_mult=0.125),
    "deeplab": dict(width_mult=0.125, aspp_features=8),
    "deeplab_os16": dict(width_mult=0.125, aspp_features=8, output_stride=16),
    "unet": dict(base_features=8),
}
HW = (64, 96)


def _bits(t) -> np.ndarray:
    """A bf16 array's bits (numpy has no bf16 compare of its own)."""
    a = np.asarray(t.view(torch.int16)) if torch.is_tensor(t) else \
        np.asarray(jax.lax.bitcast_convert_type(t, jnp.int16))
    return a


def _port_quant_model(name, use_bn=False, dtype=torch.bfloat16, seed=0):
    kw = merge_quant_safe_kwargs(name.split("_")[0], dict(MODELS[name], use_bn=use_bn))
    model = build_model(name.split("_")[0], 2, device="cpu", dtype=dtype, **kw)
    init_params(model, torch.Generator().manual_seed(seed))
    if use_bn:
        draw_bn_state(model, seed + 50, params=True)
    with torch.no_grad():      # biases away from their zero init
        rng = np.random.default_rng(seed + 7)
        for n, p in model.named_parameters():
            if n.endswith(".bias") and p.dim() == 1:
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    return model.eval()


def _jax_quant_model(name, use_bn=False, dtype=jnp.bfloat16):
    base = name.split("_")[0]
    return jax_build(base, num_classes=2, dtype=dtype,
                     **dict(MODELS[name], use_bn=use_bn, **jax_quant_safe(base)))


def _variables(model):
    return convert.to_variables(convert.from_state_dict(model.state_dict(), model))


# --- the numerical core -----------------------------------------------------

@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "transposed"])
def test_quantize_kernel_bit_equal(transposed):
    """Per-output-channel int8 and its scale, bit-equal to JAX's on the same
    kernel in each layout, an all-zero channel included (scale 1)."""
    k = (np.random.default_rng(1).normal(size=(3, 3, 16, 12)) * 0.2).astype(np.float32)
    k[..., 5] = 0.0
    k[0, 0, 0, 3] = 0.5 * np.abs(k[..., 3]).max() * 127 / 127  # a half-way case
    jqk, js = jq.quantize_kernel(k)
    w = torch.from_numpy(np.ascontiguousarray(convert.torch_layout(k, transposed)))
    q, s = oq.quantize_kernel(w, transposed)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), convert.torch_layout(np.asarray(jqk),
                                                                  transposed))
    assert s[5].item() == 1.0 and not q.numpy().any(axis=(0, 2, 3) if transposed
                                                    else (1, 2, 3))[5]


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
def test_quantized_paths_equal_jax_conv_paths(name, use_bn):
    """Under the quant-safe flags the port quantizes exactly the convs the
    JAX ``conv_paths`` lists, in its order, the transposed ones included and
    DeepLab's ``project`` (not an ``nn.Conv`` there) left out; after
    :func:`quantize_model` each is a quantized module and nothing else is."""
    base = name.split("_")[0]
    jm = _jax_quant_model(name, use_bn)
    shape = (1, *HW, 3)
    v = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros(shape), train=False))
    want = jq.conv_paths(jm, v, shape)
    port = _port_quant_model(name, use_bn)
    assert pq.conv_paths(port) == want
    assert ("aspp/project" in want) is False
    pq.quantize_model(port)
    got = [pq.flax_path(n) for n, m in port.named_modules()
           if isinstance(m, (oq.QuantConv, oq.QuantConvTranspose))]
    assert sorted(got) == sorted(want) and pq.quantized_count(port) == len(want)
    assert quant_safe_kwargs(base) == jax_quant_safe(base)


class _One(fnn.Module):
    """One flax conv or transposed conv named ``c`` (bf16 compute)."""

    kind: str
    features: int
    k: int
    step: int = 1

    @fnn.compact
    def __call__(self, x, train=False):
        if self.kind == "conv":
            return fnn.Conv(self.features, (self.k, self.k), padding="SAME",
                            kernel_dilation=(self.step, self.step),
                            dtype=jnp.bfloat16, name="c")(x)
        return fnn.ConvTranspose(self.features, (self.k, self.k),
                                 strides=(self.step, self.step), padding="SAME",
                                 dtype=jnp.bfloat16, name="c")(x)


class _Holder(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c = c

    def forward(self, x):
        return self.c(x)


LAYERS = {  # kind, cin, cout, k, dilation or stride, input HxW
    "3x3_d1": ("conv", 8, 16, 3, 1, (10, 14)),
    "3x3_d2": ("conv", 8, 16, 3, 2, (10, 14)),
    "3x3_d4": ("conv", 8, 16, 3, 4, (12, 14)),
    "1x1": ("conv", 16, 8, 1, 1, (6, 10)),
    "7x7": ("conv", 8, 16, 7, 1, (9, 11)),
    "7x7_d2": ("conv", 8, 8, 7, 2, (9, 16)),
    "cin3": ("conv", 3, 8, 3, 1, (10, 14)),
    "cout2": ("conv", 16, 2, 1, 1, (6, 10)),
    "up_fcn_4s2": ("transposed", 2, 2, 4, 2, (5, 7)),
    "up_fcn_16s8": ("transposed", 2, 2, 16, 8, (3, 4)),
    "up_unet_2s2": ("transposed", 16, 8, 2, 2, (5, 7)),
}


def _layer_pair(case, seed=0):
    kind, cin, cout, k, step, hw = LAYERS[case]
    jm = _One(kind, cout, k, step)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, *hw, cin)) * 1.5).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.key(seed), jnp.asarray(x)))
    v["params"]["c"]["bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
    mod = (Conv(cin, cout, k, dilation=step) if kind == "conv"
           else ConvTranspose(cin, cout, step, kernel_size=k, init_std=None))
    port = _Holder(mod)
    port.load_state_dict(convert.to_state_dict(convert.flatten_params(v), port))
    return jm, v, port, x


@pytest.mark.parametrize("case", list(LAYERS))
def test_quantized_conv_bit_equal(case):
    """Each quantized conv (int8 activations at a calibrated scale, int8
    weights): the port's module, built from the float weights, holds the
    int8 weights and scales of JAX's ``quantize_variables`` and its output
    is bit-equal to JAX's ``make_apply`` (``_quantized_conv``) on the same
    input: SAME padding in the int8 domain at dilations 1, 2 and 4, 1x1, 3x3
    and 7x7 kernels, 3 input channels (K = 27, padded), 2 output channels
    (padded), FCN's 4/2 and 16/8 and U-Net's 2/2 transposed convs."""
    jm, v, port, x = _layer_pair(case)
    scales = {"c": float(np.abs(x).max()) / 127.0}   # JAX's calibration of x
    qv = jq.quantize_variables(jm, v, x.shape)
    want = jax.jit(jq.make_apply(jm, scales))(qv, jnp.asarray(x))
    assert pq.calibrate_act_scales(port, [torch.from_numpy(x)]) == scales
    pq.quantize_model(port, scales, sample_shape=x.shape)
    assert isinstance(port.c, (oq.QuantConv, oq.QuantConvTranspose))
    sd = convert.to_state_dict(convert.flatten_params(qv), port)
    for k, t in port.state_dict().items():
        assert t.dtype == sd[k].dtype and torch.equal(t, sd[k]), k
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("case", ["3x3_d2", "7x7", "up_fcn_4s2", "up_unet_2s2"])
def test_weight_only_form_within_bf16(case):
    """Without an activation scale: the dequantized kernel in bf16, a bf16
    conv, the float32 bias, one more rounding; within 2^-7 of the output's
    scale of JAX's (each side's bf16 conv rounds in its own order)."""
    jm, v, port, x = _layer_pair(case, seed=3)
    qv = jq.quantize_variables(jm, v, x.shape)
    want = np.asarray(jax.jit(jq.make_apply(jm, {}))(qv, jnp.asarray(x)), np.float32)
    pq.quantize_model(port, {}, sample_shape=x.shape)
    assert port.c.act_scale is None
    with torch.no_grad():
        got = port(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -7 * np.abs(want).max())


def test_int8_gemm_splits_rows_exactly():
    """A patch matrix split over images and rows (a small budget) sums the
    same int32 values as one GEMM, and both equal a float64 conv of the same
    int8 tensors, with the patches moved byte by byte (5 channels) and as
    8-byte words (16)."""
    rng = np.random.default_rng(4)
    for c in (5, 16):
        xq = torch.from_numpy(rng.integers(-127, 128, (2, 9, 13, c)).astype(np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (6, c, 3, 3)).astype(np.int8))
        whole = oq.int8_conv2d(xq, wq, dilation=2)
        split = oq.int8_conv2d(xq, wq, dilation=2, patch_bytes=13 * 9 * c * 2)
        ref = torch.nn.functional.conv2d(xq.double().permute(0, 3, 1, 2), wq.double(),
                                         padding=2, dilation=2).permute(0, 2, 3, 1)
        assert torch.equal(whole, split) and torch.equal(whole.double(), ref), c


# --- BatchNorm folding and calibration ---------------------------------------

@pytest.mark.parametrize("name", ["segnet", "deeplab", "unet"])
def test_fold_batchnorm_bit_equal(name):
    """``fold_batchnorm`` on the port's state_dict equals JAX's on the same
    variables bit for bit (conv{i}/bn{i} and DeepLab's {name}/{name}_bn,
    the ``project`` conv included), and the folded eval forward equals the
    unfolded one within float32 rounding."""
    port = _port_quant_model(name, use_bn=True, dtype=torch.float32, seed=2)
    v = _variables(port)
    want, jn = jq.fold_batchnorm(v)
    sd, n = pq.fold_batchnorm(port.state_dict(), convert.transposed_weights(port))
    assert n == jn > 0
    if name == "deeplab":
        assert torch.equal(sd["aspp.project_bn.var"],
                           torch.full_like(sd["aspp.project_bn.var"], 1 - 1e-5))
    flat = convert.flatten_params(jax.device_get(want))
    for k, t in convert.from_state_dict(sd, port).items():
        np.testing.assert_array_equal(t, np.asarray(flat[k]), err_msg=k)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 32, 32, 3))
                         .astype(np.float32))
    with torch.no_grad():
        a = port(x)
        port.load_state_dict(sd)
        b = port(x)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=2e-5 * float(a.abs().max()))


@pytest.mark.parametrize("name", ["fcn8s", "deeplab"])
def test_calibration_scales_match_jax(name):
    """Per-conv activation scales (amax over two batches, JAX's margin 1) of
    the float32 model: the same convs as JAX's (its jitted dict comes back
    in key order, the port's in call order), each within 1e-5 relative."""
    port = _port_quant_model(name, dtype=torch.float32, seed=3)
    jm = _jax_quant_model(name, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    batches = [rng.normal(size=(2, *HW, 3)).astype(np.float32) for _ in range(2)]
    want = jq.calibrate_act_scales(jm, _variables(port), batches)
    got = pq.calibrate_act_scales(port, [torch.from_numpy(b) for b in batches])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


# --- whole models -------------------------------------------------------------

@pytest.mark.parametrize("name,use_bn", [("fcn8s", False), ("segnet", True),
                                         ("deeplab", False), ("unet", False)])
def test_int8_forward_matches_jax(name, use_bn):
    """Each family's int8 forward (bf16 between the layers; SegNet with its
    26 BatchNorms folded first) on JAX's scales: the port's quantized
    buffers equal JAX's ``quantize_for_inference`` tree, the logits are
    within 2^-6 of their scale and the labels agree on >= 99 % of pixels
    (measured: SegNet and DeepLab bit-equal, U-Net within 2e-5 and FCN-8s
    within 5.4e-3 of the scale, every label equal)."""
    port = _port_quant_model(name, use_bn, seed=4)
    jm = _jax_quant_model(name, use_bn)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    qv, apply_fn, scales = jq.quantize_for_inference(jm, _variables(port), [x],
                                                     x.shape)
    assert scales
    want = np.asarray(jax.jit(lambda v, x: apply_fn(v, x, train=False))(
        qv, jnp.asarray(x)), np.float32)
    pq.quantize_for_inference(port, None, act_scales=scales)
    flat = convert.flatten_params(jax.device_get(qv))
    for k, t in convert.from_state_dict(port.state_dict(), port).items():
        np.testing.assert_array_equal(t, np.asarray(flat[k]), err_msg=k)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -6 * np.abs(want).max())
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.99, agree


def test_fake_quant_forward_matches_int8_and_qat_step_matches_jax():
    """QAT on U-Net (float32): the fake-quant forward computes the int8
    serving product (JAX's ``test_fake_quant_forward_matches_int8_serving``
    bound), and one SGD step through it from JAX's parameters gives JAX's
    ``make_fake_quant_apply`` step's loss and, leaf by leaf, its step: at
    rate 1 the first SGD step is the gradient itself, and each leaf's step
    ``p_after - p_before`` is held to JAX's at a relative L2 bound of 1e-3.
    The bound is on the step, not on the parameters, so it sees the
    straight-through backward: a fake-quant that stops the weight's
    gradient (a detach of the whole fake-quant) makes every kernel's step
    0, a relative error of 1; a clipped STE, which zeroes the gradient of
    the inputs beyond the grid, moves the upstream leaves by far more than
    1e-3. The parameters stay the same objects."""
    name = "unet"
    port = _port_quant_model(name, dtype=torch.float32, seed=5)
    jm = _jax_quant_model(name, dtype=jnp.float32)
    v = _variables(port)
    rng = np.random.default_rng(7)
    b = {"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
         "label": rng.integers(0, 2, (2, 32, 32)).astype(np.int32),
         "valid": rng.random((2, 32, 32)) > 0.25}
    scales = jq.calibrate_act_scales(jm, v, [b["image"]])
    params = list(port.parameters())
    pq.fake_quantize(port, scales)
    assert [p for p in port.parameters()] == params
    assert sum(getattr(m, "qat", False) for m in port.modules()) == len(scales)
    with torch.no_grad():
        fq = port(torch.from_numpy(b["image"])).numpy()
    served = _port_quant_model(name, dtype=torch.float32, seed=5)
    pq.quantize_model(served, scales)
    with torch.no_grad():
        q8 = served(torch.from_numpy(b["image"])).numpy()
    np.testing.assert_allclose(fq, q8, rtol=2e-5, atol=1e-6)

    tx = jax_optimizer("sgd", 1.0)
    js = jax.jit(lambda v: JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        opt_state=tx.init(v["params"]), batch_stats={},
        rng=jax.random.key(jnp.uint32(0), impl="rbg"),
        apply_fn=jq.make_fake_quant_apply(jm, scales), tx=tx))(v)
    js, jout = jax_train_step(2)(js, {k: jnp.asarray(a) for k, a in b.items()})
    port.train()
    state = create_train_state(port, make_optimizer("sgd", port.parameters(), 1.0),
                               make_lr_schedule(1.0), seed=0)
    out = make_train_step(2)(state, {k: torch.from_numpy(a) for k, a in b.items()})
    np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]), rtol=1e-4)
    before = convert.flatten_params({"params": v["params"]})
    got = convert.from_state_dict(port.state_dict(), port)
    want = convert.flatten_params({"params": js.params})
    assert set(got) == set(want)
    for k in want:
        p0 = np.asarray(before[k], np.float64)
        d_jax = np.asarray(want[k], np.float64) - p0
        d_port = np.asarray(got[k], np.float64) - p0
        assert np.linalg.norm(d_jax) > 0, k
        err = np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)
        assert err <= 1e-3, (k, err)


def test_scales_json_round_trip_between_packages(tmp_path):
    """A scales file written by either package reads back equal in the
    other (``qat_scales.json``)."""
    scales = {"vgg16/stage1/conv0": 0.0123456789, "up2_conv7": 1.5, "head": 1.0}
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    jq.save_act_scales(a, scales)
    pq.save_act_scales(b, scales)
    assert pq.load_act_scales(a) == jq.load_act_scales(b) == scales
    assert open(a).read() == open(b).read()


def test_quant_buffers_stay_f32_under_module_to():
    """``Module.to(bf16, channels_last)`` (the Predictor's inference form)
    keeps the int8 weight int8 and the scales and biases float32."""
    port = pq.quantize_model(_port_quant_model("unet"), {})
    port.to(torch.bfloat16, memory_format=torch.channels_last)
    for m in port.modules():
        if isinstance(m, (oq.QuantConv, oq.QuantConvTranspose)):
            assert m.weight.dtype == torch.int8
            assert m.weight_scale.dtype == m.bias.dtype == torch.float32


def test_qat_warning(tmp_path, capsys):
    """``warn_qat_fp_eval``: only a checkpoint with ``qat_scales.json``, run
    without --int8, warns (the JAX helper's text)."""
    ck = str(tmp_path)
    assert not pq.warn_qat_fp_eval(ck, False)
    pq.save_act_scales(os.path.join(ck, "qat_scales.json"), {"head": 1.0})
    assert not pq.warn_qat_fp_eval(ck, True)
    assert pq.warn_qat_fp_eval(ck, False, verb="running")
    assert "running WITHOUT --int8 removes" in capsys.readouterr().err


def test_qat_checkpoint_through_the_clis(tmp_path, capsys):
    """The JAX CLIs' QAT flow on a narrow FCN-32s and tiny generated data:
    ``train --qat`` (2 steps) calibrates and writes ``qat_scales.json``,
    ``--resume --qat`` reads it back (2 more steps); ``eval`` without
    ``--int8`` warns, ``eval --int8`` and ``test --int8`` take those scales
    (the JAX lines), and every overlay of the sweep equals
    ``host_overlay`` of the labels of a Predictor over the checkpoint
    quantized directly on the same scales."""
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import (
        eval as eval_cli, test as test_cli, train,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import load_weights

    data = generate_synthetic_kitti(str(tmp_path / "kitti"), n_train=4, n_test=2,
                                    h=40, w=64)
    ck = str(tmp_path / "ck")
    sp = os.path.join(ck, "qat_scales.json")
    narrow = ["--model", "fcn32s", "--model-kw", "fc_features=32,width_mult=0.25"]
    argv = ["--data-dir", data, "--device", "cpu", "--image-size", "40", "64",
            "--batch-size", "2", "--epochs", "1", "--checkpoint-dir", ck, "--qat",
            *narrow]
    assert train.main(argv) == 0
    assert f"QAT: calibrated 17 activation scales -> {sp}" in capsys.readouterr().out
    scales = pq.load_act_scales(sp)
    assert train.main(argv + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert f"QAT: 17 activation scales from {sp}" in out and "resumed at step 2" in out
    assert pq.load_act_scales(sp) == scales

    ev = ["--data-dir", data, "--device", "cpu", "--checkpoint-dir", ck, *narrow]
    assert eval_cli.main(ev) == 0
    assert "evaluating WITHOUT --int8" in capsys.readouterr().err
    assert eval_cli.main(ev + ["--int8"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[2:4] == [f"int8: QAT scales from {sp}",
                        "int8: 17 convs quantized, 17 activation scales"]
    runs = str(tmp_path / "runs")
    assert test_cli.main(ev + ["--int8", "--runs-dir", runs]) == 0
    assert f"int8: QAT scales from {sp}" in capsys.readouterr().out

    model = build_model("fcn32s", 2, device="cpu", fc_features=32, width_mult=0.25,
                        **quant_safe_kwargs("fcn32s"))
    model.load_state_dict(load_weights(ck))
    pred = Predictor(pq.quantize_for_inference(model, None, act_scales=scales)[0],
                     (375, 1242), device="cpu")
    (run,) = os.listdir(runs)
    test_dir = os.path.join(data, "testing", "image_2")
    for name in sorted(os.listdir(test_dir)):
        img = load_image(os.path.join(test_dir, name), (375, 1242))
        want = host_overlay(img, pred._fetch_labels(img[None])[0], pred._palette)
        np.testing.assert_array_equal(np.asarray(Image.open(
            os.path.join(runs, run, name))), want)
