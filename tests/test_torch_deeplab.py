"""The port's DeepLab-ASPP against the JAX package, on the CPU in float32 at
small widths (width_mult 0.125, ASPP 16 features, rates (2, 4), 64x96
inputs; the same weights carried across by the port's weight bridge):

* the dilated VGG16's endpoints at output stride 8 and 16;
* ``upsample_bilinear`` against ``jax.image.resize`` and the image-level
  mean against ``jnp.mean`` (f32 and bf16);
* ASPP with the concat and the split projection;
* the whole model's logits at both strides, with the production flags, the
  split projection and the JAX ``quant_safe_kwargs``;
* the weight bridge (strict, bit-equal) and the checkpoint converter at
  ``deeplab_kitti_dp``;
* one train step (loss, confusion matrix, every gradient, the params after
  Adam), also with ``remat``; the Predictor's labels; Winograd routing; a
  bf16 forward; the flags that raise; the train CLI's ``--spatial`` check.

Tolerance for logits: 1e-4 of the largest logit (f32 on both sides, another
summation order), as for FCN (tests/test_torch_models.py).
"""

import collections
import functools
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semanticsegmentation_tensorflow_tpu.infer.predict import (
    Predictor as JaxPredictor,
)
from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.models.common import (
    upsample_bilinear as jax_upsample,
)
from semanticsegmentation_tensorflow_tpu.models.deeplab import ASPP as JaxASPP
from semanticsegmentation_tensorflow_tpu.models.registry import quant_safe_kwargs
from semanticsegmentation_tensorflow_tpu.models.vgg16 import VGG16 as JaxVGG16
from semanticsegmentation_tensorflow_tpu.train import loss as jax_loss
from semanticsegmentation_tensorflow_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu.train.step import (
    make_train_step as jax_train_step,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
from semanticsegmentation_tensorflow_tpu_torch.models.common import upsample_bilinear
from semanticsegmentation_tensorflow_tpu_torch.models.deeplab import ASPP, image_mean
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import VGG16
from semanticsegmentation_tensorflow_tpu_torch.ops.conv import (
    conv_by_phases, dilated_form,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

from torch_parity import decided, jax_init, nhwc_input

DL = dict(width_mult=0.125, aspp_features=16, rates=(2, 4))
HW = (64, 96)


def _assert_logits_close(got, want):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def _jax_deeplab(os_, **kw):
    return jax_build("deeplab", num_classes=2, dtype=kw.pop("dtype", jnp.float32),
                     output_stride=os_, **dict(DL, **kw))


@functools.lru_cache(maxsize=None)
def _variables(os_):
    """One set of weights per stride (every flag keeps the param tree)."""
    return jax_init(_jax_deeplab(os_), hw=HW, seed=os_)


def _port(os_, variables=None, dtype=torch.float32, **kw):
    model = build_model("deeplab", 2, device="cpu", dtype=dtype,
                        output_stride=os_, **dict(DL, **kw))
    if variables is not None:
        model.load_state_dict(convert.to_state_dict(
            convert.flatten_params(variables), model), strict=True)
    return model.eval()


@pytest.mark.parametrize("os_", [8, 16])
def test_dilated_vgg16_endpoints_match_jax(os_):
    """Every endpoint's shape and values (stage 4 at dilation 1 and stage 5 at
    2 for os8; stage 5 at 1 for os16; fc6 at the final dilation)."""
    dilate_from = {8: 4, 16: 5}[os_]
    kw = dict(width_mult=0.125, fc_features=16, dilated_last_stages=True,
              dilate_from=dilate_from, dropout_rate=0.0)
    jm = JaxVGG16(dtype=jnp.float32, packed_stage1=True, **kw)
    x = nhwc_input((1, *HW, 3), seed=2)
    variables = jax.jit(lambda k: jm.init(k, jnp.asarray(x)))(jax.random.key(1))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    pm = VGG16(dtype=torch.float32, device="cpu", **kw)
    pm.load_state_dict(convert.to_state_dict(convert.flatten_params(variables), pm))
    assert [pm.stage4.conv0.dilation, pm.stage5.conv0.dilation,
            pm.conv6.dilation] == ([1, 2, 4] if os_ == 8 else [1, 1, 2])
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1e-12),
                                   err_msg=k)
    assert got["conv7"].shape[1:3] == (HW[0] // os_, HW[1] // os_)


@pytest.mark.parametrize("hw,k,d,pad_h,pad_w", [
    ((10, 13), 7, 4, 12, 12), ((8, 12), 3, 18, 18, 18), ((9, 7), 3, 2, 2, 2),
    ((5, 6), 7, 2, 6, 6), ((14, 9), 3, 4, 0, 4)])
def test_conv_by_phases_equals_the_dilated_conv(hw, k, d, pad_h, pad_w):
    """The dilated conv as d x d undilated convs over the output's phases
    (ragged sizes, halos taller than the image, the zero row padding of a
    conv whose rows came from a halo exchange): the same output and
    gradients as F.conv2d at that dilation, in float64 to 1e-12."""
    g = torch.Generator().manual_seed(k * d)
    x = torch.randn(2, *hw, 5, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 5, k, k, generator=g, dtype=torch.float64, requires_grad=True)
    want = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(pad_h, pad_w),
                    dilation=d).permute(0, 2, 3, 1)
    got = conv_by_phases(x, w, pad_h, pad_w, d)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    cot = torch.randn(want.shape, generator=g, dtype=torch.float64)
    for a, b in zip(torch.autograd.grad(got, [x, w], cot),
                    torch.autograd.grad(want, [x, w], cot)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-11)


PASSES = ("forward", "input_grad", "weight_grad")


@pytest.mark.parametrize("forms", list(itertools.product(("direct", "phases"),
                                                         repeat=3)),
                         ids="-".join)
@pytest.mark.parametrize("hw,k,d,pad_h,pad_w", [
    ((10, 13), 7, 4, 12, 12), ((8, 12), 3, 18, 18, 18), ((9, 7), 3, 2, 2, 2),
    ((40, 7), 3, 24, 24, 24), ((14, 9), 3, 4, 0, 4)])
def test_dilated_conv_equals_the_dilated_conv_in_every_form(monkeypatch, hw, k, d,
                                                           pad_h, pad_w, forms):
    """DilatedConv with each pass forced to either form (ragged sizes, a
    window taller than the map: rate 24 on 40 rows, the zero row padding of
    rows from a halo exchange): the output and each subset of the gradients
    asked for equal F.conv2d's at that dilation, in float64 to 1e-12 and
    1e-11; the gradients not asked for are not computed."""
    from semanticsegmentation_tensorflow_tpu_torch.ops import conv

    monkeypatch.setattr(conv, "dilated_form",
                        lambda pass_, *a: forms[PASSES.index(pass_)])
    g = torch.Generator().manual_seed(k * d)
    x0 = torch.randn(2, *hw, 5, generator=g, dtype=torch.float64)
    w0 = torch.randn(4, 5, k, k, generator=g, dtype=torch.float64)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    want = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(pad_h, pad_w),
                    dilation=d).permute(0, 2, 3, 1)
    cot = torch.randn(want.shape, generator=g, dtype=torch.float64)
    grads = torch.autograd.grad(want, [x, w], cot)
    for asked in ((True, True), (True, False), (False, True)):
        x, w = (t.clone().requires_grad_(a) for t, a in zip((x0, w0), asked))
        before = conv.DILATED_PASSES.copy()
        got = conv.DilatedConv.apply(x, w, hw[0], pad_h, pad_w, d)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want.detach(), rtol=0, atol=1e-12)
        leaves = [t for t, a in zip((x, w), asked) if a]
        for a, b in zip(torch.autograd.grad(got, leaves, cot),
                        [t for t, a in zip(grads, asked) if a]):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=0, atol=1e-11)
        ran = conv.DILATED_PASSES - before
        assert ran == collections.Counter(
            {(p, f): 1 for p, f, a in zip(PASSES, forms, (True, *asked)) if a})


# (pass, batch, input rows, Cout, kernel, dilation, the form): DeepLab's and
# DeepLab-v2's dilated convs at KITTI's inference sizes (47 rows at os8, 24
# at os16) and training crops (40, 20), where tools/dilated_convs.py timed
# each pass in both forms on an H100
RULE_TABLE = [
    ("forward", 1, 47, 512, 7, 4, "phases"), ("forward", 3, 47, 512, 7, 4, "phases"),
    ("forward", 4, 47, 512, 7, 4, "direct"), ("forward", 1, 24, 512, 7, 2, "phases"),
    ("forward", 3, 24, 512, 7, 2, "phases"), ("forward", 16, 24, 512, 7, 2, "direct"),
    ("forward", 4, 40, 512, 7, 4, "phases"), ("input_grad", 4, 40, 512, 7, 4, "phases"),
    ("weight_grad", 4, 40, 512, 7, 4, "phases"), ("forward", 16, 40, 512, 7, 4, "direct"),
    ("input_grad", 16, 40, 512, 7, 4, "direct"),
    ("weight_grad", 16, 40, 512, 7, 4, "direct"), ("forward", 4, 20, 512, 7, 2, "phases"),
    ("input_grad", 4, 20, 512, 7, 2, "phases"), ("weight_grad", 4, 20, 512, 7, 2, "phases"),
    ("forward", 16, 20, 512, 7, 2, "direct"), ("input_grad", 16, 20, 512, 7, 2, "phases"),
    ("weight_grad", 16, 20, 512, 7, 2, "direct"), ("forward", 1, 47, 512, 3, 2, "direct"),
    ("forward", 1, 47, 256, 3, 6, "direct"), ("forward", 1, 47, 256, 3, 12, "phases"),
    ("forward", 2, 47, 256, 3, 12, "direct"), ("forward", 1, 47, 256, 3, 18, "phases"),
    ("forward", 2, 47, 256, 3, 18, "direct"), ("forward", 1, 24, 256, 3, 18, "direct"),
    ("forward", 1, 40, 256, 3, 12, "phases"), ("input_grad", 1, 40, 256, 3, 12, "direct"),
    ("weight_grad", 1, 40, 256, 3, 12, "direct"), ("forward", 2, 40, 256, 3, 18, "direct"),
    ("input_grad", 2, 40, 256, 3, 18, "direct"),
    ("weight_grad", 2, 40, 256, 3, 18, "direct"), ("forward", 1, 20, 256, 3, 18, "direct"),
    ("input_grad", 1, 20, 256, 3, 18, "direct"),
    ("weight_grad", 1, 20, 256, 3, 18, "direct"), ("forward", 1, 47, 512, 7, 1, "direct"),
    # DeepLab-v2 ASPP-L's fc6 branches, 512 -> 1024, at its training batch
    # and at a frame
    ("forward", 10, 40, 1024, 3, 6, "direct"), ("input_grad", 10, 40, 1024, 3, 6, "direct"),
    ("weight_grad", 10, 40, 1024, 3, 6, "direct"),
    ("forward", 10, 40, 1024, 3, 12, "phases"),
    ("input_grad", 10, 40, 1024, 3, 12, "direct"),
    ("weight_grad", 10, 40, 1024, 3, 12, "phases"),
    ("forward", 10, 40, 1024, 3, 18, "phases"),
    ("input_grad", 10, 40, 1024, 3, 18, "direct"),
    ("weight_grad", 10, 40, 1024, 3, 18, "phases"),
    ("forward", 10, 40, 1024, 3, 24, "phases"),
    ("input_grad", 10, 40, 1024, 3, 24, "direct"),
    ("weight_grad", 10, 40, 1024, 3, 24, "phases"),
    ("forward", 1, 47, 1024, 3, 24, "phases"), ("forward", 1, 47, 1024, 3, 6, "direct"),
    # cuDNN's fast islands inside the slow ranges
    ("weight_grad", 12, 40, 1024, 3, 12, "direct"),
    ("weight_grad", 10, 47, 1024, 3, 18, "direct"),
    ("forward", 3, 20, 256, 3, 12, "phases"), ("input_grad", 8, 24, 512, 7, 2, "phases"),
    ("input_grad", 10, 24, 512, 7, 2, "direct"),
    ("input_grad", 1, 24, 256, 3, 12, "phases")]


@pytest.mark.parametrize("pass_,batch,rows,cout,k,d,form", RULE_TABLE)
def test_by_phases_picks_the_form_measured_far_faster(pass_, batch, rows, cout, k,
                                                      d, form):
    """Each pass of a dilated conv by phases where cuDNN's dilated conv was
    measured far slower, direct where it was the faster one or near."""
    assert dilated_form(pass_, batch, rows, (cout, 512, k, k), d) == form


# (pass, batch, input rows, OIHW kernel, dilation, the form of dilated_form's
# general cases; the timed shape beside it as (kernel, dilation, the form the
# table gives it)): rows, a Cin or a dilation the tool did not time there
C6, FC6 = (512, 512, 7, 7), (1024, 512, 3, 3)
UNMEASURED = [
    # conv6 of output stride 8 (d4) on os16's 20 and 24 rows, as a rank of
    # deeplab_kitti_dp under --spatial 2 convolves it: not os16's d2 fit
    ("input_grad", 16, 20, C6, 4, "direct", (C6, 2, "phases")),
    ("input_grad", 6, 20, C6, 4, "direct", (C6, 2, "phases")),
    ("weight_grad", 3, 20, C6, 4, "phases", (C6, 2, "direct")),
    ("forward", 8, 20, C6, 4, "phases", (C6, 2, "direct")),
    ("input_grad", 12, 24, C6, 4, "direct", (C6, 2, "phases")),
    # an ASPP-L branch at a rate the tool did not time, and on 256 inputs
    ("weight_grad", 12, 40, FC6, 30, "phases", (FC6, 12, "direct")),
    ("weight_grad", 12, 40, (1024, 256, 3, 3), 12, "phases", (FC6, 12, "direct"))]


@pytest.mark.parametrize("pass_,batch,rows,kernel_shape,d,form,timed", UNMEASURED)
def test_a_shape_the_table_did_not_time_takes_the_general_cases(
        pass_, batch, rows, kernel_shape, d, form, timed):
    """The table's batches hold for the (rows, Cin, Cout, kernel, dilation)
    they were timed at alone; any other shape takes the general cases."""
    assert dilated_form(pass_, batch, rows, kernel_shape, d) == form
    assert dilated_form(pass_, batch, rows, timed[0], timed[1]) == timed[2]


def test_conv_nhwc_routes_by_the_backward(monkeypatch):
    """conv_nhwc runs a dilated conv through DilatedConv only where a
    backward follows, with the same values as the plain forward without;
    DILATED_PASSES counts each pass in the form dilated_form picked for
    it."""
    from semanticsegmentation_tensorflow_tpu_torch.ops import conv

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 9, 11, 3, generator=g, dtype=torch.float64)
    w = torch.randn(2, 3, 7, 7, generator=g, dtype=torch.float64, requires_grad=True)
    applied, picked = [], []
    monkeypatch.setattr(conv.DilatedConv, "apply", functools.partial(
        lambda apply, *a: applied.append(True) or apply(*a),
        conv.DilatedConv.apply))
    rule = conv.dilated_form
    monkeypatch.setattr(conv, "dilated_form",
                        lambda *a: picked.append((a[0], rule(*a))) or rule(*a))
    before = conv.DILATED_PASSES.copy()
    with torch.no_grad():
        want = conv.conv_nhwc(x, w, dtype=torch.float64, padding=6, dilation=2)
    assert not applied and [p for p, _ in picked] == ["forward"]
    got = conv.conv_nhwc(x, w, dtype=torch.float64, padding=6, dilation=2)
    got.sum().backward()
    assert applied == [True]
    assert [p for p, _ in picked] == ["forward", "forward", "weight_grad"]
    assert conv.DILATED_PASSES - before == collections.Counter(picked)
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=1e-12)


def test_dilation_one_reaches_neither_the_rule_nor_the_function(monkeypatch):
    """At dilation 1 conv_nhwc is the bare F.conv2d, with a backward or
    without: it calls neither dilated_form nor DilatedConv, and counts
    nothing."""
    from semanticsegmentation_tensorflow_tpu_torch.ops import conv

    def refuse(*a):
        raise AssertionError("reached at dilation 1")

    monkeypatch.setattr(conv, "dilated_form", refuse)
    monkeypatch.setattr(conv.DilatedConv, "apply", refuse)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 6, 7, 3, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(2, 3, 3, 3, generator=g, dtype=torch.float64, requires_grad=True)
    before = conv.DILATED_PASSES.copy()
    got = conv.conv_nhwc(x, w, dtype=torch.float64, padding=1)
    got.sum().backward()
    with torch.no_grad():
        conv.conv_nhwc(x, w, dtype=torch.float64, padding=1)
    assert conv.DILATED_PASSES == before
    want = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("factor", [8, 16])
def test_upsample_bilinear_matches_jax_resize(factor):
    x = nhwc_input((2, 5, 7, 3), seed=3)
    want = np.asarray(jax_upsample(jnp.asarray(x), factor))
    got = upsample_bilinear(torch.from_numpy(x), factor).numpy()
    assert got.shape == want.shape == (2, 5 * factor, 7 * factor, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_image_mean_matches_jnp_mean(dtype):
    """f32: within 1e-6 relative (another summation order). bf16: the sum in
    f32 and one rounding, as ``jnp.mean``: within one bf16 ulp (2^-8 of the
    value), and the dtype kept."""
    x = nhwc_input((2, 9, 13, 16), seed=4) + 0.5
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jnp.mean(jx, axis=(1, 2), keepdims=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = image_mean(tx)
    assert got.dtype == tx.dtype and got.shape == (2, 1, 1, 16)
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rel, atol=0)


@pytest.mark.parametrize("split", [False, True], ids=["concat", "split"])
def test_aspp_matches_jax(split):
    kw = dict(features=32, rates=(2, 4))
    x = nhwc_input((2, 8, 12, 16), seed=5)
    jm = JaxASPP(use_bn=False, split_proj=split, dtype=jnp.float32, **kw)
    variables = jax.jit(lambda k: jm.init(k, jnp.asarray(x)))(jax.random.key(2))
    rng = np.random.default_rng(6)       # nonzero biases
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(0.1 * rng.normal(size=v.shape), v.dtype)
                         if path[-1].key == "bias" else v), variables)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    pm = ASPP(16, split_proj=split, dtype=torch.float32, device="cpu", **kw)
    assert pm.project.weight.shape == (32, 32 * 4, 1, 1)
    pm.load_state_dict(convert.to_state_dict(convert.flatten_params(variables), pm))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("flags", ["production", "split_proj", "quant_safe"])
@pytest.mark.parametrize("os_", [8, 16])
def test_deeplab_logits_match_jax(os_, flags):
    kw = {"production": {}, "split_proj": {"aspp_split_proj": True},
          "quant_safe": quant_safe_kwargs("deeplab")}[flags]
    jm = _jax_deeplab(os_, **kw)
    variables = _variables(os_)
    x = nhwc_input((2, *HW, 3), seed=1)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    port = _port(os_, variables, **kw)
    assert port.total_stride == os_
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *HW, 2) and got.dtype == np.float32
    _assert_logits_close(got, want)


def test_weight_bridge_round_trip_is_strict_and_bit_equal():
    flat = convert.flatten_params(_variables(8))
    model = _port(8)
    sd = convert.to_state_dict(flat, model)
    assert set(sd) == set(model.state_dict())
    assert {k.split(".")[0] for k in sd} == {"vgg16", "aspp", "head"}
    assert {k for k in flat if k.startswith("aspp/")} == {
        f"aspp/{b}/{leaf}" for b in ("b0", "b_rate2", "b_rate4", "b_image",
                                     "project") for leaf in ("kernel", "bias")}
    back = convert.from_state_dict(sd, model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    extra = dict(flat, **{"aspp/b_rate6/bias": np.zeros(16, np.float32)})
    with pytest.raises(KeyError, match="b_rate6"):
        convert.to_state_dict(extra, model)
    missing = {k: v for k, v in flat.items() if not k.startswith("head/")}
    with pytest.raises(KeyError, match="head"):
        convert.to_state_dict(missing, model)


def test_checkpoint_converter_at_the_deeplab_preset(tmp_path):
    """tools/convert_checkpoint_to_torch.py --preset deeplab_kitti_dp: the
    JAX checkpoint's params land strictly and bit-equal in the port."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import convert_checkpoint_to_torch

    from semanticsegmentation_tensorflow_tpu.train.checkpoint import (
        CheckpointManager,
    )
    from semanticsegmentation_tensorflow_tpu.train.state import create_train_state

    model = jax_build("deeplab", num_classes=2, width_mult=0.125, aspp_features=16)
    state = jax.jit(lambda k: create_train_state(
        model, k, (1, *HW, 3), jax_optimizer("adam", 1e-4)))(jax.random.key(4))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, wait=True)
    mgr.close()
    out = tmp_path / "w.pt"
    assert convert_checkpoint_to_torch.main(
        ["--preset", "deeplab_kitti_dp", "--checkpoint-dir", str(tmp_path / "ckpt"),
         "--model-kw", "width_mult=0.125,aspp_features=16", "--out", str(out)]) == 0
    sd = torch.load(out, weights_only=True)
    port = build_model("deeplab", 2, device="cpu", width_mult=0.125, aspp_features=16)
    port.load_state_dict(sd, strict=True)
    got = convert.from_state_dict(sd, port)
    for k, v in convert.flatten_params(state.params).items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, *HW, 3)).astype(np.float32),
            "label": rng.integers(0, 2, (n, *HW)).astype(np.int32),
            "valid": rng.random((n, *HW)) > 0.25}


@functools.lru_cache(maxsize=None)
def _jax_step(os_):
    """The JAX side of one Adam step (lr 1e-3, dropout 0) at ``os_``: the
    loss and gradients by jax.grad, then the JAX train step's loss, cm and
    params."""
    jm = _jax_deeplab(os_, dropout_rate=0.0)
    variables = _variables(os_)
    batch = {k: jnp.asarray(v) for k, v in _batch(os_).items()}

    def jloss(params):
        logits = jm.apply({"params": params}, batch["image"], train=False)
        ce, n = jax_loss.softmax_cross_entropy_sum(
            logits, jax.nn.one_hot(batch["label"], 2), batch["valid"], None)
        return ce / jnp.maximum(n, 1.0)

    _, grads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    tx = jax_optimizer("adam", 1e-3)
    params = jax.tree.map(jnp.copy, variables["params"])   # the step donates it
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), batch_stats={},
                       rng=jax.random.key(0), apply_fn=jm.apply, tx=tx)
    js, out = jax_train_step(2)(js, batch)
    return (float(out["loss"]), np.asarray(out["cm"]),
            convert.flatten_params(grads), convert.flatten_params(js.params))


@pytest.mark.parametrize("os_,remat", [(8, False), (8, True), (16, False)])
def test_train_step_matches_jax(os_, remat):
    """One Adam step (lr 1e-3, dropout 0, f32) from the same weights on the
    same batch against the JAX package's ``make_train_step``: the loss (rtol
    1e-5), the confusion matrix (exact), every gradient (within 1e-4 of the
    leaf's largest, against jax.grad of the step's loss) and every parameter
    after the update (atol 2e-6, the FCN train test's bound). ``remat``
    recomputes the forward in the backward: the same numbers."""
    loss, cm, jgrads, jparams = _jax_step(os_)
    model = _port(os_, _variables(os_), dropout_rate=0.0).train()
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                               make_lr_schedule(1e-3), seed=0)
    out = make_train_step(2, remat=remat)(
        state, {k: torch.from_numpy(v) for k, v in _batch(os_).items()})
    np.testing.assert_allclose(out["loss"].item(), loss, rtol=1e-5)
    np.testing.assert_array_equal(out["cm"].numpy(), cm)
    grads = convert.from_state_dict({k: p.grad for k, p in model.named_parameters()},
                                    model)
    assert set(grads) == set(jgrads)
    for k, w in jgrads.items():
        np.testing.assert_allclose(grads[k], w, rtol=0,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-12),
                                   err_msg=k)
    got = convert.from_state_dict(model.state_dict(), model)
    for k, w in jparams.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("os_", [8, 16])
def test_predictor_labels_match_jax(os_):
    """The Predictor pads a 47x90 image to 48x96 at both strides (8 divides
    48; os16 pads to 48 as well) and crops back: labels equal the JAX
    Predictor's on every decided pixel, overlays where the labels agree."""
    hw = (47, 90)
    images = np.random.default_rng(7).integers(0, 256, (2, *hw, 3), np.uint8)
    jax_pred = JaxPredictor(_jax_deeplab(os_), _variables(os_), hw)
    port_pred = Predictor(_port(os_, _variables(os_)), hw, device="cpu")
    ov, lab = port_pred(images)
    j_ov, j_lab = jax_pred(images)
    assert ov.shape == j_ov.shape == (2, *hw, 3) and lab.shape == (2, *hw)
    ok = decided(jax_pred, images)
    np.testing.assert_array_equal(lab[ok], j_lab[ok])
    same = lab == j_lab
    np.testing.assert_array_equal(ov[same], j_ov[same])


@pytest.mark.parametrize("os_", [8, 16])
def test_winograd_routing_matches_jax(os_, monkeypatch):
    """``winograd="f2"`` at width 0.5 on 32x64: the port runs kernel 6's
    plain version on exactly the layers where the JAX model runs its Pallas
    kernel (the undilated eligible 3x3 convs: stages 3 and 4, stage 4
    unpooled, at os8; stages 3-5, stage 5 unpooled, at os16), and the logits
    agree within 1e-5 of their scale."""
    from semanticsegmentation_tensorflow_tpu.ops.pallas import winograd as jpw

    hw = (32, 64)
    kw = dict(width_mult=0.5, aspp_features=16, rates=(2, 4), winograd="f2",
              output_stride=os_)
    jm = jax_build("deeplab", num_classes=2, dtype=jnp.float32, **kw)
    variables = jax_init(jm, hw=hw)
    x = nhwc_input((1, *hw, 3), seed=8)
    seen = []
    orig = (jpw.winograd_conv_bias_relu, jpw.winograd_conv3x3)
    monkeypatch.setattr(jpw, "winograd_conv_bias_relu", lambda x_, w_, b_, v, i: (
        seen.append((tuple(x_.shape), w_.shape[-1], v, "bias_relu"))
        or orig[0](x_, w_, b_, v, i)))
    monkeypatch.setattr(jpw, "winograd_conv3x3", lambda x_, w_, v, i: (
        seen.append((tuple(x_.shape), w_.shape[-1], v, "none"))
        or orig[1](x_, w_, v, i)))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    routed = []
    fwd = cw.winograd_fwd_plain
    monkeypatch.setattr(cw, "winograd_fwd_plain", lambda x_, u, b, o, v, e: (
        routed.append((tuple(x_.shape), u.shape[-1], v, e)) or fwd(x_, u, b, o, v, e)))
    pm = build_model("deeplab", 2, device="cpu", dtype=torch.float32, **kw)
    pm.load_state_dict(convert.to_state_dict(convert.flatten_params(variables), pm))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    assert routed == seen
    # stage 3's last two convs (its first takes 64 channels), stage 4's three
    # (os8: unpooled, all with bias and relu), at os16 stage 5's three too
    assert len(routed) == (5 if os_ == 8 else 8)
    assert [e for *_, e in routed[2:5]] == ["bias_relu"] * 2 + [
        "bias_relu" if os_ == 8 else "none"]
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("os_", [8, 16])
def test_bf16_forward_spread(os_):
    """The port's bf16 logits sit no further from its f32 logits than the
    JAX package's bf16 model from its own f32 logits (same weights and
    input), within 1.5x plus 1e-3 relative L2; both under 5 %."""
    variables = _variables(os_)
    x = nhwc_input((1, *HW, 3), seed=9)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    with torch.no_grad():
        p32 = _port(os_, variables)(torch.from_numpy(x)).numpy()
        p16 = _port(os_, variables, dtype=torch.bfloat16)(torch.from_numpy(x)).numpy()
    j32 = np.asarray(jax.jit(_jax_deeplab(os_).apply)(variables, jnp.asarray(x)))
    j16 = np.asarray(jax.jit(_jax_deeplab(os_, dtype=jnp.bfloat16).apply)(
        variables, jnp.asarray(x)))
    assert p16.dtype == np.float32
    port_rel, jax_rel = rel(p16, p32), rel(j16, j32)
    assert port_rel <= 1.5 * jax_rel + 1e-3 and max(port_rel, jax_rel) < 0.05, \
        (port_rel, jax_rel)


@pytest.mark.parametrize("kw,err", [({"use_bn": True}, NotImplementedError),
                                    ({"output_stride": 32}, ValueError),
                                    ({"output_stride": 4}, ValueError)])
def test_unported_and_bad_flags_raise(kw, err):
    """A bad ``output_stride`` raises naming it. ``use_bn``, which raised
    (naming itself) until BatchNorm was ported, now builds: BN in the
    backbone's stages and the ASPP head (``b0_bn``, ``b_rate{r}_bn``,
    ``b_image_bn``, ``project_bn``), the image branch's counting each image
    once on a grid that splits rows."""
    if kw.get("use_bn"):
        m = build_model("deeplab", 2, device="meta", **kw)
        names = {n for n, _ in m.named_modules()}
        assert {"vgg16.stage1.bn0", "aspp.b0_bn", "aspp.b_rate6_bn",
                "aspp.b_image_bn", "aspp.project_bn"} <= names
        assert m.aspp.b_image_bn.whole_image and not m.aspp.b0_bn.whole_image
        return
    with pytest.raises(err, match="output_stride"):
        build_model("deeplab", 2, device="meta", **kw)


def test_train_cli_spatial_checks_rows_at_the_models_stride(monkeypatch):
    """``--spatial`` checks the padded height against DeepLab's own total
    stride before any work, and accepts any height with at least one
    stride block a rank: at os8 KITTI's 375 rows pad to 376, 47 blocks of 8,
    which split over two ranks 24 + 23 (as the JAX partitioner shards it);
    os16's 384 rows are 24 blocks. A height with fewer blocks than ranks is
    refused, naming the rows: 64 rows at os16 over 5 ranks, and FCN's 64
    rows (two blocks of 32) over 3."""
    from semanticsegmentation_tensorflow_tpu_torch.data import synthetic
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train

    monkeypatch.setattr(synthetic, "generate_synthetic_kitti",
                        lambda *a, **k: pytest.fail("work began"))
    for preset in ("deeplab_kitti_dp", "deeplab_kitti_os16"):
        with pytest.raises(pytest.fail.Exception, match="work began"):
            train.main(["--preset", preset, "--synthetic", "--device", "cpu",
                        "--spatial", "2"])
    with pytest.raises(ValueError, match="height 64 must divide by the model's "
                                         "stride 16 into at least 5 blocks"):
        train.main(["--preset", "deeplab_kitti_os16", "--synthetic", "--device",
                    "cpu", "--spatial", "5", "--image-size", "64", "96"])
    with pytest.raises(ValueError, match="stride 32 into at least 3 blocks"):
        train.main(["--synthetic", "--device", "cpu", "--spatial", "3",
                    "--image-size", "64", "96"])


def test_clis_train_eval_sweep_and_serve_a_deeplab_checkpoint(tmp_path, capsys):
    """The entry points at ``deeplab_kitti_dp`` (narrow, on the CPU):
    train.py with validation, keep-best and EMA, then eval.py
    --road-metrics --ema, the test-set sweep and infer_image on the
    checkpoint it wrote (KITTI's 375x1242, padded to 376x1248)."""
    from PIL import Image

    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import (
        eval as eval_cli, infer_image, test as test_cli, train,
    )

    data = generate_synthetic_kitti(str(tmp_path / "data"), n_train=8, n_test=2,
                                    h=64, w=96, seed=3)
    ck = str(tmp_path / "ck")
    kw = ["--preset", "deeplab_kitti_dp", "--device", "cpu", "--model-kw",
          "width_mult=0.125,aspp_features=16"]
    assert train.main(kw + ["--data-dir", data, "--epochs", "1", "--image-size",
                            "64", "96", "--batch-size", "2", "--val-frac", "0.25",
                            "--keep-best", "--ema-decay", "0.99",
                            "--checkpoint-dir", ck]) == 0
    assert os.listdir(os.path.join(ck, "best"))
    assert eval_cli.main(kw + ["--data-dir", data, "--checkpoint-dir", ck,
                               "--road-metrics", "--ema"]) == 0
    runs = tmp_path / "runs"
    assert test_cli.main(kw + ["--data-dir", data, "--checkpoint-dir", ck,
                               "--runs-dir", str(runs), "--batch", "2"]) == 0
    src = os.path.join(data, "testing", "image_2", "um_000008.png")
    out = str(tmp_path / "overlay.png")
    assert infer_image.main(kw + ["--checkpoint-dir", ck, "--image", src,
                                  "--out", out]) == 0
    log = capsys.readouterr().out
    assert "model=deeplab" in log and "val split: 2 images held out" in log
    assert "evaluating checkpoint step 3 (EMA params)" in log
    assert "kitti-road: MaxF=" in log and "2 images in" in log
    (run,) = os.listdir(runs)
    assert sorted(os.listdir(runs / run)) == ["um_000008.png", "um_000009.png"]
    assert np.asarray(Image.open(runs / run / "um_000008.png")).shape == (375, 1242, 3)
    assert np.asarray(Image.open(out)).shape == (375, 1242, 3)
