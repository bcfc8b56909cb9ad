"""The port's U-Net and Cityscapes data path against the JAX package, on the
CPU in float32 at small sizes (the same weights carried across by the port's
weight bridge; inputs from numpy seeds):

* U-Net's logits (``base_features`` 8 and 64, ``depth`` 2, 32x64) against
  every JAX layout of the same function: ``packed_stage0`` True, False and
  ``"mixed"`` (which take the packed path at 64 features only) and
  ``fast_upconv``; the 2x2/2 transposed conv against flax on an asymmetric
  kernel; the weight bridge (strict, bit-equal) under both JAX trees;
* two Adam steps of the train step at 19 classes with ignore pixels, the
  eval step's confusion matrix and mIoU, the Predictor's labels and overlay
  at C=19, Winograd routing;
* ``data/cityscapes.py``: the label map on every id 0..255, the synthetic
  fixture byte for byte, ``load_example`` (with the GT's nearest resize),
  ``build_dataset``'s splits and the class counts of ``--class-balance``;
* the train / eval / test / infer_image CLIs and the serve handler at
  ``unet_cityscapes`` (narrow), ``--spatial`` at stride 16, ``use_bn``.

Tolerance for logits: 1e-5 of the largest logit (f32 on both sides, another
summation order); labels are compared where the JAX logits' two largest
classes differ by more than 1e-4 of the logit scale.
"""

import filecmp
import functools
import http.client
import io
import os
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semanticsegmentation_tensorflow_tpu.data import (
    CityscapesDataset as JaxCityscapes,
)
from semanticsegmentation_tensorflow_tpu.data.cityscapes import (
    encode_cityscapes_gt as jax_encode, generate_synthetic_cityscapes as jax_generate,
)
from semanticsegmentation_tensorflow_tpu.data.pipeline import (
    class_pixel_counts as jax_class_counts,
)
from semanticsegmentation_tensorflow_tpu.infer.predict import (
    Predictor as JaxPredictor,
)
from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.ops.fast_upsample import (
    fast_conv_transpose_2x2,
)
from semanticsegmentation_tensorflow_tpu.train import loss as jax_loss
from semanticsegmentation_tensorflow_tpu.train.metrics import (
    iou_from_confusion as jax_iou,
)
from semanticsegmentation_tensorflow_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu.train.step import (
    make_eval_step as jax_eval_step, make_train_step as jax_train_step,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
from semanticsegmentation_tensorflow_tpu_torch.data.cityscapes import (
    CityscapesDataset, encode_cityscapes_gt, generate_synthetic_cityscapes,
)
from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    CITYSCAPES_PALETTE, overlay_palette,
)
from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import class_pixel_counts
from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
    build_model, padded_input_hw,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw
from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import ConvTranspose
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
from semanticsegmentation_tensorflow_tpu_torch.train.metrics import (
    SegMetrics, iou_from_confusion,
)
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import (
    make_eval_step, make_train_step,
)

from torch_parity import jax_init, nhwc_input

C = 19
HW = (32, 64)
SMALL = dict(base_features=8, depth=2)
NARROW_KW = "base_features=8,depth=2"


def _jax_unet(dtype=jnp.float32, **kw):
    return jax_build("unet", num_classes=C, dtype=dtype, **dict(SMALL, **kw))


@functools.lru_cache(maxsize=None)
def _variables(base=8):
    return jax_init(_jax_unet(base_features=base), hw=HW, seed=base)


def _port(variables=None, dtype=torch.float32, **kw):
    model = build_model("unet", C, device="cpu", dtype=dtype, **dict(SMALL, **kw))
    if variables is not None:
        model.load_state_dict(convert.to_state_dict(
            convert.flatten_params(variables), model), strict=True)
    return model.eval()


def _decided(logits: np.ndarray) -> np.ndarray:
    """Pixels whose two largest logits differ by more than 1e-4 of the
    logit scale (at most 0.5 % may not)."""
    top2 = np.sort(logits, -1)[..., -2:]
    ok = top2[..., 1] - top2[..., 0] > 1e-4 * np.abs(logits).max()
    assert ok.mean() >= 0.995
    return ok


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,layout", [
    (8, {}), (64, {"packed_stage0": True}), (64, {"packed_stage0": False}),
    (64, {"packed_stage0": "mixed"}), (64, {"packed_stage0": False, "fast_upconv": True})],
    ids=["base8", "packed", "unpacked", "mixed", "fast_upconv"])
def test_unet_logits_match_jax(base, layout):
    """One port forward (the canonical form) against the JAX model in each
    TPU layout of the same function, on the same weights: within 1e-5 of
    the largest logit, f32 [2,32,64,19] out."""
    jm = _jax_unet(base_features=base, **layout)
    variables = _variables(base)
    x = nhwc_input((2, *HW, 3), seed=1)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    port = _port(variables, base_features=base, **layout)
    assert port.total_stride == 4
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *HW, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_conv_transpose_2x2_matches_flax_tap_by_tap():
    """flax ``ConvTranspose(F, (2, 2), strides=(2, 2), "SAME")`` applies its
    kernel unflipped: output row 2i+a, column 2j+b reads input (i, j) through
    tap (1-a, 1-b). An asymmetric kernel (every tap its own value) on an
    impulse pins it; on random inputs the port's ``ConvTranspose(kernel_size=
    2)`` with the converted weight equals flax and the JAX
    ``fast_conv_transpose_2x2`` within 1e-6 of the largest value."""
    k = np.arange(1, 1 + 2 * 2 * 3 * 5, dtype=np.float32).reshape(2, 2, 3, 5)
    b = np.linspace(-1, 1, 5).astype(np.float32)
    fm = fnn.ConvTranspose(5, (2, 2), strides=(2, 2), padding="SAME",
                           dtype=jnp.float32)
    variables = {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}
    mod = ConvTranspose(3, 5, 2, kernel_size=2, dtype=torch.float32)
    sd = convert.to_state_dict({"up/kernel": k, "up/bias": b},
                               torch.nn.ModuleDict({"up": mod}))
    mod.load_state_dict({n.split(".", 1)[1]: v for n, v in sd.items()})
    impulse = np.zeros((1, 3, 4, 3), np.float32)
    impulse[0, 1, 2, 0] = 1.0
    want = np.asarray(fm.apply(variables, jnp.asarray(impulse)))
    with torch.no_grad():
        got = mod(torch.from_numpy(impulse)).numpy()
    np.testing.assert_array_equal(got, want)
    for a in range(2):
        for c in range(2):
            np.testing.assert_array_equal(want[0, 2 + a, 4 + c], k[1 - a, 1 - c, 0] + b)
    x = nhwc_input((2, 5, 7, 3), seed=3)
    want = np.asarray(fm.apply(variables, jnp.asarray(x)))
    fast = np.asarray(fast_conv_transpose_2x2(jnp.asarray(x), jnp.asarray(k),
                                              jnp.asarray(b), jnp.float32))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 10, 14, 5)
    for other in (got, fast):
        np.testing.assert_allclose(other, want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("packed", [True, False])
def test_weight_bridge_round_trip_is_strict_and_bit_equal(packed):
    """The flax tree at 64 features converts strictly under both
    ``packed_stage0`` settings (the packed path declares the same paths) and
    comes back bit-equal; ``transposed_weights`` finds the up-convs; a leaf
    too many or too few raises naming it."""
    jm = _jax_unet(base_features=64, packed_stage0=packed)
    flat = convert.flatten_params(jax_init(jm, hw=HW, seed=5))
    model = _port(base_features=64)
    assert convert.transposed_weights(model) == {"up0.weight", "up1.weight"}
    sd = convert.to_state_dict(flat, model)
    assert set(sd) == set(model.state_dict())
    assert {k.split("/")[0] for k in flat} == {
        "down0", "down1", "bottleneck", "up1", "upconv1", "up0", "upconv0", "head"}
    back = convert.from_state_dict(sd, model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(KeyError, match="up2"):
        convert.to_state_dict(dict(flat, **{"up2/bias": np.zeros(8, np.float32)}),
                              model)
    with pytest.raises(KeyError, match="head"):
        convert.to_state_dict({k: v for k, v in flat.items()
                               if not k.startswith("head/")}, model)


def test_checkpoint_converter_at_the_unet_preset(tmp_path):
    """tools/convert_checkpoint_to_torch.py --preset unet_cityscapes (8
    features): the JAX checkpoint's params land strictly and bit-equal in
    the port, the up-convs flipped as transposed kernels."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import convert_checkpoint_to_torch

    from semanticsegmentation_tensorflow_tpu.train.checkpoint import (
        CheckpointManager,
    )
    from semanticsegmentation_tensorflow_tpu.train.state import create_train_state

    model = jax_build("unet", num_classes=C, base_features=8)
    state = jax.jit(lambda k: create_train_state(
        model, k, (1, *HW, 3), jax_optimizer("adam", 1e-4)))(jax.random.key(4))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, wait=True)
    mgr.close()
    out = tmp_path / "w.pt"
    assert convert_checkpoint_to_torch.main(
        ["--preset", "unet_cityscapes", "--checkpoint-dir", str(tmp_path / "ckpt"),
         "--model-kw", "base_features=8", "--out", str(out)]) == 0
    sd = torch.load(out, weights_only=True)
    port = build_model("unet", C, device="cpu", base_features=8)
    port.load_state_dict(sd, strict=True)
    got = convert.from_state_dict(sd, port)
    for k, v in convert.flatten_params(state.params).items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    k = np.asarray(state.params["up0"]["kernel"])
    np.testing.assert_array_equal(sd["up0.weight"].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))


def test_build_stride_and_unported_flags():
    """``build_model("unet", 19)`` at the preset's width has U-Net's ~31 M
    parameters and stride 16 (512x1024 needs no pad; 500x1000 pads to
    512x1008); ``use_bn`` builds a BatchNorm beside every conv of every
    block, an unknown ``packed_stage0`` is refused."""
    m = build_model("unet", C, device="meta")
    assert m.total_stride == 16
    assert 30e6 < sum(p.numel() for p in m.parameters()) < 32e6
    assert padded_input_hw(m, (512, 1024)) == (512, 1024)
    assert padded_input_hw(m, (500, 1000)) == (512, 1008)
    bn = build_model("unet", C, device="meta", use_bn=True)
    assert sum(type(mod).__name__ == "BatchNorm" for mod in bn.modules()) == 18
    with pytest.raises(ValueError, match="packed_stage0"):
        build_model("unet", C, device="meta", packed_stage0="both")


# ---------------------------------------------------------------------------
# train and eval steps, Predictor, Winograd
# ---------------------------------------------------------------------------

def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, *HW, 3)).astype(np.float32),
            "label": rng.integers(0, C, (n, *HW)).astype(np.int32),
            "valid": rng.random((n, *HW)) > 0.25}


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """The JAX side of two Adam steps (lr 1e-3): before each step the
    gradients by jax.grad of its loss, then the step's loss, confusion
    matrix and params."""
    jm = _jax_unet()
    variables = _variables()
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}

    def jloss(params):
        logits = jm.apply({"params": params}, batch["image"], train=False)
        ce, n = jax_loss.softmax_cross_entropy_sum(
            logits, jax.nn.one_hot(batch["label"], C), batch["valid"], None)
        return ce / jnp.maximum(n, 1.0)

    grad_fn = jax.jit(jax.grad(jloss))
    tx = jax_optimizer("adam", 1e-3)
    params = jax.tree.map(jnp.copy, variables["params"])   # the step donates it
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params), batch_stats={},
                       rng=jax.random.key(0), apply_fn=jm.apply, tx=tx)
    step, outs = jax_train_step(C), []
    for _ in range(2):
        grads = convert.flatten_params(jax.tree.map(np.asarray, grad_fn(js.params)))
        js, out = step(js, batch)
        outs.append((float(out["loss"]), np.asarray(out["cm"]), grads,
                     convert.flatten_params(jax.tree.map(np.asarray, js.params))))
    return outs


def test_train_step_matches_jax():
    """Two Adam steps (lr 1e-3, f32, 19 classes, a quarter of the pixels
    ignored) from the same weights on the same batch against the JAX
    package's ``make_train_step``, each from the same point: before the
    second step the model takes JAX's params after the first (the Adam
    moments stay the port's own). Each step: the loss (rtol 1e-5), the
    19x19 confusion matrix (exact, ignore pixels uncounted), the gradients
    (within 1e-4 of each leaf's largest, against jax.grad at those params)
    and every parameter after the update (atol 2e-6, the FCN train test's
    bound). (From the port's own first-step params, which differ from
    JAX's by summation order, the second step's gradients differ by up to
    6e-4 of a leaf's largest: one Adam step of 1e-3 a parameter makes the
    loss that sensitive.)"""
    outs = _jax_steps()
    model = _port(_variables()).train()
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                               make_lr_schedule(1e-3), seed=0)
    step = make_train_step(C)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    for i, (loss, cm, jgrads, jparams) in enumerate(outs):
        if i:
            with torch.no_grad():
                for k, v in convert.to_state_dict(outs[i - 1][3], model).items():
                    model.get_parameter(k).copy_(v)
        out = step(state, batch)
        np.testing.assert_allclose(out["loss"].item(), loss, rtol=1e-5)
        np.testing.assert_array_equal(out["cm"].numpy(), cm)
        assert out["cm"].shape == (C, C) and out["cm"].sum() == _batch(0)["valid"].sum()
        grads = convert.from_state_dict(
            {k: p.grad for k, p in model.named_parameters()}, model)
        assert set(grads) == set(jgrads)
        for k, w in jgrads.items():
            np.testing.assert_allclose(grads[k], w, rtol=0,
                                       atol=1e-4 * max(float(np.abs(w).max()), 1e-12),
                                       err_msg=f"{k} at step {i + 1}")
        got = convert.from_state_dict(model.state_dict(), model)
        for k, w in jparams.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-6,
                                       err_msg=f"{k} after step {i + 1}")


def test_eval_step_confusion_matrix_and_miou_match_jax():
    """The eval step at 19 classes against JAX's on the same weights: the
    loss (rtol 1e-5), the predictions and the 19x19 confusion matrix on the
    decided pixels (a near-tie moves at most 2 counts), per-class IoU and
    mIoU of the accumulated matrix as the JAX ``iou_from_confusion``
    computes them (1e-6)."""
    jm, variables = _jax_unet(), _variables()
    batch = _batch(1)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       opt_state=None, batch_stats={}, rng=jax.random.key(0),
                       apply_fn=jm.apply, tx=None)
    want = jax_eval_step(C)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(C)(_port(variables),
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    ok = _decided(np.asarray(jm.apply(variables, jnp.asarray(batch["image"]))))
    np.testing.assert_array_equal(got["pred"].numpy()[ok], np.asarray(want["pred"])[ok])
    near = ~ok & batch["valid"]
    cm = got["cm"].numpy()
    assert cm.shape == (C, C) and cm.sum() == batch["valid"].sum()
    assert np.abs(cm - np.asarray(want["cm"])).sum() <= 2 * near.sum()
    m = SegMetrics(C)
    m.update(got["cm"], got["loss"])
    s = m.summary()
    iou, miou = jax_iou(jnp.asarray(cm))
    np.testing.assert_allclose(s["iou"].numpy(), np.asarray(iou), atol=1e-6)
    np.testing.assert_allclose(s["miou"].item(), float(miou), atol=1e-6)
    np.testing.assert_allclose(iou_from_confusion(got["cm"])[1].item(), float(miou),
                               atol=1e-6)


def test_predictor_labels_and_overlay_match_jax():
    """The Predictor at 19 classes with Cityscapes' palette (both packages'
    Predictors given it) pads 30x60 to 32x64 and crops back: labels equal
    JAX's on every decided pixel, overlay bytes wherever labels agree; the
    label fetch (19 classes: no packing) equals the overlay's labels, and
    the host blend of the serving path equals the overlay."""
    hw = (30, 60)
    images = np.random.default_rng(7).integers(0, 256, (2, *hw, 3), np.uint8)
    jax_pred = JaxPredictor(_jax_unet(), _variables(), hw,
                            overlay_palette=CITYSCAPES_PALETTE)
    port_pred = Predictor(_port(_variables()), hw, device="cpu",
                          overlay_palette=overlay_palette("cityscapes"))
    assert port_pred._pack_mode == jax_pred._pack_mode == "none"
    ov, lab = port_pred(images)
    j_ov, j_lab = jax_pred(images)
    assert ov.shape == j_ov.shape == (2, *hw, 3) and lab.shape == (2, *hw)
    logits = np.asarray(jax_pred._logits_fn(jax_pred._variables, jnp.asarray(images)))
    ok = _decided(logits)
    np.testing.assert_array_equal(lab[ok], j_lab[ok])
    same = lab == j_lab
    np.testing.assert_array_equal(ov[same], j_ov[same])
    assert len(np.unique(lab)) > 2
    fetched = port_pred._fetch_labels(images)
    np.testing.assert_array_equal(fetched, lab)
    np.testing.assert_array_equal(host_overlay(images[0], fetched[0], CITYSCAPES_PALETTE),
                                  ov[0])


def test_winograd_routing_matches_jax(monkeypatch):
    """``winograd="f2"`` at 64 features, depth 2, on 16x32: the port runs
    kernel 6's plain version on exactly the layers where the JAX model runs
    its Pallas kernel (both widths multiples of 128: down1's second conv,
    the bottleneck's two, upconv1's two), and the logits agree within 1e-5
    of their scale."""
    from semanticsegmentation_tensorflow_tpu.ops.pallas import winograd as jpw

    hw = (16, 32)
    jm = _jax_unet(base_features=64, winograd="f2", packed_stage0=False)
    variables = jax_init(jm, hw=hw, seed=9)
    x = nhwc_input((1, *hw, 3), seed=8)
    seen = []
    orig = jpw.winograd_conv_bias_relu
    monkeypatch.setattr(jpw, "winograd_conv_bias_relu", lambda x_, w_, b_, v, i: (
        seen.append((tuple(x_.shape), w_.shape[-1], v, "bias_relu"))
        or orig(x_, w_, b_, v, i)))
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    routed = []
    fwd = cw.winograd_fwd_plain
    monkeypatch.setattr(cw, "winograd_fwd_plain", lambda x_, u, b, o, v, e: (
        routed.append((tuple(x_.shape), u.shape[-1], v, e)) or fwd(x_, u, b, o, v, e)))
    pm = _port(variables, base_features=64, winograd="f2")
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert routed == seen and len(routed) == 5
    assert [r[:2] for r in routed] == [((1, 8, 16, 128), 128), ((1, 4, 8, 128), 256),
                                       ((1, 4, 8, 256), 256), ((1, 8, 16, 256), 128),
                                       ((1, 8, 16, 128), 128)]
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# Cityscapes data
# ---------------------------------------------------------------------------

def test_encode_cityscapes_gt_matches_jax_on_every_id():
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got, want = encode_cityscapes_gt(ids), jax_encode(ids)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tid, valid = (a.ravel() for a in got)
    # labelIds 0..33: the 19 train ids once each, the rest ignored; above 33
    # every id clips to 33 (bicycle, train id 18)
    assert valid[:34].sum() == 19 and sorted(tid[:34][valid[:34]]) == list(range(19))
    assert valid[34:].all() and (tid[34:] == 18).all()


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    """The same seeded fixture written by both packages (64x128, 5 train
    and 3 val images)."""
    root = tmp_path_factory.mktemp("cs")
    kw = dict(n_train=5, n_val=3, h=64, w=128, seed=4)
    return (generate_synthetic_cityscapes(str(root / "port"), **kw),
            jax_generate(str(root / "jax"), **kw))


def test_synthetic_cityscapes_writes_the_jax_files(fixture_dirs):
    port, jax_dir = fixture_dirs
    files = sorted(os.path.relpath(os.path.join(d, f), port)
                   for d, _, fs in os.walk(port) for f in fs)
    assert len(files) == 16 and sorted(
        os.path.relpath(os.path.join(d, f), jax_dir)
        for d, _, fs in os.walk(jax_dir) for f in fs) == files
    for rel in files:
        assert filecmp.cmp(os.path.join(port, rel), os.path.join(jax_dir, rel),
                           shallow=False), rel


@pytest.mark.parametrize("size", [(64, 128), (32, 64), (40, 90)])
@pytest.mark.parametrize("split", ["train", "val"])
def test_load_example_matches_jax(fixture_dirs, split, size):
    """``build_dataset("cityscapes", ..., split)`` lists the split as JAX's
    dataset does (val also as ``test_images``); every example equals JAX's,
    at the stored size and resized (image bilinear, GT nearest)."""
    port_dir, _ = fixture_dirs
    ds = build_dataset("cityscapes", port_dir, size, split=split)
    jds = JaxCityscapes(port_dir, split=split, image_size=size)
    assert isinstance(ds, CityscapesDataset)
    assert ds.train_images == jds.train_images and len(ds.train_images) == (
        5 if split == "train" else 3)
    assert ds.test_images == jds.test_images
    for p in ds.train_images:
        for a, b in zip(ds.load_example(p), jds.load_example(p)):
            assert a.dtype == b.dtype and a.shape[:2] == size
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="leftImg8bit/test"):
        build_dataset("cityscapes", port_dir, size, split="test").train_images


def test_class_pixel_counts_match_jax(fixture_dirs):
    """``--class-balance``'s scan over the fixture: the 19 counts equal the
    JAX package's, ignore pixels excluded."""
    port_dir, _ = fixture_dirs
    got = class_pixel_counts(CityscapesDataset(port_dir, image_size=(64, 128)), C)
    want = jax_class_counts(JaxCityscapes(port_dir, image_size=(64, 128)), C)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 5 * 64 * 128


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_clis_train_eval_sweep_and_infer_at_unet_cityscapes(tmp_path, capsys):
    """The entry points at ``unet_cityscapes`` (narrow, 32x64, on the CPU):
    train.py --synthetic (the Cityscapes fixture), then on a fixture of its
    own with --val-frac, --keep-best and --cache-gb, then --resume; eval.py
    on the checkpoint (split val by default; --road-metrics is ignored with
    JAX's note at 19 classes); the sweep over the val images (Cityscapes'
    palette) and infer_image."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import (
        eval as eval_cli, infer_image, test as test_cli, train,
    )

    kw = ["--preset", "unet_cityscapes", "--device", "cpu", "--model-kw", NARROW_KW]
    small = ["--image-size", "32", "64", "--batch-size", "2"]
    assert train.main(kw + small + ["--synthetic", "--epochs", "1",
                                    "--checkpoint-dir", str(tmp_path / "ck0")]) == 0
    data = generate_synthetic_cityscapes(str(tmp_path / "cs"), n_train=8, n_val=2,
                                         h=32, w=64, seed=2)
    ck = str(tmp_path / "ck")
    base = kw + small + ["--data-dir", data, "--checkpoint-dir", ck,
                         "--cache-gb", "0.01"]
    assert train.main(base + ["--epochs", "1", "--val-frac", "0.25",
                              "--keep-best"]) == 0
    assert os.listdir(os.path.join(ck, "best"))
    assert train.main(base + ["--epochs", "1", "--val-frac", "0.25", "--resume"]) == 0
    log = capsys.readouterr().out
    assert "model=unet" in log and "train_images=8" in log
    assert "val split: 2 images held out" in log and "resumed at step 3" in log
    cfg = ["--preset", "unet_cityscapes", "--device", "cpu", "--model-kw", NARROW_KW]
    # the preset's 512x1024 from 32x64 files: the resize is the loader's
    assert eval_cli.main(cfg + ["--data-dir", data, "--checkpoint-dir", ck,
                                "--road-metrics", "--batch-size", "2"]) == 0
    log = capsys.readouterr().out
    assert "evaluating checkpoint step 6" in log
    assert "evaluating split='val' (2 images)" in log
    assert "note: --road-metrics needs a binary model; ignored" in log
    assert "miou=" in log and "kitti-road" not in log
    iou = log.split("iou=")[-1].split("]")[0]
    assert len(iou.split(",")) == C
    runs = tmp_path / "runs"
    assert test_cli.main(cfg + ["--data-dir", data, "--checkpoint-dir", ck,
                                "--runs-dir", str(runs), "--batch", "2"]) == 0
    (run,) = os.listdir(runs)
    names = sorted(os.listdir(runs / run))
    assert names == ["synthcity_000000_000019_leftImg8bit.png",
                     "synthcity_000001_000019_leftImg8bit.png"]
    assert np.asarray(Image.open(runs / run / names[0])).shape == (512, 1024, 3)
    src = os.path.join(data, "leftImg8bit", "val", "synthcity", names[0])
    out = str(tmp_path / "overlay.png")
    assert infer_image.main(cfg + ["--checkpoint-dir", ck, "--image", src,
                                   "--out", out]) == 0
    assert np.asarray(Image.open(out)).shape == (512, 1024, 3)
    log = capsys.readouterr().out
    assert "2 images in" in log and "wrote" in log


def test_serve_segment_and_labels_at_19_classes():
    """``serve`` at ``unet_cityscapes`` (narrow, seeded weights): /segment
    is the host blend with Cityscapes' palette, /labels the class ids in
    all three channels, both equal to the Predictor's labels."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts.serve import make_server

    server, _ = make_server(["--preset", "unet_cityscapes", "--device", "cpu",
                             "--model-kw", NARROW_KW, "--port", "0", "--no-warmup"])
    pred = server.predictor
    np.testing.assert_array_equal(pred._palette, CITYSCAPES_PALETTE)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(3).integers(0, 256, (512, 1024, 3), np.uint8)
    labels = pred._fetch_labels(img[None])[0]
    assert labels.max() < C
    want = {"/segment": host_overlay(img, labels, CITYSCAPES_PALETTE, pred._alpha),
            "/labels": np.repeat(labels[..., None], 3, -1)}
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=120)
        for path in ("/segment", "/labels"):
            conn.request("POST", path, body=buf.getvalue())
            r = conn.getresponse()
            assert r.status == 200, path
            out = np.asarray(Image.open(io.BytesIO(r.read())))
            np.testing.assert_array_equal(out, want[path])
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_train_cli_spatial_at_stride_16(tmp_path, capsys, monkeypatch):
    """``--spatial 2`` at ``unet_cityscapes`` (8 features, depth 4): the
    rows are checked at U-Net's stride (16 rows are one block: refused before any work; 48 are
    three, which split 32 + 16), and at one rank the step trains
    unsharded."""
    from semanticsegmentation_tensorflow_tpu_torch.data import cityscapes
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train

    kw = ["--preset", "unet_cityscapes", "--synthetic", "--device", "cpu",
          "--model-kw", "base_features=8", "--batch-size", "2", "--epochs", "1",
          "--spatial", "2"]
    with monkeypatch.context() as m:
        m.setattr(cityscapes, "generate_synthetic_cityscapes",
                  lambda *a, **k: pytest.fail("work began"))
        with pytest.raises(ValueError, match="stride 16 into at least 2"):
            train.main(kw + ["--image-size", "16", "64"])
    assert train.main(kw + ["--image-size", "48", "64",
                            "--checkpoint-dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr()
    assert "final:" in out.out and "mesh=none" in out.out
