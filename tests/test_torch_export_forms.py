"""The port's serving artifacts (``infer/export.py``) on the CPU, at narrow
widths: the fixed-batch, BatchNorm and int8 forms and the JAX package's
artifact (tests/test_torch_export.py, whose helpers this file uses, has the
symbolic batch, the serving host, the guards and the CLIs).

An artifact's answers are held bit-equal to the in-process Predictor of the
same weights (one symbolic-batch artifact serving batches 1, 2 and 3; a
DeepLab artifact at a fixed batch with a ragged batch; BatchNorm; int8) and
against the JAX package's artifact on the same converted weights: labels
exact wherever the JAX logits' two classes differ by more than 1e-4 of the
logit scale (``torch_parity.decided``). Then the format guard, the serving
host's imports (no model module), the platform guards and the CLI round
trip.
"""

import copy

import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.infer import (
    ExportedPredictor as JaxExportedPredictor, export_model as jax_export_model,
)
from semanticsegmentation_tensorflow_tpu.infer.predict import (
    Predictor as JaxPredictor,
)
from semanticsegmentation_tensorflow_tpu_torch.infer import (
    ExportedPredictor, export_model,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

from test_torch_export import (
    IMAGE_HW, NARROW, _export, _images, _model, _same_as_predictor,
)
from torch_parity import decided, draw_bn_state, jax_fcn, jax_init, port_fcn


def test_deeplab_falls_back_to_a_fixed_batch(tmp_path):
    """DeepLab's dilated convs branch on the batch (``dilated_form``): the
    export refuses the symbolic batch and falls back to batch 1, or to the
    batch asked for; a ragged batch pads by repeating its last image (the
    Predictor on the padded batch gives the answer), a larger one raises."""
    model = _model("deeplab")
    meta, _, _ = _export(copy.deepcopy(model), tmp_path / "one.segx")
    assert (meta["batch_mode"], meta["batch_size"]) == ("fixed", 1)
    meta, art, pred = _export(model, tmp_path / "two.segx", batch_size=2)
    assert (meta["batch_mode"], meta["batch_size"]) == ("fixed", 2)
    imgs = _images(2, seed=3)
    _same_as_predictor(art, pred, imgs)
    padded = np.concatenate([imgs[:1], imgs[:1]])
    ov, lab = art(imgs[:1])
    want_ov, want_lab = pred(padded)
    np.testing.assert_array_equal(ov, want_ov[:1])
    np.testing.assert_array_equal(lab, want_lab[:1])
    with pytest.raises(ValueError, match="fixed-batch artifact"):
        art(_images(3))


def test_batchnorm_and_int8_artifacts_equal_their_predictors(tmp_path):
    """SegNet with BatchNorm (running statistics drawn away from their
    init) and an int8 FCN (BatchNorm-free, quant-safe flags, activation
    scales calibrated on one batch; its conv's patch budget guards the
    batch, so it exports at a fixed batch) export and answer as their
    Predictors."""
    from semanticsegmentation_tensorflow_tpu_torch.infer import quant
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
        merge_quant_safe_kwargs,
    )

    bn = draw_bn_state(_model("segnet", use_bn=True), seed=4, params=True)
    _, art, pred = _export(bn, tmp_path / "bn.segx")
    _same_as_predictor(art, pred, _images(2, seed=5))

    kw = merge_quant_safe_kwargs("fcn8s", dict(NARROW["fcn8s"]))
    model = build_model("fcn8s", 2, device="cpu", **kw)
    init_params(model, torch.Generator().manual_seed(1))
    calib = [torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 64, 96, 3)).astype(np.float32))]
    model, scales = quant.quantize_for_inference(model, calib)
    assert quant.quantized_count(model) == 21 and len(scales) == 21
    meta, art, pred = _export(model, tmp_path / "int8.segx")
    assert (meta["batch_mode"], meta["batch_size"]) == ("fixed", 1)
    _same_as_predictor(art, pred, _images(1, seed=7))


def test_artifact_matches_the_jax_artifact(tmp_path):
    """The port's artifact and the JAX package's, exported from the same
    weights (``convert.to_state_dict``): labels equal wherever the JAX
    logits decide (both in float32), overlay bytes equal where the labels
    are; the port's predictor refuses the JAX file, naming both formats."""
    model = jax_fcn("fcn8s")
    variables = jax_init(model)
    jpath = str(tmp_path / "jax.segx")
    jax_export_model(model, variables, IMAGE_HW, jpath, platforms=("cpu",))
    port = port_fcn("fcn8s", variables)
    export_model(port, IMAGE_HW, str(tmp_path / "port.segx"), platforms=("cpu",))
    imgs = _images(2, seed=8)
    ov, lab = ExportedPredictor(str(tmp_path / "port.segx"), "cpu")(imgs)
    j_ov, j_lab = JaxExportedPredictor(jpath)(imgs)
    ok = decided(JaxPredictor(model, variables, IMAGE_HW), imgs)
    np.testing.assert_array_equal(lab[ok], np.asarray(j_lab)[ok])
    same = lab == np.asarray(j_lab)
    np.testing.assert_array_equal(ov[same], np.asarray(j_ov)[same])
    with pytest.raises(ValueError, match="segx-1") as e:
        ExportedPredictor(jpath, "cpu")
    assert "segx-1" in str(e.value) and "segx-torch-1" in str(e.value)
