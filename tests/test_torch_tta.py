"""Test-time augmentation (``infer/tta.py``) in the port against the JAX
package's ``infer/tta.py`` on the CPU, in
float32 on a narrow U-Net with BatchNorm (base 8, depth 2, stride 4; the
same weights and running statistics carried across by the weight bridge;
inputs from numpy seeds):

* the variants' sizes (``_scale_hw``);
* the ensemble probabilities at scales 0.75 and 1.25 with flip (a
  downscale, which ``jax.image.resize`` antialiases, and an upscale; the
  input 30x46 pads to the stride in every variant): within 2e-5;
* the TTA eval step at scales 0.75 and 1.0 with flip and the road
  histogram: the loss within rtol 2e-5, the confusion matrix and the
  histogram with at most one labeled pixel in 1000 moved (a near-tie of the
  two frameworks' f32 sums may land either way);
* at ``scales=(1.0,)`` without flip the TTA step is the plain eval step:
  the same predictions, confusion matrix and histogram, the loss within
  rtol 1e-6.

``eval.py --tta`` runs in tests/test_torch_eval.py and tests/test_torch_bn.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.infer.tta import (
    _scale_hw as jax_scale_hw, make_tta_eval_step as jax_tta_eval_step,
    make_tta_logits_fn as jax_tta_logits_fn,
)
from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.infer.tta import (
    _scale_hw, make_tta_eval_step, make_tta_logits_fn,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_eval_step

from torch_parity import draw_bn_state

KW = dict(base_features=8, depth=2, use_bn=True)
HW = (30, 46)


def _port():
    model = build_model("unet", 2, device="cpu", dtype=torch.float32, **KW)
    init_params(model, torch.Generator().manual_seed(0))
    return draw_bn_state(model, 1).eval()


def _jax(model):
    jm = jax_build("unet", num_classes=2, dtype=jnp.float32, **KW)
    return jm, convert.to_variables(convert.from_state_dict(model.state_dict(), model))


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, *HW, 3)).astype(np.float32),
            "label": rng.integers(0, 2, (n, *HW)).astype(np.int32),
            "valid": rng.random((n, *HW)) > 0.25}


@pytest.mark.parametrize("hw,scale,stride", [
    ((375, 1242), 0.75, 32), ((375, 1242), 1.25, 32), ((30, 46), 0.75, 4),
    ((30, 46), 1.25, 4), ((20, 20), 0.5, 32), ((512, 1024), 1.5, 16)])
def test_scale_hw_matches_jax(hw, scale, stride):
    assert _scale_hw(*hw, scale, stride) == jax_scale_hw(*hw, scale, stride)


def test_tta_probs_match_jax():
    """The averaged probabilities of four variants (0.75 and 1.25, each with
    its flip) on [2,30,46,3], BatchNorm on its running statistics: f32
    [2,30,46,2], summing to 1, within 2e-5 of the JAX ensemble."""
    model = _port()
    jm, variables = _jax(model)
    x = _batch(0)["image"]
    want = np.asarray(jax.jit(jax_tta_logits_fn(jm, (0.75, 1.25), flip=True))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = make_tta_logits_fn(model, (0.75, 1.25), flip=True)(
            torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *HW, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_tta_eval_step_matches_jax():
    """``make_tta_eval_step`` at scales (0.75, 1.0) with flip and the road
    histogram against the JAX step on the same state (the model back in
    the mode it was in)."""
    model = _port().train()
    jm, variables = _jax(model)
    tx = jax_optimizer("sgd", 1e-3)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       opt_state=tx.init(variables["params"]),
                       batch_stats=variables["batch_stats"],
                       rng=jax.random.key(0), apply_fn=jm.apply, tx=tx)
    b = _batch(2)
    want = jax_tta_eval_step(jm, 2, scales=(0.75, 1.0), flip=True,
                             road_hist=True)(js, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_tta_eval_step(2, scales=(0.75, 1.0), flip=True,
                             road_hist=True)(model, {k: torch.from_numpy(v)
                                                     for k, v in b.items()})
    assert model.training
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=2e-5)
    n = int(b["valid"].sum())
    for key in ("cm", "road_hist"):
        w = np.asarray(want[key])
        assert got[key].sum() == w.sum() == n
        assert np.abs(got[key].numpy() - w).sum() // 2 <= n // 1000, key
    assert (got["pred"].numpy() != np.asarray(want["pred"])).mean() <= 1e-3


def test_tta_at_one_scale_without_flip_is_the_eval_step():
    model = _port()
    b = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    b["image"] = b["image"][:, :28, :44].contiguous()     # the stride's multiple
    b["label"], b["valid"] = b["label"][:, :28, :44], b["valid"][:, :28, :44]
    got = make_tta_eval_step(2, scales=(1.0,), flip=False,
                             road_hist=True)(model, b)
    want = make_eval_step(2, road_hist=True)(model, b)
    for key in ("pred", "cm", "road_hist"):
        assert torch.equal(got[key], want[key]), key
    np.testing.assert_allclose(got["loss"].item(), want["loss"].item(), rtol=1e-6)
