"""tools/convert_checkpoint_to_torch.py: an orbax checkpoint written by the
JAX package becomes a port state_dict that the port's CLIs load with
--weights, and the port's forward on it matches the JAX forward."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.models import build_model
from semanticsegmentation_tensorflow_tpu.train.checkpoint import CheckpointManager
from semanticsegmentation_tensorflow_tpu.train.state import (
    create_train_state, make_optimizer,
)

from torch_parity import jax_fcn, nhwc_input, port_fcn

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import convert_checkpoint_to_torch  # noqa: E402

KW = "fc_features=32,width_mult=0.25"


def test_checkpoint_converts_and_matches_jax(tmp_path):
    model = build_model("fcn8s", num_classes=2, fc_features=32, width_mult=0.25)
    tx = make_optimizer("adam", 1e-4)
    # jitted: the eager init runs op by op and takes several times longer
    state = jax.jit(lambda k: create_train_state(model, k, (1, 64, 96, 3), tx)
                    )(jax.random.key(3))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, wait=True)
    mgr.close()
    out = tmp_path / "w.pt"
    assert convert_checkpoint_to_torch.main(
        ["--checkpoint-dir", str(tmp_path / "ckpt"), "--model-kw", KW,
         "--out", str(out)]) == 0

    port = port_fcn("fcn8s")
    port.load_state_dict(torch.load(out, weights_only=True), strict=True)
    f32 = jax_fcn("fcn8s")                     # same params, f32 compute
    x = nhwc_input((1, 64, 96, 3), seed=4)
    want = np.asarray(jax.jit(f32.apply)({"params": state.params},
                                         jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        convert_checkpoint_to_torch.main(
            ["--checkpoint-dir", str(tmp_path / "none"), "--model-kw", KW,
             "--out", str(tmp_path / "w.pt")])
