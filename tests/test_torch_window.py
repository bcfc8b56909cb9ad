"""Tiled native-resolution inference (``infer/window.py``) and
``scripts/infer_image.py --tiled`` in the port against the JAX package's
``infer/window.py`` on the CPU, in float32 on a narrow U-Net with
BatchNorm (base 8, depth 2, stride 4; the same weights and statistics
carried across by the weight bridge; images from numpy seeds):

* ``tile_offsets`` on every (full, tile, overlap) of a small grid;
* ``TiledPredictor`` at a 1x1 grid (a 20x26 image edge-padded up to one
  32x32 tile) and a 2x3 grid (48x80 at an overlap of 8) against JAX's: the
  same grid and tile, the labels (at most 1 pixel in 200 may differ: a
  near-tie of the two frameworks' f32 sums may order either way) and the
  overlay where the labels agree;
* at a 1x1 grid on an image of the tile's size the tiled labels are the
  Predictor's;
* the overlap's bounds and the CLI's ``tiled:`` line.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semanticsegmentation_tensorflow_tpu.infer.window import (
    TiledPredictor as JaxTiledPredictor, tile_offsets as jax_tile_offsets,
)
from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.infer import (
    Predictor, TiledPredictor, tile_offsets,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image

from torch_parity import draw_bn_state

KW = dict(base_features=8, depth=2, use_bn=True)
TILE = (32, 32)


def _port():
    model = build_model("unet", 2, device="cpu", dtype=torch.float32, **KW)
    init_params(model, torch.Generator().manual_seed(0))
    return draw_bn_state(model, 1)


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def test_tile_offsets_match_jax():
    for full in range(1, 70, 3):
        for tile in (8, 16, 32):
            for overlap in (0, 3, 8, tile - 1):
                got = tile_offsets(full, tile, overlap)
                assert got == jax_tile_offsets(full, tile, overlap)
                assert got[0] == 0 and (full <= tile or got[-1] == full - tile)


@pytest.mark.parametrize("hw,overlap,grid", [((20, 26), None, (1, 1)),
                                             ((48, 80), 8, (2, 3))])
def test_tiled_predictor_matches_jax(hw, overlap, grid):
    model = _port()
    variables = convert.to_variables(convert.from_state_dict(model.state_dict(), model))
    jm = jax_build("unet", num_classes=2, dtype=jnp.float32, **KW)
    img = _image(*hw, seed=sum(hw))
    jp = JaxTiledPredictor(jm, variables, TILE, overlap=overlap)
    want_overlay, want = jp(img)
    tp = TiledPredictor(model, TILE, device="cpu", overlap=overlap)
    overlay, labels = tp(img)
    assert tp.grid == jp.grid == grid and tp.tile == jp._tile == TILE
    assert labels.shape == want.shape == hw and labels.dtype == np.int32
    same = labels == want
    assert same.mean() >= 0.995
    np.testing.assert_array_equal(overlay[same], want_overlay[same])


def test_one_tile_is_the_predictor():
    """An image of the tile's size is one tile: the tiled labels are the
    Predictor's wherever its two logits are not within 1e-6 of their scale
    (the argmax of a softmax may tie where the logits differ by an ulp)."""
    model = _port()
    img = _image(*TILE, seed=4)
    pred = Predictor(model, TILE, device="cpu")
    logits = pred._padded_logits(torch.from_numpy(img[None])).numpy()[0]
    _, want = pred(img)
    _, got = TiledPredictor(model, TILE, device="cpu")(img)
    decided = np.abs(logits[..., 1] - logits[..., 0]) > 1e-6 * np.abs(logits).max()
    np.testing.assert_array_equal(got[decided], want[decided])


def test_overlap_bounds_and_cli_line(tmp_path, capsys):
    """An overlap outside [0, the shorter tile side) raises; ``infer_image
    --tiled --tile-overlap 96`` keeps a 400x1300 image at its size
    (fcn8s_kitti's 384x1248 tiles, a 2x2 grid; narrow, seeded weights) and
    prints the JAX CLI's ``tiled:`` line."""
    model = _port()
    with pytest.raises(ValueError, match="overlap"):
        TiledPredictor(model, TILE, device="cpu", overlap=32)
    with pytest.raises(ValueError, match="overlap"):
        TiledPredictor(model, TILE, device="cpu", overlap=-1)
    src = tmp_path / "in.png"
    Image.fromarray(_image(400, 1300, seed=5)).save(src)
    out = tmp_path / "out.png"
    assert infer_image.main([
        "--model-kw", "fc_features=16,width_mult=0.125,use_bn=True",
        "--device", "cpu", "--image", str(src), "--out", str(out), "--tiled",
        "--tile-overlap", "96"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "tiled: input 400x1300, grid 2x2 tiles of 384x1248"
    assert lines[1].startswith(f"wrote {out} (non-background fraction ")
    assert Image.open(out).size == (1300, 400)
