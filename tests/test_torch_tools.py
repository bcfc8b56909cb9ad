"""tools/convert_checkpoint_to_torch.py: an orbax checkpoint written by the
JAX package becomes a port state_dict that the port's CLIs load with
--weights, and the port's forward on it matches the JAX forward; and
tools/stage1_bwd_ab.py's cuDNN yardstick for the backward's dgrad launch
computes that launch's function; tools/overlay_ab.py's byte counts, bounds,
turns and ptxas report."""

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
import overlay_ab  # noqa: E402
import stage1_bwd_ab  # noqa: E402

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


@pytest.mark.parametrize("shape", [(2, 8, 12, 16), (1, 6, 10, 32)])
def test_cudnn_dgrad_yardstick_is_the_backward_dgrad(shape):
    """tools/stage1_bwd_ab.py's yardstick for the dgrad launch computes the
    conv's data gradient of the same routed dz2: masked by relu'(z1) and
    rounded once to bf16 it is dz1 of the f32 plain backward, within one
    bf16 ulp (2^-7 |ref|, where the two sums straddle a rounding boundary)
    plus 2^-12 of the scale (their order differs); its work counts one
    conv's FLOPs and each tensor's bytes once."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        stage1_tail_bwd_plain, stage1_tail_codes_plain,
    )

    n, h, w, c = shape
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    z1 = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(bf)
    k2 = torch.from_numpy(rng.standard_normal((c, c, 3, 3), np.float32)
                          / np.sqrt(9 * c)).to(bf)
    b2 = torch.from_numpy(rng.standard_normal(c, np.float32) / 10).to(bf)
    g = torch.from_numpy(rng.standard_normal((n, h // 2, w // 2, c), np.float32)).to(bf)
    out, codes = stage1_tail_codes_plain(z1, k2, b2)
    want = stage1_tail_bwd_plain(g, out, codes, z1, k2)[0].float()
    dx = stage1_bwd_ab.cudnn_dgrad(torch, g, out, codes, z1, k2)()[0]
    got = torch.where(z1 > 0, dx.permute(0, 2, 3, 1).float(), 0.0).to(bf).float()
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert scale > 0
    assert bool(((got - want).abs() <= 2 ** -7 * want.abs() + 2 ** -12 * scale).all())
    nbytes, flops = stage1_bwd_ab.dgrad_work(8, 320, 1152, 64)
    assert flops == 2.0 * 8 * 320 * 1152 * 9 * 64 * 64
    assert abs(nbytes - 990.9e6) < 0.1e6


@pytest.mark.parametrize("shape", [(2, 8, 12, 16), (1, 6, 10, 32)])
def test_cudnn_fwd_yardstick_is_the_forward_conv(shape):
    """tools/stage1_bwd_ab.py's yardstick for the stage1 forward computes
    the conv of the same relu(z1): pooled, biased and relu'd by the plain
    code it is the plain training forward's out (and codes), bit for bit;
    its work counts one conv's FLOPs and each tensor's bytes once."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
        _pool_codes, stage1_tail_codes_plain,
    )

    n, h, w, c = shape
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    z1 = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(bf)
    k2 = torch.from_numpy(rng.standard_normal((c, c, 3, 3), np.float32)
                          / np.sqrt(9 * c)).to(bf)
    b2 = torch.from_numpy(rng.standard_normal(c, np.float32) / 10).to(bf)
    conv = stage1_bwd_ab.cudnn_fwd(torch, z1, k2)()
    assert conv.shape == (n, c, h, w)
    got, got_codes = _pool_codes(conv, b2)
    want, want_codes = stage1_tail_codes_plain(z1, k2, b2)
    assert torch.equal(got, want)
    assert torch.equal(got_codes, want_codes)
    nbytes, flops = stage1_bwd_ab.fwd_work(8, 320, 1152, 64)
    assert flops == 2.0 * 8 * 320 * 1152 * 9 * 64 * 64
    assert abs(flops - 217.4e9) < 0.05e9
    weights = 2 * 9 * 64 * 64 + 2 * 64
    # z1 377.5 MB read, out 94.4 MB and codes 47.2 MB written
    assert abs(nbytes - weights - 519.0e6) < 0.1e6
    assert stage1_bwd_ab.fwd_work(8, 320, 1152, 64, codes=False)[0] == nbytes - 47185920


@pytest.mark.parametrize("n,c,mb,ms", [(1, 2, 8.3835, 0.0025025),
                                       (8, 2, 67.068, 0.0200203),
                                       (1, 19, 40.0545, 0.0119566)])
def test_overlay_ab_work_and_bound(n, c, mb, ms):
    """tools/overlay_ab.py counts the overlay's bytes at 4C + 10 a pixel
    (logits and image read once, overlay and int32 labels written once) over
    the [375,1242] window of the padded logits, and bounds them by 3.35 TB/s;
    its copy yardstick moves half of them each way."""
    h, w = overlay_ab.IMAGE_HW
    nbytes = overlay_ab.work(n, h, w, c)
    assert nbytes == n * 375 * 1242 * (4 * c + 3 + 3 + 4)
    assert abs(nbytes / 1e6 - mb) < 1e-3
    b = overlay_ab.row_bound(n, h, w, c)
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - ms) < 1e-6
    assert overlay_ab.ROWS["b1_c2"][:2] == (1, 2)


def test_overlay_ab_turns_and_ptxas():
    """Each version runs twice in mirrored turns, and the ptxas report keeps
    the register and spill lines of the overlay kernels only."""
    assert overlay_ab.turns([]) == ["base", "change", "change", "base"]
    assert overlay_ab.turns(["a", "b"]) == ["base", "change", "a", "b", "b", "a",
                                            "change", "base"]
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z10pool_kernelv' for 'sm_90a'",
        "ptxas info    : Used 40 registers, 380 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114overlay_kernelILb1EEEvPKh' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 30 registers, 3072 bytes smem, 412 bytes cmem[0]"])
    assert overlay_ab.ptxas_lines(log) == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 30 registers, 3072 bytes smem, 412 bytes cmem[0]"]
