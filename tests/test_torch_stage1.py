"""The port's stage1 tail (ops/cuda/stage1.py) against the JAX package's
fused Pallas stage1 tail (interpret mode) and its jnp reference.

The TPU kernel takes width-pair-packed z1 [N,H,W/2,128] without b1; the
port takes NHWC z1 [N,H,W,64] with b1 already added. Unpacking is a pure
reshape (ops/packed_stem.py:unpack_pairs), so both see the same values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.ops.pallas.stage1 import (
    fused_stage1_tail, reference_stage1_tail,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    stage1_tail, stage1_tail_plain,
)


def _port(z1_packed, k2_hwio, b2, b1):
    n, h, wp, c2 = z1_packed.shape
    z1 = z1_packed.reshape(n, h, 2 * wp, c2 // 2) + b1        # unpack, +b1
    out = stage1_tail(torch.from_numpy(z1), torch.from_numpy(
        np.ascontiguousarray(k2_hwio.transpose(3, 2, 0, 1))),
        torch.from_numpy(b2))
    return out.numpy()


def _jax(z1_packed, k2_hwio, b2, b1):
    args = [jnp.asarray(a) for a in (z1_packed, k2_hwio, b2, b1)]
    return (np.asarray(reference_stage1_tail(*args)),
            np.asarray(fused_stage1_tail(*args, True)))


def test_stage1_tail_matches_jax():
    rng = np.random.default_rng(0)
    z1 = rng.normal(size=(2, 8, 16, 128)).astype(np.float32)
    k2 = (rng.normal(size=(3, 3, 64, 64)) * 0.1).astype(np.float32)
    b2 = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    b1 = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    got = _port(z1, k2, b2, b1)
    ref, pallas = _jax(z1, k2, b2, b1)
    assert got.shape == ref.shape == (2, 4, 16, 64)
    # f32 on both sides; 576-term sums in another order: ~1e-6 relative
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_stage1_tail_exact_with_ties():
    """Integer-valued inputs make every conv sum exact, so the port must
    equal both JAX versions bit for bit, including the deliberate pooling
    ties (repeated kernel rows) and zero SAME-padding at the halo."""
    rng = np.random.default_rng(1)
    z1 = rng.integers(-2, 3, (1, 6, 8, 128)).astype(np.float32)
    k2 = rng.integers(-1, 2, (3, 3, 64, 64)).astype(np.float32)
    k2[1] = k2[0]
    b2 = rng.integers(-1, 2, (64,)).astype(np.float32)
    b1 = rng.integers(-1, 2, (64,)).astype(np.float32)
    got = _port(z1, k2, b2, b1)
    ref, pallas = _jax(z1, k2, b2, b1)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("shape", [(3, 6, 10, 16), (1, 4, 34, 48)])
def test_stage1_tail_narrow_widths_match_unfused_stage(shape):
    """C a multiple of 16 below 64 (the CPU-size model widths): the tail
    equals relu -> conv -> pool -> +b -> relu written out by hand."""
    rng = np.random.default_rng(2)
    n, h, w, c = shape
    z1 = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    k2 = torch.from_numpy(rng.normal(size=(c, c, 3, 3)).astype(np.float32))
    b2 = torch.from_numpy(rng.normal(size=(c,)).astype(np.float32))
    y = torch.nn.functional.conv2d(torch.relu(z1).permute(0, 3, 1, 2), k2,
                                   padding=1)
    want = torch.relu(torch.nn.functional.max_pool2d(y, 2)
                      + b2[:, None, None]).permute(0, 2, 3, 1)
    torch.testing.assert_close(stage1_tail(z1, k2, b2), want)


def test_wrapper_takes_plain_version_only_on_cpu():
    rng = np.random.default_rng(3)
    z1 = torch.from_numpy(rng.normal(size=(1, 4, 8, 16)).astype(np.float32))
    k2 = torch.from_numpy(rng.normal(size=(16, 16, 3, 3)).astype(np.float32))
    b2 = torch.zeros(16)
    before = stage1_tail.launches
    torch.testing.assert_close(stage1_tail(z1, k2, b2),
                               stage1_tail_plain(z1, k2, b2), rtol=0, atol=0)
    assert stage1_tail.launches == before == 0
    # any device but the CPU goes to the kernel or raises; never the plain
    with pytest.raises(ValueError, match="no stage1 tail for device meta"):
        stage1_tail(z1.to("meta"), k2.to("meta"), b2.to("meta"))
