"""The port's overlay (ops/overlay.py, ops/cuda/overlay.py) and label
packing (ops/labelpack.py) against the JAX package's XLA overlay, its Pallas
overlay kernel in interpret mode, and its labelpack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.ops import labelpack as jax_labelpack
from semanticsegmentation_tensorflow_tpu.ops.overlay import (
    argmax_colormap_overlay as jax_overlay,
    host_overlay as jax_host_overlay,
)
from semanticsegmentation_tensorflow_tpu.ops.pallas.overlay import (
    argmax_colormap_overlay_pallas,
)
from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    CITYSCAPES_PALETTE, KITTI_OVERLAY_PALETTE,
)
from semanticsegmentation_tensorflow_tpu_torch.ops import labelpack
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
    argmax_colormap_overlay_cuda,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
    argmax_colormap_overlay, host_overlay,
)


def _inputs(c, n=2, h=37, w=50, seed=0):
    """Random image and logits with deliberate ties: some pixels have all
    classes equal (label 0), some a tie between classes 1 and 2 at the top
    (label 1, the lowest of the tied)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    logits = rng.normal(size=(n, h, w, c)).astype(np.float32)
    all_tied = rng.random((n, h, w)) < 0.1
    logits[all_tied] = logits[all_tied][:, :1]
    if c > 2:
        top = rng.random((n, h, w)) < 0.1
        logits[top, 1] = logits[top, 2] = logits[top].max(-1) + 1.0
    palette = (KITTI_OVERLAY_PALETTE if c == 2 else CITYSCAPES_PALETTE[:c])
    return img, logits, palette


@pytest.mark.parametrize("c,alpha,blend0", [(2, 0.5, False), (5, 0.5, False),
                                             (5, 0.7, True)])
def test_overlay_matches_jax(c, alpha, blend0):
    img, logits, palette = _inputs(c)
    ov, lab = argmax_colormap_overlay(torch.from_numpy(img),
                                      torch.from_numpy(logits), palette,
                                      alpha, blend0)
    ov, lab = ov.numpy(), lab.numpy()
    j_ov, j_lab = jax_overlay(jnp.asarray(img), jnp.asarray(logits),
                              jnp.asarray(palette), alpha, blend0)
    p_ov, p_lab = argmax_colormap_overlay_pallas(
        jnp.asarray(img), jnp.asarray(logits), jnp.asarray(palette), alpha,
        blend0, interpret=True)
    assert lab.dtype == np.int32 and ov.dtype == np.uint8
    np.testing.assert_array_equal(lab, np.asarray(j_lab))
    np.testing.assert_array_equal(lab, np.asarray(p_lab))
    # the same f32 products and sum (no FMA on either side): exact bytes
    np.testing.assert_array_equal(ov, np.asarray(j_ov))
    np.testing.assert_array_equal(ov, np.asarray(p_ov))


def test_ties_go_to_lowest_class():
    logits = torch.tensor([[[[0.5, 0.5], [1.0, 0.2], [0.1, 0.3]]]])
    img = torch.zeros((1, 1, 3, 3), dtype=torch.uint8)
    _, lab = argmax_colormap_overlay(img, logits, KITTI_OVERLAY_PALETTE)
    assert lab.tolist() == [[[0, 0, 1]]]
    logits5 = torch.tensor([[[[0.0, 2.0, 2.0, 1.0, 2.0]]]])
    _, lab5 = argmax_colormap_overlay(img[:, :, :1], logits5,
                                      CITYSCAPES_PALETTE[:5])
    assert lab5.item() == 1


@pytest.mark.parametrize("c", [2, 5])
def test_wrapper_reads_padded_logits_on_cpu(c):
    """The kernel wrapper takes the padded logits and crops in place; on
    the CPU it goes to the plain version and launches nothing."""
    img, logits, palette = _inputs(c, seed=1)
    padded = np.random.default_rng(2).normal(
        size=(2, 40, 64, c)).astype(np.float32)
    padded[:, :37, :50] = logits
    before = argmax_colormap_overlay_cuda.launches
    ov, lab = argmax_colormap_overlay_cuda(torch.from_numpy(img),
                                           torch.from_numpy(padded), palette)
    want_ov, want_lab = argmax_colormap_overlay(torch.from_numpy(img),
                                                torch.from_numpy(logits),
                                                palette)
    assert torch.equal(ov, want_ov) and torch.equal(lab, want_lab)
    assert argmax_colormap_overlay_cuda.launches == before == 0
    with pytest.raises(ValueError, match="do not cover"):
        argmax_colormap_overlay_cuda(torch.from_numpy(img),
                                     torch.from_numpy(padded[:, :30]), palette)
    with pytest.raises(ValueError, match="no overlay kernel for device meta"):
        argmax_colormap_overlay_cuda(torch.from_numpy(img).to("meta"),
                                     torch.from_numpy(padded).to("meta"),
                                     palette)


@pytest.mark.parametrize("blend0", [False, True])
def test_host_overlay_matches_device_blend_and_jax(blend0):
    img, logits, palette = _inputs(5, n=1, seed=3)
    ov, lab = argmax_colormap_overlay(torch.from_numpy(img),
                                      torch.from_numpy(logits), palette, 0.6,
                                      blend0)
    lab8 = lab.numpy().astype(np.uint8)[0]
    host = host_overlay(img[0], lab8, palette, 0.6, blend0)
    np.testing.assert_array_equal(host, ov.numpy()[0])
    np.testing.assert_array_equal(
        host, jax_host_overlay(img[0], lab8, palette, 0.6, blend0))


@pytest.mark.parametrize("mode,nc", [("bits", 2), ("nibbles", 16),
                                     ("none", 19)])
@pytest.mark.parametrize("w", [1, 9, 50])
def test_labelpack_matches_jax(mode, nc, w):
    rng = np.random.default_rng(w + nc)
    labels = rng.integers(0, nc, (2, 5, w)).astype(np.uint8)
    packed = labelpack.pack_labels(torch.from_numpy(labels), mode).numpy()
    np.testing.assert_array_equal(
        packed, np.asarray(jax_labelpack.pack_labels(jnp.asarray(labels), mode)))
    assert packed.shape[-1] == labelpack.packed_width(w, mode)
    np.testing.assert_array_equal(labelpack.unpack_labels(packed, w, mode),
                                  labels)
    assert labelpack.pack_mode(nc) == jax_labelpack.pack_mode(nc) == mode
