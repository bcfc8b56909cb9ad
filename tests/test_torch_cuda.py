"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and skip without one. The file imports
nothing of JAX (nor does the port), so it runs on a GPU host that has no
JAX installed; the repository's ``tests/conftest.py`` imports JAX, hence:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    CITYSCAPES_PALETTE, KITTI_OVERLAY_PALETTE,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.overlay import (
    argmax_colormap_overlay_cuda, argmax_colormap_overlay_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    stage1_tail, stage1_tail_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(3, 12, 40, 64), (1, 6, 34, 16),
                                   (2, 10, 66, 48)])
def test_stage1_kernel_matches_plain_on_card(gen, shape):
    n, h, w, c = shape
    z1 = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k2 = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
          / (9 * c) ** 0.5).bfloat16()
    b2 = (torch.randn((c,), generator=gen, device="cuda") / 10).bfloat16()
    before = stage1_tail.launches
    got = stage1_tail(z1, k2, b2).float()
    want = stage1_tail_plain(z1, k2, b2).float()
    assert stage1_tail.launches == before + 1
    assert got.shape == (n, h // 2, w // 2, c)
    # one bf16 ulp of the conv value (another f32 summation order before
    # the rounding), plus one of the bias add
    bound = 2 ** -6 * (want.abs() + b2.float().abs()) + 1e-6
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("k2_format", [torch.contiguous_format,
                                       torch.channels_last])
def test_stage1_kernel_exact_with_ties_on_card(gen, k2_format):
    """Integer-valued inputs make every sum exact: bit-equal, pooling ties
    (repeated kernel rows) and the zero halo included, with k2 in either
    memory format (the wrapper copies only the contiguous one)."""
    g = torch.Generator().manual_seed(1)
    z1 = torch.randint(-2, 3, (2, 16, 48, 64), generator=g)
    k2 = torch.randint(-1, 2, (64, 64, 3, 3), generator=g)
    k2[:, :, 1] = k2[:, :, 0]
    b2 = torch.randint(-1, 2, (64,), generator=g)
    z1, k2, b2 = (t.to("cuda", torch.bfloat16) for t in (z1, k2, b2))
    k2 = k2.contiguous(memory_format=k2_format)
    assert torch.equal(stage1_tail(z1, k2, b2), stage1_tail_plain(z1, k2, b2))


@pytest.mark.parametrize("c,alpha,blend0", [(2, 0.5, False), (5, 0.7, True)])
def test_overlay_kernel_matches_plain_on_card(gen, c, alpha, blend0):
    """Labels and bytes exact (the blend is rounded without FMA), from the
    padded logits, with ties injected."""
    h, w = 37, 50
    img = torch.randint(0, 256, (2, h, w, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    logits = torch.randn((2, 64, 64, c), generator=gen, device="cuda")
    tie = torch.rand((2, 64, 64), generator=gen, device="cuda") < 0.2
    logits[..., 1] = torch.where(tie, logits[..., 0], logits[..., 1])
    palette = KITTI_OVERLAY_PALETTE if c == 2 else CITYSCAPES_PALETTE[:c]
    before = argmax_colormap_overlay_cuda.launches
    ov, lab = argmax_colormap_overlay_cuda(img, logits, palette, alpha, blend0)
    want_ov, want_lab = argmax_colormap_overlay_plain(
        img, logits[:, :h, :w], palette, alpha, blend0)
    assert argmax_colormap_overlay_cuda.launches == before + 1
    assert torch.equal(lab, want_lab) and torch.equal(ov, want_ov)


def test_predictor_runs_both_kernels_on_card(gen):
    """A narrow FCN-8s through the Predictor on the card launches both
    kernels and agrees with the same model run on the CPU's plain path.
    Bound: bf16 on both sides, but cuDNN and the CPU sum in other orders,
    so near-tied pixels may flip: labels agree on >= 99 %."""
    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    kw = dict(fc_features=32, width_mult=0.25)
    cpu_model = build_model("fcn8s", 2, device="cpu", **kw)
    init_params(cpu_model, torch.Generator().manual_seed(0))
    card_model = build_model("fcn8s", 2, device="cuda", **kw)
    card_model.load_state_dict(cpu_model.state_dict())
    img = np.random.default_rng(0).integers(0, 256, (2, 40, 70, 3), np.uint8)
    launches = stage1_tail.launches, argmax_colormap_overlay_cuda.launches
    ov, lab = Predictor(card_model, (40, 70), device="cuda")(img)
    assert stage1_tail.launches == launches[0] + 1
    assert argmax_colormap_overlay_cuda.launches == launches[1] + 1
    _, want_lab = Predictor(cpu_model, (40, 70), device="cpu")(img)
    assert ov.shape == (2, 40, 70, 3) and lab.shape == (2, 40, 70)
    assert (lab == want_lab).mean() >= 0.99
