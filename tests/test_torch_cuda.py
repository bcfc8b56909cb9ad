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
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.preprocess import (
    preprocess_normalize, preprocess_normalize_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.pool import (
    pool_argmax, pool_argmax_plain, unpool, unpool_bwd, unpool_bwd_plain,
    unpool_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    BwdHalos, SegNetStage1Tail, Stage1Tail, Stage1TailHalo, stage1_tail,
    stage1_tail_bwd, stage1_tail_bwd_plain, stage1_tail_codes_plain,
    stage1_tail_halo, stage1_tail_halo_bwd, stage1_tail_halo_bwd_plain,
    stage1_tail_halo_plain, stage1_tail_plain, stage1_tail_segnet,
    stage1_tail_segnet_plain, stage1_tail_train,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.tie_cases import (
    int_case, segnet_tie_windows, tie_windows,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the f32 references stay f32 on the card
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(3, 12, 40, 64), (1, 6, 34, 16),
                                   (2, 10, 66, 48), (2, 8, 130, 64),
                                   (1, 8, 64, 32)])
def test_stage1_kernel_matches_plain_on_card(gen, shape):
    """Ragged tiles of 4 x 64 conv pixels (H % 4, W % 64, odd W/2, W over
    two tiles) and every width; a rerun is bit-identical."""
    n, h, w, c = shape
    z1 = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k2 = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
          / (9 * c) ** 0.5).bfloat16()
    b2 = (torch.randn((c,), generator=gen, device="cuda") / 10).bfloat16()
    before = stage1_tail.launches
    out = stage1_tail(z1, k2, b2)
    want = stage1_tail_plain(z1, k2, b2).float()
    assert stage1_tail.launches == before + 1
    assert torch.equal(stage1_tail(z1, k2, b2), out)
    got = out.float()
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


@pytest.mark.parametrize("n,h,w,hp,wp,c,alpha,blend0", [
    (2, 37, 50, 64, 64, 2, 0.5, False), (2, 37, 50, 64, 64, 5, 0.7, True),
    (8, 375, 1242, 384, 1248, 2, 0.5, False),     # the batched Predictor
    (1, 375, 1242, 384, 1248, 19, 0.5, True),     # Cityscapes classes
    # W not a multiple of 4, H*W not a multiple of a warp's 128 pixels
    (2, 37, 1238, 64, 1248, 2, 0.5, False), (2, 37, 1238, 64, 1248, 5, 0.7, True),
])
def test_overlay_kernel_matches_plain_on_card(gen, n, h, w, hp, wp, c, alpha, blend0):
    """Labels and bytes exact (the blend is rounded without FMA), from the
    padded logits, with ties injected."""
    img = torch.randint(0, 256, (n, h, w, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    logits = torch.randn((n, hp, wp, c), generator=gen, device="cuda")
    tie = torch.rand((n, hp, wp), generator=gen, device="cuda") < 0.2
    logits[..., 1] = torch.where(tie, logits[..., 0], logits[..., 1])
    palette = KITTI_OVERLAY_PALETTE if c == 2 else CITYSCAPES_PALETTE[:c]
    before = argmax_colormap_overlay_cuda.launches
    ov, lab = argmax_colormap_overlay_cuda(img, logits, palette, alpha, blend0)
    want_ov, want_lab = argmax_colormap_overlay_plain(
        img, logits[:, :h, :w], palette, alpha, blend0)
    assert argmax_colormap_overlay_cuda.launches == before + 1
    assert torch.equal(lab, want_lab) and torch.equal(ov, want_ov)


def test_overlay_kernel_refuses_a_misaligned_image(gen):
    """The kernel moves the image by 16-byte accesses: an image that starts
    off a 16-byte boundary raises (no launch, no fallback)."""
    buf = torch.zeros(1 + 4 * 8 * 3, dtype=torch.uint8, device="cuda")
    img = buf[1:].view(1, 4, 8, 3)
    logits = torch.zeros((1, 4, 8, 2), device="cuda")
    before = argmax_colormap_overlay_cuda.launches
    with pytest.raises(ValueError, match="16-byte"):
        argmax_colormap_overlay_cuda(img, logits, KITTI_OVERLAY_PALETTE)
    assert argmax_colormap_overlay_cuda.launches == before


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


@pytest.mark.parametrize("shape", [(2, 12, 40, 64), (8, 64, 256, 64),
                                   (8, 64, 200, 64), (8, 70, 200, 64)])
@pytest.mark.parametrize("case", [tie_windows, int_case])
def test_stage1_train_and_bwd_exact_with_ties_on_card(gen, case, shape):
    """Integer inputs: every sum is exact in f32, so the codes (first
    maximum in row-major window order, c = b > a included) and the kernel's
    dz1, dk2 and db2 equal the f32 plain versions bit for bit: at a shape
    where every backward block takes one tile and at ones where each walks
    several (each dgrad and wgrad block more 4 x 64 tiles than its two
    stages, the last column of tiles ragged at W = 200 and, at H = 70, the
    last row of tiles too). At the small shape the
    autograd Function also equals autograd through the plain forward."""
    z1, k2, b2 = (t.to("cuda", torch.bfloat16) for t in case(*shape, 1))
    out, codes = stage1_tail_train(z1, k2, b2)
    want_out, want_codes = stage1_tail_codes_plain(z1, k2, b2)
    assert torch.equal(out, want_out) and torch.equal(codes, want_codes)
    if case is tie_windows:
        assert int((want_codes == 1).sum()) > 0  # c = b > a picks b
    cot = torch.randint(-3, 4, out.shape, generator=torch.Generator().manual_seed(2)
                        ).to("cuda", torch.bfloat16)
    got = stage1_tail_bwd(cot, out, codes, z1, k2)
    want = stage1_tail_bwd_plain(cot, out, codes, z1, k2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if shape[0] == 2:
        leaves = [t.clone().requires_grad_() for t in (z1, k2, b2)]
        got = torch.autograd.grad(Stage1Tail.apply(*leaves), leaves, cot)
        want = torch.autograd.grad(stage1_tail_plain(*leaves), leaves, cot)
        for a, b in zip(got, want):
            assert torch.equal(a.float(), b.float())


@pytest.mark.parametrize("shape", [(3, 12, 40, 64), (1, 6, 34, 16),
                                   (1, 8, 64, 32), (2, 10, 66, 48),
                                   (1, 8, 200, 32), (2, 14, 96, 16),
                                   (8, 64, 200, 64), (8, 70, 200, 64),
                                   (12, 38, 136, 48)])
def test_stage1_bwd_kernel_matches_plain_on_card(gen, shape):
    """The backward kernel against its f32 plain version on the same
    (g, out, codes): the same bf16 products summed in f32 in another order,
    at widths whose columns (W = 200, 136) and rows (H = 14, 70, 38) end
    inside a dgrad and wgrad tile of 4 x 64 pixels and where each block of
    both launches walks more tiles than its pipeline has stages
    ((8, 64, 200, 64): 512 tiles; (8, 70, 200, 64): 576; (12, 38, 136, 48):
    360; at most 132 blocks).
    dz1, one bf16 rounding in both: one ulp (2^-7 |ref|) where the sums
    straddle a rounding boundary, plus the order difference near zero
    (2^-12 of the scale). dk2 and db2: f32 sums of up to N*H*W products,
    whose order differences random-walk to a few 1e-6 of the scale (1.3e-5
    at chip_smoke's training shape); bound 1e-4 of the scale."""
    n, h, w, c = shape
    z1 = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k2 = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
          / (9 * c) ** 0.5).bfloat16()
    b2 = (torch.randn((c,), generator=gen, device="cuda") / 10).bfloat16()
    g = torch.randn((n, h // 2, w // 2, c), generator=gen, device="cuda").bfloat16()
    out, codes = stage1_tail_codes_plain(z1, k2, b2)
    before = stage1_tail_bwd.launches
    got = stage1_tail_bwd(g, out, codes, z1, k2)
    assert stage1_tail_bwd.launches == before + 1
    want = stage1_tail_bwd_plain(g, out, codes, z1, k2)
    for a, ref, rel, near0 in zip(got, want, (2 ** -7, 0, 0), (2 ** -12, 1e-4, 1e-4)):
        a, ref = a.float(), ref.float()
        scale = ref.abs().max().item()
        assert bool(((a - ref).abs() <= rel * ref.abs() + near0 * scale).all())
    again = stage1_tail_bwd(g, out, codes, z1, k2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_preprocess_kernel_bytes_equal_plain_on_card(gen):
    """Mixed flips and offsets; the f32 output equals the plain version bit
    for bit (same f32 reciprocal, no FMA)."""
    img = torch.randint(0, 256, (4, 40, 72, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    flip = torch.tensor([True, False, True, False])
    oy, ox = torch.tensor([0, 8, 3, 5]), torch.tensor([0, 40, 7, 1])
    mean, std = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)
    before = preprocess_normalize.launches
    got = preprocess_normalize(img, flip, oy, ox, (32, 32), mean, std)
    assert preprocess_normalize.launches == before + 1
    want = preprocess_normalize_plain(img, flip, oy, ox, (32, 32), mean, std)
    assert got.shape == (4, 32, 32, 3) and torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 16, 24, 64), (1, 6, 10, 8),
                                   (3, 20, 72, 512)])
@pytest.mark.parametrize("integer", [True, False])
def test_pool_kernels_bytes_equal_plain_on_card(gen, shape, integer):
    """Kernel 5's three entry points are selections: pooled values, indices
    (first maximum, ties from small integers), the unpool and its backward
    equal the plain versions bit for bit."""
    if integer:
        x = torch.randint(-2, 3, shape, generator=gen, device="cuda").bfloat16()
    else:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    before = pool_argmax.launches, unpool.launches, unpool_bwd.launches
    p, idx = pool_argmax(x)
    want_p, want_idx = pool_argmax_plain(x)
    assert torch.equal(p, want_p) and torch.equal(idx, want_idx)
    if integer:
        assert set(idx.unique().tolist()) == {0, 1, 2, 3}
    assert torch.equal(unpool(p, idx), unpool_plain(p, idx))
    assert torch.equal(unpool_bwd(g, idx), unpool_bwd_plain(g, idx))
    assert (pool_argmax.launches, unpool.launches, unpool_bwd.launches) == tuple(
        b + 1 for b in before)


@pytest.mark.parametrize("shape", [(2, 12, 40, 64), (8, 64, 256, 64),
                                   (1, 6, 34, 16)])
@pytest.mark.parametrize("case", [segnet_tie_windows, int_case])
def test_segnet_tail_exact_with_ties_on_card(gen, case, shape):
    """Kernel 3 on integer inputs: out and idx (the first maximum of
    relu(bf16(conv + b2)), ties after the bias add and all-zero windows
    included) equal the plain version; the autograd Function's gradients
    equal the f32 backward reference fed the same (out, idx)."""
    z1, k2, b2 = (t.to("cuda", torch.bfloat16) for t in case(*shape, 3))
    before = stage1_tail_segnet.launches
    out, idx = stage1_tail_segnet(z1, k2, b2)
    assert stage1_tail_segnet.launches == before + 1
    want_out, want_idx = stage1_tail_segnet_plain(z1, k2, b2)
    assert torch.equal(out, want_out) and torch.equal(idx, want_idx)
    if case is segnet_tie_windows:
        assert bool((idx[..., 1::4] == 0).all())
        assert int((idx == 1).sum()) > 0
    cot = torch.randint(-3, 4, out.shape, generator=torch.Generator().manual_seed(4)
                        ).to("cuda", torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (z1, k2, b2)]
    got = torch.autograd.grad(SegNetStage1Tail.apply(*leaves)[0], leaves, cot)
    want = stage1_tail_bwd_plain(cot, want_out, want_idx, z1, k2)
    for a, b in zip(got, want):
        assert torch.equal(a.float(), b.to(a.dtype).float())


@pytest.mark.parametrize("shape", [(3, 12, 40, 64), (2, 10, 66, 48)])
def test_segnet_tail_matches_plain_on_card(gen, shape):
    """Random inputs: out within one bf16 ulp of the conv value plus one of
    the bias add (another f32 summation order before the rounding); the
    indices agree except where that ulp reorders a near tie."""
    n, h, w, c = shape
    z1 = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k2 = (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
          / (9 * c) ** 0.5).bfloat16()
    b2 = (torch.randn((c,), generator=gen, device="cuda") / 10).bfloat16()
    out, idx = stage1_tail_segnet(z1, k2, b2)
    want, want_idx = stage1_tail_segnet_plain(z1, k2, b2)
    bound = 2 ** -6 * (want.float().abs() + b2.float().abs()) + 1e-6
    assert bool(((out.float() - want.float()).abs() <= bound).all())
    assert (idx == want_idx).float().mean().item() >= 0.999


def test_segnet_predictor_runs_its_kernels_on_card(gen):
    """A narrow SegNet through the Predictor on the card launches kernels 3
    and 5 and stays as close to the float32 model (the CPU's plain path) as
    the CPU's own bf16 run does. SegNet's pools route by argmax indices that
    a one-ulp difference can flip, which moves a value within its window:
    on the CPU the bf16 and f32 runs of these weights differ by a relative
    L2 of ~0.3 in the logits, as do the JAX package's (test_torch_segnet's
    test_bf16_spread_is_the_models_not_the_ports). Bound: the
    card's distance to f32 at most 1.5x the CPU bf16 run's, plus 0.02."""
    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    def predictor(device, dtype=torch.bfloat16):
        model = build_model("segnet", 2, device=device, width_mult=0.25, dtype=dtype)
        model.load_state_dict(weights)
        return Predictor(model, (40, 70), device=device)

    weights = init_params(build_model("segnet", 2, device="cpu", width_mult=0.25),
                          torch.Generator().manual_seed(0)).state_dict()
    img = np.random.default_rng(0).integers(0, 256, (2, 40, 70, 3), np.uint8)
    card = predictor("cuda")
    before = (stage1_tail_segnet.launches, pool_argmax.launches, unpool.launches)
    ov, _ = card(img)
    assert (stage1_tail_segnet.launches, pool_argmax.launches,
            unpool.launches) == (before[0] + 1, before[1] + 4, before[2] + 5)
    assert ov.shape == (2, 40, 70, 3)
    ref = predictor("cpu", torch.float32)
    x = ref._to_device(img)
    want = ref._padded_logits(x)
    cpu = predictor("cpu")._padded_logits(x)
    got = card._padded_logits(x.cuda()).cpu()

    def rel(a):
        return ((a - want).norm() / want.norm()).item()

    assert rel(got) <= 1.5 * rel(cpu) + 0.02


# kernel 6: Winograd F(2,3) / F(4,3)

def _wino_inputs(gen, n, h, w, c, co):
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.winograd import u_for

    x = torch.randn((n, h, w, c), generator=gen, device="cuda").bfloat16()
    wt = torch.randn((co, c, 3, 3), generator=gen, device="cuda") / (9 * c) ** 0.5
    b = (torch.randn((co,), generator=gen, device="cuda") / 10).bfloat16()
    g = torch.randn((n, h, w, co), generator=gen, device="cuda").bfloat16()
    o = torch.randn((n, h, w, co), generator=gen, device="cuda").bfloat16()
    return x, wt, b, g, o, u_for


def _within(got, want, rel, near0):
    got, want = got.float(), want.float()
    bound = rel * want.abs() + near0 * want.abs().max()
    return bool(torch.isfinite(got).all()) and bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("variant", ["f2", "f4"])
@pytest.mark.parametrize("shape", [
    (2, 16, 24, 128, 128), (3, 12, 20, 64, 96),
    (2, 16, 24, 256, 416),   # Cout over several output-channel blocks + a ragged one
    (2, 64, 96, 512, 128),   # more K chunks than pipeline stages, forward and wgrad
    (2, 20, 36, 96, 64),     # tile rows and columns not multiples of the block's
])
def test_winograd_kernels_match_plain_on_card(gen, variant, shape):
    """Forward (bias_relu and raw), the masked forward (the input gradient)
    and the wgrad against their plain versions on the same bf16 inputs, at
    eligible shapes and ragged ones (partial tile blocks, output-channel
    blocks and K chunks; more K chunks than the kernel's pipeline stages).
    The outputs are one bf16 rounding of float32 sums taken in another
    order: one bf16 ulp (2^-7 of the value) plus 2^-12 of the scale near
    zero. dU and db are float32 sums over the tiles: 1e-4 of the scale. A
    rerun gives the same bits."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw
    from semanticsegmentation_tensorflow_tpu_torch.ops.winograd import rot180_swap

    n, h, w, c, co = shape
    x, wt, b, g, o, u_for = _wino_inputs(gen, n, h, w, c, co)
    u = u_for(wt, variant, torch.bfloat16)
    before = (cw.winograd_fwd.launches, cw.winograd_wgrad.launches)
    for epi in ("bias_relu", "none"):
        got = cw.winograd_fwd(x, u, b, None, variant, epi)
        want = cw.winograd_fwd_plain(x, u, b, None, variant, epi)
        assert got.shape == (n, h, w, co) and _within(got, want, 2 ** -7, 2 ** -12), epi
    u2 = u_for(rot180_swap(wt), variant, torch.bfloat16)
    got = cw.winograd_fwd(g, u2, None, o, variant, "none")
    assert _within(got, cw.winograd_fwd_plain(g, u2, None, o, variant, "none"),
                   2 ** -7, 2 ** -12)
    for mask in (o, None):
        du, db = cw.winograd_wgrad(x, g, mask, variant)
        du_p, db_p = cw.winograd_wgrad_plain(x, g, mask, variant)
        assert _within(du, du_p, 0.0, 1e-4) and _within(db, db_p, 0.0, 1e-4)
        again = cw.winograd_wgrad(x, g, mask, variant)
        assert torch.equal(du, again[0]) and torch.equal(db, again[1])
    assert (cw.winograd_fwd.launches, cw.winograd_wgrad.launches) == (
        before[0] + 3, before[1] + 4)


@pytest.mark.parametrize("variant", ["f2", "f4"])
def test_winograd_functions_on_card_match_cpu(gen, variant):
    """The autograd Functions through the kernels on the card against the
    same Functions through the plain versions on the CPU, same bf16
    inputs: the forward and dx within one bf16 ulp plus 2^-12 of the scale,
    dw and db (float32) within 1e-4 of theirs."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.winograd import (
        winograd_conv3x3, winograd_conv_bias_relu,
    )

    x, wt, b, g, _, _ = _wino_inputs(gen, 2, 16, 24, 128, 128)
    for fn, args in ((winograd_conv_bias_relu, (x, wt, b.float())),
                     (winograd_conv3x3, (x, wt))):
        results = []
        for dev in ("cuda", "cpu"):
            leaves = [a.detach().to(dev).requires_grad_() for a in args]
            out = fn(*leaves, variant)
            out.backward(g.to(dev))
            results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
        (out, dx, *dp), (out_c, dx_c, *dp_c) = results
        assert _within(out, out_c, 2 ** -7, 2 ** -12) and _within(dx, dx_c, 2 ** -7, 2 ** -12)
        assert all(_within(a, b_, 0.0, 1e-4) for a, b_ in zip(dp, dp_c))


# --- kernel 1c: the halo mode of the stage1 tail ----------------------------

_HALO_SINGLE = {"infer": lambda z, k, b: (stage1_tail(z, k, b), None),
                "codes": stage1_tail_train, "segnet": stage1_tail_segnet}


def _band(t, parts, i, fill):
    """Rows band i of ``parts`` and its halo rows (the neighbours' boundary
    rows, ``fill`` at the image's edge), each contiguous."""
    rows = t.shape[1] // parts
    lo, hi = i * rows, (i + 1) * rows
    edge = torch.full_like(t[:, :1], fill)
    top = t[:, lo - 1:lo] if i else edge
    bot = t[:, hi:hi + 1] if i < parts - 1 else edge
    return t[:, lo:hi].contiguous(), top.contiguous(), bot.contiguous()


def _halo_fwd(z1, k2, b2, b1, mode, parts):
    outs = [stage1_tail_halo(*_band(z1, parts, i, float("-inf")), k2, b2, b1, mode)
            for i in range(parts)]
    if parts == 1:            # no copy of a single band
        return (outs[0], None) if mode == "infer" else outs[0]
    if mode == "infer":
        return torch.cat(outs, 1), None
    return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)


def _halo_bwd(g, out, codes, z1, k2, b1, parts, fn=stage1_tail_halo_bwd):
    res = []
    for i in range(parts):
        gb, gt, gbt = _band(g, parts, i, 0.0)
        ob, ot, obt = _band(out, parts, i, 0.0)
        cb, ct, cbt = _band(codes, parts, i, 0)
        zb, zt, zbt = _band(z1, parts, i, float("-inf"))
        res.append(fn(gb, ob, cb, zb, k2, b1, BwdHalos(gt, gbt, ot, obt, ct, cbt, zt, zbt)))
    if parts == 1:
        return res[0]
    return (torch.cat([r[0] for r in res], 1), *(sum(r[k] for r in res) for k in (1, 2, 3)))


def _halo_inputs(gen, shape):
    n, h, w, c = shape
    return (torch.randn(shape, generator=gen, device="cuda").bfloat16(),
            (torch.randn((c, c, 3, 3), generator=gen, device="cuda")
             / (9 * c) ** 0.5).bfloat16(),
            (torch.randn((c,), generator=gen, device="cuda") / 10).bfloat16(),
            (torch.randn((c,), generator=gen, device="cuda") / 2).bfloat16(),
            torch.randn((n, h // 2, w // 2, c), generator=gen, device="cuda").bfloat16())


@pytest.mark.parametrize("mode", ["infer", "codes", "segnet"])
@pytest.mark.parametrize("shape", [(3, 12, 40, 64), (2, 20, 66, 48), (2, 8, 130, 64),
                                   (1, 8, 64, 32)])
def test_stage1_halo_kernel_matches_plain_on_card(gen, mode, shape):
    """Kernel 1c's forward over the whole image (-inf halo rows) equals the
    single-device kernel on z1 + b1 (the same bf16 add) bit for bit, codes
    included; against its plain version within check_stage1's bf16 bound
    (2^-6 (|plain| + |b2|) + 1e-6), codes on >= 99.9 %. Split in two halves
    with real halo rows it equals the whole-image call bit for bit; a rerun
    is bit-identical."""
    z1, k2, b2, b1, _ = _halo_inputs(gen, shape)
    before = stage1_tail_halo.launches
    out, codes = _halo_fwd(z1, k2, b2, b1, mode, 1)
    assert stage1_tail_halo.launches == before + 1
    again, again_codes = _halo_fwd(z1, k2, b2, b1, mode, 1)
    assert torch.equal(again, out)
    if mode != "infer":
        assert torch.equal(again_codes, codes)
    ref_out, ref_codes = _HALO_SINGLE[mode]((z1 + b1).contiguous(), k2, b2)
    assert torch.equal(out, ref_out)
    plain = stage1_tail_halo_plain(z1, *_band(z1, 1, 0, float("-inf"))[1:], k2, b2, b1,
                                   mode)
    p_out = plain if mode == "infer" else plain[0]
    err = (out.float() - p_out.float()).abs()
    assert bool((err <= 2 ** -6 * (p_out.float().abs() + b2.float().abs()) + 1e-6).all())
    if mode != "infer":
        assert torch.equal(codes, ref_codes)
        assert (codes == plain[1]).float().mean().item() >= 0.999
    h_out, h_codes = _halo_fwd(z1, k2, b2, b1, mode, 2)
    assert torch.equal(h_out, out)
    if mode != "infer":
        assert torch.equal(h_codes, codes)


@pytest.mark.parametrize("shape", [(3, 12, 40, 64), (1, 8, 64, 32), (8, 64, 256, 64),
                                   (2, 20, 66, 48), (8, 68, 200, 64)])
def test_stage1_halo_bwd_matches_plain_on_card(gen, shape):
    """Kernel 1c's backward against its f32 plain version on the same
    (g, out, codes), at widths whose last 4 x 64 tile is ragged (W = 66,
    200; the halves' H = 10, 34) and where each block walks more tiles than
    its two stages ((8, 68, 200, 64): 288 tiles a half), with the bounds of
    test_stage1_bwd_kernel_matches_plain
    (dz1 one bf16 ulp + 2^-12 of the scale; dk2, db2, db1 1e-4 of the
    scale); as two halves with real halo rows, dz1 bit-equal to the whole
    image's and dk2, db2, db1 within 1e-4 of the scale; reruns bit-identical."""
    z1, k2, b2, b1, g = _halo_inputs(gen, shape)
    out, codes = _halo_fwd(z1, k2, b2, b1, "codes", 1)
    before = stage1_tail_halo_bwd.launches
    got = _halo_bwd(g, out, codes, z1, k2, b1, 1)
    assert stage1_tail_halo_bwd.launches == before + 1
    want = _halo_bwd(g, out, codes, z1, k2, b1, 1, fn=stage1_tail_halo_bwd_plain)
    for a, ref, rel, near0 in zip(got, want, (2 ** -7, 0, 0, 0),
                                  (2 ** -12, 1e-4, 1e-4, 1e-4)):
        a, ref = a.float(), ref.float()
        scale = ref.abs().max().item()
        assert bool(((a - ref).abs() <= rel * ref.abs() + near0 * scale).all())
    halves = _halo_bwd(g, out, codes, z1, k2, b1, 2)
    assert torch.equal(halves[0], got[0])
    for a, ref in zip(halves[1:], got[1:]):
        assert bool(((a - ref).abs() <= 1e-4 * ref.abs().max()).all())
    again = _halo_bwd(g, out, codes, z1, k2, b1, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", [tie_windows, int_case])
def test_stage1_halo_exact_with_ties_on_card(gen, case):
    """Integer inputs and an integer b1: every sum exact, so kernel 1c's
    codes, out, dz1, dk2, db2 and db1 equal the plain versions bit for bit,
    whole and as halves; the autograd Function over the whole image equals
    the halo kernels called directly."""
    z1, k2, b2 = (t.to("cuda", torch.bfloat16) for t in case(2, 16, 48, 64, 1))
    b1 = torch.randint(-1, 2, (64,), generator=torch.Generator().manual_seed(3)
                       ).to("cuda", torch.bfloat16)
    z1 = (z1 - b1).contiguous()                 # pre-bias, still integer
    cot = torch.randint(-3, 4, (2, 8, 24, 64), generator=torch.Generator()
                        .manual_seed(2)).to("cuda", torch.bfloat16)
    for parts in (1, 2):
        out, codes = _halo_fwd(z1, k2, b2, b1, "codes", parts)
        plain = stage1_tail_halo_plain(z1, *_band(z1, 1, 0, float("-inf"))[1:], k2,
                                       b2, b1, "codes")
        assert torch.equal(out, plain[0]) and torch.equal(codes, plain[1])
        got = _halo_bwd(cot, out, codes, z1, k2, b1, parts)
        want = _halo_bwd(cot, out, codes, z1, k2, b1, 1, fn=stage1_tail_halo_bwd_plain)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    leaves = [t.clone().requires_grad_() for t in (z1, k2, b2, b1)]
    grads = torch.autograd.grad(Stage1TailHalo.apply(*leaves), leaves, cot)
    assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(grads, got))


def _op_cases(gen):
    """(op, args, plain, counter) of each registered op at a small shape,
    on integer-valued inputs: every sum is exact on both sides."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import winograd as cw

    bf = dict(device="cuda", dtype=torch.bfloat16)
    z1, k2, b2 = (t.to(**bf) for t in int_case(2, 12, 40, 64, seed=3))
    x = torch.randint(-2, 3, (2, 16, 24, 64), generator=gen, device="cuda").bfloat16()
    pooled, idx = pool_argmax_plain(x)
    img = torch.randint(0, 256, (2, 37, 50, 3), generator=gen, device="cuda",
                        dtype=torch.uint8)
    logits = torch.randint(-3, 4, (2, 64, 64, 5), generator=gen, device="cuda").float()
    pal = torch.as_tensor(CITYSCAPES_PALETTE[:5], dtype=torch.float32, device="cuda")
    wx = torch.randint(-2, 3, (2, 8, 12, 64), generator=gen, device="cuda").bfloat16()
    wt = torch.randint(-1, 2, (64, 64, 3, 3), generator=gen, device="cuda").float()
    u = cw.u_for(wt, "f2", torch.bfloat16)
    wb = torch.randint(-1, 2, (64,), generator=gen, device="cuda").bfloat16()
    ops = torch.ops.segport
    return {
        "stage1_tail": (ops.stage1_tail, (z1, k2, b2), stage1_tail_plain, stage1_tail),
        "stage1_tail_segnet": (ops.stage1_tail_segnet, (z1, k2, b2),
                               stage1_tail_segnet_plain, stage1_tail_segnet),
        "pool_argmax": (ops.pool_argmax, (x,), pool_argmax_plain, pool_argmax),
        "unpool": (ops.unpool, (pooled, idx), unpool_plain, unpool),
        "overlay": (ops.overlay, (img, logits, pal, 0.7, True),
                    lambda i, lg, p, a, b: argmax_colormap_overlay_plain(
                        i, lg[:, :37, :50], p, a, b), argmax_colormap_overlay_cuda),
        "winograd_fwd": (ops.winograd_fwd, (wx, u, wb, None, "f2", "bias_relu"),
                         cw.winograd_fwd_plain, cw.winograd_fwd),
    }


@pytest.mark.parametrize("name", ["stage1_tail", "stage1_tail_segnet", "pool_argmax",
                                  "unpool", "overlay", "winograd_fwd"])
def test_registered_op_on_card_launches_and_equals_plain(gen, name):
    """Each ``segport::`` op on CUDA tensors launches its kernel (the
    wrapper's counter, bumped in the op's CUDA implementation, goes up by
    one) and equals its plain version bit for bit on exact inputs; an input
    the kernel refuses (float32 where it takes bf16 or u8) raises instead of
    taking the plain version."""
    op, args, plain, counter = _op_cases(gen)[name]
    before = counter.launches
    got = op(*args)
    assert counter.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.is_cuda and g.is_contiguous() and torch.equal(g, w)
    bad = (args[0].float(),) + tuple(args[1:])
    with pytest.raises((TypeError, ValueError)):
        op(*bad)
    assert counter.launches == before + 1


def test_exported_program_on_card_launches_the_kernels(gen, tmp_path):
    """A narrow FCN-8s and SegNet exported on the card (``infer/export.py``)
    answer bit for bit as their Predictors on the card, and their calls
    launch the stage1, pool/unpool and overlay kernels."""
    from semanticsegmentation_tensorflow_tpu_torch.infer import (
        ExportedPredictor, Predictor, export_model,
    )
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    img = np.random.default_rng(0).integers(0, 256, (2, 40, 70, 3), np.uint8)
    for name, kw, counters in (
            ("fcn8s", dict(fc_features=32, width_mult=0.25),
             (stage1_tail, argmax_colormap_overlay_cuda)),
            ("segnet", dict(width_mult=0.25),
             (stage1_tail_segnet, pool_argmax, unpool, argmax_colormap_overlay_cuda))):
        model = build_model(name, 2, device="cuda", **kw)
        init_params(model, torch.Generator(device="cuda").manual_seed(0))
        path = str(tmp_path / f"{name}.segx")
        twin = build_model(name, 2, device="cuda", **kw)
        twin.load_state_dict(model.state_dict())
        meta = export_model(twin, (40, 70), path, platforms=("cuda",))
        assert meta["batch_mode"] == "symbolic"
        art = ExportedPredictor(path, "cuda")
        before = [c.launches for c in counters]
        ov, lab = art(img)
        labels = art._fetch_labels(img)
        assert all(c.launches > b for c, b in zip(counters, before)), name
        pred = Predictor(model, (40, 70), device="cuda")
        want_ov, want_lab = pred(img)
        assert np.array_equal(ov, want_ov) and np.array_equal(lab, want_lab)
        assert np.array_equal(labels, pred._fetch_labels(img))


# the Predictor's CUDA graphs: one per (entry, batch), captured at a key's
# second call and replayed after

GRAPH_MODELS = {
    "fcn8s": ("fcn8s", 2, dict(fc_features=32, width_mult=0.25), False),
    "segnet": ("segnet", 2, dict(width_mult=0.25), False),
    "segnet_bn": ("segnet", 2, dict(width_mult=0.25, use_bn=True), False),
    "unet": ("unet", 19, dict(base_features=8), False),
    "deeplab": ("deeplab", 2, dict(width_mult=0.25, aspp_features=16), False),
    "fcn8s_f2": ("fcn8s", 2, dict(fc_features=32, width_mult=0.5, winograd="f2"),
                 False),
    "fcn8s_int8": ("fcn8s", 2, dict(fc_features=32, width_mult=0.25), True),
}
GRAPH_HW = (40, 70)


def _graph_predictor(name):
    """A narrow model of ``GRAPH_MODELS[name]`` on the card in a Predictor
    (int8: quantized, calibrated on one seeded batch, as ``--int8``)."""
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
        normalize_images,
    )
    from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor, quant
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
        build_model, merge_quant_safe_kwargs,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.shape import pad_to_multiple

    arch, classes, kw, int8 = GRAPH_MODELS[name]
    if int8:
        kw = merge_quant_safe_kwargs(arch, dict(kw))
    model = build_model(arch, classes, device="cuda", **kw)
    init_params(model, torch.Generator(device="cuda").manual_seed(0))
    mean, std = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)
    if int8:
        calib = np.random.default_rng(9).integers(0, 256, (2, *GRAPH_HW, 3), np.uint8)
        x = pad_to_multiple(normalize_images(torch.from_numpy(calib).cuda(), mean,
                                             std), getattr(model, "total_stride", 32))
        model, scales = quant.quantize_for_inference(model, [x])
        assert scales
    palette = CITYSCAPES_PALETTE if classes == 19 else KITTI_OVERLAY_PALETTE
    return Predictor(model, GRAPH_HW, device="cuda", overlay_palette=palette)


@pytest.fixture
def strict_capture(monkeypatch):
    """Every capture runs under ``set_sync_debug_mode("error")``: a sync in
    the captured work raises."""
    from semanticsegmentation_tensorflow_tpu_torch.infer.predict import Predictor

    real = Predictor._capture

    def strict(self, *args):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(Predictor, "_capture", strict)


@pytest.mark.parametrize("name", list(GRAPH_MODELS))
def test_predictor_graph_replays_equal_the_eager_internals_on_card(
        gen, strict_capture, name):
    """Each entry's replays (``__call__``'s overlay and labels, the fetched
    label map from host frames and from device tensors, the confidence)
    equal the eager internals on the same frames bit for bit, with batches 1
    and 3 called in turn on one Predictor (one graph pool), every capture
    free of syncs, and every call launching what the key's eager call did."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import launch_counters
    from semanticsegmentation_tensorflow_tpu_torch.ops.labelpack import unpack_labels

    pred = _graph_predictor(name)
    binary = pred.model.num_classes == 2
    rng = np.random.default_rng(1)
    launched: dict = {}
    calls = 0
    for step in range(3):
        for n in (1, 3):
            img = rng.integers(0, 256, (n, *GRAPH_HW, 3), np.uint8)
            x = torch.from_numpy(img).cuda()
            before = {w: w.launches for w in launch_counters()}
            ov, lab = pred(img)
            got = {w.__name__: w.launches - b for w, b in before.items()
                   if w.launches != b}
            assert got and got == launched.setdefault(n, got), (step, n)
            want_ov, want_lab = (t.cpu().numpy() for t in pred._fwd(x))
            assert np.array_equal(ov, want_ov) and np.array_equal(lab, want_lab)
            want = unpack_labels(pred._packed_labels(x).cpu().numpy(),
                                 GRAPH_HW[1], pred._pack_mode)
            assert np.array_equal(pred._fetch_labels(img), want)
            assert np.array_equal(pred._fetch_labels(x), want)
            assert np.array_equal(want, lab)
            calls += 3
            if binary:
                assert np.array_equal(pred.confidence(img),
                                      pred._confidence(x).cpu().numpy())
                calls += 1
    keys = 2 * (3 if binary else 2)        # entries x batches
    assert (pred.graph_captures, pred.graph_replays) == (keys, calls - keys)


def test_predictor_graph_counts_and_launches_on_card(gen):
    """One eager call, one capture, then replays, one of each per call;
    kernels 1 and 2 counted once a call throughout."""
    from semanticsegmentation_tensorflow_tpu_torch.infer import predict

    pred = _graph_predictor("fcn8s")
    img = np.random.default_rng(2).integers(0, 256, (*GRAPH_HW, 3), np.uint8)
    counts = []
    for _ in range(5):
        before = stage1_tail.launches, argmax_colormap_overlay_cuda.launches
        pred(img)
        counts.append((stage1_tail.launches - before[0],
                       argmax_colormap_overlay_cuda.launches - before[1],
                       pred.graph_captures, pred.graph_replays))
    assert counts == [(1, 1, 0, 0), (1, 1, 1, 1), (1, 1, 1, 2), (1, 1, 1, 3),
                      (1, 1, 1, 4)]
    assert list(pred._graphs) == [("overlay", 1)]
    assert isinstance(pred._graphs[("overlay", 1)], predict._Graph)


def test_predictor_graph_serves_threads_their_own_answers_on_card(gen):
    """Two threads calling ``_fetch_labels`` on one Predictor at once, each
    with its own frame, each get their frame's label map every time."""
    import threading

    pred = _graph_predictor("fcn8s")
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (1, *GRAPH_HW, 3), np.uint8) for _ in range(2)]
    want = [pred._fetch_labels(f) for f in frames]        # eager, then capture
    assert not np.array_equal(want[0], want[1])
    got: dict = {0: [], 1: []}
    errors = []

    def serve(i):
        try:
            for _ in range(25):
                got[i].append(pred._fetch_labels(frames[i]))
        except Exception as e:                            # raised below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for i in range(2):
        assert len(got[i]) == 25
        assert all(np.array_equal(g, want[i]) for g in got[i])
    assert (pred.graph_captures, pred.graph_replays) == (1, 51)
