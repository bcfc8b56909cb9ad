"""The work counters against hand formulas and PyTorch's FLOP counter, and
the plain reference against the port at a small size on the CPU (the port
run in float32, ``tests/tiny.py``, so that only the order of summation
differs)."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import inputs, work
from portbench.harness.runner import load_cell
from portbench.reference import predict
from portbench.reference import train as ref_train
from portbench.reference.models import find
from portbench.tests.tiny import ROOT, shrink

CELLS = ("fcn8s_parity.train",)


def _cfg(cell: str, tiny: bool = True) -> dict:
    unit = load_cell(ROOT, cell)
    return (shrink(unit) if tiny else unit)["cfg"]


def test_vgg16_and_fc6_hand_formula():
    """The counted forward and step of FCN-8s at its published widths equal
    the hand formula: VGG16's 3x3 convs, fc6, fc7, the scores and the
    transposed convs (2 FLOPs per multiply-add, a transposed conv's per
    input pixel); a step three times the forward, less the first layer's
    input gradient."""
    cfg = _cfg("fcn8s_parity.train", tiny=False)
    h, w = 64, 96
    widths = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
              (256, 256), (256, 512), (512, 512), (512, 512), (512, 512),
              (512, 512), (512, 512)]
    stage_of = [1, 1, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5]
    vgg = sum(2 * (h >> (s - 1)) * (w >> (s - 1)) * ci * co * 9
              for (ci, co), s in zip(widths, stage_of))
    px = {s: (h // s) * (w // s) for s in (8, 16, 32)}
    fc6 = 2 * px[32] * 512 * 4096 * 49
    heads = (2 * px[32] * 4096 * 4096 + 2 * px[32] * 4096 * 2
             + 2 * px[16] * 512 * 2 + 2 * px[32] * 2 * 2 * 16
             + 2 * px[8] * 256 * 2 + 2 * px[16] * 2 * 2 * 16
             + 2 * px[8] * 2 * 2 * 256)
    fwd = vgg + fc6 + heads
    assert work.forward_flops(cfg, h, w) == fwd
    first = 2 * h * w * 3 * 64 * 9
    assert work.train_step_flops(cfg, 2, h, w) == 2 * (3 * fwd - first)
    nbytes, flops = work.fc6_work(cfg, 8, 10, 36)
    assert flops == 3 * 2 * 8 * 10 * 36 * 512 * 4096 * 49
    assert nbytes == 2 * 8 * 360 * (512 + 4096) * 2 + 4 * (4096 * 512 * 49 + 4096) * 2
    s_bytes, s_flops = work.stage1_work(8, 320, 1152)
    p = 8 * 320 * 1152
    assert s_flops == 2 * 2 * p * 3 * 64 * 9 + 3 * 2 * p * 64 * 64 * 9
    assert s_bytes == 12 * p + 64 * p + 4 * (64 * 27 + 64 + 64 * 576 + 64) * 2
    assert work.overlay_bytes(1, 375, 1242, 2) == 375 * 1242 * 18


@pytest.mark.parametrize("cell", CELLS)
def test_meta_count_is_a_real_runs(cell):
    """Counted on the meta device, the forward and the step are what the
    FLOP counter sees a real run of the reference do."""
    cfg = _cfg(cell)
    model = find(cfg["model"])
    n, (h, w) = 2, (64, 128)
    p = {k: v.requires_grad_() for k, v in inputs.make_weights(
        torch, model.param_specs(cfg), 0, "cpu").items()}
    x = torch.randn(n, h, w, 3)
    masks = [torch.rand(s) < 0.5 for s in model.mask_shapes(cfg, n, h, w)]
    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            model.forward(cfg, p, x)
    assert fwd.get_total_flops() == n * work.forward_flops(cfg, h, w)
    with FlopCounterMode(display=False) as step:
        model.forward(cfg, p, x, masks).sum().backward()
    assert step.get_total_flops() == work.train_step_flops(cfg, n, h, w)


def test_an_unknown_model_has_no_reference():
    cfg = dict(_cfg("fcn8s_parity.train"), model="segnet")
    with pytest.raises(ValueError, match="no reference model"):
        work.forward_flops(cfg, 64, 64)
    with pytest.raises(ValueError, match="no reference model"):
        find("../harness/work")


def test_reference_batches_are_the_loaders():
    """Over three epochs, the batches the reference works out from the seed
    are those ``BatchLoader`` yields."""
    from portbench.kinds.train import FrameSet
    from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import BatchLoader

    images = np.zeros((11, 4, 4, 3), np.uint8)
    images[:, 0, 0, 0] = np.arange(11)
    data = FrameSet(images, np.zeros((11, 4, 4), np.int32))
    loader = BatchLoader(data, 3, pad_multiple=4, seed=2147483641, device="cpu")
    got = []
    for _ in range(3):
        for b in loader.epoch():
            got.append([f"frame_{int(i):04d}" for i in b["image"][:, 0, 0, 0]])
    want = ref_train.batches(data.train_images, 2147483641, 3, 0, 9)
    assert got == want
    assert ref_train.batches(data.train_images, 2147483641, 3, 4, 4) == want[4:8]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_forward_matches_port(cell):
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

    cfg = _cfg(cell)
    model = find(cfg["model"])
    weights = inputs.make_weights(torch, model.param_specs(cfg), 3, "cpu")
    port = build_model(cfg["model"], num_classes=2, device="cpu",
                       **cfg["model_kwargs"]).eval()
    port.load_state_dict(weights, strict=True)
    x = torch.randn(2, 64, 128, 3)
    with torch.no_grad():
        got = port(x)
        want = model.forward(cfg, weights, x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_port_training(cell):
    """Three steps of the port's train step (in float32) and of the
    reference agree to summation order: at set-up, and four times again
    from the seed's state after six more steps, over batches across
    epochs."""
    from portbench.kinds.train import Mix

    unit = shrink(load_cell(ROOT, cell))
    mix = Mix(torch, unit["cfg"], unit["traffic"], 11, [torch.device("cpu")])
    mix.build()
    mix.first_steps()
    mix.run_units(6)
    mix.after_window()
    runs = mix.runs
    assert [r["first_batch"] for r in runs] == [0, 9, 12, 15, 18]
    mix.release()
    got = mix.readings()
    assert len(mix.info["runs"]) == 5
    assert got["loss_steps"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-2


def test_blend_matches_port_overlay():
    from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
        KITTI_OVERLAY_PALETTE,
    )
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import (
        argmax_colormap_overlay,
    )

    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (1, 30, 40, 3), generator=g, dtype=torch.uint8)
    logits = torch.randn((1, 30, 40, 2), generator=g)
    overlay, labels = argmax_colormap_overlay(img, logits, KITTI_OVERLAY_PALETTE, 0.5)
    want = predict.blend(img[0].numpy(), labels[0].numpy(), KITTI_OVERLAY_PALETTE, 0.5)
    assert np.array_equal(overlay[0].numpy(), want)
    got = predict.judge(logits[0], img[0].numpy(), overlay[0].numpy(),
                        labels[0].numpy(), KITTI_OVERLAY_PALETTE, 0.5)
    assert got == {"tie_gap": 0.0, "overlay_diff": 0, "label_gap": 0.0,
                   "flip_share": 0.0}
