"""``remat``, one recompute per stage (``train/step.py``, ``models.common.region``)
on the CPU, at narrow widths.

The remat step equals the step without it bit for bit on all four families
(FCN-8s and DeepLab with dropout, SegNet with BatchNorm, U-Net), and each
recompute in the backward packs exactly the activations its own region saved
in the forward, never the whole model's (a ``saved_tensors_hooks`` count of
the forward's regions beside one of the backward's recomputes).
"""

import numpy as np
import pytest
import torch
import torch.utils.checkpoint as cp

from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    init_params, remat_regions,
)
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.train import step as step_mod
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

from torch_parity import draw_bn_state

HW = (32, 64)
FAMILIES = {
    # name: (model kwargs, regions of one forward)
    "fcn8s": (dict(fc_features=32, width_mult=0.25), 6),        # 5 stages, fc6/fc7
    "deeplab": (dict(width_mult=0.125, aspp_features=16), 7),   # + the ASPP head
    "segnet": (dict(width_mult=0.25, use_bn=True), 10),         # 5 enc, 5 dec
    "unet": (dict(base_features=8, depth=3), 7),                # 3 down, 1, 3 up
}


def _model(name):
    kw, _ = FAMILIES[name]
    model = build_model(name, 2, device="cpu", dtype=torch.float32, **kw)
    init_params(model, torch.Generator().manual_seed(0))
    if kw.get("use_bn"):
        draw_bn_state(model, seed=1, params=True)
    return model.train()


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.normal(size=(n, *HW, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 2, (n, *HW)).astype(np.int32)),
            "valid": torch.from_numpy(rng.random((n, *HW)) > 0.1)}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_remat_step_equals_plain_step(name):
    """Two Adam steps with and without remat: the same losses, parameters,
    buffers (BatchNorm's running statistics) and dropout generator state,
    bit for bit."""
    def run(remat):
        model = _model(name)
        st = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                                make_lr_schedule(1e-3), seed=0)
        step = make_train_step(2, remat=remat)
        return st, [step(st, _batch(s))["loss"].item() for s in range(2)]

    plain, lp = run(False)
    rem, lr_ = run(True)
    assert lp == lr_
    for (k, a), b in zip(plain.model.state_dict().items(),
                         rem.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(plain.dropout_gen.get_state(), rem.dropout_gen.get_state())


def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_each_recompute_packs_only_its_own_region(name, monkeypatch):
    """The bytes each region saves for the backward in a plain forward
    (its own ``saved_tensors_hooks``), against the bytes each recompute of
    the remat step packs (``torch.utils.checkpoint``'s recompute hook,
    counted): one recompute per region, each packing one region's
    activations; the largest is less than the model's total, which the one
    recompute of a whole-model checkpoint packed."""
    _, n_regions = FAMILIES[name]
    batch = _batch(3)
    model = _model(name)

    own = []

    def count(fn, *args):
        own.append(0)

        def pack(t):
            own[-1] += _nbytes(t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return fn(*args)

    gen = torch.Generator().manual_seed(5)
    with remat_regions(count):
        model(batch["image"], generator=gen)

    recomputed = []

    class Counting(cp._recomputation_hook):
        def __init__(self, frame, gid):
            super().__init__(frame, gid)
            inner = self.pack_hook
            recomputed.append(0)

            def pack(t):
                recomputed[-1] += _nbytes(t)
                return inner(t)

            self.pack_hook = pack

    monkeypatch.setattr(cp, "_recomputation_hook", Counting)
    gen = torch.Generator().manual_seed(5)
    logits = step_mod._remat_forward(model, batch["image"], gen)
    logits.float().square().sum().backward()

    assert len(own) == len(recomputed) == n_regions
    assert sorted(recomputed) == sorted(own)
    assert max(recomputed) < sum(own)
