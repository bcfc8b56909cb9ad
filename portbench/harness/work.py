"""Operations and bytes of the measured work, and the peaks of one NVIDIA
H100 SXM that shares of a roofline are taken against.

A model's FLOPs are what ``torch.utils.flop_counter`` counts in its plain
reference (``portbench/reference/models/<model>.py``) run on the meta
device: 2 per multiply-add of the convolutions and matrix products
(transposed convolutions per input pixel); pools, activations, the loss
and the optimizer are not counted. A training step counts the forward and
the backward of the reference with the image needing no gradient, so the
first layer's input gradient is left out. A kernel's work is counted from
its shapes; bytes count each input read once and each output written once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.models import find

# NVIDIA's published H100 SXM figures: dense bf16 tensor-core FLOP/s, HBM3
# bytes/s (at the card's full 700 W)
PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def conv_flops(n: int, h: int, w: int, cin: int, cout: int, k: int) -> float:
    """A SAME stride-1 conv's forward on n x h x w outputs."""
    return 2.0 * n * h * w * cin * cout * k * k


def param_shape(cfg: dict, name: str) -> tuple[int, ...]:
    """The shape of parameter ``name`` of ``cfg``'s reference model."""
    return next(s for k, s, _ in find(cfg["model"]).param_specs(cfg) if k == name)


def counted_flops(cfg: dict, n: int, h: int, w: int, train: bool) -> float:
    """The reference's FLOPs on n images of h x w (multiples of the
    stride): its forward, and with ``train`` its backward too."""
    model = find(cfg["model"])
    p = {k: torch.empty(s, device="meta", requires_grad=train)
         for k, s, _ in model.param_specs(cfg)}
    x = torch.empty((n, h, w, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        if train:
            masks = [torch.empty(s, device="meta", dtype=torch.bool)
                     for s in model.mask_shapes(cfg, n, h, w)]
            model.forward(cfg, p, x, masks).sum().backward()
        else:
            with torch.no_grad():
                model.forward(cfg, p, x)
    return float(counter.get_total_flops())


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """One image's forward at h x w (already a multiple of the stride)."""
    return counted_flops(cfg, 1, h, w, train=False)


def train_step_flops(cfg: dict, n: int, h: int, w: int) -> float:
    """One training step of n images at h x w: forward, weight gradients,
    and input gradients of every layer but the first."""
    return counted_flops(cfg, n, h, w, train=True)


def fc6_work(cfg: dict, n: int, h: int, w: int) -> tuple[float, float]:
    """(bytes, FLOPs) of fc6 (``vgg16.conv6``) with its bias and relu,
    forward and both gradients, at an n x h x w input (fc6's own grid).
    Bytes: the bf16 input, output gradient, output and input gradient; the
    f32 kernel and bias read and their gradients written."""
    fc, cin, k, _ = param_shape(cfg, "vgg16.conv6.weight")
    flops = 3 * conv_flops(n, h, w, cin, fc, k)
    acts = 2 * n * h * w * (cin + fc) * 2
    params = 4 * (fc * cin * k * k + fc) * 2
    return acts + params, flops


def stage1_work(n: int, h: int, w: int, c: int = 64) -> tuple[float, float]:
    """(bytes, FLOPs) of VGG16's first stage (conv1_1, conv1_2, pool, biases,
    relus; c features) forward and backward on n f32 images of h x w x 3: conv1_1's
    forward and weight gradient, conv1_2's forward and both gradients.
    Bytes: the f32 image read, the bf16 pooled output written and its
    gradient read, the f32 parameters read and their gradients written."""
    p = n * h * w
    flops = 2 * conv_flops(n, h, w, 3, c, 3) + 3 * conv_flops(n, h, w, c, c, 3)
    params = 4 * (c * 3 * 9 + c + c * c * 9 + c) * 2
    return 12 * p + 2 * (2 * p * c // 4) + params, flops


def overlay_bytes(n: int, h: int, w: int, c: int) -> float:
    """The overlay's bytes: f32 logits of the image's window and the u8
    image read, the u8 overlay and the int32 labels written (18 B/px at
    C=2)."""
    return n * h * w * (4 * c + 10)


def roofline_pct(nbytes: float, flops: float, seconds: float) -> float:
    """100 x the least time the card could take (the larger of bytes over
    HBM bandwidth and FLOPs over the bf16 peak) over ``seconds``."""
    least = max(nbytes / PEAK_HBM_BYTES_S, flops / PEAK_BF16_FLOP_S)
    return 100.0 * least / seconds


def mfu_pct(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAK_BF16_FLOP_S
