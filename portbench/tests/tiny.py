"""A cell cut to a size the CPU runs in seconds, for the tests: an eighth of
VGG16's widths, fc6/fc7 32 wide, 2 images of 64x128 crops from 75x142 frames,
and the program's convolutions in float32. The limits are the cell's, set
for bf16 at full width; in float32 a sound run reads far under them, so a
tiny run shows the harness and the faults alone, not the rounding of
layers eight times narrower."""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def shrink(unit: dict) -> dict:
    cfg, traffic = unit["cfg"], unit["traffic"]
    import torch

    cfg["model_kwargs"] = dict(cfg["model_kwargs"], width_mult=0.125,
                               fc_features=32, dtype=torch.float32)
    cfg.update(crop_size=[64, 128], batch_size=2)
    traffic.update(frames=10, frame_hw=[75, 142], traced_tail=3)
    if traffic["kind"] == "frames":
        traffic.update(frames=4, warmup_requests=2, checked_answers=3)
    return unit
