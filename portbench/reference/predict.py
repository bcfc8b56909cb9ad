"""A served frame, in plain float32: normalized, padded at the bottom and
right by its edge pixels to the model's stride, the forward, cropped back;
and the overlay that the served labels make over the frame.

The numbers that judge a served answer (frame, overlay, labels), from the
reference's margin ``m`` between its best and second-best class at each
pixel and the ``gap`` at each pixel by which the reference's logit of the
served label lies below the reference's best:

- ``tie_gap``: the gaps summed over the frame, per pixel whose ``|m|`` is
  under 5 % of ``m``'s standard deviation (a near tie), in units of that
  standard deviation. Rounding flips labels only near ties, and the summed
  gap grows with the square of the rounding; dividing by the near ties
  makes frames with few and with many of them alike.
- ``overlay_diff``: the largest byte difference between the served overlay
  and the reference's blend of the frame under the served labels (class 0
  keeps the pixel; others ``pixel * (1 - alpha) + colour * alpha`` in
  float32, clipped and truncated to uint8): an exact comparison.
- ``label_gap`` (the widest gap over ``m``'s root mean square) and
  ``flip_share`` (the share of pixels whose served label is not the
  reference's; ties to the lowest class): reported, not compared.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import layers
from portbench.reference.models import find


def logits(cfg: dict, p: dict, image_u8: np.ndarray, device) -> torch.Tensor:
    """[H,W,C] float32 logits of one frame."""
    h, w = image_u8.shape[:2]
    mean = torch.tensor(cfg["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(cfg["std"], dtype=torch.float32, device=device)
    x = (torch.from_numpy(image_u8).to(device).float() - mean) / std
    model = find(cfg["model"])
    m = model.stride(cfg)
    x = F.pad(x.permute(2, 0, 1)[None], (0, -w % m, 0, -h % m), mode="replicate")
    with torch.no_grad(), layers.exact_f32():
        y = model.forward(cfg, p, x.permute(0, 2, 3, 1))
    return y[0, :h, :w]


def blend(image_u8: np.ndarray, labels: np.ndarray, palette: np.ndarray,
          alpha: float) -> np.ndarray:
    img = image_u8.astype(np.float32)
    colours = palette.astype(np.float32)[labels]
    out = img * np.float32(1.0 - alpha) + colours * np.float32(alpha)
    out = np.where((labels == 0)[..., None], img, out)
    return np.clip(out, 0, 255).astype(np.uint8)


def judge(ref_logits: torch.Tensor, image_u8: np.ndarray, overlay: np.ndarray,
          labels: np.ndarray, palette: np.ndarray, alpha: float) -> dict:
    """The numbers of one served answer (module docstring)."""
    ref = ref_logits.float()
    lab = torch.from_numpy(np.ascontiguousarray(labels)).to(ref.device).long()
    best = ref.max(-1).values
    gap = best - ref.gather(-1, lab.unsqueeze(-1)).squeeze(-1)
    two = ref.topk(2, dim=-1).values
    m = two[..., 0] - two[..., 1]
    sd = m.std().clamp(min=1e-30)
    ties = (m < 0.05 * sd).sum().clamp(min=1)
    want = blend(image_u8, np.asarray(labels), palette, alpha)
    return {"tie_gap": float(gap.sum() / ties / sd),
            "overlay_diff": int(np.abs(overlay.astype(np.int16)
                                       - want.astype(np.int16)).max()),
            "label_gap": float(gap.max() / m.pow(2).mean().sqrt().clamp(min=1e-30)),
            "flip_share": float((ref.argmax(-1) != lab).float().mean())}
