"""Per-pixel softmax cross-entropy and focal loss in masked SUM form
(counterpart of the JAX package's ``train/loss.py``).

The sum form (loss sum, valid-pixel count) lets the step divide once by the
total valid count, so microbatched and full-batch training agree up to
summation order. Labels are integer class ids; invalid pixels (stride
padding, KITTI's ignore region) contribute zero loss and zero gradient.
"""

from __future__ import annotations

import numpy as np
import torch


def _log_pt(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[label] per pixel: [N,H,W,C], [N,H,W] -> [N,H,W]."""
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


def _masked_sum(per_pixel: torch.Tensor, labels: torch.Tensor,
                valid_mask: torch.Tensor | None,
                class_weights: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    if class_weights is not None:
        w = torch.as_tensor(class_weights, dtype=per_pixel.dtype,
                            device=per_pixel.device)
        per_pixel = per_pixel * w[labels.long()]
    if valid_mask is None:
        return per_pixel.sum(), torch.tensor(float(per_pixel.numel()),
                                             device=per_pixel.device)
    valid = valid_mask.to(per_pixel.dtype)
    return (per_pixel * valid).sum(), valid.sum()


def softmax_cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                              valid_mask: torch.Tensor | None = None,
                              class_weights: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked per-pixel CE, number of valid pixels).

    logits [N,H,W,C] float32, labels [N,H,W] class ids, valid_mask [N,H,W]
    {0,1}. ``class_weights`` [C] scales each pixel's CE by its true class's
    weight; the count stays the unweighted valid-pixel count (weighted sum /
    pixel count), so all-ones weights equal none."""
    return _masked_sum(-_log_pt(logits, labels), labels, valid_mask,
                       class_weights)


def focal_loss_sum(logits: torch.Tensor, labels: torch.Tensor,
                   valid_mask: torch.Tensor | None = None,
                   class_weights: torch.Tensor | None = None,
                   gamma: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Focal loss ``-(1 - p_t)^gamma log(p_t)`` (Lin et al.) in the same
    masked sum form; ``gamma=0`` is plain CE."""
    logpt = _log_pt(logits, labels)
    f = -logpt
    if gamma:
        f = f * (1.0 - torch.exp(logpt)) ** gamma
    return _masked_sum(f, labels, valid_mask, class_weights)


def median_frequency_weights(class_pixel_counts) -> torch.Tensor:
    """Median-frequency balancing weights (Eigen & Fergus; the SegNet
    paper's class balancing): ``w_c = median(freq) / freq_c``; classes
    absent from the counts get 0. Returns float32 [C] on the CPU."""
    counts = np.asarray(class_pixel_counts, np.float64)
    total = counts.sum()
    if total <= 0:
        raise ValueError("class_pixel_counts sums to zero")
    freq = counts / total
    present = freq > 0
    med = np.median(freq[present])
    w = np.zeros_like(freq)
    w[present] = med / freq[present]
    return torch.tensor(w, dtype=torch.float32)
