"""Segmentation metrics: confusion matrix -> mIoU / pixel accuracy, and the
KITTI road devkit measures from a road-confidence histogram (counterpart of
the JAX package's ``train/metrics.py``)."""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(true_labels: torch.Tensor, pred_labels: torch.Tensor,
                     num_classes: int,
                     valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """[C, C] int64 counts, rows = true class, cols = predicted class.

    One integer scatter-add over ``true * C + pred`` (a bincount), exact at
    any pixel count; invalid pixels land in a spill bin that is dropped.
    No host synchronization."""
    c = num_classes
    idx = (true_labels.reshape(-1).long() * c + pred_labels.reshape(-1).long())
    if valid_mask is not None:
        idx = torch.where(valid_mask.reshape(-1).bool(), idx, c * c)
    counts = torch.zeros(c * c + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts[:c * c].reshape(c, c)


def binary_confidence_histogram(prob_fg: torch.Tensor, gt_fg: torch.Tensor,
                                valid_mask: torch.Tensor | None = None,
                                bins: int = 256) -> torch.Tensor:
    """[2, bins] int64 counts of foreground-confidence bins, row = GT class
    (0 background, 1 foreground). A pixel's bin is ``clip(floor(p * bins),
    0, bins - 1)`` of its f32 probability: the uint8 confidence map the
    KITTI road devkit sweeps. One integer scatter-add over ``gt * bins +
    bin``, as :func:`confusion_matrix`, exact at any pixel count."""
    b = torch.floor(prob_fg.reshape(-1).float() * bins).clamp(0, bins - 1).long()
    idx = gt_fg.reshape(-1).long() * bins + b
    if valid_mask is not None:
        idx = torch.where(valid_mask.reshape(-1).bool(), idx, 2 * bins)
    counts = torch.zeros(2 * bins + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts[:2 * bins].reshape(2, bins)


def kitti_road_metrics(hist) -> dict[str, float]:
    """KITTI road devkit measures from a [2, bins] confidence histogram (a
    numpy copy of the JAX package's host-side finish). For every threshold
    ``k / bins`` (road iff the bin >= k, k = 0..bins) suffix sums give the
    exact TP/FP counts; ``maxf`` is the best F1 over the sweep, ``ap`` the
    11-point interpolated average precision, and ``precision`` /
    ``recall`` / ``fpr`` / ``fnr`` / ``threshold`` the working point where
    F1 peaks. No positive or no valid pixel returns zeros."""
    if isinstance(hist, torch.Tensor):
        hist = hist.cpu().numpy()
    hist = np.asarray(hist, np.int64)
    neg, pos = hist[0], hist[1]
    n_pos, n_neg = int(pos.sum()), int(neg.sum())
    bins = hist.shape[1]
    if n_pos == 0 or (n_pos + n_neg) == 0:
        return {k: 0.0 for k in ("maxf", "ap", "precision", "recall",
                                 "fpr", "fnr", "threshold")}
    # k = bins (predict nothing) closes the PR curve at recall 0
    tp = np.concatenate([np.cumsum(pos[::-1])[::-1], [0]]).astype(np.float64)
    fp = np.concatenate([np.cumsum(neg[::-1])[::-1], [0]]).astype(np.float64)
    fn = n_pos - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        recall = tp / n_pos
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    k = int(np.argmax(f1))
    ap = float(np.mean([precision[recall >= r].max(initial=0.0)
                        for r in np.linspace(0.0, 1.0, 11)]))
    return {"maxf": float(f1[k]), "ap": ap, "precision": float(precision[k]),
            "recall": float(recall[k]),
            "fpr": float(fp[k] / n_neg) if n_neg else 0.0,
            "fnr": float(fn[k] / n_pos), "threshold": k / bins}


def iou_from_confusion(cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-class IoU [C], mIoU over classes present in true or pred)."""
    cm = cm.to(torch.float64 if cm.dtype == torch.int64 else torch.float32)
    tp = torch.diagonal(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    iou = torch.where(denom > 0, tp / denom.clamp(min=1.0), 0.0)
    present = (denom > 0).to(iou.dtype)
    return iou, (iou * present).sum() / present.sum().clamp(min=1.0)


class SegMetrics:
    """Accumulating metric state: confusion matrix, loss sum, step count
    (tensors, so accumulation does not synchronize with the device)."""

    def __init__(self, num_classes: int, device=None):
        self.cm = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                              device=device)
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        self.count = 0

    def update(self, cm: torch.Tensor | None, loss: torch.Tensor) -> None:
        """Add one step; ``cm`` None for a loss-only step."""
        if cm is not None:
            self.cm = self.cm + cm.to(self.cm.device)
        self.loss_sum = self.loss_sum + loss.detach().to(self.loss_sum.device)
        self.count += 1

    def summary(self) -> dict[str, torch.Tensor]:
        iou, miou = iou_from_confusion(self.cm)
        acc = torch.diagonal(self.cm).sum() / self.cm.sum().clamp(min=1)
        return {"loss": self.loss_sum / max(self.count, 1), "miou": miou,
                "pixel_acc": acc, "iou": iou}
