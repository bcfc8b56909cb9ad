"""Segmentation metrics: confusion matrix -> mIoU / pixel accuracy
(counterpart of the JAX package's ``train/metrics.py``)."""

from __future__ import annotations

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
