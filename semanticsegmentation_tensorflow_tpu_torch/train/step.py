"""The train step (counterpart of the JAX package's ``train/step.py``).

One step: per microbatch, augment, forward in ``train()`` mode (dropout from
the state's generator), the masked loss in SUM form and its backward, which
accumulates into ``.grad``; then one divide of the gradients by the total
valid-pixel count (``max(valid_sum, 1)``), the optimizer update and the EMA.
Keeping the loss a sum until that single divide makes ``grad_accum=k`` equal
the full-batch step up to summation order.

With a grid of ranks (``mesh``, a ``parallel.mesh.Grid``: each rank holds its
images and rows of the batch) the step runs with the grid active
(``parallel.mesh.use_grid``: the convs exchange halo rows, dropout and the
augment draw for the global batch), then the local loss sums, every
gradient and the confusion matrix get one ``all_reduce(SUM)`` over the
world before the single divide, so the grid step equals the single-process
step up to summation order and the update is the same on every rank.

Batch contract (leading dim = batch): image [N,H,W,3] (uint8 with an
augment function, or float32 already normalized), label [N,H,W] class ids,
valid [N,H,W] bool (optional).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.distributed as dist

from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import use_grid
from semanticsegmentation_tensorflow_tpu_torch.train.loss import (
    focal_loss_sum, softmax_cross_entropy_sum,
)
from semanticsegmentation_tensorflow_tpu_torch.train.metrics import confusion_matrix
from semanticsegmentation_tensorflow_tpu_torch.train.state import TrainState

AugmentFn = Callable[[torch.Generator, dict], dict]  # (generator, batch) -> batch


def make_train_step(num_classes: int, mesh=None,
                    augment_fn: AugmentFn | None = None, remat: bool = False,
                    with_metrics: bool = True, class_weights=None,
                    grad_accum: int = 1, shard_opt: bool = False,
                    loss: str = "ce", focal_gamma: float = 2.0) -> Callable:
    """Build ``step(state, batch) -> {"loss", "cm"}`` (``cm``, the [C, C]
    train-time confusion matrix, only ``with_metrics``). The step updates
    ``state`` in place. ``mesh``: a ``parallel.mesh.Grid`` (module
    docstring); the batch holds this rank's images and rows. ``shard_opt``
    and ``remat`` are not ported yet and raise."""
    if shard_opt or remat:
        raise NotImplementedError("shard_opt and remat are not ported yet")
    if loss == "ce":
        loss_sum_fn = softmax_cross_entropy_sum
    elif loss == "focal":
        loss_sum_fn = partial(focal_loss_sum, gamma=focal_gamma)
    else:
        raise ValueError(f"unknown loss {loss!r} (ce | focal)")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch: dict) -> dict:
        n = batch["label"].shape[0]
        if n % grad_accum:
            raise ValueError(f"grad_accum={grad_accum} must divide the batch {n}")
        model = state.model
        weights = (None if class_weights is None else
                   torch.as_tensor(class_weights, dtype=torch.float32,
                                   device=state.device))
        for p in model.parameters():
            p.grad = None
        ce_total = torch.zeros((), device=state.device)
        valid_total = torch.zeros((), device=state.device)
        cm = None
        k = n // grad_accum
        for i in range(grad_accum):
            mb = {key: v[i * k:(i + 1) * k] for key, v in batch.items()}
            with use_grid(mesh):
                if augment_fn is not None:
                    mb = augment_fn(state.aug_gen, mb)
                logits = model(mb["image"], generator=state.dropout_gen)
                ce_sum, valid_sum = loss_sum_fn(logits, mb["label"],
                                                mb.get("valid"), weights)
                ce_sum.backward()
            ce_total += ce_sum.detach()
            valid_total += valid_sum
            if with_metrics:
                mcm = confusion_matrix(mb["label"], logits.detach().argmax(-1),
                                       num_classes, mb.get("valid"))
                cm = mcm if cm is None else cm + mcm
        if mesh is not None and mesh.world > 1:
            ce_total, valid_total, cm = _all_reduce(model, ce_total, valid_total,
                                                    cm)
        denom = valid_total.clamp(min=1.0)
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(denom)
        state.apply_gradients()
        out = {"loss": ce_total / denom}
        if with_metrics:
            out["cm"] = cm
        return out

    return step


def _all_reduce(model, ce_total, valid_total, cm):
    """One SUM over the world of the loss sums and every gradient (a
    parameter without one gets zeros), and one of the confusion matrix."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    with torch.profiler.record_function("grid_all_reduce"):
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [ce_total.reshape(1), valid_total.reshape(1)])
        dist.all_reduce(flat)
        if cm is not None:
            dist.all_reduce(cm)
    off = 0
    for p in params:
        p.grad.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()
    return flat[off], flat[off + 1], cm
