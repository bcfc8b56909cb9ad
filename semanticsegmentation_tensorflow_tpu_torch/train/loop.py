"""The training loop: epochs x batches, metrics, checkpoints, and validation
with keep-best (counterpart of the JAX package's ``train/loop.py``).

The loop body only enqueues device work: metrics accumulate as device
tensors, and the host reads a value only at the logging cadence and at the
end of an epoch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable

import torch

from semanticsegmentation_tensorflow_tpu_torch.train.metrics import SegMetrics
from semanticsegmentation_tensorflow_tpu_torch.train.state import TrainState


@dataclass
class LoopHooks:
    on_log: Callable[[int, dict], None] = lambda step, m: print(
        f"step {step}: " + " ".join(f"{k}={float(v):.4f}" for k, v in m.items()))
    on_epoch: Callable[[int, dict], None] = lambda epoch, m: None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(state: TrainState, train_step: Callable,
          batches_per_epoch: Callable[[], Iterable], *, epochs: int,
          num_classes: int, log_every: int = 10, checkpoint_every: int = 0,
          ckpt=None, hooks: LoopHooks | None = None,
          images_per_batch: int | None = None, val_every: int = 0,
          val_fn: Callable | None = None,
          best_ckpt=None) -> tuple[TrainState, dict]:
    """Runs the loop; returns (final state, last epoch summary). The summary
    holds loss, miou, pixel_acc, iou (as Python numbers and lists),
    images_per_sec, epoch and the global step. A step without metrics
    (``with_metrics=False``) contributes its loss only. ``images_per_batch``:
    the global batch a step trains on, where a batch holds only this rank's
    share of it (a grid of ranks); default the batch's own size.

    ``val_fn(state) -> {"val_loss", "val_miou"}`` runs every ``val_every``
    epochs and merges into the epoch summary with its wall time
    (``val_seconds``, host clock; ``val_fn`` ends in a host read). With
    ``best_ckpt`` (a second CheckpointManager, by convention
    ``<ckpt_dir>/best`` keeping one) the state is saved there whenever
    ``val_miou`` improves, and the summary gains ``val_best``."""
    hooks = hooks or LoopHooks()
    summary: dict = {}
    best_miou = -1.0
    device = state.device
    for epoch in range(epochs):
        metrics = SegMetrics(num_classes, device)
        _sync(device)
        t0, n_imgs = time.perf_counter(), 0
        for batch in batches_per_epoch():
            n_imgs += images_per_batch or int(batch["label"].shape[0])
            out = train_step(state, batch)
            metrics.update(out.get("cm"), out["loss"])
            if log_every and state.step % log_every == 0:
                hooks.on_log(state.step, {"loss": float(out["loss"])})
            if checkpoint_every and ckpt is not None \
                    and state.step % checkpoint_every == 0:
                ckpt.save(state)
        _sync(device)
        dt = time.perf_counter() - t0
        summary = {k: v.tolist() for k, v in metrics.summary().items()}
        summary["images_per_sec"] = n_imgs / dt if dt > 0 else 0.0
        summary["epoch"] = epoch
        summary["step"] = state.step  # global step, for log keying
        if val_fn is not None and val_every and (epoch + 1) % val_every == 0:
            t_val = time.perf_counter()
            vm = val_fn(state)
            summary.update(vm, val_seconds=time.perf_counter() - t_val)
            miou = float(vm.get("val_miou", -1.0))
            if best_ckpt is not None and miou > best_miou:
                best_miou = miou
                best_ckpt.save(state)
                summary["val_best"] = best_miou
        hooks.on_epoch(epoch, summary)
    if ckpt is not None:
        ckpt.save(state)
    return state, summary
