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

``remat`` recomputes the model's forward in the backward, one stage at a
time (``torch.utils.checkpoint`` around each of the model's
``models.common.region`` calls: VGG16's stages and its fc6/fc7 head,
SegNet's and U-Net's blocks, DeepLab's ASPP head; the counterpart of
``jax.checkpoint`` with ``nothing_saveable``): only the regions' inputs and
outputs stay alive from the forward, and the backward rebuilds one region's
activations at a time. The dropout generator's state is saved before each
region and put back for its recompute, so the recompute draws the same
masks, and the recompute leaves BatchNorm's running statistics alone
(``models.common.frozen_batch_stats``). On a grid that splits rows a
region's recompute re-runs its halo exchanges in the backward, in the same
order on every rank. The eval step
(:func:`make_eval_step`) runs the forward in ``eval()`` mode without
gradients and draws from no generator.

BatchNorm (``use_bn``): each microbatch's forward in ``train()`` mode
normalizes by its own statistics and updates the running ones in turn, as
the JAX package threads ``batch_stats`` through its microbatch scan
(``train/step.py:139-184``). On a data-only grid each rank does so on its
images and the step ends with the running statistics averaged over the
ranks (JAX's ``lax.pmean``, ``:275``); on a grid that splits rows the
statistics are the world's already (``models.common.BatchNorm``).

``shard_opt`` (ZeRO-1, a data-only grid; the JAX ``_zero1_apply_gradients``):
after the same all-reduce and divide, each rank updates its slice of every
parameter that ``parallel.mesh.zero1_spec`` shards, from its slice of the
optimizer's moments, one all_gather writes the fresh slices into every
rank's parameters, and the EMA updates after it (``train.state.Zero1``).
The update equals the replicated step's bit for bit.

:func:`replicate_eval_step` runs an eval step over one model replica per
device of one process (the serving CLIs' one-process ``--mesh``).

Batch contract (leading dim = batch): image [N,H,W,3] (uint8 with an
augment function, or float32 already normalized), label [N,H,W] class ids,
valid [N,H,W] bool (optional).
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    average_batch_stats, frozen_batch_stats, remat_regions,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import labels_from_logits
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import use_grid
from semanticsegmentation_tensorflow_tpu_torch.train.loss import (
    focal_loss_sum, softmax_cross_entropy_sum,
)
from semanticsegmentation_tensorflow_tpu_torch.train.metrics import (
    binary_confidence_histogram, confusion_matrix,
)
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
    docstring); the batch holds this rank's images and rows. ``remat``:
    recompute the forward in the backward (module docstring).
    ``shard_opt``: ZeRO-1 on a data-only grid (module docstring); the step
    takes a state that ``train.state.shard_state_zero1`` prepared."""
    if shard_opt and (mesh is None or mesh.spatial > 1):
        raise ValueError("shard_opt=True (ZeRO-1) requires a 1-D data mesh")
    if loss == "ce":
        loss_sum_fn = softmax_cross_entropy_sum
    elif loss == "focal":
        loss_sum_fn = partial(focal_loss_sum, gamma=focal_gamma)
    else:
        raise ValueError(f"unknown loss {loss!r} (ce | focal)")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch: dict) -> dict:
        if shard_opt != (state.zero1 is not None):
            raise ValueError("shard_opt=True needs a state prepared by "
                             "shard_state_zero1" if shard_opt else
                             "a state sharded by shard_state_zero1 needs a "
                             "step built with shard_opt=True")
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
                logits = (_remat_forward(model, mb["image"], state.dropout_gen)
                          if remat else
                          model(mb["image"], generator=state.dropout_gen))
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
            if mesh.spatial == 1:
                average_batch_stats(model, mesh)
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


@contextlib.contextmanager
def _replay(generator: torch.Generator, saved: torch.Tensor):
    """Run the enclosed recompute from the generator state ``saved``, with
    BatchNorm's running statistics left as the forward left them, and
    leave the generator where it was before."""
    now = generator.get_state()
    generator.set_state(saved)
    try:
        with frozen_batch_stats():
            yield
    finally:
        generator.set_state(now)


def _remat_forward(model, image: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """``model(image, generator=generator)`` keeping, of each region
    (``models.common.region``), only its inputs and outputs for the
    backward: the rest is recomputed there, region by region.
    ``preserve_rng_state`` restores only the global generators, so the
    dropout generator's state is saved before each region and replayed for
    its recompute."""

    def wrap(fn, *args):
        saved = generator.get_state()
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              _replay(generator, saved)))

    with remat_regions(wrap):
        return model(image, generator=generator)


def make_eval_step(num_classes: int, mesh=None,
                   road_hist: bool = False) -> Callable:
    """Build ``step(state, batch) -> {"loss", "cm", "pred"[, "road_hist"]}``
    (``state`` a TrainState or the model itself).

    The forward runs in ``eval()`` mode under ``torch.no_grad()``; the model
    goes back to the mode it was in. ``loss`` is the masked CE sum over
    ``max(valid_sum, 1)``, ``pred`` the first-max argmax (``l1 > l0`` at
    C == 2), ``cm`` the [C, C] confusion matrix. ``road_hist`` (binary
    models only) adds the [2, 256] histogram of ``softmax(logits)[..., 1]``
    for :func:`train.metrics.kitti_road_metrics`. ``mesh``: a data-only
    ``parallel.mesh.Grid``; each rank evaluates its images and one
    ``all_reduce(SUM)`` covers cm, the loss sums and the histogram."""
    if road_hist and num_classes != 2:
        raise ValueError("road_hist needs a binary (num_classes=2) model")
    if mesh is not None and mesh.spatial > 1:
        raise ValueError("the eval step shards over a data-only grid")

    def step(state, batch: dict) -> dict:
        model = getattr(state, "model", state)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits = model(batch["image"])
        finally:
            model.train(was_training)
        valid = batch.get("valid")
        ce_sum, valid_sum = softmax_cross_entropy_sum(logits, batch["label"],
                                                      valid)
        pred = labels_from_logits(logits)
        cm = confusion_matrix(batch["label"], pred, num_classes, valid)
        hist = None
        if road_hist:
            prob = torch.softmax(logits.float(), dim=-1)[..., 1]
            hist = binary_confidence_histogram(prob, batch["label"] == 1, valid)
        if mesh is not None and mesh.world > 1:
            ce_sum, valid_sum, cm, hist = _all_reduce_sums(ce_sum, valid_sum,
                                                           cm, hist)
        out = {"loss": ce_sum / valid_sum.clamp(min=1.0), "cm": cm,
               "pred": pred, "ce_sum": ce_sum, "valid_sum": valid_sum}
        if hist is not None:
            out["road_hist"] = hist
        return out

    return step


def replicate_eval_step(step: Callable, models: list) -> Callable:
    """An eval step (:func:`make_eval_step`, ``infer.tta.make_tta_eval_step``)
    over one replica of the model per device, in one process (``--mesh``):
    the batch, a multiple of the replica count, cut into one part per
    replica (``parallel.replicas.run_on_replicas``), then the sums added on
    the first device: the confusion matrix and the road histogram exactly,
    the loss as the summed CE over the summed valid count; ``pred`` joined
    in order. The ``state`` argument is ignored."""
    from semanticsegmentation_tensorflow_tpu_torch.parallel.replicas import (
        run_on_replicas,
    )

    devices = [next(m.parameters()).device for m in models]

    def run(_state, batch: dict) -> dict:
        outs, _ = run_on_replicas(step, models, devices, batch)
        first = outs[0]["cm"].device

        def total(key):
            return sum(o[key].to(first) for o in outs)

        ce_sum, valid_sum = total("ce_sum"), total("valid_sum")
        out = {"loss": ce_sum / valid_sum.clamp(min=1.0), "cm": total("cm"),
               "pred": torch.cat([o["pred"].to(first) for o in outs]),
               "ce_sum": ce_sum, "valid_sum": valid_sum}
        if "road_hist" in outs[0]:
            out["road_hist"] = total("road_hist")
        return out

    return run


def _all_reduce_sums(ce_sum, valid_sum, cm, hist):
    """One SUM over the world of the eval step's sums, in float64 (every
    count stays exact below 2^53)."""
    parts = [ce_sum.reshape(1), valid_sum.reshape(1), cm.reshape(-1)]
    if hist is not None:
        parts.append(hist.reshape(-1))
    with torch.profiler.record_function("grid_all_reduce"):
        flat = torch.cat([t.to(torch.float64) for t in parts])
        dist.all_reduce(flat)
    n = cm.numel()
    cm = flat[2:2 + n].round().to(cm.dtype).view_as(cm)
    if hist is not None:
        hist = flat[2 + n:].round().to(hist.dtype).view_as(hist)
    return flat[0].float(), flat[1].float(), cm, hist


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
