"""One process, one replica of a model per device: ``--mesh`` of serve,
test and eval in one process (the counterpart of the JAX CLIs' one-process
data mesh). The one place that knows how a batch is divided over the
replicas: :func:`run_on_replicas` cuts it into one equal part per replica,
runs each part on its replica's device and returns the outputs in order;
the Predictor joins them, the eval step (``train/step.py``
``replicate_eval_step``) adds them."""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Sequence

import numpy as np
import torch


def indexed(device) -> torch.device:
    """``device`` as a torch.device, a CUDA device with no index read as the
    current card (``cuda`` -> ``cuda:0``), so that two names of one card
    compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_from(device, mesh: Sequence | None) -> list[torch.device]:
    """The devices of a one-process mesh that starts at ``device`` (each
    with its index, :func:`indexed`); ``[device]`` without a mesh or with
    one device. Raises where the mesh starts elsewhere."""
    if not mesh or (len(mesh) == 1 and torch.device(mesh[0]) == torch.device(device)):
        return [torch.device(device)]
    mesh = [indexed(d) for d in mesh]
    if mesh[0] != indexed(device):
        raise ValueError(f"the mesh {mesh} must start with the device {device}")
    return mesh


def _cut(batch, start: int, stop: int, device):
    """Items ``start:stop`` of an array, a tensor or a dict of them; a
    tensor moves to ``device``, an array stays on the host."""
    if isinstance(batch, dict):
        return {k: _cut(v, start, stop, device) for k, v in batch.items()}
    part = batch[start:stop]
    return part.to(device) if torch.is_tensor(part) else part


def _pad(batch, pad: int):
    """``batch`` with its last item repeated ``pad`` more times."""
    if isinstance(batch, dict):
        return {k: _pad(v, pad) for k, v in batch.items()}
    if torch.is_tensor(batch):
        return torch.cat([batch, batch[-1:].expand(pad, *batch.shape[1:])])
    return np.concatenate([batch, np.repeat(batch[-1:], pad, 0)])


def run_on_replicas(fn: Callable, replicas: Sequence, devices: Sequence,
                    batch, *, pad: bool = False) -> tuple[list, int]:
    """``fn(replica, part)`` for each replica in order, on its device.

    ``batch``: an array or a tensor with the batch first, or a dict of them.
    It is cut into one equal part per replica; a ragged batch is first
    padded to a multiple of the replica count by repeating its last item
    with ``pad``, and raises without it. A tensor part moves to its
    replica's device, an array part stays on the host. Every part is
    enqueued on its device (under ``torch.cuda.device``) before the caller
    fetches any result, so the replicas run at once. One replica gets the
    batch as it is. Returns the outputs in replica order and the real batch
    size (the padded items are the caller's to drop)."""
    first = next(iter(batch.values())) if isinstance(batch, dict) else batch
    n, m = first.shape[0], len(replicas)
    if m == 1:
        return [fn(replicas[0], batch)], n
    if n % m:
        if not pad:
            raise ValueError(f"batch {n} does not divide over {m} replicas")
        batch = _pad(batch, (-n) % m)
    k = (n + (-n) % m) // m
    outs = []
    for i, (replica, device) in enumerate(zip(replicas, devices)):
        device = torch.device(device)
        guard = torch.cuda.device(device) if device.type == "cuda" else nullcontext()
        with guard:
            outs.append(fn(replica, _cut(batch, i * k, (i + 1) * k, device)))
    return outs, n
