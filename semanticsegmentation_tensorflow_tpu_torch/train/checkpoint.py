"""Checkpoint/resume of the port (counterpart of the JAX package's
``train/checkpoint.py``, which wraps orbax).

Each save writes ``<dir>/ckpt_<step>.pt`` with ``torch.save`` to a temporary
file and renames it into place, so a crash leaves the previous checkpoints
whole; the oldest beyond ``max_to_keep`` are deleted. A checkpoint holds the
model parameters and buffers (a BatchNorm model's running statistics, the
JAX package's ``batch_stats``), the optimizer state, the step, both
generator states and the EMA parameters when tracked: resuming continues
the run bit for bit (given the same batches). A checkpoint does not depend
on ZeRO-1 (``train/state.py`` ``Zero1``), as the JAX package's orbax
checkpoints of global arrays do not: ``save`` gathers the whole moments
(every rank calls it; a manager with ``write=False`` only takes part in
that gather) and ``restore`` slices them for a sharded run, so a run
resumes with or without ``--shard-opt`` whichever way it was saved.
"""

from __future__ import annotations

import os
import re
import warnings

import torch

from semanticsegmentation_tensorflow_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def checkpoint_steps(directory: str) -> list[int]:
    """Steps of the port checkpoints in ``directory``, ascending ([] when it
    holds none or does not exist)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory))
                  if m)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 write: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.write = write

    def save(self, state: TrainState) -> str | None:
        optimizer = state.optimizer_state_dict()   # collective under ZeRO-1
        if not self.write:
            return None
        os.makedirs(self.directory, exist_ok=True)
        payload = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": optimizer,
            "aug_gen": state.aug_gen.get_state(),
            "dropout_gen": state.dropout_gen.get_state(),
        }
        if state.ema_params:  # only when tracked
            payload["ema_params"] = state.ema_params
        path = checkpoint_path(self.directory, state.step)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in checkpoint_steps(self.directory)[:-self.max_to_keep]:
            os.remove(checkpoint_path(self.directory, old))
        return path

    def latest_step(self) -> int | None:
        steps = checkpoint_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Load the checkpoint at ``step`` (default: the latest) into
        ``state`` in place and return it; no checkpoint leaves it as is. A
        state tracking EMA needs a checkpoint that holds one; a stored EMA
        that ``state`` does not track is dropped with a warning."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        ckpt = torch.load(checkpoint_path(self.directory, step),
                          map_location=state.device, weights_only=True)
        if state.ema_params and "ema_params" not in ckpt:
            raise ValueError(f"EMA params requested (the state tracks them) but "
                             f"the checkpoint at step {step} holds none: it "
                             "was not trained with --ema-decay")
        if "ema_params" in ckpt and not state.ema_params:
            warnings.warn(f"checkpoint at step {step} holds EMA params but this "
                          "run does not track them (no --ema-decay): EMA "
                          "tracking stops here", stacklevel=2)
        state.model.load_state_dict(ckpt["model"])
        state.load_optimizer_state_dict(ckpt["optimizer"])
        state.aug_gen.set_state(ckpt["aug_gen"].cpu())
        state.dropout_gen.set_state(ckpt["dropout_gen"].cpu())
        if state.ema_params:
            for name, e in state.ema_params.items():
                e.copy_(ckpt["ema_params"][name])
        state.step = int(ckpt["step"])
        return state


def load_weights(directory: str, use_ema: bool = False, map_location="cpu"
                 ) -> dict[str, torch.Tensor]:
    """The model ``state_dict`` of the latest port checkpoint in
    ``directory``, with the EMA parameters in place of the raw ones when
    ``use_ema`` (a BatchNorm model's running statistics stay the live ones:
    the EMA covers parameters only, as in the JAX package). Raises
    FileNotFoundError when ``directory`` holds none."""
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no port checkpoint (ckpt_<step>.pt) in "
                                f"{directory!r}")
    step = steps[-1]
    ckpt = torch.load(checkpoint_path(directory, step),
                      map_location=map_location, weights_only=True)
    if not use_ema:
        return ckpt["model"]
    if "ema_params" not in ckpt:
        raise ValueError(f"--ema: the checkpoint at step {step} holds no EMA "
                         "params (train with --ema-decay)")
    return dict(ckpt["model"], **ckpt["ema_params"])
