"""Train state: model + optimizer + step + generators + EMA (counterpart of
the JAX package's ``train/state.py``).

Optimizer semantics follow the JAX package's optax chains: ``adam`` with
weight decay is coupled L2 (the decay is added to the gradient, as
``torch.optim.Adam(weight_decay=)`` does), ``adamw`` is decoupled, ``sgd``
uses momentum 0.9 and, as there, no weight decay. The learning rate is a
plain function of the optimizer step, set on the optimizer before each
update (optax evaluates its schedule at the update's count, from 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn as nn

LrFn = Callable[[int], float]


def make_lr_schedule(learning_rate: float, schedule: str = "constant",
                     total_steps: int | None = None, warmup_steps: int = 0,
                     power: float = 0.9, end_factor: float = 0.0) -> LrFn:
    """step -> learning rate. ``constant`` (the reference's), ``poly``
    (power 0.9, the DeepLab schedule) or ``cosine``, each after an optional
    linear warmup from 0 over ``warmup_steps``; the decays run over the
    post-warmup remainder of ``total_steps`` (optimizer steps) down to
    ``learning_rate * end_factor``. Poly's value at and after its last step
    is exactly the end value (``state.py:77-88`` of the JAX package)."""
    if schedule in (None, "constant"):
        def dec(count: int) -> float:
            return learning_rate
    else:
        if total_steps is None:
            raise ValueError(f"schedule={schedule!r} requires total_steps")
        decay_steps = max(total_steps - warmup_steps, 1)
        end = learning_rate * end_factor
        if schedule == "poly":
            def dec(count: int) -> float:
                frac = min(max(1.0 - count / decay_steps, 0.0), 1.0)
                return (learning_rate - end) * frac ** power + end if frac > 0 else end
        elif schedule == "cosine":
            def dec(count: int) -> float:
                c = min(count, decay_steps)
                cos = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
                return learning_rate * ((1.0 - end_factor) * cos + end_factor)
        else:
            raise ValueError(f"unknown lr schedule {schedule!r} "
                             "(constant | poly | cosine)")
    if not warmup_steps:
        return dec

    def warm(count: int) -> float:
        if count < warmup_steps:
            return learning_rate * count / warmup_steps
        return dec(count - warmup_steps)

    return warm


def make_optimizer(name: str, params, learning_rate: float,
                   weight_decay: float = 0.0, mu_dtype: Any = None
                   ) -> torch.optim.Optimizer:
    """``adam`` (coupled L2 weight decay), ``adamw`` (decoupled) or ``sgd``
    (momentum 0.9, weight decay ignored as in the JAX package) over
    ``params``; the rate is set per step from the
    schedule (:class:`TrainState`). ``mu_dtype`` (a bf16 first moment on
    the TPU) is not ported."""
    if mu_dtype is not None:
        raise NotImplementedError("mu_dtype is not ported yet")
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate,
                                 weight_decay=weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=0.9)
    raise ValueError(f"unknown optimizer {name!r}")


@dataclasses.dataclass
class TrainState:
    """The mutable training world: ``model`` (f32 params on its device, in
    ``train()`` mode), ``optimizer`` over its parameters, ``lr_fn`` (step ->
    rate), the optimizer ``step`` count, the augment and dropout generators
    (explicit ``torch.Generator``s; the dropout one on the model's device),
    and the EMA copy of the parameters (empty when ``ema_decay`` is 0)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_fn: LrFn
    aug_gen: torch.Generator
    dropout_gen: torch.Generator
    step: int = 0
    ema_decay: float = 0.0
    ema_params: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_gradients(self) -> None:
        """One optimizer update from the accumulated ``.grad``s at the
        schedule's rate for this step, then the EMA update
        ``e * d + p * (1 - d)`` and ``step += 1``."""
        lr = self.lr_fn(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.ema_params:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    e = self.ema_params[name]
                    e.copy_(e * d + p * (1.0 - d))
        self.step += 1


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       lr_fn: LrFn, seed: int, ema_decay: float = 0.0
                       ) -> TrainState:
    """A fresh state: the augment generator on the CPU (its draws are a few
    ints per example) and the dropout generator on the model's device, both
    seeded from ``seed``; the EMA starts as a copy of the parameters."""
    device = next(model.parameters()).device
    aug = torch.Generator().manual_seed(seed)
    drop = torch.Generator(device=device).manual_seed(seed + 1)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if ema_decay else {})
    return TrainState(model.train(), optimizer, lr_fn, aug, drop,
                      ema_decay=ema_decay, ema_params=ema)
