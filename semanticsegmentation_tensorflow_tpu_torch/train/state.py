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


def _as_dtype(d: torch.dtype | str) -> torch.dtype:
    """A torch dtype, or its name (``"bfloat16"``, ``"float16"``, ...)."""
    dtype = d if isinstance(d, torch.dtype) else getattr(torch, str(d), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown mu_dtype {d!r}")
    return dtype


class MomentDtypeOptimizer(torch.optim.Optimizer):
    """optax's ``adam`` / ``adamw`` (``mu_dtype=``) and ``sgd`` with
    momentum 0.9 (``accumulator_dtype=``) with the first moment (Adam's
    ``mu``, SGD's trace) stored in ``mu_dtype``.

    As in optax, each update forms the new moment in f32 from the f32
    gradient and the decayed stored moment (``decay * moment`` in
    ``mu_dtype``, the factor rounded to it too, as jnp's weak typing
    computes it), computes the update from that f32 moment, and only then
    casts the moment for storage; Adam's second moment stays f32. Adam:
    ``mu_hat = mu / (1 - b1^t)``, ``nu_hat = nu / (1 - b2^t)``, update
    ``mu_hat / (sqrt(nu_hat) + eps)``; ``adam`` adds ``weight_decay * p`` to
    the gradient first (coupled L2), ``adamw`` adds it to the update."""

    def __init__(self, params, kind: str, lr: float, mu_dtype: torch.dtype | str,
                 weight_decay: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8, momentum: float = 0.9):
        if kind not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      betas=betas, eps=eps,
                                      momentum=momentum))
        self.kind = kind
        self.mu_dtype = _as_dtype(mu_dtype)

    def _decay(self, moment: torch.Tensor, decay: float) -> torch.Tensor:
        """``decay * moment`` as jnp computes it for a weakly typed Python
        float: the factor rounded to ``mu_dtype``, the product too; f32."""
        m = moment.to(self.mu_dtype)
        return (m * torch.tensor(decay, dtype=self.mu_dtype)).float()

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                st = self.state[p]
                if self.kind == "sgd":
                    t = st.get("momentum_buffer")
                    trace = g if t is None else g + self._decay(t, group["momentum"])
                    st["momentum_buffer"] = trace.to(self.mu_dtype)
                    p.add_(trace, alpha=-lr)
                    continue
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                if self.kind == "adam" and wd:
                    g = g + wd * p
                st["step"] += 1
                mu = (1 - b1) * g + self._decay(st["exp_avg"], b1)
                nu = st["exp_avg_sq"].mul_(b2).add_((1 - b2) * g * g)
                mu_hat = mu / (1 - b1 ** st["step"])
                nu_hat = nu / (1 - b2 ** st["step"])
                update = mu_hat / (nu_hat.sqrt() + group["eps"])
                if self.kind == "adamw" and wd:
                    update = update + wd * p
                st["exp_avg"] = mu.to(self.mu_dtype)
                p.add_(update, alpha=-lr)


def make_optimizer(name: str, params, learning_rate: float,
                   weight_decay: float = 0.0, mu_dtype: Any = None
                   ) -> torch.optim.Optimizer:
    """``adam`` (coupled L2 weight decay), ``adamw`` (decoupled) or ``sgd``
    (momentum 0.9, weight decay ignored as in the JAX package) over
    ``params``; the rate is set per step from the schedule
    (:class:`TrainState`). ``mu_dtype`` (e.g. ``torch.bfloat16`` or
    ``"bfloat16"``) stores the first moment in that dtype
    (:class:`MomentDtypeOptimizer`); None keeps torch's f32 optimizers."""
    if name not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}")
    if mu_dtype is not None:
        return MomentDtypeOptimizer(params, name, learning_rate, mu_dtype,
                                    weight_decay if name != "sgd" else 0.0)
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate,
                                weight_decay=weight_decay)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate,
                                 weight_decay=weight_decay)
    return torch.optim.SGD(params, lr=learning_rate, momentum=0.9)


@dataclasses.dataclass
class TrainState:
    """The mutable training world: ``model`` (f32 params on its device, in
    ``train()`` mode), ``optimizer`` over its parameters, ``lr_fn`` (step ->
    rate), the optimizer ``step`` count, the augment and dropout generators
    (explicit ``torch.Generator``s; the dropout one on the model's device),
    and the EMA copy of the parameters (empty when ``ema_decay`` is 0; the
    parameters only: BatchNorm's running statistics are buffers, served
    live beside the EMA parameters, as the JAX package's
    ``train/state.py:37-48`` keeps ``batch_stats`` out of its EMA), and
    ``zero1`` where :func:`shard_state_zero1` put the optimizer over this
    rank's slices (None: the optimizer holds the whole parameters)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    lr_fn: LrFn
    aug_gen: torch.Generator
    dropout_gen: torch.Generator
    step: int = 0
    ema_decay: float = 0.0
    ema_params: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    zero1: Zero1 | None = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def optimizer_state_dict(self) -> dict:
        """The optimizer's state_dict over the whole parameters: under
        ZeRO-1 the moments gathered from every data rank (a collective:
        every rank calls it), so that a checkpoint does not depend on the
        sharding."""
        sd = self.optimizer.state_dict()
        return sd if self.zero1 is None else self.zero1.gather_state(sd)

    def load_optimizer_state_dict(self, sd: dict) -> None:
        """Load a whole-parameter optimizer state_dict, this rank's slice
        of each moment under ZeRO-1."""
        self.optimizer.load_state_dict(
            sd if self.zero1 is None else self.zero1.slice_state(sd))

    def apply_gradients(self) -> None:
        """One optimizer update from the accumulated ``.grad``s at the
        schedule's rate for this step (under ZeRO-1 on this rank's slices,
        then the fresh slices gathered), then the EMA update
        ``e * d + p * (1 - d)`` and ``step += 1``."""
        lr = self.lr_fn(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if self.zero1 is None:
            self.optimizer.step()
        else:
            self.zero1.step(self.optimizer)
        if self.ema_params:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    e = self.ema_params[name]
                    e.copy_(e * d + p * (1.0 - d))
        self.step += 1


class Zero1:
    """ZeRO-1 over a data grid (the JAX ``_zero1_apply_gradients``): the
    optimizer runs over one leaf per parameter, in the model's order: this
    rank's slice of each parameter that :func:`parallel.mesh.zero1_spec`
    shards, the parameter itself where it stays replicated. Its moments
    are then 1/``data`` of the sharded leaves. A slice along dim 0 is a
    view of the parameter, so the update lands in place and the gather
    writes the other ranks' slices beside it with no buffer; a transposed
    conv's dim-1 slice is a copy. Every optimizer the port builds is
    elementwise, so updating a slice equals slicing the whole update."""

    def __init__(self, model: nn.Module, grid):
        from semanticsegmentation_tensorflow_tpu_torch.convert import (
            transposed_weights,
        )
        from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (
            zero1_spec,
        )

        self.grid = grid
        self.n, self.index = grid.data, grid.data_index
        transposed = transposed_weights(model)
        self.params: list[nn.Parameter] = []
        self.axes: list[int | None] = []
        self.leaves: list[torch.Tensor] = []
        for name, p in model.named_parameters():
            axis = (zero1_spec(p, grid, name in transposed)
                    if self.n > 1 else None)
            self.params.append(p)
            self.axes.append(axis)
            if axis is None:
                self.leaves.append(p)
            else:
                mine = self._mine(p.detach(), axis)
                self.leaves.append(mine if axis == 0 else mine.clone())

    def _mine(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        k = t.shape[axis] // self.n
        return t.narrow(axis, self.index * k, k)

    @torch.no_grad()
    def step(self, optimizer: torch.optim.Optimizer) -> None:
        """Each sharded leaf takes this rank's slice of its gradient (the
        gradients already summed over the world), the optimizer steps, and
        an all_gather over the data ranks writes every rank's fresh slices
        into the parameters."""
        for p, axis, leaf in zip(self.params, self.axes, self.leaves):
            if axis is None:
                continue
            if axis:              # a copy: this step's values first
                leaf.copy_(self._mine(p, axis))
            leaf.grad = (None if p.grad is None
                         else self._mine(p.grad, axis).contiguous())
        optimizer.step()
        for leaf, axis in zip(self.leaves, self.axes):
            if axis is not None:      # a view would keep the step's gradients
                leaf.grad = None
        self._gather([(p, a, leaf) for p, a, leaf in
                      zip(self.params, self.axes, self.leaves) if a is not None])

    def _gather(self, items: list[tuple[torch.Tensor, int, torch.Tensor]]) -> None:
        """One ``all_gather`` over the data ranks per item: every other
        rank's ``part`` into its slot of ``full`` along ``axis``, straight
        into the slot where it is contiguous (dim 0), else through a
        buffer; this rank's own slot receives into a buffer (a leaf may be
        a view of that slot) and is copied only where it is not the leaf."""
        import torch.distributed as dist

        with torch.profiler.record_function("zero1_all_gather"):
            for full, axis, part in items:
                k = full.shape[axis] // self.n
                slots = [full.narrow(axis, r * k, k) for r in range(self.n)]
                outs = [slot if axis == 0 and r != self.index
                        else torch.empty_like(part)
                        for r, slot in enumerate(slots)]
                dist.all_gather(outs, part.contiguous(),
                                group=self.grid.data_group)
                for slot, out in zip(slots, outs):
                    if out is not slot and slot.data_ptr() != part.data_ptr():
                        slot.copy_(out)

    def _moments(self, sd: dict, shape_of) -> list[tuple[int, str, int]]:
        """(param index, state key, axis) of every moment of a sharded
        leaf in an optimizer state_dict: the tensors shaped as
        ``shape_of(i)`` (a step count is not)."""
        out = []
        for i, (p, axis) in enumerate(zip(self.params, self.axes)):
            if axis is None:
                continue
            for key, v in sd["state"].get(i, {}).items():
                if torch.is_tensor(v) and tuple(v.shape) == tuple(shape_of(i)):
                    out.append((i, key, axis))
        return out

    def slice_state(self, sd: dict) -> dict:
        """A whole-parameter optimizer state_dict -> this rank's."""
        state = {i: dict(s) for i, s in sd["state"].items()}
        for i, key, axis in self._moments(sd, lambda i: self.params[i].shape):
            state[i][key] = self._mine(state[i][key], axis).clone()
        return dict(sd, state=state)

    def gather_state(self, sd: dict) -> dict:
        """This rank's optimizer state_dict -> the whole-parameter one
        (every rank's slices, by one all_gather; every rank calls it)."""
        state = {i: dict(s) for i, s in sd["state"].items()}
        items = []
        for i, key, axis in self._moments(sd, lambda i: self.leaves[i].shape):
            full = torch.empty(self.params[i].shape, dtype=state[i][key].dtype,
                               device=state[i][key].device)
            items.append((full, axis, state[i][key]))
            state[i][key] = full
        self._gather(items)
        return dict(sd, state=state)


def shard_state_zero1(state: TrainState, grid) -> TrainState:
    """ZeRO-1 for ``state`` on a data grid (the JAX ``shard_state_zero1``):
    its optimizer is rebuilt over :class:`Zero1`'s leaves with the same
    class, hyperparameters and implementation, and takes this rank's slice
    of any state the old one held (e.g. after a restore). In place; returns
    ``state``. The parameters, EMA and generators stay whole on every
    rank."""
    if grid is None or grid.spatial != 1:
        raise ValueError("shard_opt=True (ZeRO-1) requires a 1-D data mesh")
    if state.zero1 is not None:
        raise ValueError("the state is sharded for ZeRO-1 already")
    import inspect

    old = state.optimizer
    zero1 = Zero1(state.model, grid)
    accepted = inspect.signature(type(old).__init__).parameters
    kw = {k: v for k, v in old.defaults.items() if k in accepted}
    if isinstance(old, MomentDtypeOptimizer):
        kw.update(kind=old.kind, mu_dtype=old.mu_dtype)
    new = type(old)(zero1.leaves, **kw)
    sd = old.state_dict()
    if sd["state"]:
        new.load_state_dict(zero1.slice_state(sd))
    state.optimizer, state.zero1 = new, zero1
    return state


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
