"""Training traffic (a mix of ``"kind": "train"``): the port's train step as
``scripts/train.py`` builds it for the configuration's preset, fed by its
``BatchLoader`` from frames held in host memory.

The mix's file gives the frame count and size and whether crops are
flipped; its ``control`` the settings of the control run (``"qat": true``:
``train.py --qat``'s model and step). The configuration gives the model,
batch, crop, optimizer and normalization. Set-up makes the frames and
weights from the seed, builds one train state, and drives it through
three checked steps with the window's own call and feed. Right after the
window the same objects run ``checked_after`` (from the mix file) more
runs of three checked steps, each from the state set back to the seed's
(its parameters, Adam's moments and step count, both generators), the
loader going on where it was. Of each run of three the mix records what
the reference compares: each step's loss, each leaf's first gradient as
Adam holds it after one step (``exp_avg / (1 - beta1)``) and each leaf's
change over the three.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench.harness import inputs, trace

CHECKED_STEPS = 3
SPANS = ("loader_wait", "step", "log_sync")


class FrameSet:
    """The dataset interface ``BatchLoader`` reads (``train_images``,
    ``load_example``) over frames already decoded in host memory."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images, self.labels = images, labels
        self.valid = np.ones(labels.shape[1:], np.bool_)
        self.train_images = [f"frame_{i:04d}" for i in range(len(images))]

    def load_example(self, name: str):
        i = int(name.rsplit("_", 1)[1])
        return self.images[i], self.labels[i], self.valid


class Mix:
    """One training cell's program side: build, first steps, window, the
    steps after it, traced tail, release, and the comparison with the
    reference."""

    unit = "steps"
    # faults planted under the timed path (``plant``)
    FAULTS = ("unchanged", "half_batch", "altered_loss")

    def __init__(self, torch, cfg: dict, traffic: dict, seed: int, devices,
                 control: bool = False):
        if len(devices) != 1:
            raise ValueError("a train mix runs on one card")
        if control:
            traffic = {**traffic, **traffic["control"]}
        self.torch, self.cfg, self.traffic = torch, cfg, traffic
        self.seed, self.device = seed, devices[0]
        self.taken = 0        # batches taken from the loader, over epochs

    # -- the program ------------------------------------------------------
    def build(self) -> None:
        torch, cfg = self.torch, self.cfg
        from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
            make_augment_fn, normalize_images,
        )
        from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import (
            BatchLoader,
        )
        from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
            build_model, merge_quant_safe_kwargs,
        )
        from semanticsegmentation_tensorflow_tpu_torch.ops.shape import (
            pad_to_multiple,
        )
        from semanticsegmentation_tensorflow_tpu_torch.train.state import (
            create_train_state, make_lr_schedule, make_optimizer,
        )
        from semanticsegmentation_tensorflow_tpu_torch.train.step import (
            make_train_step,
        )

        h, w = self.traffic["frame_hw"]
        images, labels = inputs.road_frames(torch, self.traffic["frames"], h, w,
                                            self.seed, self.device)
        self.data = FrameSet(images, labels)
        qat = self.traffic.get("qat", False)
        kwargs = dict(cfg["model_kwargs"])
        if qat:
            kwargs = merge_quant_safe_kwargs(cfg["model"], kwargs)
        model = build_model(cfg["model"], num_classes=cfg["num_classes"],
                            device=self.device, **kwargs)
        weights, self.bias = inputs.model_weights(torch, cfg, self.seed,
                                                  self.device, images[0])
        model.load_state_dict(weights, strict=True)
        del weights
        stride = getattr(model, "total_stride", 32)
        if qat:
            from semanticsegmentation_tensorflow_tpu_torch.infer import quant

            calib = pad_to_multiple(normalize_images(
                torch.from_numpy(images[:cfg["batch_size"]]).to(self.device),
                cfg["mean"], cfg["std"]), stride)
            quant.fake_quantize(model, quant.calibrate_act_scales(model, [calib]))
        self.loader = BatchLoader(self.data, cfg["batch_size"], pad_multiple=stride,
                                  seed=self.seed, device=self.device)
        aug = make_augment_fn(cfg["mean"], cfg["std"],
                              crop_size=tuple(cfg["crop_size"]),
                              random_flip=self.traffic["random_flip"])
        opt = make_optimizer(cfg["optimizer"], model.parameters(),
                             cfg["learning_rate"])
        self.model = model
        self.state = create_train_state(model, opt,
                                        make_lr_schedule(cfg["learning_rate"]),
                                        self.seed)
        self.step_fn = make_train_step(cfg["num_classes"], augment_fn=aug)
        self.batches = self.loader.epoch()

    def plant(self, fault: str) -> None:
        """Plants one of ``FAULTS`` on the objects the window calls."""
        step = self.step_fn
        if fault == "unchanged":       # the step leaves the parameters as they were
            self.state.apply_gradients = lambda: None
        elif fault == "half_batch":    # half the images, the mean over the rest
            self.step_fn = lambda state, b: step(
                state, {k: v[:v.shape[0] // 2] for k, v in b.items()})
        elif fault == "altered_loss":  # the answer altered where it is produced
            def altered(state, b):
                out = step(state, b)
                return dict(out, loss=out["loss"] * 1.1)

            self.step_fn = altered
        else:
            raise ValueError(f"unknown fault {fault!r}")

    def _batch(self) -> dict:
        try:
            batch = next(self.batches)
        except StopIteration:
            self.batches = self.loader.epoch()
            batch = next(self.batches)
        self.taken += 1
        return batch

    def _checked(self) -> dict:
        """``CHECKED_STEPS`` steps through the window's own call and feed,
        from fresh Adam moments: what they produce (module docstring)."""
        torch = self.torch
        named = list(self.model.named_parameters())
        start = {k: p.detach().clone() for k, p in named}
        first_batch = self.taken
        beta1 = self.cfg["adam_betas"][0]
        losses, grad = [], {}
        for t in range(CHECKED_STEPS):
            out = self.step_fn(self.state, self._batch())
            losses.append(float(out["loss"]))
            if t == 0:
                opt_state = self.state.optimizer.state
                for k, p in named:
                    m = opt_state.get(p, {}).get("exp_avg")
                    grad[k] = 0.0 if m is None else float(m.norm()) / (1 - beta1)
        with torch.no_grad():
            change = {k: float((p - start[k]).norm()) for k, p in named}
        del start
        self._sync()
        return {"first_batch": first_batch, "loss": losses, "grad_norm": grad,
                "change_norm": change}

    def first_steps(self) -> None:
        """The checked steps of set-up, from the seed's state."""
        self.runs = [self._checked()]

    def after_window(self) -> None:
        """The checked runs after the window, through the same objects, each
        from the seed's state: the parameters copied back in place, every
        tensor of Adam's state (moments, step) zeroed in place as a fresh
        Adam holds it, the step count 0, both generators seeded again; the
        loader goes on from the window's last batch."""
        torch, state = self.torch, self.state
        w0, _ = inputs.model_weights(torch, self.cfg, self.seed, self.device,
                                     self.data.images[0], self.bias)
        for _ in range(self.traffic["checked_after"]):
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    p.copy_(w0[k])
                for st in state.optimizer.state.values():
                    for key, v in st.items():
                        if torch.is_tensor(v):
                            v.zero_()
                        else:
                            st[key] = type(v)(0)
            state.step = 0
            state.aug_gen.manual_seed(self.seed)
            state.dropout_gen.manual_seed(self.seed + 1)
            self.runs.append(self._checked())
        del w0

    def _one(self, mark) -> None:
        """One step as the window runs it: the batch, the step, and every
        10th step the loss read to the host, as ``train/loop.py`` logs it;
        each part inside ``mark(name)``."""
        with mark("loader_wait"):
            batch = self._batch()
        with mark("step"):
            out = self.step_fn(self.state, batch)
        if self.taken % 10 == 0:
            with mark("log_sync"):
                float(out["loss"])

    def window(self, seconds: float, mark=contextlib.nullcontext) -> dict:
        """Steps until ``seconds`` have passed, then a synchronize: the
        images of every step over the whole time."""
        clock = time.perf_counter
        self._sync()
        steps, t0 = 0, clock()
        while clock() - t0 < seconds:
            self._one(mark)
            steps += 1
        self._sync()
        return {"seconds": clock() - t0, "units": steps,
                "images": steps * self.cfg["batch_size"]}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def run_units(self, k: int, mark=contextlib.nullcontext) -> None:
        for _ in range(k):
            self._one(mark)

    def tail(self, units: int) -> dict:
        """The traced run's last steps: one device-only session (busy,
        wall, ops by name), then one with the host's spans (idle gaps)."""
        torch = self.torch
        busy = trace.busy_session(torch, self.run_units, units)
        gaps = trace.idle_by_span(torch, lambda k: self.run_units(
            k, torch.profiler.record_function), units, SPANS)
        return {"busy": busy, "gaps": gaps}

    def release(self) -> None:
        """Stops the loader's producer and frees the program's state."""
        self.batches.close()
        del self.batches, self.loader, self.state, self.step_fn, self.model
        import gc

        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------
    def readings(self) -> dict:
        """Every run of checked steps against the reference's, each from
        the seed's weights and fresh moments over the batches the program
        took; each number is the mean over the runs. A leaf's gap is the
        gap between the program's norm and the reference's, over the larger
        of the reference's norm of that leaf and of the median leaf.
        ``loss_steps``: the largest relative gap of a step's loss;
        ``loss_gap``: the first step's, steady where the later steps' swing
        with the rounding of the steps before. ``grad_gap``: the worst
        leaf's gap of the first gradient; ``grad_mid``: the median leaf's,
        steady where the worst leaf swings with one small leaf's rounding.
        ``change_gap``: the worst leaf's gap of the change over the checked
        steps, ``change_mean`` the mean leaf's, both leaving out leaves
        whose reference gradient is under a thousandth of the median
        leaf's."""
        torch, cfg = self.torch, self.cfg
        p0, _ = inputs.model_weights(torch, cfg, self.seed, self.device,
                                     self.data.images[0], self.bias)
        per_run = []
        self.info = {"runs": []}
        for prog in self.runs:
            numbers, info = self._compare(prog, p0)
            per_run.append(numbers)
            self.info["runs"].append(dict(info, numbers=numbers))
        del p0
        return {k: float(np.mean([n[k] for n in per_run])) for k in per_run[0]}

    def _compare(self, prog: dict, p0: dict) -> tuple[dict, dict]:
        from portbench.reference import train as ref_train

        examples = {n: self.data.load_example(n) for n in self.data.train_images}
        ref = ref_train.follow(self.cfg, p0, examples, self.data.train_images,
                               self.seed, self.device, steps=CHECKED_STEPS,
                               first_batch=prog["first_batch"])
        grads = ref["grad_norm"]
        med_g = float(np.median(list(grads.values())))
        moved = [k for k, v in grads.items() if v >= 1e-3 * med_g]
        grad = leaf_gaps(prog["grad_norm"], grads, list(grads))
        change = leaf_gaps(prog["change_norm"], ref["change_norm"], moved)
        worst_grad = max(grad, key=grad.get)
        worst_change = max(change, key=change.get)
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
        info = {"first_batch": prog["first_batch"], "loss": prog["loss"],
                "ref_loss": ref["loss"], "loss_gaps": loss_gaps,
                "worst_grad": worst_grad, "worst_change": worst_change,
                "change_gaps": change,
                "left_out": sorted(set(grads) - set(moved))}
        return {"loss_gap": loss_gaps[0], "loss_steps": max(loss_gaps),
                "grad_gap": grad[worst_grad],
                "grad_mid": float(np.median(list(grad.values()))),
                "change_gap": change[worst_change],
                "change_mean": float(np.mean(list(change.values())))}, info


def leaf_gaps(prog: dict, ref: dict, keys: list[str]) -> dict[str, float]:
    """Each leaf's gap between the two norms over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}
