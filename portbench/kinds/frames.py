"""Frame traffic (a mix of ``"kind": "frames"``): a closed loop of one
stream, each request one uint8 frame from host memory through
``Predictor.__call__`` (built as ``scripts/common.py`` ``build_predictor``
builds it: the preset's model, KITTI's overlay palette, alpha 0.5), the
overlay and labels back on the host.

The mix's file gives the frame count and size, the warm-up requests, the
blend's alpha, whether the Predictor serves int8 (``"int8"``, its
``--int8``), and in ``control`` the settings of the control run
(``"int8": true``). Frames cycle in order. Each request's latency runs from the call to the
host holding its answer. The answers kept for the comparison are a uniform
sample, drawn from the seed as the window runs (reservoir sampling), of
every answer the window produced.
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np

from portbench.harness import inputs, trace

SPANS = ("request",)


class Mix:
    unit = "frames"
    # faults planted under the timed path (``plant``)
    FAULTS = ("stale", "altered_labels")

    def __init__(self, torch, cfg: dict, traffic: dict, seed: int, devices,
                 control: bool = False):
        if len(devices) != 1:
            raise ValueError("a frames mix runs on one card")
        if control:
            traffic = {**traffic, **traffic["control"]}
        self.torch, self.cfg, self.traffic = torch, cfg, traffic
        self.seed, self.device = seed, devices[0]
        self.kept: list = []
        self.bias = None

    def build(self) -> None:
        torch, cfg = self.torch, self.cfg
        from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
            normalize_images,
        )
        from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
            overlay_palette,
        )
        from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
        from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
            build_model, merge_quant_safe_kwargs,
        )
        from semanticsegmentation_tensorflow_tpu_torch.ops.shape import (
            pad_to_multiple,
        )

        h, w = self.traffic["frame_hw"]
        images, _ = inputs.road_frames(torch, self.traffic["frames"], h, w,
                                       self.seed, self.device)
        self.frames = list(images)
        int8 = self.traffic.get("int8", False)
        kwargs = dict(cfg["model_kwargs"])
        if int8:                           # the --int8 Predictor's model
            kwargs = merge_quant_safe_kwargs(cfg["model"], kwargs)
        model = build_model(cfg["model"], num_classes=cfg["num_classes"],
                            device=self.device, **kwargs)
        model.load_state_dict(self._weights(), strict=True)
        if int8:
            from semanticsegmentation_tensorflow_tpu_torch.infer import quant

            calib = pad_to_multiple(normalize_images(
                torch.from_numpy(images[:4]).to(self.device), cfg["mean"],
                cfg["std"]), getattr(model, "total_stride", 32))
            model, _ = quant.quantize_for_inference(model, [calib])
        self.palette = overlay_palette(cfg["dataset"])
        self.alpha = self.traffic["alpha"]
        self.predictor = Predictor(model, (h, w), device=self.device,
                                   mean=cfg["mean"], std=cfg["std"],
                                   overlay_palette=self.palette, alpha=self.alpha)
        self.call = self.predictor
        self.model = self.predictor.model

    def plant(self, fault: str) -> None:
        """Plants one of ``FAULTS`` on the call the window makes."""
        call = self.call
        if fault == "stale":             # each answer is the request before's
            last: list = []

            def stale(frame):
                out = call(frame)
                if not last:
                    last.append(out)
                    return out
                prev, last[0] = last[0], out
                return prev

            self.call = stale
        elif fault == "altered_labels":  # a 64 x 64 block of labels flipped
            def altered_labels(frame):
                overlay, labels = call(frame)
                labels = labels.copy()
                labels[:64, :64] = 1 - labels[:64, :64]
                return overlay, labels

            self.call = altered_labels
        else:
            raise ValueError(f"unknown fault {fault!r}")

    def _weights(self) -> dict:
        """The seed's weights, rounded to bfloat16, the type they are
        served in (``inputs.model_weights``; the classifier's bias worked
        out once, then reused)."""
        w, self.bias = inputs.model_weights(
            self.torch, self.cfg, self.seed, self.device, self.frames[0],
            self.bias, served_dtype=self.torch.bfloat16)
        return w

    def first_steps(self) -> None:
        """Warm-up requests on the cell's one shape."""
        for i in range(self.traffic["warmup_requests"]):
            self.call(self.frames[i % len(self.frames)])

    def after_window(self) -> None:
        """Nothing: the answers compared are the window's own."""

    def window(self, seconds: float, mark=contextlib.nullcontext) -> dict:
        """Requests back to back until ``seconds`` have passed; the window
        ends when the last answer is on the host."""
        clock = time.perf_counter
        rng = random.Random(self.seed)
        keep = self.traffic["checked_answers"]
        lat, i = [], 0
        t0 = end = clock()
        while True:
            start = clock()
            if start - t0 >= seconds:
                break
            k = i % len(self.frames)
            with mark("request"):
                overlay, labels = self.call(self.frames[k])
            end = clock()
            lat.append(end - start)
            if len(self.kept) < keep:
                self.kept.append((k, overlay, labels))
            else:
                j = rng.randrange(i + 1)
                if j < keep:
                    self.kept[j] = (k, overlay, labels)
            i += 1
        return {"seconds": end - t0, "units": i, "latencies": lat}

    def run_units(self, k: int, mark=contextlib.nullcontext) -> None:
        for i in range(k):
            with mark("request"):
                self.call(self.frames[i % len(self.frames)])

    def tail(self, units: int) -> dict:
        torch = self.torch
        busy = trace.busy_session(torch, self.run_units, units)
        gaps = trace.idle_by_span(torch, lambda k: self.run_units(
            k, torch.profiler.record_function), units, SPANS)
        return {"busy": busy, "gaps": gaps}

    def release(self) -> None:
        del self.predictor, self.call, self.model
        import gc

        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def readings(self) -> dict:
        """The kept answers against the reference's logits of their frames
        (``reference.predict``): the worst of each number over them."""
        from portbench.reference import predict as ref_predict

        p = self._weights()
        worst: dict = {}
        for k, overlay, labels in self.kept:
            ref = ref_predict.logits(self.cfg, p, self.frames[k], self.device)
            got = ref_predict.judge(ref, self.frames[k], overlay, labels,
                                    np.asarray(self.palette), self.alpha)
            for name, v in got.items():
                worst[name] = max(worst.get(name, v), v)
        compared = {k: worst.pop(k) for k in ("tie_gap", "overlay_diff")
                    if k in worst}
        self.info = dict(worst, answers=len(self.kept))
        return compared
