"""The port's tracing (``utils/tracing.py``) on the CPU: off, the Predictor,
the train step and the BatchLoader record nothing and never enter
``record_function`` or read the tracing clock; on, they record the spans
of ``utils/tracing.py``'s docstring with the right parents, threads and
units; ``drain()`` clears; the sync counter is a no-op without CUDA and
counts every synchronization it is shown; a span's start, mapped through
``drain()``'s clock offsets, lands on its ``record_function`` event in a
profiler session. The tests marked ``cuda`` hold the mapped clock to 50 us
of kineto's events and the sync counter to real synchronizations on a
card:

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_tracing.py
"""

import time
import warnings

import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu_torch.data.augment import make_augment_fn
from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import BatchLoader
from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step
from semanticsegmentation_tensorflow_tpu_torch.utils import tracing

HW = (40, 70)
MEAN, STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)


class Frames:
    """The dataset interface BatchLoader reads, over seeded frames."""

    def __init__(self, n=5, hw=HW):
        rng = np.random.default_rng(0)
        self.images = rng.integers(0, 256, (n, *hw, 3), np.uint8)
        self.labels = rng.integers(0, 2, (n, *hw)).astype(np.int32)
        self.train_images = [f"f{i}" for i in range(n)]

    def load_example(self, name):
        i = int(name[1:])
        return self.images[i], self.labels[i], np.ones(HW, np.bool_)


def _model(device="cpu"):
    """A tiny FCN-8s: float32 on the CPU, the port's bf16 on a card (its
    kernels take bf16 and stage1 widths from 16)."""
    kw = {"dtype": torch.float32} if device == "cpu" else {}
    model = build_model("fcn8s", 2, device=device, fc_features=16,
                        width_mult=0.25, **kw)
    init_params(model, torch.Generator(device=device).manual_seed(0))
    return model


@pytest.fixture
def off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _drive(device="cpu"):
    """A Predictor call, two train steps and a BatchLoader epoch."""
    data = Frames()
    pred = Predictor(_model(device), HW, device=device)
    pred(data.images[0])
    model = _model(device)
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-4),
                               make_lr_schedule(1e-4), seed=0)
    step = make_train_step(2, augment_fn=make_augment_fn(MEAN, STD, crop_size=(32, 64)))
    loader = BatchLoader(data, 2, pad_multiple=32, seed=0, device=device)
    batches = list(loader.epoch())
    for b in batches:
        step(state, b)
    return state, len(batches)


def test_off_records_nothing_and_enters_no_record_function(off, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_clock", refuse)
    assert tracing.span("a") is tracing.span("b")       # one shared null context
    _drive()
    monkeypatch.undo()
    got = tracing.drain()
    assert got["spans"] == [] and got["syncs_outside"] == 0


def test_on_records_the_spans_with_parents_threads_and_units(off):
    import threading

    tracing.enable()
    state, n_batches = _drive()
    got = tracing.drain()
    tracing.disable()
    spans = got["spans"]
    by_id = {s.id: s for s in spans}
    main = threading.get_ident()

    def named(name):
        return [s for s in spans if s.name == name]

    (call,) = named("predict")
    assert call.parent is None and call.thread == main and call.unit == 0
    for name in ("predict.upload", "predict.forward", "predict.overlay",
                 "predict.fetch"):
        (s,) = named(name)
        assert s.parent == call.id and s.thread == main and s.unit == call.unit
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
    steps = named("step")
    assert [s.unit for s in steps] == list(range(n_batches)) == [0, 1]
    assert state.step == n_batches
    for name in ("step.forward", "step.backward", "step.update"):
        kids = named(name)
        assert len(kids) == n_batches
        for k in kids:
            parent = by_id[k.parent]
            assert parent.name == "step" and k.unit == parent.unit
            assert k.thread == main
    produce = named("loader.produce")
    assert [s.unit for s in produce] == list(range(n_batches))
    assert {s.thread for s in produce} != {main} and len({s.thread for s in produce}) == 1
    assert all(s.parent is None for s in produce)
    gets = named("loader.get")
    assert {s.thread for s in gets} == {main}
    # every batch, then the epoch's end, fetched
    assert [s.unit for s in gets] == list(range(n_batches + 1))
    assert {s.name for s in spans} == {
        "predict", "predict.upload", "predict.forward", "predict.overlay",
        "predict.fetch", "step", "step.forward", "step.backward", "step.update",
        "loader.produce", "loader.get"}
    assert len({s.id for s in spans}) == len(spans)
    assert all(s.end_ns >= s.start_ns and s.syncs == 0 for s in spans)


def test_on_enters_record_function_only_inside_a_profiler_session(off, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.profiler.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    tracing.enable()
    with tracing.span("alone"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("profiled"):
            pass
    assert [s.name for s in tracing.drain()["spans"]] == ["alone", "profiled"]
    assert entered == ["profiled"]


def test_predictor_label_and_confidence_paths(off):
    data = Frames()
    pred = Predictor(_model(), HW, device="cpu")
    tracing.enable()
    pred._fetch_labels(data.images[:2])
    pred.confidence(data.images[0])
    pred(data.images[1])
    spans = tracing.drain()["spans"]
    tracing.disable()
    roots = [s for s in spans if s.name == "predict"]
    assert [s.unit for s in roots] == [0, 1, 2]
    for r in roots:
        kids = sorted(s.name for s in spans if s.parent == r.id)
        want = ["predict.fetch", "predict.forward", "predict.upload"]
        assert kids == (sorted(want + ["predict.overlay"]) if r.unit == 2 else want)


def test_drain_clears_and_enable_starts_afresh(off):
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b", 7):
            pass
    first = tracing.drain()
    assert [(s.name, s.unit) for s in first["spans"]] == [("b", 7), ("a", 0)]
    assert first["spans"][0].parent == first["spans"][1].id
    assert tracing.drain()["spans"] == []
    with tracing.span("a"):
        pass
    tracing.enable()
    assert tracing.drain()["spans"] == []
    with tracing.span("a"):
        pass
    (s,) = tracing.drain()["spans"]
    assert s.unit == 0 and s.id == 1
    tracing.disable()
    with tracing.span("a"):
        pass
    assert tracing.drain()["spans"] == []


def test_sync_counter_is_a_no_op_without_cuda(off, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")

    def refuse(*a, **k):
        raise AssertionError("sync debug mode set without CUDA")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    show, filters = warnings.showwarning, list(warnings.filters)
    tracing.enable()
    assert warnings.showwarning is show and warnings.filters == filters
    with tracing.span("a"):
        torch.ones(3).sum().item()
    got = tracing.drain()
    tracing.disable()
    assert got["sync_counter"] is False and got["syncs_outside"] == 0
    assert [s.syncs for s in got["spans"]] == [0]


def test_sync_counter_counts_every_warning_on_the_innermost_span(off, monkeypatch):
    """With CUDA present (faked: the counter's logic alone), every sync
    warning counts, the same line twice included, on the innermost span of
    its thread; other warnings pass through; disable() restores the mode,
    the filters and ``showwarning``."""
    import threading

    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    show, filters = warnings.showwarning, list(warnings.filters)
    seen = []
    monkeypatch.setattr(warnings, "showwarning", lambda m, *a, **k: seen.append(str(m)))
    tracing.enable()
    assert modes[-1] == "warn"

    def sync():
        warnings.warn(tracing.SYNC_MESSAGE + " (Triggered internally)", UserWarning)

    with tracing.span("outer"):
        sync()
        with tracing.span("inner"):
            for _ in range(3):
                sync()
        warnings.warn("something else", UserWarning)
    sync()
    t = threading.Thread(target=lambda: [sync() for _ in range(2)])
    with tracing.span("waits"):
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    got = tracing.drain()
    tracing.disable()
    assert {s.name: s.syncs for s in got["spans"]} == {"inner": 3, "outer": 1, "waits": 0}
    assert got["syncs_outside"] == 3 and got["sync_counter"] is True
    assert seen == ["something else"]
    assert modes[-1] == "default"
    monkeypatch.undo()
    assert warnings.showwarning is show and warnings.filters == filters


def _kineto_starts(prof, name):
    """The host's ``record_function`` events called ``name`` (not their
    projections onto the device's timeline)."""
    cpu = torch.autograd.DeviceType.CPU
    return sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                  if e.name() == name and e.device_type() == cpu)


def _spin(seconds):
    """Waits on the clock without sleeping, so that the thread stays on its
    core and the next span is not stretched by a wake-up."""
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def _bracketed_session(monkeypatch, activities, work, n, pause):
    """``n`` spans around ``work()`` under one profiler session, each
    span's ``record_function`` entered through a wrapper that reads the
    clock again once it has entered. Returns, per span, (its event's
    kineto start, the mapped span start, the mapped clock after the
    enter) in epoch ns, and ``drain()``'s clock."""
    from torch.profiler import profile

    real, after = torch.profiler.record_function, []

    class Bracketed:
        def __init__(self, name):
            self.rf = real(name)

        def __enter__(self):
            self.rf.__enter__()
            after.append(time.perf_counter_ns())

        def __exit__(self, *exc):
            return self.rf.__exit__(*exc)

    monkeypatch.setattr(torch.profiler, "record_function", Bracketed)
    tracing.enable()
    with profile(activities=activities) as prof:
        for i in range(n):
            with tracing.span("mapped", i):
                work()
            _spin(pause)
    got = tracing.drain()
    tracing.disable()
    monkeypatch.undo()
    (p0, o0), (p1, o1) = got["clock"]["enable"], got["clock"]["drain"]

    def epoch(t):
        return t + o0 + round((o1 - o0) / (p1 - p0) * (t - p0))

    spans = [s for s in got["spans"] if s.name == "mapped"]
    want = _kineto_starts(prof, "mapped")
    assert len(want) == len(spans) == len(after) == n
    return [(k, epoch(s.start_ns), epoch(a)) for k, s, a in zip(want, spans, after)], got


def _outside(k, lo, hi):
    """How far ``k`` lies outside [lo, hi] (0 inside)."""
    return max(lo - k, k - hi, 0)


def _error_bounds(rows):
    """The bounds on the mapping's error e (a mapped time less kineto's)
    if each event truly lies inside its bracket and e is the same over the
    session: [max(k - hi), min(k - lo)] over the rows (k, lo, hi). Crossed
    bounds say e moved within the session."""
    return max(k - hi for k, _, hi in rows), min(k - lo for k, lo, _ in rows)


def test_a_span_maps_onto_its_record_function_event(off, monkeypatch):
    """A span's start, mapped through the clock offsets, and the clock
    read once its ``record_function`` has entered bracket the event's
    kineto start, within 1 ms on the CPU (the card's check: 50 us)."""
    from torch.profiler import ProfilerActivity

    rows, _ = _bracketed_session(monkeypatch, [ProfilerActivity.CPU],
                                 lambda: torch.ones(64).sum(), 20, 0.005)
    assert max(_outside(*r) for r in rows) < 1_000_000


@pytest.mark.cuda
def test_card_clock_residual_under_50us_at_both_ends(off):
    """In a device-only session, as the benchmark's program-traced stretch
    opens, over ~5 s: each span around one kernel launch holds, once
    mapped through the clock offsets, its ``cudaLaunchKernel`` event (the
    runtime call kineto stamps on the host); at the session's first and
    last span the event lies within 50 us of the mapped span (residuals
    printed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(100):
            with tracing.span("launch", i):
                x.add_(1)
            _spin(0.05)
        torch.cuda.synchronize()
    got = tracing.drain()
    tracing.disable()
    (p0, o0), (p1, o1) = got["clock"]["enable"], got["clock"]["drain"]

    def epoch(t):
        return t + o0 + round((o1 - o0) / (p1 - p0) * (t - p0))

    cpu = torch.autograd.DeviceType.CPU
    launches = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                      if e.device_type() == cpu and e.name().startswith("cudaLaunchKernel"))
    spans = sorted((epoch(s.start_ns), epoch(s.end_ns)) for s in got["spans"])
    assert len(launches) == len(spans) == 100
    rows = [(k, a, b) for k, (a, b) in zip(launches, spans)]
    out = [_outside(*r) for r in rows]
    after = sorted(k - a for k, a, _ in rows)
    width = sorted(b - a for _, a, b in rows)
    print(f"clock residual ns (event outside its mapped span): first {out[0]}, "
          f"last {out[-1]}, worst {max(out)}; event after the span's start: median "
          f"{after[50]}, range {after[0]}..{after[-1]}; span width median "
          f"{width[50]}; mapping error within {_error_bounds(rows)}; offset drift "
          f"{o1 - o0} ns over {(p1 - p0) / 1e9:.2f} s")
    assert out[0] < 50_000 and out[-1] < 50_000


@pytest.mark.cuda
def test_card_record_function_events_fall_in_their_enter_call(off, monkeypatch):
    """With the host recorded too, a ``record_function`` event's kineto
    start lies inside the mapped bracket [span start, clock once the enter
    returned], within 50 us, at the session's first and last span (the
    enter's cost, and the bounds that all 100 brackets put on the mapping's
    error, printed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity

    x = torch.randn(1024, 1024, device="cuda")
    rows, got = _bracketed_session(
        monkeypatch, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
        lambda: (x @ x).sum(), 100, 0.05)
    torch.cuda.synchronize()
    out = [_outside(*r) for r in rows]
    into = sorted(k - lo for k, lo, _ in rows)
    width = sorted(hi - lo for _, lo, hi in rows)
    lo, hi = _error_bounds(rows)
    print(f"record_function residual ns (outside the bracket): first {out[0]}, "
          f"last {out[-1]}, worst {max(out)}; event after the span's start: median "
          f"{into[50]}, range {into[0]}..{into[-1]}; enter bracket median "
          f"{width[50]}; mapping error within [{lo}, {hi}]")
    assert out[0] < 50_000 and out[-1] < 50_000


@pytest.mark.cuda
def test_card_counts_real_synchronizations(off):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(256, device="cuda")
    mode = torch.cuda.get_sync_debug_mode()
    tracing.enable()
    with tracing.span("item"):
        for _ in range(4):
            x.sum().item()
    with tracing.span("fetch"):
        x.cpu()
    with tracing.span("queued"):
        (x * 2).sum()
    got = tracing.drain()
    tracing.disable()
    syncs = {s.name: s.syncs for s in got["spans"]}
    print(f"syncs counted on the card: {syncs}")
    assert syncs["item"] == 4 and syncs["fetch"] >= 1 and syncs["queued"] == 0
    assert torch.cuda.get_sync_debug_mode() == mode


@pytest.mark.cuda
def test_card_predictor_and_step_spans(off):
    """The spans of the Predictor and the train step on the card, with
    their synchronizations (printed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tracing.enable()
    state, n = _drive("cuda")
    torch.cuda.synchronize()
    got = tracing.drain()
    tracing.disable()
    names = {s.name for s in got["spans"]}
    assert {"predict.fetch", "step.update", "loader.produce", "loader.get"} <= names
    syncs: dict = {}
    for s in got["spans"]:
        syncs[s.name] = syncs.get(s.name, 0) + s.syncs
    print(f"syncs by span on the card over 1 call, {n} steps: {syncs}, outside "
          f"{got['syncs_outside']}")
