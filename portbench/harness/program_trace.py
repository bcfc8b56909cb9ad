"""The program's own spans and sync counter (the port's ``utils/tracing.py``)
over a stretch of a traced run, and the device's idle time put down to the
span the host was in, on one clock.

After the traced tail, the first reader of a program-traced metric runs
the stretch once (:func:`stretch`; the others read what it left in the
run's record): ``5 x traced_tail`` units with the program's tracing on,
the last ``traced_tail`` of them under one device-only profiler session.
Each span is placed on the profiler's timeline (the Unix epoch's clock, on
which kineto stamps its events) by the offset the program reads at
``enable()`` and ``drain()``, interpolated between the two. The session's
wall runs from the host clock as its first unit starts to the return of
its final synchronize; the device's idle time is that wall less the union
of its ops' intervals, split at the main thread's span boundaries and
given to the innermost span open there, or to ``outside`` (:func:`attribute`).

A program without ``utils/tracing.py`` gives nothing to read (None), as
does a session that saw no device op.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
import traceback
from collections import defaultdict

from portbench.harness import trace

OUTSIDE = "outside"
KEY = "program_trace"


def attribute(wall: tuple[int, int], device: list[tuple[int, int]],
              spans: list[tuple[int, int, object]]) -> dict:
    """The idle time of ``wall`` (start, end) split by span: ``device`` the
    device ops' (start, end), ``spans`` one thread's (start, end, label),
    nested or disjoint, all on one clock in one unit. Each stretch between
    two span boundaries where the device is idle goes to the label of the
    innermost span open over it (the one that started last), or to None
    where no span is open; the idle before the first op and after the last
    counts like any other. Device time outside the wall is left out
    (``clipped``). ``busy + sum(idle.values()) == wall`` exactly, in
    integers."""
    w0, w1 = wall
    clipped = [(max(a, w0), min(b, w1)) for a, b in device]
    inside = [(a, b) for a, b in clipped if b > a]
    busy = trace.merged(inside)
    starts = [a for a, _ in busy]
    before = [0]
    for a, b in busy:
        before.append(before[-1] + b - a)

    def busy_to(t: int) -> int:
        """Busy time in [w0, t]."""
        i = bisect.bisect_right(starts, t)
        return 0 if i == 0 else before[i - 1] + min(t, busy[i - 1][1]) - busy[i - 1][0]

    points = sorted({w0, w1} | {t for s, e, _ in spans for t in (s, e) if w0 < t < w1})
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    idle: dict = defaultdict(int)
    open_: list = []
    j = 0
    for a, b in zip(points, points[1:]):
        while j < len(order) and order[j][0] <= a:
            open_.append(order[j])
            j += 1
        # no boundary lies inside (a, b): a span still open at a is open to b
        open_ = [s for s in open_ if s[1] > a]
        label = max(open_, key=lambda s: (s[0], -s[1]))[2] if open_ else None
        gap = (b - a) - (busy_to(b) - busy_to(a))
        if gap:
            idle[label] += gap
    return {"wall": w1 - w0, "busy": before[-1], "idle": dict(idle),
            "lead": (busy[0][0] if busy else w1) - w0,
            "trail": w1 - (busy[-1][1] if busy else w1),
            "clipped": sum(b - a for a, b in device) - sum(b - a for a, b in inside)}


def to_epoch(clock: dict):
    """perf_counter_ns -> the Unix epoch's ns, by the offsets the program
    read at ``enable()`` and ``drain()``, interpolated linearly."""
    (p0, o0), (p1, o1) = clock["enable"], clock["drain"]
    slope = (o1 - o0) / (p1 - p0) if p1 != p0 else 0.0
    return lambda t: t + o0 + round(slope * (t - p0))


def _device_ops(torch, prof, spans: set[str]) -> list[tuple[int, int]]:
    """The session's device ops (kernels, copies, sets; not the projections
    of the ``spans`` onto the device's timeline) as (start, end) in the
    epoch's ns."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.name() not in spans]


def stretch(rec: dict) -> dict | None:
    """The program-traced stretch of this run (module docstring), run at
    the first call and kept in ``rec``; None where the program has no
    tracing."""
    if KEY not in rec:
        try:
            rec[KEY] = _run(rec)
        except Exception:    # the run goes on; its metrics read nothing
            traceback.print_exc()
            rec[KEY] = None
    return rec[KEY]


def _run(rec: dict) -> dict | None:
    try:
        from semanticsegmentation_tensorflow_tpu_torch.utils import tracing
    except ImportError:                  # a program without its own tracing
        return None
    from torch.profiler import profile

    torch, mix = rec["torch"], rec["mix"]
    tail = rec["traffic"]["traced_tail"]
    main = threading.get_ident()
    trace._sync(torch)
    tracing.enable()
    try:
        mix.run_units(4 * tail)
        trace._sync(torch)
        with profile(activities=trace._activities(torch)) as prof:
            t0 = time.perf_counter_ns()
            mix.run_units(tail)
            trace._sync(torch)
            t1 = time.perf_counter_ns()
        got = tracing.drain()
    finally:
        tracing.disable()
    spans = got["spans"]
    out = {"units": 5 * tail, "unit": mix.unit, "spans": spans, "main": main,
           "sync_counter": got["sync_counter"], "syncs_outside": got["syncs_outside"],
           "drift_ns": got["clock"]["drain"][1] - got["clock"]["enable"][1],
           "session": None}
    device = _device_ops(torch, prof, {s.name for s in spans})
    if device:
        epoch = to_epoch(got["clock"])
        mine = [(epoch(s.start_ns), epoch(s.end_ns), s.id) for s in spans
                if s.thread == main]
        out["session"] = attribute((epoch(t0), epoch(t1)), device, mine)
        out["session"]["ops"] = len(device)
    _log(out, tail)
    return out


def names(pt: dict) -> dict[int, str]:
    return {s.id: s.name for s in pt["spans"]}


def under(pt: dict, roots: tuple[str, ...]) -> set[int]:
    """Ids of the spans called one of ``roots`` and of every span inside
    one of them."""
    parent = {s.id: s.parent for s in pt["spans"]}
    name = names(pt)
    found = set()
    for sid in parent:
        k = sid
        while k is not None and k in name:
            if name[k] in roots:
                found.add(sid)
                break
            k = parent[k]
    return found


def idle_by_name(pt: dict) -> dict[str, int] | None:
    """The session's idle ns by the name of the span it went to."""
    if pt is None or pt["session"] is None:
        return None
    name = names(pt)
    out: dict[str, int] = defaultdict(int)
    for sid, ns in pt["session"]["idle"].items():
        out[OUTSIDE if sid is None else name[sid]] += ns
    return dict(out)


def idle_pct_under(rec: dict, roots: tuple[str, ...]) -> float | None:
    """100 x the session's idle while the main thread was inside a span
    called one of ``roots`` (or a span inside one), over its wall."""
    pt = stretch(rec)
    if pt is None or pt["session"] is None or not pt["session"]["wall"]:
        return None
    ids = under(pt, roots)
    if not ids:
        return None
    s = pt["session"]
    return 100.0 * sum(ns for sid, ns in s["idle"].items() if sid in ids) / s["wall"]


def mean_ms(rec: dict, name: str) -> float | None:
    """Mean duration of the stretch's spans called ``name``, in ms."""
    pt = stretch(rec)
    d = [s.end_ns - s.start_ns for s in (pt or {}).get("spans", ()) if s.name == name]
    return sum(d) / len(d) / 1e6 if d else None


def per_unit_ms(rec: dict, parts: tuple[str, ...], unit: str) -> float | None:
    """The stretch's time in spans called one of ``parts``, in ms, per span
    called ``unit``."""
    pt = stretch(rec)
    spans = (pt or {}).get("spans", ())
    n = sum(s.name == unit for s in spans)
    d = [s.end_ns - s.start_ns for s in spans if s.name in parts]
    return sum(d) / n / 1e6 if n and d else None


def syncs_per(rec: dict, root: str) -> float | None:
    """Synchronizations counted in spans called ``root`` and inside them,
    per ``root`` span; None where the program counted none (no CUDA)."""
    pt = stretch(rec)
    if pt is None or not pt["sync_counter"]:
        return None
    n = sum(s.name == root for s in pt["spans"])
    if not n:
        return None
    ids = under(pt, (root,))
    return sum(s.syncs for s in pt["spans"] if s.id in ids) / n


def _log(pt: dict, tail: int) -> None:
    """One line: the session's wall, busy and idle by span (ms), and the
    stretch's syncs per unit by span."""
    syncs: dict[str, int] = defaultdict(int)
    for s in pt["spans"]:
        syncs[s.name] += s.syncs
    syncs[OUTSIDE] += pt["syncs_outside"]
    line = {"units": pt["units"], "profiled": tail, "unit": pt["unit"],
            "syncs_per_unit": ({k: v / pt["units"] for k, v in sorted(syncs.items()) if v}
                               if pt["sync_counter"] else None),
            "clock_drift_ns": pt["drift_ns"]}
    s = pt["session"]
    if s is not None:
        idle = idle_by_name(pt)
        line.update(wall_ms=s["wall"] / 1e6, busy_ms=s["busy"] / 1e6,
                    idle_ms={k: v / 1e6 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
                    lead_ms=s["lead"] / 1e6, trail_ms=s["trail"] / 1e6,
                    reconcile_ns=s["busy"] + sum(idle.values()) - s["wall"],
                    clipped_ms=s["clipped"] / 1e6, ops=s["ops"])
    print("program trace: " + json.dumps(line), flush=True)
