"""Reading the device from ``torch.profiler``: busy time as the union of the
device ops' intervals, device time per call of an entry, and idle gaps
named by the benchmark's own span that was open on the host.

The profiler loses device events only after tens of sessions in one
process; a run opens at most four, each over a fixed short piece of work. A
session that saw no device op reads as nothing (None), never as 0.
"""

from __future__ import annotations

import time
from collections import defaultdict


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def group(name: str) -> str:
    """The kind of a device op, by its kernel name."""
    low = name.lower()
    if any(k in low for k in ("stage1_", "preprocess_kernel", "pool_argmax",
                              "unpool", "winograd_", "overlay")):
        return "port kernels"
    if any(k in low for k in ("conv", "cudnn", "xmma", "cutlass", "gemm",
                              "wgrad", "dgrad", "fprop")):
        return "convolutions and GEMMs"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise and reductions"


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _activities(torch, host: bool = False) -> list:
    """The profiler's activities: the device's, and the host's where asked
    or where there is no card (a session then reads no device op)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    return acts + [ProfilerActivity.CPU] if host or not acts else acts


def _device_events(torch, prof) -> list:
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_seconds_per_call(torch, fn, calls: int, warmup: int = 3) -> float | None:
    """Summed duration of every device op that ``calls`` calls of ``fn``
    launch, per call (host gaps between them excluded): the time of
    whatever implements the entry. None when the profiler saw no op."""
    import warnings

    from torch.profiler import profile

    for _ in range(warmup):
        fn()
    _sync(torch)
    with warnings.catch_warnings(), profile(activities=_activities(torch)) as prof:
        warnings.simplefilter("ignore")
        for _ in range(calls):
            fn()
        _sync(torch)
    total_us = sum(e.self_device_time_total for e in _device_events(torch, prof))
    return total_us / 1e6 / calls if total_us > 0 else None


def busy_session(torch, run_units, units: int) -> dict | None:
    """``run_units(units)`` under one device-only profiler session:
    ``busy_s`` (the union of the device ops' intervals), ``wall_s`` (the
    host clock over the same work, ending in a synchronize), ``ops`` and
    ``by_op`` (seconds by kernel name). None when no device op was seen."""
    import warnings

    from torch.profiler import profile

    _sync(torch)
    with warnings.catch_warnings(), profile(activities=_activities(torch)) as prof:
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        run_units(units)
        _sync(torch)
        wall = time.perf_counter() - t0
    events = _device_events(torch, prof)
    if not events:
        return None
    by_op: dict[str, float] = defaultdict(float)
    spans = []
    for e in events:
        by_op[e.name] += e.self_device_time_total / 1e6
        spans.append((e.time_range.start, e.time_range.end))
    return {"busy_s": union_seconds(spans) / 1e6, "wall_s": wall,
            "ops": len(events), "by_op": dict(by_op)}


def idle_by_span(torch, run_units, units: int, names: tuple[str, ...]) -> dict | None:
    """``run_units(units)`` under one profiler session of host and device,
    the benchmark's spans recorded with ``record_function`` under
    ``names``: the device's idle gaps (between the union's intervals)
    summed by the innermost of those spans open on the host at each gap's
    middle ("other" where none is), in seconds (``by_span``), beside the
    session's first-to-last device time and busy time. None without
    device ops."""
    import warnings

    from torch.profiler import profile

    _sync(torch)
    with warnings.catch_warnings(), profile(
            activities=_activities(torch, host=True)) as prof:
        warnings.simplefilter("ignore")
        run_units(units)
        _sync(torch)
    events = prof.events()
    dev = merged([(e.time_range.start, e.time_range.end)
                  for e in _device_events(torch, prof)])
    if not dev:
        return None
    spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.name in names),
                   key=lambda s: s[1] - s[0])
    gaps: dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(dev, dev[1:]):
        mid = (a + b) / 2
        name = next((n for s, e, n in spans if s <= mid <= e), "other")
        gaps[name] += (b - a) / 1e6
    return {"by_span": dict(gaps), "device_span_s": (dev[-1][1] - dev[0][0]) / 1e6,
            "busy_s": union_seconds(dev) / 1e6}


def top(items: dict[str, float], k: int = 10) -> list[list]:
    return [[n, v] for n, v in sorted(items.items(), key=lambda kv: -kv[1])[:k]]


def grouped_ops(by_op: dict[str, float], k: int = 10) -> list[list]:
    """The ``k`` device ops that took most time, each named by its group
    and its kernel name (cut to 120 characters)."""
    named: dict[str, float] = defaultdict(float)
    for n, v in by_op.items():
        named[f"{group(n)}: {n[:120]}"] += v
    return top(named, k)
