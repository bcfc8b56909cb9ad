"""The port's own tracing: named host spans and a count of host-device
synchronizations, kept in memory and placed on the profiler's clock.

Off by default. Off, :func:`span` checks one module flag and returns a
shared null context: no clock is read, no ``record_function`` entered,
nothing allocated. :func:`enable` turns it on for the whole process; the
program itself never does (a benchmark, a smoke script or a test does).

On, every span records its name, thread, id, parent (the span open around
it on the same thread), unit (given by the caller: the train step's
``state.step``, the loader's batch index; else the parent's; else the
count of earlier outermost spans of that name since :func:`enable`, which
numbers the Predictor's calls) and start and end on
``time.perf_counter_ns``. While a profiler session is open, each span also
enters ``torch.profiler.record_function(name)``, so the session holds it
too. With a CUDA device, every synchronization that
torch reports under ``torch.cuda.set_sync_debug_mode("warn")`` (``.item()``,
a copy to pageable host memory, ``nonzero``, ...) is counted, silently, on
the innermost span open on the thread that made it (a synchronization on
a thread that torch runs itself, such as gloo's workers, reaches no Python
warning filter: torch prints it and it is not counted).

:func:`drain` hands back what was recorded and clears it, with two
readings of ``time.time_ns() - time.perf_counter_ns()`` (at :func:`enable`
and at :func:`drain`): the profiler stamps its events on the Unix epoch's
clock, so a span's ``start_ns + offset`` lies on the profiler's timeline.

Span names: ``predict``, ``predict.upload``, ``predict.forward``,
``predict.overlay``, ``predict.replay``, ``predict.capture``,
``predict.fetch`` (``infer/predict.py``); ``step``,
``step.forward``, ``step.backward``, ``step.update`` (``train/step.py``);
``loader.produce``, ``loader.get`` (``data/pipeline.py``);
``halo_exchange`` (``parallel/halo.py``), ``grid_all_reduce``
(``train/step.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings
from collections import defaultdict
from typing import NamedTuple

import torch

SYNC_MESSAGE = "called a synchronizing CUDA operation"

_clock = time.perf_counter_ns
_on = False
_NULL = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()
_done: list = []
_ids = itertools.count(1)
_roots: dict[str, int] = defaultdict(int)
_enabled_at: tuple[int, int] | None = None
_syncs_outside = 0
_restore: list = []     # what disable() puts back: warning state, sync mode,
                        # warnings.showwarning
_counting = False


class Span(NamedTuple):
    name: str
    thread: int          # threading.get_ident() of the thread it ran on
    id: int
    parent: int | None   # the enclosing span on the same thread
    unit: int | None
    start_ns: int        # time.perf_counter_ns()
    end_ns: int
    syncs: int           # synchronizations made while it was innermost


class _Open:
    __slots__ = ("name", "id", "parent", "unit", "rf", "start", "syncs")

    def __init__(self, name: str, unit: int | None):
        self.name, self.unit, self.rf = name, unit, None

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        if self.unit is None:
            if outer is not None:
                self.unit = outer.unit
            else:
                with _lock:
                    self.unit = _roots[self.name]
                    _roots[self.name] += 1
        self.syncs = 0
        # the span holds its record_function event, overhead included
        self.start = _clock()
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = _clock()
        _done.append(Span(self.name, threading.get_ident(), self.id, self.parent,
                          self.unit, self.start, end, self.syncs))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, unit: int | None = None):
    """A context manager: one span called ``name`` while tracing is on, a
    shared null context while it is off."""
    if not _on:
        return _NULL
    return _Open(name, unit)


def _clock_offset() -> tuple[int, int]:
    """(perf_counter_ns, time_ns - perf_counter_ns), from the closest of
    three bracketed reads."""
    best = None
    for _ in range(3):
        a = _clock()
        t = time.time_ns()
        b = _clock()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, t)
    _, mid, t = best
    return mid, t - mid


def _count_sync(message, category, filename, lineno, file=None, line=None):
    global _syncs_outside
    if not str(message).startswith(SYNC_MESSAGE):
        return _restore[2](message, category, filename, lineno, file, line)
    stack = _stack()
    if stack:
        stack[-1].syncs += 1
    else:
        with _lock:
            _syncs_outside += 1


def enable() -> None:
    """Turns tracing on, from an empty record: spans from here, and with a
    CUDA device the synchronization counter."""
    global _on, _enabled_at, _syncs_outside, _counting, _ids
    if _on:
        disable()
    _done.clear()
    _roots.clear()
    _ids = itertools.count(1)
    _syncs_outside = 0
    _counting = torch.cuda.is_available()
    if _counting:
        saved = warnings.catch_warnings()
        saved.__enter__()
        _restore[:] = [saved, torch.cuda.get_sync_debug_mode(), warnings.showwarning]
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        warnings.showwarning = _count_sync
        torch.cuda.set_sync_debug_mode("warn")
    _enabled_at = _clock_offset()
    _on = True


def disable() -> None:
    """Turns tracing off: the sync debug mode, the warning filters and
    ``warnings.showwarning`` go back as they were. What was recorded stays
    until :func:`drain` or the next :func:`enable`."""
    global _on
    _on = False
    if _restore:
        saved, mode, _ = _restore
        torch.cuda.set_sync_debug_mode(mode)
        saved.__exit__(None, None, None)
        _restore.clear()


def drain() -> dict:
    """What was recorded since :func:`enable` or the last drain, cleared:
    ``spans`` (finished :class:`Span` s, every thread, in the order they
    ended), ``syncs_outside`` (synchronizations made under no span),
    ``sync_counter`` (whether synchronizations were counted: a CUDA device
    was present), and ``clock``: ``enable`` and ``drain``, each a pair
    (perf_counter_ns, time_ns - perf_counter_ns) read then."""
    global _syncs_outside
    spans = _done[:]
    del _done[:len(spans)]
    with _lock:
        outside, _syncs_outside = _syncs_outside, 0
    return {"spans": spans, "syncs_outside": outside, "sync_counter": _counting,
            "clock": {"enable": _enabled_at, "drain": _clock_offset()}}
