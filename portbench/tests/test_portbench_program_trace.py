"""The program-traced stretch (``harness/program_trace.py``): the idle
attribution on synthetic intervals, traced tiny runs of every cell on the
CPU (the span metrics read numbers; the sync counter and the device's idle
nothing), and a program without its own tracing, which gives nothing to
read."""

import json
import sys
import time

import pytest
import torch

from portbench.harness import program_trace, runner
from portbench.tests.tiny import ROOT, shrink

with open(f"{ROOT}/BENCHMARK.json") as _f:
    BENCH = json.load(_f)
CELLS = [c["name"] for c in BENCH["workloads"]]
NAMES = ("loader_get_ms.train", "loader_produce_ms.train", "step_launch_ms.train",
         "step_syncs.train", "launch_idle_pct.train", "predict_launch_ms.frame",
         "predict_fetch_ms.frame", "launch_idle_pct.frame")
NEW = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NAMES}


def test_attribute_nested_spans_and_both_edges():
    # wall 0..100; device busy 10..20, 30..35, 60..90; spans: A 5..50 holding
    # B 25..40, C 55..70; nothing open 50..55 and 70..100
    got = program_trace.attribute(
        (0, 100), [(10, 20), (30, 35), (60, 90)],
        [(5, 50, "A"), (25, 40, "B"), (55, 70, "C")])
    assert got["busy"] == 10 + 5 + 30 and got["wall"] == 100
    # idle: 0..5 none, 5..10 A, 20..25 A, 25..30 B, 35..40 B, 40..50 A,
    # 50..55 none, 55..60 C, 90..100 none
    assert got["idle"] == {None: 5 + 5 + 10, "A": 5 + 5 + 10, "B": 10, "C": 5}
    assert got["busy"] + sum(got["idle"].values()) == got["wall"]
    assert got["lead"] == 10 and got["trail"] == 10 and got["clipped"] == 0


def test_attribute_clips_ops_outside_the_wall_and_overlaps():
    got = program_trace.attribute(
        (100, 200), [(50, 120), (110, 130), (190, 260)], [(90, 150, 1), (150, 210, 2)])
    assert got["busy"] == 30 + 10
    assert got["idle"] == {1: 20, 2: 40}
    assert got["busy"] + sum(got["idle"].values()) == 100
    assert got["clipped"] == (70 + 20 + 70) - (20 + 20 + 10)
    assert got["lead"] == 0 and got["trail"] == 0


def test_attribute_without_device_ops_or_spans():
    got = program_trace.attribute((0, 50), [], [])
    assert got == {"wall": 50, "busy": 0, "idle": {None: 50}, "lead": 50,
                   "trail": 0, "clipped": 0}
    got = program_trace.attribute((0, 50), [(0, 50)], [(10, 20, "x")])
    assert got["idle"] == {} and got["busy"] == 50


def test_attribute_reconciles_on_random_intervals():
    import random

    rng = random.Random(5)
    for _ in range(50):
        w0, w1 = sorted(rng.sample(range(10_000), 2))
        dev = [tuple(sorted(rng.sample(range(-500, 10_500), 2))) for _ in range(40)]
        spans, t = [], rng.randrange(-200, 200)
        while t < 10_000:                  # disjoint outer spans, each with a child
            a, b = t, t + rng.randrange(50, 600)
            c = rng.randrange(a, b)
            spans += [(a, b, ("outer", a)), (c, rng.randrange(c, b + 1), ("inner", a))]
            t = b + rng.randrange(0, 300)
        got = program_trace.attribute((w0, w1), dev, spans)
        assert got["busy"] + sum(got["idle"].values()) == w1 - w0
        assert all(v > 0 for v in got["idle"].values())


def test_to_epoch_interpolates_the_offsets():
    f = program_trace.to_epoch({"enable": (1000, 5000), "drain": (3000, 5010)})
    assert f(1000) == 6000 and f(3000) == 8010 and f(2000) == 2000 + 5005


def test_the_new_entries_read_the_stretch():
    assert len(NEW) == 8
    for m in NEW.values():
        assert len(m["workloads"]) == 1 and m["better"] == "lower"
        assert m["source"] == ("device_trace" if "idle" in m["name"] else
                               "program_counter" if "syncs" in m["name"] else
                               "program_span")


def _tiny(capsys, cell):
    rc = runner.main(["--workload", cell, "--seed", "2147483641", "--seconds",
                      "0.5", "--trace", "1"], ROOT, time.time(),
                     device=torch.device("cpu"), shrink=shrink)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]), out


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reads_the_spans(capsys, cell):
    rc, res, out = _tiny(capsys, cell)
    assert rc == 0 and res["correct"] is True
    mine = [n for n, m in NEW.items() if cell in m["workloads"]]
    assert mine
    for name in mine:
        if "idle" in name or "syncs" in name:    # no device, no sync counter
            assert name not in res["metrics"]
            assert f"{name}: nothing to read" in out
        else:
            v = res["metrics"][name]["value"]
            assert isinstance(v, float) and v > 0
    (line,) = [s for s in out if s.startswith("program trace: ")]
    got = json.loads(line.split(": ", 1)[1])
    assert got["units"] == 5 * 3 and got["syncs_per_unit"] is None
    assert "wall_ms" not in got                  # the CPU session saw no device op


def test_a_program_without_its_tracing_reads_nothing(monkeypatch):
    """A program from before ``utils/tracing.py``: every new reader reads None."""
    from semanticsegmentation_tensorflow_tpu_torch import utils

    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules,
                        "semanticsegmentation_tensorflow_tpu_torch.utils.tracing", None)
    rec = {"torch": torch, "mix": None, "traffic": {"traced_tail": 3}}
    for name in NEW:
        assert runner.reader(ROOT, name)(rec) is None
    assert rec[program_trace.KEY] is None
