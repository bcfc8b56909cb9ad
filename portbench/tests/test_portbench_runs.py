"""Runs of every cell at a tiny size on the CPU (the look for a card
skipped): the result line, the faults that must turn ``correct`` false, the
modules a run loads, the refusals; and, on a card, the control at the
cell's own size."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import runner
from portbench.tests.tiny import ROOT, shrink

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [c["name"] for c in BENCH["workloads"]]
KIND = {c: runner.load_cell(ROOT, c)["traffic"]["kind"] for c in CELLS}
FAULTS = {k: runner.mix_class(ROOT, k).FAULTS for k in set(KIND.values())}
BANNED = {"jax", "jaxlib", "flax", "semanticsegmentation_tensorflow_tpu"}


def tiny_run(capsys, cell: str, trace: int = 0, fault: str | None = None):
    """(exit code, result line, standard error) of a tiny CPU run."""
    rc = runner.main(["--workload", cell, "--seed", "2147483641", "--seconds",
                      "0.5", "--trace", str(trace)], ROOT, time.time(),
                     device=torch.device("cpu"), shrink=shrink, fault=fault)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, json.loads(lines[-1]) if rc == 0 else None, out.err


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_the_result_line(capsys, cell, trace):
    rc, res, err = tiny_run(capsys, cell, trace)
    assert rc == 0
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in runner.reported(BENCH, cell, bool(trace))}
    assert set(res["metrics"]) <= want
    if not trace:      # the end-to-end metrics need no device trace
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    limits = runner.load_cell(ROOT, cell)["limits"]
    assert set(res["checks"]) == set(limits)
    tail = err.strip().splitlines()[-len(limits):]
    assert [line.split()[1] for line in tail] == list(limits)
    assert all(line.startswith("check ") and " limit " in line for line in tail)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[KIND[c]]])
def test_a_fault_under_the_timed_path_is_not_correct(capsys, cell, fault):
    rc, res, _ = tiny_run(capsys, cell, fault=fault)
    assert rc == 0 and res["correct"] is False


def test_a_run_loads_no_jax(tmp_path):
    """A run of each kind, in a fresh interpreter: no module whose top-level
    name is JAX's or the JAX package's (compared whole: the port's name
    begins with the JAX package's)."""
    code = (
        "import json, sys, time, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench.harness import runner\n"
        "from portbench.tests.tiny import shrink\n"
        "for cell in sys.argv[1:]:\n"
        "    assert runner.main(['--workload', cell, '--seed', '5', '--seconds',\n"
        "                        '0.3', '--trace', '1'], "
        f"{ROOT!r}, time.time(),\n"
        "                       device=torch.device('cpu'), shrink=shrink) == 0\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    cells = [next(c for c in CELLS if KIND[c] == k) for k in sorted(set(KIND.values()))]
    out = subprocess.run([sys.executable, "-c", code, *cells], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "semanticsegmentation_tensorflow_tpu_torch" in loaded
    assert not loaded & BANNED


def test_refuses_without_the_port(tmp_path):
    """In a directory of only BENCHMARK.json and the benchmark's files a
    run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = runner.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                      "--trace", "0"], ROOT, time.time())
    assert rc == 3
    assert not any(line.startswith("{")
                   for line in capsys.readouterr().out.splitlines())


def test_an_unknown_kind_has_no_driver():
    with pytest.raises(ValueError, match="no kinds file"):
        runner.mix_class(ROOT, "replay")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    """The program with its mix's ``control`` settings, its own
    lower-precision path (QAT's int8 grids for training, the int8
    Predictor for frames), at the cell's own size fails one of the cell's
    limits."""
    unit = runner.load_cell(ROOT, cell)
    mix = runner.mix_class(ROOT, unit["traffic"]["kind"])(
        torch, unit["cfg"], unit["traffic"], 2147483629, [card], control=True)
    mix.build()
    mix.first_steps()
    mix.window(2.0)
    mix.after_window()
    mix.release()
    got = mix.readings()
    assert any(got[k] > v for k, v in unit["limits"].items())
