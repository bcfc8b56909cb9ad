"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
configuration, mix, limits and metric readers are found by name."""

import json
import os
import re

import pytest

from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][:2] == ["python3", "portbench/run.py"]
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
        assert _line(c["why"]) and c["chips"] in (1, 4)
    for c in bench["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for c in bench["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_reports_what_it_must(bench):
    from portbench.harness.runner import reported

    e2e_names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e_names
    cells = {c["name"] for c in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e_names
        for cell in m.get("workloads", ()):
            assert m["moves"] in {e["name"] for e in reported(bench, cell, False)}
        if "%" == m["unit"]:
            assert "roofline" in m["name"] or "mfu" in m["name"] or "idle" in m["name"]
    for cell in cells:
        e2e = {m["name"] for m in reported(bench, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert reported(bench, cell, True)
    used = {c["config"] for c in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    four = sum(c["chips"] == 4 for c in bench["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_files_found_by_name(bench):
    from portbench.harness.runner import load_cell, mix_class, reader
    from portbench.reference.models import find

    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and c["file"].endswith(".json")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        model = find(cfg["model"])
        assert model.param_specs(cfg) and model.stride(cfg) > 0
    for c in bench["workloads"]:
        unit = load_cell(ROOT, c["name"])
        mix = mix_class(ROOT, unit["traffic"]["kind"])
        assert mix.FAULTS and callable(mix.plant) and callable(mix.after_window)
        assert unit["limits"] and all(isinstance(v, (int, float))
                                      for v in unit["limits"].values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reader(ROOT, m["name"]))


def test_configs_are_the_port_presets(bench):
    """Each configuration runs its preset as ``scripts/train.py`` would."""
    from semanticsegmentation_tensorflow_tpu_torch.config import get_preset

    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        p = get_preset(cfg["preset"])
        assert cfg["model"] == p.model and cfg["model_kwargs"] == p.model_kwargs
        assert cfg["batch_size"] == p.train.batch_size
        assert tuple(cfg["crop_size"]) == p.data.crop_size
        assert tuple(cfg["image_size"]) == p.data.image_size
        assert cfg["num_classes"] == p.data.num_classes
        assert cfg["dataset"] == p.data.dataset
        assert cfg["learning_rate"] == p.train.learning_rate
        assert cfg["optimizer"] == p.train.optimizer
        assert tuple(cfg["mean"]) == p.data.mean and tuple(cfg["std"]) == p.data.std
