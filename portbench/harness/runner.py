"""One run of one cell: ``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration file there, its mix ``portbench/traffic/<traffic>.json``,
its limits ``portbench/limits/<cell>.json``; the mix's ``kind`` names the
traffic driver, the ``Mix`` of ``portbench/kinds/<kind>.py``; each metric
is the ``read`` function of ``portbench/metrics/<metric>.py``; the
configuration's ``model`` names its reference,
``portbench/reference/models/<model>.py``. The run:

1. refuses (exit 3, no result) without as many CUDA cards as the cell asks;
   the driver is handed that many;
2. builds the program and drives it through its checked first steps or
   warm-up requests (set-up; ``setup_s`` runs from the process's start to
   here);
3. measures for ``--seconds``, with the host's spans recorded when traced;
4. reads the devices' peak memory over the window (reset after set-up);
   runs what the driver checks right after the window (training: three
   more steps); traced, runs the tail under the profiler and the
   per-layer readers; untraced, the end-to-end readers;
5. frees the program and compares what it produced with the plain
   reference (``portbench/reference``), each number against its limit;
6. refuses (exit 4, no result) if JAX or the JAX package is loaded;
7. prints each compared number beside its limit as the last lines of
   standard error, and the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

from portbench.harness import trace as trace_mod

BANNED = ("jax", "jaxlib", "flax", "semanticsegmentation_tensorflow_tpu")
PORT = "semanticsegmentation_tensorflow_tpu_torch"


def process_age(fallback_start: float) -> float:
    """Seconds since this process started (``/proc``: its start in clock
    ticks since boot against the system's uptime); where that cannot be
    read, since ``fallback_start`` (``time.time()``)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if 0 <= age < 3600:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.time() - fallback_start


def load_cell(root: str, name: str) -> dict:
    """The cell's entries and files, found by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, config["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(root, "portbench", "limits", name + ".json")) as f:
        limits = json.load(f)
    return {"bench": bench, "cell": cell, "cfg": cfg, "traffic": traffic,
            "limits": limits}


def reported(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: untraced its end-to-end
    metrics, traced the per-layer metrics whose moved metric it reports
    (those that list cells: only in them)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def found(root: str, folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py``; raises where there is
    none."""
    path = os.path.join(root, "portbench", folder, name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no {folder} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(root: str, metric: str):
    """``read`` of ``portbench/metrics/<metric>.py``."""
    return found(root, "metrics", metric).read


def mix_class(root: str, kind: str):
    """``Mix`` of ``portbench/kinds/<kind>.py``: the traffic driver."""
    return found(root, "kinds", kind).Mix


def banned_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def launch_counts() -> dict[str, int]:
    """The port's kernel launch counters (``<wrapper>.launches`` of its
    ``ops.cuda`` modules) as they stand."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith(PORT + ".ops.cuda."):
            continue
        for attr, fn in vars(mod).items():
            n = getattr(fn, "launches", None)
            if isinstance(n, int) and getattr(fn, "__module__", None) == name:
                out[f"{name.rsplit('.', 1)[1]}.{attr}"] = n
    return out


def card_line(torch) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
        return smi[0] if smi else torch.cuda.get_device_name(0)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def run(torch, root: str, unit: dict, seed: int, seconds: float, traced: bool,
        devices: list, started: float, fault: str | None = None,
        log=print) -> dict:
    """Steps 2-5 of the module docstring on ``devices``: the result."""
    bench, cell, cfg, traffic = (unit[k] for k in ("bench", "cell", "cfg", "traffic"))
    mix = mix_class(root, traffic["kind"])(torch, cfg, traffic, seed, devices)
    cuda = devices[0].type == "cuda"
    built_at = process_age(started)
    mix.build()
    if fault:
        mix.plant(fault)
    first_at = process_age(started)
    mix.first_steps()
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = process_age(started)
    log(f"set-up: {built_at:.2f} s to the build, {first_at - built_at:.2f} s "
        f"building, {setup_s - first_at:.2f} s of first steps")
    launches0 = launch_counts()
    spans: list = []

    @contextlib.contextmanager
    def span(name):
        start = time.perf_counter()
        yield
        spans.append((name, start, time.perf_counter()))

    window = mix.window(seconds, span) if traced else mix.window(seconds)
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    launches = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()}
    mix.after_window()
    log(f"window: {window['units']} {mix.unit} in {window['seconds']:.4f} s; "
        f"setup {setup_s:.3f} s; peak {peak / 2**30:.3f} GiB; launches "
        + json.dumps({k: v for k, v in launches.items() if v}))
    rec = {"torch": torch, "mix": mix, "cfg": cfg, "traffic": traffic,
           "window": window, "spans": spans, "setup_s": setup_s,
           "device": devices[0]}
    result = {"correct": False, "attempted": window["units"], "failed": 0,
              "metrics": {}}
    device_info = {"platform": "gpu" if cuda else devices[0].type,
                   "kind": (torch.cuda.get_device_name(devices[0]) if cuda
                            else devices[0].type),
                   "count": len(devices), "memory_peak_bytes": int(peak)}
    tail = None
    if traced:
        tail = mix.tail(traffic["traced_tail"])
        rec["tail"] = tail
        busy = tail["busy"]
        if busy is not None:
            device_info.update(busy_s=busy["busy_s"], window_s=busy["wall_s"])
            log(f"traced tail: {traffic['traced_tail']} {mix.unit}, busy "
                f"{busy['busy_s']:.6f} s of {busy['wall_s']:.6f} s, {busy['ops']} ops; "
                "with host spans: " + json.dumps({k: v for k, v in (tail["gaps"] or {}).items()
                                                  if k != "by_span"}))
        else:
            log("traced tail: the profiler saw no device op")
    for m in reported(bench, cell["name"], traced):
        value = reader(root, m["name"])(rec)
        if value is None:
            log(f"{m['name']}: nothing to read")
            continue
        result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"] = device_info
    if traced and tail is not None:
        result["breakdown"] = {
            "device_ops": (trace_mod.grouped_ops(tail["busy"]["by_op"])
                           if tail["busy"] else []),
            "idle_gaps": trace_mod.top((tail["gaps"] or {}).get("by_span", {}))}
    mix.release()
    t_ref = time.perf_counter()
    numbers = mix.readings()
    log(f"reference: {time.perf_counter() - t_ref:.2f} s; readings: "
        + json.dumps(getattr(mix, "info", {})))
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in unit["limits"].items()}
    result["correct"] = all(c["value"] is not None and c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    return result


def cache_dirs(root: str) -> None:
    """Triton's and torch's extension caches inside the checkout, at fixed
    paths (the port builds its own kernels under ``build/kernels``)."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(root, "build", "torch_extensions"))


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: str, started: float, device=None, shrink=None,
         fault: str | None = None) -> int:
    """A run as ``run.py`` makes it. For the tests: ``device``, run there
    without looking for a card; ``shrink``, a function that cuts the cell's
    unit to a size the CPU can run; ``fault``, one of the mix's ``FAULTS``
    planted under the timed path."""
    args = parse(argv)
    unit = load_cell(root, args.workload)
    if shrink is not None:
        shrink(unit)
    cache_dirs(root)
    import torch

    chips = unit["cell"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        devices = [torch.device("cuda", i) for i in range(chips)]
    else:
        devices = [device]
    torch.set_num_threads(4)
    print(f"cell {args.workload}, seed {args.seed}, {args.seconds} s, trace "
          f"{args.trace}", flush=True)
    result = run(torch, root, unit, args.seed, args.seconds, bool(args.trace),
                 devices, started, fault=fault, log=lambda s: print(s, flush=True))
    if devices[0].type == "cuda":     # after the window: no subprocess in set-up
        print(f"card: {card_line(torch)}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)
    found = banned_modules()
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
