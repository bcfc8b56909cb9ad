"""What several metric readers share (``portbench/metrics/*.py``)."""

from __future__ import annotations


def device_idle_pct(rec: dict) -> float | None:
    """100 x (1 - busy / wall) of the traced tail's device-only session;
    nothing where it saw no device op, or where its busy time exceeds its
    wall (the two clocks disagree)."""
    busy = (rec.get("tail") or {}).get("busy")
    if busy is None or busy["busy_s"] > busy["wall_s"]:
        return None
    return 100.0 * (1.0 - busy["busy_s"] / busy["wall_s"])


def span_mean_ms(rec: dict, name: str) -> float | None:
    """Mean duration of the window's host spans called ``name``, in ms."""
    d = [b - a for n, a, b in rec.get("spans") or () if n == name]
    return 1e3 * sum(d) / len(d) if d else None
