"""Metrics logging: one JSONL record per call (counterpart of the JAX
package's ``utils/logging.py``, without its optional TensorBoard writer)."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, f"{name}.jsonl"), "a", buffering=1)

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
