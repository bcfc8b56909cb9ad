"""The reference models, one file each: ``portbench/reference/models/<model>.py``
for the configuration's ``"model"``. Each file gives

- ``param_specs(cfg)``: (name, shape, init std) of every parameter, in
  order, the classifier's bias last;
- ``forward(cfg, p, x, masks=None)``: logits [N,H,W,C] of normalized NHWC
  images whose sides are multiples of the stride; ``masks``: dropout's
  keep-masks in the order training draws them (None: inference);
- ``stride(cfg)``: the multiple the input is padded to;
- ``mask_shapes(cfg, n, h, w)``: the shapes of those keep-masks.

A model's work (FLOPs) is counted from its ``forward`` (``harness.work``).
"""

from __future__ import annotations

import importlib
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))


def find(name: str):
    """The reference of model ``name``; raises where there is none."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name) or not os.path.isfile(
            os.path.join(HERE, name + ".py")):
        raise ValueError(f"no reference model {name!r} under {HERE}")
    return importlib.import_module(f"{__name__}.{name}")
