"""Weight bridge between the JAX package's flax params and the port's
``state_dict``.

flax params are a tree keyed like ``vgg16/stage1/conv0/kernel``; the port
names its modules the same way, so the state-dict key is the flax path with
``.`` for ``/`` and ``weight`` for ``kernel``. Layouts:

* conv kernels: flax HWIO -> PyTorch OIHW;
* transposed-conv kernels: flax [kh, kw, Cin, Cout], which flax applies
  without flipping (``transpose_kernel=False``) -> flipped in space and
  permuted to PyTorch's [Cin, Cout, kh, kw];
* biases: copied.

Both directions are pure permutations of float32 values, so a round trip is
bit-equal. No JAX import: flax arrays arrive as anything ``np.asarray`` takes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import (
    ConvTranspose,
)


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested flax param dict -> flat {"a/b/kernel": np.ndarray}. A
    top-level ``{"params": ...}`` wrapper is unwrapped."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """Inverse of :func:`flatten_params` (without the ``params`` wrapper)."""
    tree: dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _torch_key(flax_key: str) -> str:
    *path, leaf = flax_key.split("/")
    return ".".join([*path, {"kernel": "weight"}.get(leaf, leaf)])


def _flax_key(torch_key: str) -> str:
    *path, leaf = torch_key.split(".")
    return "/".join([*path, {"weight": "kernel"}.get(leaf, leaf)])


def _transposed_weights(model: nn.Module) -> set[str]:
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, ConvTranspose)}


def to_state_dict(flat: Mapping[str, np.ndarray], model: nn.Module, *,
                  strict: bool = True) -> dict[str, torch.Tensor]:
    """Flat flax params -> a ``state_dict`` for ``model`` (CPU float32).

    Every flax leaf must land on exactly one port parameter of the same
    shape. ``strict``: raise on any flax leaf the model has no place for and
    on any model parameter the params do not fill."""
    own = model.state_dict()
    transposed = _transposed_weights(model)
    out: dict[str, torch.Tensor] = {}
    unused = []
    for fk, v in flat.items():
        tk = _torch_key(fk)
        if tk not in own:
            unused.append(fk)
            continue
        a = np.asarray(v, dtype=np.float32)
        if a.ndim == 4:
            a = (np.flip(a, (0, 1)).transpose(2, 3, 0, 1) if tk in transposed
                 else a.transpose(3, 2, 0, 1))
        if tuple(a.shape) != tuple(own[tk].shape):
            raise ValueError(f"shape mismatch for {fk!r}: {a.shape} (converted) "
                             f"vs {tuple(own[tk].shape)} in the port model")
        out[tk] = torch.from_numpy(np.array(a, order="C"))  # own, writable
    missing = sorted(set(own) - set(out))
    if strict and (unused or missing):
        raise KeyError(f"flax -> torch: unused flax params {sorted(unused)}; "
                       f"port params not filled {missing}")
    return out


def from_state_dict(state_dict: Mapping[str, torch.Tensor],
                    model: nn.Module) -> dict[str, np.ndarray]:
    """A port ``state_dict`` -> flat flax params (float32 numpy), the
    inverse of :func:`to_state_dict`."""
    transposed = _transposed_weights(model)
    flat: dict[str, np.ndarray] = {}
    for tk, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if a.ndim == 4:
            a = (np.flip(a.transpose(2, 3, 0, 1), (0, 1)) if tk in transposed
                 else a.transpose(2, 3, 1, 0))
        flat[_flax_key(tk)] = np.ascontiguousarray(a)
    return flat
