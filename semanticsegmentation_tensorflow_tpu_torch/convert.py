"""Weight bridge between the JAX package's flax params and the port's
``state_dict``.

flax params are a tree keyed like ``vgg16/stage1/conv0/kernel``; the port
names its modules the same way, so the state-dict key is the flax path with
``.`` for ``/`` and ``weight`` for ``kernel``. A BatchNorm's flax
``scale`` and ``bias`` (params) and ``mean`` and ``var`` (``batch_stats``)
are the port's parameters and buffers of the same names. Layouts:

* conv kernels: flax HWIO -> PyTorch OIHW;
* transposed-conv kernels: flax [kh, kw, Cin, Cout], which flax applies
  without flipping (``transpose_kernel=False``) -> flipped in space and
  permuted to PyTorch's [Cin, Cout, kh, kw];
* biases: copied.

Both directions are pure permutations of float32 values, so a round trip is
bit-equal. The JAX package's int8 trees (``infer/quant.py``
``quantize_variables``) carry too: an int8 ``kernel`` is permuted as int8,
its ``kernel_scale`` is the quantized module's ``weight_scale``
(``ops/quant.py``). No JAX import: flax arrays arrive as anything
``np.asarray`` takes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import (
    ConvTranspose,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.quant import QuantConvTranspose


# the flax collections a model's variables may hold; their leaves share one
# flat namespace (a BatchNorm's params are scale/bias, its stats mean/var)
COLLECTIONS = ("params", "batch_stats")
_STATS_LEAVES = ("mean", "var")


def flatten_params(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested flax param dict -> flat {"a/b/kernel": np.ndarray}. A
    top-level variables dict (``{"params": ...}``, with ``"batch_stats"``
    for a BatchNorm model) is unwrapped, both collections into one flat
    dict."""
    if not prefix and "params" in tree and set(tree) <= set(COLLECTIONS):
        flat = {}
        for col in COLLECTIONS:
            flat.update(_flatten(tree.get(col, {}), ""))
        return flat
    return _flatten(tree, prefix)


def _flatten(tree: Mapping[str, Any], prefix: str) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "/"))
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


def to_variables(flat: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """Flat leaves (:func:`flatten_params`, :func:`from_state_dict`) -> a
    flax variables dict: ``{"params": ...}``, plus ``"batch_stats"`` (the
    ``mean`` and ``var`` leaves) when the model has BatchNorm."""
    stats = {k: v for k, v in flat.items()
             if k.rsplit("/", 1)[-1] in _STATS_LEAVES}
    out = {"params": unflatten_params({k: v for k, v in flat.items()
                                       if k not in stats})}
    if stats:
        out["batch_stats"] = unflatten_params(stats)
    return out


_LEAVES = {"kernel": "weight", "kernel_scale": "weight_scale"}


def torch_key(flax_key: str) -> str:
    """flax path ``a/b/kernel`` -> state-dict key ``a.b.weight``."""
    *path, leaf = flax_key.split("/")
    return ".".join([*path, _LEAVES.get(leaf, leaf)])


def flax_key(torch_key: str) -> str:
    """The inverse of :func:`torch_key`."""
    *path, leaf = torch_key.split(".")
    inverse = {v: k for k, v in _LEAVES.items()}
    return "/".join([*path, inverse.get(leaf, leaf)])


def transposed_weights(model: nn.Module) -> set[str]:
    """State-dict keys of the model's transposed-conv kernels (float or
    int8)."""
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, (ConvTranspose, QuantConvTranspose))}


def _leaf(a: np.ndarray) -> np.ndarray:
    """A leaf as the port holds it: int8 kept, anything else float32."""
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.astype(np.float32, copy=False)


def torch_layout(a: np.ndarray, transposed: bool) -> np.ndarray:
    """A flax leaf in PyTorch's layout (module docstring); a view."""
    if a.ndim != 4:
        return a
    return (np.flip(a, (0, 1)).transpose(2, 3, 0, 1) if transposed
            else a.transpose(3, 2, 0, 1))


def flax_layout(a: np.ndarray, transposed: bool) -> np.ndarray:
    """The inverse of :func:`torch_layout`; a view."""
    if a.ndim != 4:
        return a
    return (np.flip(a.transpose(2, 3, 0, 1), (0, 1)) if transposed
            else a.transpose(2, 3, 1, 0))


def to_state_dict(flat: Mapping[str, np.ndarray], model: nn.Module, *,
                  strict: bool = True) -> dict[str, torch.Tensor]:
    """Flat flax params -> a ``state_dict`` for ``model`` (CPU float32).

    Every flax leaf must land on exactly one port parameter of the same
    shape. ``strict``: raise on any flax leaf the model has no place for and
    on any model parameter the params do not fill."""
    own = model.state_dict()
    transposed = transposed_weights(model)
    out: dict[str, torch.Tensor] = {}
    unused = []
    for fk, v in flat.items():
        tk = torch_key(fk)
        if tk not in own:
            unused.append(fk)
            continue
        a = torch_layout(_leaf(v), tk in transposed)
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
    """A port ``state_dict`` -> flat flax params (float32 numpy, int8 for
    a quantized weight), the inverse of :func:`to_state_dict`. The arrays
    are copies: a later
    in-place update of the model (an optimizer step, BatchNorm's running
    statistics) leaves them as they were."""
    transposed = transposed_weights(model)
    return {flax_key(tk): np.array(flax_layout(
                _leaf(t.detach().cpu().float().numpy() if t.is_floating_point()
                      else t.detach().cpu().numpy()), tk in transposed),
                order="C")
            for tk, t in state_dict.items()}
