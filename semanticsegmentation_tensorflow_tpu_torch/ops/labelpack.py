"""Label-map packing for the device->host fetch (counterpart of the JAX
package's ``ops/labelpack.py``): 1 bit/pixel for nc <= 2, a nibble for
nc <= 16, raw otherwise. Bit order matches ``np.unpackbits(bitorder="big")``,
so the host unpack is one numpy call."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_mode(num_classes: int) -> str:
    """Wire format for a label space: "bits", "nibbles", or "none"."""
    if num_classes <= 2:
        return "bits"
    if num_classes <= 16:
        return "nibbles"
    return "none"


def packed_width(width: int, mode: str) -> int:
    if mode == "bits":
        return (width + 7) // 8
    if mode == "nibbles":
        return (width + 1) // 2
    return width


def pack_labels(labels: torch.Tensor, mode: str) -> torch.Tensor:
    """[..., W] integer labels -> packed u8 [..., packed_width], padding W on
    the right with zeros to the pack granularity."""
    if mode == "none":
        return labels
    labels = labels.to(torch.uint8)
    w = labels.shape[-1]
    if mode == "bits":
        labels = F.pad(labels, (0, (-w) % 8))
        x = labels.reshape(*labels.shape[:-1], -1, 8).to(torch.int32)
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32,
                               device=labels.device)
        return (x * weights).sum(dim=-1).to(torch.uint8)
    if mode == "nibbles":
        labels = F.pad(labels, (0, (-w) % 2))
        return labels[..., 0::2] * 16 + labels[..., 1::2]
    raise ValueError(f"unknown pack mode {mode!r}")


def unpack_labels(packed: np.ndarray, width: int, mode: str) -> np.ndarray:
    """Host inverse of :func:`pack_labels`: packed u8 -> u8 [..., width]."""
    if mode == "none":
        return packed
    packed = np.asarray(packed, dtype=np.uint8)
    if mode == "bits":
        out = np.unpackbits(packed, axis=-1)  # big bit order, matches pack
        return out[..., :width]
    if mode == "nibbles":
        out = np.empty((*packed.shape[:-1], packed.shape[-1] * 2), np.uint8)
        out[..., 0::2] = packed >> 4
        out[..., 1::2] = packed & 0x0F
        return out[..., :width]
    raise ValueError(f"unknown pack mode {mode!r}")
