"""PNG writer of the serving path and the test-set sweep (counterpart of the
JAX package's ``utils/fastpng.py``; the same bytes for the same pixels).

8-bit RGB, PNG filter "sub" on every row, then DEFLATE. At ``level <= 1``
the native fixed-Huffman encoder of ``native/segio.cpp`` runs (no LZ match
search: the fastest, with larger files); at ``level >= 2``, or with
``SEG_NATIVE=0`` or no native build, the filter is one vectorized numpy
subtraction and ``zlib`` deflates at ``level``. Both the ctypes call and
``zlib.compress`` release the GIL, so a writer pool's threads overlap.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _native_encode(arr: np.ndarray) -> bytes | None:
    from semanticsegmentation_tensorflow_tpu_torch import native

    if not native.available():
        return None
    return native.encode_png(arr, mode="fixed")


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode_png(arr: np.ndarray, level: int = 1) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (8-bit RGB, sub filter, deflate):
    the native fixed-Huffman encoder at ``level <= 1`` where it is built,
    else :func:`encode_png_numpy`."""
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError(f"expected [H,W,3] uint8, got {arr.shape} {arr.dtype}")
    if level <= 1:
        data = _native_encode(np.ascontiguousarray(arr))
        if data is not None:
            return data
    return encode_png_numpy(arr, level)


def encode_png_numpy(arr: np.ndarray, level: int = 1) -> bytes:
    """The numpy + zlib encoder (the fallback, and the smaller files)."""
    h, w, _ = arr.shape
    flat = np.ascontiguousarray(arr).reshape(h, w * 3)
    # filter type 1 ("sub"): each byte minus the byte 3 positions left, mod
    # 256 (uint8 wraps)
    raw = np.empty((h, w * 3 + 1), np.uint8)
    raw[:, 0] = 1
    raw[:, 1:4] = flat[:, :3]
    np.subtract(flat[:, 3:], flat[:, :-3], out=raw[:, 4:])
    return (_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray, level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr, level))
