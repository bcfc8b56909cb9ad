"""segio: native (C++) host image IO, bound with ctypes and built at first use
(counterpart of the JAX package's ``native/``; ``segio.cpp`` is a copy of
its source with one compile guard added, ``SEGIO_NO_LIBPNG``, and a test
pins the two equal outside the guard).

``segio.cpp`` holds the libpng decode, the sub-filter PNG encode (a
literal-only fixed-Huffman DEFLATE, or zlib at a chosen level), the 16.16
fixed-point bilinear and nearest resizes and the overlay LUT walk. It is
compiled with ``g++ -O3 -shared -fPIC ... -lpng -lz`` on the first call that
needs it, never at import, into ``build/native/`` at the repository root
(gitignored); the file name carries a hash of the source, so an edit
rebuilds. On a host without libpng's header (``png.h``) it builds with
``-DSEGIO_NO_LIBPNG`` and zlib only: encode, resize and the LUT work, and
``decode_png`` raises (``decode_available()`` is False).

Contract (as in the JAX package):

* ``decode_png``/``png_info`` equal PIL's ``Image.open(...).convert("RGB")``
  for every 8-bit PNG colour type (gray, gray + alpha, palette, RGB, RGBA).
  16-bit sources take the high-byte strip, where PIL saturates.
* ``resize_bilinear``/``resize_nearest`` equal the numpy oracles
  ``resize_bilinear_ref``/``resize_nearest_ref`` below (half-pixel centres,
  16.16 weights, 32.32 accumulation, round half up). Nearest also equals
  PIL's NEAREST; bilinear is the classic 2-tap filter, not PIL's
  area-averaging one, so the data loader takes it only on opt-in
  (``SEG_NATIVE_RESIZE=1``).
* ``SEG_NATIVE=0`` switches every native path off (the Python fallbacks take
  over); a failed build falls back the same way, with one warning.

Every ctypes call releases the GIL, so a writer pool's threads overlap.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "segio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LOAD_FAILED: str | None = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
NO_LIBPNG = -100  # what both decode entries return in a zlib-only build


def _has_libpng_header() -> bool:
    probe = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                           input="#include <png.h>\n", capture_output=True,
                           text=True, timeout=60)
    return probe.returncode == 0


def library_path(with_libpng: bool) -> Path:
    """Where the library of this ``segio.cpp`` is (or will be) built."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"segio-{tag}{'' if with_libpng else '-nolibpng'}.so"


def _compile(out_path: Path, with_libpng: bool) -> None:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_path.parent)
    os.close(fd)
    flags = ["-lpng", "-lz"] if with_libpng else ["-DSEGIO_NO_LIBPNG", "-lz"]
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", tmp, *flags],
            check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, out_path)  # atomic: concurrent builders both win
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.segio_version.restype = ctypes.c_int
    lib.segio_version.argtypes = []
    lib.segio_png_info.restype = ctypes.c_int
    lib.segio_png_info.argtypes = [_u8p, ctypes.c_size_t, _i32p, _i32p]
    lib.segio_decode_png.restype = ctypes.c_int
    lib.segio_decode_png.argtypes = [_u8p, ctypes.c_size_t, _u8p, _i32p, _i32p]
    lib.segio_encode_png_fixed.restype = ctypes.c_int
    lib.segio_encode_png_fixed.argtypes = [
        _u8p, ctypes.c_int32, ctypes.c_int32, _u8p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t)]
    lib.segio_encode_png_zlib.restype = ctypes.c_int
    lib.segio_encode_png_zlib.argtypes = [
        _u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p,
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    for name in ("segio_resize_bilinear_u8", "segio_resize_nearest_u8"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                       _u8p, ctypes.c_int32, ctypes.c_int32]
    lib.segio_overlay_lut_u8.restype = ctypes.c_int
    lib.segio_overlay_lut_u8.argtypes = [
        _u8p, _u8p, ctypes.c_int64, _u8p, ctypes.c_int32, _u8p]
    return lib


def load() -> ctypes.CDLL | None:
    """Build (if needed) and load the segio library; None where it is
    switched off or does not build."""
    global _LIB, _LOAD_FAILED
    if _LIB is not None:
        return _LIB
    if _LOAD_FAILED is not None:
        return None
    if os.environ.get("SEG_NATIVE", "1").strip().lower() in ("0", "false", "off"):
        _LOAD_FAILED = "disabled via SEG_NATIVE=0"
        return None
    with _LOCK:
        if _LIB is not None or _LOAD_FAILED is not None:
            return _LIB
        try:
            with_libpng = _has_libpng_header()
            so = library_path(with_libpng)
            if not so.exists():
                _compile(so, with_libpng)
            _LIB = _bind(ctypes.CDLL(str(so)))
            return _LIB
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or e
            _LOAD_FAILED = (f"native segio unavailable ({detail}); using "
                            "Python fallbacks")
        warnings.warn(_LOAD_FAILED, RuntimeWarning)
        return None


def available() -> bool:
    return load() is not None


def why_unavailable() -> str | None:
    load()
    return _LOAD_FAILED


def decode_available() -> bool:
    """True where the library is loaded and was built with libpng."""
    lib = load()
    return lib is not None and lib.segio_png_info(
        None, 0, None, None) != NO_LIBPNG


def _lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError(f"segio unavailable: {_LOAD_FAILED}")
    return lib


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def png_info(data: bytes) -> tuple[int, int]:
    """(H, W) of a PNG without decoding its pixels."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    rc = lib.segio_png_info(_as_u8p(buf), buf.size,
                            ctypes.byref(h), ctypes.byref(w))
    if rc == NO_LIBPNG:
        raise RuntimeError("segio was built without libpng (no png.h on this "
                           "host): no native PNG decode")
    if rc != 0:
        raise ValueError(f"segio_png_info failed rc={rc}")
    return h.value, w.value


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB (any colour type normalized): a
    header probe sizes the buffer, then the decode fills it."""
    lib = _lib()
    h, w = png_info(data)
    out = np.empty((h, w, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    h2 = ctypes.c_int32()
    w2 = ctypes.c_int32()
    rc = lib.segio_decode_png(_as_u8p(buf), buf.size, _as_u8p(out),
                              ctypes.byref(h2), ctypes.byref(w2))
    if rc != 0:
        raise ValueError(f"segio_decode_png failed rc={rc}")
    return out


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode_png(arr: np.ndarray, mode: str = "fixed", level: int = 1) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes.

    mode="fixed": literal-only fixed-Huffman DEFLATE (no LZ matching), the
    fastest and larger files. mode="zlib": the sub filter in C, then zlib at
    ``level``, the same bytes as ``utils.fastpng.encode_png_numpy``.
    """
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError(f"expected [H,W,3] uint8, got {arr.shape} {arr.dtype}")
    lib = _lib()
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    raw_len = h * (w * 3 + 1)
    cap = raw_len + raw_len // 8 + 4096  # > the C side's bound + the skeleton
    out = np.empty(cap, np.uint8)
    n = ctypes.c_size_t()
    if mode == "fixed":
        rc = lib.segio_encode_png_fixed(_as_u8p(arr), h, w, _as_u8p(out),
                                        cap, ctypes.byref(n))
    elif mode == "zlib":
        rc = lib.segio_encode_png_zlib(_as_u8p(arr), h, w, int(level),
                                       _as_u8p(out), cap, ctypes.byref(n))
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if rc != 0:
        raise ValueError(f"segio_encode_png_{mode} failed rc={rc}")
    return out[: n.value].tobytes()


# ---------------------------------------------------------------------------
# Resize: the native functions and the numpy oracles they equal. Half-pixel
# centres: src_x = (j + 0.5) * in/out - 0.5 in 16.16 fixed point, clamped at
# the edges; bilinear accumulates in 32.32 and rounds half up.
# ---------------------------------------------------------------------------

def _axis_coords_ref(in_n: int, out_n: int) -> tuple[np.ndarray, np.ndarray]:
    j = np.arange(out_n, dtype=np.int64)
    x = ((2 * j + 1) * in_n << 16) // (2 * out_n) - (1 << 15)
    x = np.maximum(x, 0)
    i0 = x >> 16
    frac = x & 0xFFFF
    at_edge = i0 >= in_n - 1
    return (np.where(at_edge, in_n - 1, i0),
            np.where(at_edge, 0, frac))


def resize_bilinear_ref(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Numpy oracle of ``segio_resize_bilinear_u8`` (bit-exact)."""
    h, w, _ = src.shape
    xi, xw = _axis_coords_ref(w, ow)
    yi, yw = _axis_coords_ref(h, oh)
    x1 = np.minimum(xi + 1, w - 1)
    y1 = np.minimum(yi + 1, h - 1)
    s = src.astype(np.int64)
    hrow = (s[:, xi] * (65536 - xw)[None, :, None]
            + s[:, x1] * xw[None, :, None])           # [H, ow, C] in 16.16
    v = (hrow[yi] * (65536 - yw)[:, None, None]
         + hrow[y1] * yw[:, None, None])              # [oh, ow, C] in 32.32
    return ((v + (1 << 31)) >> 32).astype(np.uint8)


def _pil_nearest_axis(in_n: int, out_n: int) -> np.ndarray:
    # PIL accumulates the double scale per output pixel (xx = 0.5*s; xx += s;
    # truncate), and the accumulated rounding decides exact ties, so this is
    # a sequence of adds (np.add.accumulate, left to right), not a closed form
    s = in_n / out_n
    steps = np.full(out_n, s, np.float64)
    steps[0] = s * 0.5
    return np.minimum(np.add.accumulate(steps).astype(np.int64), in_n - 1)


def resize_nearest_ref(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Numpy oracle of ``segio_resize_nearest_u8`` (bit-exact; equal to PIL's
    NEAREST, exact half-pixel ties included)."""
    h, w = src.shape[:2]
    return src[_pil_nearest_axis(h, oh)][:, _pil_nearest_axis(w, ow)]


def _resize(src: np.ndarray, oh: int, ow: int, fn_name: str) -> np.ndarray:
    if src.ndim == 2:
        return _resize(src[:, :, None], oh, ow, fn_name)[:, :, 0]
    if src.ndim != 3 or src.dtype != np.uint8:
        raise ValueError(f"expected [H,W,C] uint8, got {src.shape} {src.dtype}")
    lib = _lib()
    src = np.ascontiguousarray(src)
    h, w, c = src.shape
    dst = np.empty((oh, ow, c), np.uint8)
    rc = getattr(lib, fn_name)(_as_u8p(src), h, w, c, _as_u8p(dst), oh, ow)
    if rc != 0:
        raise ValueError(f"{fn_name} failed rc={rc}")
    return dst


def resize_bilinear(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    return _resize(src, oh, ow, "segio_resize_bilinear_u8")


def resize_nearest(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    return _resize(src, oh, ow, "segio_resize_nearest_u8")


# ---------------------------------------------------------------------------
# Overlay blend through a table (``ops.overlay._blend_lut`` builds
# lut[class][channel][256] with the blend's own f32 arithmetic)
# ---------------------------------------------------------------------------

def overlay_lut(img: np.ndarray, labels: np.ndarray,
                lut: np.ndarray) -> np.ndarray:
    """lut [nc, 3, 256] u8 applied to img [H, W, 3] u8 through labels
    [H, W] u8."""
    lib = _lib()
    if (img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8
            or labels.shape != img.shape[:2] or labels.dtype != np.uint8
            or lut.ndim != 3 or lut.shape[1:] != (3, 256)
            or lut.dtype != np.uint8):
        raise ValueError(
            f"bad shapes/dtypes: img {img.shape} {img.dtype}, labels "
            f"{labels.shape} {labels.dtype}, lut {lut.shape} {lut.dtype}")
    img = np.ascontiguousarray(img)
    labels = np.ascontiguousarray(labels)
    lut = np.ascontiguousarray(lut)
    out = np.empty_like(img)
    rc = lib.segio_overlay_lut_u8(
        _as_u8p(img), _as_u8p(labels), img.shape[0] * img.shape[1],
        _as_u8p(lut), lut.shape[0], _as_u8p(out))
    if rc == -3:
        raise IndexError(f"label id >= num classes ({lut.shape[0]})")
    if rc != 0:
        raise ValueError(f"segio_overlay_lut_u8 failed rc={rc}")
    return out
