"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all in
parallel, and the objects link into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: seconds to build
instead of minutes). The build happens at first use, never at import,
into ``build/kernels/`` at the repository root (gitignored). The file name
carries a hash of the sources, their headers (``csrc/*.cuh``) and the flags,
so editing a kernel rebuilds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "seg_stage1_tail": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "seg_stage1_tail_segnet": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _P), _I),
    "seg_stage1_tail_halo": ((_P,) * 8 + (_I,) * 4 + (_P,), _I),
    "seg_stage1_tail_halo_segnet": ((_P,) * 8 + (_I,) * 4 + (_P,), _I),
    "seg_stage1_tail_bwd_halo": ((_P,) * 18 + (_I, _I, _P, _P, _P, _I, _I, _I, _I,
                                                _P), _I),
    "seg_stage1_bwd_dgrad_parts": ((_I, _I, _I, _I), _I),
    "seg_pool_argmax": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
    "seg_unpool": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
    "seg_unpool_bwd": ((_P, _P, _P, _I, _I, _I, _I, _P), _I),
    "seg_stage1_bwd_parts": ((_I, _I, _I, _I), _I),
    "seg_stage1_tail_bwd": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                             _I, _I, _P), _I),
    "seg_preprocess": ((_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                        _P), _I),
    "seg_error_string": ((_I,), ctypes.c_char_p),
    "seg_overlay": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                     _P), _I),
    "seg_winograd_fwd": ((_P,) * 6 + (_I,) * 7 + (_P,), _I),
    "seg_winograd_wgrad_scratch": ((_I,) * 6 + (ctypes.POINTER(ctypes.c_longlong),),
                                   _I),
    "seg_winograd_wgrad": ((_P,) * 7 + (_I, _P, _P) + (_I,) * 6 + (_P,), _I),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libseg_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    ``nvcc -c`` per source, all started together, then one link. The
    compiler's report (registers, shared memory, spills) is kept beside the
    library as ``<name>.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in sources():
        obj = path.with_suffix(f".{src.stem}.{os.getpid()}.o")
        jobs.append((obj, subprocess.Popen(
            [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = [proc.communicate()[0] for _, proc in jobs]
    objs = [str(obj) for obj, _ in jobs]
    try:
        failed = [(obj, proc.returncode) for obj, proc in jobs if proc.returncode]
        if not failed:
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *objs],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode:
                failed.append((tmp, link.returncode))
        path.with_suffix(".log").write_text("".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed: {failed}\n" + "".join(logs)[-4000:])
        os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return path


def build_log() -> str:
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib().seg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
