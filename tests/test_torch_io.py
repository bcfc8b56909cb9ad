"""The port's host image IO against the JAX package's: the native library
(native/segio.cpp through ctypes), the PNG writer (utils/fastpng.py), the
overlay's LUT blend (ops/overlay.py) and the KITTI loaders (data/kitti.py).
Every comparison is exact: these are integer functions of their inputs.
"""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from semanticsegmentation_tensorflow_tpu import native as jax_native
from semanticsegmentation_tensorflow_tpu.data import kitti as jax_kitti
from semanticsegmentation_tensorflow_tpu.ops.overlay import (
    host_overlay as jax_host_overlay,
)
from semanticsegmentation_tensorflow_tpu.utils import fastpng as jax_fastpng
from semanticsegmentation_tensorflow_tpu_torch import native
from semanticsegmentation_tensorflow_tpu_torch.data import kitti
from semanticsegmentation_tensorflow_tpu_torch.data.palette import (
    CITYSCAPES_PALETTE, KITTI_OVERLAY_PALETTE, KITTI_ROAD_PALETTE,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
from semanticsegmentation_tensorflow_tpu_torch.utils import fastpng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "semanticsegmentation_tensorflow_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both libraries, built once (a test here must not pass on a
    fallback)."""
    assert native.available(), native.why_unavailable()
    assert native.decode_available()
    assert jax_native.available(), jax_native.why_unavailable()


def _png(arr) -> bytes:
    """PNG of arr in the mode its shape implies (L, LA, RGB or RGBA)."""
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _strip_guard(src: str) -> str:
    """segio.cpp without the SEGIO_NO_LIBPNG guard the port's copy adds: each
    ``#else`` branch of it, then every line that names it."""
    src = re.sub(r"^#else  // SEGIO_NO_LIBPNG\n.*?(?=^#endif  // SEGIO_NO_LIBPNG\n)",
                 "", src, flags=re.S | re.M)
    return re.sub(r"^#.*SEGIO_NO_LIBPNG\n", "", src, flags=re.M)


def test_segio_source_equals_the_jax_packages():
    port = open(os.path.join(REPO, PKG, "native", "segio.cpp")).read()
    ref = open(os.path.join(REPO, "semanticsegmentation_tensorflow_tpu",
                            "native", "segio.cpp")).read()
    assert "SEGIO_NO_LIBPNG" in port and "SEGIO_NO_LIBPNG" not in ref
    assert _strip_guard(port) == ref


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("hw", [(1, 1), (1, 97), (53, 1), (31, 57), (40, 70)])
def test_encode_png_equals_jax(hw, level):
    """The port's PNG bytes equal the JAX writer's (native fixed-Huffman at
    level 1, numpy + zlib at 2), and PIL decodes them to the input."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    arr = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    data = fastpng.encode_png(arr, level)
    assert data == jax_fastpng.encode_png(arr, level)
    np.testing.assert_array_equal(_pil_rgb(data), arr)
    if level == 1:
        assert data == native.encode_png(arr, "fixed")
    else:
        assert data == fastpng.encode_png_numpy(arr, level)
        assert data == native.encode_png(arr, "zlib", level)


def test_write_png_and_bad_input(tmp_path):
    arr = np.random.default_rng(1).integers(0, 256, (9, 14, 3), np.uint8)
    fastpng.write_png(str(tmp_path / "a.png"), arr)
    assert (tmp_path / "a.png").read_bytes() == jax_fastpng.encode_png(arr)
    with pytest.raises(ValueError):
        fastpng.encode_png(arr[..., :2])
    with pytest.raises(ValueError):
        native.encode_png(arr, mode="lz4")


def _source(mode: str, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    if mode == "P":
        img = Image.fromarray(rng.integers(0, 256, (19, 37, 3), np.uint8)
                              ).quantize(17)
        buf = io.BytesIO()
        img.save(buf, "PNG")
        return buf.getvalue()
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    shape = (23, 41) if ch == 1 else (23, 41, ch)
    data = _png(rng.integers(0, 256, shape, dtype=np.uint8))
    assert Image.open(io.BytesIO(data)).mode == mode
    return data


@pytest.mark.parametrize("mode", ["L", "LA", "P", "RGB", "RGBA"])
def test_decode_png_equals_jax_and_pil(mode):
    data = _source(mode)
    got = native.decode_png(data)
    assert got.shape == ((19, 37, 3) if mode == "P" else (23, 41, 3))
    np.testing.assert_array_equal(got, jax_native.decode_png(data))
    np.testing.assert_array_equal(got, _pil_rgb(data))
    assert native.png_info(data) == got.shape[:2]


def test_decode_png_refuses_bad_input():
    data = _source("RGB")
    for bad in (data[: len(data) // 2], b"not a png at all"):
        with pytest.raises(ValueError):
            native.decode_png(bad)


@pytest.mark.parametrize("kind", ["bilinear", "nearest"])
@pytest.mark.parametrize("shape,out", [
    ((75, 248, 3), (38, 124)),      # a KITTI-like downscale
    ((17, 29, 3), (40, 61)),        # upscale
    ((13, 31), (7, 11)),            # a 2-D map
    ((11, 16, 4), (11, 16)),        # identity, 4 channels
])
def test_resize_equals_jax_and_the_oracles(kind, shape, out):
    src = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    got = getattr(native, f"resize_{kind}")(src, *out)
    np.testing.assert_array_equal(
        got, getattr(jax_native, f"resize_{kind}")(src, *out))
    ref = src if src.ndim == 3 else src[..., None]
    oracle = getattr(native, f"resize_{kind}_ref")(ref, *out)
    np.testing.assert_array_equal(got.reshape(oracle.shape), oracle)
    np.testing.assert_array_equal(
        oracle, getattr(jax_native, f"resize_{kind}_ref")(ref, *out))
    if kind == "nearest" and src.ndim == 3 and shape[2] == 3:
        pil = Image.fromarray(src).resize(out[::-1], Image.NEAREST)
        np.testing.assert_array_equal(got, np.asarray(pil))


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("nc,blend0", [(2, False), (2, True), (19, False),
                                       (19, True)])
def test_host_overlay_equals_jax(nc, blend0, branch, monkeypatch):
    """Both branches of the port's host blend (the LUT walk in C++ and the
    numpy expression) are bit-equal to the JAX package's host blend."""
    rng = np.random.default_rng(nc)
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    labels = rng.integers(0, nc, (37, 53)).astype(np.uint8)
    palette = KITTI_OVERLAY_PALETTE if nc == 2 else CITYSCAPES_PALETTE
    want = jax_host_overlay(img, labels, palette, 0.5, blend0)
    if branch == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    got = host_overlay(img, labels, palette, 0.5, blend0)
    np.testing.assert_array_equal(got, want)


def test_overlay_lut_refuses_a_label_out_of_range():
    img = np.zeros((4, 4, 3), np.uint8)
    lut = np.zeros((3, 3, 256), np.uint8)
    with pytest.raises(IndexError):
        native.overlay_lut(img, np.full((4, 4), 7, np.uint8), lut)
    with pytest.raises(ValueError):
        native.overlay_lut(img, np.zeros((4, 5), np.uint8), lut)


@pytest.fixture(scope="module")
def kitti_files(tmp_path_factory):
    """An image and its GT (palette colours) at 75x248, and a BMP copy."""
    d = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(14)
    img = d / "um_000000.png"
    Image.fromarray(rng.integers(0, 256, (75, 248, 3), np.uint8)).save(img)
    gt = d / "um_road_000000.png"
    pal = KITTI_ROAD_PALETTE.astype(np.uint8)
    Image.fromarray(pal[rng.integers(0, len(pal), (75, 248))]).save(gt)
    bmp = d / "um_000001.bmp"
    Image.open(img).save(bmp)
    return {"png": str(img), "gt": str(gt), "bmp": str(bmp)}


@pytest.mark.parametrize("native_resize", ["", "1"])
@pytest.mark.parametrize("what,size", [("png", (38, 124)), ("png", (75, 248)),
                                       ("bmp", (38, 124)), ("gt", (38, 124))])
def test_loaders_equal_jax(kitti_files, what, size, native_resize, monkeypatch):
    """``load_image`` (PIL's bilinear, or with SEG_NATIVE_RESIZE=1 the
    native decode and half-pixel bilinear; a BMP falls through to PIL) and
    ``load_gt`` (the native nearest) equal the JAX loaders."""
    monkeypatch.setenv("SEG_NATIVE_RESIZE", native_resize)
    path = kitti_files[what]
    if what == "gt":
        ids, valid = kitti.load_gt(path, size)
        j_ids, j_valid = jax_kitti.load_gt(path, size)
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_array_equal(valid, j_valid)
        pil = Image.open(path).convert("RGB").resize(size[::-1], Image.NEAREST)
        np.testing.assert_array_equal(
            ids, kitti.encode_labels(np.asarray(pil), KITTI_ROAD_PALETTE)[0])
        return
    got = kitti.load_image(path, size)
    np.testing.assert_array_equal(got, jax_kitti.load_image(path, size))
    src = np.asarray(Image.open(path).convert("RGB"))
    if size == src.shape[:2]:
        np.testing.assert_array_equal(got, src)
    elif native_resize and what == "png":
        np.testing.assert_array_equal(got, native.resize_bilinear(src, *size))
    else:
        pil = Image.open(path).convert("RGB").resize(size[::-1], Image.BILINEAR)
        np.testing.assert_array_equal(got, np.asarray(pil))


def test_build_without_libpng(tmp_path, monkeypatch, kitti_files):
    """On a host without png.h the library builds with SEGIO_NO_LIBPNG:
    decode raises saying why, while encode, resize and the LUT still run,
    and the opt-in loader decodes with PIL, then resizes natively."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_has_libpng_header", lambda: False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LOAD_FAILED", None)
    assert native.available() and not native.decode_available()
    assert native.library_path(False).parent == tmp_path
    assert native.library_path(False).exists()
    with pytest.raises(RuntimeError, match="without libpng"):
        native.decode_png(_source("RGB"))
    arr = np.random.default_rng(2).integers(0, 256, (21, 33, 3), np.uint8)
    assert fastpng.encode_png(arr) == jax_fastpng.encode_png(arr)
    np.testing.assert_array_equal(native.resize_bilinear(arr, 10, 17),
                                  native.resize_bilinear_ref(arr, 10, 17))
    labels = (arr[..., 0] > 127).astype(np.uint8)
    np.testing.assert_array_equal(
        host_overlay(arr, labels, KITTI_OVERLAY_PALETTE),
        jax_host_overlay(arr, labels, KITTI_OVERLAY_PALETTE))
    monkeypatch.setenv("SEG_NATIVE_RESIZE", "1")
    np.testing.assert_array_equal(
        kitti.load_image(kitti_files["png"], (38, 124)),
        jax_kitti.load_image(kitti_files["png"], (38, 124)))


def _run(code: str, **env) -> str:
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO, **env),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_seg_native_0_falls_back():
    """SEG_NATIVE=0 switches the library off in a fresh process; the
    writer then gives the numpy + zlib bytes and the blend its numpy
    branch."""
    out = _run(
        "import numpy as np\n"
        f"from {PKG} import native\n"
        f"from {PKG}.utils import fastpng\n"
        f"from {PKG}.ops.overlay import host_overlay\n"
        "assert not native.available() and not native.decode_available()\n"
        "assert 'SEG_NATIVE=0' in native.why_unavailable()\n"
        "a = np.random.default_rng(0).integers(0, 256, (12, 17, 3), np.uint8)\n"
        "assert fastpng.encode_png(a) == fastpng.encode_png_numpy(a)\n"
        "pal = np.array([[0, 0, 0], [255, 0, 255]], np.uint8)\n"
        "lab = (a[..., 0] > 99).astype(np.uint8)\n"
        "print(host_overlay(a, lab, pal).tobytes().hex())\n", SEG_NATIVE="0")
    a = np.random.default_rng(0).integers(0, 256, (12, 17, 3), np.uint8)
    pal = np.array([[0, 0, 0], [255, 0, 255]], np.uint8)
    lab = (a[..., 0] > 99).astype(np.uint8)
    assert out.strip() == host_overlay(a, lab, pal).tobytes().hex()


def test_importing_the_port_builds_nothing():
    """Importing every module of the port neither builds nor loads segio:
    the build happens at first use."""
    out = _run(
        "import importlib, pkgutil\n"
        f"import {PKG} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"from {PKG} import native\n"
        "print(native._LIB is None and native._LOAD_FAILED is None)\n")
    assert out.strip() == "True"
