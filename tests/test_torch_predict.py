"""The port's inference slice against the JAX package: the Predictor, the
serve handler's round trip, the CLIs and the package guards.

Labels are compared exactly wherever the JAX logits' two classes differ
by more than 1e-4 of the logit scale; within that margin the f32 sums of
the two frameworks (another summation order) may order a near-tie either
way, and at most 0.5 % of pixels may fall in it.
"""

import http.client
import io
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semanticsegmentation_tensorflow_tpu.infer.predict import (
    Predictor as JaxPredictor,
)
from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay

from torch_parity import jax_fcn, jax_init, port_fcn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_HW = (40, 70)   # padded to 64x96 by the predictor


@pytest.fixture(scope="module")
def predictors():
    model = jax_fcn("fcn8s")
    variables = jax_init(model)
    jax_pred = JaxPredictor(model, variables, IMAGE_HW)
    port_pred = Predictor(port_fcn("fcn8s", variables), IMAGE_HW, device="cpu")
    return jax_pred, port_pred


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, (2, *IMAGE_HW, 3),
                                             np.uint8)


def _decided(jax_pred, images):
    """Pixels whose JAX logits are not a near-tie (see module docstring)."""
    logits = np.asarray(jax_pred._logits_fn(jax_pred._variables,
                                            jnp.asarray(images)))
    margin = np.abs(logits[..., 1] - logits[..., 0])
    decided = margin > 1e-4 * np.abs(logits).max()
    assert decided.mean() >= 0.995
    return decided


def test_predictor_overlay_and_labels_match_jax(predictors, images):
    jax_pred, port_pred = predictors
    ov, lab = port_pred(images)
    j_ov, j_lab = jax_pred(images)
    assert ov.shape == j_ov.shape == (2, *IMAGE_HW, 3) and ov.dtype == np.uint8
    assert lab.shape == j_lab.shape and lab.dtype == np.int32
    ok = _decided(jax_pred, images)
    np.testing.assert_array_equal(lab[ok], j_lab[ok])
    same = lab == j_lab      # where the labels agree the bytes are exact
    np.testing.assert_array_equal(ov[same], j_ov[same])
    ov1, lab1 = port_pred(images[0])           # rank-3 in, rank-3 out
    np.testing.assert_array_equal(ov1, ov[0])
    np.testing.assert_array_equal(lab1, lab[0])


def test_predictor_packed_labels_match_jax(predictors, images):
    jax_pred, port_pred = predictors
    assert port_pred._pack_mode == jax_pred._pack_mode == "bits"
    packed = port_pred._packed_labels(torch.from_numpy(images)).numpy()
    j_packed = np.asarray(jax_pred._jfwd_labels_packed(jax_pred._variables,
                                                       jnp.asarray(images)))
    assert packed.shape == j_packed.shape == (2, 40, 9)
    labels = port_pred._fetch_labels(images)
    j_labels = jax_pred._fetch_labels(images)
    assert labels.dtype == j_labels.dtype == np.uint8
    ok = _decided(jax_pred, images)
    np.testing.assert_array_equal(labels[ok], j_labels[ok])
    if np.array_equal(labels, j_labels):
        np.testing.assert_array_equal(packed, j_packed)
    # the packed fetch is the overlay path's labels, bit for bit
    np.testing.assert_array_equal(labels, port_pred(images)[1])


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_serve_round_trip_matches_predictor(predictors):
    from http.server import ThreadingHTTPServer

    from semanticsegmentation_tensorflow_tpu_torch.scripts.serve import (
        make_handler,
    )

    _, pred = predictors
    stats = {"requests": 0, "last_ms": None}
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pred, stats))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(1).integers(0, 256, (*IMAGE_HW, 3), np.uint8)
    labels = pred._fetch_labels(img[None])[0]
    want = {"/segment": host_overlay(img, labels, pred._palette, pred._alpha),
            "/labels": np.repeat(labels[..., None], 3, -1)}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=120)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["status"] == "ok"
        for path in ("/segment", "/labels", "/segment"):
            conn.request("POST", path, body=_png(img))
            r = conn.getresponse()
            assert r.status == 200, path
            out = np.asarray(Image.open(io.BytesIO(r.read())))
            np.testing.assert_array_equal(out, want[path])
        # another size is resized to the preset size, like the loader
        conn.request("POST", "/labels", body=_png(np.zeros((50, 60, 3), np.uint8)))
        r = conn.getresponse()
        assert r.status == 200
        assert Image.open(io.BytesIO(r.read())).size == (70, 40)
        for path, body, code in (("/segment", b"not a png", 400),
                                 ("/nope", _png(img), 404),
                                 ("/segment", None, 400)):
            conn.request("POST", path, body=body)
            r = conn.getresponse()
            r.read()        # drain before reusing the keep-alive connection
            assert r.status == code, path
        conn.close()
        assert stats["requests"] == 4
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_infer_image_cli_with_weights_file(tmp_path):
    """--weights loads a port state_dict; the CLI's overlay equals the
    Predictor's on the same image (resized to the preset's 375x1242; a
    narrow fcn32s keeps the CPU forward small)."""
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image

    kw = "fc_features=32,width_mult=0.25"
    model = port_fcn("fcn32s", dtype=torch.bfloat16)
    init_params(model, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "w.pt")
    src = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (45, 70, 3), np.uint8)).save(src)
    out = tmp_path / "out.png"
    rc = infer_image.main(["--model", "fcn32s", "--model-kw", kw, "--weights",
                           str(tmp_path / "w.pt"), "--device", "cpu",
                           "--image", str(src), "--out", str(out)])
    assert rc == 0
    got = np.asarray(Image.open(out))
    want, _ = Predictor(model, (375, 1242), device="cpu").predict_file(str(src))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("entry", ["infer_image", "serve"])
@pytest.mark.parametrize("extra,err", [
    (["--device", "cuda"], RuntimeError),
    (["--device", "cpu", "--int8"], NotImplementedError),
    (["--device", "cpu", "--tiled"], NotImplementedError),
    (["--device", "cpu", "--checkpoint-dir", "ckpt"], NotImplementedError),
])
def test_cli_guards(entry, extra, err, monkeypatch):
    """--device cuda raises when no card is present (never drops to the
    CPU); unported flags raise before any model is built."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import (
        infer_image, serve,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = extra + (["--image", "x.png"] if entry == "infer_image" else [])
    fn = infer_image.main if entry == "infer_image" else serve.make_server
    with pytest.raises(err):
        fn(argv)


def test_port_never_imports_jax():
    """The port package and chip_smoke.py import neither JAX nor the JAX
    package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import semanticsegmentation_tensorflow_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'orbax',\n"
        "                   'semanticsegmentation_tensorflow_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without CUDA, and
    alone in a directory without the port."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    for script, cwd in ((os.path.join(REPO, "chip_smoke.py"), REPO),
                        (str(lone), str(tmp_path))):
        r = subprocess.run([sys.executable, script], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_port_presets_equal_the_jax_packages():
    """The port keeps its own copy of the presets (so it imports nothing of
    the JAX package); they must stay equal to the reference's."""
    import dataclasses

    from semanticsegmentation_tensorflow_tpu import config as jax_config
    from semanticsegmentation_tensorflow_tpu_torch import config

    assert sorted(config.PRESETS) == sorted(jax_config.PRESETS)
    for name, preset in config.PRESETS.items():
        assert dataclasses.asdict(preset) == dataclasses.asdict(
            jax_config.PRESETS[name]), name
    assert config.parse_model_kw("a=1,b=none,c=x,d=true") == \
        jax_config.parse_model_kw("a=1,b=none,c=x,d=true")


def test_predictor_casts_weights_once():
    """The Predictor holds the weights in the compute dtype and channels_last
    memory, which every conv would otherwise convert them to on each call;
    the logits stay those of the uncast model. Bound: the same bf16 values
    go in, but the weight layout may select another conv algorithm
    (summation order), so 2^-6 of the logit scale."""
    from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
        normalize_images,
    )
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
    from semanticsegmentation_tensorflow_tpu_torch.ops.shape import pad_to_multiple

    model = port_fcn("fcn8s", dtype=torch.bfloat16)
    init_params(model, torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (1, *IMAGE_HW, 3), np.uint8))
    with torch.no_grad():
        want = model(pad_to_multiple(normalize_images(
            x, (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)), 32))
    pred = Predictor(model, IMAGE_HW, device="cpu")
    w = pred.model.vgg16.conv6.weight
    assert w.dtype == torch.bfloat16
    assert w.is_contiguous(memory_format=torch.channels_last)
    got = pred._padded_logits(x)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2 ** -6 * want.abs().max().item())
