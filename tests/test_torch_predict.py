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

from torch_parity import decided, jax_fcn, jax_init, port_fcn

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


def test_predictor_overlay_and_labels_match_jax(predictors, images):
    jax_pred, port_pred = predictors
    ov, lab = port_pred(images)
    j_ov, j_lab = jax_pred(images)
    assert ov.shape == j_ov.shape == (2, *IMAGE_HW, 3) and ov.dtype == np.uint8
    assert lab.shape == j_lab.shape and lab.dtype == np.int32
    ok = decided(jax_pred, images)
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
    ok = decided(jax_pred, images)
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


@pytest.mark.parametrize("n", [1, 2, 3])
def test_predictor_replicas_equal_one_device(n):
    """``Predictor(mesh=[cpu, cpu])`` (the one-process data mesh: a replica
    of the model on each device, a ragged batch padded to the replica count
    by repeating its last image): the overlay, the labels, the fetched
    label map (from numpy and from a tensor on the first device) and the
    road confidence bit-equal to the one-device Predictor's."""
    import copy

    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params

    model = port_fcn("fcn8s")
    init_params(model, torch.Generator().manual_seed(4))
    one = Predictor(copy.deepcopy(model), IMAGE_HW, device="cpu")
    two = Predictor(model, IMAGE_HW, device="cpu", mesh=["cpu", "cpu"])
    assert (one.mesh_size, two.mesh_size) == (1, 2)
    imgs = np.random.default_rng(n).integers(0, 256, (n, *IMAGE_HW, 3), np.uint8)
    for a, b in zip(one(imgs), two(imgs)):
        np.testing.assert_array_equal(a, b)
    for x in (imgs, torch.from_numpy(imgs)):
        np.testing.assert_array_equal(one._fetch_labels(x), two._fetch_labels(x))
    np.testing.assert_array_equal(one.confidence(imgs), two.confidence(imgs))
    np.testing.assert_array_equal(one(imgs[0])[1], two(imgs[0])[1])
    with pytest.raises(ValueError, match="start with"):
        Predictor(port_fcn("fcn8s"), IMAGE_HW, device="cpu", mesh=["meta", "cpu"])


@pytest.mark.parametrize("name,want", [("cuda", ("cuda:0", "cuda:1")),
                                       ("cuda:1", ("cuda:1", "cuda:0"))])
def test_mesh_devices_start_at_the_predictors_device(monkeypatch, name, want):
    """On a host with two cards (``torch.cuda``'s count and current card
    patched; no card is touched), ``--mesh``'s devices for ``--device
    cuda`` (the default) and ``cuda:1`` start at that card, index filled
    in, and pass the Predictor's device check: the constructor gets as far
    as casting the model (stubbed, on a meta model). A mesh that starts at
    another card raises."""
    from semanticsegmentation_tensorflow_tpu_torch.infer import predict
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.scripts.common import mesh_devices

    class Cast(Exception):
        pass

    def cast(model, device):
        raise Cast(device)

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(predict, "inference_form", cast)
    device = torch.device(name)
    mesh = mesh_devices(device)
    assert mesh == [torch.device(d) for d in want]
    model = build_model("fcn32s", 2, device="meta", fc_features=32, width_mult=0.25)
    with pytest.raises(Cast):
        Predictor(model, IMAGE_HW, device=device, mesh=mesh)
    with pytest.raises(ValueError, match="start with"):
        Predictor(model, IMAGE_HW, device=device, mesh=mesh[::-1])


def test_serve_cli_mesh_answers_segment(capsys):
    """``serve.py --mesh --device cpu``: one device, so the flag changes
    nothing (no ``mesh serving`` line, as the JAX CLI on one device) and
    /segment answers with the overlay of a Predictor on the same seeded
    weights."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import serve

    server, _ = serve.make_server(["--mesh", "--device", "cpu", "--model", "fcn32s",
                                   "--model-kw", "fc_features=32,width_mult=0.25",
                                   "--port", "0", "--no-warmup"])
    assert "mesh serving" not in capsys.readouterr().out
    pred = server.predictor
    assert pred.mesh_size == 1
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(3).integers(0, 256, (*pred.image_size, 3), np.uint8)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=120)
        conn.request("POST", "/segment", body=_png(img))
        r = conn.getresponse()
        assert r.status == 200
        got = np.asarray(Image.open(io.BytesIO(r.read())))
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    labels = pred._fetch_labels(img[None])[0]
    np.testing.assert_array_equal(got, host_overlay(img, labels, pred._palette,
                                                    pred._alpha))


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
    (["--device", "cpu", "--calib-dir", "imgs/"], NotImplementedError),
    (["--device", "cpu", "--tile-overlap", "64"], NotImplementedError),
    (["--device", "cpu", "--checkpoint-dir", "ckpt"], NotImplementedError),
])
def test_cli_guards(entry, extra, err, monkeypatch, tmp_path, capsys):
    """--device cuda raises when no card is present (never drops to the
    CPU); unported flags raise before any model is built, naming the flag; a
    --checkpoint-dir of the JAX package's orbax checkpoints (step
    subdirectories) raises with the conversion hint. --tiled and
    --tile-overlap raised so until tiled inference was ported: infer_image
    now runs them (narrow, seeded weights), and serve refuses them in
    argparse, as the JAX package's serve.py, which has neither. --int8 and
    --calib-dir raised so until int8 serving was ported: infer_image --int8
    now calibrates on its image, serve --int8 is weight-only and with
    --calib-dir calibrates on that directory's images (17 convs of a narrow
    FCN-32s), and infer_image refuses --calib-dir in argparse, as the JAX
    package's infer_image.py, which has no such flag."""
    from semanticsegmentation_tensorflow_tpu_torch.infer.quant import (
        quantized_count,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import (
        infer_image, serve,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ckpt" / "1").mkdir(parents=True)
    argv = extra + (["--image", "x.png"] if entry == "infer_image" else [])
    fn = infer_image.main if entry == "infer_image" else serve.make_server
    if "--int8" in extra or "--calib-dir" in extra:
        if entry == "infer_image" and "--calib-dir" in extra:
            with pytest.raises(SystemExit):
                fn(argv)
            return
        (tmp_path / "imgs").mkdir()
        for name in ("x.png", "imgs/a.png", "imgs/b.png"):
            Image.fromarray(np.random.default_rng(len(name)).integers(
                0, 256, (45, 70, 3), np.uint8)).save(tmp_path / name)
        narrow = ["--model", "fcn32s", "--model-kw", "fc_features=32,width_mult=0.25"]
        if entry == "infer_image":
            assert fn(argv + narrow) == 0
            assert Image.open(tmp_path / "overlay.png").size == (1242, 375)
            want = "int8: 17 activation scales"
        else:
            server, _ = fn(argv + narrow + ["--int8", "--port", "0", "--no-warmup"])
            server.server_close()
            assert quantized_count(server.predictor.model) == 17
            want = ("int8 serving: 17 activation scales" if "imgs/" in extra
                    else "int8 serving: 0 activation scales (weight-only)")
        assert want in capsys.readouterr().out.splitlines()
        return
    if extra[-1] in ("--tiled", "64"):
        if entry == "serve":
            with pytest.raises(SystemExit):
                fn(argv)
            return
        Image.fromarray(np.random.default_rng(2).integers(
            0, 256, (45, 70, 3), np.uint8)).save(tmp_path / "x.png")
        assert fn(argv + ["--tiled", "--model", "fcn32s", "--model-kw",
                          "fc_features=32,width_mult=0.25"]) == 0
        assert Image.open(tmp_path / "overlay.png").size == (70, 45)
        return
    with pytest.raises(err, match=extra[2] if err is NotImplementedError
                       else None):
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
    the JAX package); every JAX preset is in it and equal to the
    reference's, and the port's one extra preset is that of its own model,
    DeepLab-v2 ASPP-L."""
    import dataclasses

    from semanticsegmentation_tensorflow_tpu import config as jax_config
    from semanticsegmentation_tensorflow_tpu_torch import config

    assert set(config.PRESETS) - set(jax_config.PRESETS) == {"deeplab_v2_kitti"}
    assert set(jax_config.PRESETS) <= set(config.PRESETS)
    for name, preset in jax_config.PRESETS.items():
        assert dataclasses.asdict(config.PRESETS[name]) == dataclasses.asdict(
            preset), name
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


def test_cpu_predictor_never_captures():
    """On the CPU a key's third call runs eagerly as its first did: no graph
    is captured or replayed, and the answer does not move."""
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params

    model = port_fcn("fcn32s", fc_features=8, width_mult=0.125)
    init_params(model, torch.Generator().manual_seed(0))
    pred = Predictor(model, (32, 32), device="cpu")
    img = np.random.default_rng(1).integers(0, 256, (32, 32, 3), np.uint8)
    first = pred(img)
    for _ in range(2):
        for a, b in zip(pred(img), first):
            np.testing.assert_array_equal(a, b)
    assert (pred.graph_captures, pred.graph_replays) == (0, 0)
    assert pred._graphs == {}


def test_labelpack_weights_made_once_pack_as_before():
    """The bit weights live on the device once, and pack as
    ``np.packbits(bitorder="big")`` does, ragged widths included."""
    from semanticsegmentation_tensorflow_tpu_torch.ops import labelpack

    labels = np.random.default_rng(2).integers(0, 2, (2, 5, 21), np.uint8)
    packed = labelpack.pack_labels(torch.from_numpy(labels), "bits")
    np.testing.assert_array_equal(packed.numpy(),
                                  np.packbits(labels, axis=-1, bitorder="big"))
    w = labelpack._bit_weights(torch.device("cpu"))
    assert w is labelpack._bit_weights(torch.device("cpu"))
    assert w.tolist() == list(labelpack._BIT_WEIGHTS) and w.dtype == torch.int32


@pytest.mark.parametrize("transposed", [False, True])
def test_quant_constants_made_once_keep_their_float32_bits(transposed):
    """A quantized conv holds its activation scale and reciprocal as float32
    buffers (outside its state dict, kept float32 by ``Module.to``), equal
    bit for bit to the constants a call used to make, and its forward
    equals the same product from the Python float scale."""
    from semanticsegmentation_tensorflow_tpu_torch.ops import quant as oq
    from semanticsegmentation_tensorflow_tpu_torch.models.common import Conv
    from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import (
        ConvTranspose,
    )

    scale = 0.0123456789
    g = torch.Generator().manual_seed(3)
    if transposed:
        conv = ConvTranspose(8, 8, 2, dtype=torch.float32)
    else:
        conv = Conv(8, 8, 3, dtype=torch.float32)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    m = (oq.QuantConvTranspose if transposed else oq.QuantConv)(conv, scale)
    m.to(torch.bfloat16)
    assert m.act_scale32.dtype == m.act_recip32.dtype == torch.float32
    assert torch.equal(m.act_recip32.view(torch.int32),
                       oq._recip(scale, "cpu").view(torch.int32))
    assert torch.equal(m.act_scale32.view(torch.int32), torch.tensor(
        scale, dtype=torch.float32).view(torch.int32))
    assert not {"act_scale32", "act_recip32"} & set(m.state_dict())
    x = torch.randn((1, 6, 10, 8), generator=g).bfloat16()
    xq = oq.quantize_act(x, scale)
    assert torch.equal(oq.quantize_act(x, scale, m.act_recip32), xq)
    y32 = (oq.int8_conv_transpose2d(xq, m.weight, m.stride) if transposed
           else oq.int8_conv2d(xq, m.weight, m.dilation))
    want = oq.rescale(y32, m.weight_scale, scale, m.bias, m.dtype)
    assert torch.equal(m(x).view(torch.int16), want.view(torch.int16))
