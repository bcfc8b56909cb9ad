"""The port's test-set sweep against the JAX package's: ``Predictor.confidence``,
``save_inference_samples``, the ``scripts/test.py`` CLI, and the server's
``/segment`` and ``/labels`` bytes (now the JAX writer's).

Weights are carried across by the port's bridge (``convert.py``) and both
sides compute in f32, so they differ by summation order only: labels are
compared where the JAX logits are not a near-tie (``torch_parity.decided``),
and a confidence map may differ by 1 count where round(p * 255) sits on a
rounding boundary, on at most 0.1 % of pixels.
"""

import http.client
import io
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image, UnidentifiedImageError

from semanticsegmentation_tensorflow_tpu.infer.predict import (
    Predictor as JaxPredictor, save_inference_samples as jax_sweep,
)
from semanticsegmentation_tensorflow_tpu.utils import fastpng as jax_fastpng
from semanticsegmentation_tensorflow_tpu_torch.infer import (
    Predictor, save_inference_samples,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
from semanticsegmentation_tensorflow_tpu_torch.utils import fastpng

from torch_parity import decided, jax_fcn, jax_init, port_fcn

IMAGE_HW = (40, 70)   # padded to 64x96 by the predictors


@pytest.fixture(scope="module")
def predictors():
    model = jax_fcn("fcn8s")
    variables = jax_init(model)
    jax_pred = JaxPredictor(model, variables, IMAGE_HW)
    port_pred = Predictor(port_fcn("fcn8s", variables), IMAGE_HW, device="cpu")
    return jax_pred, port_pred


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(7).integers(0, 256, (5, *IMAGE_HW, 3),
                                             np.uint8)


def test_confidence_matches_jax(predictors, images):
    jax_pred, port_pred = predictors
    got = port_pred.confidence(images)
    want = np.asarray(jax_pred.confidence(images))
    assert got.shape == want.shape == (5, *IMAGE_HW) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_array_equal(port_pred.confidence(images[1]), got[1])
    # round(p * 255) of the f32 logits, computed here in float64
    logits = port_pred._padded_logits(torch.from_numpy(images))[:, :40, :70]
    p = torch.softmax(logits.double(), -1)[..., 1].numpy()
    assert np.abs(got - np.round(p * 255)).max() <= 1


def test_confidence_refuses_a_model_that_is_not_binary():
    pred = Predictor(port_fcn("fcn32s", num_classes=3), IMAGE_HW, device="cpu")
    with pytest.raises(ValueError, match="binary"):
        pred.confidence(np.zeros((*IMAGE_HW, 3), np.uint8))


def _write_images(d, images) -> list[str]:
    d.mkdir()
    paths = []
    for i, im in enumerate(images):
        paths.append(str(d / f"um_{i:06d}.png"))
        Image.fromarray(im).save(paths[-1])
    return paths


def test_save_inference_samples_matches_jax_sweep(predictors, images, tmp_path):
    """Batch 2 over 5 images (a ragged last batch): the files land in input
    order under runs/<timestamp>/, and each overlay equals the JAX sweep's
    wherever the labels are decided, and the port's own labels exactly."""
    jax_pred, port_pred = predictors
    paths = _write_images(tmp_path / "in", images)
    got = list(save_inference_samples(port_pred, paths, str(tmp_path / "port"),
                                      batch_size=2))
    want = list(jax_sweep(jax_pred, paths, str(tmp_path / "jax"), batch_size=2))
    assert [src for src, _ in got] == paths
    (run,) = os.listdir(tmp_path / "port")
    assert [dst for _, dst in got] == [
        str(tmp_path / "port" / run / os.path.basename(p)) for p in paths]
    ok = decided(jax_pred, images)
    labels = port_pred._fetch_labels(images)
    for i, ((_, dst), (_, j_dst)) in enumerate(zip(got, want)):
        ov = np.asarray(Image.open(dst))
        np.testing.assert_array_equal(ov[ok[i]], np.asarray(Image.open(j_dst))[ok[i]])
        np.testing.assert_array_equal(
            ov, host_overlay(images[i], labels[i], port_pred._palette))
        assert open(dst, "rb").read() == fastpng.encode_png(ov)


def test_save_inference_samples_propagates_errors(predictors, images, tmp_path,
                                                  monkeypatch):
    _, port_pred = predictors
    paths = _write_images(tmp_path / "in", images[:3])
    bad = tmp_path / "in" / "um_000009.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(UnidentifiedImageError):
        list(save_inference_samples(port_pred, paths + [str(bad)],
                                    str(tmp_path / "runs"), batch_size=2))

    def broken(path, arr, level=1):
        raise OSError("disk full")

    with monkeypatch.context() as m:
        m.setattr(fastpng, "write_png", broken)
        with pytest.raises(OSError, match="disk full"):
            list(save_inference_samples(port_pred, paths, str(tmp_path / "runs2")))
    # a consumer that stops early stops the producer thread too
    sweep = save_inference_samples(port_pred, paths, str(tmp_path / "runs3"),
                                   prefetch=1)
    next(sweep)
    sweep.close()
    assert not [t for t in threading.enumerate() if t.name == "sweep-producer"]


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """Two KITTI-like test images at the preset's 375x1242 and a weights
    file of a narrow fcn32s (a small CPU forward at full resolution)."""
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params

    d = tmp_path_factory.mktemp("cli")
    data = generate_synthetic_kitti(str(d / "data"), n_train=0, n_test=2)
    model = port_fcn("fcn32s", dtype=torch.bfloat16)
    init_params(model, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), d / "w.pt")
    argv = ["--model", "fcn32s", "--model-kw", "fc_features=32,width_mult=0.25",
            "--weights", str(d / "w.pt"), "--device", "cpu", "--data-dir", data]
    return d, data, model, argv


def test_test_cli_overlays_and_confidence(cli_setup, capsys):
    """scripts/test.py with --weights: overlays under runs/<ts>/ equal the
    Predictor's host composite; --confidence writes the devkit's names
    (um_000000 -> um_road_000000) with the Predictor's maps."""
    from semanticsegmentation_tensorflow_tpu_torch.data.kitti import load_image
    from semanticsegmentation_tensorflow_tpu_torch.scripts import test as test_cli

    d, data, model, argv = cli_setup
    assert test_cli.main(argv + ["--runs-dir", str(d / "runs"), "--batch", "2"]) == 0
    assert test_cli.main(argv + ["--runs-dir", str(d / "conf"), "--batch", "2",
                                 "--confidence"]) == 0
    out = capsys.readouterr().out
    assert out.count("2 images in") == 2 and "img/s" in out
    srcs = sorted(os.listdir(os.path.join(data, "testing", "image_2")))
    assert srcs == ["um_000000.png", "um_000001.png"]
    (run,) = os.listdir(d / "runs")
    (conf,) = os.listdir(d / "conf")
    assert conf.endswith("_conf")
    assert sorted(os.listdir(d / "runs" / run)) == srcs
    assert sorted(os.listdir(d / "conf" / conf)) == ["um_road_000000.png",
                                                     "um_road_000001.png"]
    pred = Predictor(model, (375, 1242), device="cpu")
    imgs = np.stack([load_image(os.path.join(data, "testing", "image_2", s))
                     for s in srcs])
    labels = pred._fetch_labels(imgs)
    conf_maps = pred.confidence(imgs)
    for i, s in enumerate(srcs):
        ov = np.asarray(Image.open(d / "runs" / run / s))
        np.testing.assert_array_equal(ov, host_overlay(imgs[i], labels[i],
                                                       pred._palette))
        c = Image.open(d / "conf" / conf / s.replace("um_", "um_road_"))
        assert c.mode == "L"
        np.testing.assert_array_equal(np.asarray(c), conf_maps[i])


@pytest.mark.parametrize("extra,err,match", [
    (["--int8"], NotImplementedError, "--int8"),
    (["--mesh"], NotImplementedError, "--mesh"),
    (["--calib", "4"], NotImplementedError, "--calib"),
    (["--tiled"], SystemExit, None),
    (["--device", "cuda"], RuntimeError, "no CUDA"),
])
def test_test_cli_guards(extra, err, match, monkeypatch, tmp_path, capsys):
    """A flag the JAX sweep does not have fails in argparse; --device cuda
    without a card raises. --mesh raised so until the one-process mesh was
    ported: on the one device there is it now sweeps as without it (no
    ``mesh inference`` line, --batch unchanged; one file an image). --int8 and --calib raised so until int8 was ported: --int8 now
    sweeps the int8 model calibrated on the first 8 (here both) test images,
    and --int8 --calib 4 too (the ``int8 serving:`` line, 17 convs of a
    narrow FCN-32s; one file an image)."""
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import test as test_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--device", "cpu", "--data-dir", "/nonexistent", *extra]
    if match == "--mesh":
        data = generate_synthetic_kitti(str(tmp_path / "kitti"), n_train=0,
                                        n_test=3, h=40, w=64)
        runs = tmp_path / "runs"
        assert test_cli.main(["--device", "cpu", "--data-dir", data, "--runs-dir",
                              str(runs), "--model", "fcn32s", "--model-kw",
                              "fc_features=32,width_mult=0.25", "--batch", "2",
                              "--mesh"]) == 0
        out = capsys.readouterr().out
        assert "mesh inference" not in out and "rounded" not in out
        assert out.splitlines()[-1].startswith("3 images in ")
        (run,) = os.listdir(runs)
        assert len(os.listdir(runs / run)) == 3
        return
    if match in ("--int8", "--calib"):
        data = generate_synthetic_kitti(str(tmp_path / "kitti"), n_train=0,
                                        n_test=2, h=40, w=64)
        argv = ["--device", "cpu", "--data-dir", data, "--runs-dir",
                str(tmp_path / "runs"), "--model", "fcn32s", "--model-kw",
                "fc_features=32,width_mult=0.25", "--int8",
                *(a for a in extra if a != "--int8")]
        assert test_cli.main(argv) == 0
        out = capsys.readouterr().out.splitlines()
        assert "int8 serving: 17 activation scales" in out
        assert out[-1].startswith("2 images in ")
        return
    with pytest.raises(err, match=match):
        test_cli.main(argv)


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_serve_bytes_equal_the_jax_writer(predictors):
    """/segment and /labels answer with the bytes the JAX server's writer
    (``utils.fastpng.encode_png``) gives for the same overlay and label
    map."""
    from http.server import ThreadingHTTPServer

    from semanticsegmentation_tensorflow_tpu_torch.scripts.serve import (
        make_handler,
    )

    _, pred = predictors
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(
        pred, {"requests": 0, "last_ms": None}))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(11).integers(0, 256, (*IMAGE_HW, 3), np.uint8)
    labels = pred._fetch_labels(img[None])[0]
    want = {"/segment": jax_fastpng.encode_png(
                host_overlay(img, labels, pred._palette, pred._alpha)),
            "/labels": jax_fastpng.encode_png(
                np.repeat(labels[..., None], 3, -1))}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=120)
        for path in ("/segment", "/labels"):
            conn.request("POST", path, body=_png(img))
            r = conn.getresponse()
            assert r.status == 200, path
            assert r.read() == want[path], path
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
