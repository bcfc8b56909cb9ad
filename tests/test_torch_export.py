"""The port's serving artifacts (``infer/export.py``, ``scripts/export_model.py``,
``serve.py --artifact``) on the CPU, at narrow widths.

An artifact's answers are held bit-equal to the in-process Predictor of the
same weights: one symbolic-batch artifact each of FCN-8s, SegNet and U-Net
serving batches 1, 2 and 3. Then the serving host's imports (no model
module), the platform guards and the CLI round trip. The fixed-batch,
BatchNorm and int8 forms, and the comparison with the JAX package's
artifact, are in tests/test_torch_export_forms.py.
"""

import copy
import http.client
import io
import json
import os
import subprocess
import sys
import threading
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from semanticsegmentation_tensorflow_tpu_torch.infer import (
    ExportedPredictor, Predictor, export_model,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model

from torch_parity import port_fcn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_HW = (40, 70)     # padded to the model's stride by the pipeline
NARROW = {"fcn8s": dict(fc_features=32, width_mult=0.25),
          "segnet": dict(width_mult=0.25),
          "unet": dict(base_features=8),
          "deeplab": dict(width_mult=0.125, aspp_features=16)}


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *IMAGE_HW, 3),
                                                np.uint8)


def _model(name, seed=0, **kw):
    """A narrow model in float32 (the CPU's fast dtype; the artifact keeps
    whatever dtype the model computes in)."""
    model = build_model(name, 2, device="cpu", dtype=torch.float32,
                        **dict(NARROW[name], **kw))
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def _export(model, path, **kw):
    """(artifact predictor, in-process Predictor) of the same weights."""
    meta = export_model(copy.deepcopy(model), IMAGE_HW, str(path),
                        platforms=("cpu",), **kw)
    return meta, ExportedPredictor(str(path), "cpu"), Predictor(
        model, IMAGE_HW, device="cpu")


def _same_as_predictor(art, pred, imgs):
    ov, lab = art(imgs)
    want_ov, want_lab = pred(imgs)
    np.testing.assert_array_equal(ov, want_ov)
    np.testing.assert_array_equal(lab, want_lab)
    labels = art._fetch_labels(imgs)
    assert labels.dtype == np.uint8
    np.testing.assert_array_equal(labels, pred._fetch_labels(imgs))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """name -> (path, meta, artifact predictor, Predictor) of FCN-8s, SegNet
    and U-Net, each exported once for the CPU."""
    out = {}
    for name in ("fcn8s", "segnet", "unet"):
        path = tmp_path_factory.mktemp("segx") / f"{name}.segx"
        out[name] = (str(path), *_export(_model(name), path))
    return out


@pytest.mark.parametrize("name", ["fcn8s", "segnet", "unet"])
def test_symbolic_batch_artifact_equals_predictor(name, artifacts):
    """One artifact at a symbolic batch answers batches 1, 2 and 3 (and a
    single [H,W,3] image) bit for bit as the Predictor does."""
    _, meta, art, pred = artifacts[name]
    assert meta["batch_mode"] == "symbolic" and meta["batch_size"] is None
    assert meta["format"] == "segx-torch-1" and meta["platforms"] == ["cpu"]
    imgs = _images(3)
    for n in (1, 2, 3):
        _same_as_predictor(art, pred, imgs[:n])
    ov, lab = art(imgs[0])
    assert ov.shape == (*IMAGE_HW, 3) and lab.shape == IMAGE_HW
    np.testing.assert_array_equal(lab, pred(imgs[0])[1])


def test_serving_host_imports_no_model(artifacts):
    """Loading an artifact and answering with it imports no module of the
    port's ``models`` package (a fresh interpreter)."""
    path = artifacts["segnet"][0]
    code = (
        "import sys, numpy as np\n"
        "from semanticsegmentation_tensorflow_tpu_torch.infer.export import "
        "ExportedPredictor\n"
        f"p = ExportedPredictor({path!r}, 'cpu')\n"
        f"print(p.labels(np.zeros((1, {IMAGE_HW[0]}, {IMAGE_HW[1]}, 3), "
        "np.uint8)).shape)\n"
        "print(sorted(m for m in sys.modules if "
        "m.startswith('semanticsegmentation_tensorflow_tpu_torch.models')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines() == [f"(1, {IMAGE_HW[0]}, {IMAGE_HW[1]})", "[]"]


def test_platform_guards(monkeypatch, tmp_path, artifacts):
    """``cuda`` is traced on the card: without one, export_model and the
    CLI raise; an artifact without the asked platform raises, and so does a
    platform the port does not know."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import export_model as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _model("unet")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model(model, IMAGE_HW, str(tmp_path / "x.segx"), platforms=("cuda",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--device", "cpu", "--platforms", "cuda", "--model", "unet",
                  "--model-kw", "base_features=8", "--out", str(tmp_path / "y.segx")])
    with pytest.raises(ValueError, match="platforms"):
        export_model(model, IMAGE_HW, str(tmp_path / "x.segx"), platforms=("tpu",))
    path = artifacts["unet"][0]
    with pytest.raises(ValueError, match="no cuda program"):
        ExportedPredictor(path, "cuda")
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == ["labels_cpu.pt2", "meta.json",
                                        "overlay_cpu.pt2"]
        assert json.loads(z.read("meta.json"))["entries"] == {
            "labels": {"cpu": "labels_cpu.pt2"}, "overlay": {"cpu": "overlay_cpu.pt2"}}


def test_export_cli_then_serve_artifact(tmp_path, capsys):
    """``export_model.py`` on a --weights file (narrow FCN-32s at the
    preset's 375x1242), then ``serve.py --artifact --device cpu``: /segment
    and /labels answer as the Predictor of the same weights; the preset and
    model flags are ignored, --int8 with --artifact raises."""
    from semanticsegmentation_tensorflow_tpu_torch.ops.overlay import host_overlay
    from semanticsegmentation_tensorflow_tpu_torch.scripts import (
        export_model as cli, serve,
    )

    kw = "fc_features=32,width_mult=0.25"
    model = port_fcn("fcn32s", dtype=torch.bfloat16)
    init_params(model, torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "w.pt")
    art = str(tmp_path / "fcn32s.segx")
    assert cli.main(["--model", "fcn32s", "--model-kw", kw, "--weights",
                     str(tmp_path / "w.pt"), "--device", "cpu", "--platforms",
                     "cpu", "--out", art]) == 0
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith(f"wrote {art} (") and line.endswith(
        "batch=symbolic platforms=cpu image_size=[375, 1242]"), line
    with pytest.raises(ValueError, match="--int8"):
        serve.make_server(["--artifact", art, "--device", "cpu", "--int8"])
    server, _ = serve.make_server(["--artifact", art, "--device", "cpu",
                                   "--port", "0", "--preset", "segnet_kitti",
                                   "--alpha", "0.9"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    pred = Predictor(model, (375, 1242), device="cpu")
    img = np.random.default_rng(2).integers(0, 256, (375, 1242, 3), np.uint8)
    labels = pred._fetch_labels(img[None])[0]
    want = {"/segment": host_overlay(img, labels, pred._palette, pred._alpha),
            "/labels": np.repeat(labels[..., None], 3, -1)}
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=120)
        for path in ("/segment", "/labels"):
            conn.request("POST", path, body=buf.getvalue())
            r = conn.getresponse()
            assert r.status == 200, path
            got = np.asarray(Image.open(io.BytesIO(r.read())))
            np.testing.assert_array_equal(got, want[path])
        conn.close()
        assert server.stats["requests"] == 2
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
