"""The port's DeepLab-v2 ASPP-L (``models/deeplab_v2.py``, a port-only model)
against the benchmark's plain float32 reference
(``portbench/reference/models/deeplab_v2.py``), on the CPU in float32 at a
tiny width (width_mult 0.125, fc 32, the published rates 6/12/18/24) from
seeded random weights:

* the forward in eval mode, also on a map of fewer rows than rate 24's
  window; the parameter names and shapes; the published parameter count;
* one train step's loss and gradients, with the reference's dropout masks
  drawn from the step's generator in the program's order;
* the Predictor's labels against the reference's argmax;
* the ``aspp`` and ``aspp.branch`` spans inside ``step.forward``; the
  spatial-grid guard; an ImageNet VGG16 archive imported into the
  backbone; the in-map tap count of ``aspp_roofline.train``'s work;
* the CLIs at ``deeplab_v2_kitti``: train two steps, eval and serve the
  checkpoint.

Tolerance for logits and gradients: 1e-4 of the largest value (f32 on both
sides, the same operations; only the summation order may differ).
"""

import http.client
import io
import os
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import atrous, inputs  # noqa: E402
from portbench.reference import predict  # noqa: E402
from portbench.reference.models import deeplab_v2 as ref  # noqa: E402
from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor  # noqa: E402
from semanticsegmentation_tensorflow_tpu_torch.models.registry import (  # noqa: E402
    build_model,
)
from semanticsegmentation_tensorflow_tpu_torch.train.state import (  # noqa: E402
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import (  # noqa: E402
    make_train_step,
)
from semanticsegmentation_tensorflow_tpu_torch.utils import tracing  # noqa: E402

KW = {"width_mult": 0.125, "fc_features": 32}
CFG = {"model": "deeplab_v2", "num_classes": 2, "model_kwargs": KW,
       "dropout_rate": 0.5}
NARROW = ["--model-kw", "width_mult=0.125,fc_features=16"]


def _weights(seed=3):
    return inputs.make_weights(torch, ref.param_specs(CFG), seed, "cpu")


def _port(weights, **kw):
    model = build_model("deeplab_v2", 2, device="cpu", dtype=torch.float32,
                        **KW, **kw)
    model.load_state_dict(weights, strict=True)
    return model


def _close(got, want, scale=None):
    scale = float(want.abs().max()) if scale is None else scale
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * max(scale, 1e-12)


@pytest.mark.parametrize("hw", [(64, 128), (160, 64)])
def test_forward_matches_the_reference(hw):
    """Eval mode at 64x128 (pool5 8x16) and at 160x64, whose 20 rows at
    pool5 are fewer than rate 24's 49-row window."""
    w = _weights()
    x = torch.randn(2, *hw, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = _port(w).eval()(x)
        want = ref.forward(CFG, w, x)
    assert got.dtype == torch.float32 and got.shape == (2, *hw, 2)
    _close(got, want)


def test_parameters_are_the_references():
    model = build_model("deeplab_v2", 2, device="meta", **KW)
    got = [(k, tuple(p.shape)) for k, p in model.named_parameters()]
    assert got == [(k, s) for k, s, _ in ref.param_specs(CFG)]
    assert got[-1][0] == "aspp.fc8_24.bias"


def test_published_widths_have_the_hand_counted_parameters():
    """VGG16's 13 convs (14,714,688) and four branches of fc6 (3x3, 512 ->
    1024), fc7 (1024 -> 1024) and fc8 (1024 -> 2), 5,771,266 each."""
    model = build_model("deeplab_v2", 2, device="meta", fc_features=1024)
    vgg = sum(p.numel() for p in model.vgg16.parameters())
    branch = (512 * 1024 * 9 + 1024) + (1024 * 1024 + 1024) + (1024 * 2 + 2)
    assert vgg == 14_714_688 and branch == 5_771_266
    assert sum(p.numel() for p in model.parameters()) == 37_799_752
    assert [getattr(model.aspp, f"fc6_{r}").dilation for r in (6, 12, 18, 24)] \
        == [6, 12, 18, 24] and model.total_stride == 8


def test_train_step_matches_the_reference():
    """One step (Adam 1e-4, dropout 0.5, no augment): the loss and every
    gradient equal the reference's under the keep-masks drawn from the
    state's dropout generator (seed + 1) at ``mask_shapes``, in order."""
    w = _weights()
    model = _port(w)
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-4),
                               make_lr_schedule(1e-4), seed=5)
    g = torch.Generator().manual_seed(2)
    n, h, wd = 2, 64, 128
    batch = {"image": torch.randn(n, h, wd, 3, generator=g),
             "label": torch.randint(0, 2, (n, h, wd), generator=g, dtype=torch.int32),
             "valid": torch.rand(n, h, wd, generator=g) < 0.9}
    out = make_train_step(2)(state, batch)

    drop = torch.Generator().manual_seed(6)
    masks = [torch.rand(s, generator=drop) < 0.5 for s in ref.mask_shapes(CFG, n, h, wd)]
    p = {k: v.clone().requires_grad_() for k, v in w.items()}
    logp = torch.log_softmax(ref.forward(CFG, p, batch["image"], masks), -1)
    valid = batch["valid"].float()
    ce = -(logp.gather(-1, batch["label"].long().unsqueeze(-1)).squeeze(-1)
           * valid).sum() / valid.sum()
    ce.backward()
    np.testing.assert_allclose(float(out["loss"]), float(ce.detach()), rtol=1e-5)
    for k, q in model.named_parameters():
        _close(q.grad, p[k].grad)


def test_predictor_labels_are_the_references_argmax():
    """A 47x90 frame padded by its edge pixels to 48x96 and cropped back:
    the labels on every pixel the reference decides by more than 1e-4 of
    its logit scale."""
    w = _weights()
    cfg = dict(CFG, mean=[123.68, 116.779, 103.939], std=[58.393, 57.12, 57.375])
    images = np.random.default_rng(7).integers(0, 256, (2, 47, 90, 3), np.uint8)
    _, labels = Predictor(_port(w), (47, 90), device="cpu")(images)
    for img, lab in zip(images, labels):
        logits = predict.logits(cfg, w, img, "cpu")
        margin = (logits[..., 1] - logits[..., 0]).abs()
        ok = (margin > 1e-4 * logits.abs().max()).numpy()
        assert ok.mean() >= 0.99
        np.testing.assert_array_equal(lab[ok], logits.argmax(-1).numpy()[ok])


def test_a_step_records_the_head_spans_inside_the_forward():
    model = _port(_weights())
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-4),
                               make_lr_schedule(1e-4), seed=0)
    batch = {"image": torch.randn(1, 64, 64, 3),
             "label": torch.zeros(1, 64, 64, dtype=torch.int32)}
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        make_train_step(2)(state, batch)
        spans = tracing.drain()["spans"]
    finally:
        tracing.disable()
    by_id = {s.id: s for s in spans}
    (head,) = [s for s in spans if s.name == "aspp"]
    assert by_id[head.parent].name == "step.forward"
    branches = [s for s in spans if s.name == "aspp.branch"]
    assert len(branches) == 4 and all(s.parent == head.id for s in branches)


def test_a_grid_that_splits_rows_raises(monkeypatch):
    from semanticsegmentation_tensorflow_tpu_torch.models import deeplab_v2

    monkeypatch.setattr(deeplab_v2, "spatial_grid", lambda: object())
    with pytest.raises(NotImplementedError, match="halo"):
        _port(_weights()).eval()(torch.zeros(1, 64, 64, 3))


def test_an_imagenet_vgg16_archive_imports_into_the_backbone(tmp_path):
    """``load_npz_weights(strict=True)`` fills every backbone conv from an
    archive of VGG16's 13 convs in flax paths, and only those."""
    from semanticsegmentation_tensorflow_tpu_torch import convert
    from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import (
        load_npz_weights,
    )

    model = _port(_weights())
    rng = np.random.default_rng(0)
    blob = {}
    for k, v in model.state_dict().items():
        if k.startswith("vgg16."):
            layout = convert.flax_layout(np.zeros(v.shape, np.float32), False)
            blob[convert.flax_key(k)] = rng.standard_normal(layout.shape).astype(np.float32)
    np.savez(tmp_path / "vgg16.npz", **blob)
    report = {}
    sd = load_npz_weights(model.state_dict(), str(tmp_path / "vgg16.npz"),
                          strict=True, report=report)
    assert len(report["matched"]) == 26 and not report["unused_archive"]
    k = "vgg16.stage5.conv2.weight"
    np.testing.assert_array_equal(
        sd[k].numpy(), convert.torch_layout(blob[convert.flax_key(k)], False))


@pytest.mark.parametrize("h,w", [(5, 7), (8, 16), (1, 3)])
@pytest.mark.parametrize("k,d", [(3, 1), (3, 2), (3, 4), (3, 6), (3, 24), (1, 1)])
def test_in_map_taps_equal_a_brute_force_count(h, w, k, d):
    half = k // 2
    want = sum(1 for i in range(h) for j in range(w)
               for a in range(-half, half + 1) for b in range(-half, half + 1)
               if 0 <= i + a * d < h and 0 <= j + b * d < w)
    assert atrous.in_map_taps(h, w, k, d) == want


def test_aspp_work_at_the_cells_shape():
    """At batch 10 on pool5's 40x144: 6.03 TFLOP of in-map taps, against
    7.97 TFLOP counting every tap."""
    cfg = dict(CFG, model_kwargs={"fc_features": 1024})
    _, flops = atrous.aspp_work(cfg, 10, 40, 144)
    px = 10 * 40 * 144
    every = 3 * 4 * 2 * px * (512 * 1024 * 9 + 1024 * 1024 + 1024 * 2)
    assert abs(flops - 6.0275294208e12) < 1e3 and abs(every - 7.9749e12) < 1e9


def test_clis_train_eval_and_serve_a_deeplab_v2_checkpoint(tmp_path, capsys):
    """``deeplab_v2_kitti`` (narrow, on the CPU): train.py for two steps on
    synthetic frames, eval.py on its checkpoint, and serve's /labels on it
    equal to the Predictor's labels."""
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli, train
    from semanticsegmentation_tensorflow_tpu_torch.scripts.serve import make_server

    data = generate_synthetic_kitti(str(tmp_path / "data"), n_train=4, n_test=1,
                                    h=64, w=96, seed=3)
    ck = str(tmp_path / "ck")
    kw = ["--preset", "deeplab_v2_kitti", "--device", "cpu", *NARROW]
    assert train.main(kw + ["--data-dir", data, "--epochs", "1", "--image-size",
                            "64", "96", "--batch-size", "2",
                            "--checkpoint-dir", ck]) == 0
    assert eval_cli.main(kw + ["--data-dir", data, "--checkpoint-dir", ck]) == 0
    log = capsys.readouterr().out
    assert "model=deeplab_v2" in log and "evaluating checkpoint step 2" in log
    server, _ = make_server(kw + ["--checkpoint-dir", ck, "--port", "0",
                                  "--no-warmup"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(3).integers(0, 256, (375, 1242, 3), np.uint8)
    want = server.predictor._fetch_labels(img[None])[0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                          timeout=120)
        conn.request("POST", "/labels", body=buf.getvalue())
        r = conn.getresponse()
        assert r.status == 200
        got = np.asarray(Image.open(io.BytesIO(r.read())))
        np.testing.assert_array_equal(got, np.repeat(want[..., None], 3, -1))
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
