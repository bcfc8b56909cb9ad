"""The port's evaluation path against the JAX package on the CPU, in float32
at small widths: the road-confidence histogram and the KITTI road devkit
measures, the eval step (FCN-8s and SegNet), the loop's validation hooks
and keep-best, and the eval CLI.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.train import metrics as jax_metrics
from semanticsegmentation_tensorflow_tpu.train.state import TrainState as JaxTrainState
from semanticsegmentation_tensorflow_tpu.train.step import (
    make_eval_step as jax_eval_step,
)
from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
    make_augment_fn, normalize_images,
)
from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import BatchLoader
from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
    generate_synthetic_kitti,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.scripts import eval as eval_cli
from semanticsegmentation_tensorflow_tpu_torch.train import metrics
from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
    CheckpointManager, checkpoint_steps, load_weights,
)
from semanticsegmentation_tensorflow_tpu_torch.train.loop import LoopHooks, train
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import (
    make_eval_step, make_train_step,
)

from torch_parity import jax_fcn, jax_init, port_fcn

KW = "fc_features=32,width_mult=0.25"
MEAN, STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)


def _probs(n, seed):
    """f32 probabilities with every k/256 edge, 0, 1 and the f32 just below
    1 among random values."""
    rng = np.random.default_rng(seed)
    edges = np.arange(257, dtype=np.float32) / 256
    special = np.array([0.0, 1.0, np.nextafter(np.float32(1), 0),
                        np.nextafter(np.float32(0.5), 0)], np.float32)
    p = np.concatenate([edges, special, rng.random(n).astype(np.float32)])
    return rng.permutation(p)


@pytest.mark.parametrize("masked", [False, True])
def test_road_histogram_matches_jax_bit_for_bit(masked):
    p = _probs(5000, seed=0)
    rng = np.random.default_rng(1)
    gt = rng.random(p.shape) > 0.6
    valid = rng.random(p.shape) > 0.3 if masked else None
    got = metrics.binary_confidence_histogram(
        torch.from_numpy(p), torch.from_numpy(gt),
        None if valid is None else torch.from_numpy(valid))
    want = jax_metrics.binary_confidence_histogram(
        jnp.asarray(p), jnp.asarray(gt),
        None if valid is None else jnp.asarray(valid))
    assert got.dtype == torch.int64 and got.shape == (2, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() == (p.size if valid is None else valid.sum())


def test_kitti_road_metrics_match_jax():
    """The devkit measures, float-equal on the same histograms: random ones,
    one with a single occupied bin, and the degenerate cases (no positive
    pixel, no pixel at all) that return zeros."""
    rng = np.random.default_rng(2)
    hists = [rng.integers(0, 1000, (2, 256)) for _ in range(3)]
    one_bin = np.zeros((2, 256), np.int64)
    one_bin[:, 200] = (7, 11)
    no_pos = np.zeros((2, 256), np.int64)
    no_pos[0] = rng.integers(0, 50, 256)
    hists += [one_bin, no_pos, np.zeros((2, 256), np.int64)]
    for h in hists:
        got = metrics.kitti_road_metrics(torch.from_numpy(h))
        want = jax_metrics.kitti_road_metrics(jnp.asarray(h, jnp.int32))
        assert got == want
    assert set(metrics.kitti_road_metrics(no_pos).values()) == {0.0}


def _eval_batch(seed, n=3, hw=(64, 96)):
    """Normalized-looking images, labels and a valid mask whose last
    example is wholly invalid (the loader's wrap-padded row)."""
    rng = np.random.default_rng(seed)
    valid = rng.random((n, *hw)) > 0.2
    valid[-1] = False
    return {"image": rng.normal(size=(n, *hw, 3)).astype(np.float32),
            "label": rng.integers(0, 2, (n, *hw)).astype(np.int32),
            "valid": valid}


def _models(name):
    if name == "segnet":
        from test_torch_segnet import jax_init as seg_init, jax_segnet, port_segnet

        jm = jax_segnet()
        variables = seg_init(jm, hw=(64, 96))
        return jm, variables, port_segnet(variables)
    jm = jax_fcn(name)
    variables = jax_init(jm)
    return jm, variables, port_fcn(name, variables)


@pytest.mark.parametrize("name", ["fcn8s", "segnet"])
def test_eval_step_matches_jax(name):
    """make_eval_step against JAX's on the same weights and batch (f32).
    loss within rtol 1e-5; the confusion matrix equal up to the near-tie
    pixels (|l1 - l0| <= 1e-4 of the logit scale: another summation order
    may order them either way; each moves at most 2 counts of cm);
    road_hist within an L1 of 2 per valid pixel whose probability * 256 lies
    within 1e-3 of a bin edge. The step leaves a train()-mode model in
    train() mode and draws from neither generator."""
    jm, variables, model = _models(name)
    batch = _eval_batch(0)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       opt_state=None, batch_stats={}, rng=jax.random.key(0),
                       apply_fn=jm.apply, tx=None)
    want = jax_eval_step(2, road_hist=True)(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                               make_lr_schedule(1e-3), seed=0)
    gens = (state.aug_gen.get_state(), state.dropout_gen.get_state())
    got = make_eval_step(2, road_hist=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.model.training
    assert all(torch.equal(a, b) for a, b in zip(
        gens, (state.aug_gen.get_state(), state.dropout_gen.get_state())))

    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    logits = np.asarray(jm.apply(variables, jnp.asarray(batch["image"])))
    margin = np.abs(logits[..., 1] - logits[..., 0])
    near = margin <= 1e-4 * np.abs(logits).max()
    valid = batch["valid"]
    decided = ~near
    np.testing.assert_array_equal(got["pred"].numpy()[decided],
                                  np.asarray(want["pred"])[decided])
    cm_diff = np.abs(got["cm"].numpy() - np.asarray(want["cm"])).sum()
    assert cm_diff <= 2 * (near & valid).sum()
    assert got["cm"].sum() == valid.sum()
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)[..., 1]) * 256
    edge = np.abs(prob - np.round(prob)) < 1e-3
    l1 = np.abs(got["road_hist"].numpy() - np.asarray(want["road_hist"])).sum()
    assert l1 <= 2 * (edge & valid).sum()
    assert got["road_hist"].sum() == valid.sum()   # exact total
    with pytest.raises(ValueError, match="binary"):
        make_eval_step(5, road_hist=True)


def _uint8_batches(n_batches, seed=0, n=2, hw=(40, 72)):
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(rng.integers(0, 256, (n, *hw, 3), np.uint8)),
             "label": torch.from_numpy(rng.integers(0, 2, (n, *hw)).astype(np.int32)),
             "valid": torch.from_numpy(rng.random((n, *hw)) > 0.1)}
            for _ in range(n_batches)]


def test_loop_validation_keeps_training_bit_for_bit(tmp_path):
    """Dropout 0.5, random crops, EMA: three epochs with a val_fn after each
    (the eval step on held-out batches, as the train CLI builds it) leave
    the parameters, the EMA and both generators bit-equal to the same loop
    without one. best/ is written when val_miou improves (scripted here
    as 0.5, 0.4, 0.6: saves after epochs 1 and 3, not 2)."""
    aug = make_augment_fn(MEAN, STD, crop_size=(32, 64))
    step_fn = make_train_step(2, augment_fn=aug)
    batches = _uint8_batches(2)
    held = _uint8_batches(1, seed=9, n=3, hw=(64, 96))
    veval = make_eval_step(2)

    def fresh():
        model = port_fcn("fcn8s").train()
        init_params(model, torch.Generator().manual_seed(0))
        return create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                                  make_lr_schedule(1e-3), seed=0, ema_decay=0.9)

    scripted = iter([0.5, 0.4, 0.6])
    seen = []

    def val_fn(state):
        assert state.model.training
        m = metrics.SegMetrics(2)
        for b in held:
            out = veval(state, dict(b, image=normalize_images(b["image"], MEAN, STD)))
            m.update(out["cm"], out["loss"])
        s = m.summary()
        seen.append(float(s["miou"]))
        return {"val_loss": float(s["loss"]), "val_miou": next(scripted)}

    quiet = LoopHooks(on_log=lambda *a: None)
    a, b = fresh(), fresh()
    _, sa = train(a, step_fn, lambda: iter(batches), epochs=3, num_classes=2,
                  log_every=0, hooks=quiet)
    saves = []
    best = CheckpointManager(str(tmp_path / "best"), max_to_keep=1)
    real_save = best.save
    best.save = lambda s: saves.append(s.step) or real_save(s)
    _, sb = train(b, step_fn, lambda: iter(batches), epochs=3, num_classes=2,
                  log_every=0, hooks=quiet, val_every=1, val_fn=val_fn,
                  best_ckpt=best)
    assert len(seen) == 3 and all(np.isfinite(seen))
    assert saves == [2, 6]
    assert checkpoint_steps(str(tmp_path / "best")) == [6]
    assert sb["val_miou"] == 0.6 and sb["val_best"] == 0.6 and "val_loss" in sb
    assert "val_loss" not in sa and sa["loss"] == sb["loss"]
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
        assert torch.equal(a.ema_params[k], b.ema_params[k]), k
    assert torch.equal(a.aug_gen.get_state(), b.aug_gen.get_state())
    assert torch.equal(a.dropout_gen.get_state(), b.dropout_gen.get_state())


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_replicated_eval_step_equals_one_device(tta):
    """``replicate_eval_step`` (eval.py's one-process ``--mesh``: one replica
    of the model per device, the batch cut into one equal part each, the
    sums added) over two CPU replicas against the step on the whole batch:
    the confusion matrix, the road histogram and the predictions exact,
    the loss within rtol 1e-6 (two partial sums); a batch that does not
    divide over the replicas raises."""
    import copy

    from semanticsegmentation_tensorflow_tpu_torch.infer.tta import (
        make_tta_eval_step,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.step import (
        replicate_eval_step,
    )

    model = port_fcn("fcn8s")
    init_params(model, torch.Generator().manual_seed(2))
    step = (make_tta_eval_step(2, scales=(0.75, 1.0), road_hist=True) if tta
            else make_eval_step(2, road_hist=True))
    b = _uint8_batches(1, seed=4, n=4, hw=(32, 64))[0]
    b = dict(b, image=normalize_images(b["image"], MEAN, STD))
    want = step(model, b)
    got = replicate_eval_step(step, [model, copy.deepcopy(model)])(None, b)
    for k in ("cm", "road_hist", "pred"):
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_allclose(got["loss"].item(), want["loss"].item(), rtol=1e-6)
    with pytest.raises(ValueError, match="replicas"):
        replicate_eval_step(step, [model] * 3)(None, b)


def _eval_cli_setup(tmp_path):
    """A synthetic KITTI set of 5 images (batch 2 wrap-pads the last) and a
    port checkpoint with EMA params that differ from the raw ones."""
    data = generate_synthetic_kitti(str(tmp_path / "data"), n_train=5, n_test=1,
                                    h=64, w=96, seed=3)
    model = build_model("fcn8s", 2, device="cpu", fc_features=32, width_mult=0.25)
    init_params(model, torch.Generator().manual_seed(1))
    state = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                               make_lr_schedule(1e-3), seed=0, ema_decay=0.5)
    for e in state.ema_params.values():
        e.mul_(0.9)
    state.step = 7
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(state)
    return data, ck


_LINE = re.compile(r"loss=(\S+) miou=(\S+) pixel_acc=(\S+) iou=(\[.*\])")


@pytest.mark.parametrize("ema", [False, True])
def test_eval_cli_prints_its_eval_step(tmp_path, capsys, ema):
    """eval.main prints the JAX CLI's lines; its numbers equal the eval step
    run directly over the same loader on the checkpoint's weights."""
    data, ck = _eval_cli_setup(tmp_path)
    argv = ["--device", "cpu", "--model-kw", KW, "--data-dir", data,
            "--checkpoint-dir", ck, "--batch-size", "2", "--road-metrics"]
    assert eval_cli.main(argv + (["--ema"] if ema else [])) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "evaluating checkpoint step 7" + (" (EMA params)" if ema else "")
    assert out[1] == "evaluating split='train' (5 images)"

    model = build_model("fcn8s", 2, device="cpu", fc_features=32, width_mult=0.25)
    model.load_state_dict(load_weights(ck, use_ema=ema))
    ds = build_dataset("kitti_road", data, (375, 1242))
    loader = BatchLoader(ds, 2, device="cpu", drop_remainder=False)
    step = make_eval_step(2, road_hist=True)
    m, hist = metrics.SegMetrics(2), torch.zeros((2, 256), dtype=torch.int64)
    for b in loader.epoch():
        o = step(model, dict(b, image=normalize_images(b["image"], MEAN, STD)))
        m.update(o["cm"], o["loss"])
        hist += o["road_hist"]
    s = {k: v.tolist() for k, v in m.summary().items()}
    assert out[2] == (f"loss={s['loss']:.4f} miou={s['miou']:.4f} "
                      f"pixel_acc={s['pixel_acc']:.4f} iou={s['iou']}")
    assert _LINE.fullmatch(out[2])
    r = metrics.kitti_road_metrics(hist)
    assert out[3] == (f"kitti-road: MaxF={r['maxf']:.4f} AP={r['ap']:.4f} "
                      f"PRE={r['precision']:.4f} REC={r['recall']:.4f} "
                      f"FPR={r['fpr']:.4f} FNR={r['fnr']:.4f} "
                      f"@tau={r['threshold']:.3f}")
    assert re.fullmatch(r"5 images in \S+s \(\S+ img/s\)", out[4])


@pytest.mark.parametrize("extra,err,match", [
    (["--tta"], NotImplementedError, "--tta"),
    (["--tta-scales", "0.75,1.0"], NotImplementedError, "--tta-scales"),
    (["--int8"], NotImplementedError, "--int8"),
    (["--calib-batches", "8"], NotImplementedError, "--calib-batches"),
    (["--mesh"], NotImplementedError, "--mesh"),
    (["--distributed"], NotImplementedError, "--distributed"),
    (["--coordinator", "h:1"], NotImplementedError, "--coordinator"),
    (["--num-processes", "2"], NotImplementedError, "--num-processes"),
    (["--process-id", "1"], NotImplementedError, "--process-id"),
    (["--device", "cuda"], RuntimeError, "no CUDA device"),
    (["--split", "testing"], ValueError, "testing"),
    # the JAX defaults of the unported flags parse and do not raise
    (["--calib-batches", "4", "--checkpoint-dir", "EMPTY"], FileNotFoundError,
     "no port checkpoint"),
    (["--checkpoint-dir", "ORBAX"], NotImplementedError,
     "convert_checkpoint_to_torch"),
])
def test_eval_cli_guards(tmp_path, monkeypatch, capsys, extra, err, match):
    """Unported flags raise NotImplementedError naming the flag; --device
    cuda raises without a card (never drops to the CPU); an orbax
    directory points at the conversion tool. --tta and --tta-scales raised
    so until test-time augmentation was ported: they now evaluate, printing
    the JAX CLI's ``TTA eval:`` line. --int8 and --calib-batches raised so
    until int8 was ported: --int8 now evaluates the int8 model calibrated
    on the default 4 batches, and with --calib-batches 8 on every batch
    there is (the JAX CLI's ``int8:`` line; 21 convs of FCN-8s). --mesh and
    the process-group flags raised so until multi-rank eval was ported:
    --mesh now evaluates on the one device there is, printing no ``mesh
    eval`` line (the JAX CLI's one-device case), and --distributed with
    --coordinator, --num-processes or --process-id missing raises before
    any work, naming what is missing (the run on gloo ranks is a scenario
    of tests/test_torch_spatial.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("SEG_COORDINATOR", "SEG_NUM_PROCESSES", "SEG_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    data, ck = _eval_cli_setup(tmp_path)
    (tmp_path / "EMPTY").mkdir()
    (tmp_path / "ORBAX" / "7").mkdir(parents=True)
    extra = [str(tmp_path / a) if a in ("EMPTY", "ORBAX") else a for a in extra]
    argv = ["--device", "cpu", "--model-kw", KW, "--data-dir", data,
            "--checkpoint-dir", ck] + extra
    if match in ("--int8", "--calib-batches"):
        assert eval_cli.main(argv + ["--int8"] * (match == "--calib-batches")) == 0
        assert "int8: 21 convs quantized, 21 activation scales" in \
            capsys.readouterr().out.splitlines()
        return
    if match == "--mesh":
        assert eval_cli.main(argv) == 0
        out = capsys.readouterr().out
        assert "loss=" in out and "mesh eval" not in out
        return
    if match in ("--distributed", "--coordinator", "--num-processes",
                 "--process-id"):
        missing = "world size" if match == "--coordinator" else "coordinator"
        with pytest.raises(ValueError, match=missing):
            eval_cli.main(argv + ["--distributed"] * (match != "--distributed"))
        return
    if match.startswith("--tta"):
        assert eval_cli.main(argv) == 0
        scales = "[0.75, 1.0]" if match == "--tta-scales" else "[1.0]"
        assert f"TTA eval: scales={scales} flip=True" in capsys.readouterr().out
        return
    with pytest.raises(err, match=match):
        eval_cli.main(argv)
    assert os.path.isdir(ck)
