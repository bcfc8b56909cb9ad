"""The port's training path against the JAX package on the CPU, in float32
at small widths (``torch_parity.SMALL``): the odd-size VGG16, the stage1
tail's autograd Function against the fused Pallas tail (interpret mode) and
its jnp reference, losses and metrics, the optimizers and schedules, the
train step, checkpoint resume and the train CLI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from semanticsegmentation_tensorflow_tpu.models.vgg16 import VGG16 as JaxVGG16
from semanticsegmentation_tensorflow_tpu.ops.pallas.stage1 import (
    _fused_fwd, fused_stage1_tail, reference_stage1_tail,
)
from semanticsegmentation_tensorflow_tpu.train import loss as jax_loss
from semanticsegmentation_tensorflow_tpu.train import metrics as jax_metrics
from semanticsegmentation_tensorflow_tpu.train.state import (
    TrainState as JaxTrainState, make_lr_schedule as jax_schedule,
    make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu.train.step import (
    make_train_step as jax_train_step,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.data.augment import make_augment_fn
from semanticsegmentation_tensorflow_tpu_torch.infer import Predictor
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import VGG16
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    Stage1Tail, stage1_tail_bwd_plain, stage1_tail_codes_plain, stage1_tail_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.train import loss, metrics
from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
    CheckpointManager, load_weights,
)
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

from torch_parity import SMALL, jax_fcn, jax_init, port_fcn

KW = "fc_features=32,width_mult=0.25"


def test_vgg16_odd_size_matches_jax():
    """Odd H or W: the JAX VGG16 runs stage1 as the plain pooled block, and
    so does the port (it raised before); every endpoint agrees in f32."""
    jm = JaxVGG16(**SMALL, packed_stage1=True, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(1, 10, 14, 3)).astype(np.float32)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    port = VGG16(**SMALL, dtype=torch.float32, device="cpu").eval()
    port.load_state_dict(convert.to_state_dict(
        convert.flatten_params(variables), port))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:  # f32, other summation order: ~1e-6 of the scale
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1), err_msg=k)


def _port_tail(z1_packed, k2_hwio, b2, b1):
    """The port's Stage1 computation (b1 added in conv1_1's output, the
    tail as the autograd Function) on the JAX tail's packed inputs; returns
    the output and the leaves (z1 packed, k2 HWIO, b2, b1) for autograd."""
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
              for a in (z1_packed, k2_hwio, b2, b1)]
    zp, k, b2_, b1_ = leaves
    n, h, wp, c2 = zp.shape
    z1 = (zp.reshape(n, h, 2 * wp, c2 // 2) + b1_).contiguous()
    return Stage1Tail.apply(z1, k.permute(3, 2, 0, 1), b2_), leaves


def _jax_tail_grads(fn, args, cot):
    return [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.vdot(fn(*a), jnp.asarray(cot)), (0, 1, 2, 3))(
            *[jnp.asarray(a) for a in args])]


def test_stage1_tail_function_matches_jax():
    """Values and the gradients of z1, k2, b2 and b1 against jax.grad of
    the fused Pallas tail (interpret mode) and of its jnp reference, at
    tests/test_packed_stem.py's shapes. f32: rtol 1e-4."""
    rng = np.random.default_rng(0)
    args = (rng.normal(size=(2, 8, 16, 128)).astype(np.float32),
            (rng.normal(size=(3, 3, 64, 64)) * 0.1).astype(np.float32),
            (rng.normal(size=(64,)) * 0.1).astype(np.float32),
            (rng.normal(size=(64,)) * 0.1).astype(np.float32))
    out, leaves = _port_tail(*args)
    cot = rng.normal(size=out.shape).astype(np.float32)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    fused = lambda *a: fused_stage1_tail(*a, True)  # noqa: E731
    for fn in (fused, reference_stage1_tail):
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(fn(*map(jnp.asarray, args))),
                                   rtol=1e-4, atol=1e-4)
        for g, w in zip(got, _jax_tail_grads(fn, args, cot)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def _int_tail_args(rng):
    """Integer inputs with repeated kernel taps: many pooling ties."""
    z1 = rng.integers(-2, 3, (1, 6, 8, 128)).astype(np.float32)
    k2 = rng.integers(-1, 2, (3, 3, 64, 64)).astype(np.float32)
    k2[1] = k2[0]
    return z1, k2, np.zeros(64, np.float32), rng.integers(-1, 2, (64,)).astype(np.float32)


def _tie_window_args(rng):
    """A centre-tap identity k2, so the conv output is relu(z1): 2x2
    windows drawn from tie patterns, among them (1,0) = (0,1) > (0,0)."""
    pats = np.array([[1, 2, 2, 0], [2, 2, 2, 2], [0, 1, 1, 1], [3, 1, 3, 0],
                     [1, 1, 2, 2], [0, 0, 1, 2], [-1, -2, 1, 1]], np.float32)
    win = pats[rng.integers(0, len(pats), (1, 3, 8, 64))].reshape(1, 3, 8, 64, 2, 2)
    z1 = win.transpose(0, 1, 4, 2, 5, 3).reshape(1, 6, 8, 128)  # packed pairs
    k2 = np.zeros((3, 3, 64, 64), np.float32)
    k2[1, 1] = np.eye(64)
    return z1, k2, np.zeros(64, np.float32), np.zeros(64, np.float32)


@pytest.mark.parametrize("make_args", [_int_tail_args, _tie_window_args])
def test_stage1_tail_exact_routing_with_ties(make_args):
    """Every sum exact in f32: the routing codes equal the TPU kernel's
    (first maximum in row-major window order, c = b > a picking b), and the
    values and gradients equal both JAX versions bit for bit."""
    rng = np.random.default_rng(1)
    args = make_args(rng)
    out, leaves = _port_tail(*args)
    cot = rng.integers(-3, 4, out.shape).astype(np.float32)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    fused = lambda *a: fused_stage1_tail(*a, True)  # noqa: E731
    for fn in (fused, reference_stage1_tail):
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(fn(*map(jnp.asarray, args))))
        for g, w in zip(got, _jax_tail_grads(fn, args, cot)):
            np.testing.assert_array_equal(g.numpy(), w)
    z1, k2, b2, b1 = args
    _, res = _fused_fwd(*map(jnp.asarray, args), True, False)
    tpu_codes = np.transpose(np.asarray(res[-1]), (2, 0, 1, 3))
    _, codes = stage1_tail_codes_plain(
        torch.from_numpy(z1.reshape(1, 6, 16, 64) + b1),
        torch.from_numpy(k2).permute(3, 2, 0, 1), torch.from_numpy(b2))
    np.testing.assert_array_equal(codes.numpy(), tpu_codes)
    assert set(np.unique(tpu_codes)) == {0, 1, 2, 3}


@pytest.mark.parametrize("shape", [(3, 6, 10, 16), (1, 4, 34, 48)])
def test_stage1_bwd_plain_matches_autograd(shape):
    """The backward's plain version (routing by codes, f32 conv gradients),
    which the card holds the kernel against, equals autograd through the
    plain forward at the narrow widths."""
    rng = np.random.default_rng(2)
    n, h, w, c = shape
    z1, k2, b2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in (shape, (c, c, 3, 3), (c,)))
    g = torch.from_numpy(rng.normal(size=(n, h // 2, w // 2, c)).astype(np.float32))
    out, codes = stage1_tail_codes_plain(z1, k2, b2)
    torch.testing.assert_close(out, stage1_tail_plain(z1, k2, b2), rtol=0, atol=0)
    leaves = [t.clone().requires_grad_() for t in (z1, k2, b2)]
    want = torch.autograd.grad(stage1_tail_plain(*leaves), leaves, g)
    for got, ref in zip(stage1_tail_bwd_plain(g, out, codes, z1, k2), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 6, 8, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, (2, 6, 8)).astype(np.int32)
    valid = rng.random((2, 6, 8)) > 0.3
    weights = np.array([0.5, 1.0, 2.0], np.float32)
    onehot = jax.nn.one_hot(labels, 3, dtype=jnp.float32)
    tl, tlab, tval = map(torch.from_numpy, (logits, labels, valid))
    for port_fn, jax_fn in ((loss.softmax_cross_entropy_sum,
                             jax_loss.softmax_cross_entropy_sum),
                            (loss.focal_loss_sum, jax_loss.focal_loss_sum)):
        for v, w in ((None, None), (valid, weights)):
            got = port_fn(tl, tlab, None if v is None else tval,
                          None if w is None else torch.from_numpy(w))
            want = jax_fn(jnp.asarray(logits), onehot, v, w)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)
    np.testing.assert_array_equal(
        loss.median_frequency_weights([10, 30, 0, 5]).numpy(),
        np.asarray(jax_loss.median_frequency_weights([10, 30, 0, 5])))

    preds = logits.argmax(-1)
    cm = metrics.confusion_matrix(tlab, torch.from_numpy(preds), 3, tval)
    jcm = jax_metrics.confusion_matrix(jnp.asarray(labels), jnp.asarray(preds), 3,
                                       jnp.asarray(valid))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    sm = metrics.SegMetrics(3)
    jm = jax_metrics.SegMetrics.zero(3)
    for s in range(2):
        sm.update(cm, torch.tensor(0.5 + s))
        jm = jm.update(jcm, jnp.float32(0.5 + s))
    got, want = sm.summary(), jm.summary()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.01),
                                     ("adamw", 0.01), ("sgd", 0.0)])
def test_optimizers_and_ema_match_optax(name, wd):
    """make_optimizer (with a poly schedule over 4 steps, warmup 1) and the
    EMA update against optax and the JAX TrainState on a small tree: three
    updates from fixed gradients. f32 on both sides: rtol 1e-5."""
    rng = np.random.default_rng(4)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = jax_optimizer(name, 1e-2, wd, schedule="poly", total_steps=4,
                       warmup_steps=1)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree.map(jnp.asarray, params),
                       opt_state=None, batch_stats={}, rng=jax.random.key(0),
                       apply_fn=None, tx=tx,
                       ema_params=jax.tree.map(jnp.asarray, params), ema_decay=0.9)
    js = js.replace(opt_state=tx.init(js.params))

    class Tree(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params.items():
                self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    model = Tree()
    state = create_train_state(
        model, make_optimizer(name, model.parameters(), 1e-2, wd),
        make_lr_schedule(1e-2, "poly", 4, 1), seed=0, ema_decay=0.9)
    for g in grads:
        js = js.apply_gradients(jax.tree.map(jnp.asarray, g))
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        state.apply_gradients()
    assert state.step == int(js.step) == 3
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(js.params[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(state.ema_params[k].numpy(),
                                   np.asarray(js.ema_params[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("schedule,warmup", [("constant", 0), ("constant", 3),
                                             ("poly", 0), ("poly", 2),
                                             ("cosine", 2)])
def test_lr_schedule_matches_jax(schedule, warmup):
    """At every step through the end and past it; poly's last step (the
    run's last, ``total``) is exactly the end value (0), never NaN. The JAX
    schedules run in f32: within 1e-6 of the peak rate."""
    total = 10
    want = jax_schedule(0.1, schedule, total, warmup)
    got = make_lr_schedule(0.1, schedule, total, warmup)
    for s in range(total + 3):
        w = want if isinstance(want, float) else float(jax.jit(want)(s))
        assert got(s) == pytest.approx(w, rel=1e-6, abs=1e-7), s
    if schedule == "poly":
        assert got(total) == 0.0


def _step_batch(seed, n=4, hw=(32, 64)):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, *hw, 3)).astype(np.float32),
            "label": rng.integers(0, 2, (n, *hw)).astype(np.int32),
            "valid": rng.random((n, *hw)) > 0.25}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    """Two Adam steps (lr 1e-3, dropout 0, f32) from the same weights on the
    same batches: the loss, the confusion matrix (exact) and every parameter
    after each update. The port's grad_accum=2 step also equals its
    full-batch step. Bound: f32 gradients in another summation order move
    Adam's first updates (~lr * sign) by far less than 1 % of lr."""
    jm = jax_fcn("fcn8s", dropout_rate=0.0)
    variables = jax_init(jm, hw=(32, 64))
    tx = jax_optimizer("adam", 1e-3)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       opt_state=tx.init(variables["params"]), batch_stats={},
                       rng=jax.random.key(0), apply_fn=jm.apply, tx=tx)
    jstep = jax_train_step(2, grad_accum=grad_accum)

    def port_state():
        model = port_fcn("fcn8s", variables, dropout_rate=0.0).train()
        return create_train_state(
            model, make_optimizer("adam", model.parameters(), 1e-3),
            make_lr_schedule(1e-3), seed=0)

    state, full = port_state(), port_state()
    pstep = make_train_step(2, grad_accum=grad_accum)
    for seed in (0, 1):
        batch = _step_batch(seed)
        js, jout = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        out = pstep(state, tb)
        np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(out["cm"].numpy(), np.asarray(jout["cm"]))
        got = convert.from_state_dict(state.model.state_dict(), state.model)
        want = convert.flatten_params(js.params)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-6, err_msg=k)
        if grad_accum > 1:
            make_train_step(2)(full, tb)
            for a, b in zip(full.model.parameters(), state.model.parameters()):
                torch.testing.assert_close(a, b, rtol=0, atol=2e-6)


def _uint8_batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.integers(0, 256, (n, 40, 72, 3), np.uint8)),
            "label": torch.from_numpy(rng.integers(0, 2, (n, 40, 72)).astype(np.int32)),
            "valid": torch.from_numpy(rng.random((n, 40, 72)) > 0.1)}


def test_checkpoint_resume_continues_bit_for_bit(tmp_path):
    """Dropout 0.5, random crops and EMA: three steps in one run equal one
    step, a save, a restore into a freshly built state and two more steps,
    bit for bit (parameters, EMA, optimizer step, losses)."""
    aug = make_augment_fn((123.68, 116.779, 103.939), (58.393, 57.12, 57.375),
                          crop_size=(32, 64))
    step_fn = make_train_step(2, augment_fn=aug)

    def fresh(seed):
        model = port_fcn("fcn8s").train()
        init_params(model, torch.Generator().manual_seed(seed))
        return create_train_state(
            model, make_optimizer("adam", model.parameters(), 1e-3),
            make_lr_schedule(1e-3), seed=0, ema_decay=0.9)

    batches = [_uint8_batch(s) for s in range(3)]
    a = fresh(0)
    losses_a = [step_fn(a, b)["loss"].item() for b in batches]
    b = fresh(0)
    step_fn(b, batches[0])
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    mgr.save(b)
    c = mgr.restore(fresh(1))
    assert c.step == 1 and mgr.latest_step() == 1
    losses_c = [step_fn(c, bt)["loss"].item() for bt in batches[1:]]
    assert losses_c == losses_a[1:]
    for (k, p), q in zip(a.model.named_parameters(), c.model.parameters()):
        assert torch.equal(p, q), k
        assert torch.equal(a.ema_params[k], c.ema_params[k]), k
    mgr.save(c)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt"]  # max_to_keep
    plain = fresh(0)
    plain.ema_params = {}
    CheckpointManager(str(tmp_path / "no_ema")).save(plain)
    with pytest.raises(ValueError, match="EMA"):
        CheckpointManager(str(tmp_path / "no_ema")).restore(fresh(0))


def test_train_cli_then_infer_image_from_its_checkpoint(tmp_path, capsys):
    """The train CLI takes one step on synthetic data (augment through the
    preprocess path, EMA tracked) and checkpoints; infer_image and serve's
    model loader read that checkpoint (raw and --ema), and the overlay
    equals a Predictor on the same weights."""
    from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image, train

    ck = tmp_path / "ck"
    rc = train.main(["--synthetic", "--epochs", "1", "--device", "cpu",
                     "--model-kw", KW, "--image-size", "64", "96",
                     "--batch-size", "8", "--ema-decay", "0.9",
                     "--pallas-preprocess", "--checkpoint-dir", str(ck)])
    assert rc == 0 and "final:" in capsys.readouterr().out
    assert sorted(os.listdir(ck)) == ["ckpt_1.pt", "logs"]
    src = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (45, 70, 3), np.uint8)).save(src)
    for ema in (False, True):
        out = tmp_path / f"out{ema}.png"
        assert infer_image.main(["--model-kw", KW, "--checkpoint-dir", str(ck),
                                 "--device", "cpu", "--image", str(src),
                                 "--out", str(out)] + (["--ema"] if ema else [])) == 0
        model = build_model("fcn8s", 2, device="cpu", fc_features=32,
                            width_mult=0.25)
        model.load_state_dict(load_weights(str(ck), use_ema=ema))
        want, _ = Predictor(model, (375, 1242), device="cpu").predict_file(str(src))
        np.testing.assert_array_equal(np.asarray(Image.open(out)), want)
    raw, ema_w = load_weights(str(ck)), load_weights(str(ck), use_ema=True)
    assert not torch.equal(raw["vgg16.conv6.weight"], ema_w["vgg16.conv6.weight"])


@pytest.mark.parametrize("argv,err,out", [
    (["--shard-opt"], NotImplementedError, ""),
    (["--qat"], NotImplementedError, ""),
    (["--qat-calib-batches", "8"], NotImplementedError, ""),
    (["--synthetic", "--device", "cuda"], RuntimeError, ""),
    (["--data-dir", "/nonexistent", "--device", "cpu"], FileNotFoundError, ""),
    # BatchNorm (use_bn) builds and reaches the data
    (["--model-kw", "use_bn=true", "--data-dir", "/nonexistent", "--device", "cpu"],
     FileNotFoundError, ""),
    # the JAX defaults of the unported flags parse and do not raise
    (["--val-every", "1", "--qat-calib-batches", "4", "--data-dir",
      "/nonexistent", "--device", "cpu"], FileNotFoundError, ""),
    # the JAX CLI's rules for the validated-training flags
    (["--keep-best", "--device", "cpu"], SystemExit, ""),
    (["--val-frac", "1.0", "--synthetic", "--image-size", "64", "96",
      "--device", "cpu"], SystemExit, ""),
    (["--color-jitter", "0.2,0.2", "--device", "cpu"], ValueError, ""),
    (["--scale-jitter", "0.75,1.0", "--spatial", "2", "--data-dir",
      "/nonexistent", "--device", "cpu"], FileNotFoundError,
     "note: --scale-jitter needs"),
])
def test_train_cli_guards(argv, err, out, monkeypatch, capsys, tmp_path):
    """--device cuda raises without a card (never drops to the CPU); a bad
    --data-dir fails fast; --keep-best without --val-frac and a --val-frac that leaves no
    training image are usage errors; a malformed --color-jitter raises;
    --scale-jitter under --spatial is ignored with the JAX CLI's note.
    --qat and --qat-calib-batches raised so until quantization-aware
    training was ported: --qat now trains 2 steps (narrow FCN-32s,
    synthetic data) after calibrating on the default 4 (here both) batches,
    and with --qat-calib-batches 8 too, and writes qat_scales.json.
    --shard-opt raised so until ZeRO-1 was ported: on one rank it is now
    ignored silently, as the JAX CLI does without a mesh, and the run goes
    on to the data (the gloo ranks' runs are scenarios of
    tests/test_torch_spatial.py)."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if argv[0].startswith("--qat"):
        ck = tmp_path / "ck"
        assert train.main(["--qat", *(a for a in argv if a != "--qat"),
                           "--synthetic", "--device", "cpu",
                           "--image-size", "64", "96", "--epochs", "1",
                           "--batch-size", "4", "--model", "fcn32s", "--model-kw",
                           "fc_features=32,width_mult=0.25",
                           "--checkpoint-dir", str(ck)]) == 0
        assert (ck / "qat_scales.json").exists() and (ck / "ckpt_2.pt").exists()
        assert f"QAT: calibrated 17 activation scales -> {ck}/qat_scales.json" in \
            capsys.readouterr().out.splitlines()
        return
    if argv[0] == "--shard-opt":
        with pytest.raises(FileNotFoundError):
            train.main(argv + ["--data-dir", "/nonexistent", "--device", "cpu"])
        assert "ZeRO-1" not in capsys.readouterr().out
        return
    with pytest.raises(err, match=argv[0] if err is NotImplementedError
                       else "color_jitter" if err is ValueError else None):
        train.main(argv)
    assert out in capsys.readouterr().out


def test_serving_checkpoint_dir_guards(tmp_path):
    from semanticsegmentation_tensorflow_tpu_torch.scripts import infer_image

    base = ["--device", "cpu", "--image", "x.png", "--model-kw", KW]
    with pytest.raises(FileNotFoundError):
        infer_image.main(base + ["--checkpoint-dir", str(tmp_path)])
    (tmp_path / "7").mkdir()                       # an orbax step directory
    with pytest.raises(NotImplementedError, match="convert_checkpoint_to_torch"):
        infer_image.main(base + ["--checkpoint-dir", str(tmp_path)])
    with pytest.raises(ValueError):
        infer_image.main(base + ["--ema"])
