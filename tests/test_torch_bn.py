"""BatchNorm (``use_bn``) in the port against the JAX package on the CPU, in
float32 at narrow widths (the same weights and running statistics carried
across by the port's weight bridge; inputs from numpy seeds):

* flax's ``nn.BatchNorm`` itself on NHWC input in both modes, with its
  running-statistics update;
* the model of each of the five presets with ``use_bn=True`` (FCN-8s,
  SegNet, DeepLab at output stride 8 and 16, U-Net): the forward in train
  and eval mode and two SGD steps of the train step (loss, confusion matrix,
  parameters, running statistics);
* ``grad_accum=2`` (each microbatch normalizes by its own statistics and
  updates the running ones in turn) with ``remat``, whose recompute leaves
  the statistics alone;
* the port's checkpoint (the statistics saved and restored; the EMA over
  the parameters only) and the weight bridge and
  ``tools/convert_checkpoint_to_torch.py`` with ``batch_stats``.

Tolerances (f32 on both sides, another summation order; BatchNorm divides
by a batch's standard deviation, which a narrow model's few pixels make
small): logits within 1e-4 of their scale, losses
within rtol 2e-5, the parameters after two steps within rtol 1e-3 / atol
1e-5 and the running statistics within rtol 1e-4 / atol 1e-6.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from semanticsegmentation_tensorflow_tpu.train.state import (
    TrainState as JaxTrainState, make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu.train.step import (
    make_train_step as jax_train_step,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    BatchNorm, init_params,
)
from semanticsegmentation_tensorflow_tpu_torch.models.registry import build_model
from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
    CheckpointManager, load_weights,
)
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import convert_checkpoint_to_torch  # noqa: E402
from torch_parity import draw_bn_state  # noqa: E402

LR = 1e-3
HW = (32, 32)
MODELS = {
    "fcn8s": dict(fc_features=16, width_mult=0.125, dropout_rate=0.0),
    "segnet": dict(width_mult=0.125),
    "deeplab": dict(width_mult=0.125, aspp_features=8, rates=(2,),
                    dropout_rate=0.0),
    "deeplab_os16": dict(width_mult=0.125, aspp_features=8, rates=(2,),
                         dropout_rate=0.0, output_stride=16),
    "unet": dict(base_features=8, depth=2),
}


def _batch(seed, n=2, hw=HW):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, *hw, 3)).astype(np.float32),
            "label": rng.integers(0, 2, (n, *hw)).astype(np.int32),
            "valid": rng.random((n, *hw)) > 0.25}


def _port_model(name, seed=0, **kw):
    """The port's BN model with seeded weights, and its BatchNorm
    parameters and statistics drawn away from their init (so that eval
    mode is no identity)."""
    model = build_model(name.split("_")[0], 2, device="cpu", dtype=torch.float32,
                        use_bn=True, **dict(MODELS[name], **kw))
    init_params(model, torch.Generator().manual_seed(seed))
    return draw_bn_state(model, seed + 100, params=True)


def _jax_model(name):
    return jax_build(name.split("_")[0], num_classes=2, dtype=jnp.float32,
                     use_bn=True, **MODELS[name])


def _jax_state(jm, variables, tx):
    # jitted: the eager optimizer init runs op by op and takes seconds; the
    # key is the JAX package's (rbg, ``train/state.py:create_train_state``)
    # so that its checkpoint restores into that package's template
    return jax.jit(lambda v: JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        opt_state=tx.init(v["params"]), batch_stats=v["batch_stats"],
        rng=jax.random.key(jnp.uint32(0), impl="rbg"), apply_fn=jm.apply,
        tx=tx))(variables)


def _port_state(model):
    model.train()
    return create_train_state(model, make_optimizer("sgd", model.parameters(), LR),
                              make_lr_schedule(LR), seed=0)


def _close_tree(got_sd, model, want_flat, prt, pat, leaves):
    got = convert.from_state_dict(got_sd, model)
    keys = [k for k in want_flat if k.rsplit("/", 1)[-1] in leaves]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want_flat[k]), rtol=prt,
                                   atol=pat, err_msg=k)


def test_batchnorm_matches_flax_in_both_modes():
    """The module alone on [4,5,6,8] bf16 and f32 input: train mode (the
    output, the updated running statistics with the biased variance) and
    eval mode against ``flax.linen.BatchNorm`` with the same scale, bias and
    statistics; its tensors stay f32 when the module is cast to bf16."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 5, 6, 8)) * 3 + 1).astype(np.float32)
    scale, var = (rng.uniform(lo, hi, 8).astype(np.float32) for lo, hi in ((0.5, 1.5), (0.5, 2)))
    bias, mean = (rng.normal(size=8).astype(np.float32) for _ in range(2))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        bn = BatchNorm(8, dtype=tdt).to(tdt)
        assert all(t.dtype == torch.float32 for t in (bn.scale, bn.bias, bn.mean, bn.var))
        with torch.no_grad():
            for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean), (bn.var, var)):
                t.copy_(torch.from_numpy(v))
        variables = {"params": {"scale": scale, "bias": bias},
                     "batch_stats": {"mean": mean, "var": var}}
        xj = jnp.asarray(x, jdt)
        fm = fnn.BatchNorm(use_running_average=False, dtype=jdt)
        want, mut = fm.apply(variables, xj, mutable=["batch_stats"])
        got = bn.train()(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        tol = 1e-5 if tdt == torch.float32 else 1e-2
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=tol * float(np.abs(want).max()))
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       np.asarray(mut["batch_stats"][k]),
                                       rtol=1e-5, atol=1e-6)
        variables["batch_stats"] = mut["batch_stats"]
        want = fnn.BatchNorm(use_running_average=True, dtype=jdt).apply(variables, xj)
        with torch.no_grad():
            got = bn.eval()(torch.from_numpy(x).to(tdt))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(MODELS))
def test_bn_model_forward_and_train_steps_match_jax(name):
    """The model with ``use_bn=True`` on the same weights and statistics:
    the train-mode forward (logits and the updated statistics) and the
    eval-mode forward against ``model.apply``; then two SGD steps of the
    train step against the JAX step (each loss, the last confusion matrix,
    the parameters and the running statistics after both). The BN blocks
    take the direct conv and no fused stage1 (the JAX package's BN
    forms)."""
    port = _port_model(name)
    assert not any(type(m).__name__ in ("Stage1", "SegNetStage1")
                   for m in port.modules())
    variables = convert.to_variables(convert.from_state_dict(port.state_dict(), port))
    jm = _jax_model(name)
    tx = jax_optimizer("sgd", LR)
    js = _jax_state(jm, variables, tx)
    b = _batch(1)
    x = b["image"]
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    @jax.jit
    def forward(v, x):          # train mode (logits, new stats), eval mode
        return (jm.apply(v, x, train=True, mutable=["batch_stats"]),
                jm.apply(v, x, train=False))

    (train_logits, stats1), eval_logits = forward(variables, jb["image"])
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(train_logits), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(train_logits)).max()))
    _close_tree(port.state_dict(), port, convert.flatten_params(
        {"params": variables["params"], **stats1}), 1e-4, 1e-6, ("mean", "var"))
    port.load_state_dict(convert.to_state_dict(convert.flatten_params(variables), port))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(eval_logits), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(eval_logits)).max()))

    jstep = jax_train_step(2)
    outs = []
    for _ in range(2):
        js, out = jstep(js, jb)
        outs.append(out)
    state = _port_state(port)
    step = make_train_step(2)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    losses = [step(state, tb) for _ in range(2)]
    for o, jo in zip(losses, outs):
        np.testing.assert_allclose(o["loss"].item(), float(jo["loss"]), rtol=2e-5)
    np.testing.assert_array_equal(losses[-1]["cm"].numpy(), np.asarray(outs[-1]["cm"]))
    flat = convert.flatten_params({"params": js.params,
                                   "batch_stats": js.batch_stats})
    _close_tree(port.state_dict(), port, flat, 1e-3, 1e-5, ("kernel", "bias", "scale"))
    _close_tree(port.state_dict(), port, flat, 1e-4, 1e-6, ("mean", "var"))


def test_grad_accum_with_bn_matches_jax_and_remat_updates_once():
    """``grad_accum=2`` on a BN U-Net: microbatch 2 normalizes by its own
    statistics after microbatch 1 updated the running ones, as the JAX
    step's scan carries them; one step against the JAX step with
    ``grad_accum=2`` (loss, parameters, statistics). The port runs it with
    ``remat``: the recompute in the backward leaves the statistics as the
    forward set them (equal to the step without remat)."""
    port = _port_model("unet", seed=3)
    variables = convert.to_variables(convert.from_state_dict(port.state_dict(), port))
    jm = _jax_model("unet")
    tx = jax_optimizer("sgd", LR)
    b = _batch(4, n=4)
    js, out = jax_train_step(2, grad_accum=2)(
        _jax_state(jm, variables, tx), {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    stats = {}
    for remat in (True, False):
        port.load_state_dict(convert.to_state_dict(convert.flatten_params(variables),
                                                   port))
        o = make_train_step(2, grad_accum=2, remat=remat)(_port_state(port), tb)
        np.testing.assert_allclose(o["loss"].item(), float(out["loss"]), rtol=2e-5)
        want = convert.flatten_params({"params": js.params,
                                       "batch_stats": js.batch_stats})
        _close_tree(port.state_dict(), port, want, 1e-3, 1e-5, ("kernel", "bias", "scale"))
        _close_tree(port.state_dict(), port, want, 1e-4, 1e-6, ("mean", "var"))
        stats[remat] = {k: v.clone() for k, v in port.state_dict().items()
                        if k.endswith((".mean", ".var"))}
    for k, v in stats[True].items():
        torch.testing.assert_close(v, stats[False][k], rtol=0, atol=1e-7)


def test_checkpoint_keeps_stats_and_ema_covers_params_only(tmp_path):
    """A train state of a BN SegNet with EMA: the checkpoint holds the
    running statistics and restores them bit for bit; the EMA tracks the
    parameters (BN scale and bias among them) and not the statistics, and
    ``load_weights(use_ema=True)`` serves the EMA parameters beside the live
    statistics."""
    model = _port_model("segnet")
    state = create_train_state(model.train(), make_optimizer(
        "adam", model.parameters(), 1e-3), make_lr_schedule(1e-3), seed=0,
        ema_decay=0.9)
    assert "enc1.bn0.scale" in state.ema_params
    assert not any(k.endswith((".mean", ".var")) for k in state.ema_params)
    make_train_step(2)(state, {k: torch.from_numpy(v) for k, v in _batch(2).items()})
    CheckpointManager(str(tmp_path)).save(state)
    live = {k: v.clone() for k, v in model.state_dict().items()}
    other = _port_model("segnet", seed=9)
    st2 = create_train_state(other.train(), make_optimizer(
        "adam", other.parameters(), 1e-3), make_lr_schedule(1e-3), seed=1,
        ema_decay=0.9)
    CheckpointManager(str(tmp_path)).restore(st2)
    for k, v in live.items():
        assert torch.equal(other.state_dict()[k], v), k
    ema = load_weights(str(tmp_path), use_ema=True)
    for k in live:
        if k.endswith((".mean", ".var")):
            assert torch.equal(ema[k], live[k]), k
    assert not torch.equal(ema["enc1.bn0.scale"], live["enc1.bn0.scale"])
    assert torch.equal(ema["enc1.bn0.scale"], state.ema_params["enc1.bn0.scale"])


def test_bridge_and_converter_carry_batch_stats(tmp_path):
    """flax ``{"params", "batch_stats"}`` -> the port's state_dict (scale
    and bias parameters, mean and var buffers) -> back, bit-equal and
    strict (a missing ``batch_stats`` leaves buffers unfilled and raises);
    and an orbax checkpoint of a JAX BN SegNet state converts through
    ``tools/convert_checkpoint_to_torch.py`` to that state_dict."""
    port = _port_model("deeplab")
    flat = convert.from_state_dict(port.state_dict(), port)
    variables = convert.to_variables(flat)
    assert "aspp/b_image_bn/mean" in convert.flatten_params(variables)
    assert set(variables["batch_stats"]["aspp"]) == {
        "b0_bn", "b_rate2_bn", "b_image_bn", "project_bn"}
    back = convert.to_state_dict(convert.flatten_params(variables), port)
    assert set(back) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
    with pytest.raises(KeyError, match="mean"):
        convert.to_state_dict(convert.flatten_params(
            {"params": variables["params"]}), port)

    port = _port_model("segnet", seed=5)
    variables = convert.to_variables(convert.from_state_dict(port.state_dict(), port))
    js = _jax_state(_jax_model("segnet"), variables, jax_optimizer("adam", 1e-4))
    mgr = JaxCheckpointManager(str(tmp_path / "ck"))
    mgr.save(js, wait=True)
    mgr.close()
    out = tmp_path / "w.pt"
    assert convert_checkpoint_to_torch.main(
        ["--preset", "segnet_kitti", "--model-kw", "width_mult=0.125,use_bn=True",
         "--checkpoint-dir", str(tmp_path / "ck"), "--out", str(out)]) == 0
    got = torch.load(out, weights_only=True)
    assert set(got) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(got[k], v), k


def test_use_bn_through_the_clis(tmp_path, capsys):
    """``--model-kw use_bn=true`` through every entry point on the CPU
    (narrow SegNet): train.py writes a checkpoint whose running statistics
    moved; eval.py (with --tta), test.py and infer_image run on it; the
    server's Predictor holds the checkpoint's statistics."""
    from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
        generate_synthetic_kitti,
    )
    from semanticsegmentation_tensorflow_tpu_torch.scripts import (
        eval as eval_cli, infer_image, serve, test as test_cli, train,
    )

    data = generate_synthetic_kitti(str(tmp_path / "data"), n_train=4, n_test=1,
                                    h=64, w=96, seed=3)
    kw = ["--preset", "segnet_kitti", "--model-kw", "width_mult=0.125,use_bn=true",
          "--device", "cpu"]
    ck = str(tmp_path / "ck")
    assert train.main(kw + ["--data-dir", data, "--epochs", "1", "--batch-size", "2",
                            "--image-size", "64", "96", "--checkpoint-dir", ck]) == 0
    stats = load_weights(ck)
    assert not torch.equal(stats["enc1.bn0.mean"], torch.zeros_like(stats["enc1.bn0.mean"]))
    assert eval_cli.main(kw + ["--data-dir", data, "--checkpoint-dir", ck,
                               "--batch-size", "2", "--tta"]) == 0
    assert "TTA eval: scales=[1.0] flip=True" in capsys.readouterr().out
    assert test_cli.main(kw + ["--data-dir", data, "--checkpoint-dir", ck,
                               "--runs-dir", str(tmp_path / "runs")]) == 0
    img = sorted((tmp_path / "data" / "testing" / "image_2").iterdir())[0]
    assert infer_image.main(kw + ["--checkpoint-dir", ck, "--image", str(img),
                                  "--out", str(tmp_path / "o.png")]) == 0
    server, _ = serve.make_server(kw + ["--checkpoint-dir", ck, "--port", "0",
                                        "--no-warmup"])
    try:
        bn = server.predictor.model.enc1.bn0
        assert bn.mean.dtype == torch.float32
        assert torch.equal(bn.mean, stats["enc1.bn0.mean"])
    finally:
        server.server_close()
