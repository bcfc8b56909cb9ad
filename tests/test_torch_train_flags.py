"""The port's validated-training features against the JAX package on the
CPU: the validation split and the loader's decode workers, scale and color
jitter with the JAX draws injected, the VGG16 ``.npz`` import, the
low-precision first moment (``mu_dtype``) and ``remat``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.data import KittiRoadDataset as JaxKitti
from semanticsegmentation_tensorflow_tpu.data.augment import (
    _color_jitter_one, _scale_jitter_batch, make_augment_fn as jax_make_augment_fn,
)
from semanticsegmentation_tensorflow_tpu.data.pipeline import (
    subset_dataset as jax_subset,
)
from semanticsegmentation_tensorflow_tpu.models.vgg16 import (
    load_npz_weights as jax_load_npz,
)
from semanticsegmentation_tensorflow_tpu.train.state import (
    make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
from semanticsegmentation_tensorflow_tpu_torch.data.augment import (
    color_jitter, make_augment_fn, sample_augment_params, scale_jitter,
)
from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import (
    BatchLoader, subset_dataset,
)
from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
    generate_synthetic_kitti,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import init_params
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import load_npz_weights
from semanticsegmentation_tensorflow_tpu_torch.train import step as step_mod
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    MomentDtypeOptimizer, create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import make_train_step

from torch_parity import jax_fcn, jax_init, port_fcn

MEAN, STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    return generate_synthetic_kitti(str(tmp_path_factory.mktemp("k")), n_train=10,
                                    n_test=1, h=40, w=72, seed=4)


@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_val_split_names_match_jax(kitti_dir, frac):
    """The train CLI's split (the last round(n * frac) images, at least one)
    through subset_dataset holds out the images JAX's holds out."""
    ds = build_dataset("kitti_road", kitti_dir, (40, 72))
    jds = JaxKitti(kitti_dir, image_size=(40, 72))
    paths = list(ds.train_images)
    assert paths == list(jds.train_images)
    k = max(1, int(round(len(paths) * frac)))
    val, tr = subset_dataset(ds, paths[-k:]), subset_dataset(ds, paths[:-k])
    jval, jtr = (jax_subset(jds, list(jds.train_images)[-k:]),
                 jax_subset(jds, list(jds.train_images)[:-k]))
    assert val.train_images == jval.train_images
    assert tr.train_images == jtr.train_images
    assert not set(val.train_images) & set(tr.train_images)
    for a, b in zip(val.load_example(val.train_images[0]),
                    jval.load_example(jval.train_images[0])):
        np.testing.assert_array_equal(a, b)
    assert val.image_size == ds.image_size      # everything else delegates


def test_loader_workers_batches_equal_inline(kitti_dir):
    """A decode pool of 2 threads gives the batches of workers=0, bit for
    bit and in order, over two epochs with a wrap-padded last batch."""
    ds = build_dataset("kitti_road", kitti_dir, (40, 72))
    a = BatchLoader(ds, 4, seed=3, device="cpu", drop_remainder=False)
    b = BatchLoader(ds, 4, seed=3, device="cpu", drop_remainder=False, workers=2)
    for _ in range(2):
        ea, eb = list(a.epoch()), list(b.epoch())
        assert len(ea) == len(eb) == 3
        for x, y in zip(ea, eb):
            for k in x:
                assert torch.equal(x[k], y[k]), k
    assert b._pool is not None and b._pool._max_workers == 2


def _u8_batch(n=3, h=30, w=45, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (n, h, w, 3), np.uint8),
            "label": rng.integers(0, 2, (n, h, w)).astype(np.int32),
            "valid": rng.random((n, h, w)) > 0.2}


def _jax_scale_draw(key, scale, h, w):
    """The offsets _scale_jitter_batch draws under ``key`` for ``scale``."""
    _, k_y, k_x = jax.random.split(key, 3)
    hs, ws = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    if (hs, ws) == (h, w):
        return 0, 0
    oy = int(jax.random.randint(k_y, (), 0, abs(hs - h) + 1))
    ox = int(jax.random.randint(k_x, (), 0, abs(ws - w) + 1))
    return oy, ox


def _assert_images_close(got, want, what=""):
    """uint8 images within 1 count (another f32 summation order can round a
    .5 the other way); every other value equal."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, what
    assert (d > 0).mean() < 0.01, what


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.0, 1.25, 1.5])
def test_scale_jitter_matches_jax(scale):
    """Each branch of _scale_jitter_batch (zoom out: antialiased bilinear
    down, placed on a zero canvas with valid=0 outside; identity; zoom in:
    bilinear up then a window) with the JAX offsets injected: labels and
    valid bit-equal, images within 1 count."""
    batch = _u8_batch()
    key = jax.random.key(11)
    wi, wl, wv = _scale_jitter_batch(key, *(jnp.asarray(batch[k]) for k in
                                            ("image", "label", "valid")), (scale,))
    oy, ox = _jax_scale_draw(key, scale, 30, 45)
    gi, gl, gv = scale_jitter(*(torch.from_numpy(batch[k]) for k in
                                ("image", "label", "valid")), scale, oy, ox)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi.dtype == torch.uint8 and gi.shape == batch["image"].shape
    _assert_images_close(gi.numpy(), np.asarray(wi))


def _jax_color_draw(key, bcs):
    """(brightness, contrast, saturation) _color_jitter_one draws under
    ``key``."""
    b, c, s = bcs
    kb, kc, ks = jax.random.split(key, 3)
    return (float(jax.random.uniform(kb, (), minval=-b, maxval=b)),
            float(jax.random.uniform(kc, (), minval=1.0 - c, maxval=1.0 + c)),
            float(jax.random.uniform(ks, (), minval=1.0 - s, maxval=1.0 + s)))


@pytest.mark.parametrize("bcs", [(0.2, 0.2, 0.2), (0.4, 0.0, 0.0),
                                 (0.0, 0.5, 0.0), (0.0, 0.0, 0.6)])
def test_color_jitter_matches_jax(bcs):
    """Per-example brightness, contrast and saturation with the JAX factors
    injected: images within 1 count, rounded half-even back to uint8."""
    batch = _u8_batch(seed=1)
    keys = jax.random.split(jax.random.key(5), 3)
    want = np.stack([np.asarray(_color_jitter_one(k, jnp.asarray(im), bcs))
                     for k, im in zip(keys, batch["image"])])
    draws = np.array([_jax_color_draw(k, bcs) for k in keys], np.float32)
    got = color_jitter(torch.from_numpy(batch["image"]),
                       *(torch.from_numpy(draws[:, i]) for i in range(3)), bcs)
    assert got.dtype == torch.uint8
    _assert_images_close(got.numpy(), want)


def _jax_augment_draws(key, batch, scales, bcs, crop):
    """Every draw of make_augment_fn's augment under ``key``, in its split
    order: the scale jitter's key off the top, then one key per example
    (its color key off the top, then flip, oy, ox)."""
    n, h, w = batch["label"].shape
    k_jit, rng = jax.random.split(key)
    idx = int(jax.random.randint(jax.random.split(k_jit, 3)[0], (), 0, len(scales)))
    scale = (scales[idx], *_jax_scale_draw(k_jit, scales[idx], h, w))
    color, flip, oy, ox = [], [], [], []
    for k in jax.random.split(rng, n):
        k, k_col = jax.random.split(k)
        color.append(_jax_color_draw(k_col, bcs))
        k_flip, k_y, k_x = jax.random.split(k, 3)
        flip.append(bool(jax.random.bernoulli(k_flip)))
        oy.append(int(jax.random.randint(k_y, (), 0, h - crop[0] + 1)))
        ox.append(int(jax.random.randint(k_x, (), 0, w - crop[1] + 1)))
    color = tuple(torch.tensor(c, dtype=torch.float32) for c in zip(*color))
    return (torch.tensor(flip), torch.tensor(oy), torch.tensor(ox), scale, color)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jittered_augment_matches_jax(seed):
    """make_augment_fn with both jitters, crop and flip against JAX's under
    one key, its draws injected into Augment.apply: labels and valid
    bit-equal. The normalized image within 2 counts / std, at under 0.1 %
    of its values: the scale jitter's 1-count differences pass through the
    contrast and saturation factors (up to 1.2 each) and the rounding
    before the normalize."""
    batch = _u8_batch(n=4, h=32, w=48, seed=seed)
    scales, bcs, crop = (0.75, 1.0, 1.25), (0.2, 0.2, 0.2), (24, 40)
    key = jax.random.key(seed)
    want = jax_make_augment_fn(MEAN, STD, crop, True, scales, bcs)(
        key, {k: jnp.asarray(v) for k, v in batch.items()})
    aug = make_augment_fn(MEAN, STD, crop, True, scales, bcs)
    got = aug.apply({k: torch.from_numpy(v) for k, v in batch.items()},
                    *_jax_augment_draws(key, batch, scales, bcs, crop))
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    d = np.abs(got["image"].numpy() - np.asarray(want["image"])) * np.array(STD)
    assert d.max() <= 2 + 1e-4 and (d > 0.5).mean() < 1e-3


def test_jitter_draws_and_the_stream_without_them():
    """With both jitters off, an augment call draws exactly what
    sample_augment_params draws (the generator's stream is unchanged, which
    checkpoint resume relies on); with them on it draws more, from the same
    generator, and two runs from one seed agree bit for bit."""
    tb = {k: torch.from_numpy(v) for k, v in _u8_batch(n=4, h=32, w=48).items()}
    g, ref = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    make_augment_fn(MEAN, STD, (24, 40))(g, tb)
    make_augment_fn(MEAN, STD, (24, 40), color_jitter=(0, 0, 0))(g, tb)
    for _ in range(2):
        sample_augment_params(ref, 4, 32, 48, (24, 40))
    assert torch.equal(g.get_state(), ref.get_state())
    jit = make_augment_fn(MEAN, STD, (24, 40), scale_jitter=(0.75, 1.25),
                          color_jitter=(0.2, 0.2, 0.2))
    a = jit(torch.Generator().manual_seed(3), tb)
    g2 = torch.Generator().manual_seed(3)
    b = jit(g2, tb)
    assert not torch.equal(g2.get_state(), ref.get_state())
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="color_jitter"):
        make_augment_fn(MEAN, STD, color_jitter=(0.2, 0.2))
    with pytest.raises(ValueError, match="color_jitter"):
        make_augment_fn(MEAN, STD, color_jitter=(0.2, -0.1, 0.2))


def _archive(path, flat, rename=None, drop=(), extra=None, fc6=None):
    """An .npz of the VGG16 leaves of ``flat`` (flax paths, HWIO), random
    from a seed; half the keys relative to the model (vgg16/...), half to
    the backbone."""
    rng = np.random.default_rng(6)
    blob = {}
    for i, (k, v) in enumerate(sorted(flat.items())):
        if not k.startswith("vgg16/") or k in drop:
            continue
        a = rng.normal(size=v.shape).astype(np.float32)
        blob[k if i % 2 else k.removeprefix("vgg16/")] = a
    if fc6 is not None:
        blob["vgg16/conv6/kernel"] = rng.normal(size=fc6).astype(np.float32)
    blob.update(extra or {})
    np.savez(path, **blob)
    return str(path)


def test_vgg_import_matches_jax(tmp_path):
    """load_npz_weights on the port's state_dict against JAX's on the flax
    params of the production FCN-8s build (its parameter names are the
    canonical build's, so one archive serves both): the imported weights
    bit-equal through the weight bridge, the reports equal; strict raises
    in both on an unused entry and on an unmatched backbone param; a shape
    mismatch raises in both modes."""
    jm = jax_fcn("fcn8s")
    params = jax_init(jm)["params"]
    flat = convert.flatten_params(params)
    model = port_fcn("fcn8s", {"params": params})
    sd, tr = model.state_dict(), convert.transposed_weights(model)

    npz = _archive(tmp_path / "a.npz", flat, extra={"head/kernel": np.zeros(3)})
    jrep, rep = {}, {}
    jnew = jax_load_npz(params, npz, report=jrep)
    got = load_npz_weights(sd, npz, report=rep, transposed=tr)
    assert rep == jrep and len(rep["matched"]) == 30
    assert rep["unused_archive"] == ["head/kernel"] and not rep["unmatched_params"]
    want = convert.to_state_dict(convert.flatten_params(jnew), model)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["vgg16.stage1.conv0.weight"],
                           sd["vgg16.stage1.conv0.weight"])
    assert torch.equal(got["score_conv7.weight"], sd["score_conv7.weight"])
    for fn, kw in ((jax_load_npz, {}), (load_npz_weights, {"transposed": tr})):
        target = params if fn is jax_load_npz else sd
        with pytest.raises(ValueError, match="unused archive entries"):
            fn(target, npz, strict=True, **kw)
    short = _archive(tmp_path / "b.npz", flat, drop=("vgg16/conv7/bias",))
    jrep, rep = {}, {}
    with pytest.raises(ValueError, match="vgg16/conv7/bias"):
        jax_load_npz(params, short, strict=True, report=jrep)
    with pytest.raises(ValueError, match="vgg16/conv7/bias"):
        load_npz_weights(sd, short, strict=True, report=rep, transposed=tr)
    assert rep == jrep and rep["unmatched_params"] == ["vgg16/conv7/bias"]
    wide = _archive(tmp_path / "c.npz", flat, fc6=(7, 7, 128, 64))
    for strict in (False, True):
        with pytest.raises(ValueError, match="shape mismatch"):
            jax_load_npz(params, wide, strict=strict)
        with pytest.raises(ValueError, match="shape mismatch"):
            load_npz_weights(sd, wide, strict=strict, transposed=tr)


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.01),
                                     ("adamw", 0.01), ("sgd", 0.0)])
def test_bf16_moment_matches_optax(name, wd):
    """Three updates with the first moment stored in bf16 (optax's
    mu_dtype / accumulator_dtype): the parameters within lr * 2^-7 (one
    bf16 rounding of the moment apart, should the f32 moment round the
    other way) and the stored moment in bf16 within one bf16 ulp of
    optax's; the second moment stays f32."""
    rng = np.random.default_rng(4)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    lr = 1e-2
    tx = jax_optimizer(name, lr, wd, mu_dtype=jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)

    class Tree(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params.items():
                self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    model = Tree()
    opt = make_optimizer(name, model.parameters(), lr, wd, mu_dtype="bfloat16")
    assert isinstance(opt, MomentDtypeOptimizer)
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    mus = [leaf for leaf in jax.tree.leaves(js) if getattr(leaf, "dtype", None)
           == jnp.bfloat16]
    assert len(mus) == 2
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=lr * 2 ** -7, err_msg=k)
        st = opt.state[p]
        mu = st["momentum_buffer" if name == "sgd" else "exp_avg"]
        assert mu.dtype == torch.bfloat16
        if name != "sgd":
            assert st["exp_avg_sq"].dtype == torch.float32
    key = "momentum_buffer" if name == "sgd" else "exp_avg"
    for m, p in zip(mus, model.parameters()):      # a, b in both
        np.testing.assert_allclose(opt.state[p][key].float().numpy(),
                                   np.asarray(m, np.float32), rtol=2 ** -7)


def _u8_torch_batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.integers(0, 256, (n, 40, 72, 3), np.uint8)),
            "label": torch.from_numpy(rng.integers(0, 2, (n, 40, 72)).astype(np.int32)),
            "valid": torch.from_numpy(rng.random((n, 40, 72)) > 0.1)}


def test_remat_step_equals_plain_step(monkeypatch):
    """Dropout 0.5 and random crops, two steps: the remat step (the forward
    recomputed in the backward) equals the plain step bit for bit, the
    dropout generator included. Without the replay of the dropout
    generator's state the recompute draws other masks and the gradients
    differ: the test sees that."""
    aug = make_augment_fn(MEAN, STD, crop_size=(32, 64))
    batches = [_u8_torch_batch(s) for s in range(2)]

    def run(remat):
        model = port_fcn("fcn8s").train()
        init_params(model, torch.Generator().manual_seed(0))
        st = create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                                make_lr_schedule(1e-3), seed=0)
        step = make_train_step(2, augment_fn=aug, remat=remat)
        losses = [step(st, b)["loss"].item() for b in batches]
        return st, losses

    plain, lp = run(False)
    rem, lr_ = run(True)
    assert lp == lr_
    for (k, p), q in zip(plain.model.named_parameters(), rem.model.parameters()):
        assert torch.equal(p, q), k
    assert torch.equal(plain.dropout_gen.get_state(), rem.dropout_gen.get_state())
    import contextlib

    monkeypatch.setattr(step_mod, "_replay", lambda g, s: contextlib.nullcontext())
    bad, _ = run(True)
    assert not all(torch.equal(p, q) for p, q in zip(plain.model.parameters(),
                                                     bad.model.parameters()))
    with pytest.raises(ValueError, match="1-D data mesh"):
        make_train_step(2, shard_opt=True)


def test_zero1_on_one_rank_and_its_guards():
    """ZeRO-1 over a 1x1 grid (one data rank: every leaf whole, nothing to
    gather) equals the plain step bit for bit, two Adam steps with EMA; the
    JAX package's guards: ``shard_opt`` without a grid or on a grid that
    splits rows raises "requires a 1-D data mesh", as does sharding a
    state for one; a state that ``shard_state_zero1`` did not prepare
    raises in a ``shard_opt`` step, and a sharded state in a plain one."""
    from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (
        Grid, make_grid,
    )
    from semanticsegmentation_tensorflow_tpu_torch.train.state import (
        shard_state_zero1,
    )

    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.normal(size=(2, 32, 64, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 2, (2, 32, 64)).astype(np.int32))}

    def fresh():
        model = port_fcn("fcn8s", dropout_rate=0.0).train()
        init_params(model, torch.Generator().manual_seed(0))
        return create_train_state(model, make_optimizer("adam", model.parameters(), 1e-3),
                                  make_lr_schedule(1e-3), seed=0, ema_decay=0.9)

    grid = make_grid(1, 1)
    plain, sharded = fresh(), shard_state_zero1(fresh(), grid)
    assert all(a is None for a in sharded.zero1.axes)
    for st, step in ((plain, make_train_step(2, mesh=grid)),
                     (sharded, make_train_step(2, mesh=grid, shard_opt=True))):
        for _ in range(2):
            step(st, batch)
    for (k, p), q in zip(plain.model.named_parameters(), sharded.model.parameters()):
        assert torch.equal(p, q) and torch.equal(plain.ema_params[k],
                                                 sharded.ema_params[k]), k
    for bad in (None, Grid(1, 2, 0)):
        with pytest.raises(ValueError, match="1-D data mesh"):
            make_train_step(2, mesh=bad, shard_opt=True)
        with pytest.raises(ValueError, match="1-D data mesh"):
            shard_state_zero1(fresh(), bad)
    with pytest.raises(ValueError, match="shard_state_zero1"):
        make_train_step(2, mesh=grid, shard_opt=True)(fresh(), batch)
    with pytest.raises(ValueError, match="shard_opt=True"):
        make_train_step(2, mesh=grid)(sharded, batch)
    with pytest.raises(ValueError, match="already"):
        shard_state_zero1(sharded, grid)


def test_train_cli_passes_the_presets_remat(monkeypatch, tmp_path):
    """A preset with train.remat=True reaches make_train_step (it was
    dropped before), and the run trains through it."""
    import dataclasses

    from semanticsegmentation_tensorflow_tpu_torch import config
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train

    base = config.get_preset("fcn8s_kitti")
    preset = dataclasses.replace(base, train=dataclasses.replace(base.train, remat=True))
    monkeypatch.setattr(config, "get_preset", lambda name: preset)
    seen = []
    real = step_mod.make_train_step
    monkeypatch.setattr(step_mod, "make_train_step",
                        lambda *a, **kw: seen.append(kw["remat"]) or real(*a, **kw))
    data = generate_synthetic_kitti(str(tmp_path / "d"), n_train=2, n_test=1,
                                    h=64, w=96)
    assert train.main(["--data-dir", data, "--epochs", "1", "--device", "cpu",
                       "--image-size", "64", "96", "--batch-size", "2",
                       "--model-kw", "fc_features=32,width_mult=0.25",
                       "--checkpoint-dir", str(tmp_path / "ck")]) == 0
    assert seen == [True]
    assert os.path.exists(tmp_path / "ck" / "ckpt_1.pt")
