"""Height-partitioned training in the port (``--spatial``, a data x spatial
grid of ranks) against the JAX package on the CPU, in float32.

* the halo mode of the stage1 tail (kernel 1c's plain versions) against the
  JAX package's ``spmd=True`` kernels in interpret mode, over the whole image
  and as two halves with real halo rows;
* the boundary rows against the JAX ``_halo_rows``;
* the row-split ops (convs, transposed convs) on two gloo ranks against the
  whole-image ops;
* the grid train step (FCN-8s and SegNet; 2x2, 1x2 and 2x1 grids, gloo ranks
  in subprocesses of ``tests/_torch_grid_worker.py``) against the JAX
  package's single-device and 1-D mesh steps with ``pallas_spmd=True``, and
  against the port's own single-process step (gradients, dropout on);
* BatchNorm on the grid (U-Net 2x1 and 1x2 with uneven rows, DeepLab 2x2)
  against the JAX package's 1-D ``shard_map`` mesh and its 2-D mesh;
* ZeRO-1 (``shard_opt``) on 2 and 4 data ranks against the replicated grid
  step (bit for bit), the JAX package's ``shard_opt`` step and its
  ``zero1_spec``, and checkpoints that resume across the two;
* the CLIs on two ranks: ``train --qat`` on a data and a spatial grid and
  ``eval --distributed`` (plain and ``--tta``) against one process,
  ``train --shard-opt`` on both grids;
* the halo mode on one process, the registry's SPMD-safe kwargs, the
  loader's grid slices, and the train CLI's ``--spatial`` at one rank.

Every spawned rank has a 60 s timeout on the process group and the test a
timeout on each process, so a hang fails in seconds.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semanticsegmentation_tensorflow_tpu.models import build_model as jax_build
from semanticsegmentation_tensorflow_tpu.models.registry import (
    merge_spmd_safe_kwargs as jax_merge_spmd, spmd_safe_kwargs as jax_spmd_kwargs,
)
from semanticsegmentation_tensorflow_tpu.ops.pallas.stage1 import (
    _fused_fwd, _halo_rows, fused_segnet_stage1_tail, fused_stage1_tail,
)
from semanticsegmentation_tensorflow_tpu.parallel.mesh import (
    make_mesh, make_mesh_2d, replicate, shard_batch,
    shard_state_zero1 as jax_shard_zero1, zero1_spec as jax_zero1_spec,
)
from semanticsegmentation_tensorflow_tpu.train.state import (
    TrainState as JaxTrainState, create_train_state as jax_state,
    make_optimizer as jax_optimizer,
)
from semanticsegmentation_tensorflow_tpu.train.step import (
    make_train_step as jax_train_step,
)
from semanticsegmentation_tensorflow_tpu_torch import convert
from semanticsegmentation_tensorflow_tpu_torch.data.augment import make_augment_fn
from semanticsegmentation_tensorflow_tpu_torch.data.pipeline import BatchLoader
from semanticsegmentation_tensorflow_tpu_torch.data.synthetic import (
    generate_synthetic_kitti,
)
from semanticsegmentation_tensorflow_tpu_torch.data import build_dataset
from semanticsegmentation_tensorflow_tpu_torch.infer import quant as pq
from semanticsegmentation_tensorflow_tpu_torch.models.common import (
    bn_fed_biases, init_params,
)
from semanticsegmentation_tensorflow_tpu_torch.models.registry import (
    build_model, merge_spmd_safe_kwargs, spmd_safe_kwargs,
)
from semanticsegmentation_tensorflow_tpu_torch.models.segnet import SegNetStage1
from semanticsegmentation_tensorflow_tpu_torch.models.vgg16 import Stage1, _halo_tail
from semanticsegmentation_tensorflow_tpu_torch.ops.conv import conv_nhwc
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda import stage1 as port_stage1
from semanticsegmentation_tensorflow_tpu_torch.ops.cuda.stage1 import (
    BwdHalos, SegNetStage1TailHalo, Stage1TailHalo, stage1_tail_halo_bwd_plain,
    stage1_tail_halo_plain,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import ConvTranspose
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import boundary_rows
from semanticsegmentation_tensorflow_tpu_torch.parallel.launch import (
    initialize_distributed,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import Grid, make_grid
from semanticsegmentation_tensorflow_tpu_torch.train.state import (
    create_train_state, make_lr_schedule, make_optimizer,
)
from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (
    CheckpointManager, load_weights,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import (
    make_eval_step, make_train_step,
)

import torch_parity  # noqa: F401  (one intra-op thread in this process)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_grid_worker.py")
LR = 1e-3
FCN_HW, SEG_HW = (192, 32), (64, 32)   # 192/32 = 6 rows at fc6: 3 per rank at S=2
FCN_KW = dict(fc_features=16, width_mult=1.0, dropout_rate=0.0)
SEG_KW = dict(width_mult=1.0)
JAX_KW = dict(packed_stage1=True, pallas_pool=True, pallas_spmd=True)
DROP_KW = dict(fc_features=16, width_mult=0.25, dropout_rate=0.5)
# DeepLab os8 on 64 rows: 8 rows at 1/8, so 4 (1x2) or 2 (1x4) a rank against
# conv6's 12-row halo (7x7 at dilation 4) and the rate-4 branch's 4 rows
DL_HW = (64, 32)
DL_KW = dict(width_mult=0.25, aspp_features=16, rates=(2, 4), dropout_rate=0.5)
# uneven row shards (queue 3 fault 4), each height a stride multiple whose
# blocks do not split evenly over 2 ranks: DeepLab os8 (dropout 0, so that
# the JAX step is comparable) on 24 rows, three blocks of 8 -> 16 + 8; U-Net
# (8 features, depth 2, stride 4, 19 classes) on 20 rows, five blocks ->
# 12 + 8
UNEVEN = {"deeplab_os8": dict(model="deeplab", hw=(24, 32), stride=8, classes=2,
                              kw=dict(DL_KW, dropout_rate=0.0)),
          "unet": dict(model="unet", hw=(20, 32), stride=4, classes=19,
                       kw=dict(base_features=8, depth=2))}
# BatchNorm on the grid: U-Net (19 classes) on a 2x1 data grid, each rank
# normalizing by its own images (JAX's 1-D shard_map mesh, whose BatchNorm
# has no axis name; the statistics pmean'd after the step), and on a 1x2
# grid of 20 rows at stride 4, 12 + 8 (JAX's 2-D mesh, one global program:
# the statistics of every row); DeepLab os8 on a 2x2 grid (the world's
# statistics, the ASPP image branch's counting each image once)
BN = {"unet_bn": dict(model="unet", hw=(20, 32), stride=4, classes=19,
                      kw=dict(base_features=8, depth=2, use_bn=True)),
      "deeplab_bn": dict(model="deeplab", hw=DL_HW, stride=8, classes=2,
                         kw=dict(DL_KW, dropout_rate=0.0, use_bn=True))}
BN_GRIDS = {"unet_bn_2x1": ("unet_bn", 2, 1), "unet_bn_1x2": ("unet_bn", 1, 2),
            "deeplab_bn_2x2": ("deeplab_bn", 2, 2)}
# ZeRO-1 on the FCN at the tests' SMALL widths (torch_parity.SMALL), two
# steps of batch 4 at 32x64: Adam on 2 and 4 data ranks, and AdamW with
# weight decay, grad_accum=2 and EMA on 2
Z1_KW = dict(fc_features=32, width_mult=0.25, dropout_rate=0.0)
Z1 = {"zero1_adam_w2": dict(world=2, opt="adam", wd=0.0, ema=0.0, grad_accum=1),
      "zero1_adam_w4": dict(world=4, opt="adam", wd=0.0, ema=0.0, grad_accum=1),
      "zero1_adamw_w2": dict(world=2, opt="adamw", wd=0.01, ema=0.9, grad_accum=2)}
# the CLIs on two ranks: a narrow FCN-32s on generated KITTI images
NARROW = ["--model", "fcn32s", "--model-kw", "fc_features=32,width_mult=0.25",
          "--device", "cpu"]


# ---------------------------------------------------------------------------
# the halo mode of the stage1 tail against the JAX spmd kernels
# ---------------------------------------------------------------------------

def _tail_args(kind: str):
    """(z1 packed [2,8,16,128], k2 HWIO, b2, b1) with a nonzero b1: random
    normals, or integers where every sum is exact (many pooling ties)."""
    rng = np.random.default_rng(5)
    if kind == "random":
        return (rng.normal(size=(2, 8, 16, 128)).astype(np.float32),
                (rng.normal(size=(3, 3, 64, 64)) * 0.1).astype(np.float32),
                (rng.normal(size=(64,)) * 0.1).astype(np.float32),
                (rng.normal(size=(64,)) * 0.5).astype(np.float32))
    k2 = rng.integers(-1, 2, (3, 3, 64, 64)).astype(np.float32)
    k2[1] = k2[0]
    return (rng.integers(-2, 3, (2, 8, 16, 128)).astype(np.float32), k2,
            rng.integers(-2, 3, (64,)).astype(np.float32),
            rng.integers(1, 3, (64,)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_tail(kind: str, segnet: bool):
    """The JAX spmd kernels (interpret mode) on _tail_args: out, codes, and
    (dz1, dk2, db2, db1) for a fixed cotangent, unpacked to NHWC/OIHW."""
    args = [jnp.asarray(a) for a in _tail_args(kind)]
    if segnet:
        def fn(*a):
            return fused_segnet_stage1_tail(*a, True, True)[0]
    else:
        def fn(*a):
            return fused_stage1_tail(*a, True, True)
    out, vjp = jax.vjp(fn, *args)
    cot = np.random.default_rng(6).integers(-3, 4, out.shape).astype(np.float32)
    dz1, dk2, db2, db1 = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    _, res = _fused_fwd(*args, True, True, biased_codes=segnet)
    codes = np.transpose(np.asarray(res[-1]), (2, 0, 1, 3))
    n, h, wp, c2 = dz1.shape
    return (np.asarray(out), codes, cot, dz1.reshape(n, h, 2 * wp, c2 // 2),
            dk2.transpose(3, 2, 0, 1), db2, db1)


def _port_tail(kind: str, segnet: bool, parts: int):
    """The port's halo-mode plain versions on the same inputs, the image's
    rows split into ``parts`` bands whose halo rows are their neighbours'
    boundary rows (-inf / 0 at the image's edges); results joined."""
    z1p, k2, b2, b1 = _tail_args(kind)
    n, h, wp, c2 = z1p.shape
    z1 = torch.from_numpy(z1p.reshape(n, h, 2 * wp, c2 // 2))
    k2t = torch.from_numpy(np.ascontiguousarray(k2.transpose(3, 2, 0, 1)))
    b2t, b1t = torch.from_numpy(b2), torch.from_numpy(b1)
    cot = torch.from_numpy(_jax_tail(kind, segnet)[2])
    mode = "segnet" if segnet else "codes"
    hz, hp = h // parts, h // (2 * parts)

    def band(t, rows, i, fill):
        lo, hi = i * rows, (i + 1) * rows
        top = t[:, lo - 1:lo] if i else torch.full_like(t[:, :1], fill)
        bot = t[:, hi:hi + 1] if i < parts - 1 else torch.full_like(t[:, :1], fill)
        return t[:, lo:hi], top, bot

    fwd = []
    for i in range(parts):
        z, top, bot = band(z1, hz, i, float("-inf"))
        fwd.append(stage1_tail_halo_plain(z, top, bot, k2t, b2t, b1t, mode))
    out = torch.cat([f[0] for f in fwd], 1)
    codes = torch.cat([f[1] for f in fwd], 1)
    grads = []
    for i in range(parts):
        z, zt, zb = band(z1, hz, i, float("-inf"))
        g, gt, gb = band(cot, hp, i, 0.0)
        o, ot, ob = band(out, hp, i, 0.0)
        c, ct, cb = band(codes, hp, i, 0)
        grads.append(stage1_tail_halo_bwd_plain(
            g, o, c, z, k2t, b1t, BwdHalos(gt, gb, ot, ob, ct, cb, zt, zb)))
    dz1 = torch.cat([g[0] for g in grads], 1)
    dk2, db2, db1 = (sum(g[k] for g in grads) for k in (1, 2, 3))
    return out, codes, dz1, dk2, db2, db1


@pytest.mark.parametrize("kind", ["random", "integer"])
@pytest.mark.parametrize("parts", [1, 2], ids=["whole", "halves"])
@pytest.mark.parametrize("segnet", [False, True], ids=["fcn", "segnet"])
def test_halo_plain_matches_jax_spmd_kernels(segnet, parts, kind):
    """The forward, the codes and the four gradients (db1 included) of the
    halo-mode plain versions against the JAX spmd kernels in interpret mode
    (C = 64, nonzero b1, so the -inf edge fill matters). Integer inputs:
    every sum exact, so bit for bit, codes and ties included. Random inputs
    (f32, another summation order): test_torch_stage1's rtol 1e-5 for the
    forward, test_torch_train's 1e-4 for the gradients; the codes exact."""
    want = _jax_tail(kind, segnet)
    got = _port_tail(kind, segnet, parts)
    w_out, w_codes, _, w_dz1, w_dk2, w_db2, w_db1 = want
    out, codes, dz1, dk2, db2, db1 = (t.numpy() for t in got)
    np.testing.assert_array_equal(codes, w_codes)
    pairs = ((out, w_out, 1e-5), (dz1, w_dz1, 1e-4), (dk2, w_dk2, 1e-4),
             (db2, w_db2, 1e-4), (db1, w_db1, 1e-4))
    for i, (a, b, tol) in enumerate(pairs):
        if kind == "integer":
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=str(i))


@pytest.mark.parametrize("fill", [float("-inf"), 0.0])
def test_boundary_rows_whole_image_match_jax_halo_rows(fill):
    """With no grid the boundary rows are the image's edge: the JAX
    ``_halo_rows`` with one block, bit for bit."""
    x = np.random.default_rng(7).normal(size=(2, 6, 5, 4)).astype(np.float32)
    [(top, bot)] = boundary_rows([torch.from_numpy(x)], [fill], None)
    tops, bots = _halo_rows(jnp.asarray(x.transpose(1, 2, 0, 3)), 6, fill)
    for got, want in ((top, tops), (bot, bots)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).transpose(2, 0, 1, 3))


def test_pallas_spmd_on_one_process_matches_default():
    """With no grid, ``Stage1`` (kernel 1's plain version) equals the
    halo-mode tail over the whole image (``_halo_tail`` called directly:
    conv1_1 without bias, then the halo Function) in the output and every
    gradient, db1 included; the same for ``SegNetStage1`` (output and
    index). f32, another summation order: 1e-5. The inference path of
    ``_halo_tail`` takes the halo mode; the module's does not."""
    torch.manual_seed(0)
    for cls, fn, mode in ((Stage1, Stage1TailHalo, "infer"),
                          (SegNetStage1, SegNetStage1TailHalo, "segnet")):
        m = cls(3, 16, dtype=torch.float32, device="cpu")
        init_params(m, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for p in m.parameters():
                p.add_(torch.randn_like(p) * 0.1)    # nonzero biases
        x = torch.randn(2, 8, 12, 3)
        ya = m(x)
        yb = _halo_tail(m.conv0, m.conv1, x, None, fn, mode)
        if isinstance(ya, tuple):
            assert torch.equal(ya[1], yb[1])
            ya, yb = ya[0], yb[0]
        assert type(yb.grad_fn).__name__ == f"{fn.__name__}Backward"
        assert type(ya.grad_fn).__name__ != type(yb.grad_fn).__name__
        torch.testing.assert_close(yb, ya, rtol=1e-5, atol=1e-5)
        cot = torch.randn_like(ya)
        params = list(m.parameters())
        ga = torch.autograd.grad(ya, params, cot)
        gb = torch.autograd.grad(yb, params, cot)
        for (name, _), u, v in zip(m.named_parameters(), ga, gb):
            torch.testing.assert_close(v, u, rtol=1e-5, atol=1e-5, msg=name)
        calls = []
        orig = port_stage1.stage1_tail_halo_plain
        try:
            port_stage1.stage1_tail_halo_plain = lambda *q: calls.append(1) or orig(*q)
            with torch.no_grad():
                m(x)
                assert not calls, "no grid, yet the module took the halo mode"
                _halo_tail(m.conv0, m.conv1, x, None, fn, mode)
        finally:
            port_stage1.stage1_tail_halo_plain = orig
        assert calls, "the inference path did not take the halo mode"


# ---------------------------------------------------------------------------
# gloo ranks in subprocesses
# ---------------------------------------------------------------------------

def _batch(n, hw, seed, classes=2):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.normal(size=(n, *hw, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, classes, (n, *hw))
                                      .astype(np.int32)),
            "valid": torch.from_numpy(rng.random((n, *hw)) > 0.25)}


def _u8_batch(n, hw, seed):
    b = _batch(n, hw, seed)
    b["image"] = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n, *hw, 3), np.uint8))
    return b


def _ops_job():
    rng = np.random.default_rng(8)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    x = f(2, 16, 12, 8)
    ops = {"conv3": dict(kind="conv", w=f(6, 8, 3, 3), padding=1, cot=f(2, 16, 12, 6)),
           "conv7": dict(kind="conv", w=f(6, 8, 7, 7), padding=3, cot=f(2, 16, 12, 6)),
           # a halo of 10 rows against 8 rows a rank (DeepLab's dilated convs)
           "conv3_d10": dict(kind="conv", w=f(6, 8, 3, 3), padding=10, dilation=10,
                             cot=f(2, 16, 12, 6))}
    for s in (2, 8):
        ops[f"convT{s}"] = dict(kind="convT", w=f(8, 5, 2 * s, 2 * s), b=f(5),
                                stride=s, cot=f(2, 16 * s, 12 * s, 5))
    return {"name": "ops", "kind": "ops", "x": x, "ops": ops, "fill": float("-inf")}


def _uneven_ops_job():
    """The row-split ops on 24 rows at stride 8: three blocks, so rank 0
    holds 16 rows and rank 1 8. conv7_d4 is conv6's 7x7 at dilation 4 (a
    12-row halo, taller than rank 1's rows); the U-Net 2x2/2 up-conv, the
    bilinear upsample (stride 8 x 8 at the output), dropout."""
    rng = np.random.default_rng(9)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    x = f(2, 24, 12, 8)
    ops = {"conv3": dict(kind="conv", w=f(6, 8, 3, 3), padding=1, cot=f(2, 24, 12, 6)),
           "conv7_d4": dict(kind="conv", w=f(6, 8, 7, 7), padding=12, dilation=4,
                            cot=f(2, 24, 12, 6)),
           "convT2": dict(kind="convT", w=f(8, 5, 4, 4), b=f(5), stride=2,
                          cot=f(2, 48, 24, 5)),
           "convT2x2": dict(kind="convT", w=f(8, 5, 2, 2), b=f(5), stride=2, kernel=2,
                            cot=f(2, 48, 24, 5)),
           "upsample8": dict(kind="upsample", factor=8, cot=f(2, 192, 96, 8)),
           "dropout": dict(kind="dropout", rate=0.5, seed=3, cot=f(2, 24, 12, 8))}
    return {"name": "ops_uneven", "kind": "ops", "x": x, "ops": ops, "stride": 8,
            "fill": float("-inf")}


def _launch(tmp, tag, world, scenarios):
    """Start ``world`` gloo ranks of the worker on ``scenarios``."""
    job = os.path.join(tmp, f"{tag}.job")
    torch.save({"scenarios": scenarios}, job)
    store = os.path.join(tmp, f"{tag}.store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [(os.path.join(tmp, f"{tag}.{r}.pt"), subprocess.Popen(
        [sys.executable, WORKER, job, str(r), str(world), store,
         os.path.join(tmp, f"{tag}.{r}.pt")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for r in range(world)]
    return procs


def _collect(procs, timeout=240):
    out = []
    for path, p in procs:
        try:
            log, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for _, q in procs:
                q.kill()
            raise AssertionError("a gloo rank timed out")
        assert p.returncode == 0, log[-3000:]
        out.append(torch.load(path, weights_only=False))
    return out


def _jax_fcn_state(name, hw):
    kw = (dict(FCN_KW, **JAX_KW) if name == "fcn8s"
          else dict(SEG_KW, packed_dec1=False, **JAX_KW))
    model = jax_build(name, num_classes=2, dtype=jnp.float32, **kw)
    return jax_state(model, jax.random.key(0), (4, *hw, 3), jax_optimizer("sgd", LR))


def _jax_uneven_state(name):
    u = UNEVEN[name]      # the JAX defaults (its fused kernels need 64 features)
    model = jax_build(u["model"], num_classes=u["classes"], dtype=jnp.float32,
                      **u["kw"])
    return jax_state(model, jax.random.key(1), (2, *u["hw"], 3), jax_optimizer("sgd", LR))


def _port_state(name, state_dict, classes=2, **kw):
    model = build_model(name, classes, device="cpu", dtype=torch.float32, **kw)
    model.load_state_dict(state_dict)
    return create_train_state(model, make_optimizer("sgd", model.parameters(), LR),
                              make_lr_schedule(LR), seed=0)


def _bn_setup(name, seed):
    """A BN model's port state_dict (seeded init, the running statistics
    drawn away from theirs) and a maker of the JAX state on the same
    variables (the JAX step donates its state: each mesh gets its own)."""
    u = BN[name]
    model = build_model(u["model"], u["classes"], device="cpu", dtype=torch.float32,
                        **u["kw"])
    init_params(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, b in model.named_buffers():
            b.copy_(torch.from_numpy((rng.normal(0, 0.1, b.shape) if k.endswith("mean")
                                      else rng.uniform(0.5, 2, b.shape)).astype(np.float32)))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    v = convert.to_variables(convert.from_state_dict(sd, model))
    jm = jax_build(u["model"], num_classes=u["classes"], dtype=jnp.float32,
                   **u["kw"])
    tx = jax_optimizer("sgd", LR)
    return sd, lambda: JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        opt_state=tx.init(v["params"]), batch_stats=v["batch_stats"],
        rng=jax.random.key(0), apply_fn=jm.apply, tx=tx)


def _jax_mesh_steps(js, batch, classes, data, spatial):
    """Two steps of the JAX step on a ``data x spatial`` mesh of the host
    devices: 1-D (``make_mesh``, shard_map) at spatial 1, else 2-D."""
    devs = jax.devices()[:data * spatial]
    mesh = make_mesh(devs) if spatial == 1 else make_mesh_2d(data, spatial, devs)
    st = replicate(js, mesh)
    step = jax_train_step(classes, mesh=mesh)
    b = shard_batch({k: v.numpy() for k, v in batch.items()}, mesh)
    for _ in range(2):
        st, out = step(st, b)
    st = jax.device_get(st)
    return (float(out["loss"]), np.asarray(out["cm"]),
            convert.flatten_params({"params": st.params,
                                    "batch_stats": st.batch_stats}))


def _single_steps(state, batch, steps=2, augment=None, classes=2):
    step = make_train_step(classes, augment_fn=augment)
    losses, grads = [], None
    for i in range(steps):
        out = step(state, batch)
        losses.append(out["loss"].item())
        if i == 0:
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    return {"losses": losses, "cm": out["cm"], "grads": grads,
            "params": state.model.state_dict()}


def _zero1_setup(tmp):
    """The port's seeded FCN at Z1_KW, the global batch, and each Z1
    case's gloo scenario (its checkpoints under ``tmp``)."""
    model = build_model("fcn8s", 2, device="cpu", dtype=torch.float32, **Z1_KW)
    init_params(model, torch.Generator().manual_seed(7))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _batch(4, (32, 64), 30)
    scs = {name: dict(name=name, kind="zero1", model="fcn8s", kw=Z1_KW,
                      state_dict=sd, batch=batch, lr=LR, steps=2, tmp=tmp,
                      **{k: v for k, v in z.items() if k != "world"})
           for name, z in Z1.items()}
    return sd, batch, scs


def _jax_zero1(sd, batch, z):
    """Two steps of the JAX package's ZeRO-1 step (``shard_state_zero1``,
    ``make_train_step(shard_opt=True)``) on ``make_mesh`` over the first
    ``world`` host devices, from the port's weights: the loss, the params,
    and the flax paths whose optimizer state ``zero1_spec`` shards."""
    jm = jax_build("fcn8s", num_classes=2, dtype=jnp.float32, **Z1_KW)
    meta = build_model("fcn8s", 2, device="meta", **Z1_KW)
    flat = convert.from_state_dict(sd, meta)
    params = convert.to_variables(flat)["params"]
    tx = jax_optimizer(z["opt"], LR, weight_decay=z["wd"])
    mesh = make_mesh(jax.devices()[:z["world"]])
    st = jax_shard_zero1(JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
        batch_stats={}, rng=jax.random.key(0), apply_fn=jm.apply, tx=tx,
        ema_decay=z["ema"],
        ema_params=jax.tree.map(jnp.array, params) if z["ema"] else {}), mesh)
    step = jax_train_step(2, mesh=mesh, shard_opt=True, state=st,
                          grad_accum=z["grad_accum"])
    b = shard_batch({k: v.numpy() for k, v in batch.items()}, mesh)
    for _ in range(2):
        st, out = step(st, b)
    st = jax.device_get(st)
    sharded = {k for k, v in flat.items() if tuple(jax_zero1_spec(v, mesh))}
    return float(out["loss"]), convert.flatten_params(st.params), sharded


def _qat_argv(data, ck, spatial):
    """``train --qat`` on two ranks' worth of work: a data grid (64x96,
    batch 4, two epochs of one step) or --spatial 2 (192x96, so that fc6's
    7x7 has 3 rows a rank at stride 32; batch 2, one epoch of two steps);
    one calibration batch."""
    size = (["--image-size", "192", "96", "--batch-size", "2", "--spatial", "2",
             "--epochs", "1"] if spatial else
            ["--image-size", "64", "96", "--batch-size", "4", "--epochs", "2"])
    return [*NARROW, "--data-dir", data, *size, "--qat", "--qat-calib-batches",
            "1", "--checkpoint-dir", ck]


def _cli_setup(tmp):
    """Generated KITTI images, a seeded checkpoint of the narrow FCN-32s
    for eval, and the entry-point calls that the two ranks' ``cli``
    scenario makes with ``--distributed`` and one process without."""
    data = generate_synthetic_kitti(os.path.join(tmp, "kitti"), n_train=4,
                                    n_test=1, h=64, w=96, seed=0)
    model = build_model("fcn32s", 2, device="cpu", fc_features=32, width_mult=0.25)
    init_params(model, torch.Generator().manual_seed(5))
    ck0 = os.path.join(tmp, "ck0")
    CheckpointManager(ck0).save(create_train_state(
        model, make_optimizer("adam", model.parameters(), LR), make_lr_schedule(LR),
        seed=0))
    ev = [*NARROW, "--data-dir", data, "--checkpoint-dir", ck0, "--batch-size", "2"]
    small = ["--image-size", "64", "96", "--batch-size", "4", "--epochs", "1"]
    calls = {"qat_data": ("train", _qat_argv(data, os.path.join(tmp, "qd"), False)),
             "qat_spatial": ("train", _qat_argv(data, os.path.join(tmp, "qs"), True)),
             "qat_nomesh": ("train", ["--no-mesh",
                                      *_qat_argv(data, os.path.join(tmp, "qn"), False)]),
             "eval": ("eval", [*ev, "--road-metrics"]),
             "eval_tta": ("eval", [*ev, "--tta"]),
             "shard_opt_data": ("train", [*NARROW, "--data-dir", data, *small,
                                          "--shard-opt", "--checkpoint-dir",
                                          os.path.join(tmp, "zd")]),
             "shard_opt_spatial": ("train", [
                 *NARROW, "--data-dir", data, "--image-size", "192", "96",
                 "--batch-size", "2", "--epochs", "1", "--spatial", "2",
                 "--shard-opt", "--checkpoint-dir", os.path.join(tmp, "zs")])}
    return data, calls


def _one_process(script, argv):
    """An entry point's main in this process; its standard output."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(
        f"semanticsegmentation_tensorflow_tpu_torch.scripts.{script}").main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """Starts the gloo ranks (one world of 2, one of 4), computes the JAX
    steps and the port's single-process steps while they run, then collects
    every rank's results."""
    tmp = str(tmp_path_factory.mktemp("grid"))
    js = {"fcn8s": _jax_fcn_state("fcn8s", FCN_HW),
          "segnet": _jax_fcn_state("segnet", SEG_HW)}
    sds, batches = {}, {"fcn8s": _batch(4, FCN_HW, 0), "segnet": _batch(4, SEG_HW, 1)}
    for name, st in js.items():
        meta = build_model(name, 2, device="meta", **(FCN_KW if name == "fcn8s"
                                                      else SEG_KW))
        sds[name] = convert.to_state_dict(convert.flatten_params(st.params), meta)
    drop_model = build_model("fcn8s", 2, device="cpu", dtype=torch.float32, **DROP_KW)
    init_params(drop_model, torch.Generator().manual_seed(3))
    drop_sd = {k: v.clone() for k, v in drop_model.state_dict().items()}
    drop_batch = _u8_batch(4, FCN_HW, 2)
    dl_model = build_model("deeplab", 2, device="cpu", dtype=torch.float32, **DL_KW)
    init_params(dl_model, torch.Generator().manual_seed(4))
    dl_sd = {k: v.clone() for k, v in dl_model.state_dict().items()}
    dl_batch = _batch(4, DL_HW, 6)
    eval_batch = _batch(4, FCN_HW, 5)
    eval_batch["valid"][-1] = False          # the loader's wrap-padded row
    ujs, usds, ubatches = {}, {}, {}
    for i, (name, u) in enumerate(UNEVEN.items()):
        ujs[name] = _jax_uneven_state(name)
        meta = build_model(u["model"], u["classes"], device="meta", **u["kw"])
        usds[name] = convert.to_state_dict(convert.flatten_params(ujs[name].params), meta)
        ubatches[name] = _batch(4, u["hw"], 10 + i, u["classes"])
    bn = {name: (*_bn_setup(name, 20 + i), _batch(4, u["hw"], 20 + i, u["classes"]))
          for i, (name, u) in enumerate(BN.items())}
    z1_sd, z1_batch, z1_scs = _zero1_setup(tmp)
    data, calls = _cli_setup(tmp)
    cli = dict(name="cli", kind="cli",
               calls=[(script, [*argv, "--distributed"])
                      for script, argv in calls.values()])

    def bn_sc(grid):
        name, data, spatial = BN_GRIDS[grid]
        u, (sd, _, batch) = BN[name], bn[name]
        return step_sc(grid, u["model"], data, spatial, sd, batch, u["kw"],
                       stride=u["stride"], classes=u["classes"])

    def step_sc(name, model, data, spatial, sd, batch, kw, **extra):
        return dict(name=name, kind="step", model=model, data=data, spatial=spatial,
                    state_dict=sd, batch=batch, kw=kw, lr=LR, steps=2, **extra)

    fk, sk = FCN_KW, SEG_KW
    two = _launch(tmp, "w2", 2, [
        _ops_job(),
        step_sc("fcn8s_1x2", "fcn8s", 1, 2, sds["fcn8s"], batches["fcn8s"], fk),
        step_sc("fcn8s_2x1", "fcn8s", 2, 1, sds["fcn8s"], batches["fcn8s"], fk),
        step_sc("segnet_1x2", "segnet", 1, 2, sds["segnet"], batches["segnet"], sk),
        step_sc("dropout_1x2", "fcn8s", 1, 2, drop_sd, drop_batch, DROP_KW,
                augment=True),
        step_sc("deeplab_1x2", "deeplab", 1, 2, dl_sd, dl_batch, DL_KW),
        step_sc("dropout_1x2_remat", "fcn8s", 1, 2, drop_sd, drop_batch, DROP_KW,
                augment=True, remat=True),
        step_sc("deeplab_1x2_remat", "deeplab", 1, 2, dl_sd, dl_batch, DL_KW,
                remat=True),
        *(step_sc(f"{name}_1x2", u["model"], 1, 2, usds[name], ubatches[name], u["kw"],
                  stride=u["stride"], classes=u["classes"])
          for name, u in UNEVEN.items()),
        _uneven_ops_job(),
        dict(name="eval_2x1", kind="eval", model="fcn8s", state_dict=sds["fcn8s"],
             batch=eval_batch, kw=fk),
        bn_sc("unet_bn_2x1"), bn_sc("unet_bn_1x2"),
        *(sc for name, sc in z1_scs.items() if Z1[name]["world"] == 2), cli])
    four = _launch(tmp, "w4", 4, [
        step_sc("fcn8s_2x2", "fcn8s", 2, 2, sds["fcn8s"], batches["fcn8s"], fk),
        step_sc("segnet_2x2", "segnet", 2, 2, sds["segnet"], batches["segnet"], sk),
        step_sc("deeplab_1x4", "deeplab", 1, 4, dl_sd, dl_batch, DL_KW),
        bn_sc("deeplab_bn_2x2"), z1_scs["zero1_adam_w4"]])
    try:
        jax_out = {}
        fcn_mesh_state = jax.tree.map(jnp.array, js["fcn8s"])  # the steps donate
        for name, st in js.items():
            step = jax_train_step(2)
            b = {k: jnp.asarray(v.numpy()) for k, v in batches[name].items()}
            for _ in range(2):
                st, out = step(st, b)
            jax_out[name] = (float(out["loss"]), np.asarray(out["cm"]),
                             convert.flatten_params(st.params))
        for name, st in ujs.items():
            step = jax_train_step(UNEVEN[name]["classes"])
            b = {k: jnp.asarray(v.numpy()) for k, v in ubatches[name].items()}
            for _ in range(2):
                st, out = step(st, b)
            jax_out[name] = (float(out["loss"]), np.asarray(out["cm"]),
                             convert.flatten_params(st.params))
        mesh = make_mesh(jax.devices()[:2])
        st = replicate(fcn_mesh_state, mesh)
        step = jax_train_step(2, mesh=mesh)
        b = shard_batch({k: v.numpy() for k, v in batches["fcn8s"].items()}, mesh)
        for _ in range(2):
            st, out = step(st, b)
        jax_out["fcn8s_mesh"] = (float(out["loss"]), np.asarray(out["cm"]),
                                 convert.flatten_params(jax.device_get(st.params)))
        single = {name: _single_steps(_port_state(name, sds[name], **kw),
                                      batches[name])
                  for name, kw in (("fcn8s", fk), ("segnet", sk))}
        aug = make_augment_fn((123.68, 116.779, 103.939), (58.393, 57.12, 57.375))
        single["dropout"] = _single_steps(_port_state("fcn8s", drop_sd, **DROP_KW),
                                          drop_batch, augment=aug)
        single["deeplab"] = _single_steps(_port_state("deeplab", dl_sd, **DL_KW),
                                          dl_batch)
        for name, u in UNEVEN.items():
            single[name] = _single_steps(
                _port_state(u["model"], usds[name], u["classes"], **u["kw"]),
                ubatches[name], classes=u["classes"])
        single["eval"] = make_eval_step(2, road_hist=True)(
            _port_state("fcn8s", sds["fcn8s"], **fk), eval_batch)
        for grid, (name, data, spatial) in BN_GRIDS.items():
            u, (sd, js, batch) = BN[name], bn[name]
            jax_out[grid] = _jax_mesh_steps(js(), batch, u["classes"], data, spatial)
        for name, (sd, _, batch) in bn.items():
            u = BN[name]
            single[name] = _single_steps(_port_state(u["model"], sd, u["classes"],
                                                     **u["kw"]),
                                         batch, classes=u["classes"])
        for name, z in Z1.items():
            jax_out[name] = _jax_zero1(z1_sd, z1_batch, z)
        one = {}
        for name in ("qat_data", "qat_spatial", "eval", "eval_tta"):
            script, argv = calls[name]
            if script == "train":
                argv = [*argv[:-1], argv[-1] + "_one"]
            one[name] = _one_process(script, argv)
    finally:
        ranks2, ranks4 = _collect(two), _collect(four)
    return {"jax": jax_out, "single": single, "w2": ranks2, "w4": ranks4,
            "cli": dict(zip(calls, ranks2[0]["cli"]["outputs"])),
            "cli_rank1": dict(zip(calls, ranks2[1]["cli"]["outputs"])),
            "one": one, "tmp": tmp}


def test_boundary_rows_on_uneven_ranks_are_the_neighbours_rows(grid_runs):
    """On 16 + 8 rows (24 at stride 8) each rank's halo rows are the rows
    just outside its own, -inf beyond the image's edge, bit for bit."""
    x = _uneven_ops_job()["x"]
    fill = torch.full_like(x[:, :1], float("-inf"))
    for (start, rows), rank in zip(((0, 16), (16, 8)), grid_runs["w2"]):
        top, bot = rank["ops_uneven"]["boundary"]
        assert torch.equal(top, x[:, start - 1:start] if start else fill)
        end = start + rows
        assert torch.equal(bot, x[:, end:end + 1] if end < 24 else fill)


def test_boundary_rows_on_two_ranks_match_jax_halo_rows(grid_runs):
    """The exchange on two gloo ranks gives rank p the JAX ``_halo_rows``
    block p (nrows = H/2), bit for bit, -inf edge fill included."""
    ops = _ops_job()
    x = ops["x"].numpy()
    tops, bots = _halo_rows(jnp.asarray(x.transpose(1, 2, 0, 3)), x.shape[1] // 2,
                            ops["fill"])
    for p, rank in enumerate(grid_runs["w2"]):
        top, bot = rank["ops"]["boundary"]
        np.testing.assert_array_equal(top.numpy(),
                                      np.asarray(tops[p:p + 1]).transpose(2, 0, 1, 3))
        np.testing.assert_array_equal(bot.numpy(),
                                      np.asarray(bots[p:p + 1]).transpose(2, 0, 1, 3))


@pytest.mark.parametrize("op", [
    "conv3", "conv7", "conv3_d10", "convT2", "convT8",
    "uneven/conv3", "uneven/conv7_d4", "uneven/convT2", "uneven/convT2x2",
    "uneven/upsample8", "uneven/dropout"])
def test_row_split_ops_match_whole_image(grid_runs, op):
    """``conv_nhwc`` (k = 3 and 7, and k = 3 at dilation 10, whose 10-row
    halo is taller than a rank's 8 rows) and ``ConvTranspose`` (s = 2 and 8)
    on two gloo ranks, each holding half the rows; and ("uneven/") on 16 + 8
    rows (24 at stride 8): conv6's 7x7 at dilation 4 (a 12-row halo), both
    transposed convs (FCN's 4x4/2 with its halo row, U-Net's 2x2/2 without),
    ``upsample_bilinear`` and ``dropout`` (its mask drawn at the whole
    image's shape). The joined outputs and input gradients and the summed
    weight gradients equal the whole-image op's. f32, another summation
    order: within 1e-5 of the value plus 1e-6 of the tensor's largest
    element."""
    from semanticsegmentation_tensorflow_tpu_torch.models.common import (
        dropout, upsample_bilinear,
    )

    job = _uneven_ops_job() if op.startswith("uneven/") else _ops_job()
    name = op.split("/")[-1]
    spec = job["ops"][name]
    x = job["x"].clone().requires_grad_()
    w = None
    if spec["kind"] == "conv":
        w = spec["w"].clone().requires_grad_()
        y = conv_nhwc(x, w, dtype=torch.float32, padding=spec["padding"],
                      dilation=spec.get("dilation", 1))
    elif spec["kind"] == "convT":
        mod = ConvTranspose(8, 5, spec["stride"], kernel_size=spec.get("kernel"),
                            dtype=torch.float32)
        with torch.no_grad():
            mod.weight.copy_(spec["w"])
            mod.bias.copy_(spec["b"])
        w = mod.weight
        y = mod(x)
    elif spec["kind"] == "upsample":
        y = upsample_bilinear(x, spec["factor"])
    else:
        y = dropout(x, spec["rate"], training=True,
                    generator=torch.Generator().manual_seed(spec["seed"]))
    y.backward(spec["cot"])
    parts = [rank[job["name"]][name] for rank in grid_runs["w2"]]
    if "stride" in job:
        assert [p[0].shape[1] * 24 // y.shape[1] for p in parts] == [16, 8]
    pairs = [(torch.cat([p[0] for p in parts], 1), y.detach()),
             (torch.cat([p[1] for p in parts], 1), x.grad)]
    if w is not None:
        pairs.append((sum(p[2] for p in parts), w.grad))
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * want.abs().max().item())


def _ranks(grid_runs, name):
    world = "w4" if name.endswith(("2x2", "1x4")) else "w2"
    return [r[name] for r in grid_runs[world]]


@pytest.mark.parametrize("name", ["fcn8s_2x2", "fcn8s_1x2", "fcn8s_2x1",
                                  "segnet_2x2", "segnet_1x2"])
def test_grid_step_matches_jax(grid_runs, name):
    """Two SGD steps (step 2 with nonzero biases) of the grid step against
    the JAX package's step with ``pallas_spmd=True`` on the same weights and
    batch: the single-device step (the JAX tests hold its 2-D mesh step
    equal to it), and for the 2x1 grid its 1-D ``make_mesh()`` step over two
    devices. The JAX tests' tolerances: FCN loss rtol 2e-5, params rtol
    3e-4 / atol 3e-6 (tests/test_train.py:395-399); SegNet loss 5e-5,
    params 2e-4 / 2e-6 (:509-513). Every rank ends with the same params and
    loss. The confusion matrix is exact for FCN; SegNet's logits sit near
    zero at this init, so a one-ulp difference may flip a near-tied argmax:
    at most one labeled pixel in 1000 may move."""
    model = name.split("_")[0]
    ranks = _ranks(grid_runs, name)
    loss, cm, params = grid_runs["jax"]["fcn8s_mesh" if name == "fcn8s_2x1" else model]
    lrt, prt, pat = (2e-5, 3e-4, 3e-6) if model == "fcn8s" else (5e-5, 2e-4, 2e-6)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        assert r["checksum"] == ranks[0]["checksum"]
        moved = np.abs(r["cm"].numpy() - cm).sum() // 2
        assert r["cm"].sum() == cm.sum()
        assert moved <= (0 if model == "fcn8s" else cm.sum() // 1000), moved
    np.testing.assert_allclose(ranks[0]["losses"][-1], loss, rtol=lrt)
    meta = build_model(model, 2, device="meta", **(FCN_KW if model == "fcn8s"
                                                   else SEG_KW))
    got = convert.from_state_dict(ranks[0]["params"], meta)
    for k, w in params.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=prt, atol=pat,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["fcn8s_2x2", "fcn8s_1x2", "fcn8s_2x1",
                                  "segnet_2x2", "segnet_1x2"])
def test_grid_gradients_match_single_process(grid_runs, name):
    """The first step's gradients (after the all-reduce and the divide) and
    both losses of the grid step against the port's single-process step:
    every leaf within 1e-4 of its L2 norm (f32 in another summation order is
    ~1e-6; a wrong halo row moves a leaf by O(1))."""
    model = name.split("_")[0]
    want = grid_runs["single"][model]
    got = _ranks(grid_runs, name)[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    for k, g in want["grads"].items():
        err = (got["grads"][k] - g).norm() / g.norm().clamp(min=1e-30)
        assert err <= 1e-4, (k, err.item())


@pytest.mark.parametrize("name", ["fcn8s_2x2", "fcn8s_1x2", "fcn8s_2x1",
                                  "segnet_2x2", "segnet_1x2", "deeplab_1x2"])
def test_grid_stage1_takes_the_halo_mode_from_the_grid(grid_runs, name):
    """Built with no keyword for it, the fused stage1 runs its halo mode
    (kernel 1c's autograd Function) on every rank of a grid that splits
    rows, and kernel 1's on a data-only grid."""
    model, shape = name.split("_")
    tail = "SegNetStage1Tail" if model == "segnet" else "Stage1Tail"
    want = [f"{tail}HaloBackward" if shape[-1] != "1" else f"{tail}Backward"]
    for r in _ranks(grid_runs, name):
        assert r["stage1_tails"] == want


def test_grid_dropout_step_matches_single_process(grid_runs):
    """Dropout 0.5 and random flips on a 1x2 grid: the masks and flips are
    drawn at the global batch's shape, so two grid steps equal two
    single-process steps (losses rtol 2e-5, every leaf's first gradient
    within 1e-4 of its norm, the params after two steps atol 3e-6)."""
    want = grid_runs["single"]["dropout"]
    ranks = _ranks(grid_runs, "dropout_1x2")
    got = ranks[0]
    assert ranks[1]["checksum"] == got["checksum"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    for k, g in want["grads"].items():
        err = (got["grads"][k] - g).norm() / g.norm().clamp(min=1e-30)
        assert err <= 1e-4, (k, err.item())
    for k, p in want["params"].items():
        torch.testing.assert_close(got["params"][k], p, rtol=0, atol=3e-6, msg=k)


@pytest.mark.parametrize("name", ["deeplab_1x2", "deeplab_1x4"])
def test_grid_deeplab_step_matches_single_process(grid_runs, name):
    """DeepLab at output stride 8 (dropout 0.5) on a 1x2 and a 1x4 grid:
    conv6's 12-row halo and the ASPP's rate-4 halo reach past the next rank
    (at 1x4 two ranks away, past the image's edge beyond), the image-level
    mean sums over the ranks (``spatial_sum``) and the bilinear upsample
    takes one row of each neighbour. Two grid steps against two
    single-process steps: the losses within rtol 2e-5, every leaf's first
    gradient within 1e-4 of its norm, the params after two steps within
    atol 3e-6, every rank the same."""
    want = grid_runs["single"]["deeplab"]
    ranks = _ranks(grid_runs, name)
    got = ranks[0]
    assert all(r["checksum"] == got["checksum"] for r in ranks)
    assert all(r["losses"] == got["losses"] for r in ranks)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        err = (got["grads"][k] - g).norm() / g.norm().clamp(min=1e-30)
        assert err <= 1e-4, (k, err.item())
    for k, p in want["params"].items():
        torch.testing.assert_close(got["params"][k], p, rtol=0, atol=3e-6, msg=k)


@pytest.mark.parametrize("name", ["dropout_1x2", "deeplab_1x2"])
def test_grid_remat_step_equals_the_grid_step(grid_runs, name):
    """``remat`` on a 1x2 grid (one recompute per stage, each re-running
    its halo exchanges, and DeepLab's image mean over the ranks, in the
    backward): the same losses, first gradients and parameters as the grid
    step without it, bit for bit, on both ranks."""
    plain, remat = _ranks(grid_runs, name), _ranks(grid_runs, f"{name}_remat")
    for a, b in zip(plain, remat):
        assert a["losses"] == b["losses"] and a["checksum"] == b["checksum"]
    for k, g in plain[0]["grads"].items():
        assert torch.equal(remat[0]["grads"][k], g), k
    for k, p in plain[0]["params"].items():
        assert torch.equal(remat[0]["params"][k], p), k


@pytest.mark.parametrize("name", list(UNEVEN))
def test_grid_uneven_rows_step_matches_single_process_and_jax(grid_runs, name):
    """Queue 3 fault 4: two SGD steps on a 1x2 grid whose rows split
    unevenly at the model's stride (DeepLab os8 on 24 rows: 16 + 8, conv6's
    12-row halo reaching past rank 1; U-Net on 20 rows at stride 4: 12 + 8,
    19 classes). Against the port's single-process step: the losses within
    rtol 2e-5, every leaf's first gradient within 1e-4 of its norm, the
    params after two steps within atol 3e-6, every rank the same. Against
    the JAX package's single-device step on the same weights: the loss
    within rtol 2e-5 and the params within rtol 3e-4 / atol 3e-6 (FCN's
    bounds, tests/test_train.py:395-399); the confusion matrix exact for
    DeepLab, and for U-Net's 19 classes at most one labeled pixel in 1000
    moved (a near-tied argmax may order either way)."""
    u = UNEVEN[name]
    want = grid_runs["single"][name]
    ranks = _ranks(grid_runs, f"{name}_1x2")
    got = ranks[0]
    assert all(r["checksum"] == got["checksum"] for r in ranks)
    assert all(r["losses"] == got["losses"] for r in ranks)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in want["grads"].items():
        err = (got["grads"][k] - g).norm() / g.norm().clamp(min=1e-30)
        assert err <= 1e-4, (k, err.item())
    for k, p in want["params"].items():
        torch.testing.assert_close(got["params"][k], p, rtol=0, atol=3e-6, msg=k)
    loss, cm, params = grid_runs["jax"][name]
    np.testing.assert_allclose(got["losses"][-1], loss, rtol=2e-5)
    assert got["cm"].sum() == cm.sum()
    moved = np.abs(got["cm"].numpy() - cm).sum() // 2
    assert moved <= (0 if u["model"] == "deeplab" else cm.sum() // 1000), moved
    meta = build_model(u["model"], u["classes"], device="meta", **u["kw"])
    mine = convert.from_state_dict(got["params"], meta)
    assert set(mine) == set(params)
    for k, w in params.items():
        np.testing.assert_allclose(mine[k], np.asarray(w), rtol=3e-4, atol=3e-6,
                                   err_msg=k)


@pytest.mark.parametrize("grid", list(BN_GRIDS))
def test_grid_bn_step_matches_jax_meshes(grid_runs, grid):
    """Two SGD steps of a BatchNorm model on the grid against the JAX
    package's step on its own mesh of the host devices, on the same weights,
    running statistics and batch: the 1-D ``shard_map`` mesh for the 2x1
    data grid (each rank's own statistics, averaged after the step), the
    2-D mesh (one global program) for the 1x2 grid of uneven rows and the
    2x2 DeepLab. Every rank ends with the same parameters, statistics and
    losses. Against JAX: the loss within rtol 2e-5, the parameters within
    rtol 1e-3 / atol 1e-5 and the statistics within rtol 1e-4 / atol 1e-6
    (``tests/test_torch_bn.py``'s bounds), at most one labeled pixel in
    1000 moved in the confusion matrix. Where the grid splits rows its
    statistics are the whole batch's, so it also equals the port's
    single-process step: the losses within rtol 2e-5 and every leaf's
    first gradient within 1e-4 of its norm, but for a conv bias that feeds
    a BatchNorm, whose gradient is zero up to rounding: both within 1e-6."""
    name, data, spatial = BN_GRIDS[grid]
    u = BN[name]
    ranks = _ranks(grid_runs, grid)
    got = ranks[0]
    for key in ("checksum", "buffers", "losses"):
        assert all(r[key] == got[key] for r in ranks), key
    loss, cm, want = grid_runs["jax"][grid]
    np.testing.assert_allclose(got["losses"][-1], loss, rtol=2e-5)
    assert got["cm"].sum() == cm.sum()
    assert np.abs(got["cm"].numpy() - cm).sum() // 2 <= cm.sum() // 1000
    meta = build_model(u["model"], u["classes"], device="meta", **u["kw"])
    mine = convert.from_state_dict(got["params"], meta)
    assert set(mine) == set(want)
    for k, w in want.items():
        stats = k.endswith(("/mean", "/var"))
        np.testing.assert_allclose(mine[k], np.asarray(w), rtol=1e-4 if stats else 1e-3,
                                   atol=1e-6 if stats else 1e-5, err_msg=k)
    if spatial > 1:
        single = grid_runs["single"][name]
        np.testing.assert_allclose(got["losses"], single["losses"], rtol=2e-5)
        fed = bn_fed_biases(meta)
        for k, g in single["grads"].items():
            d = got["grads"][k] - g
            if k in fed:
                # a conv bias that feeds a BatchNorm: its gradient is zero up
                # to rounding (the BN subtracts the mean), so only its size
                assert d.abs().max() <= 1e-6 and g.abs().max() <= 1e-6, k
                continue
            err = d.norm() / g.norm().clamp(min=1e-30)
            assert err <= 1e-4, (k, err.item())


def test_grid_eval_step_matches_single_process(grid_runs):
    """The eval step on a 2x1 data grid (each rank its two images, the last
    one wholly invalid; one SUM of cm, the loss sums and the road
    histogram) against the single-process step on the whole batch: cm and
    histogram exact, the loss within rtol 1e-6, every rank the same, and
    each rank's predictions those of its images."""
    want = grid_runs["single"]["eval"]
    ranks = _ranks(grid_runs, "eval_2x1")
    for i, r in enumerate(ranks):
        assert torch.equal(r["cm"], want["cm"])
        assert torch.equal(r["road_hist"], want["road_hist"])
        np.testing.assert_allclose(r["loss"], want["loss"].item(), rtol=1e-6)
        assert torch.equal(r["pred"], want["pred"][2 * i:2 * i + 2])
    assert want["road_hist"].sum() == want["cm"].sum()


def _zero1_ranks(grid_runs, name):
    return [r[name] for r in grid_runs["w4" if name.endswith("w4") else "w2"]]


@pytest.mark.parametrize("name", list(Z1))
def test_zero1_step_equals_the_replicated_grid_step(grid_runs, name):
    """ZeRO-1 on a data grid of 2 or 4 ranks: after two steps the losses,
    the parameters, the EMA and the moments gathered from every rank equal
    the replicated grid step's bit for bit (the same summed gradients into
    an elementwise optimizer, each rank on its slice), every rank ends with
    the same parameters, each rank's Adam moments of a sharded leaf are
    1/world of the leaf, and its moment bytes about 1/world of the
    replicated run's (the unsharded leaves are the score layers' few)."""
    world = Z1[name]["world"]
    ranks = _zero1_ranks(grid_runs, name)
    for r in ranks:
        assert r["zero1_losses"] == r["replicated_losses"]
        assert r["zero1_checksum"] == r["replicated_checksum"] == \
            ranks[0]["zero1_checksum"]
        assert all(full == world * mine for full, mine in r["shard_sizes"])
        assert r["zero1_bytes"] < r["replicated_bytes"] / world * 1.01
    runs = ranks[0]["runs"]
    want, got = runs["replicated"], runs["zero1"]
    for key in ("params", "ema"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            assert torch.equal(got[key][k], v), (key, k)
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(got["optimizer"]["state"][i][k]),
                               torch.as_tensor(v)), (i, k)


@pytest.mark.parametrize("name", list(Z1))
def test_zero1_step_matches_jax_shard_opt(grid_runs, name):
    """Against the JAX package's ZeRO-1 step (``shard_state_zero1``,
    ``make_train_step(shard_opt=True)``) on as many host devices, from the
    same weights and batch: the loss within rtol 2e-5 and the parameters
    within rtol 3e-4 / atol 3e-6 (test_grid_step_matches_jax's FCN bounds),
    and the port shards the optimizer state of exactly the leaves whose
    flax paths ``zero1_spec`` shards (the output-channel axis)."""
    loss, params, sharded = grid_runs["jax"][name]
    got = _zero1_ranks(grid_runs, name)[0]
    np.testing.assert_allclose(got["zero1_losses"][-1], loss, rtol=2e-5)
    meta = build_model("fcn8s", 2, device="meta", **Z1_KW)
    assert {convert.flax_key(k) for k in got["sharded"]} == sharded
    mine = convert.from_state_dict(got["runs"]["zero1"]["params"], meta)
    assert set(mine) == set(params)
    for k, w in params.items():
        np.testing.assert_allclose(mine[k], np.asarray(w), rtol=3e-4, atol=3e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(Z1))
def test_zero1_checkpoints_resume_either_way(grid_runs, name):
    """A checkpoint holds the whole moments whatever the sharding: one step
    of the replicated run saved and resumed as ZeRO-1, and one of the
    ZeRO-1 run resumed replicated, each then one more step, end bit-equal
    to two uninterrupted steps (parameters, EMA, moments, the loss)."""
    ranks = _zero1_ranks(grid_runs, name)
    runs = ranks[0]["runs"]
    for kind in ("resumed_zero1", "resumed_replicated"):
        for r in ranks:
            assert r[f"{kind}_losses"] == r["replicated_losses"][1:]
        for key in ("params", "ema"):
            for k, v in runs["replicated"][key].items():
                assert torch.equal(runs[kind][key][k], v), (kind, key, k)
        for i, st in runs["replicated"]["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(runs[kind]["optimizer"]["state"][i][k]),
                                   torch.as_tensor(v)), (kind, i, k)


def _final(out: str) -> dict:
    import ast

    (line,) = [x for x in out.splitlines() if x.startswith("final: ")]
    return ast.literal_eval(line[len("final: "):])


@pytest.mark.parametrize("kind", ["data", "spatial", "nomesh"])
def test_qat_cli_on_two_ranks_matches_one_process(grid_runs, kind):
    """``train --qat --distributed`` on a 2x1 data grid and a 1x2 spatial
    grid against the same command in one process: the calibration (each
    rank its images or rows, one MAX all-reduce) writes the same
    qat_scales.json bit for bit, the final loss within rtol 1e-6, and the
    parameters after two Adam steps within 10 % of the one-process run's
    update from the seeded init (Adam's first updates are lr * g / |g|, so
    another summation order moves a near-zero gradient's element by up to
    lr; a wrong scale or halo row moves the loss). With ``--no-mesh`` each
    rank trains the whole batch on its own (no collective in the
    calibration): the ranks still meet at the same barriers around
    qat_scales.json, and rank 0's run is the data run's one process."""
    name = f"qat_{kind}"
    rc, out = grid_runs["cli"][name]
    assert rc == 0 and "QAT: calibrated 17 activation scales" in out
    assert {"spatial": "mesh=data1xspatial2", "data": "mesh=1d-data2",
            "nomesh": "ranks=2 mesh=none"}[kind] in out
    assert grid_runs["cli_rank1"][name] == (0, "")
    tmp = grid_runs["tmp"]
    ck = os.path.join(tmp, {"spatial": "qs", "data": "qd", "nomesh": "qn"}[kind])
    one_ck = os.path.join(tmp, "qs_one" if kind == "spatial" else "qd_one")
    one_out = grid_runs["one"]["qat_spatial" if kind == "spatial" else "qat_data"]
    assert pq.load_act_scales(os.path.join(ck, "qat_scales.json")) == \
        pq.load_act_scales(os.path.join(one_ck, "qat_scales.json"))
    np.testing.assert_allclose(_final(out)["loss"], _final(one_out)["loss"], rtol=1e-6)
    init = build_model("fcn32s", 2, device="cpu", fc_features=32, width_mult=0.25)
    init_params(init, torch.Generator().manual_seed(0))
    w0, got, want = init.state_dict(), load_weights(ck), load_weights(one_ck)
    dist = sum(((got[k] - want[k]) ** 2).sum() for k in want).sqrt()
    update = sum(((want[k] - w0[k]) ** 2).sum() for k in want).sqrt()
    assert dist <= 0.1 * update, (dist.item(), update.item())


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_eval_cli_on_two_ranks_matches_one_process(grid_runs, tta):
    """``eval --distributed`` on two ranks (batch 2, one image a rank, the
    world's sums a batch) against the same eval in one process: rank 0
    prints the same metric lines (the IoUs and pixel accuracy from the
    confusion matrix, the road devkit's line from the histogram, the loss
    at its 4 decimals), after ``mesh eval over 2 devices``; rank 1 prints
    only its process line."""
    name = "eval_tta" if tta else "eval"
    rc, out = grid_runs["cli"][name]
    lines = out.splitlines()
    assert rc == 0 and lines[0] == "distributed: process 0/2"
    assert "mesh eval over 2 devices" in lines
    assert grid_runs["cli_rank1"][name] == (0, "distributed: process 1/2\n")

    def metrics(text):
        return [x for x in text.splitlines()
                if x.startswith(("loss=", "kitti-road:", "TTA eval:"))]

    want = metrics(grid_runs["one"][name])
    assert len(want) == 2 and metrics(out) == want


def test_shard_opt_cli_on_two_ranks(grid_runs):
    """``train --shard-opt --distributed`` on a data grid prints the JAX
    CLI's ZeRO-1 line and writes a checkpoint of whole moments (each
    leaf's moments shaped as its parameter); under --spatial 2 it prints
    the JAX CLI's note and trains replicated."""
    rc, out = grid_runs["cli"]["shard_opt_data"]
    assert rc == 0 and "ZeRO-1: optimizer state sharded over 2 devices" in out
    rc, out = grid_runs["cli"]["shard_opt_spatial"]
    assert rc == 0 and "note: --shard-opt needs the 1-D data mesh; ignored" in out
    assert "ZeRO-1" not in out
    ck = torch.load(os.path.join(grid_runs["tmp"], "zd", "ckpt_1.pt"),
                    weights_only=True)
    params = list(ck["model"].values())
    for i, st in ck["optimizer"]["state"].items():
        assert st["exp_avg"].shape == params[i].shape == st["exp_avg_sq"].shape


# ---------------------------------------------------------------------------
# registry, grid, loader, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fcn8s", "fcn16s", "fcn32s", "segnet", "deeplab",
                                  "unet", "nope"])
def test_spmd_safe_kwargs_table_matches_jax(name):
    assert spmd_safe_kwargs(name) == jax_spmd_kwargs(name)


def test_merge_spmd_safe_kwargs_warns_on_conflict_and_keeps_user_choice():
    for merge in (merge_spmd_safe_kwargs, jax_merge_spmd):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert merge("fcn8s", {"fc_features": 8}) == {
                "fc_features": 8, "winograd": None, "pallas_spmd": True}
        with pytest.warns(UserWarning, match="winograd='f2'"):
            got = merge("segnet", {"winograd": "f2"})
        assert got == {"winograd": "f2", "pallas_spmd": True}


def test_make_grid_and_launch_guards(monkeypatch):
    """Without a process group the world is one rank: a 1x1 grid, anything
    else raises as the JAX ``make_mesh_2d`` does; the launch names what is
    missing."""
    g = make_grid(1, 1)
    assert (g.world, g.data_index, g.spatial_index, g.spatial_group) == (1, 0, 0, None)
    for shape in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="devices"):
            make_grid(*shape)
    for k in ("SEG_COORDINATOR", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        initialize_distributed("localhost:1", None, None, device="cpu")


@pytest.mark.parametrize("rank", [0, 3])
def test_loader_gives_each_rank_its_images_and_rows(tmp_path, rank):
    """``BatchLoader(mesh=grid)`` on a 2x2 grid yields rank r's images and
    rows of the batch the grid-less loader yields (same shuffle), padding
    and the wrap's invalid marks included; a height that does not split
    over the spatial ranks at the stride raises."""
    data = generate_synthetic_kitti(str(tmp_path / "d"), n_train=6, n_test=1,
                                    h=50, w=40, seed=0)
    ds = build_dataset("kitti_road", data, (50, 40))
    grid = Grid(data=2, spatial=2, rank=rank)
    kw = dict(pad_multiple=32, seed=1, device="cpu", drop_remainder=False)
    whole = list(BatchLoader(ds, 4, **kw).epoch())
    mine = list(BatchLoader(ds, 4, mesh=grid, **kw).epoch())
    assert len(whole) == len(mine) == 2
    for a, b in zip(whole, mine):
        for k in a:
            assert torch.equal(b[k], a[k][grid.images(4)][:, grid.rows(64)]), k
    with pytest.raises(ValueError, match="divide"):
        next(BatchLoader(ds, 4, mesh=Grid(1, 3, 0), **kw).epoch())


def test_train_cli_spatial_at_one_rank_merges_kwargs_and_trains(tmp_path, capsys):
    """``--spatial 2`` at one rank: the SPMD-safe kwargs merge in, the step
    runs unsharded, with no grid, so through kernel 1's backward and not the
    halo mode's, and trains."""
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train

    calls = {"stage1_tail_bwd_plain": [], "stage1_tail_halo_bwd_plain": []}
    origs = {k: getattr(port_stage1, k) for k in calls}
    for k, fn in origs.items():
        setattr(port_stage1, k,
                lambda *a, k=k, fn=fn: calls[k].append(1) or fn(*a))
    try:
        rc = train.main(["--synthetic", "--epochs", "1", "--device", "cpu",
                         "--spatial", "2", "--image-size", "64", "96",
                         "--batch-size", "8", "--model-kw",
                         "fc_features=32,width_mult=0.25",
                         "--checkpoint-dir", str(tmp_path / "ck")])
    finally:
        for k, fn in origs.items():
            setattr(port_stage1, k, fn)
    out = capsys.readouterr().out
    assert rc == 0 and "final:" in out and "mesh=none" in out
    assert calls["stage1_tail_bwd_plain"], "the step did not run kernel 1's backward"
    assert not calls["stage1_tail_halo_bwd_plain"], "no grid, yet the halo mode ran"


@pytest.mark.parametrize("argv", [["--spatial", "0"],
                                  ["--spatial", "2", "--image-size", "32", "96"],
                                  ["--spatial", "4", "--image-size", "64", "96"]])
def test_train_cli_bad_grid_raises_before_work(argv, monkeypatch):
    from semanticsegmentation_tensorflow_tpu_torch.scripts import train

    from semanticsegmentation_tensorflow_tpu_torch.data import synthetic

    monkeypatch.setattr(synthetic, "generate_synthetic_kitti",
                        lambda *a, **k: pytest.fail("work began"))
    with pytest.raises(ValueError):
        train.main(["--synthetic", "--device", "cpu", *argv])
