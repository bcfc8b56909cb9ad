"""One rank of a gloo process group on the CPU, for tests/test_torch_spatial.py.

Not a pytest module (leading underscore); it imports nothing of JAX:

    python tests/_torch_grid_worker.py JOB RANK WORLD STORE OUT

``JOB`` is a ``torch.save``d dict ``{"scenarios": [...]}``; each scenario
runs on this rank and its results go to ``OUT`` (``torch.save``), with
each scenario's seconds under ``"seconds"``. ``STORE``
is the path of the group's ``FileStore``. The process group and every
collective time out after 60 s, so a hang fails the test instead of
stalling the run.
"""

from __future__ import annotations

import datetime
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from semanticsegmentation_tensorflow_tpu_torch.data.augment import (  # noqa: E402
    make_augment_fn,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import (  # noqa: E402
    dropout, upsample_bilinear,
)
from semanticsegmentation_tensorflow_tpu_torch.models.registry import (  # noqa: E402
    build_model,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.conv import (  # noqa: E402
    conv_nhwc,
)
from semanticsegmentation_tensorflow_tpu_torch.ops.fast_upsample import (  # noqa: E402
    ConvTranspose,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.halo import (  # noqa: E402
    boundary_rows,
)
from semanticsegmentation_tensorflow_tpu_torch.parallel.mesh import (  # noqa: E402
    make_grid, use_grid,
)
from semanticsegmentation_tensorflow_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from semanticsegmentation_tensorflow_tpu_torch.train.state import (  # noqa: E402
    create_train_state, make_lr_schedule, make_optimizer, shard_state_zero1,
)
from semanticsegmentation_tensorflow_tpu_torch.train.step import (  # noqa: E402
    make_eval_step, make_train_step,
)

MEAN, STD = (123.68, 116.779, 103.939), (58.393, 57.12, 57.375)


def run_ops(sc: dict) -> dict:
    """The row-split ops on a 1 x world grid: this rank's output rows and
    input-gradient rows, and its share of the weight gradient (None for an
    op without one). With ``stride``, the rows split at that stride,
    unevenly where its blocks do not divide (``Grid.at_height``)."""
    grid = make_grid(1, dist.get_world_size())
    x = sc["x"]
    h, stride = x.shape[1], sc.get("stride", 1)
    if "stride" in sc:
        grid = grid.at_height(h, stride)
    out = {}
    rows = grid.rows(h, stride)
    [(top, bot)] = boundary_rows([x[:, rows]], [sc["fill"]], grid)
    out["boundary"] = (top, bot)
    for name, op in sc["ops"].items():
        xl = x[:, rows].clone().requires_grad_()
        w = None
        with use_grid(grid):
            if op["kind"] == "conv":
                w = op["w"].clone().requires_grad_()
                y = conv_nhwc(xl, w, dtype=torch.float32, padding=op["padding"],
                              dilation=op.get("dilation", 1))
            elif op["kind"] == "convT":
                mod = ConvTranspose(x.shape[-1], op["w"].shape[1], op["stride"],
                                    kernel_size=op.get("kernel"), dtype=torch.float32)
                with torch.no_grad():
                    mod.weight.copy_(op["w"])
                    mod.bias.copy_(op["b"])
                w = mod.weight
                y = mod(xl)
            elif op["kind"] == "upsample":
                y = upsample_bilinear(xl, op["factor"])
            else:      # dropout, the mask drawn at the whole image's shape
                y = dropout(xl, op["rate"], training=True,
                            generator=torch.Generator().manual_seed(op["seed"]))
        ch = op["cot"].shape[1]
        cot = op["cot"][:, grid.rows(ch, stride * ch // h)]
        with use_grid(grid):
            y.backward(cot)
        out[name] = (y.detach(), xl.grad, None if w is None else w.grad)
    return out


def run_step(sc: dict) -> dict:
    """``steps`` train steps of a model on a ``data x spatial`` grid from the
    given weights and global batch (SGD; ``remat`` as the scenario says;
    ``classes`` classes, default 2;
    with ``stride``, the rows split at it, unevenly where they must); the losses, the last confusion
    matrix, checksums of the parameters and of the buffers (BatchNorm's
    running statistics) and the names of the autograd nodes of the fused
    stage1's outputs on every rank, and on rank 0 the first step's
    gradients and the last state_dict."""
    classes = sc.get("classes", 2)
    grid = make_grid(sc["data"], sc["spatial"])
    model = build_model(sc["model"], classes, device="cpu", dtype=torch.float32,
                        **sc["kw"])
    model.load_state_dict(sc["state_dict"])
    tails = set()
    for m in model.modules():
        if type(m).__name__ in ("Stage1", "SegNetStage1"):
            m.register_forward_hook(lambda mod, args, out: tails.add(type(
                (out[0] if isinstance(out, tuple) else out).grad_fn).__name__))
    opt = make_optimizer("sgd", model.parameters(), sc["lr"])
    state = create_train_state(model, opt, make_lr_schedule(sc["lr"]), seed=0)
    aug = make_augment_fn(MEAN, STD) if sc.get("augment") else None
    b = sc["batch"]
    n, h = b["label"].shape[:2]
    stride = sc.get("stride", 1)
    if "stride" in sc:              # the rows split at the model's stride
        grid = grid.at_height(h, stride)
    step = make_train_step(classes, mesh=grid, augment_fn=aug,
                           remat=sc.get("remat", False))
    local = {k: v[grid.images(n)][:, grid.rows(h, stride)].contiguous()
             for k, v in b.items()}
    losses, grads = [], None
    for i in range(sc["steps"]):
        out = step(state, local)
        losses.append(out["loss"].item())
        if i == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    res = {"losses": losses, "cm": out["cm"],
           "checksum": sum(p.detach().double().sum().item()
                           for p in model.parameters()),
           "buffers": sum(b.double().sum().item() for b in model.buffers()),
           "stage1_tails": sorted(tails)}
    if dist.get_rank() == 0:
        res["grads"] = grads
        res["params"] = {k: v.clone() for k, v in model.state_dict().items()}
    return res


def run_eval(sc: dict) -> dict:
    """The eval step with the road histogram on a ``world x 1`` data grid,
    on this rank's images of the global batch; every rank returns the
    world's sums."""
    grid = make_grid(dist.get_world_size(), 1)
    model = build_model(sc["model"], 2, device="cpu", dtype=torch.float32,
                        **sc["kw"])
    model.load_state_dict(sc["state_dict"])
    b = sc["batch"]
    local = {k: v[grid.images(b["label"].shape[0])] for k, v in b.items()}
    out = make_eval_step(2, mesh=grid, road_hist=True)(model, local)
    return {"loss": out["loss"].item(), "cm": out["cm"],
            "road_hist": out["road_hist"], "pred": out["pred"]}


def run_zero1(sc: dict) -> dict:
    """ZeRO-1 on a ``world x 1`` data grid: ``steps`` steps of the
    replicated grid step and of the ``shard_opt`` step from the same
    weights and global batch (optimizer ``opt``, weight decay ``wd``,
    ``grad_accum``, ``ema``), and the resumes across the two: a checkpoint
    of one step of each run, restored into the other kind of state, then
    the remaining steps. Every rank returns its losses, a checksum of its
    parameters, the sizes of its sharded leaves' moments against their
    parameters', and its moment bytes in both runs; rank 0 also the
    parameters, EMA and whole-parameter moments of every run and the
    names of the sharded leaves."""
    grid = make_grid(dist.get_world_size(), 1)
    b = sc["batch"]
    local = {k: v[grid.images(b["label"].shape[0])] for k, v in b.items()}

    def fresh(shard):
        model = build_model(sc["model"], 2, device="cpu", dtype=torch.float32,
                            **sc["kw"])
        model.load_state_dict(sc["state_dict"])
        opt = make_optimizer(sc["opt"], model.parameters(), sc["lr"], sc["wd"])
        st = create_train_state(model, opt, make_lr_schedule(sc["lr"]), seed=0,
                                ema_decay=sc["ema"])
        return shard_state_zero1(st, grid) if shard else st

    def run(st, steps, shard):
        step = make_train_step(2, mesh=grid, grad_accum=sc["grad_accum"],
                               shard_opt=shard)
        return [step(st, local)["loss"].item() for _ in range(steps)]

    def moment_bytes(st):
        return sum(v.numel() * v.element_size() for s in st.optimizer.state.values()
                   for v in s.values() if torch.is_tensor(v) and v.dim())

    res, whole = {}, {}
    for kind in ("replicated", "zero1"):
        st = fresh(kind == "zero1")
        res[f"{kind}_losses"] = run(st, sc["steps"], kind == "zero1")
        res[f"{kind}_checksum"] = sum(p.detach().double().sum().item()
                                      for p in st.model.parameters())
        res[f"{kind}_bytes"] = moment_bytes(st)
        whole[kind] = st
    z = whole["zero1"].zero1
    res["shard_sizes"] = [
        (p.numel(), st_leaf["exp_avg"].numel())
        for p, a, leaf in zip(z.params, z.axes, z.leaves) if a is not None
        for st_leaf in [whole["zero1"].optimizer.state[leaf]]]
    opt_sd = {k: whole[k].optimizer_state_dict() for k in whole}   # collective
    for src, dst in (("replicated", "zero1"), ("zero1", "replicated")):
        st = fresh(src == "zero1")
        run(st, 1, src == "zero1")
        directory = os.path.join(sc["tmp"], f"{src}_{dist.get_world_size()}")
        CheckpointManager(directory, write=dist.get_rank() == 0).save(st)
        dist.barrier()
        st = CheckpointManager(directory).restore(fresh(dst == "zero1"))
        res[f"resumed_{dst}_losses"] = run(st, sc["steps"] - 1, dst == "zero1")
        whole[f"resumed_{dst}"] = st
        opt_sd[f"resumed_{dst}"] = st.optimizer_state_dict()
    if dist.get_rank() == 0:
        sharded = {id(p) for p, a in zip(z.params, z.axes) if a is not None}
        res["sharded"] = {n for n, p in whole["zero1"].model.named_parameters()
                          if id(p) in sharded}
        res["runs"] = {k: {"params": {n: p.detach().clone() for n, p
                                      in st.model.named_parameters()},
                           "ema": {n: e.clone() for n, e in st.ema_params.items()},
                           "optimizer": opt_sd[k]}
                       for k, st in whole.items()}
    return res


def run_cli(sc: dict) -> dict:
    """The port's entry points inside this world (``initialize_distributed``
    finds the group up): each ``(script, argv)`` of ``calls`` in turn, its
    return code and this rank's standard output."""
    import contextlib
    import importlib
    import io

    outs = []
    for script, argv in sc["calls"]:
        main = importlib.import_module(
            f"semanticsegmentation_tensorflow_tpu_torch.scripts.{script}").main
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        outs.append((rc, buf.getvalue()))
    return {"outputs": outs}


RUN = {"ops": run_ops, "step": run_step, "eval": run_eval, "zero1": run_zero1,
       "cli": run_cli}


def main() -> None:
    job, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    results, seconds = {}, {}
    for sc in torch.load(job, weights_only=False)["scenarios"]:
        t0 = time.perf_counter()
        results[sc["name"]] = RUN[sc["kind"]](sc)
        seconds[sc["name"]] = time.perf_counter() - t0
    results["seconds"] = seconds
    torch.save(results, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
