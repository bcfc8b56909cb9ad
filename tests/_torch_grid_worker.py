"""One rank of a gloo process group on the CPU, for tests/test_torch_spatial.py.

Not a pytest module (leading underscore); it imports nothing of JAX:

    python tests/_torch_grid_worker.py JOB RANK WORLD STORE OUT

``JOB`` is a ``torch.save``d dict ``{"scenarios": [...]}``; each scenario
runs on this rank and its results go to ``OUT`` (``torch.save``). ``STORE``
is the path of the group's ``FileStore``. The process group and every
collective time out after 60 s, so a hang fails the test instead of
stalling the run.
"""

from __future__ import annotations

import datetime
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from semanticsegmentation_tensorflow_tpu_torch.data.augment import (  # noqa: E402
    make_augment_fn,
)
from semanticsegmentation_tensorflow_tpu_torch.models.common import (  # noqa: E402
    conv_nhwc, dropout, upsample_bilinear,
)
from semanticsegmentation_tensorflow_tpu_torch.models.registry import (  # noqa: E402
    build_model,
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
from semanticsegmentation_tensorflow_tpu_torch.train.state import (  # noqa: E402
    create_train_state, make_lr_schedule, make_optimizer,
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
    running statistics) on every rank, and on rank 0 the first step's
    gradients and the last state_dict."""
    classes = sc.get("classes", 2)
    grid = make_grid(sc["data"], sc["spatial"])
    model = build_model(sc["model"], classes, device="cpu", dtype=torch.float32,
                        **sc["kw"])
    model.load_state_dict(sc["state_dict"])
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
           "buffers": sum(b.double().sum().item() for b in model.buffers())}
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


RUN = {"ops": run_ops, "step": run_step, "eval": run_eval}


def main() -> None:
    job, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    results = {}
    for sc in torch.load(job, weights_only=False)["scenarios"]:
        results[sc["name"]] = RUN[sc["kind"]](sc)
    torch.save(results, out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
