"""Row halo exchange for height-partitioned images (no JAX counterpart: on
the TPU, XLA's SPMD partitioner inserted these exchanges itself).

Each rank of a grid's spatial group holds a band of rows of the same images
(``parallel/mesh.py``). A conv with a k-row window needs (k-1)/2 rows of
each neighbour. Every exchange here is one ``all_reduce(SUM)`` over the
spatial group: each rank writes its boundary rows into its own slot of a
zeroed byte buffer, and since a value plus zeros is itself, the sum moves
the bits exactly, for any dtype (``-inf`` and u8 codes included). The byte
view keeps the reduction an integer one on every backend (NCCL, and gloo
on CPU or CUDA tensors, which takes ``broadcast`` and ``all_reduce`` only).

* :func:`boundary_rows`: the one row above and below this rank's rows of
  several tensors, no gradient (the fused stage1's halos);
* :func:`exchange_rows`: ``above`` rows on top and ``below`` rows under a
  tensor, differentiable (the convs); its backward sends the halo rows'
  gradients back to their owners, where they are added.

Rows beyond the image's edge get ``fill`` (zero for the convs: their SAME
padding).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(firsts: list[torch.Tensor], lasts: list[torch.Tensor], grid
              ) -> tuple[list, list]:
    """Each rank i sends ``firsts`` to rank i-1 and ``lasts`` to rank i+1 of
    its spatial group. Returns (the ``lasts`` of rank i-1, the ``firsts``
    of rank i+1), each entry None at the image's edge."""
    s, i = grid.spatial, grid.spatial_index
    tensors = firsts + lasts
    # byte offsets of the parts in a slot, 16-aligned so that each part
    # views back as its dtype
    offsets, total = [], 0
    for t in tensors:
        offsets.append(total)
        total += -(-t.numel() * t.element_size() // 16) * 16
    with torch.profiler.record_function("halo_exchange"):
        buf = torch.zeros((s, total), dtype=torch.uint8, device=tensors[0].device)
        for t, lo in zip(tensors, offsets):
            part = t.contiguous().reshape(-1).view(torch.uint8)
            buf[i, lo:lo + part.numel()] = part
        dist.all_reduce(buf, group=grid.spatial_group)
    nf = len(firsts)
    out_above, out_below = [], []
    for k, (t, lo) in enumerate(zip(tensors, offsets)):
        j = i + 1 if k < nf else i - 1
        got = None
        if 0 <= j < s:
            nbytes = t.numel() * t.element_size()
            got = buf[j, lo:lo + nbytes].view(t.dtype).reshape(t.shape)
        (out_below if k < nf else out_above).append(got)
    return out_above, out_below


def _filled(like: torch.Tensor, rows: int, fill) -> torch.Tensor:
    shape = (like.shape[0], rows, *like.shape[2:])
    return torch.full(shape, fill, dtype=like.dtype, device=like.device)


def boundary_rows(xs: list[torch.Tensor], fills: list, grid
                  ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """For each [N,H,...] ``x``: (top, bot) [N,1,...], the row just above
    and just below this rank's rows, ``fill`` beyond the image's edge; one
    exchange for all. ``grid`` None (or one spatial rank): the whole image,
    all fill."""
    if grid is None or grid.spatial == 1:
        return [(_filled(x, 1, f), _filled(x, 1, f)) for x, f in zip(xs, fills)]
    above, below = _exchange([x[:, :1] for x in xs], [x[:, -1:] for x in xs], grid)
    return [(_filled(x, 1, f) if a is None else a,
             _filled(x, 1, f) if b is None else b)
            for x, f, a, b in zip(xs, fills, above, below)]


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, grid):
        h = x.shape[1]
        ctx.above, ctx.below, ctx.grid = above, below, grid
        [a], [b] = _exchange([x[:, :below]], [x[:, h - above:]], grid)
        top = _filled(x, above, 0) if a is None else a
        bot = _filled(x, below, 0) if b is None else b
        return torch.cat([top, x, bot], 1)

    @staticmethod
    def backward(ctx, dy):
        above, below = ctx.above, ctx.below
        h = dy.shape[1] - above - below
        dx = dy[:, above:above + h].clone()
        # the halo rows' gradients go back to the ranks that own those rows
        [from_above], [from_below] = _exchange(
            [dy[:, :above]], [dy[:, above + h:]], ctx.grid)
        if from_above is not None:
            dx[:, :below] += from_above
        if from_below is not None:
            dx[:, h - above:] += from_below
        return dx, None, None, None


def exchange_rows(x: torch.Tensor, above: int, below: int, grid) -> torch.Tensor:
    """[N,H,...] -> [N,above+H+below,...]: the ``above`` last rows of the
    rank above and the ``below`` first rows of the rank below around this
    rank's rows (zeros beyond the image's edge). Differentiable: the
    gradient of a halo row is added to the row it came from. Raises when a
    rank holds fewer rows than a neighbour needs."""
    h = x.shape[1]
    if h < max(above, below):
        raise ValueError(f"a rank holds {h} rows of this tensor, fewer than its "
                         f"halo of {max(above, below)} rows: use fewer spatial "
                         "ranks or a taller image")
    if grid is None or grid.spatial == 1:
        return torch.cat([_filled(x, above, 0), x, _filled(x, below, 0)], 1)
    return _ExchangeRows.apply(x, above, below, grid)
