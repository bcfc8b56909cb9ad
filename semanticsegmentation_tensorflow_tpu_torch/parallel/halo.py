"""Row halo exchange for height-partitioned images (no JAX counterpart: on
the TPU, XLA's SPMD partitioner inserted these exchanges itself).

Each rank of a grid's spatial group holds a band of rows of the same images
(``parallel/mesh.py``). A conv with a k-row window needs (k-1)/2 rows of
its neighbours, dilation included. Every exchange here is one
``all_reduce(SUM)`` over the spatial group: each rank writes its boundary
rows into its own slot of a zeroed byte buffer, and since a value plus
zeros is itself, the sum moves the bits exactly, for any dtype (``-inf``
and u8 codes included), and leaves every rank's rows in every rank's
buffer. The byte view keeps the reduction an integer one on every backend
(NCCL, and gloo on CPU or CUDA tensors, which takes ``broadcast`` and
``all_reduce`` only).

* :func:`boundary_rows`: the one row above and below this rank's rows of
  several tensors, no gradient (the fused stage1's halos);
* :func:`exchange_rows`: ``above`` rows on top and ``below`` rows under a
  tensor, differentiable (the convs); a halo taller than one rank's rows
  takes rows from every rank within reach (DeepLab's dilated convs on a
  grid). Its backward sends the halo rows' gradients back to their owners,
  where they are added;
* :func:`spatial_sum`: a tensor summed over the spatial group, forward and
  backward (the image-level mean of DeepLab's ASPP).

Rows beyond the image's edge get ``fill`` (zero for the convs: their SAME
padding).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_slots(tensors: list[torch.Tensor], grid) -> list[list[torch.Tensor]]:
    """Every rank of the spatial group writes ``tensors`` (the same shapes
    on every rank) into its slot of one buffer; one SUM gives each rank all
    slots. Returns ``parts[k][j]``, tensor k of rank j."""
    s, i = grid.spatial, grid.spatial_index
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
    return [[buf[j, lo:lo + t.numel() * t.element_size()].view(t.dtype)
             .reshape(t.shape) for j in range(s)]
            for t, lo in zip(tensors, offsets)]


def _exchange(firsts: list[torch.Tensor], lasts: list[torch.Tensor], grid
              ) -> tuple[list, list]:
    """Each rank i sends ``firsts`` to rank i-1 and ``lasts`` to rank i+1 of
    its spatial group. Returns (the ``lasts`` of rank i-1, the ``firsts``
    of rank i+1), each entry None at the image's edge."""
    s, i = grid.spatial, grid.spatial_index
    parts = _all_slots(firsts + lasts, grid)
    nf = len(firsts)
    return ([p[i - 1] if i > 0 else None for p in parts[nf:]],
            [p[i + 1] if i < s - 1 else None for p in parts[:nf]])


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


def _halo(parts: list[torch.Tensor], i: int, rows: int, up: bool) -> torch.Tensor:
    """The ``rows`` rows just above (``up``) or below rank ``i``'s rows, from
    ``parts[j]``: the last (up) or first rows of rank j that it sent (all of
    its rows when the halo is taller than a rank's rows); zeros beyond the
    image's edge."""
    k = -(-rows // parts[0].shape[1])        # ranks within reach
    js = range(i - k, i) if up else range(i + 1, i + 1 + k)
    pieces = [parts[j] if 0 <= j < len(parts) else torch.zeros_like(parts[0])
              for j in js]
    cat = torch.cat(pieces, 1)
    return cat[:, cat.shape[1] - rows:] if up else cat[:, :rows]


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, grid):
        h, i = x.shape[1], grid.spatial_index
        ctx.above, ctx.below, ctx.grid = above, below, grid
        lasts, firsts = _all_slots([x[:, h - min(above, h):],
                                    x[:, :min(below, h)]], grid)
        pieces = [x]
        if above:
            pieces.insert(0, _halo(lasts, i, above, up=True))
        if below:
            pieces.append(_halo(firsts, i, below, up=False))
        return torch.cat(pieces, 1)

    @staticmethod
    def backward(ctx, dy):
        above, below, grid = ctx.above, ctx.below, ctx.grid
        h = dy.shape[1] - above - below
        i = grid.spatial_index
        dx = dy[:, above:above + h].clone()
        # the halo rows' gradients go back to the ranks that own those rows:
        # rank j's top halo holds global rows [j*h - above, j*h), its bottom
        # halo [(j+1)*h, (j+1)*h + below); this rank owns [i*h, (i+1)*h)
        tops, bots = _all_slots([dy[:, :above], dy[:, above + h:]], grid)
        for j in range(grid.spatial):
            if j == i:
                continue
            for part, start in ((tops[j], j * h - above), (bots[j], (j + 1) * h)):
                lo = max(start, i * h)
                hi = min(start + part.shape[1], (i + 1) * h)
                if lo < hi:
                    dx[:, lo - i * h:hi - i * h] += part[:, lo - start:hi - start]
        return dx, None, None, None


def exchange_rows(x: torch.Tensor, above: int, below: int, grid) -> torch.Tensor:
    """[N,H,...] -> [N,above+H+below,...]: the ``above`` rows of the image
    just above this rank's rows and the ``below`` rows just under them, from
    the ranks that hold them (a halo taller than H reaches past the next
    rank), zeros beyond the image's edge. Differentiable: the gradient of a
    halo row is added to the row it came from."""
    if grid is None or grid.spatial == 1:
        return torch.cat([_filled(x, above, 0), x, _filled(x, below, 0)], 1)
    return _ExchangeRows.apply(x, above, below, grid)


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        y = x.clone()
        with torch.profiler.record_function("spatial_sum"):
            dist.all_reduce(y, group=grid.spatial_group)
        return y

    @staticmethod
    def backward(ctx, dy):
        # every rank's loss reads the sum: each rank's input gets the sum of
        # the ranks' gradients of it
        g = dy.clone()
        with torch.profiler.record_function("spatial_sum"):
            dist.all_reduce(g, group=ctx.grid.spatial_group)
        return g, None


def spatial_sum(x: torch.Tensor, grid) -> torch.Tensor:
    """``x`` summed over the ranks of ``grid``'s spatial group (the same
    images, the other rows), on every rank; differentiable (the backward
    sums the gradients the same way). ``x`` itself with no grid or one
    spatial rank."""
    if grid is None or grid.spatial == 1:
        return x
    return _SpatialSum.apply(x, grid)
