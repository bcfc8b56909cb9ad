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
padding). The ranks may hold different numbers of rows (``Grid.at_height``
records the uneven split of a height, ``Grid.level_splits`` gives every
rank's rows at any resolution); the exchange sizes each slot for the
largest rank's part and walks the ranks by their own rows.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from semanticsegmentation_tensorflow_tpu_torch.utils import tracing


def _all_slots(tensors: list[torch.Tensor], grid, shapes=None
               ) -> list[list[torch.Tensor]]:
    """Every rank of the spatial group writes ``tensors`` into its slot of
    one buffer; one SUM gives each rank all slots. ``shapes[k][j]``: the
    shape of tensor k on rank j (default: this rank's shape on every rank);
    each slot is sized for the largest rank's parts. Returns ``parts[k][j]``,
    tensor k of rank j at its own shape."""
    s, i = grid.spatial, grid.spatial_index
    if shapes is None:
        shapes = [[t.shape] * s for t in tensors]
    # byte offsets of the parts in a slot, 16-aligned so that each part
    # views back as its dtype
    offsets, sizes, total = [], [], 0
    for t, shs in zip(tensors, shapes):
        nbytes = [math.prod(sh) * t.element_size() for sh in shs]
        offsets.append(total)
        sizes.append(nbytes)
        total += -(-max(nbytes) // 16) * 16
    with tracing.span("halo_exchange"):
        buf = torch.zeros((s, total), dtype=torch.uint8, device=tensors[0].device)
        for t, lo in zip(tensors, offsets):
            part = t.contiguous().reshape(-1).view(torch.uint8)
            buf[i, lo:lo + part.numel()] = part
        dist.all_reduce(buf, group=grid.spatial_group)
    return [[buf[j, lo:lo + n[j]].view(t.dtype).reshape(shs[j]) for j in range(s)]
            for t, lo, n, shs in zip(tensors, offsets, sizes, shapes)]


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
    its rows when the halo is taller than a rank's rows), walking the ranks
    outward by their own row counts; zeros beyond the image's edge."""
    pieces, got, j = [], 0, i
    while got < rows:
        j += -1 if up else 1
        if 0 <= j < len(parts):
            p = parts[j]
        else:
            like = parts[i]
            p = like.new_zeros((like.shape[0], rows - got, *like.shape[2:]))
        pieces.append(p)
        got += p.shape[1]
    if up:
        cat = torch.cat(pieces[::-1], 1)
        return cat[:, cat.shape[1] - rows:]
    return torch.cat(pieces, 1)[:, :rows]


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, grid):
        i = grid.spatial_index
        splits = grid.level_splits(x.shape[1])
        ctx.above, ctx.below, ctx.grid, ctx.splits = above, below, grid, splits
        h = x.shape[1]
        shapes = [[(x.shape[0], min(n, r), *x.shape[2:]) for _, r in splits]
                  for n in (above, below)]
        lasts, firsts = _all_slots([x[:, h - min(above, h):],
                                    x[:, :min(below, h)]], grid, shapes)
        pieces = [x]
        if above:
            pieces.insert(0, _halo(lasts, i, above, up=True))
        if below:
            pieces.append(_halo(firsts, i, below, up=False))
        return torch.cat(pieces, 1)

    @staticmethod
    def backward(ctx, dy):
        above, below, grid, splits = ctx.above, ctx.below, ctx.grid, ctx.splits
        i = grid.spatial_index
        lo_i, h = splits[i]
        dx = dy[:, above:above + h].clone()
        # the halo rows' gradients go back to the ranks that own those rows:
        # rank j's top halo holds global rows [s_j - above, s_j), its bottom
        # halo [s_j + h_j, s_j + h_j + below); this rank owns [s_i, s_i + h)
        tops, bots = _all_slots([dy[:, :above], dy[:, above + h:]], grid)
        for j, (s_j, h_j) in enumerate(splits):
            if j == i:
                continue
            for part, start in ((tops[j], s_j - above), (bots[j], s_j + h_j)):
                lo = max(start, lo_i)
                hi = min(start + part.shape[1], lo_i + h)
                if lo < hi:
                    dx[:, lo - lo_i:hi - lo_i] += part[:, lo - start:hi - start]
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
        dist.all_reduce(y, group=grid.spatial_group)
        return y

    @staticmethod
    def backward(ctx, dy):
        # every rank's loss reads the sum: each rank's input gets the sum of
        # the ranks' gradients of it
        g = dy.clone()
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
