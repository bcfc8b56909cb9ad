"""The grid of ranks (counterpart of the JAX package's ``parallel/mesh.py``).

One process per GPU. A ``data x spatial`` grid shards the batch over
``data`` and each image's HEIGHT over ``spatial``: rank r sits at
(r // spatial, r % spatial), as the JAX package's
``devices.reshape(data, spatial)`` does. The ranks of one row of the grid
(one data index) hold the same images and exchange halo rows
(``parallel/halo.py``); the gradients, the loss sums and the confusion
matrix are summed over the whole world (``train/step.py``). ``make_grid(world,
1)`` is the 1-D data-parallel mesh.

While a train step runs, the grid is the *active* one (:func:`use_grid`):
the convs (``ops/conv.py:conv_nhwc``), the transposed convs, dropout,
the augment and the fused stage1 read it from :func:`current_grid`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a ``data x spatial`` grid and its two groups:
    ``spatial_group`` (the ranks with this data index: same images, other
    rows) and ``data_group`` (the ranks with this spatial index: same rows,
    other images). Groups are None where the grid has a single rank."""

    data: int
    spatial: int
    rank: int
    spatial_group: Any = None
    data_group: Any = None
    blocks: tuple[int, ...] | None = None

    @property
    def world(self) -> int:
        return self.data * self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def images(self, n_global: int) -> slice:
        """This rank's images of a global batch (the counterpart of
        ``batch_spec``'s ``data`` axis)."""
        if n_global % self.data:
            raise ValueError(f"batch {n_global} does not divide over "
                             f"data={self.data} ranks")
        k = n_global // self.data
        return slice(self.data_index * k, (self.data_index + 1) * k)

    def row_splits(self, h_global: int, stride: int = 1) -> list[tuple[int, int]]:
        """Every spatial rank's ``(start, rows)`` of a global image height:
        the height cut into blocks of ``stride`` rows (the model's total
        stride), the first ``blocks % spatial`` ranks one block more than
        the others (the split the JAX partitioner makes of a height that
        does not divide). Rank boundaries fall on stride multiples, so no
        pool window straddles two ranks. Raises as :func:`check_rows`."""
        check_rows(h_global, self.spatial, stride)
        q, r = divmod(h_global // stride, self.spatial)
        out, start = [], 0
        for j in range(self.spatial):
            rows = (q + (j < r)) * stride
            out.append((start, rows))
            start += rows
        return out

    def rows(self, h_global: int, stride: int = 1) -> slice:
        """This rank's rows of a global image height (``spatial`` axis), as
        :meth:`row_splits` deals them."""
        start, rows = self.row_splits(h_global, stride)[self.spatial_index]
        return slice(start, start + rows)

    def at_height(self, h_global: int, stride: int) -> Grid:
        """This grid with the row split of ``h_global`` at ``stride``
        (:meth:`row_splits`) recorded, so that the halo exchange, dropout
        and the image-wide sums of a step know every rank's rows at any
        resolution without a message. A grid without it splits evenly."""
        blocks = tuple(rows // stride for _, rows in self.row_splits(h_global, stride))
        return dataclasses.replace(self, blocks=blocks)

    def level_splits(self, rows: int) -> list[tuple[int, int]]:
        """Every spatial rank's ``(start, rows)`` at the resolution where
        this rank holds ``rows`` rows: each rank's share of the recorded
        blocks (:meth:`at_height`), or ``rows`` each without them."""
        if self.blocks is None:
            counts = [rows] * self.spatial
        else:
            mine = self.blocks[self.spatial_index]
            if rows % mine:
                raise ValueError(f"{rows} rows do not split into this rank's "
                                 f"{mine} stride blocks")
            counts = [b * (rows // mine) for b in self.blocks]
        starts = [sum(counts[:j]) for j in range(self.spatial)]
        return list(zip(starts, counts))


def make_grid(data: int, spatial: int = 1) -> Grid:
    """The ``data x spatial`` grid over the default process group (the
    counterpart of ``make_mesh_2d``; ``make_grid(world, 1)`` is
    ``make_mesh``). Every rank must call it, in the same order as any other
    group creation. Without a process group the world is one rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data < 1 or spatial < 1 or data * spatial != world:
        raise ValueError(f"mesh {data}x{spatial} != {world} devices")
    rank = dist.get_rank() if dist.is_initialized() else 0
    spatial_group = data_group = None
    if world > 1:
        for d in range(data):       # new_group is collective: every rank, in order
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == rank // spatial:
                spatial_group = g
        for s in range(spatial):
            g = dist.new_group(list(range(s, world, spatial)))
            if s == rank % spatial:
                data_group = g
    return Grid(data, spatial, rank, spatial_group, data_group)


def zero1_spec(param, grid: Grid, transposed: bool = False) -> int | None:
    """The axis along which ZeRO-1 shards ``param``'s optimizer state over
    the grid's data ranks, or None where it stays replicated (the
    counterpart of the JAX ``zero1_spec``). JAX shards a leaf's last axis,
    which in flax's layouts is the output-channel axis; here that is dim 0
    of an OIHW conv weight and of a bias or BatchNorm vector, dim 1 of a
    transposed conv's [Cin, Cout, kh, kw] weight (``transposed``). As
    there, the axis shards when it is at least ``grid.data`` long and
    divides by it; a 0-d leaf stays replicated."""
    if param.dim() == 0:
        return None
    axis = 1 if transposed and param.dim() == 4 else 0
    size, n = param.shape[axis], grid.data
    return axis if size >= n and size % n == 0 else None


def check_rows(h: int, spatial: int, stride: int = 32) -> None:
    """Raise unless a padded image height ``h`` divides into blocks of the
    model's total ``stride``, at least one for each of ``spatial`` ranks
    (:meth:`Grid.row_splits` deals them out, unevenly where they do not
    divide)."""
    if spatial < 1 or h % stride or h // stride < spatial:
        raise ValueError(f"--spatial {spatial}: the padded height {h} must divide "
                         f"by the model's stride {stride} into at least {spatial} "
                         f"blocks of rows, one for each spatial rank (it holds "
                         f"{h / stride:g})")


_ACTIVE: list[Grid] = []


@contextlib.contextmanager
def use_grid(grid: Grid | None) -> Iterator[None]:
    """Make ``grid`` the active grid for the enclosed forward and backward
    (None: no grid). A module-level stack, not thread-local: autograd runs
    a CUDA backward on its own thread, and the Functions that need the grid
    there keep it from their forward anyway."""
    _ACTIVE.append(grid)
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_grid() -> Grid | None:
    """The active grid, or None outside :func:`use_grid`."""
    return _ACTIVE[-1] if _ACTIVE else None


def spatial_grid() -> Grid | None:
    """The active grid if it splits images over more than one rank."""
    g = current_grid()
    return g if g is not None and g.spatial > 1 else None
