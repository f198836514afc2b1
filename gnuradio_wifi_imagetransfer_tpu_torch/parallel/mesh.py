"""Meshes of cells over the ranks of a process group (the port's copy of the
JAX package's parallel/mesh.py).

The JAX package lays a (channel, time) grid of devices out as a
``jax.sharding.Mesh``:

  * axis "channel": independent 20 MHz channels (data parallel);
  * axis "time":    time blocks of one channel's sample stream (sequence
    parallel), with a halo exchange between neighbouring blocks.

A torch rank drives one device and torch has no virtual devices, so here
a mesh is a grid of CELLS, each owned by one rank of a
``torch.distributed`` group, and one rank may own several cells:

  * ``group=None``: every cell lies on this process (one device runs the
    whole mesh, as the JAX tests run a 2 x 4 mesh on 8 virtual CPU
    devices);
  * a group of N ranks: the last axis is split first, then the one before
    it, into N equal contiguous rectangles, rank r owning the r-th in
    row-major order of the rank grid. Ranks that share a time range
    differ only in their channels, so each rank has at most one
    neighbour on either side along "time".

``make_mesh`` builds the (channel, time) mesh of the executors,
``make_data_mesh`` the 1-D ("data",) mesh of the trainer.
"""

from __future__ import annotations

import math

import numpy as np
import torch.distributed as dist


class Mesh:
    """A grid of cells named by ``shape`` ({axis: cells}), owned by the
    ranks of ``group`` (None: all on this process)."""

    def __init__(self, shape: dict[str, int], group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.group = group
        self.size = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        cells = math.prod(self.shape.values())
        if self.size > cells:
            raise ValueError(f"mesh {'x'.join(map(str, self.shape.values()))} has {cells} "
                             f"cells, fewer than the group's {self.size} ranks")
        # the rank grid: split the last axis first, then the ones before it
        parts, left = {}, self.size
        for axis in reversed(self.axis_names):
            parts[axis] = math.gcd(left, self.shape[axis])
            left //= parts[axis]
        if left != 1:
            raise ValueError(f"{self.size} ranks do not split mesh {self.shape} into equal "
                             f"contiguous rectangles")
        # cell -> owning rank
        self.ranks = np.arange(self.size).reshape(tuple(parts[a] for a in self.axis_names))
        for i, axis in enumerate(self.axis_names):
            self.ranks = np.repeat(self.ranks, self.shape[axis] // parts[axis], axis=i)

    def cells(self, rank: int) -> tuple[slice, ...]:
        """The rectangle of cells that ``rank`` owns, one slice an axis."""
        own = np.argwhere(self.ranks == rank)
        lo, hi = own.min(axis=0), own.max(axis=0) + 1
        return tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))

    @property
    def local(self) -> tuple[slice, ...]:
        """This rank's rectangle of cells."""
        return self.cells(self.rank)

    def neighbour(self, axis: str, step: int) -> int | None:
        """The rank owning the cells ``step`` (-1 or +1) beside this rank's
        rectangle along ``axis``; None at an open end of the axis or when
        those cells are this rank's own."""
        idx = [s.start for s in self.local]
        i = self.axis_names.index(axis)
        idx[i] = idx[i] - 1 if step < 0 else self.local[i].stop
        if not 0 <= idx[i] < self.shape[axis]:
            return None
        other = int(self.ranks[tuple(idx)])
        return None if other == self.rank else other


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def make_mesh(channels: int = 1, time_shards: int | None = None, group=None) -> Mesh:
    """Build a (channel, time) mesh over the ranks of ``group``.

    If time_shards is None, the time axis takes the group's ranks left
    after the channels (one time shard a rank)."""
    n = _group_size(group)
    if time_shards is None:
        if n % channels:
            raise ValueError(f"{n} ranks not divisible by {channels} channels")
        time_shards = n // channels
    return Mesh({"channel": channels, "time": time_shards}, group)


def make_data_mesh(group=None) -> Mesh:
    """Build the trainer's 1-D ("data",) mesh: the per-user batch axis is
    split into one shard a rank of ``group``."""
    return Mesh({"data": _group_size(group)}, group)
