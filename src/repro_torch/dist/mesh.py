"""The runtime process layout: the port's counterpart of the
``jax.sharding.Mesh`` that the reference's ``DistConfig.make_mesh`` builds.

The port runs one process a card and lays the mesh axes over the processes
of a ``torch.distributed`` run: a ``ProcessMesh`` maps rank r to its
coordinates in row-major order, the worker axis outermost, so that worker
block b is the contiguous ranks ``[b * block_size, (b + 1) * block_size)``
(the reference's ``make_mesh`` rule). Phase 1 is data parallel over every
rank; in phase 2 each block trains its own workers, data parallel over
the block's ranks (the ``data`` axis) and with no collective outside it.
The production layouts over the processes that exist are in
``repro_torch.launch.mesh``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a
    ``torch.distributed`` run."""
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


class ProcessMesh:
    """Axes of named sizes over ``prod(shape)`` ranks (the reference's
    ``jax.sharding.Mesh``, with processes for devices). ``shape`` maps an
    axis to its size and ``axis_names`` lists the axes, as on a jax mesh.
    An axis that is not named has size 1."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} must have equal rank")
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated mesh axis in {tuple(axes)}")
        if any(int(s) < 1 for s in shape):
            raise ValueError(f"mesh sizes must be >= 1, got {tuple(shape)}")
        self.axis_names = tuple(axes)
        self.shape = {a: int(s) for a, s in zip(axes, shape)}
        self.size = int(np.prod([int(s) for s in shape], dtype=np.int64))

    def __repr__(self) -> str:
        return ("ProcessMesh(" + ",".join(f"{a}:{s}" for a, s in
                                          self.shape.items()) + ")")

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def n_blocks(self) -> int:
        """Worker blocks: the size of the worker axis times any pod axis
        before it."""
        return self.axis_size("pod") * self.axis_size("worker")

    @property
    def block_size(self) -> int:
        """Ranks a worker block holds (its data and model axes)."""
        return self.size // self.n_blocks

    def block_of(self, rank: int) -> int:
        return rank // self.block_size

    def block_ranks(self, block: int) -> List[int]:
        """The contiguous ranks of worker block ``block``."""
        return list(range(block * self.block_size,
                          (block + 1) * self.block_size))

    def data_index(self, rank: int) -> int:
        """The rank's position inside its block (its phase-2 data shard;
        the port has no model axis yet)."""
        return rank % self.block_size

    def owned_workers(self, rank: int, n_workers: int) -> List[int]:
        """The global worker indices that ``rank``'s block trains: block b
        owns the contiguous ``n_workers // n_blocks`` from
        ``b * n_workers // n_blocks`` (the reference shards the stacked W
        axis over the worker axis the same way)."""
        if n_workers % self.n_blocks:
            raise ValueError(
                f"{n_workers} workers do not split over {self.n_blocks} "
                f"worker blocks of {self}")
        per = n_workers // self.n_blocks
        b = self.block_of(rank)
        return list(range(b * per, (b + 1) * per))

    def owner(self, worker: int, n_workers: int) -> int:
        """The first rank of the block that trains ``worker``: the source
        of its phase-3 broadcasts."""
        return worker // (n_workers // self.n_blocks) * self.block_size

    def block_groups(self) -> List[Optional[object]]:
        """One ``torch.distributed`` group a worker block, in block order
        (None for every block of one rank: it needs no collective).
        ``new_group`` is collective over the whole world, so every rank
        must call this at the same point."""
        if self.block_size == 1:
            return [None] * self.n_blocks
        import torch.distributed as tdist
        return [tdist.new_group(self.block_ranks(b))
                for b in range(self.n_blocks)]
