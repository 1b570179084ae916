"""Cache layout rules and the collective audit: twin of the parts of
``repro/dist/sharding.py`` that the multi-process SWAP needs.

  * **Cache rules** -- ``cache_batch_dim`` / ``page_pool_dim``: where the
    batch (or page) dim of a KV/SSM cache leaf sits; the compiled serving
    engine scatters its per-slot rows with them.
  * **Collective audit** -- the reference proves SWAP's phase-2 property
    (workers train with no synchronization) on the compiled program's HLO
    replica groups. The port's collectives are calls it makes itself, so
    the audit records them: every collective the port issues goes through
    a ``RecordedGroup``, which appends a ``CollectiveRecord`` (the op, the
    group's global ranks, the bytes, the phase, the host seconds) to its
    ``CollectiveRecorder``. ``collective_bytes`` sums the records by op,
    and ``assert_no_cross_worker_collectives`` fails on any record whose
    group spans two workers' blocks of ranks.

Left for the model axis (ROADMAP A13c): the ambient mesh and
``logical_constraint``, the FSDP ``param_spec`` rules and
``ensemble_shardings``. One process a card holds whole tensors; nothing
in the port is sharded inside a process group yet.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import torch


def cache_batch_dim(path: str) -> int:
    """Batch dim of a cache leaf: leaves under the stacked ``units``
    subtree carry the unit axis first, so batch is dim 1."""
    return 1 if path.split("/", 1)[0] == "units" else 0


def page_pool_dim(path: str) -> Optional[int]:
    """Page dim of a paged KV-pool leaf (under a ``p`` layout key, as
    against ``a`` for a dense one), where the batch dim would be; None for
    per-slot (dense) leaves."""
    parts = path.split("/")
    if len(parts) >= 2 and parts[-2] == "p":
        return 1 if parts[0] == "units" else 0
    return None


# ---------------------------------------------------------------------------
# collective audit
# ---------------------------------------------------------------------------


class CollectiveRecord(NamedTuple):
    op: str                  # "all_reduce" | "broadcast"
    ranks: tuple             # the group's global ranks
    nbytes: int              # the tensor's bytes on this rank
    phase: str               # the recorder's phase at the call
    seconds: float           # host time of the (blocking) call


class CollectiveRecorder:
    """The records of one run's collectives. ``phase`` is set by the
    controller at each phase boundary and stamped on every record."""

    def __init__(self):
        self.records: List[CollectiveRecord] = []
        self.phase = ""


class RecordedGroup:
    """A ``torch.distributed`` process group whose every collective is
    recorded. ``pg`` None is the world group. Blocking calls, with the
    timeout the group was made with."""

    def __init__(self, pg, ranks: Sequence[int],
                 recorder: CollectiveRecorder):
        self.pg = pg
        self.ranks = tuple(ranks)
        self.recorder = recorder

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _call(self, op: str, fn, tensor: torch.Tensor) -> None:
        t0 = time.perf_counter()
        fn()
        self.recorder.records.append(CollectiveRecord(
            op, self.ranks, tensor.numel() * tensor.element_size(),
            self.recorder.phase, time.perf_counter() - t0))

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the group, in place."""
        import torch.distributed as tdist
        self._call("all_reduce",
                   lambda: tdist.all_reduce(tensor, group=self.pg), tensor)
        return tensor

    def mean_(self, tensor: torch.Tensor) -> torch.Tensor:
        """The group's mean of ``tensor``, in place: a sum, then one
        divide, so every rank holds the same bits."""
        return self.all_reduce_(tensor).div_(self.size)

    def broadcast_(self, tensor: torch.Tensor, src: int) -> torch.Tensor:
        """Global rank ``src``'s ``tensor`` to every rank, in place."""
        import torch.distributed as tdist
        self._call("broadcast",
                   lambda: tdist.broadcast(tensor, src, group=self.pg),
                   tensor)
        return tensor


def collective_bytes(records: Iterable[CollectiveRecord],
                     phase: Optional[str] = None) -> Dict[str, int]:
    """Bytes of the recorded collectives by op (one phase, if given)."""
    out: Dict[str, int] = {}
    for r in records:
        if phase is None or r.phase == phase:
            out[r.op] = out.get(r.op, 0) + r.nbytes
    return out


def assert_no_cross_worker_collectives(records: Iterable[CollectiveRecord],
                                       n_workers: int,
                                       world_size: int) -> int:
    """Assert that every recorded collective's group stays inside one
    worker block. Worker block ``w`` is the contiguous ranks
    ``[w * world_size // n_workers, (w + 1) * world_size // n_workers)``
    (the worker axis is outermost: ``dist.mesh.ProcessMesh``). This is
    the paper's phase-2 property, checked on what the port issued; pass
    phase 2's records. Raises AssertionError explicitly (not a bare
    ``assert``) so that it holds under ``python -O``. Returns the number
    of records checked."""
    if world_size % n_workers:
        raise ValueError(f"{world_size} ranks do not split into "
                         f"{n_workers} worker blocks")
    per = world_size // n_workers
    n = 0
    for r in records:
        owners = {rank // per for rank in r.ranks}
        if len(owners) > 1:
            raise AssertionError(
                f"{r.op} over ranks {list(r.ranks)} in {r.phase or 'a run'} "
                f"spans workers {sorted(owners)} (n_workers={n_workers}, "
                f"{per} ranks a worker): SWAP phase-2 workers must not "
                f"synchronize")
        n += 1
    return n
