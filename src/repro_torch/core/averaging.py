"""Phase 3: weight averaging and batch-norm statistic recomputation.

Twin of ``repro/core/averaging.py`` (Algorithm 1, lines 27-28 of the
paper: average the W models, recompute BN statistics):

  * ``average_stacked`` -- mean over the leading worker axis;
  * ``StreamingAverage`` -- running mean folding one model at a time (the
    SWA baseline and the elastic phase 3), on the hand-written swa_avg
    kernel for CUDA tensors;
  * ``ElasticAverage`` -- the deadline-gated elastic variant: the average
    folds whichever workers report within a deadline, with a straggler
    backoff while fewer than ``min_workers`` reported.

``StreamingAverage`` keeps one f32 accumulator, a copy it owns, and folds
each new model into it in place; ``value()`` returns that accumulator.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.swa_avg import running_average_tree
from repro_torch.optim.api import tree_leaves, tree_map


def average_stacked(stacked_params):
    """Mean over the leading (worker) axis of every leaf."""
    return tree_map(lambda a: a.mean(dim=0), stacked_params)


def average_list(params_list):
    return average_stacked(tree_map(lambda *xs: torch.stack(xs),
                                    *params_list))


class StreamingAverage:
    """Running mean of parameter trees. ``impl`` follows
    ``repro_torch.kernels.dispatch``: "auto" gives the swa_avg kernel for
    CUDA tensors and the plain version for CPU tensors."""

    def __init__(self, impl: str = "auto"):
        self.impl = dispatch.validate_impl(impl, "StreamingAverage.impl")
        self.n = 0
        self.avg = None

    @torch.no_grad()
    def add(self, params):
        if self.avg is None:
            # a copy in f32: the caller's tensors go on training
            self.avg = tree_map(
                lambda a: a.detach().to(torch.float32, copy=True), params)
        else:
            # cast to the accumulator dtype before folding, as the
            # reference does, so every path sees the same operand dtypes
            w = tree_map(lambda a, acc: a.detach().to(acc.dtype), params,
                         self.avg)
            running_average_tree(self.avg, w, float(self.n), impl=self.impl,
                                 inplace=True)
        self.n += 1
        return self.avg

    def value(self):
        if self.avg is None:
            raise ValueError("no models folded in yet")
        return self.avg


class ElasticAverageError(RuntimeError):
    """No usable elastic average: fewer than ``min_workers`` workers
    reported within the fully backed-off deadline."""


class ElasticAverage:
    """Deadline-gated elastic phase-3 averaging with online partial folds.

    Each worker ``submit``s its parameters with its arrival time; reports
    within the current deadline fold at once into a ``StreamingAverage``,
    the liveness ``mask`` records who made it, and while fewer than
    ``min_workers`` reported a late report extends the deadline by
    ``backoff`` (at most ``max_extensions`` times). ``value()`` returns
    (avg_params, mask), or raises ``ElasticAverageError`` below quorum.
    ``collect(reports)`` runs a whole round from (worker, params, arrival)
    tuples, in arrival order."""

    def __init__(self, n_workers: int, deadline_s: float, *,
                 backoff: float = 2.0, max_extensions: int = 2,
                 min_workers: int = 1, impl: str = "auto"):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if deadline_s <= 0:
            raise ValueError("ElasticAverage needs deadline_s > 0 (use "
                             "average_stacked for the strict barrier)")
        if backoff < 1.0:
            raise ValueError("backoff must be >= 1 (deadlines never shrink)")
        if not (1 <= min_workers <= n_workers):
            raise ValueError(f"min_workers must be in [1, {n_workers}], "
                             f"got {min_workers}")
        self.n_workers = n_workers
        self.deadline_s = float(deadline_s)
        self.backoff = float(backoff)
        self.max_extensions = int(max_extensions)
        self.min_workers = int(min_workers)
        self.mask = np.zeros(n_workers, dtype=bool)
        self.extensions_used = 0
        self.stragglers: List[Tuple[int, float]] = []
        self._stream = StreamingAverage(impl)

    @property
    def deadline(self) -> float:
        return self.deadline_s * self.backoff ** self.extensions_used

    @property
    def n_live(self) -> int:
        return int(self.mask.sum())

    def extend(self) -> bool:
        """Back off the deadline once; False when extensions are spent."""
        if self.extensions_used >= self.max_extensions:
            return False
        self.extensions_used += 1
        return True

    def submit(self, worker: int, params, arrival_s: float) -> bool:
        """Fold one worker's report if it beat the current deadline; a
        late one is recorded as a straggler and not held."""
        if not (0 <= worker < self.n_workers):
            raise ValueError(f"worker {worker} out of range "
                             f"[0, {self.n_workers})")
        if self.mask[worker]:
            raise ValueError(f"worker {worker} already reported this round")
        if arrival_s > self.deadline:
            self.stragglers.append((worker, float(arrival_s)))
            return False
        self._stream.add(params)
        self.mask[worker] = True
        return True

    def value(self):
        if self.n_live < self.min_workers:
            raise ElasticAverageError(
                f"elastic average has {self.n_live}/{self.n_workers} "
                f"workers after {self.extensions_used} deadline "
                f"extension(s) (deadline {self.deadline:g}s, quorum "
                f"{self.min_workers}); stragglers: "
                f"{[(w, round(t, 3)) for w, t in self.stragglers]}")
        return self._stream.value(), self.mask.copy()

    def collect(self, reports: Iterable[Tuple[int, object, float]]):
        for worker, params, arrival in sorted(reports, key=lambda r: r[2]):
            while (arrival > self.deadline
                   and self.n_live < self.min_workers and self.extend()):
                pass
            self.submit(worker, params, arrival)
        return self.value()


def elastic_average_stacked(stacked_params, dist, worker_arrivals=None,
                            impl: str = "auto"):
    """Elastic phase-3 average of a stacked parameter tree under ``dist``'s
    elastic knobs. ``worker_arrivals``: each worker's report time in
    seconds (None = all at once; ``float('inf')`` = lost). Returns
    (avg_params, liveness_mask)."""
    n = int(tree_leaves(stacked_params)[0].shape[0])
    if worker_arrivals is None:
        worker_arrivals = [0.0] * n
    if len(worker_arrivals) != n:
        raise ValueError(f"worker_arrivals has {len(worker_arrivals)} "
                         f"entries for {n} workers")
    ea = ElasticAverage(
        n, dist.elastic_deadline_s, backoff=dist.elastic_backoff,
        max_extensions=dist.elastic_max_extensions,
        min_workers=dist.elastic_min_workers, impl=impl)
    return ea.collect(
        (w, tree_map(lambda a: a[w], stacked_params),
         float(worker_arrivals[w]))
        for w in range(n) if not np.isinf(worker_arrivals[w]))


def _batch_count(batch) -> int:
    for leaf in tree_leaves(batch):
        if getattr(leaf, "ndim", 0) >= 1:
            return int(leaf.shape[0])
    raise ValueError("cannot infer batch size: batch has no array leaves")


@torch.no_grad()
def recompute_bn_stats(batch_stats_fn: Callable, params,
                       batches: Iterable) -> dict:
    """Fresh BN running statistics for averaged weights from one pass over
    training data, weighted by batch size. Raises on an empty pass."""
    acc, total = None, 0
    for batch in batches:
        stats = batch_stats_fn(params, batch)
        bs = _batch_count(batch)
        weighted = tree_map(lambda x: x * float(bs), stats)
        acc = weighted if acc is None else tree_map(torch.add, acc, weighted)
        total += bs
    if acc is None:
        raise ValueError(
            "recompute_bn_stats received no batches — BN statistics need at "
            "least one pass batch (was the loader empty?)")
    return tree_map(lambda x: x / total, acc)
