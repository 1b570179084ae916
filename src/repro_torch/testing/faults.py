"""Deterministic fault injection for the resilience layer: twin of
``repro/testing/faults.py``.

Every fault the train -> average -> publish -> serve pipeline must survive
is scripted here -- a worker's death at a chosen step, a straggler's
delay, a checkpoint's damaged bytes, a NaN step, failed publish
deliveries -- and driven by a ``FakeClock`` instead of wall time, so that
a faulted run repeats bit for bit and nothing waits on a sleep.

Injection seams (all production surfaces; none is a test-only hook in the
trained path):

  * ``FaultPlan.chunk_filter`` -- ``PhaseSupervisor.run_phase``'s
    ``chunk_filter`` (``SWAP.run(phase2_chunk_filter=)``): poisons the
    state a chunk surfaced, where damage from outside would show;
  * ``FaultPlan.beat_hook`` -- a phase-2 ``on_chunk`` hook that beats the
    writers of the workers still scripted alive, so that the
    ``HeartbeatMonitor`` (on the plan's clock) declares a death from real
    beacon staleness;
  * ``corrupt_latest_checkpoint`` / ``truncate_sidecar`` -- damage on disk
    that ``verify_snapshot`` and ``read_meta`` exist to catch;
  * ``FaultPlan.failing_engine`` -- an engine whose ``publish`` raises
    for the first N deliveries, for ``WeightPublisher``'s retry budget.

The NaN is injected once, on the host side of a chunk and out of place
(new NaN tensors in a new params tree; the runner's buffers are not
written): a fault inside the step would recur on the supervisor's replay
and, rightly, spend the retry budget, where a transient one must not.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint.state import _TAG_ORDER, list_checkpoints
from repro_torch.optim.api import tree_map


class FakeClock:
    """A callable monotonic clock that the test advances by hand: stands
    in for ``time.monotonic`` wherever a clock is injectable
    (``HeartbeatWriter``, ``HeartbeatMonitor``, ``CompiledServingEngine``,
    ``FaultPlan``)."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"a monotonic clock cannot rewind ({dt})")
        self.t += float(dt)
        return self.t


class FaultPlan:
    """A scripted schedule of faults, built fluently::

        plan = (FaultPlan()
                .kill_worker(2, at_step=4)     # its beacon goes silent
                .delay_worker(1, by_s=5.0)     # a straggler's arrival
                .nan_at_step(6)                # one-shot poison
                .fail_publishes(2))            # the first 2 deliveries raise

    A fault stays inert until its seam fires, so one plan can carry a
    whole scenario."""

    def __init__(self, clock: Optional[FakeClock] = None):
        self.clock = clock if clock is not None else FakeClock()
        self.deaths: Dict[int, int] = {}      # worker id -> death step
        self.delays: Dict[int, float] = {}    # worker id -> arrival delay s
        self.nan_step: Optional[int] = None
        self.publish_failures = 0
        self._nan_fired = False
        self._publish_attempts = 0

    # -- the schedule ---------------------------------------------------

    def kill_worker(self, worker: int, at_step: int) -> "FaultPlan":
        """Worker ``worker`` stops beating once its step reaches
        ``at_step`` (the death shows at the next chunk boundary)."""
        self.deaths[int(worker)] = int(at_step)
        return self

    def delay_worker(self, worker: int, by_s: float) -> "FaultPlan":
        """Worker ``worker`` reports ``by_s`` seconds late to the phase-3
        average (alive, straggling)."""
        self.delays[int(worker)] = float(by_s)
        return self

    def nan_at_step(self, step: int) -> "FaultPlan":
        """Poison the surfaced parameters with NaN at the first chunk
        boundary whose step is >= ``step``, once (a transient fault)."""
        self.nan_step = int(step)
        return self

    def fail_publishes(self, n: int = 1) -> "FaultPlan":
        """The first ``n`` deliveries to ``failing_engine`` raise."""
        self.publish_failures = int(n)
        return self

    # -- seam: the supervisor's chunk_filter ----------------------------

    def chunk_filter(self, state, metrics):
        """One-shot NaN poison of every floating param leaf of the state a
        chunk surfaced: new tensors (``torch.full_like``) in a new params
        tree, so the runner's buffers stay as the chunk left them and the
        supervisor's replay runs clean."""
        if self.nan_step is None or self._nan_fired:
            return state, metrics
        step = int(state.step.reshape(-1)[0])
        if step < self.nan_step:
            return state, metrics
        self._nan_fired = True

        def poison(leaf):
            if leaf.is_floating_point() or leaf.is_complex():
                return torch.full_like(leaf, float("nan"))
            return leaf

        params = tree_map(poison, state.bundle["params"])
        return state._replace(bundle=dict(state.bundle,
                                          params=params)), metrics

    # -- seam: a phase-2 chunk hook (heartbeats) ------------------------

    def beat_hook(self, writers: Sequence[Any], chunk_wall_s: float = 1.0):
        """An ``on_chunk`` hook that advances the plan's clock by
        ``chunk_wall_s`` a chunk and beats every writer whose worker is
        still scripted alive: a killed worker's beacon stops, and the
        monitor (on ``self.clock``) times it out."""
        def hook(state, done):
            self.clock.advance(chunk_wall_s)
            step = int(state.step.reshape(-1)[0])
            for w in writers:
                death = self.deaths.get(w.worker)
                if death is not None and step >= death:
                    continue
                w.maybe_beat(step=step)
        return hook

    # -- seam: phase-3 simulated arrivals -------------------------------

    def apply_delays(self, arrivals: Sequence[float],
                     worker_ids: Optional[Sequence[int]] = None
                     ) -> List[float]:
        """Add the scripted straggler delays to arrivals aligned with
        ``worker_ids`` (default 0..n-1)."""
        ids = (list(range(len(arrivals))) if worker_ids is None
               else [int(w) for w in worker_ids])
        return [a + self.delays.get(w, 0.0) for a, w in zip(arrivals, ids)]

    # -- seam: publish delivery -----------------------------------------

    def failing_engine(self, inner: Optional[Any] = None) -> "FlakyEngine":
        """A serving-engine stand-in bound to this plan's failure budget."""
        return FlakyEngine(self, inner)


class FlakyEngine:
    """Quacks like ``CompiledServingEngine`` for ``WeightPublisher``:
    ``publish`` raises for the plan's first ``publish_failures``
    deliveries, then hands on to ``inner`` (or accepts outright)."""

    def __init__(self, plan: FaultPlan, inner: Optional[Any] = None):
        self.plan = plan
        self.inner = inner
        self.delivered: List[int] = []        # generations that landed

    def publish(self, params, generation: int):
        self.plan._publish_attempts += 1
        if self.plan._publish_attempts <= self.plan.publish_failures:
            raise RuntimeError(
                f"injected publish failure "
                f"{self.plan._publish_attempts}/{self.plan.publish_failures}")
        if self.inner is not None:
            out = self.inner.publish(params, generation=generation)
        else:
            out = True
        if out is not None:
            self.delivered.append(int(generation))
        return out


def corrupt_latest_checkpoint(directory: str, tag: Optional[str] = None,
                              mode: str = "flip") -> str:
    """Damage the newest snapshot on disk (the highest resume priority,
    then step: the one ``find_resume_point`` would pick if it verified).

    ``mode="flip"`` xors one byte mid-file (bit rot: the payload still
    unpacks, only the checksum shows it); ``mode="truncate"`` halves the
    file (a torn copy). Returns the damaged path."""
    ckpts = [c for c in list_checkpoints(directory)
             if tag is None or c["tag"] == tag]
    if not ckpts:
        raise ValueError(f"no checkpoints in {directory!r} to corrupt")
    victim = max(ckpts, key=lambda c: (_TAG_ORDER[c["tag"]], c["step"]))
    path = victim["path"]
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if mode == "flip":
        data[len(data) // 2] ^= 0xFF
    elif mode == "truncate":
        data = data[:len(data) // 2]
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path


def truncate_sidecar(path: str, keep_bytes: int = 10) -> str:
    """Cut a snapshot's JSON sidecar mid-object (a write killed midway,
    or disk damage, which ``read_meta`` must survive). Returns the
    sidecar's path."""
    sidecar = path + ".json"
    with open(sidecar, "rb") as f:
        data = f.read()
    if not len(data) > keep_bytes:
        raise ValueError(f"sidecar {sidecar} too small to truncate")
    with open(sidecar, "wb") as f:
        f.write(data[:keep_bytes])
    return sidecar
