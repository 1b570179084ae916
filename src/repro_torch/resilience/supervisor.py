"""Supervised phase execution: bounded retry, divergence rollback and
dead-worker recovery for ``run_phase`` / ``SWAP.run``. Twin of
``repro/resilience/supervisor.py``.

State machine (per ``PhaseSupervisor.run_phase`` call)::

    RUN ──ok──────────────────────────────▶ DONE
     │
     ├─ guard trips (nonfinite loss/EMA/params, loss above the
     │  configured bar)                       → DivergenceError
     ├─ liveness trips (a current worker's heartbeat went stale,
     │  checked at every chunk boundary)      → WorkerLostError
     ▼
    attempt += 1 ── attempt > max_retries ──▶ FAIL (SupervisorError)
     │
     ▼
    BACKOFF  sleep(backoff_s * factor**(attempt-1))   (injectable sleep)
     ▼
    RESTORE  newest *verified* checkpoint for the tag (else the phase's
             initial state), minus any dead workers (a prefix loss through
             ``shrink_worker_axis``, any other through
             ``take_worker_axis``), then re-RUN for the remaining steps.

The guard runs at chunk boundaries, before ``run_phase``'s hooks and
checkpoint cadence for the chunk: a poisoned state is never snapshotted
and never published. A retry replays from the restore point: a transient
fault passes, a divergence the data drives recurs and spends the budget.

The port's chunks update the state in place (``train.loop``), so the
phase's initial state is gone after the first chunk. The supervisor keeps
a host copy of it, taken before the first chunk (the reference keeps one
too, since its chunks donate their buffers), and every restore moves a
fresh copy of its source onto the state's devices: the host copy stays
untouched for the next restore, and no restored tensor shares storage with
a failed attempt's. A restore first frees the storage of the state the
failed attempt was given (the caller's tensors on the first attempt,
which the chunks had updated in place, as the reference's donated buffers
are dead), so that the card holds one phase state, not two.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.state import (_map_state, checkpoint_workers,
                                          list_checkpoints, load_train_state,
                                          state_step, take_worker_axis,
                                          verify_snapshot)
from repro_torch.optim.api import tree_leaves
from repro_torch.train.loop import as_hooks
from repro_torch.train.loop import run_phase as _run_phase


class DivergenceError(RuntimeError):
    """Nonfinite or exploding training signal at a chunk boundary (loss,
    accuracy EMA or parameters)."""


class WorkerLostError(RuntimeError):
    """One or more phase-2 workers stopped heartbeating mid-phase."""

    def __init__(self, lost, msg: Optional[str] = None):
        self.lost = sorted(int(w) for w in lost)
        super().__init__(
            msg or f"worker(s) {self.lost} stopped heartbeating")


class SupervisorError(RuntimeError):
    """The retry budget is spent (or no worker survives)."""


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    max_retries: int = 2          # recovery attempts per phase call
    backoff_s: float = 0.0        # sleep before retry k: b * factor^(k-1)
    backoff_factor: float = 2.0
    max_loss: Optional[float] = None   # divergence bar; None = nonfinite only
    check_params: bool = True     # the all-finite sweep over the params

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")


@dataclasses.dataclass(frozen=True)
class RecoveryEvent:
    """One recovery the supervisor made (listed in SWAP's results)."""
    kind: str                     # "divergence" | "worker_lost"
    attempt: int                  # 1-based recovery attempt number
    tag: str                      # the supervised phase's tag
    error: str                    # the triggering error, as a string
    restored_step: int            # step of the state resumed from
    restored_from: str            # checkpoint path, or "initial state"
    lost_workers: Tuple[int, ...] = ()


class SupervisedResult(NamedTuple):
    """``PhaseResult`` and what the supervision did. ``steps``,
    ``train_time`` and ``hook_time`` are the final attempt's; ``worker``
    is the (possibly shrunk) list of worker ids the phase ended with."""
    state: Any
    steps: int
    train_time: float
    hook_time: float
    worker: Any
    events: Tuple[RecoveryEvent, ...]


def _tensors(state) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_state(lambda t: out.append(t) if torch.is_tensor(t) else None,
               state)
    return out


def _host_copy(state):
    """(a host copy of every tensor of ``state``, each leaf's device)."""
    def copy(t):
        return t.detach().to("cpu", copy=True) if torch.is_tensor(t) else t
    return (_map_state(copy, state),
            _map_state(lambda t: t.device if torch.is_tensor(t) else None,
                       state))


def _to_devices(host, devices):
    """A fresh copy of a host state on ``devices`` (never aliasing it)."""
    return _map_state(
        lambda h, d: h.to(d, copy=True) if d is not None else h,
        host, devices)


def _release(state) -> None:
    """Free the storage of the params and optimizer state of a failed
    attempt's state, whoever else references those tensors."""
    for t in tree_leaves(state.bundle) + tree_leaves(state.opt_state or {}):
        # memory lent by numpy is not resizable, and is not freed
        if torch.is_tensor(t) and t.untyped_storage().resizable():
            t.untyped_storage().resize_(0)


class _Guard:
    """Health checks on the state and metrics a chunk surfaced: every
    check reduced on the device, one scalar read a chunk."""

    def __init__(self, cfg: SupervisorConfig):
        self.cfg = cfg

    def check(self, state, metrics: Dict[str, Any]) -> None:
        dev = state.acc_ema.device
        names, checks = [], []
        loss = metrics.get("loss")
        if loss is not None:
            ok = torch.isfinite(loss)
            if "skipped" in metrics:
                # a dynamic loss scale skips overflowing steps on purpose:
                # only an overflow the scaler did not catch is a divergence
                ok = ok | (metrics["skipped"].to(ok.device) > 0)
            names.append("loss")
            checks.append(ok.all())
            if self.cfg.max_loss is not None:
                names.append("max_loss")
                checks.append((loss[..., -1] <= self.cfg.max_loss).all())
        names.append("ema")
        checks.append(torch.isfinite(state.acc_ema).all())
        if self.cfg.check_params:
            # min and max propagate NaN and keep an inf: one pass over each
            # leaf and no temporaries (``isfinite`` would make ~7 bytes an
            # element of the largest leaf, 5.6 GB at internlm2's full width)
            bounds = [torch.stack(torch.aminmax(
                torch.view_as_real(leaf) if leaf.is_complex() else leaf))
                for leaf in tree_leaves(state.bundle["params"])
                if (leaf.is_floating_point() or leaf.is_complex())
                and leaf.numel()]
            if bounds:
                names.append("params")
                checks.append(torch.isfinite(torch.cat(
                    [b.float().to(dev) for b in bounds])).all())
        passed = torch.stack([c.to(dev) for c in checks]).tolist()
        failed = [n for n, ok in zip(names, passed) if not ok]
        if not failed:
            return
        step = state_step(state)
        if failed[0] == "loss":
            raise DivergenceError(
                f"nonfinite loss in chunk ending at step {step}")
        if failed[0] == "max_loss":
            raise DivergenceError(
                f"loss {float(loss[..., -1].max()):.4g} above the "
                f"divergence bar {self.cfg.max_loss} at step {step}")
        if failed[0] == "ema":
            raise DivergenceError(f"nonfinite accuracy EMA at step {step}")
        raise DivergenceError(f"nonfinite parameter(s) at step {step}")


class _GuardedRunner:
    """``run_chunk`` proxy: the inner chunk, then an optional fault filter
    (the harness's injection point), then the guard. Everything else
    (loader, ensemble, ...) is the wrapped runner's."""

    def __init__(self, runner, guard: _Guard,
                 chunk_filter: Optional[Callable] = None):
        self._runner = runner
        self._guard = guard
        self._filter = chunk_filter

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def run_chunk(self, state, worker, n_steps):
        state, metrics = self._runner.run_chunk(state, worker, n_steps)
        if self._filter is not None:
            state, metrics = self._filter(state, metrics)
        self._guard.check(state, metrics)
        return state, metrics


class PhaseSupervisor:
    """Runs a training phase to its end through faults.

    ``monitor`` is an optional ``repro_torch.dist.heartbeat.
    HeartbeatMonitor``; with one, every chunk boundary of an ensemble
    phase checks the CURRENT workers' liveness, and a stale worker sets
    off a recovery. ``sleep`` is injectable, so that tests read the
    backoff schedule without waiting.
    """

    def __init__(self, cfg: Optional[SupervisorConfig] = None, *,
                 monitor=None, sleep: Callable[[float], None] = time.sleep):
        self.cfg = cfg or SupervisorConfig()
        self.monitor = monitor
        self._sleep = sleep
        # a record per run_phase call: {"tag", "host_copy_bytes",
        # "host_copy_s", "restore_s": [seconds of each restore]}
        self.timings: List[Dict[str, Any]] = []

    def run_phase(self, runner, state, worker, *, max_steps: int,
                  tag: str, stop_accuracy=None, chunk_steps=None, log=None,
                  checkpointer=None, checkpoint_meta=None, on_chunk=None,
                  chunk_filter: Optional[Callable] = None
                  ) -> SupervisedResult:
        """``repro_torch.train.loop.run_phase`` under supervision (the same
        keywords) plus ``chunk_filter``, the fault-injection seam
        (``repro_torch.testing.faults``). ``state`` is consumed: the
        chunks update it in place, and a restore frees it."""
        ensemble = bool(getattr(runner, "ensemble", False))
        t0 = time.perf_counter()
        init_host, devices = _host_copy(state)
        timing = {"tag": tag, "host_copy_s": time.perf_counter() - t0,
                  "host_copy_bytes": sum(t.numel() * t.element_size()
                                         for t in _tensors(init_host)),
                  "restore_s": []}
        self.timings.append(timing)
        if ensemble:
            init_ids = [int(x) for x in np.asarray(worker).reshape(-1)]
            ids = list(init_ids)
            # worker count -> the ids a snapshot of that width holds, so
            # that a restore of any era maps rows to identities (widths
            # only shrink, so eras never collide)
            eras: Dict[int, List[int]] = {len(init_ids): list(init_ids)}
        else:
            init_ids, ids, eras = None, None, {}

        target = state_step(state) + max_steps
        guard = _Guard(self.cfg)
        events: List[RecoveryEvent] = []
        attempt = 0
        while True:
            hooks = list(as_hooks(on_chunk))
            if ensemble and self.monitor is not None:
                hooks.append(self._liveness_hook(ids))
            guarded = _GuardedRunner(runner, guard, chunk_filter)
            try:
                res = _run_phase(
                    guarded, state, worker,
                    max_steps=max(target - state_step(state), 0),
                    stop_accuracy=stop_accuracy, chunk_steps=chunk_steps,
                    log=log, checkpointer=checkpointer, tag=tag,
                    checkpoint_meta=checkpoint_meta, on_chunk=hooks)
                return SupervisedResult(res.state, res.steps, res.train_time,
                                        res.hook_time, worker, tuple(events))
            except (DivergenceError, WorkerLostError) as err:
                attempt += 1
                if attempt > self.cfg.max_retries:
                    raise SupervisorError(
                        f"phase {tag!r} failed after "
                        f"{self.cfg.max_retries} recovery attempt(s): "
                        f"{err}") from err
                lost = tuple(getattr(err, "lost", ()))
                kind = "divergence"
                if isinstance(err, WorkerLostError):
                    kind = "worker_lost"
                    ids = [w for w in ids if w not in set(lost)]
                    if not ids:
                        raise SupervisorError(
                            f"phase {tag!r}: no workers survive "
                            f"({err})") from err
                error = f"{type(err).__name__}: {err}"
            # out of the except block the error's traceback is gone, and
            # with it the frames that held the surfaced (poisoned) state
            _release(state)
            state = None
            self._sleep(self.cfg.backoff_s
                        * self.cfg.backoff_factor ** (attempt - 1))
            t0 = time.perf_counter()
            state, worker, restored_from = self._restore(
                checkpointer, tag, ensemble, init_host, devices, worker,
                init_ids, ids, eras)
            if devices.acc_ema.type == "cuda":
                torch.cuda.synchronize(devices.acc_ema)
            timing["restore_s"].append(time.perf_counter() - t0)
            event = RecoveryEvent(
                kind=kind, attempt=attempt, tag=tag, error=error,
                restored_step=state_step(state), restored_from=restored_from,
                lost_workers=lost)
            events.append(event)
            warnings.warn(
                f"[supervisor] {kind} in phase {tag!r} (attempt "
                f"{attempt}/{self.cfg.max_retries}): {error} -- resuming "
                f"from {restored_from} at step {event.restored_step}",
                RuntimeWarning)

    def _liveness_hook(self, ids: List[int]):
        def hook(state, done):
            dead = self.monitor.dead_among(ids)
            if dead:
                raise WorkerLostError(dead)
        return hook

    def _latest_good(self, checkpointer, tag: str) -> Optional[Dict]:
        if checkpointer is None or not checkpointer.directory:
            return None
        mine = [c for c in list_checkpoints(checkpointer.directory)
                if c["tag"] == tag]
        for c in reversed(mine):
            if verify_snapshot(c["path"], c["meta"]):
                return c
            warnings.warn(
                f"[supervisor] skipping corrupt checkpoint {c['path']}",
                RuntimeWarning)
        return None

    def _restore(self, checkpointer, tag: str, ensemble: bool, init_host,
                 devices, worker, init_ids: Optional[List[int]],
                 live_ids: Optional[List[int]], eras: Dict[int, List[int]]):
        """(restored state on the devices, worker ids, its source)."""
        entry = self._latest_good(checkpointer, tag)
        if entry is None:
            base, restored_from = init_host, "initial state"
            base_ids = list(init_ids) if ensemble else None
        else:
            restored_from = entry["path"]
            template = init_host
            base_ids = None
            if ensemble:
                n_ckpt = checkpoint_workers(entry["meta"]) or len(init_ids)
                base_ids = eras.get(n_ckpt)
                if base_ids is None:
                    raise SupervisorError(
                        f"checkpoint {entry['path']} holds {n_ckpt} "
                        f"workers but no known worker-era matches")
                # a template of the snapshot's era: the initial stacked
                # state without the workers that era had already lost
                if base_ids != init_ids:
                    template = take_worker_axis(
                        init_host, [init_ids.index(w) for w in base_ids])
            base = load_train_state(entry["path"], template)
        if ensemble:
            keep = [i for i, w in enumerate(base_ids) if w in set(live_ids)]
            if len(keep) != len(base_ids):
                base = take_worker_axis(base, keep)
            worker = [base_ids[i] for i in keep]
            eras[len(worker)] = list(worker)
            live_ids[:] = worker
        return _to_devices(base, devices), worker, restored_from
