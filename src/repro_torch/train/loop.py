"""Phase engine: twin of ``repro/train/loop.py``.

  * ``TrainState`` -- what flows through a phase: (bundle, opt_state, step,
    acc_ema, phase tag, rng, loss-scale state). Phase 2 carries the same
    structure with a leading W worker axis on every leaf.
  * ``EpochRunner`` -- advances a state by a chunk of steps (an epoch by
    default). Each step gathers its batch from the loader (epoch
    permutations are cached once per (worker, epoch)), runs the train step
    and folds the accuracy EMA on the device. ``ensemble=True`` advances
    the W workers of a stacked state: each step runs worker by worker on
    views of the stacked tensors, writing into them in place, which gives
    the numbers of the reference's ``vmap`` ensemble (the workers are
    independent) and holds one worker's activations and gradients at a
    time. The reference compiles a chunk as one ``lax.scan``; here it is a
    Python loop of eager steps.
  * ``run_phase`` -- the host loop of a phase: chunks with early exit on
    the EMA at epoch boundaries, the realignment of a mid-epoch entry to
    the next boundary, per-step logs, periodic checkpoints
    (``repro_torch.checkpoint.state.Checkpointer``), and ``on_chunk`` hooks;
    the time of hooks and checkpoints is kept apart from train time.
  * ``python_loop_reference`` -- the per-step host loop, kept as the
    equivalence oracle.

The train step's update is in place (see ``repro_torch.optim``), so the
state returned by a chunk holds the same tensors as the state passed in.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.data import prng
from repro_torch.data.pipeline import Loader
from repro_torch.optim.api import tree_leaves, tree_map
from repro_torch.train.precision import (
    LossScaleState, default_scale_state, stack_scale_state,
)

PHASE_TAGS = {"sgd": 0, "phase1": 1, "phase2": 2}


class TrainState(NamedTuple):
    bundle: Any        # {"params": ..., "state": ...}
    opt_state: Any
    step: Any          # int64 tensor: 0-d, or (W,) in phase 2
    acc_ema: Any       # float32 tensor on the params' device: 0-d or (W,)
    phase: Any         # int32 PHASE_TAGS value
    rng: Any           # threefry key (reserved for stochastic steps)
    scale: Any         # LossScaleState


def _device(bundle) -> torch.device:
    return tree_leaves(bundle["params"])[0].device


def init_train_state(bundle, opt_state, *, step: int = 0,
                     acc_ema: float = 0.0, phase: str = "phase1",
                     seed: int = 0,
                     scale: Optional[LossScaleState] = None) -> TrainState:
    return TrainState(
        bundle=bundle, opt_state=opt_state,
        step=torch.tensor(step, dtype=torch.int64),
        acc_ema=torch.tensor(acc_ema, dtype=torch.float32,
                             device=_device(bundle)),
        phase=torch.tensor(PHASE_TAGS.get(phase, 0), dtype=torch.int32),
        rng=prng.PRNGKey(seed),
        scale=scale if scale is not None else default_scale_state())


def stack_train_state(stacked_bundle, stacked_opt_state, n_workers: int,
                      seed: int = 0,
                      scale: Optional[LossScaleState] = None,
                      worker_ids: Optional[Sequence[int]] = None
                      ) -> TrainState:
    """The phase-2 start state from an already-stacked bundle and
    per-worker optimizer state, both with a leading worker axis.
    ``worker_ids``: the global workers of the ``n_workers`` that the
    stacked rows hold (all of them by default); worker w's key is row w of
    the split of ``seed`` into ``n_workers`` whatever rows a process
    holds."""
    ids = list(range(n_workers)) if worker_ids is None else list(worker_ids)
    n = len(ids)
    return TrainState(
        bundle=stacked_bundle, opt_state=stacked_opt_state,
        step=torch.zeros((n,), dtype=torch.int64),
        acc_ema=torch.zeros((n,), dtype=torch.float32,
                            device=_device(stacked_bundle)),
        phase=torch.full((n,), PHASE_TAGS["phase2"], dtype=torch.int32),
        rng=prng.split(prng.PRNGKey(seed), n_workers)[ids],
        scale=stack_scale_state(
            scale if scale is not None else default_scale_state(), n))


def _write_back(dst, src):
    """Copy ``src`` into the worker view ``dst`` leaf by leaf, skipping
    leaves the step already updated in place."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if s.data_ptr() != d.data_ptr() or s.shape != d.shape:
            d.copy_(s)


def _ema(beta: float, ema, metrics):
    new = beta * ema + (1.0 - beta) * metrics["accuracy"].float()
    if "skipped" in metrics and float(metrics["skipped"]) > 0:
        new = ema        # a skipped (overflow) step's batch was not applied
    return new


class EpochRunner:
    """Chunks of train steps over a loader, one model or a stacked
    ensemble (see the module docstring)."""

    def __init__(self, step_fn: Callable, loader: Loader, ema_beta: float,
                 ensemble: bool = False):
        self.step_fn = step_fn
        self.loader = loader
        self.ema_beta = ema_beta
        self.ensemble = ensemble

    def _one(self, st: TrainState, worker: int):
        step = int(st.step)
        batch = self.loader.batch(step, worker)
        bundle, opt, scale, metrics = self.step_fn(
            st.bundle, st.opt_state, batch, step, st.scale)
        ema = _ema(self.ema_beta, st.acc_ema, metrics)
        return st._replace(bundle=bundle, opt_state=opt, step=st.step + 1,
                           acc_ema=ema, scale=scale), dict(metrics, ema=ema)

    def _ensemble_step(self, st: TrainState, workers):
        W = int(st.step.shape[0])
        logs = []
        for w in range(W):
            bundle = tree_map(lambda t: t[w], st.bundle)
            opt = tree_map(lambda t: t[w], st.opt_state)
            sub = TrainState(bundle, opt, st.step[w], st.acc_ema[w],
                             st.phase[w], st.rng[w],
                             LossScaleState(*(t[w] for t in st.scale)))
            new, metrics = self._one(sub, int(workers[w]))
            _write_back(bundle, new.bundle)
            _write_back(opt, new.opt_state)
            for dst, src in zip(st.scale, new.scale):
                dst[w] = src
            st.acc_ema[w] = new.acc_ema
            logs.append(metrics)
        metrics = {k: torch.stack([m[k] for m in logs]) for k in logs[0]}
        return st._replace(step=st.step + 1), metrics

    def run_chunk(self, state: TrainState, worker, n_steps: int):
        """Advance ``n_steps``. Returns (state, metrics) with every metric
        stacked over the step axis (``(n_steps,)``; ``(W, n_steps)`` for
        ensembles)."""
        logs = []
        for _ in range(n_steps):
            if self.ensemble:
                state, metrics = self._ensemble_step(state, worker)
            else:
                state, metrics = self._one(state, int(worker))
            logs.append(metrics)
        return state, {k: torch.stack([m[k] for m in logs], dim=-1)
                       for k in logs[0]}


class PhaseResult(NamedTuple):
    state: TrainState
    steps: int          # steps executed by this call
    train_time: float   # wall time inside train chunks only
    hook_time: float    # wall time in on_chunk hooks, checkpoints, logging


def _ema_value(state: TrainState) -> float:
    ema = state.acc_ema
    return float(ema if ema.dim() == 0 else ema.min())


def _first_step(state: TrainState) -> int:
    return int(state.step.reshape(-1)[0])


def _sync(state: TrainState) -> None:
    dev = _device(state.bundle)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def as_hooks(on_chunk) -> tuple:
    """None, one callable or a sequence of them -> a tuple of hooks, each
    called as ``hook(state, steps_done)`` after every chunk."""
    if on_chunk is None:
        return ()
    if callable(on_chunk):
        return (on_chunk,)
    return tuple(on_chunk)


def _append_log(log: List[dict], metrics: Dict, first_step: int) -> None:
    host = {k: metrics[k].cpu() for k in ("accuracy", "ema", "loss", "lr")}
    for i in range(host["accuracy"].shape[-1]):
        log.append({"step": first_step + i,
                    **{k: float(v[..., i]) for k, v in host.items()}})


def run_phase(runner: EpochRunner, state: TrainState, worker, *,
              max_steps: int, stop_accuracy: Optional[float] = None,
              chunk_steps: Optional[int] = None, log: Optional[list] = None,
              checkpointer=None, tag: str = "phase1",
              checkpoint_meta: Optional[Callable] = None,
              on_chunk: Optional[Callable] = None) -> PhaseResult:
    """Drive a phase: chunks of an epoch with early exit on the accuracy
    EMA at epoch boundaries. ``max_steps`` counts from the current
    ``state.step`` (a resumed state runs the remainder). A state that
    enters mid-epoch runs a first chunk to the next boundary only, so that
    the stopping check keeps to epoch boundaries. Between chunks the hooks
    run, then ``checkpointer.maybe_save(tag, state, meta)``, with ``meta``
    = ``checkpoint_meta(train_time_so_far)`` when given (e.g. the
    cumulative phase times, for a resume to report totals)."""
    if log is not None and runner.ensemble:
        raise ValueError(
            "per-step logs are single-model only: ensemble metrics carry a "
            "leading worker axis — consume them via on_chunk instead")
    chunk = chunk_steps or runner.loader.steps_per_epoch
    hooks = as_hooks(on_chunk)
    done, train_time, hook_time = 0, 0.0, 0.0
    if stop_accuracy is not None and _ema_value(state) >= stop_accuracy:
        return PhaseResult(state, 0, 0.0, 0.0)
    offset = _first_step(state) % chunk
    first = chunk - offset if offset else chunk
    while done < max_steps:
        n = min(first if done == 0 else chunk, max_steps - done)
        t0 = time.perf_counter()
        state, metrics = runner.run_chunk(state, worker, n)
        _sync(state)
        train_time += time.perf_counter() - t0
        done += n

        t1 = time.perf_counter()
        if log is not None:
            _append_log(log, metrics, _first_step(state) - n)
        for hook in hooks:
            hook(state, done)
        if checkpointer is not None:
            checkpointer.maybe_save(
                tag, state,
                checkpoint_meta(train_time) if checkpoint_meta else None)
        hook_time += time.perf_counter() - t1

        if stop_accuracy is not None and _ema_value(state) >= stop_accuracy:
            break
    return PhaseResult(state, done, train_time, hook_time)


def stack_host_batches(loader: Loader, step: int, n_workers: int):
    """Every worker's batch at ``step``, stacked on a leading W axis."""
    batches = [loader.batch(step, worker=w) for w in range(n_workers)]
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def python_loop_reference(step_fn: Callable, loader: Loader,
                          state: TrainState, worker: int = 0, *,
                          n_steps: int, ema_beta: float):
    """The per-step host loop: one step per iteration, the batch built on
    the host each step. The equivalence oracle of the engine. Returns
    (state, per-step log dicts)."""
    bundle, opt, scale = state.bundle, state.opt_state, state.scale
    start = int(state.step)
    ema = state.acc_ema
    logs = []
    for s in range(start, start + n_steps):
        batch = loader.batch(s, worker=worker)
        bundle, opt, scale, metrics = step_fn(bundle, opt, batch, s, scale)
        ema = _ema(ema_beta, ema, metrics)
        logs.append({"step": s, "accuracy": float(metrics["accuracy"]),
                     "ema": float(ema), "loss": float(metrics["loss"]),
                     "lr": float(metrics["lr"])})
    return state._replace(
        bundle=bundle, opt_state=opt, scale=scale,
        step=torch.tensor(start + n_steps, dtype=torch.int64),
        acc_ema=ema), logs
