"""SWAP (Algorithm 1 of the paper), the three-phase controller: twin of
``repro/core/swap.py``, one process a card.

Phase 1: synchronous large-batch SGD until the train-accuracy EMA reaches
         tau (checked at epoch boundaries) or max_steps.
Phase 2: W independent small-batch workers from the common phase-1 model,
         each with its own data order, as one stacked ensemble (a leading W
         axis on every leaf of the state; see ``repro_torch.train.loop``).
Phase 3: average the W models (the plain mean, or with
         ``DistConfig.elastic_deadline_s > 0`` the elastic fold of
         whichever workers report within the deadline, on the streaming-
         average kernel), then the adapter's BN recompute hook.

The phase-1 optimizer state is dropped before phase 2 (the results keep
only the phase-1 bundle). ``results["device"]`` (a dict, which the
launcher's summary leaves out) holds the device's name, each phase's train
time without evals, and on CUDA each phase's device-memory peak
(``torch.cuda.max_memory_allocated``). With
``SWAPConfig.checkpoint_dir``/``checkpoint_every`` set, periodic snapshots
let ``run(resume=True)`` restart bit-exactly mid-phase-1 or mid-phase-2
(see ``repro_torch.checkpoint.state``). With a supervisor
(``repro_torch.resilience.PhaseSupervisor``) both phases run under its
retry, rollback and dead-worker recovery; with a heartbeat monitor the
elastic phase 3 takes real arrivals.

Across processes (``DistConfig`` with ``num_processes`` > 1, after
``DistConfig.initialize()``; the layout is ``DistConfig.make_mesh()``, a
``repro_torch.dist.mesh.ProcessMesh``):

  * phase 1 is data parallel over every rank: each rank's loader takes its
    shard of every batch (``DistConfig.data_shard``), and the step sets
    the gradients and metrics to their means over the world;
  * phase 2 with the ``sharded`` engine: each rank trains only the workers
    its block of the ``worker`` axis owns, as views of its stacked state,
    data parallel over the block's ranks (none with ``data`` 1), and
    issues no collective outside its block; each worker's data order and
    random key come from its global index. The ``vmap`` engine trains
    every worker on every rank, with no collective;
  * phase 3 gathers every worker's params in worker order, leaf by leaf,
    one broadcast a worker from the first rank of its block, and folds
    each leaf as one process folds it (``average``), so every rank ends
    with the same bits as a single-process run from the same phase-1
    model;
  * each worker's test accuracy is computed on its block and gathered in
    worker order. ``results["stacked_params"]`` holds this rank's workers
    (``results["local_worker_ids"]``), ``results["collectives"]`` every
    collective issued (``repro_torch.dist.sharding.CollectiveRecord``).

A ``model`` (or ``pod``) axis, a supervisor, heartbeats and snapshot
writes across processes are refused (ROADMAP A13c); loading a snapshot on
every rank is allowed.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.state import (
    Checkpointer, checkpoint_workers, find_resume_point, list_checkpoints,
    load_train_state, shrink_worker_axis, state_step, take_worker_axis,
)
from repro_torch.configs.base import PhaseConfig, SWAPConfig
from repro_torch.core.averaging import average_stacked, elastic_average_stacked
from repro_torch.core.schedules import schedule_fn as make_schedule
from repro_torch.data.pipeline import Loader
from repro_torch.dist.config import DistConfig, resolve_dist
from repro_torch.dist.sharding import CollectiveRecorder, RecordedGroup
from repro_torch.dist.mesh import ProcessMesh, world
from repro_torch.optim.api import tree_leaves, tree_map
from repro_torch.train.loop import (
    EpochRunner, TrainState, init_train_state, run_phase, stack_train_state,
)
from repro_torch.train.precision import resolve_policy

_PHASE1_SUMMARY_KEYS = ("phase1_steps", "phase1_train_acc", "phase1_time",
                        "phase1_test_acc", "phase1_skipped_steps",
                        "phase1_loss_scale")


def _stack_bundles(bundle, n: int):
    return tree_map(lambda a: a.unsqueeze(0).expand(n, *a.shape).clone(),
                    bundle)


def _device_of(bundle) -> torch.device:
    return tree_leaves(bundle["params"])[0].device


def _record_peak(stats: Dict, phase: str, device: torch.device) -> None:
    if device.type == "cuda":
        stats[f"{phase}_peak_gb"] = \
            torch.cuda.max_memory_allocated(device) / 1e9
        torch.cuda.reset_peak_memory_stats(device)


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class Placement(NamedTuple):
    """Where this process stands in a run: its rank, the phase-2 engine,
    the global workers it trains in phase 2, and its
    recorded groups (None where there is no collective): ``world_group``
    (phase 1's data parallelism, phase 3's gather), ``block_group`` (phase
    2's data parallelism inside the worker's block) with ``block_shard``,
    the block's shard of each phase-2 batch."""
    rank: int
    engine: str
    workers: List[int]
    world_group: Optional[RecordedGroup]
    block_group: Optional[RecordedGroup]
    block_shard: Optional[Tuple[int, int]]


def _single(n_workers: int) -> Placement:
    return Placement(0, "vmap", list(range(n_workers)), None, None, None)


class SGDRun:
    """Plain single-model training (phase 1, and the small/large-batch
    baselines): epoch chunks, EMA early exit at epoch boundaries."""

    def __init__(self, adapter, phase: PhaseConfig, train_arrays: Dict,
                 seed: int = 0, dist: Optional[DistConfig] = None,
                 device="cpu", group: Optional[RecordedGroup] = None):
        """``group``: across processes, the world's recorded group; each
        rank then takes its ``dist.data_shard`` of every batch."""
        self.adapter = adapter
        self.phase = phase
        self.dist = dist if dist is not None else DistConfig()
        self.loader = Loader(train_arrays, phase.batch_size, seed=seed,
                             shard=self.dist.data_shard, device=device)
        self.policy = resolve_policy(phase.precision, adapter.opt_cfg)
        self.runner = EpochRunner(
            adapter.make_train_step(make_schedule(phase.schedule),
                                    policy=self.policy,
                                    grad_accum_steps=phase.grad_accum_steps,
                                    group=group),
            self.loader, phase.accuracy_ema)

    def init_state(self, bundle, opt_state=None, start_step: int = 0,
                   phase_tag: str = "phase1") -> TrainState:
        opt_state = opt_state if opt_state is not None \
            else self.adapter.init_opt(bundle)
        return init_train_state(bundle, opt_state, step=start_step,
                                phase=phase_tag,
                                scale=self.policy.init_scale_state())

    def run(self, bundle, opt_state=None, start_step: int = 0,
            log: Optional[list] = None, worker: int = 0):
        """Returns (bundle, opt_state, steps_taken, acc_ema)."""
        state = self.init_state(bundle, opt_state, start_step)
        res = run_phase(self.runner, state, worker,
                        max_steps=self.phase.max_steps,
                        stop_accuracy=self.phase.stop_accuracy, log=log)
        st = res.state
        return st.bundle, st.opt_state, res.steps, float(st.acc_ema)


class SWAP:
    """The full three-phase algorithm over an adapter and a dataset."""

    def __init__(self, adapter, cfg: SWAPConfig, train_arrays: Dict,
                 test_loader: Loader, mesh=None,
                 dist: Optional[DistConfig] = None, supervisor=None):
        """``dist``: the distribution config (``repro_torch.dist.
        DistConfig``): the process layout, the phase-2 engine, the elastic
        phase 3, the multi-process layout (see the module docstring).
        ``mesh=`` is the deprecated spelling: a ``ProcessMesh``, from which
        a DistConfig is derived, with a DeprecationWarning (``resolve_dist``).

        ``supervisor``: an optional ``repro_torch.resilience.
        PhaseSupervisor``. With one, both phases run under its retry,
        rollback and dead-worker recovery (a worker whose heartbeat goes
        stale mid-phase-2 is dropped when the supervisor has a monitor),
        and ``results["recovery_events"]`` lists what it did."""
        self.adapter = adapter
        self.cfg = cfg
        self.train_arrays = train_arrays
        self.test_loader = test_loader
        self.dist, self.mesh = resolve_dist(dist, mesh, caller="SWAP")
        self.supervisor = supervisor
        if self.dist.n_workers not in (1, cfg.n_workers) \
                and self.dist.mesh_shape:
            raise ValueError(
                f"DistConfig.n_workers={self.dist.n_workers} disagrees with "
                f"SWAPConfig.n_workers={cfg.n_workers}")
        for axis in ("model", "pod"):
            if self.mesh is not None and self.mesh.axis_size(axis) > 1:
                _refuse(f"a {axis} axis > 1 ({self.mesh})", "A13c")
        if self.dist.multihost and supervisor is not None:
            _refuse("a supervisor across processes", "A13c")

    def placement(self, recorder: Optional[CollectiveRecorder] = None
                  ) -> Placement:
        """This process's place in the run: one process, or the ranks of
        an initialized ``torch.distributed`` run laid out by the mesh
        (``data`` over every rank where none is set). Makes the worker
        blocks' groups, which is collective: every rank calls it at the
        same point."""
        W = self.cfg.n_workers
        rank, size = world()
        if size != self.dist.num_processes:
            raise RuntimeError(
                f"DistConfig.num_processes={self.dist.num_processes} but "
                f"this run has {size} process(es): call "
                f"DistConfig.initialize() first")
        mesh = self.mesh if self.mesh is not None \
            else ProcessMesh((size,), ("data",))
        if mesh.size != size:
            raise ValueError(f"the layout {mesh} needs {mesh.size} "
                             f"processes, this run has {size}")
        engine = self.dist.resolved_engine(mesh)
        if engine == "sharded" and "worker" not in mesh.axis_names \
                and size > 1:
            raise ValueError(f"the sharded phase-2 engine needs a worker "
                             f"axis to split {size} processes; got {mesh}")
        if size == 1:
            return _single(W)._replace(engine=engine)
        recorder = recorder if recorder is not None else CollectiveRecorder()
        world_group = RecordedGroup(None, range(size), recorder)
        if engine == "vmap":
            return Placement(rank, engine, list(range(W)), world_group, None,
                             None)
        workers = mesh.owned_workers(rank, W)
        block = mesh.block_of(rank)
        pg = mesh.block_groups()[block]
        group = None if pg is None else RecordedGroup(
            pg, mesh.block_ranks(block), recorder)
        shard = None if pg is None else (mesh.data_index(rank),
                                         mesh.block_size)
        return Placement(rank, engine, workers, world_group, group, shard)

    def phase1(self, bundle, place: Optional[Placement] = None
               ) -> Tuple[EpochRunner, TrainState]:
        """Phase 1's runner (one model, the large batch; data parallel over
        ``place``'s world) and its start state from ``bundle``."""
        p1 = SGDRun(self.adapter, self.cfg.phase1, self.train_arrays,
                    seed=self.cfg.seed, dist=self.dist,
                    device=_device_of(bundle),
                    group=place.world_group if place is not None else None)
        return p1.runner, p1.init_state(bundle)

    def phase2(self, bundle, n_workers: Optional[int] = None,
               place: Optional[Placement] = None
               ) -> Tuple[EpochRunner, TrainState]:
        """Phase 2's ensemble runner (the small batch, each worker its own
        data order) and the state stacked from ``bundle`` for the workers
        ``place`` trains (all W without one). ``n_workers`` replaces the
        configured W, for the template of a snapshot written by a run of
        another size."""
        cfg, adapter = self.cfg, self.adapter
        W = n_workers if n_workers is not None else cfg.n_workers
        place = place if place is not None else _single(W)
        loader = Loader(self.train_arrays, cfg.phase2.batch_size,
                        seed=cfg.seed + 1, shard=place.block_shard,
                        device=_device_of(bundle))
        policy = resolve_policy(cfg.phase2.precision, adapter.opt_cfg)
        runner = EpochRunner(
            adapter.make_train_step(
                make_schedule(cfg.phase2.schedule), policy=policy,
                grad_accum_steps=cfg.phase2.grad_accum_steps,
                group=place.block_group),
            loader, cfg.phase2.accuracy_ema, ensemble=True)
        n = len(place.workers)
        stacked = _stack_bundles(bundle, n)
        opt = tree_map(lambda t: t.expand(n).clone() if t.dim() == 0 else t,
                       adapter.init_opt(stacked))
        return runner, stack_train_state(stacked, opt, W, seed=cfg.seed + 2,
                                         scale=policy.init_scale_state(),
                                         worker_ids=place.workers)

    def average(self, stacked_params, worker_arrivals=None):
        """Phase 3's average of the stacked workers: (params, live mask).
        The plain mean, or the elastic fold when the deadline is set."""
        if self.dist.elastic:
            return elastic_average_stacked(stacked_params, self.dist,
                                           worker_arrivals=worker_arrivals)
        W = int(tree_leaves(stacked_params)[0].shape[0])
        return average_stacked(stacked_params), np.ones(W, dtype=bool)

    @torch.no_grad()
    def gather_average(self, local_params, place: Placement,
                       worker_arrivals=None):
        """Phase 3 across processes: every worker's params gathered in
        worker order and folded by ``average``, leaf by leaf, so that the
        extra memory is the W rows of one leaf. Each row is one broadcast
        from the first rank of the worker's block; the fold of a leaf is
        the one ``average`` makes of that leaf in one process, so every
        rank ends with its bits. No ``all_reduce``: its summation order is
        the backend's. Returns (params, live mask)."""
        W = self.cfg.n_workers
        mesh = self.mesh
        pos = {w: i for i, w in enumerate(place.workers)}
        masks = []

        def fold(local):
            if isinstance(local, dict):     # the same order on every rank
                return {k: fold(local[k]) for k in local}
            rows = local.new_empty((W,) + tuple(local.shape[1:]))
            for w in range(W):
                if w in pos:
                    rows[w].copy_(local[pos[w]])
                place.world_group.broadcast_(rows[w], mesh.owner(w, W))
            avg, mask = self.average({"leaf": rows}, worker_arrivals)
            masks.append(mask)
            return avg["leaf"]

        avg = fold(local_params)
        return avg, masks[0]

    def _gather_accs(self, accs: List[float], place: Placement,
                     device: torch.device) -> List[float]:
        """Every worker's accuracy in worker order: the first rank of each
        block writes its workers' into a zero vector, one sum over the
        world (exact: each slot adds zeros to its one value)."""
        vec = torch.zeros(self.cfg.n_workers, dtype=torch.float64,
                          device=device)
        if place.block_group is None or place.block_group.ranks[0] \
                == place.rank:
            for w, a in zip(place.workers, accs):
                vec[w] = a
        return place.world_group.all_reduce_(vec).tolist()

    def run(self, key, collect_curves: bool = False,
            resume: bool = False, phase2_hooks: Sequence = (),
            worker_arrivals: Optional[Sequence[float]] = None,
            heartbeats=None, phase2_chunk_filter=None) -> Dict:
        """``key``: the torch.Generator the adapter initializes from (its
        device is where the run happens). ``resume``: restart from the
        newest verified snapshot in ``cfg.checkpoint_dir`` (mid-phase-1,
        or phase 2 from ``phase1_final`` or mid-phase-2), bit-exactly.
        ``phase2_hooks``: extra epoch-boundary hooks for phase 2,
        ``hook(state, steps_done)``. ``worker_arrivals``: per-worker report
        times for the elastic phase 3 (``float('inf')`` marks a lost
        worker), by worker id. ``heartbeats``: an optional
        ``repro_torch.dist.heartbeat.HeartbeatMonitor``; with the elastic
        phase 3 its arrivals (beacon staleness at averaging time) replace
        ``worker_arrivals``. ``phase2_chunk_filter``: a ``(state, metrics)
        -> (state, metrics)`` transform of what each phase-2 chunk
        surfaces, before the supervisor's guard (the fault-injection seam,
        ``repro_torch.testing.faults.FaultPlan.chunk_filter``); it needs a
        supervisor, since without one no guard would see the fault."""
        cfg = self.cfg
        adapter = self.adapter
        recorder = CollectiveRecorder()
        results: Dict = {"phase1_log": [], "phase2_curves": [],
                         "recovery_events": [],
                         "collectives": recorder.records}
        if phase2_chunk_filter is not None and self.supervisor is None:
            raise ValueError(
                "phase2_chunk_filter needs a supervisor attached "
                "(SWAP(..., supervisor=...)): without one, no guard "
                "observes the injected fault")
        many = self.dist.multihost
        if many and heartbeats is not None:
            _refuse("heartbeats across processes", "A13c")
        if many and cfg.checkpoint_dir and (cfg.checkpoint_every > 0
                                            or not resume):
            _refuse("writing snapshots from a run of more than one process "
                    "(resume=True with checkpoint_every 0 loads one on "
                    "every rank)", "A13c")
        place = self.placement(recorder)
        if many and place.engine == "sharded" and (collect_curves
                                                   or phase2_hooks):
            _refuse("phase-2 hooks and curves across processes (each rank "
                    "holds only its block's workers)", "A13c")

        def _supervised(runner, state, worker, **kw):
            res = self.supervisor.run_phase(runner, state, worker, **kw)
            results["recovery_events"].extend(
                {"kind": e.kind, "attempt": e.attempt, "tag": e.tag,
                 "error": e.error, "restored_step": e.restored_step,
                 "restored_from": e.restored_from,
                 "lost_workers": list(e.lost_workers)} for e in res.events)
            return res

        ckpt = Checkpointer(cfg.checkpoint_dir, cfg.checkpoint_every) \
            if cfg.checkpoint_dir and not many else None
        resume_pt = find_resume_point(cfg.checkpoint_dir) \
            if (resume and cfg.checkpoint_dir) else None

        # ---------------- phase 1: large batch, synchronous --------------
        recorder.phase = "phase1"
        t0 = time.perf_counter()
        bundle = adapter.init(key)
        dev = _device_of(bundle)
        stats = results["device"] = {
            "name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        runner1, state1 = self.phase1(bundle, place)
        if resume_pt is not None and resume_pt["tag"] in ("phase1_final",
                                                          "phase2"):
            # phase 1 finished in an earlier process: its final state and
            # summary metrics come from the phase1_final snapshot
            finals = [c for c in list_checkpoints(cfg.checkpoint_dir)
                      if c["tag"] == "phase1_final"]
            if not finals:
                raise ValueError(
                    f"cannot resume {resume_pt['tag']} from "
                    f"{cfg.checkpoint_dir!r}: no phase1_final snapshot")
            meta = finals[-1]["meta"]
            state1 = load_train_state(finals[-1]["path"], state1)
            bundle = state1.bundle
            for k in _PHASE1_SUMMARY_KEYS:
                if k in meta:
                    results[k] = meta[k]
            stats["phase1_train_s"] = meta.get("phase1_train_s", 0.0)
        else:
            prior_t1 = prior_train1 = 0.0
            if resume_pt is not None:      # tag "phase1": mid-phase-1
                state1 = load_train_state(resume_pt["path"], state1)
                # the time before the interruption, so that the reported
                # times go with the cumulative phase1_steps
                prior_t1 = resume_pt["meta"].get("phase1_time", 0.0)
                prior_train1 = resume_pt["meta"].get("phase1_train_s", 0.0)
            phase1_kw = dict(
                max_steps=cfg.phase1.max_steps - state_step(state1),
                stop_accuracy=cfg.phase1.stop_accuracy,
                log=results["phase1_log"], checkpointer=ckpt, tag="phase1",
                checkpoint_meta=lambda tt: {
                    "phase1_time": prior_t1 + time.perf_counter() - t0,
                    "phase1_train_s": prior_train1 + tt})
            res1 = (_supervised if self.supervisor is not None
                    else run_phase)(runner1, state1, 0, **phase1_kw)
            state1 = res1.state
            bundle = state1.bundle
            results["phase1_steps"] = state_step(state1)
            results["phase1_train_acc"] = float(state1.acc_ema)
            results["phase1_skipped_steps"] = int(state1.scale.skipped)
            results["phase1_loss_scale"] = float(state1.scale.scale)
            results["phase1_time"] = prior_t1 + time.perf_counter() - t0
            results["phase1_test_acc"] = adapter.eval_accuracy(
                bundle, self.test_loader)
            stats["phase1_train_s"] = prior_train1 + res1.train_time
            if ckpt is not None:
                ckpt.save("phase1_final", state1, meta=dict(
                    {k: results[k] for k in _PHASE1_SUMMARY_KEYS},
                    phase1_train_s=stats["phase1_train_s"]))
            del res1
        del state1, runner1           # the phase-1 optimizer state goes
        _record_peak(stats, "phase1", dev)

        # ---------------- phase 2: independent small-batch workers -------
        recorder.phase = "phase2"
        W = cfg.n_workers
        runner2, state2 = self.phase2(bundle, place=place)
        local = len(place.workers) < W      # this rank trains a block's
        prior_t2 = 0.0
        if resume_pt is not None and resume_pt["tag"] == "phase2":
            # the snapshot's W from its sidecar: load into a template of
            # that size, then keep this run's W (growing is refused, see
            # checkpoint.state.shrink_worker_axis), then this rank's rows
            ckpt_w = checkpoint_workers(resume_pt["meta"])
            template = state2 if ckpt_w in (None, W) and not local \
                else self.phase2(bundle, n_workers=ckpt_w or W)[1]
            state2 = shrink_worker_axis(
                load_train_state(resume_pt["path"], template), W)
            del template
            if local:
                state2 = take_worker_axis(state2, place.workers)
            prior_t2 = resume_pt["meta"].get("phase2_train_time", 0.0)
        workers = list(place.workers)

        bn_loader = Loader(self.train_arrays, cfg.bn_recompute_batch_size,
                           seed=cfg.seed, device=dev)
        hooks = list(phase2_hooks)
        if collect_curves:
            def curve_hook(state: TrainState, done: int):
                avg_now = adapter.finalize(
                    average_stacked(state.bundle["params"]), bn_loader,
                    cfg.bn_recompute_batches)
                accs: List[float] = [
                    adapter.eval_accuracy(
                        tree_map(lambda a: a[w], state.bundle),
                        self.test_loader, max_batches=2)
                    for w in range(int(state.step.shape[0]))]
                results["phase2_curves"].append({
                    "step": state_step(state) - 1,
                    "worker_test_accs": accs,
                    "avg_test_acc": adapter.eval_accuracy(
                        avg_now, self.test_loader, max_batches=2)})

            hooks.append(curve_hook)

        phase2_kw = dict(
            max_steps=cfg.phase2.max_steps - state_step(state2),
            chunk_steps=1 if collect_curves else None,
            checkpointer=ckpt, tag="phase2",
            checkpoint_meta=lambda tt: {"phase2_train_time": prior_t2 + tt,
                                        "n_workers": W},
            on_chunk=hooks)
        if self.supervisor is not None:
            res2 = _supervised(runner2, state2, workers,
                               chunk_filter=phase2_chunk_filter, **phase2_kw)
            # the surviving ids after any mid-phase recovery shrink
            workers = list(res2.worker)
        else:
            res2 = run_phase(runner2, state2, workers, **phase2_kw)
        # phase 2's optimizer state (W momentum trees, as large as the
        # stacked params) is dead from here on: the evaluations and phase 3
        # run without it
        state2 = res2.state._replace(opt_state=None)
        results["local_worker_ids"] = workers
        results["phase2_steps"] = state_step(state2)
        # train time only, cumulative over resumes
        results["phase2_time"] = prior_t2 + res2.train_time
        results["phase2_eval_time"] = res2.hook_time
        del res2

        recorder.phase = "eval"
        worker_accs = [
            adapter.eval_accuracy(tree_map(lambda a: a[w], state2.bundle),
                                  self.test_loader)
            for w in range(len(workers))]
        if local:
            worker_accs = self._gather_accs(worker_accs, place, dev)
            workers = list(range(W))
        results["phase2_worker_ids"] = workers
        W_live = len(workers)
        results["worker_test_accs"] = worker_accs
        stats["phase2_train_s"] = results["phase2_time"]
        _record_peak(stats, "phase2", dev)

        # ---------------- phase 3: average + BN recompute ----------------
        recorder.phase = "phase3"
        t3 = time.perf_counter()
        if heartbeats is not None:
            # real beacon staleness at averaging time, by surviving id
            worker_arrivals = heartbeats.arrivals(workers)
        elif worker_arrivals is not None and W_live != W \
                and len(worker_arrivals) == W:
            # simulated arrivals are by original worker id: realign them
            # to the survivors' stacked positions
            worker_arrivals = [worker_arrivals[wid] for wid in workers]
        avg_params, live_mask = (
            self.gather_average(state2.bundle["params"], place,
                                worker_arrivals) if local
            else self.average(state2.bundle["params"], worker_arrivals))
        full_mask = [False] * W
        for pos, wid in enumerate(workers):
            full_mask[wid] = bool(live_mask[pos])
        results["worker_live_mask"] = full_mask
        results["phase2_live_workers"] = int(sum(full_mask))
        live_accs = [a for a, live in zip(worker_accs, live_mask) if live]
        results["before_avg_test_acc"] = sum(live_accs) / len(live_accs)
        final = adapter.finalize(avg_params, bn_loader,
                                 cfg.bn_recompute_batches)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t4 = time.perf_counter()
        results["phase3_time"] = t4 - t3
        results["after_avg_test_acc"] = adapter.eval_accuracy(
            final, self.test_loader)
        results["total_time"] = t4 - t0
        _record_peak(stats, "phase3", dev)
        results["final_bundle"] = final
        results["stacked_params"] = state2.bundle["params"]
        results["phase1_bundle"] = bundle
        return results
