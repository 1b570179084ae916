"""The port's resilience layer against the JAX package's: twin of
``tests/test_resilience.py``.

Every scenario of the reference's chaos suite that this layer covers runs
through both packages on the same inputs (the same scripted faults, the
same fake clock readings, the same data, the port's model initialized
with JAX's params) and compares what each did: the recovery events (kind,
attempt, tag, restored step, lost workers, the basename of
``restored_from``, since the directories differ), the surviving worker
ids, the live masks, the step counts, the backoff sleeps, the warnings,
and the final params within ``tests/test_torch_swap.py``'s ``TOL``. The
checksum and publish-fallback scenarios are in
``tests/test_torch_checkpoint.py`` and ``tests/test_torch_resume.py``,
the publisher's in ``tests/test_torch_publisher.py``, the serving
deadlines' in ``tests/test_torch_serve_paged.py``.

Then three properties of the port's own: a run rolled back from a NaN
ends bitwise where the unfaulted run ends; a survivor of a worker's death
ends bitwise where the same worker ends in an unfaulted run; and beacons
written by one package read the same in the other's monitor.
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.resilience as jres  # noqa: E402
import repro_torch.resilience as tres  # noqa: E402
from repro.checkpoint import state as jstate  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core import swap as jswap  # noqa: E402
from repro.core.adapters import LMAdapter as JAdapter  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_markov_lm  # noqa: E402
from repro.dist import config as jdist  # noqa: E402
from repro.dist import heartbeat as jhb  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.checkpoint import state as tstate  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import swap as tswap  # noqa: E402
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.dist import config as tdist  # noqa: E402
from repro_torch.dist import heartbeat as thb  # noqa: E402
from repro_torch.optim.api import tree_leaves, tree_map  # noqa: E402
from repro_torch.testing import faults as tfaults  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from test_torch_swap import FromJax, _close_trees  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
INF = float("inf")
ARCH = "internlm2-1.8b"


@functools.lru_cache(maxsize=None)
def _lm_setup():
    """The reference suite's smoke LM and data; the port's adapter starts
    from JAX's params."""
    jcfg = jreg.get_smoke_config(ARCH)
    data = make_markov_lm(0, vocab=jcfg.vocab_size, n_train=128, n_test=64,
                          seq_len=16)
    train = {"tokens": data["train_tokens"], "labels": data["train_labels"]}
    test = {"tokens": data["test_tokens"], "labels": data["test_labels"]}
    jad = JAdapter(jcfg, jbase.OptimizerConfig(kind="sgd"))
    tad = FromJax(treg.get_smoke_config(ARCH),
                  tbase.OptimizerConfig(kind="sgd"),
                  jad.init(jax.random.PRNGKey(0))["params"])
    return jad, tad, train, test


class Pkg:
    """One package's resilience surface and the helpers a scenario
    needs."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        (self.state, self.base, self.swap, self.dist, self.hb, self.res,
         self.faults, self.loop) = (
            (jstate, jbase, jswap, jdist, jhb, jres, jfaults, jloop)
            if jax_side else
            (tstate, tbase, tswap, tdist, thb, tres, tfaults, tloop))

    # the model and data are made on first use, not at collection
    @property
    def adapter(self):
        return _lm_setup()[0 if self.jax else 1]

    @property
    def train(self):
        return _lm_setup()[2]

    @property
    def test_loader(self):
        return (JLoader if self.jax else Loader)(_lm_setup()[3], 32)

    def __repr__(self):
        return "jax" if self.jax else "port"

    def key(self):
        return jax.random.PRNGKey(0) if self.jax else torch.Generator()

    def tiny_state(self, step=0, value=1.0):
        xp, f32 = (jnp, jnp.float32) if self.jax else (torch, torch.float32)
        bundle = {"params": {"w": xp.full((4, 3), value, dtype=f32)},
                  "state": {}}
        opt = {"m": xp.zeros((4, 3), dtype=f32)}
        return self.loop.init_train_state(bundle, opt, step=step)

    def leaves(self, tree):
        if self.jax:
            return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
        return [x.detach().numpy() for x in tree_leaves(tree)]

    def finite(self, tree) -> bool:
        return all(np.isfinite(x).all() for x in self.leaves(tree))

    def poison_always(self, state, metrics):
        """A fault that recurs on every replay (a data-driven
        divergence)."""
        if self.jax:
            params = jax.tree_util.tree_map(
                lambda a: jnp.full_like(a, jnp.nan)
                if jnp.issubdtype(a.dtype, jnp.inexact) else a,
                state.bundle["params"])
        else:
            params = tree_map(lambda a: torch.full_like(a, float("nan")),
                              state.bundle["params"])
        return state._replace(bundle=dict(state.bundle, params=params)), \
            metrics

    def swap_cfg(self, n_workers=4, phase2_steps=4, **kw):
        b = self.base
        return b.SWAPConfig(
            n_workers=n_workers,
            phase1=b.PhaseConfig(batch_size=32, max_steps=2,
                                 schedule=b.ScheduleConfig(kind="const",
                                                           peak_lr=0.1)),
            phase2=b.PhaseConfig(batch_size=16, max_steps=phase2_steps,
                                 schedule=b.ScheduleConfig(kind="const",
                                                           peak_lr=0.05)),
            bn_recompute_batch_size=64, **kw)

    def sgd_phase(self, max_steps=3):
        phase = self.base.PhaseConfig(
            batch_size=16, max_steps=max_steps,
            schedule=self.base.ScheduleConfig(kind="const", peak_lr=0.1))
        run = self.swap.SGDRun(self.adapter, phase, self.train)
        return run, run.init_state(self.adapter.init(self.key()))


PKGS = (Pkg(True), Pkg(False))


def both(scenario, *args):
    """``scenario(pkg, *args)`` through the JAX package and the port."""
    return tuple(scenario(p, *args) for p in PKGS)


def _event_record(ev):
    """What a recovery event says, comparable across the packages."""
    get = (lambda k: ev[k]) if isinstance(ev, dict) else \
        (lambda k: getattr(ev, k))
    return (get("kind"), get("attempt"), get("tag"), get("restored_step"),
            os.path.basename(get("restored_from")),
            [int(w) for w in get("lost_workers")])


def _flip_byte(path):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


def _dir(tmp_path, p, name=""):
    return str(tmp_path / f"{p!r}{name}")


# ---------------------------------------------------------------------------
# heartbeat liveness
# ---------------------------------------------------------------------------


def test_fake_clock_is_monotonic():
    def run(p):
        clock = p.faults.FakeClock()
        seen = [clock(), clock.advance(2.5), clock()]
        with pytest.raises(ValueError, match="rewind"):
            clock.advance(-1.0)
        return seen

    want, got = both(run)
    assert got == want == [0.0, 2.5, 2.5]


def test_heartbeat_writer_interval_and_beacon(tmp_path):
    def run(p):
        clock = p.faults.FakeClock()
        w = p.hb.HeartbeatWriter(_dir(tmp_path, p), 2, interval_s=5.0,
                                 clock=clock)
        beats = [w.maybe_beat(step=1), w.maybe_beat(step=2)]
        clock.advance(5.0)
        beats.append(w.maybe_beat(step=3))
        with open(w.path, "rb") as f:
            return beats, os.path.basename(w.path), f.read()

    want, got = both(run)
    assert got == want
    assert got[0] == [True, False, True]           # inside the interval
    assert json.loads(got[2]) == {"worker": 2, "seq": 2, "t": 5.0,
                                  "step": 3}


def test_monitor_staleness_liveness_arrivals(tmp_path):
    def run(p):
        clock = p.faults.FakeClock()
        hb = _dir(tmp_path, p)
        w0 = p.hb.HeartbeatWriter(hb, 0, clock=clock)
        w1 = p.hb.HeartbeatWriter(hb, 1, clock=clock)
        mon = p.hb.HeartbeatMonitor(hb, 3, timeout_s=4.0, clock=clock)
        w0.beat()
        clock.advance(3.0)
        w1.beat()
        clock.advance(1.0)
        # worker 0: 4 s stale (the timeout: still live), worker 1: 1 s,
        # worker 2: never beat
        out = [mon.staleness(), mon.live_mask().tolist(),
               mon.dead_among([0, 1, 2]), mon.arrivals([1, 0]),
               mon.arrivals()]
        clock.advance(1.0)                   # worker 0 past the timeout
        return out + [mon.dead_among([0, 1]), mon.arrivals([0, 1])]

    want, got = both(run)
    assert got == want
    assert got == [[4.0, 1.0, INF], [True, True, False], [2], [1.0, 4.0],
                   [4.0, 1.0, INF], [0], [INF, 2.0]]


def test_monitor_tolerates_damaged_beacon(tmp_path):
    def run(p):
        clock = p.faults.FakeClock()
        hb = _dir(tmp_path, p)
        p.hb.HeartbeatWriter(hb, 0, clock=clock).beat()
        with open(os.path.join(hb, "hb-worker0.json"), "w") as f:
            f.write('{"worker": 0, "seq"')       # torn from outside
        mon = p.hb.HeartbeatMonitor(hb, 1, timeout_s=1.0, clock=clock)
        return mon.poll(), mon.live_mask().tolist()

    want, got = both(run)
    assert got == want == ({0: None}, [False])


def test_beacons_read_the_same_in_both_packages(tmp_path):
    """A beacon is the same file from either package: each package's
    monitor reads the other's writers with the staleness its own would
    give, on one shared fake clock."""
    clock = tfaults.FakeClock()
    hb = str(tmp_path)
    thb.HeartbeatWriter(hb, 0, clock=clock).beat(step=3)
    clock.advance(2.0)
    jhb.HeartbeatWriter(hb, 1, clock=clock).beat(step=5)
    clock.advance(0.5)
    mons = [mod.HeartbeatMonitor(hb, 3, timeout_s=2.25, clock=clock)
            for mod in (jhb, thb)]
    seen = [(m.poll(), m.staleness(), m.live_mask().tolist(),
             m.arrivals([2, 1, 0])) for m in mons]
    assert seen[0] == seen[1]
    assert seen[1][1:] == ([2.5, 0.5, INF], [False, True, False],
                           [INF, 0.5, INF])
    assert seen[1][0][0] == {"worker": 0, "seq": 1, "t": 0.0, "step": 3}


# ---------------------------------------------------------------------------
# checkpoint integrity
# ---------------------------------------------------------------------------


def test_truncated_sidecar_skipped_with_fallback(tmp_path):
    """A sidecar cut mid-JSON crashes neither ``read_meta`` nor
    ``find_resume_point``: the snapshot is unverifiable, the one before
    wins."""
    def run(p):
        d = _dir(tmp_path, p)
        os.makedirs(d)
        old = os.path.join(d, "phase1-step00000002.msgpack")
        new = os.path.join(d, "phase1-step00000004.msgpack")
        p.state.save_train_state(old, p.tiny_state(step=2))
        p.state.save_train_state(new, p.tiny_state(step=4))
        with open(p.faults.truncate_sidecar(new), "rb") as f:
            cut = f.read()
        with pytest.warns(RuntimeWarning,
                          match="unreadable checkpoint sidecar"):
            meta = p.state.read_meta(new)
        with pytest.warns(RuntimeWarning, match="skipping corrupt checkpoint"):
            pick = p.state.find_resume_point(d)
        return cut, meta, os.path.basename(pick["path"]), pick["step"]

    want, got = both(run)
    assert got == want
    assert got[1] == {"_sidecar_corrupt": True} and got[3] == 2


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_resume_point_skips_corrupt_latest(tmp_path, mode):
    def run(p):
        d = _dir(tmp_path, p)
        os.makedirs(d)
        for step in (2, 4):
            p.state.save_train_state(
                os.path.join(d, f"phase2-step{step:08d}.msgpack"),
                p.tiny_state(step=step))
        bad = p.faults.corrupt_latest_checkpoint(d, mode=mode)
        with open(bad, "rb") as f:
            damaged = f.read()
        with pytest.warns(RuntimeWarning, match="falling back"):
            pick = p.state.find_resume_point(d)
        restored = p.state.load_train_state(pick["path"], p.tiny_state())
        return (os.path.basename(bad), damaged, pick["step"],
                p.state.state_step(restored), p.leaves(restored.bundle))

    (*want, wl), (*got, tl) = both(run)
    assert got == want
    assert got[0] == "phase2-step00000004.msgpack" and got[2:] == [2, 2]
    for t, j in zip(tl, wl):
        np.testing.assert_array_equal(t, j)


def test_resume_point_none_when_everything_corrupt(tmp_path):
    def run(p):
        d = _dir(tmp_path, p)
        os.makedirs(d)
        p.state.save_train_state(
            os.path.join(d, "phase1-step00000001.msgpack"),
            p.tiny_state(step=1))
        p.faults.corrupt_latest_checkpoint(d)
        with pytest.warns(RuntimeWarning):
            return p.state.find_resume_point(d)

    assert both(run) == (None, None)


@pytest.mark.parametrize("damaged", [False, True],
                         ids=["bounds_good", "keeps_last_verified_good"])
def test_prune(tmp_path, damaged):
    """Pruning keeps ``keep`` snapshots a tag, but never deletes the last
    one that verifies: with the two newest damaged on disk, a fresh
    Checkpointer (no cache of what it wrote) spares step 10."""
    def run(p):
        d = _dir(tmp_path, p)
        ckpt = p.state.Checkpointer(d, keep=10 if damaged else 2)
        for step in (10, 20, 30):
            ckpt.save("phase2", p.tiny_state(step=step))
        if damaged:
            for name in ("phase2-step00000020.msgpack",
                         "phase2-step00000030.msgpack"):
                _flip_byte(os.path.join(d, name))
            p.state.Checkpointer(d, keep=2)._prune("phase2")
        steps = [c["step"] for c in p.state.list_checkpoints(d)]
        good = [p.state.verify_snapshot(c["path"])
                for c in p.state.list_checkpoints(d)]
        return steps, good

    want, got = both(run)
    assert got == want
    assert got == (([10, 20, 30], [True, False, False]) if damaged
                   else ([20, 30], [True, True]))


# ---------------------------------------------------------------------------
# supervised phase execution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")],
                         ids=["nan", "inf", "-inf"])
def test_guard_catches_one_nonfinite_param(bad):
    """The guard's sweep over the params finds a single non-finite element
    (the port reduces each leaf to its min and max), and passes a finite
    state."""
    def run(p):
        guard = p.res.supervisor._Guard(p.res.SupervisorConfig())
        state = p.tiny_state(step=3)
        guard.check(state, {})
        w = np.ones((4, 3), np.float32)
        w[2, 1] = bad
        w = jnp.asarray(w) if p.jax else torch.from_numpy(w)
        state = state._replace(bundle=dict(state.bundle, params={"w": w}))
        with pytest.raises(p.res.DivergenceError,
                           match="nonfinite parameter") as err:
            guard.check(state, {})
        return str(err.value)

    want, got = both(run)
    assert got == want == "nonfinite parameter(s) at step 3"


def test_supervisor_exhausts_budget_with_backoff_schedule():
    """A fault that recurs on every replay spends the retry budget on the
    backoff schedule, then fails loudly."""
    def run(p):
        runner, state = p.sgd_phase()
        sleeps = []
        sup = p.res.PhaseSupervisor(
            p.res.SupervisorConfig(max_retries=2, backoff_s=0.5,
                                   backoff_factor=2.0),
            sleep=sleeps.append)
        with pytest.warns(RuntimeWarning, match="divergence") as caught:
            with pytest.raises(p.res.SupervisorError,
                               match="after 2 recovery attempt"):
                sup.run_phase(runner.runner, state, 0, max_steps=2,
                              tag="phase1", chunk_steps=1,
                              chunk_filter=p.poison_always)
        return sleeps, len([w for w in caught
                            if "divergence" in str(w.message)])

    want, got = both(run)
    assert got == want == ([0.5, 1.0], 2)    # backoff_s * factor**(k-1)


def test_supervisor_rolls_back_transient_nan(tmp_path):
    """A one-shot NaN poisons the chunk ending at step 2: the supervisor
    rolls back to the verified step-1 snapshot, replays clean and ends the
    phase; the poisoned state was never written."""
    def run(p):
        runner, state = p.sgd_phase(max_steps=3)
        d = _dir(tmp_path, p)
        ckpt = p.state.Checkpointer(d, every=1)
        plan = p.faults.FaultPlan().nan_at_step(2)
        sup = p.res.PhaseSupervisor(p.res.SupervisorConfig(max_retries=2),
                                    sleep=lambda s: None)
        with pytest.warns(RuntimeWarning, match="divergence"):
            res = sup.run_phase(runner.runner, state, 0, max_steps=3,
                                tag="phase1", chunk_steps=1,
                                checkpointer=ckpt,
                                chunk_filter=plan.chunk_filter)
        snaps = [p.state.load_train_state(c["path"], p.sgd_phase()[1])
                 for c in p.state.list_checkpoints(d)]
        return (p.state.state_step(res.state),
                [_event_record(e) for e in res.events],
                all(p.finite(s.bundle["params"]) for s in snaps),
                res.state.bundle["params"])

    (*want, jp), (*got, tp) = both(run)
    assert got == want
    assert got == [3, [("divergence", 1, "phase1", 1,
                        "phase1-step00000001.msgpack", [])], True]
    _close_trees(tp, jp)


def test_supervisor_without_faults_is_transparent():
    def run(p):
        runner, state = p.sgd_phase(max_steps=2)
        sup = p.res.PhaseSupervisor(p.res.SupervisorConfig(max_retries=1))
        res = sup.run_phase(runner.runner, state, 0, max_steps=2,
                            tag="phase1")
        return p.state.state_step(res.state), res.events, \
            res.state.bundle["params"]

    (*want, jp), (*got, tp) = both(run)
    assert got == want == [2, ()]
    _close_trees(tp, jp)


# ---------------------------------------------------------------------------
# end-to-end: supervised SWAP
# ---------------------------------------------------------------------------


_SWAP_KEYS = ("phase2_worker_ids", "worker_live_mask", "phase2_live_workers",
              "phase1_steps", "phase2_steps")


def _check_swap(want, got):
    for key in _SWAP_KEYS:
        assert got[key] == want[key], key
    assert [_event_record(e) for e in got["recovery_events"]] == \
        [_event_record(e) for e in want["recovery_events"]]
    assert set(got["recovery_events"][0]) == set(want["recovery_events"][0])
    _close_trees(got["stacked_params"], want["stacked_params"])
    _close_trees(got["final_bundle"]["params"],
                 want["final_bundle"]["params"])


def _worker_death(p, tmp_path, checkpoints=True, kill=3, n_workers=4,
                  collect_curves=True):
    hb_dir = _dir(tmp_path, p, "-hb")
    clock = p.faults.FakeClock()
    plan = p.faults.FaultPlan(clock).kill_worker(kill, at_step=2)
    writers = [p.hb.HeartbeatWriter(hb_dir, w, clock=clock)
               for w in range(n_workers)]
    for w in writers:
        w.beat()
    monitor = p.hb.HeartbeatMonitor(hb_dir, n_workers, timeout_s=2.5,
                                    clock=clock)
    sup = p.res.PhaseSupervisor(p.res.SupervisorConfig(max_retries=2),
                                monitor=monitor, sleep=lambda s: None)
    kw = dict(checkpoint_dir=_dir(tmp_path, p, "-ckpts"),
              checkpoint_every=1) if checkpoints else {}
    cfg = p.swap_cfg(n_workers=n_workers, **kw)
    dist = p.dist.DistConfig(n_workers=n_workers, elastic_deadline_s=30.0)
    swap = p.swap.SWAP(p.adapter, cfg, p.train, p.test_loader, dist=dist,
                       supervisor=sup)
    with pytest.warns(RuntimeWarning, match="worker_lost"):
        return swap.run(p.key(), collect_curves=collect_curves,
                        phase2_hooks=[plan.beat_hook(writers)],
                        heartbeats=monitor)


def test_supervised_swap_survives_worker_death(tmp_path):
    """Worker 3's heartbeat goes silent mid-phase-2: the supervisor drops
    it, resumes the survivors from the last verified snapshot, and phase
    3 averages only them."""
    want, got = both(_worker_death, tmp_path)
    _check_swap(want, got)
    assert got["phase2_worker_ids"] == [0, 1, 2]
    assert got["worker_live_mask"] == [True, True, True, False]
    (kind, attempt, tag, step, src, lost), = \
        [_event_record(e) for e in got["recovery_events"]]
    assert (kind, lost, tag) == ("worker_lost", [3], "phase2")
    assert src.endswith(".msgpack")
    assert got["phase2_steps"] == 4


def _nan_step(p, tmp_path, checkpoints=True, nan_step=2):
    plan = p.faults.FaultPlan().nan_at_step(nan_step)
    sup = p.res.PhaseSupervisor(p.res.SupervisorConfig(max_retries=2),
                                sleep=lambda s: None)
    kw = dict(checkpoint_dir=_dir(tmp_path, p, "-ckpts"),
              checkpoint_every=1) if checkpoints else {}
    swap = p.swap.SWAP(p.adapter, p.swap_cfg(**kw), p.train, p.test_loader,
                       supervisor=sup)
    with pytest.warns(RuntimeWarning, match="divergence"):
        return swap.run(p.key(), collect_curves=True,
                        phase2_chunk_filter=plan.chunk_filter)


def test_supervised_swap_recovers_from_nan_step(tmp_path):
    """A one-shot NaN in phase 2 rolls back to the last verified snapshot,
    and the run ends with everything finite."""
    want, got = both(_nan_step, tmp_path)
    _check_swap(want, got)
    assert [_event_record(e) for e in got["recovery_events"]] == [
        ("divergence", 1, "phase2", 1, "phase2-step00000001.msgpack", [])]
    assert got["worker_live_mask"] == [True] * 4
    assert np.isfinite(got["after_avg_test_acc"])
    assert PKGS[1].finite(got["final_bundle"]["params"])


@pytest.mark.parametrize("pkg", PKGS, ids=repr)
def test_phase2_chunk_filter_requires_supervisor(pkg):
    swap = pkg.swap.SWAP(pkg.adapter, pkg.swap_cfg(), pkg.train,
                         pkg.test_loader)
    with pytest.raises(ValueError, match="needs a supervisor"):
        swap.run(pkg.key(), phase2_chunk_filter=lambda s, m: (s, m))


def test_swap_resume_skips_corrupted_latest_checkpoint(tmp_path):
    """Damage the newest snapshot after a run: a resumed run falls back to
    the verified one before it and ends."""
    def run(p):
        d = _dir(tmp_path, p)
        cfg = p.swap_cfg(n_workers=2, checkpoint_dir=d, checkpoint_every=1)
        p.swap.SWAP(p.adapter, cfg, p.train, p.test_loader).run(
            p.key(), collect_curves=True)
        victim = p.faults.corrupt_latest_checkpoint(d, tag="phase2")
        with pytest.warns(RuntimeWarning, match="falling back"):
            good = p.state.find_resume_point(d)
        with pytest.warns(RuntimeWarning, match="falling back"):
            res = p.swap.SWAP(p.adapter, cfg, p.train,
                              p.test_loader).run(p.key(), resume=True)
        return (os.path.basename(victim), os.path.basename(good["path"]),
                res)

    (*want, jres_), (*got, tres_) = both(run)
    assert got == want == ["phase2-step00000004.msgpack",
                           "phase2-step00000003.msgpack"]
    assert tres_["phase2_steps"] == jres_["phase2_steps"] == 4
    assert 0.0 <= tres_["after_avg_test_acc"] <= 1.0
    _close_trees(tres_["final_bundle"]["params"],
                 jres_["final_bundle"]["params"])


# ---------------------------------------------------------------------------
# the port's own: bitwise replays
# ---------------------------------------------------------------------------


def _port_leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


@functools.lru_cache(maxsize=None)
def _port_unfaulted(n_workers):
    p = PKGS[1]
    return p.swap.SWAP(p.adapter, p.swap_cfg(n_workers=n_workers), p.train,
                       p.test_loader).run(p.key(), collect_curves=True)


@pytest.mark.parametrize("checkpoints", [False, True],
                         ids=["initial_state", "checkpoint"])
def test_nan_rollback_ends_bitwise_on_the_unfaulted_run(tmp_path,
                                                        checkpoints):
    """The replay after a NaN rollback, from the phase's initial state
    (the host copy) or from a snapshot, takes the same steps on the same
    bits: its params equal the unfaulted run's bitwise."""
    res = _nan_step(PKGS[1], tmp_path, checkpoints)
    want = _port_unfaulted(4)
    assert res["recovery_events"][0]["restored_from"].endswith(
        ".msgpack" if checkpoints else "initial state")
    assert _port_leaves_equal(res["phase1_bundle"]["params"],
                              want["phase1_bundle"]["params"])
    assert _port_leaves_equal(res["stacked_params"], want["stacked_params"])
    assert _port_leaves_equal(res["final_bundle"]["params"],
                              want["final_bundle"]["params"])


def test_survivor_ends_bitwise_on_its_unfaulted_trajectory(tmp_path):
    """Worker 0 dies mid-phase-2 of a 2-worker run: the survivor keeps its
    identity (it draws worker 1's batches), and its params equal worker
    1's of the unfaulted run bitwise."""
    res = _worker_death(PKGS[1], tmp_path, checkpoints=False, kill=0,
                        n_workers=2)
    want = _port_unfaulted(2)
    assert res["phase2_worker_ids"] == [1]
    assert res["worker_live_mask"] == [False, True]
    assert [_event_record(e) for e in res["recovery_events"]] == [
        ("worker_lost", 1, "phase2", 0, "initial state", [0])]
    assert _port_leaves_equal(_take(res["stacked_params"], 0),
                              _take(want["stacked_params"], 1))
    assert _port_leaves_equal(res["phase1_bundle"]["params"],
                              want["phase1_bundle"]["params"])


def _take(tree, i):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _launch(module, args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return [line for line in proc.stdout.splitlines()
            if line.startswith(("elastic:", "recovery:"))]


def test_launcher_supervises_through_a_lost_worker(tmp_path):
    """``--supervise 2 --heartbeat-dir DIR --lost-workers 3``: worker 3
    never beats, the supervisor drops it mid-phase-2, and both launchers
    print the same live mask and recovery."""
    args = ["--workers", "4", "--elastic-deadline", "30", "--supervise", "2",
            "--lost-workers", "3", "--phase1-steps", "2", "--phase2-steps",
            "1"]
    want = _launch("repro.launch.train",
                   args + ["--heartbeat-dir", str(tmp_path / "jax")])
    got = _launch("repro_torch.launch.train",
                  args + ["--heartbeat-dir", str(tmp_path / "port"),
                          "--device", "cpu"])
    assert got == want == [
        "elastic: 3/4 workers in the average, live mask "
        "[True, True, True, False]",
        "recovery: worker_lost in phase2 (attempt 1) -> resumed from "
        "initial state at step 0"]
