"""The port's SWAP controller, SWA baseline and launcher against JAX's.

Both packages start from JAX's init (carried over with
``params_from_numpy`` by a test-side adapter whose ``init`` returns it) and
read the same data. Tolerances: per-step loss, lr and EMA and the averaged
params 1e-4 relative (short f32 trajectories whose sums are taken in
another order); accuracies, which count argmax hits, to one hit in the
batch; step counts and liveness masks exactly.
"""
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

from repro.configs import base as jbase  # noqa: E402
from repro.core.adapters import LMAdapter as JAdapter  # noqa: E402
from repro.core.swa import SWA as JSWA  # noqa: E402
from repro.core.swap import SWAP as JSWAP  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_markov_lm  # noqa: E402
from repro.dist.config import DistConfig as JDist  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.swa import SWA  # noqa: E402
from repro_torch.core.swap import SWAP  # noqa: E402
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.dist.config import DistConfig, add_dist_args  # noqa: E402
from repro_torch.dist.heartbeat import (HeartbeatMonitor,  # noqa: E402
                                        HeartbeatWriter)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.resilience import PhaseSupervisor  # noqa: E402
from repro_torch.testing.faults import FakeClock  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
TINY = dict(name="tiny-lm", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=32,
            attention="gqa", dtype="float32", remat=False,
            scan_layers=False)
W = 2


class FromJax(LMAdapter):
    """The port's LM adapter, initialized with JAX's params."""

    def __init__(self, cfg, opt_cfg, jax_params):
        super().__init__(cfg, opt_cfg)
        self.jax_params = jax.device_get(jax_params)

    def init(self, gen):
        return {"params": params_from_numpy(self.jax_params,
                                            device=gen.device), "state": {}}


def _swap_cfgs(**over):
    def make(b):
        sched = b.ScheduleConfig(kind="warmup_linear", peak_lr=0.2,
                                 warmup_steps=2, total_steps=8)
        return b.SWAPConfig(
            n_workers=W, seed=3,
            phase1=b.PhaseConfig(batch_size=64, max_steps=8, schedule=sched,
                                 **over),
            phase2=b.PhaseConfig(batch_size=16, max_steps=6,
                                 schedule=b.ScheduleConfig(
                                     kind="warmup_linear", peak_lr=0.05,
                                     total_steps=6)))
    return make(jbase), make(tbase)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _close_trees(t_tree, j_tree, tol=TOL):
    t, j = _flat(t_tree), _flat(jax.device_get(j_tree))
    assert t.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def runs():
    data = make_markov_lm(0, vocab=32, n_train=256, n_test=128, seq_len=16)
    train = {"tokens": data["train_tokens"], "labels": data["train_labels"]}
    test = {"tokens": data["test_tokens"], "labels": data["test_labels"]}
    jcfg, tcfg = _swap_cfgs()
    jad = JAdapter(jbase.ModelConfig(**TINY), jbase.OptimizerConfig())
    jinit = jad.init(jax.random.PRNGKey(0))["params"]
    tad = FromJax(tbase.ModelConfig(**TINY), tbase.OptimizerConfig(), jinit)
    dist = dict(n_workers=W, elastic_deadline_s=10.0)
    jres = JSWAP(jad, jcfg, train, JLoader(test, 32),
                 dist=JDist(**dist)).run(jax.random.PRNGKey(0))
    tres = SWAP(tad, tcfg, train, Loader(test, 32),
                dist=DistConfig(**dist)).run(torch.Generator())
    return jres, tres, (jad, tad, train, test)


def test_swap_phase_counts_masks_and_keys(runs):
    jres, tres, _ = runs
    for key in ("phase1_steps", "phase2_steps", "phase1_skipped_steps",
                "phase1_loss_scale", "phase2_live_workers",
                "worker_live_mask", "phase2_worker_ids"):
        assert tres[key] == jres[key], key
    assert set(jres) <= set(tres)
    assert tres["device"]["name"] == "cpu"


def test_swap_phase1_log_matches_jax(runs):
    jres, tres, _ = runs
    jl, tl = jres["phase1_log"], tres["phase1_log"]
    assert [e["step"] for e in tl] == [e["step"] for e in jl]
    for key in ("loss", "lr", "ema"):
        np.testing.assert_allclose([e[key] for e in tl],
                                   [e[key] for e in jl], rtol=TOL,
                                   err_msg=key)
    # batch of 64 x 16 tokens: one argmax hit is 1/1024
    np.testing.assert_allclose([e["accuracy"] for e in tl],
                               [e["accuracy"] for e in jl], atol=1 / 1024)


def test_swap_accuracies_and_averaged_params_match_jax(runs):
    jres, tres, _ = runs
    hit = 1 / (32 * 16)            # one argmax hit in a test batch
    for key in ("phase1_test_acc", "before_avg_test_acc",
                "after_avg_test_acc", "phase1_train_acc"):
        np.testing.assert_allclose(tres[key], jres[key], atol=hit,
                                   err_msg=key)
    np.testing.assert_allclose(tres["worker_test_accs"],
                               jres["worker_test_accs"], atol=hit)
    _close_trees(tres["phase1_bundle"]["params"],
                 jres["phase1_bundle"]["params"])
    _close_trees(tres["stacked_params"], jres["stacked_params"])
    _close_trees(tres["final_bundle"]["params"],
                 jres["final_bundle"]["params"])


def test_swa_matches_jax(runs):
    _, _, (jad, tad, train, test) = runs
    kw = dict(n_samples=3, cycle_steps=4, batch_size=32, seed=1)
    jcfg = jbase.SWAConfig(schedule=jbase.ScheduleConfig(
        kind="cyclic", peak_lr=0.1, min_lr=0.01, cycle_steps=4), **kw)
    tcfg = tbase.SWAConfig(schedule=tbase.ScheduleConfig(
        kind="cyclic", peak_lr=0.1, min_lr=0.01, cycle_steps=4), **kw)
    jres = JSWA(jad, jcfg, train, JLoader(test, 32)).run(
        jad.init(jax.random.PRNGKey(0)))
    tres = SWA(tad, tcfg, train, Loader(test, 32)).run(
        tad.init(torch.Generator()))
    assert tres["n_samples"] == jres["n_samples"] == 3
    _close_trees(tres["final_bundle"]["params"],
                 jres["final_bundle"]["params"])
    _close_trees(tres["last_bundle"]["params"],
                 jres["last_bundle"]["params"])
    for key in ("before_avg_test_acc", "after_avg_test_acc"):
        np.testing.assert_allclose(tres[key], jres[key], atol=1 / 512)


def test_unported_surfaces_are_refused(tmp_path):
    """The mesh is accepted since A13b (``mesh=`` warns, a model axis is
    refused: A13c); the supervisor and heartbeats are accepted and run to
    a result."""
    from repro_torch.dist.mesh import ProcessMesh
    _, tcfg = _swap_cfgs()
    tad = LMAdapter(tbase.ModelConfig(**TINY), tbase.OptimizerConfig())
    tr = {"tokens": np.zeros((256, 16), np.int32),
          "labels": np.zeros((256, 16), np.int32)}
    test = Loader(tr, 32)
    with pytest.warns(DeprecationWarning, match="mesh="):
        SWAP(tad, tcfg, tr, test, mesh=ProcessMesh((W,), ("worker",)))
    with pytest.raises(NotImplementedError, match="A13c"), \
            pytest.warns(DeprecationWarning):
        SWAP(tad, tcfg, tr, test, mesh=ProcessMesh((1, 2),
                                                   ("worker", "model")))
    clock = FakeClock()
    for w in range(W):
        HeartbeatWriter(str(tmp_path), w, clock=clock).beat()
    monitor = HeartbeatMonitor(str(tmp_path), W, timeout_s=1.0, clock=clock)
    swap = SWAP(tad, tcfg, tr, test,
                dist=DistConfig(n_workers=W, elastic_deadline_s=10.0),
                supervisor=PhaseSupervisor(monitor=monitor))
    res = swap.run(torch.Generator(), heartbeats=monitor)
    assert res["recovery_events"] == []
    assert res["phase2_worker_ids"] == list(range(W))
    assert res["worker_live_mask"] == [True] * W
    assert res["phase2_steps"] == tcfg.phase2.max_steps


def test_dist_config_validation_and_flags():
    for kw, msg in ((dict(n_workers=0), "n_workers"),
                    (dict(elastic_deadline_s=-1.0), "elastic_deadline_s"),
                    (dict(elastic_backoff=0.5), "elastic_backoff"),
                    (dict(elastic_max_extensions=-1), "max_extensions"),
                    (dict(n_workers=2, elastic_min_workers=3),
                     "elastic_min_workers"),
                    (dict(heartbeat_interval_s=-1.0), "heartbeat_interval_s"),
                    (dict(heartbeat_timeout_s=-1.0), "heartbeat_timeout_s"),
                    (dict(heartbeat_interval_s=5.0, heartbeat_timeout_s=2.0),
                     "declares every worker dead")):
        with pytest.raises(ValueError, match=msg):
            DistConfig(**kw)
        with pytest.raises(ValueError, match=msg):
            JDist(**kw)
    import argparse
    ap = argparse.ArgumentParser()
    add_dist_args(ap)
    d = DistConfig.from_args(ap.parse_args(
        ["--workers", "3", "--elastic-deadline", "5",
         "--elastic-min-workers", "2"]), n_workers_default=4)
    assert (d.n_workers, d.elastic_deadline_s, d.elastic_min_workers,
            d.elastic) == (3, 5.0, 2, True)
    assert DistConfig.from_args(ap.parse_args([]),
                                n_workers_default=4).n_workers == 4
    d = DistConfig.from_args(ap.parse_args(
        ["--heartbeat-dir", "hb", "--heartbeat-interval", "2",
         "--heartbeat-timeout", "0"]))
    assert (d.heartbeats, d.heartbeat_dir, d.heartbeat_interval_s,
            d.resolved_heartbeat_timeout) == (True, "hb", 2.0, 6.0)
    for kw in (dict(heartbeat_dir="hb"), dict(heartbeat_interval_s=2.0),
               dict(heartbeat_interval_s=2.0, heartbeat_timeout_s=7.0)):
        assert (DistConfig(**kw).resolved_heartbeat_timeout,
                DistConfig(**kw).heartbeats) == \
            (JDist(**kw).resolved_heartbeat_timeout, JDist(**kw).heartbeats)
    assert not DistConfig().heartbeats
    # the layout and multi-process flags are registered since A13b, and
    # give the reference's fields
    from repro.dist.config import add_dist_args as jadd_dist_args
    jap = argparse.ArgumentParser()
    jadd_dist_args(jap)
    argv = ["--mesh", "worker:2", "--phase2-engine", "sharded",
            "--coordinator", "127.0.0.1:1", "--num-processes", "2",
            "--process-id", "1"]
    d, jd = (DistConfig.from_args(ap.parse_args(argv)),
             JDist.from_args(jap.parse_args(argv)))
    assert json.loads(d.to_json()) == dict(json.loads(jd.to_json()),
                                           backend="")


def _launch(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout)


def test_launcher_on_cpu_prints_the_reference_summary(runs, tmp_path):
    """The launcher's JSON summary has exactly the reference launcher's
    keys: every int/float result of SWAP.run but the log, and wall_s;
    ``--save`` writes the averaged params as a checkpoint the JAX package
    reads."""
    jres, _, _ = runs
    ckpt = tmp_path / "avg.ckpt"
    proc = _launch(["--device", "cpu", "--workers", "2", "--phase1-steps",
                    "2", "--phase2-steps", "1", "--elastic-deadline", "30",
                    "--save", str(ckpt)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    summary = json.loads(out[out.index("{"):out.index("}") + 1])
    want = {k for k, v in jres.items()
            if isinstance(v, (int, float)) and k != "phase1_log"}
    assert set(summary) == want | {"wall_s"}
    assert summary["phase1_steps"] == 2 and summary["phase2_steps"] == 1
    assert "worker accs:" in out and "SWAP: before avg" in out
    assert "elastic: 2/2 workers in the average" in out
    from repro.checkpoint.io import load_pytree as jload
    from repro.configs import registry as jreg
    from repro.models.model import Model as JModel
    jm = JModel(jreg.get_smoke_config("internlm2-1.8b"))
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    restored = jload(str(ckpt), jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), template))
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(restored))


def test_launcher_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--phase1-steps", "1"])
    with pytest.raises(SystemExit, match="--resume requires"):
        tlaunch.main(["--resume"])
    with pytest.raises(SystemExit, match="lost-workers"):
        tlaunch.main(["--device", "cpu", "--lost-workers", "1"])
