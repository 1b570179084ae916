"""SWAP on the port's CNN+BatchNorm path, on the CPU.

  * The reference's integration scenarios (``tests/test_swap_integration.py``)
    on the port: the three phases run, the average is at least the mean of
    its workers (less 0.01), phase 3 recomputes finite BN statistics, phase 1
    stops at its accuracy threshold, the SWA baseline runs.
  * ``SWAP.run`` and ``SWA.run`` from JAX's init carried over (params and
    BN state), against the JAX package's runs on the same data: params and
    BN state 1e-4 (short f32 trajectories, sums in another order),
    accuracies to one argmax hit in a test batch, step counts exactly.
  * The quickstart's ``main(["--device", "cpu"])`` prints the reference
    quickstart's lines, and the launcher refuses the CNN as the
    reference's does.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core.adapters import CNNAdapter as JAdapter  # noqa: E402
from repro.core.swa import SWA as JSWA  # noqa: E402
from repro.core.swap import SWAP as JSWAP  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_gmm_images as jgmm  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import SWA, SWAP, CNNAdapter, SGDRun  # noqa: E402
from repro_torch.data.pipeline import Loader, make_gmm_images  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402

TOL = 1e-4
ARCH = "cifar-cnn"


# ---------------------------------------------------------------------------
# the reference's integration scenarios, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cnn_setup():
    data = make_gmm_images(0, n_classes=10, image_size=16, n_train=1024,
                           n_test=512, noise=2.0)
    train = {"images": data["train_images"], "labels": data["train_labels"]}
    test_loader = Loader({"images": data["test_images"],
                          "labels": data["test_labels"]}, 256)
    adapter = CNNAdapter(treg.get_smoke_config(ARCH),
                         tbase.OptimizerConfig(kind="sgd"))
    return adapter, train, test_loader


@pytest.fixture(scope="module")
def swap_result(cnn_setup):
    adapter, train, test_loader = cnn_setup
    b = tbase
    cfg = b.SWAPConfig(
        n_workers=4,
        phase1=b.PhaseConfig(batch_size=512, max_steps=40, stop_accuracy=0.8,
                             schedule=b.ScheduleConfig(
                                 kind="warmup_linear", peak_lr=0.4,
                                 warmup_steps=8, total_steps=40)),
        phase2=b.PhaseConfig(batch_size=64, max_steps=30,
                             schedule=b.ScheduleConfig(
                                 kind="warmup_linear", peak_lr=0.05,
                                 warmup_steps=0, total_steps=30)),
        bn_recompute_batches=4, bn_recompute_batch_size=256)
    return SWAP(adapter, cfg, train, test_loader).run(
        torch.Generator().manual_seed(0))


def test_phases_execute(swap_result):
    r = swap_result
    assert r["phase1_steps"] > 0
    assert len(r["worker_test_accs"]) == 4
    assert 0.0 <= r["after_avg_test_acc"] <= 1.0


def test_averaged_model_at_least_mean_of_workers(swap_result):
    r = swap_result
    assert r["after_avg_test_acc"] >= r["before_avg_test_acc"] - 0.01


def test_phase3_bn_stats_recomputed(swap_result):
    state = swap_result["final_bundle"]["state"]
    assert state, "CNN must get recomputed BN statistics in phase 3"
    phase1 = swap_result["phase1_bundle"]["state"]
    for new, old in zip(tree_leaves(state), tree_leaves(phase1)):
        assert torch.isfinite(new).all()
        assert new.dtype == torch.float32 and new.shape == old.shape
        assert not torch.equal(new, old)


def test_phase1_stops_at_accuracy_threshold(cnn_setup):
    adapter, train, _ = cnn_setup
    b = tbase
    phase = b.PhaseConfig(batch_size=256, max_steps=200, stop_accuracy=0.30,
                          accuracy_ema=0.5,
                          schedule=b.ScheduleConfig(kind="const",
                                                    peak_lr=0.2))
    run = SGDRun(adapter, phase, train)
    bundle = adapter.init(torch.Generator().manual_seed(1))
    _, _, steps, ema = run.run(bundle)
    assert steps < 200, "should exit early at the accuracy threshold"
    assert ema >= 0.30


def test_swa_baseline_runs(cnn_setup):
    adapter, train, test_loader = cnn_setup
    b = tbase
    cfg = b.SWAConfig(n_samples=3, cycle_steps=10, batch_size=128,
                      schedule=b.ScheduleConfig(kind="cyclic", peak_lr=0.1,
                                                min_lr=0.01, cycle_steps=10))
    bundle = adapter.init(torch.Generator().manual_seed(0))
    res = SWA(adapter, cfg, train, test_loader).run(bundle)
    assert res["n_samples"] == 3
    assert 0.0 <= res["after_avg_test_acc"] <= 1.0
    assert all(torch.isfinite(t).all()
               for t in tree_leaves(res["final_bundle"]["state"]))


# ---------------------------------------------------------------------------
# SWAP.run and SWA.run against the JAX package
# ---------------------------------------------------------------------------


class FromJax(CNNAdapter):
    """The port's CNN adapter, initialized with a JAX bundle."""

    def __init__(self, cfg, opt_cfg, jax_bundle):
        super().__init__(cfg, opt_cfg)
        self.jax_bundle = jax.device_get(jax_bundle)

    def init(self, gen):
        return params_from_numpy(self.jax_bundle, device=gen.device)


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


def _swap_cfg(b):
    sched = b.ScheduleConfig(kind="warmup_linear", peak_lr=0.2,
                             warmup_steps=2, total_steps=6)
    return b.SWAPConfig(
        n_workers=2, seed=3, bn_recompute_batches=2,
        bn_recompute_batch_size=64,
        phase1=b.PhaseConfig(batch_size=64, max_steps=6, schedule=sched),
        phase2=b.PhaseConfig(batch_size=16, max_steps=4,
                             schedule=b.ScheduleConfig(
                                 kind="warmup_linear", peak_lr=0.05,
                                 total_steps=4)))


@pytest.fixture(scope="module")
def runs():
    data = jgmm(1, n_classes=10, image_size=16, n_train=256, n_test=64,
                noise=2.0)
    train = {"images": np.asarray(data["train_images"]),
             "labels": np.asarray(data["train_labels"])}
    test = {"images": np.asarray(data["test_images"]),
            "labels": np.asarray(data["test_labels"])}
    jad = JAdapter(jreg.get_smoke_config(ARCH), jbase.OptimizerConfig())
    jinit = jad.init(jax.random.PRNGKey(0))
    tad = FromJax(treg.get_smoke_config(ARCH), tbase.OptimizerConfig(),
                  jinit)
    jres = JSWAP(jad, _swap_cfg(jbase), train, JLoader(test, 32)).run(
        jax.random.PRNGKey(0))
    tres = SWAP(tad, _swap_cfg(tbase), train, Loader(test, 32)).run(
        torch.Generator())
    return jres, tres, (jad, tad, train, test)


def test_swap_run_matches_jax(runs):
    jres, tres, _ = runs
    for key in ("phase1_steps", "phase2_steps", "phase2_live_workers",
                "worker_live_mask", "phase2_worker_ids"):
        assert tres[key] == jres[key], key
    hit = 1 / 32                   # one argmax hit in a test batch
    for key in ("phase1_test_acc", "before_avg_test_acc",
                "after_avg_test_acc", "phase1_train_acc"):
        np.testing.assert_allclose(tres[key], jres[key], atol=hit,
                                   err_msg=key)
    np.testing.assert_allclose(tres["worker_test_accs"],
                               jres["worker_test_accs"], atol=hit)
    _close_trees(tres["phase1_bundle"], jres["phase1_bundle"])
    _close_trees(tres["stacked_params"], jres["stacked_params"])
    _close_trees(tres["final_bundle"], jres["final_bundle"])


def test_swa_run_matches_jax(runs):
    _, _, (jad, tad, train, test) = runs
    kw = dict(n_samples=3, cycle_steps=3, batch_size=64, seed=1)
    jcfg = jbase.SWAConfig(schedule=jbase.ScheduleConfig(
        kind="cyclic", peak_lr=0.1, min_lr=0.01, cycle_steps=3), **kw)
    tcfg = tbase.SWAConfig(schedule=tbase.ScheduleConfig(
        kind="cyclic", peak_lr=0.1, min_lr=0.01, cycle_steps=3), **kw)
    jres = JSWA(jad, jcfg, train, JLoader(test, 32)).run(
        jad.init(jax.random.PRNGKey(0)))
    tres = SWA(tad, tcfg, train, Loader(test, 32)).run(
        tad.init(torch.Generator()))
    assert tres["n_samples"] == jres["n_samples"] == 3
    _close_trees(tres["final_bundle"], jres["final_bundle"])
    _close_trees(tres["last_bundle"], jres["last_bundle"])
    for key in ("before_avg_test_acc", "after_avg_test_acc"):
        np.testing.assert_allclose(tres[key], jres[key], atol=1 / 32)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_quickstart_on_cpu_prints_the_reference_lines(monkeypatch, capsys):
    """The quickstart's ``main`` with ``--device cpu``, its phases cut to a
    few steps (the whole run is the reference's own schedule, ~60 s on one
    thread: ``python -m repro_torch.experiments.quickstart --device cpu``)."""
    from repro_torch.experiments import quickstart

    def short(**kw):
        return tbase.PhaseConfig(**{**kw, "max_steps": 3})

    monkeypatch.setattr(quickstart, "PhaseConfig", short)
    res = quickstart.main(["--device", "cpu"])
    assert res["phase1_steps"] == 3 and res["phase2_steps"] == 3
    lines = capsys.readouterr().out.strip().splitlines()
    patterns = [r"phase 1: \d+ large-batch steps -> test [\d.]+ \([\d.]+s\)",
                r"phase 2: 4 independent workers \([\d.]+s\)",
                *[rf"  worker {w}: test [\d.]+" for w in range(4)],
                r"phase 3: averaged model -> test [\d.]+ \([\d.]+s, BN "
                r"stats recomputed\)",
                r"averaging gain over mean worker: [+-][\d.]+"]
    assert len(lines) == len(patterns), lines
    for line, pat in zip(lines, patterns):
        assert re.fullmatch(pat, line), (line, pat)


def test_experiment_tasks_build_on_the_cpu():
    from repro_torch.core import LMAdapter
    from repro_torch.experiments import common
    adapter, train, test = common.cnn_task(n_train=64, n_test=256,
                                           device="cpu")
    assert isinstance(adapter, CNNAdapter)
    assert adapter.cfg == treg.get_smoke_config(ARCH)
    assert train["images"].shape == (64, 16, 16, 3)
    assert test.device.type == "cpu" and test.n == 256
    full = treg.get_config(ARCH)
    adapter, train, _ = common.cnn_task(n_train=8, n_test=256, cfg=full,
                                        device="cpu")
    assert adapter.cfg is full and train["images"].shape == (8, 32, 32, 3)
    adapter, train, _ = common.cnn_task(n_classes=20, n_train=64,
                                        n_test=256, device="cpu")
    assert adapter.cfg.n_classes == 20 and train["labels"].max() >= 10
    adapter, train, test = common.lm_task(n_train=16, n_test=256,
                                          seq_len=8, device="cpu")
    assert isinstance(adapter, LMAdapter)
    assert train["tokens"].shape == (16, 8) and test.n == 256
    assert common.mean_std([0.5]) == "0.5000"
    assert common.mean_std([0.5, 0.7]) == "0.6000 ± 0.1414"


def test_entry_points_need_a_card_and_the_launcher_refuses_the_cnn():
    from repro_torch.experiments import (ablation_workers, common,
                                         figure1_curves, figure4_cosine,
                                         figure23_landscape, landscape_viz,
                                         quickstart, table1_cifar10,
                                         table2_cifar100, table3_imagenet)
    with pytest.raises(SystemExit, match="experiments.table1_cifar10"):
        tlaunch.main(["--arch", ARCH, "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.cnn_task()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table1_cifar10.run(seeds=(0,), verbose=False)
    for mod in (table2_cifar100, table3_imagenet):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run(seeds=(0,), verbose=False)
    for mod in (figure1_curves, figure23_landscape, figure4_cosine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run(verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ablation_workers.run(seeds=(0,), verbose=False)
    for mod in (landscape_viz, table2_cifar100, table3_imagenet,
                figure1_curves, figure23_landscape, figure4_cosine,
                ablation_workers):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
