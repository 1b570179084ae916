"""The paper's experiments on the port against the JAX package's scripts.

Each twin in ``repro_torch.experiments`` (Table 2, Table 3, Figure 1,
Figures 2/3 with the ASCII map, Figure 4, the worker ablation) runs beside
its JAX script (``benchmarks/``, ``examples/landscape_viz.py``) with the
step counts cut to a few (``SMALL``/``LARGE``/``SWAP_HP``/``BASE``/
``STEPS``/``GRID`` patched in both modules). Both read the JAX task's data
and start from JAX's init (``FromJax``), so they run the same
trajectories. Tolerances as ``tests/test_torch_swap.py``: values derived
from the params (Figures 2/3's plane coordinates, Figure 4's cosines)
1e-4; accuracies and errors to 1/512 (two hits in a test batch of 256);
step counts exactly. Table 2's JAX side gets a 20-class
config: the reference's ``cnn_task`` keeps the smoke config's 10 classes,
whose loss is NaN past label 9.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))        # the JAX scripts in benchmarks/

import jax  # noqa: E402

from benchmarks import ablation_workers as j_abl  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import figure1_curves as j_f1  # noqa: E402
from benchmarks import figure23_landscape as j_f23  # noqa: E402
from benchmarks import figure4_cosine as j_f4  # noqa: E402
from benchmarks import table2_cifar100 as j_t2  # noqa: E402
from benchmarks import table3_imagenet as j_t3  # noqa: E402
from repro.core.adapters import CNNAdapter as JCNN  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import CNNAdapter, LMAdapter  # noqa: E402
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.experiments import ablation_workers as t_abl  # noqa: E402
from repro_torch.experiments import figure1_curves as t_f1  # noqa: E402
from repro_torch.experiments import figure23_landscape as t_f23  # noqa: E402
from repro_torch.experiments import figure4_cosine as t_f4  # noqa: E402
from repro_torch.experiments import landscape_viz as t_viz  # noqa: E402
from repro_torch.experiments import table2_cifar100 as t_t2  # noqa: E402
from repro_torch.experiments import table3_imagenet as t_t3  # noqa: E402

TOL = 1e-4
HIT = 1 / 512


def _from_jax(base):
    class FromJax(base):
        """The port's adapter, initialized with JAX's init for the
        generator's seed."""

        def __init__(self, cfg, opt_cfg, jax_adapter):
            super().__init__(cfg, opt_cfg)
            self.jax_adapter = jax_adapter

        def init(self, gen):
            b = self.jax_adapter.init(jax.random.PRNGKey(gen.initial_seed()))
            return params_from_numpy(jax.device_get(b), device=gen.device)

    return FromJax


def _opt(b):
    return b.OptimizerConfig(kind="sgd", momentum=0.9, weight_decay=5e-4)


def _cnn_tasks(monkeypatch, jmod, tmod, **sizes):
    """Both modules' ``cnn_task`` on the JAX task's data (cut to
    ``sizes``); the JAX model gets the task's class count."""
    def jtask(**kw):
        adapter, train, test = jcommon.cnn_task(**{**kw, **sizes})
        cfg = dataclasses.replace(adapter.cfg,
                                  n_classes=kw.get("n_classes", 10))
        return JCNN(cfg, adapter.opt_cfg), train, test

    def ttask(*, cfg=None, device="cuda", **kw):
        assert cfg is None and device == "cpu"
        jad, train, test = jtask(**kw)
        tcfg = dataclasses.replace(treg.get_smoke_config("cifar-cnn"),
                                   n_classes=jad.cfg.n_classes)
        train = {k: np.asarray(v) for k, v in train.items()}
        test = Loader({k: np.asarray(v) for k, v in test.arrays.items()},
                      test.batch_size)
        return _from_jax(CNNAdapter)(tcfg, _opt(tbase), jad), train, test

    monkeypatch.setattr(jmod, "cnn_task", jtask)
    monkeypatch.setattr(tmod, "cnn_task", ttask)


def _rows_close(t_rows, j_rows, key="acc"):
    assert t_rows.keys() == j_rows.keys()
    for row in j_rows:
        np.testing.assert_allclose(t_rows[row][key], j_rows[row][key],
                                   atol=HIT, err_msg=row)


def test_table2_matches_jax_with_20_classes(monkeypatch):
    _cnn_tasks(monkeypatch, j_t2, t_t2, n_train=512, n_test=512)
    small = dict(batch_size=64, steps=3, peak_lr=0.4)
    large = dict(batch_size=256, steps=2, peak_lr=1.2)
    hp = dict(j_t2.SWAP_HP, b1=256, steps1=2, steps2=2, workers=2)
    for mod in (j_t2, t_t2):
        monkeypatch.setattr(mod, "SMALL", small)
        monkeypatch.setattr(mod, "LARGE", large)
        monkeypatch.setattr(mod, "SWAP_HP", hp)
    jout = j_t2.run(seeds=(0,), verbose=False)
    tout = t_t2.run(seeds=(0,), verbose=False, device="cpu")
    assert all(np.isfinite(v["acc"]).all() for v in jout.values())
    _rows_close(tout, jout)
    assert t_t2.N_CLASSES == 20 and t_t2.NOISE == 3.0


def _lm_tasks(monkeypatch):
    def jtask(**kw):
        return jcommon.lm_task(**dict(kw, n_train=512, n_test=256))

    def ttask(*, device="cuda", **kw):
        assert device == "cpu"
        jad, train, test = jtask(**kw)
        tcfg = treg.get_smoke_config("internlm2-1.8b")
        assert tcfg.head_dim == 64 and tcfg.dtype == "float32"
        train = {k: np.asarray(v) for k, v in train.items()}
        test = Loader({k: np.asarray(v) for k, v in test.arrays.items()},
                      test.batch_size)
        return _from_jax(LMAdapter)(tcfg, _opt(tbase), jad), train, test

    monkeypatch.setattr(j_t3, "lm_task", jtask)
    monkeypatch.setattr(t_t3, "lm_task", ttask)


def test_table3_matches_jax(monkeypatch):
    _lm_tasks(monkeypatch)
    for mod in (j_t3, t_t3):
        monkeypatch.setattr(mod, "SMALL", dict(mod.SMALL, steps=3))
        monkeypatch.setattr(mod, "LARGE", dict(mod.LARGE, steps=2))
        monkeypatch.setattr(mod, "SWAP_HP",
                            dict(mod.SWAP_HP, steps1=2, steps2=2))
    jout = j_t3.run(seeds=(0,), verbose=False)
    tout = t_t3.run(seeds=(0,), verbose=False, device="cpu")
    _rows_close(tout, jout)


def test_figure1_curves_match_jax(monkeypatch):
    _cnn_tasks(monkeypatch, j_f1, t_f1, n_train=512, n_test=512)
    for mod in (j_f1, t_f1):
        monkeypatch.setattr(mod, "SWAP_HP", dict(
            mod.SWAP_HP, workers=2, b1=256, steps1=2, steps2=3))
    jout = j_f1.run(verbose=False)
    tout = t_f1.run(verbose=False, device="cpu")
    assert len(tout["curves"]) == len(jout["curves"]) == 3
    for t, j in zip(tout["curves"], jout["curves"]):
        assert t["step"] == j["step"]
        np.testing.assert_allclose(t["worker_test_accs"],
                                   j["worker_test_accs"], atol=HIT)
        np.testing.assert_allclose(t["avg_test_acc"], j["avg_test_acc"],
                                   atol=HIT)
    assert tout["late_steps_avg_above_best"] == \
        jout["late_steps_avg_above_best"]


def test_figure23_landscape_matches_jax(monkeypatch):
    _cnn_tasks(monkeypatch, j_f23, t_f23, n_train=512, n_test=512)
    for mod in (j_f23, t_f23):
        monkeypatch.setattr(mod, "SWAP_HP", dict(
            mod.SWAP_HP, workers=2, b1=256, steps1=2, steps2=2))
        monkeypatch.setattr(mod, "GRID", 3)
    jout = j_f23.run(verbose=False)
    tout = t_f23.run(verbose=False, device="cpu")
    for name, (a, b) in jout["points"].items():
        np.testing.assert_allclose(tout["points"][name], (a, b), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert len(tout["grid"]) == len(jout["grid"]) == 9
    for t, j in zip(tout["grid"], jout["grid"]):
        np.testing.assert_allclose([t["alpha"], t["beta"]],
                                   [j["alpha"], j["beta"]], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose([t["train_err"], t["test_err"]],
                                   [j["train_err"], j["test_err"]],
                                   atol=HIT)
    for key in ("train_err", "test_err"):
        for name in ("LB", "SGD", "SWAP"):
            np.testing.assert_allclose(tout[key][name], jout[key][name],
                                       atol=HIT, err_msg=f"{key} {name}")


def _jax_landscape_viz():
    spec = importlib.util.spec_from_file_location(
        "jax_landscape_viz", ROOT / "examples" / "landscape_viz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_landscape_viz_draws_the_reference_map(monkeypatch, capsys,
                                               tmp_path):
    """The ASCII map of one grid is the reference's, character for
    character; ``main`` writes the result and draws both maps."""
    rng = np.random.default_rng(0)
    grid = [{"alpha": float(a), "beta": float(b),
             "train_err": float(rng.random()), "test_err": float(rng.random())}
            for a in np.linspace(-1, 2, 5) for b in np.linspace(0, 1, 5)]
    _jax_landscape_viz().ascii_map(grid, "train_err")
    want = capsys.readouterr().out
    t_viz.ascii_map(grid, "train_err")
    assert capsys.readouterr().out == want
    res = {"points": {"LB": (0.0, 0.0)}, "grid": grid,
           "train_err": {}, "test_err": {}}
    monkeypatch.setattr(t_viz, "run", lambda **kw: res)
    monkeypatch.chdir(tmp_path)
    assert t_viz.main(["--device", "cpu"]) is res
    assert (tmp_path / "results" / "figure23_torch.json").exists()
    lines = capsys.readouterr().out
    assert "train_err (low" in lines and "test_err (low" in lines


def test_figure4_cosines_match_jax(monkeypatch):
    _cnn_tasks(monkeypatch, j_f4, t_f4, n_train=512, n_test=256)
    for mod in (j_f4, t_f4):
        monkeypatch.setattr(mod, "STEPS", 8)
    jout = j_f4.run(verbose=False)
    tout = t_f4.run(verbose=False, device="cpu")
    assert len(tout["sims"]) == len(jout["sims"]) == 8
    np.testing.assert_allclose(tout["sims"], jout["sims"], rtol=TOL,
                               atol=TOL)
    for key in ("early_mean", "late_mean"):
        np.testing.assert_allclose(tout[key], jout[key], rtol=TOL, atol=TOL)


def test_worker_ablation_matches_jax(monkeypatch):
    _cnn_tasks(monkeypatch, j_abl, t_abl, n_train=512, n_test=512)
    base = dict(j_abl.BASE, b1=256, steps1=2, steps2=2)
    for mod in (j_abl, t_abl):
        monkeypatch.setattr(mod, "BASE", base)
    jout = j_abl.run(seeds=(0,), verbose=False)
    runs = []
    tout = t_abl.run(seeds=(0,), verbose=False, device="cpu", results=runs)
    assert list(tout) == list(jout) == [1, 2, 4, 8]
    assert [r["workers"] for r in runs] == [1, 2, 4, 8]
    for W in jout:
        for key in ("before", "after"):
            np.testing.assert_allclose(tout[W][key], jout[W][key], atol=HIT,
                                       err_msg=f"W {W} {key}")
