"""Port's hybrid family (zamba2) against the JAX package's, on the CPU.

Two f32 configs: the zamba2 smoke config (4 mamba layers in 2 pattern
units of 2, each preceded by the ONE shared attention block) and the same
at 5 layers (2 units and a tail of 1 mamba layer, which no shared block
precedes). JAX ``Model.init`` params are carried over with
``params_from_numpy``; the same numpy tokens go through both packages.
atol = rtol = 1e-4 for logits, caches and decode (as the mamba2 tests);
one train step's loss and every grad leaf (the shared block's, summed over
its applications, among them) 1e-5 in relative L2, as the step's update;
serving token for token; a SWAP run's losses and averaged params 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core.adapters import LMAdapter as JAdapter  # noqa: E402
from repro.core.swap import SWAP as JSWAP  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_markov_lm  # noqa: E402
from repro.dist.config import DistConfig as JDist  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.train.steps import lm_loss_and_metrics as jloss  # noqa: E402
from repro_torch.checkpoint.io import _items, params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.swap import SWAP  # noqa: E402
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.dist.config import DistConfig  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.ssd import kernel as skernel  # noqa: E402
from repro_torch.kernels.ssd import ops as sops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.train.steps import lm_loss_and_metrics  # noqa: E402

ARCH = "zamba2-7b"
TOL = 1e-4
STEP_TOL = 1e-5
# the smoke config (2 units of 2 mamba layers, no tail) and the same with a
# tail of one mamba layer
CONFIGS = {"units": {}, "tail": {"n_layers": 5}}


def _cfgs(case, **over):
    over = {**CONFIGS[case], **over}
    return (dataclasses.replace(jreg.get_smoke_config(ARCH), **over),
            dataclasses.replace(treg.get_smoke_config(ARCH), **over))


def _pair(case, **over):
    jcfg, tcfg = _cfgs(case, **over)
    jm, tm = JModel(jcfg), TModel(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(jax.device_get(jp))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_params_share_key_paths_and_shapes(case):
    """The port's own init gives the reference's tree: stacked mamba
    ``blocks`` (and ``tail``), and the one unstacked attention block with
    its MLP at ``shared``."""
    jcfg, tcfg = _cfgs(case)
    want = {k: v.shape for k, v in _flat(jax.eval_shape(
        JModel(jcfg).init, jax.random.PRNGKey(0))).items()}
    model = TModel(tcfg)
    got = {k: tuple(v.shape) for k, v in _items(
        model.init(torch.Generator().manual_seed(0)))}
    assert got == want
    d = tcfg.d_model
    assert got["shared/attn/wq"] == (d, tcfg.n_heads * tcfg.head_dim)
    assert got["shared/mlp/wi"] == (d, tcfg.d_ff)
    assert ("tail/mamba/in_proj" in got) == (case == "tail")
    assert (model.n_units, len(model.unit_kinds), len(model.tail_kinds)) == (
        2, 2, 1 if case == "tail" else 0)


def test_full_config_head_dim_and_params():
    """zamba2-7b at full config (its plan: test_torch_mamba2.py): one
    shared block of 32 heads of 112 (G 1), a head dim both flash kernels
    take; 6.75 B parameters, as the reference counts them."""
    cfg = treg.get_config(ARCH)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (32, 32, 112)
    assert cfg.head_dim in fkernel.FWD_HEAD_DIMS
    assert cfg.head_dim in fkernel.BWD_HEAD_DIMS
    assert abs(cfg.param_count() / 1e9 - 6.75) < 0.01
    assert cfg.param_count() == jreg.get_config(ARCH).param_count()


@pytest.mark.parametrize("S", [40, 2])     # two SSD chunks; under d_conv
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_apply_prefill_decode_match_jax(case, S):
    jm, jp, tm, tp = _pair(case)
    B, T = 2, 3
    toks = _tokens(jm.cfg, (B, S + T), seed=S)
    jl, _ = jm.apply(jp, jnp.asarray(toks))
    tl, aux = tm.apply(tp, torch.from_numpy(toks).long())
    _close(tl, jl)
    assert float(aux) == 0.0

    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + T)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                          cache_len=S + T)
    _close(tlog, jlog)
    tflat, jflat = dict(_items(tc)), _flat(jc)
    assert set(tflat) == set(jflat)
    assert {"units/shared/a/k", "units/shared/a/v"} <= set(tflat)
    assert ("t0/m/state" in tflat) == (case == "tail")
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        _close(tflat[key], leaf)
    # each unit's application of the shared block keeps its own K/V
    k = tflat["units/shared/a/k"]
    assert k.shape[:3] == (2, B, S + T) and not torch.equal(k[0], k[1])

    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), S + i)
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(), S + i)
        _close(tlog, jlog)
        _close(tlog, jl[:, S + i])        # decode continues the full forward
    for key, leaf in _flat(jc).items():
        _close(dict(_items(tc))[key], leaf)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_empty_cache_matches_jax(case):
    jm, _, tm, _ = _pair(case)
    jc, tc = jm.empty_cache(3, 16), tm.empty_cache(3, 16, "cpu")
    tflat, jflat = dict(_items(tc)), _flat(jc)
    assert set(tflat) == set(jflat)
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        assert str(tflat[key].dtype).split(".")[-1] == str(leaf.dtype), key
        assert not bool(tflat[key].any())


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lengths]


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_engine_is_token_exact(case):
    """Five prompts through two slots: the port's engine equals the port's
    single-request generation and JAX's engine, token for token (each
    unit's shared K/V cache and the mamba states scattered into a slot)."""
    jm, jp, tm, tp = _pair(case)
    prompts = _prompts(tm.cfg, [9, 17, 5, 12, 8], seed=3)
    teng = TEngine(tm, tp, max_batch=2, max_seq=48)
    got = teng.run([TRequest(rid=i, prompt=torch.from_numpy(p),
                             max_new_tokens=5) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        ref, _ = tserve.generate(tm, tp, torch.from_numpy(p)[None], 5)
        assert got[i] == ref[0].tolist()
    jeng = JEngine(jm, jp, max_batch=2, max_seq=48)
    want = jeng.run([JRequest(rid=i, prompt=jnp.asarray(p), max_new_tokens=5)
                     for i, p in enumerate(prompts)])
    assert got == want
    assert set(teng.cache["units"]["shared"]["a"]) == {"k", "v"}


def _batch(cfg, n=8, seq_len=24, seed=0):
    data = make_markov_lm(seed, vocab=cfg.vocab_size, n_train=n, n_test=8,
                          seq_len=seq_len)
    return {"tokens": data["train_tokens"], "labels": data["train_labels"]}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_train_step_loss_and_grads_match_jax(case):
    """The LM loss and every grad leaf against ``jax.value_and_grad`` of
    the reference's, from JAX's init, remat on (the shared block inside
    each unit's region): the shared block's grad is the sum over its
    applications in both."""
    jcfg, tcfg = _cfgs(case, remat=True)
    jad, tad = JAdapter(jcfg, jbase.OptimizerConfig()), LMAdapter(
        tcfg, tbase.OptimizerConfig())
    jp = jad.init(jax.random.PRNGKey(1))["params"]
    tp = params_from_numpy(jax.device_get(jp))
    tr = _batch(tcfg)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss(jad.model, p, {k: jnp.asarray(v)
                                       for k, v in tr.items()}),
        has_aux=True)(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl, _ = lm_loss_and_metrics(tad.model, tp, {
        k: torch.from_numpy(v.copy()) for k, v in tr.items()})
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=STEP_TOL)
    jflat = _flat(jax.device_get(jg))
    keys = sorted(jflat)
    assert keys == [k for k, _ in _items(tp)]
    assert any(k.startswith("shared/attn/") for k in keys)
    for k, got in zip(keys, tg):
        assert float(np.abs(jflat[k]).max()) > 0, k
        assert _rel_l2(got.numpy(), jflat[k]) <= STEP_TOL, k


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_memory_not_numbers(policy):
    """Each unit with its shared block under torch.utils.checkpoint gives
    the grads of the plain forward bit for bit."""
    _, cfg = _cfgs("tail")
    tr = _batch(cfg, n=4, seq_len=16)
    batch = {k: torch.from_numpy(v.copy()) for k, v in tr.items()}
    params = TModel(cfg).init(torch.Generator().manual_seed(0))
    grads = []
    for remat in (False, True):
        model = TModel(dataclasses.replace(cfg, remat=remat,
                                           remat_policy=policy))
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = lm_loss_and_metrics(model, _rebuild(params, iter(leaves)),
                                      batch)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def test_kernel_launches_follow_the_layer_plan(monkeypatch):
    """``attention_impl`` and ``ssd_impl`` "kernel" under remat "dots",
    with a test-only dispatch that sends the Functions' launches to the
    plain versions on the CPU: one step runs the flash forward twice a
    unit (remat), its backward once a unit, the SSD forward twice in each
    unit's layers and once in the tail's, its backward once a layer; and
    the grads equal plain autograd's."""
    calls = dict.fromkeys(("fa_fwd", "fa_bwd", "ssd_fwd", "ssd_bwd"), 0)

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    resolve = dispatch.resolve
    monkeypatch.setattr(dispatch, "resolve", lambda impl, dev: (
        "kernel" if impl == "kernel" else resolve(impl, dev)))
    monkeypatch.setattr(fkernel, "flash_fwd", counted(
        "fa_fwd", lambda q, k, v, **kw: fops._blockwise_fwd(
            q, k, v, chunk=512, **kw)))
    monkeypatch.setattr(fkernel, "flash_bwd", counted(
        "fa_bwd", fref.flash_attention_bwd_ref))
    monkeypatch.setattr(skernel, "ssd_fwd", counted(
        "ssd_fwd", lambda *a, chunk: sops._intra_chunk(*a, chunk)))
    monkeypatch.setattr(skernel, "ssd_bwd", counted(
        "ssd_bwd", lambda *a, chunk: sops._intra_chunk_bwd(*a, chunk)))
    _, cfg = _cfgs("tail", remat=True, remat_policy="dots")
    tr = _batch(cfg, n=4, seq_len=40)
    batch = {k: torch.from_numpy(v.copy()) for k, v in tr.items()}
    params = TModel(cfg).init(torch.Generator().manual_seed(2))
    grads = {}
    for impl in ("kernel", "reference"):
        model = TModel(dataclasses.replace(cfg, attention_impl=impl,
                                           ssd_impl=impl))
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = lm_loss_and_metrics(model, _rebuild(params, iter(leaves)),
                                      batch)
        grads[impl] = torch.autograd.grad(loss, leaves)
        if impl == "kernel":
            units, in_units = model.n_units, model.n_units * len(
                model.unit_kinds)
            assert calls == {"fa_fwd": 2 * units, "fa_bwd": units,
                             "ssd_fwd": 2 * in_units + len(model.tail_kinds),
                             "ssd_bwd": cfg.n_layers}
    for a, b in zip(grads["kernel"], grads["reference"]):
        assert bool(b.abs().max() > 0)
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)


def test_launcher_runs_swap_on_cpu(capsys):
    """``launch.train --arch zamba2-7b --device cpu``: a short SWAP run
    (W 2, elastic) finishes all three phases with finite numbers."""
    res = tlaunch.main(["--arch", ARCH, "--device", "cpu", "--workers", "2",
                        "--phase1-steps", "3", "--phase2-steps", "2",
                        "--phase1-batch", "16", "--phase2-batch", "8",
                        "--seq-len", "16", "--elastic-deadline", "30"])
    assert res["phase1_steps"] == 3 and res["phase2_steps"] == 2
    assert res["phase2_live_workers"] == 2
    vals = ([e["loss"] for e in res["phase1_log"]]
            + [res[k] for k in ("phase1_test_acc", "before_avg_test_acc",
                                "after_avg_test_acc")]
            + res["worker_test_accs"])
    assert all(np.isfinite(v) for v in vals)
    assert "shared" in res["final_bundle"]["params"]
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke family=hybrid" in out
    assert "SWAP: before avg" in out


class FromJax(LMAdapter):
    """The port's LM adapter, initialized with JAX's params."""

    def __init__(self, cfg, opt_cfg, jax_params):
        super().__init__(cfg, opt_cfg)
        self.jax_params = jax.device_get(jax_params)

    def init(self, gen):
        return {"params": params_from_numpy(self.jax_params,
                                            device=gen.device), "state": {}}


def _swap_cfg(b):
    sched = b.ScheduleConfig(kind="warmup_linear", peak_lr=0.2,
                             warmup_steps=1, total_steps=4)
    return b.SWAPConfig(
        n_workers=2, seed=3,
        phase1=b.PhaseConfig(batch_size=16, max_steps=4, schedule=sched),
        phase2=b.PhaseConfig(batch_size=8, max_steps=3,
                             schedule=b.ScheduleConfig(
                                 kind="warmup_linear", peak_lr=0.05,
                                 total_steps=3)))


def test_swap_trajectory_matches_jax():
    """A smoke SWAP run (the tail config, W 2, elastic phase 3) in both
    packages from JAX's init on the same data: the phase-1 losses and the
    averaged params within 1e-4, step counts and live workers exactly."""
    jcfg, tcfg = _cfgs("tail")
    data = make_markov_lm(0, vocab=tcfg.vocab_size, n_train=256, n_test=32,
                          seq_len=16)
    train = {"tokens": data["train_tokens"], "labels": data["train_labels"]}
    test = {"tokens": data["test_tokens"], "labels": data["test_labels"]}
    jad = JAdapter(jcfg, jbase.OptimizerConfig())
    tad = FromJax(tcfg, tbase.OptimizerConfig(),
                  jad.init(jax.random.PRNGKey(0))["params"])
    dist = dict(n_workers=2, elastic_deadline_s=10.0)
    jres = JSWAP(jad, _swap_cfg(jbase), train, JLoader(test, 16),
                 dist=JDist(**dist)).run(jax.random.PRNGKey(0))
    tres = SWAP(tad, _swap_cfg(tbase), train, Loader(test, 16),
                dist=DistConfig(**dist)).run(torch.Generator())
    for key in ("phase1_steps", "phase2_steps", "phase2_live_workers"):
        assert tres[key] == jres[key], key
    np.testing.assert_allclose([e["loss"] for e in tres["phase1_log"]],
                               [e["loss"] for e in jres["phase1_log"]],
                               rtol=TOL)
    got = dict(_items(tres["final_bundle"]["params"]))
    want = _flat(jax.device_get(jres["final_bundle"]["params"]))
    assert set(got) == set(want) and "shared/attn/wo" in got
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=k)
