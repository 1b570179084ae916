"""Port's Mamba-2 (ssm family) against the JAX package's, on the CPU.

JAX ``Model.init`` params of the f32 mamba2 smoke config are carried over
with ``params_from_numpy``; the same numpy tokens go through both packages.
atol = rtol = 1e-4 for layers, logits, caches and decode (the JAX SSD
tests' bound); one train step 1e-5 on the relative L2 of the param update;
serving token for token.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt  # noqa: E402
from repro.configs.base import ScheduleConfig as JSched  # noqa: E402
from repro.core.adapters import LMAdapter as JAdapter  # noqa: E402
from repro.core.schedules import schedule_fn as jschedule  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_markov_lm  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.checkpoint.io import _items, params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import OptimizerConfig  # noqa: E402
from repro_torch.configs.base import ScheduleConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.schedules import schedule_fn  # noqa: E402
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ssd import kernel as tkernel  # noqa: E402
from repro_torch.kernels.ssd import ops as tops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.train.steps import lm_loss_and_metrics  # noqa: E402

ARCH = "mamba2-2.7b"
TOL = 1e-4
STEP_TOL = 1e-5


def _pair(**overrides):
    jcfg = dataclasses.replace(jreg.get_smoke_config(ARCH), **overrides)
    tcfg = dataclasses.replace(treg.get_smoke_config(ARCH), **overrides)
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


def test_params_share_key_paths_and_shapes():
    """The port's own init gives the reference's tree: the stacked
    (n_units, 1, ...) blocks/mamba/* and blocks/ln1 leaves."""
    jm = JModel(jreg.get_smoke_config(ARCH))
    tm = TModel(treg.get_smoke_config(ARCH))
    want = {k: v.shape for k, v in _flat(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0))).items()}
    params = tm.init(torch.Generator().manual_seed(0))
    got = {k: tuple(v.shape) for k, v in _items(params)}
    assert got == want
    assert {k.split("/")[-1] for k in got if k.startswith("blocks/mamba")} \
        == {"in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
            "norm_scale", "out_proj"}


def test_init_distributions():
    """softplus(dt_bias) spans [dt_min, dt_max], A = exp(A_log) lies in
    a_init_range, D and norm_scale are ones, conv_b zeros."""
    cfg = treg.get_smoke_config(ARCH)
    p = TModel(cfg).init(torch.Generator().manual_seed(1))["blocks"]["mamba"]
    s = cfg.ssm
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= s.dt_min * 0.999
    assert float(dt.max()) <= s.dt_max * 1.001
    A = torch.exp(p["A_log"])
    assert float(A.min()) >= s.a_init_range[0]
    assert float(A.max()) <= s.a_init_range[1]
    assert bool((p["D"] == 1).all()) and bool((p["norm_scale"] == 1).all())
    assert bool((p["conv_b"] == 0).all())


def test_gated_rmsnorm_and_causal_conv_match_jax():
    rng = np.random.default_rng(2)
    x, z = (rng.standard_normal((2, 7, 48)).astype(np.float32)
            for _ in range(2))
    scale = rng.standard_normal(48).astype(np.float32)
    want = jlayers.gated_rmsnorm(jnp.asarray(x), jnp.asarray(z),
                                 jnp.asarray(scale), 1e-6)
    got = tlayers.gated_rmsnorm(torch.from_numpy(x), torch.from_numpy(z),
                                torch.from_numpy(scale), 1e-6)
    _close(got, want)
    for S in (1, 3, 11):                  # shorter and longer than d_conv
        xbc = rng.standard_normal((2, S, 40)).astype(np.float32)
        w = rng.standard_normal((4, 40)).astype(np.float32)
        b = rng.standard_normal(40).astype(np.float32)
        want = jmamba._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                   jnp.asarray(b), jnp.float32)
        got = tmamba._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                                  torch.from_numpy(b), torch.float32)
        _close(got, want)


@pytest.mark.parametrize("S", [40, 70, 2])   # one chunk; padded to 2; < d_conv
def test_apply_prefill_decode_match_jax(S):
    jm, jp, tm, tp = _pair()
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
    assert set(tflat) == set(jflat) == {"units/0/m/conv", "units/0/m/state"}
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        _close(tflat[key], leaf)

    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), S + i)
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(), S + i)
        _close(tlog, jlog)
        _close(tlog, jl[:, S + i])        # decode continues the full forward


def test_empty_cache_matches_jax():
    jm, _, tm, _ = _pair()
    jc, tc = jm.empty_cache(3, 16), tm.empty_cache(3, 16, "cpu")
    tflat = dict(_items(tc))
    for key, leaf in _flat(jc).items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        assert str(tflat[key].dtype).split(".")[-1] == str(leaf.dtype), key
        assert not bool(tflat[key].any())


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lengths]


def test_engine_is_token_exact():
    """Five prompts through two slots: the port's engine equals the port's
    single-request generation and JAX's engine, token for token (the
    stacked (conv, state) caches go to batch dim 1 under ``units``)."""
    jm, jp, tm, tp = _pair()
    prompts = _prompts(tm.cfg, [9, 17, 5, 12, 8], seed=3)
    teng = TEngine(tm, tp, max_batch=2, max_seq=64)
    got = teng.run([TRequest(rid=i, prompt=torch.from_numpy(p),
                             max_new_tokens=6) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        ref, _ = tserve.generate(tm, tp, torch.from_numpy(p)[None], 6)
        assert got[i] == ref[0].tolist()
    jeng = JEngine(jm, jp, max_batch=2, max_seq=64)
    want = jeng.run([JRequest(rid=i, prompt=jnp.asarray(p), max_new_tokens=6)
                     for i, p in enumerate(prompts)])
    assert got == want
    assert teng.active == 0 and not teng.waiting


def test_mamba_forward_refuses_compiled_engine_arguments():
    _, _, tm, tp = _pair()
    u = torch.zeros(1, 4, tm.cfg.d_model)
    p = {k: v[0, 0] for k, v in tp["blocks"]["mamba"].items()}
    with pytest.raises(NotImplementedError, match="A12"):
        tmamba.mamba_forward(p, u, tm.cfg, length=3)
    with pytest.raises(NotImplementedError, match="A12"):
        tmamba.mamba_forward(p, u, tm.cfg, init_cache={})


def test_hybrid_is_refused_naming_its_item():
    with pytest.raises(NotImplementedError, match="A11.*112"):
        TModel(treg.get_config("zamba2-7b"))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(cfg, n=16, seq_len=24, seed=0):
    data = make_markov_lm(seed, vocab=cfg.vocab_size, n_train=n, n_test=8,
                          seq_len=seq_len)
    return {"tokens": data["train_tokens"], "labels": data["train_labels"]}


def test_one_train_step_matches_jax():
    """One SGD step of the LM adapter in both packages from JAX's init:
    the param update agrees to 1e-5 in relative L2, the loss to 1e-5."""
    jcfg, tcfg = jreg.get_smoke_config(ARCH), treg.get_smoke_config(ARCH)
    jad, tad = JAdapter(jcfg, JOpt()), LMAdapter(tcfg, OptimizerConfig())
    tr = _batch(tcfg)
    jb = jad.init(jax.random.PRNGKey(1))
    tb = {"params": params_from_numpy(jax.device_get(jb["params"])),
          "state": {}}
    j0 = jax.device_get(jb["params"])
    jstep = jad.make_train_step(jschedule(JSched(kind="const", peak_lr=0.1)))
    tstep = tad.make_train_step(schedule_fn(ScheduleConfig(kind="const",
                                                           peak_lr=0.1)))
    from repro.train.precision import resolve_policy as jpol
    from repro_torch.train.precision import resolve_policy as tpol
    jb, _, _, jm = jstep(jb, jad.init_opt(jb), JLoader(tr, 16).batch(0), 0,
                         jpol("float32").init_scale_state())
    tb, _, _, tm = tstep(tb, tad.init_opt(tb), Loader(tr, 16).batch(0), 0,
                         tpol("float32").init_scale_state())
    t, j, z = (dict(_items(tb["params"])), _flat(jax.device_get(jb["params"])),
               _flat(j0))
    num = sum(((t[k].numpy() - np.asarray(j[k])) ** 2).sum() for k in j)
    den = sum(((np.asarray(j[k]) - np.asarray(z[k])) ** 2).sum() for k in j)
    assert den > 0 and float(np.sqrt(num / den)) <= STEP_TOL
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=STEP_TOL)


def _grads(model, params, batch):
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    tree = _rebuild(params, it)
    loss, _ = lm_loss_and_metrics(model, tree, batch)
    return torch.autograd.grad(loss, leaves)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_memory_not_numbers(policy):
    cfg = treg.get_smoke_config(ARCH)
    tr = _batch(cfg, n=4, seq_len=16)
    batch = {k: torch.from_numpy(v.copy()) for k, v in tr.items()}
    params = TModel(cfg).init(torch.Generator().manual_seed(0))
    grads = [_grads(TModel(dataclasses.replace(cfg, remat=remat,
                                               remat_policy=policy)),
                    params, batch) for remat in (False, True)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_model_grads_through_the_function_equal_plain_autograd(monkeypatch):
    """``ssd_impl="kernel"`` under remat "dots", with a test-only dispatch
    that sends the Function's launches to the plain twins on the CPU: the
    whole model's grads equal autograd through the plain scan, and each
    layer runs the Function's backward once (its forward twice: remat)."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(x, dt, A, Bm, Cm, *, chunk):
        calls["fwd"] += 1
        return tops._intra_chunk(x, dt, A, Bm, Cm, chunk)

    def bwd(*args, chunk):
        calls["bwd"] += 1
        return tops._intra_chunk_bwd(*args, chunk)

    resolve = dispatch.resolve
    monkeypatch.setattr(dispatch, "resolve", lambda impl, dev: (
        "kernel" if impl == "kernel" else resolve(impl, dev)))
    monkeypatch.setattr(tkernel, "ssd_fwd", fwd)
    monkeypatch.setattr(tkernel, "ssd_bwd", bwd)
    cfg = dataclasses.replace(treg.get_smoke_config(ARCH), remat=True,
                              remat_policy="dots")
    tr = _batch(cfg, n=4, seq_len=40)
    batch = {k: torch.from_numpy(v.copy()) for k, v in tr.items()}
    params = TModel(cfg).init(torch.Generator().manual_seed(2))
    got = _grads(TModel(dataclasses.replace(cfg, ssd_impl="kernel")), params,
                 batch)
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}
    want = _grads(TModel(dataclasses.replace(cfg, ssd_impl="reference")),
                  params, batch)
    for a, b in zip(got, want):
        assert bool(b.abs().max() > 0)
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)


def test_launcher_runs_swap_on_cpu(capsys):
    """``launch.train --arch mamba2-2.7b --device cpu``: a short SWAP run
    (W 2, elastic) finishes all three phases with finite numbers."""
    res = tlaunch.main(["--arch", ARCH, "--device", "cpu", "--workers", "2",
                        "--phase1-steps", "3", "--phase2-steps", "2",
                        "--phase1-batch", "32", "--phase2-batch", "8",
                        "--seq-len", "16", "--elastic-deadline", "30"])
    assert res["phase1_steps"] == 3 and res["phase2_steps"] == 2
    assert res["phase2_live_workers"] == 2
    vals = [res[k] for k in ("phase1_test_acc", "before_avg_test_acc",
                             "after_avg_test_acc")] + res["worker_test_accs"]
    assert all(np.isfinite(v) for v in vals)
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke family=ssm" in out and "SWAP: before avg" in out


def test_build_takes_a_config():
    """``launch.train.build(args, cfg=...)`` runs the launcher's own run on
    a given config (chip_smoke.py and profile_train cut the depth so)."""
    args = tlaunch.build_parser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--workers", "2"])
    cfg = dataclasses.replace(treg.get_smoke_config(ARCH), n_layers=1)
    swap = tlaunch.build(args, cfg=cfg)
    assert swap.adapter.cfg is cfg and swap.adapter.model.n_units == 1
    with pytest.raises(ValueError, match="arch"):
        tlaunch.build(args, cfg=treg.get_smoke_config("internlm2-1.8b"))
