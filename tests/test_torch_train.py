"""The port's training stack against JAX's, on the CPU: the LM loss and
its grads, the precision step (f32, bf16, f16 with dynamic scaling and the
overflow skip, grad accumulation), the phase engine (per-step logs, early
exit at epoch boundaries, mid-chunk realignment) and the phase-2 ensemble.

JAX params are carried over with ``params_from_numpy`` and both packages
read the same numpy data through their (bitwise equal) loaders.
Tolerances: one step 1e-5 relative (loss, updated params; grads 1e-4 with
1e-6 absolute, as they are small sums of products taken in another order);
short trajectories 1e-4. Reduced-precision compute is held on the update:
the relative L2 distance of the two packages' param updates, 3e-2 for bf16
and 5e-3 for f16 (measured 9.4e-3 and 1.35e-3: the two frameworks round
the bf16/f16 intermediates at different places, see ROADMAP C).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt  # noqa: E402
from repro.configs.base import ScheduleConfig as JSched  # noqa: E402
from repro.core.adapters import LMAdapter as JAdapter  # noqa: E402
from repro.core.schedules import schedule_fn as jschedule  # noqa: E402
from repro.core.swap import _stack_bundles as jstack  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_markov_lm  # noqa: E402
from repro.optim.api import init_optimizer as jinit_opt  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import precision as jprec  # noqa: E402
from repro.train.steps import lm_loss_and_metrics as jloss  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import OptimizerConfig  # noqa: E402
from repro_torch.configs.base import ScheduleConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.schedules import schedule_fn  # noqa: E402
from repro_torch.core.swap import _stack_bundles  # noqa: E402
from repro_torch.data.pipeline import Loader  # noqa: E402
from repro_torch.optim.api import init_optimizer, tree_leaves  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import precision as tprec  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    lm_loss_and_metrics, make_lm_eval_fn, make_lm_train_step,
)

STEP_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
TRAJ_TOL = 1e-4
UPDATE_TOL = {"bfloat16": 3e-2, "float16": 5e-3}

TINY = dict(name="tiny-lm", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=32,
            attention="gqa", dtype="float32", remat=False,
            scan_layers=False)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _close_trees(t_tree, j_tree, rtol, atol):
    t, j = _flat(t_tree), _flat(jax.device_get(j_tree))
    assert t.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(
            t[k].detach().float().numpy(), np.asarray(j[k], np.float32),
            rtol=rtol, atol=atol, err_msg=k)


def _to_torch(tree):
    return params_from_numpy(jax.device_get(tree))


def _pair(cfg_kw, opt_kw=None):
    opt_kw = opt_kw or dict(kind="sgd")
    jad = JAdapter(JModelConfig(**cfg_kw), JOpt(**opt_kw))
    tad = LMAdapter(ModelConfig(**cfg_kw), OptimizerConfig(**opt_kw))
    return jad, tad


def _data(vocab, n_train=128, seq_len=16, seed=0):
    data = make_markov_lm(seed, vocab=vocab, n_train=n_train, n_test=32,
                          seq_len=seq_len)
    return {"tokens": data["train_tokens"], "labels": data["train_labels"]}


def _start(jad, key=1):
    """JAX's init, and the same params and a fresh optimizer state in the
    port."""
    jb = jad.init(jax.random.PRNGKey(key))
    tb = {"params": _to_torch(jb["params"]), "state": {}}
    return jb, tb


# ---------------------------------------------------------------------------
# loss and grads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen2.5-14b",
                                  "mamba2-2.7b"])
def test_lm_loss_metrics_and_grads_match_jax(arch):
    jcfg, tcfg = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    jad = JAdapter(jcfg, JOpt())
    tad = LMAdapter(tcfg, OptimizerConfig())
    jb, tb = _start(jad)
    tr = _data(tcfg.vocab_size, n_train=8, seq_len=24)
    jbatch = {k: jnp.asarray(v) for k, v in tr.items()}
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in tr.items()}

    (jl, jm), jg = jax.value_and_grad(
        lambda p: jloss(jad.model, p, jbatch), has_aux=True)(jb["params"])
    leaves = [t.requires_grad_() for t in tree_leaves(tb["params"])]
    tl, tm = lm_loss_and_metrics(tad.model, tb["params"], tbatch)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=STEP_TOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    jflat = _flat(jax.device_get(jg))
    for (k, want), got in zip(sorted(jflat.items()), tg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    ev = make_lm_eval_fn(tad.model)(tb["params"], tbatch)
    assert float(ev["accuracy"]) == float(jm["accuracy"])


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_memory_not_numbers(policy):
    """Each pattern unit under torch.utils.checkpoint (with the "dots"
    policy, saving the weight matmuls' outputs) gives the grads of the
    plain forward bit for bit."""
    cfg = treg.get_smoke_config("internlm2-1.8b")
    tr = _data(cfg.vocab_size, n_train=4, seq_len=16)
    batch = {k: torch.from_numpy(v.copy()) for k, v in tr.items()}
    params = LMAdapter(cfg, OptimizerConfig()).init(
        torch.Generator().manual_seed(0))["params"]
    grads = []
    for remat in (False, True):
        model = LMAdapter(dataclasses.replace(
            cfg, remat=remat, remat_policy=policy), OptimizerConfig()).model
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(leaves)
        tree = tree_map_sorted(params, it)
        loss, _ = lm_loss_and_metrics(model, tree, batch)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def tree_map_sorted(tree, it):
    if isinstance(tree, dict):
        return {k: tree_map_sorted(tree[k], it) for k in sorted(tree)}
    return next(it)


# ---------------------------------------------------------------------------
# the precision step
# ---------------------------------------------------------------------------


def _run_pair(jad, tad, tr, *, policy="float32", k=1, n=3, peak_lr=0.1):
    """n steps of adapter.make_train_step in both packages from the same
    start; returns (jax bundle, port bundle, jax metrics, port metrics)."""
    jpol, tpol = jprec.resolve_policy(policy), tprec.resolve_policy(policy)
    jstep = jax.jit(jad.make_train_step(
        jschedule(JSched(kind="const", peak_lr=peak_lr)), policy=jpol,
        grad_accum_steps=k))
    tstep = tad.make_train_step(
        schedule_fn(ScheduleConfig(kind="const", peak_lr=peak_lr)),
        policy=tpol, grad_accum_steps=k)
    jl, tl = JLoader(tr, 32, seed=3), Loader(tr, 32, seed=3)
    jb, tb = _start(jad)
    jo, to = jad.init_opt(jb), tad.init_opt(tb)
    js, ts = jpol.init_scale_state(), tpol.init_scale_state()
    for s in range(n):
        jb, jo, js, jm = jstep(jb, jo, jl.batch(s), s, js)
        tb, to, ts, tm = tstep(tb, to, tl.batch(s), s, ts)
    return jb, tb, jm, tm, (jo, to)


def test_f32_step_matches_jax():
    jad, tad = _pair(TINY)
    tr = _data(32)
    jb, tb, jm, tm, (jo, to) = _run_pair(jad, tad, tr, n=1)
    _close_trees(tb["params"], jb["params"], STEP_TOL, STEP_TOL)
    _close_trees(to["mu"], jo["mu"], GRAD_RTOL, GRAD_ATOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=STEP_TOL)
    assert float(tm["lr"]) == float(jm["lr"])
    jb, tb, jm, tm, _ = _run_pair(jad, tad, tr, n=4)
    _close_trees(tb["params"], jb["params"], TRAJ_TOL, TRAJ_TOL)


def _update_distance(tb, jb, j0):
    """||port update - JAX update|| / ||JAX update|| over all params."""
    t, j = _flat(tb["params"]), _flat(jax.device_get(jb["params"]))
    z = _flat(jax.device_get(j0["params"]))
    num = sum(((t[k].numpy() - np.asarray(j[k])) ** 2).sum() for k in j)
    den = sum(((np.asarray(j[k]) - np.asarray(z[k])) ** 2).sum() for k in j)
    return float(np.sqrt(num / den))


@pytest.mark.parametrize("policy", ["bfloat16", "float16"])
def test_reduced_precision_step_matches_jax(policy):
    """bf16, and f16 with the 2**15 dynamic loss scale (finite steps
    unscale exactly: a power-of-two scale), for 3 steps: the updates agree
    to UPDATE_TOL, the loss to the same bound, and the scale state evolves
    identically."""
    jad, tad = _pair(TINY)
    jb, tb, jm, tm, _ = _run_pair(jad, tad, _data(32), policy=policy)
    j0, _ = _start(jad)
    assert _update_distance(tb, jb, j0) <= UPDATE_TOL[policy]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=UPDATE_TOL[policy])
    if policy == "float16":
        assert float(tm["skipped"]) == float(jm["skipped"]) == 0.0
        assert float(tm["loss_scale"]) == float(jm["loss_scale"]) == 2.0 ** 15


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_matches_jax_and_the_fused_batch(k):
    jad, tad = _pair(TINY)
    tr = _data(32)
    jb, tb, jm, tm, _ = _run_pair(jad, tad, tr, k=k)
    _close_trees(tb["params"], jb["params"], TRAJ_TOL, TRAJ_TOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=STEP_TOL)
    _, tb1, _, tm1, _ = _run_pair(jad, tad, tr, k=1)
    # tests/test_precision.py's bar for f32 accumulation
    _close_trees(tb["params"], jax.tree_util.tree_map(
        lambda t: np.asarray(t.detach()), tb1["params"]), 2e-5, 1e-6)


def test_grad_accum_rejects_bad_factor():
    _, tad = _pair(TINY)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        tad.make_train_step(schedule_fn(ScheduleConfig(kind="const")),
                            grad_accum_steps=0)
    with pytest.raises(ValueError, match="not divisible"):
        tprec.split_microbatches({"x": torch.zeros(6, 2)}, 4)
    micro = tprec.split_microbatches(
        {"x": torch.zeros(8, 2), "aug_seed": torch.tensor(3)}, 4)
    assert micro["x"].shape == (4, 2, 2) and micro["aug_seed"].tolist() == \
        [3, 3, 3, 3]


def test_dynamic_scaling_skips_nonfinite_steps_as_jax():
    """The transparent scalar model of tests/test_precision.py, through both
    packages: an overflow step leaves params and optimizer state untouched,
    backs the scale off and counts the skip; growth resumes after
    growth_interval finite steps."""
    kw = dict(name="test16", loss_scale=8.0, dynamic=True,
              growth_factor=2.0, backoff_factor=0.5, growth_interval=2)
    okw = dict(kind="sgd", momentum=0.0, nesterov=False, weight_decay=0.0)
    jpol, tpol = jprec.PrecisionPolicy(**kw), tprec.PrecisionPolicy(**kw)
    _, jupd = jinit_opt(JOpt(**okw))
    _, tupd = init_optimizer(OptimizerConfig(**okw))

    def jl(p, st, b):
        loss = jnp.sum(p["w"] * b["x"])
        return loss, ({"loss": loss, "accuracy": jnp.float32(1.0),
                       "aux": jnp.float32(0.0)}, st)

    def tl(p, st, b):
        loss = (p["w"] * b["x"]).sum()
        return loss, ({"loss": loss, "accuracy": torch.tensor(1.0),
                       "aux": torch.tensor(0.0)}, st)

    jstep = jprec.make_precision_train_step(jl, jupd, lambda s: 0.5,
                                            policy=jpol)
    tstep = tprec.make_precision_train_step(tl, tupd, lambda s: 0.5,
                                            policy=tpol)
    jb = {"params": {"w": jnp.asarray([1.0, 2.0])}, "state": {}}
    tb = {"params": {"w": torch.tensor([1.0, 2.0])}, "state": {}}
    jo, to = {"mu": {"w": jnp.zeros(2)}}, {"mu": {"w": torch.zeros(2)}}
    js, ts = jpol.init_scale_state(), tpol.init_scale_state()
    xs = [[3.0, -1.0], [np.inf, 0.0], [3.0, -1.0], [3.0, -1.0]]
    for s, x in enumerate(xs):
        jb, jo, js, jm = jstep(jb, jo, {"x": jnp.asarray(x)}, s, js)
        tb, to, ts, tm = tstep(tb, to, {"x": torch.tensor(x)}, s, ts)
        np.testing.assert_array_equal(tb["params"]["w"].numpy(),
                                      np.asarray(jb["params"]["w"]))
        np.testing.assert_array_equal(to["mu"]["w"].numpy(),
                                      np.asarray(jo["mu"]["w"]))
        assert [float(v) for v in ts] == [float(v) for v in js]
        assert float(tm["skipped"]) == float(jm["skipped"])
        assert float(tm["loss_scale"]) == float(jm["loss_scale"])
    assert float(ts.scale) == 8.0 and int(ts.skipped) == 1


def test_update_scale_dynamics_and_presets():
    pol = tprec.PrecisionPolicy(name="t", dynamic=True, loss_scale=16.0,
                                growth_interval=2)
    st = pol.init_scale_state()
    st = pol.update_scale(st, True)
    assert (float(st.scale), int(st.growth_count), int(st.skipped)) == \
        (16.0, 1, 0)
    st = pol.update_scale(st, True)
    assert (float(st.scale), int(st.growth_count)) == (32.0, 0)
    st = pol.update_scale(st, False)
    assert (float(st.scale), int(st.growth_count), int(st.skipped)) == \
        (16.0, 0, 1)
    for name in ("", "f32", "fp32", "bf16", "bfloat16", "f16", "fp16"):
        assert tprec.resolve_policy(name) == tprec.PrecisionPolicy(
            **dataclasses.asdict(jprec.resolve_policy(name)))
    with pytest.raises(ValueError, match="unknown precision preset"):
        tprec.resolve_policy("int8")
    with pytest.warns(DeprecationWarning, match="grad_dtype"):
        pol = tprec.resolve_policy("f32", OptimizerConfig(
            grad_dtype="bfloat16"))
    assert pol.grad_dtype == "bfloat16"
    stacked = tprec.stack_scale_state(tprec.F16.init_scale_state(), 3)
    assert stacked.scale.tolist() == [2.0 ** 15] * 3


def test_make_lm_train_step_matches_adapter_step():
    _, tad = _pair(TINY)
    sched = schedule_fn(ScheduleConfig(kind="const", peak_lr=0.1))
    init, step = make_lm_train_step(tad.model, tad.opt_cfg, sched)
    tr = _data(32)
    batch = Loader(tr, 32, seed=3).batch(0)
    p1 = tad.init(torch.Generator().manual_seed(0))["params"]
    p2 = {k: v for k, v in _to_torch(jax.device_get(
        jax.tree_util.tree_map(np.asarray, _flat(p1)))).items()}
    p2 = params_from_numpy(jax.tree_util.tree_map(
        lambda t: t.numpy().copy(), p1))
    new, _, m = step(p1, init(p1), batch, 0)
    b2, _, _, m2 = tad.make_train_step(sched)(
        {"params": p2, "state": {}}, tad.init_opt({"params": p2}), batch, 0,
        tprec.default_scale_state())
    for a, b in zip(tree_leaves(new), tree_leaves(b2["params"])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="dynamic loss scaling"):
        make_lm_train_step(tad.model, tad.opt_cfg, sched, policy=tprec.F16)


# ---------------------------------------------------------------------------
# the phase engine
# ---------------------------------------------------------------------------


def _engine_pair(n_train=128, batch=16):
    jad, tad = _pair(TINY)
    tr = _data(32, n_train=n_train)
    sk = dict(kind="warmup_linear", peak_lr=0.1, warmup_steps=3,
              total_steps=12)
    jstep = jad.make_train_step(jschedule(JSched(**sk)))
    tstep = tad.make_train_step(schedule_fn(ScheduleConfig(**sk)))
    return (jad, tad, jstep, tstep, JLoader(tr, batch, seed=3),
            Loader(tr, batch, seed=3))


def test_run_phase_log_matches_jax():
    """Phase 1 through the engines of both packages: per-step accuracy
    equal, loss/lr/ema and the final params within the trajectory bound."""
    jad, tad, jstep, tstep, jl, tl = _engine_pair()
    jb, tb = _start(jad)
    jst = jloop.init_train_state(jb, jad.init_opt(jb))
    tst = tloop.init_train_state(tb, tad.init_opt(tb))
    jlog, tlog = [], []
    jres = jloop.run_phase(jloop.EpochRunner(jstep, jl, 0.9), jst, 0,
                           max_steps=12, log=jlog)
    tres = tloop.run_phase(tloop.EpochRunner(tstep, tl, 0.9), tst, 0,
                           max_steps=12, log=tlog)
    assert tres.steps == jres.steps == 12
    assert [e["step"] for e in tlog] == [e["step"] for e in jlog]
    assert [e["accuracy"] for e in tlog] == [e["accuracy"] for e in jlog]
    for key in ("loss", "lr", "ema"):
        np.testing.assert_allclose([e[key] for e in tlog],
                                   [e[key] for e in jlog], rtol=TRAJ_TOL,
                                   err_msg=key)
    _close_trees(tres.state.bundle["params"],
                 jres.state.bundle["params"], TRAJ_TOL, TRAJ_TOL)


def test_early_exit_at_epoch_boundary():
    jad, tad, _, tstep, _, tl = _engine_pair()
    _, tb = _start(jad)
    runner = tloop.EpochRunner(tstep, tl, 0.9)
    res = tloop.run_phase(runner, tloop.init_train_state(
        tb, tad.init_opt(tb)), 0, max_steps=40, stop_accuracy=1e-6)
    assert res.steps == tl.steps_per_epoch == int(res.state.step)
    res2 = tloop.run_phase(runner, res.state, 0, max_steps=40,
                           stop_accuracy=1e-6)
    assert res2.steps == 0 and int(res2.state.step) == tl.steps_per_epoch


def test_mid_chunk_entry_realigns_to_epoch_boundaries():
    """A phase entered 3 steps into an epoch runs a first chunk to the
    boundary (step 8), then whole epochs; the trajectory is the
    uninterrupted per-step loop's, bitwise."""
    jad, tad, _, tstep, _, tl = _engine_pair()
    assert tl.steps_per_epoch == 8

    def entry():
        _, tb = _start(jad)
        st, _ = tloop.python_loop_reference(
            tstep, tl, tloop.init_train_state(tb, tad.init_opt(tb)),
            n_steps=3, ema_beta=0.9)
        return st

    boundaries, log = [], []
    res = tloop.run_phase(tloop.EpochRunner(tstep, tl, 0.9), entry(), 0,
                          max_steps=10, log=log,
                          on_chunk=lambda st, done: boundaries.append(
                              int(st.step)))
    assert boundaries == [8, 13] and res.steps == 10
    full, full_log = tloop.python_loop_reference(tstep, tl, entry(),
                                                 n_steps=10, ema_beta=0.9)
    for a, b in zip(tree_leaves(full.bundle), tree_leaves(res.state.bundle)):
        assert torch.equal(a, b)
    assert full_log == log


def test_hooks_see_epoch_boundaries_and_logs_refuse_ensembles():
    _, tad, _, tstep, _, tl = _engine_pair()
    _, tb = _start(JAdapter(JModelConfig(**TINY), JOpt()))
    st = tloop.init_train_state(tb, tad.init_opt(tb))
    seen = []
    hooks = [lambda s, d: seen.append(("a", d)),
             lambda s, d: seen.append(("b", d))]
    res = tloop.run_phase(tloop.EpochRunner(tstep, tl, 0.9), st, 0,
                          max_steps=16, on_chunk=hooks)
    assert seen == [("a", 8), ("b", 8), ("a", 16), ("b", 16)]
    assert res.hook_time >= 0.0 and res.train_time > 0.0
    with pytest.raises(ValueError, match="single-model"):
        tloop.run_phase(tloop.EpochRunner(tstep, tl, 0.9, ensemble=True),
                        st, [0], max_steps=1, log=[])


def test_engine_freezes_ema_on_skipped_steps():
    """A skipped (overflow) step's accuracy never enters the EMA."""
    def step_fn(bundle, opt, batch, step, scale):
        skipped = torch.tensor(1.0 if step == 1 else 0.0)
        return bundle, opt, scale, {"accuracy": torch.tensor(1.0),
                                    "loss": torch.tensor(0.0),
                                    "lr": torch.tensor(0.1),
                                    "skipped": skipped}
    tl = Loader({"x": np.zeros((8, 2), np.float32)}, 2)
    st = tloop.init_train_state({"params": {"w": torch.zeros(1)},
                                 "state": {}}, {})
    st, m = tloop.EpochRunner(step_fn, tl, 0.5).run_chunk(st, 0, 3)
    assert m["ema"].tolist() == [0.5, 0.5, 0.75]


def _state_from_jax(jstate):
    """A whole JAX TrainState (bundle, optimizer state with its momentum
    under the same key paths, step, EMA, phase, rng, loss-scale state) as
    the port's, through ``params_from_numpy``."""
    st = tloop.TrainState(*params_from_numpy(jax.device_get(jstate)))
    return st._replace(step=st.step.long(), rng=st.rng.long(),
                       scale=tprec.LossScaleState(*st.scale))


def test_training_continues_from_a_jax_train_state():
    """JAX trains 8 steps of phase 1; its TrainState is carried into the
    port, and both continue 8 more steps: the same logs and params within
    the trajectory bound (the carried momentum matters: it is nonzero)."""
    jad, tad, jstep, tstep, jl, tl = _engine_pair()
    jb = jad.init(jax.random.PRNGKey(1))
    jst = jloop.init_train_state(jb, jad.init_opt(jb))
    jrunner = jloop.EpochRunner(jstep, jl, 0.9)
    jst, _ = jrunner.run_chunk(jst, 0, 8)
    tst = _state_from_jax(jst)
    assert int(tst.step) == 8
    assert float(tree_leaves(tst.opt_state["mu"])[0].abs().max()) > 0
    _close_trees(tst.opt_state["mu"], jst.opt_state["mu"], 0, 0)
    jlog, tlog = [], []
    jres = jloop.run_phase(jrunner, jst, 0, max_steps=8, log=jlog)
    tres = tloop.run_phase(tloop.EpochRunner(tstep, tl, 0.9), tst, 0,
                           max_steps=8, log=tlog)
    assert [e["step"] for e in tlog] == [e["step"] for e in jlog] == \
        list(range(8, 16))
    for key in ("loss", "ema"):
        np.testing.assert_allclose([e[key] for e in tlog],
                                   [e[key] for e in jlog], rtol=TRAJ_TOL)
    _close_trees(tres.state.bundle["params"], jres.state.bundle["params"],
                 TRAJ_TOL, TRAJ_TOL)
    _close_trees(tres.state.opt_state["mu"], jres.state.opt_state["mu"],
                 TRAJ_TOL, TRAJ_TOL)


# ---------------------------------------------------------------------------
# the phase-2 ensemble
# ---------------------------------------------------------------------------


def test_ensemble_equals_independent_runs_and_jax_vmap():
    """The stacked W-worker ensemble (each worker its own data order) is
    W independent runs (the same eager steps, to an ulp), and agrees with
    JAX's vmap ensemble over the same batches, both starting from a JAX
    phase-1 model."""
    W = 3
    cfg = treg.get_smoke_config("internlm2-1.8b")
    jcfg = jreg.get_smoke_config("internlm2-1.8b")
    jad, tad = JAdapter(jcfg, JOpt()), LMAdapter(cfg, OptimizerConfig())
    tr = _data(cfg.vocab_size, n_train=256, seq_len=16)
    tl, jl = Loader(tr, 16, seed=7), JLoader(tr, 16, seed=7)
    sk = dict(kind="const", peak_lr=0.05)
    tstep = tad.make_train_step(schedule_fn(ScheduleConfig(**sk)))
    jstep = jad.make_train_step(jschedule(JSched(**sk)))
    # JAX's phase 1 (4 steps at batch 64) gives the common start
    j0 = jad.init(jax.random.PRNGKey(1))
    jst1, _ = jloop.EpochRunner(jstep, JLoader(tr, 64, seed=7), 0.9).run_chunk(
        jloop.init_train_state(j0, jad.init_opt(j0)), 0, 4)
    jb = jst1.bundle
    tb = {"params": _to_torch(jb["params"]), "state": {}}

    runner = tloop.EpochRunner(tstep, tl, 0.9, ensemble=True)
    stacked = _stack_bundles(tb, W)
    state = tloop.stack_train_state(stacked, tad.init_opt(stacked), W)
    state, metrics = runner.run_chunk(state, list(range(W)), 3)
    assert metrics["loss"].shape == (W, 3)
    assert state.step.tolist() == [3] * W

    js = jstack(jb, W)
    jst = jloop.stack_train_state(js, jax.vmap(jad.init_opt)(js), W)
    jst, _ = jloop.EpochRunner(jstep, jl, 0.9, ensemble=True).run_chunk(
        jst, jnp.arange(W, dtype=jnp.int32), 3)
    _close_trees(state.bundle["params"], jst.bundle["params"], TRAJ_TOL,
                 TRAJ_TOL)
    np.testing.assert_allclose(state.acc_ema.numpy(),
                               np.asarray(jst.acc_ema), rtol=TRAJ_TOL)

    for w in range(W):
        b = {"params": _to_torch(jb["params"]), "state": {}}
        st = tloop.init_train_state(b, tad.init_opt(b))
        st, _ = tloop.EpochRunner(tstep, tl, 0.9).run_chunk(st, w, 3)
        for a, c in zip(tree_leaves(st.bundle["params"]),
                        tree_leaves(state.bundle["params"])):
            # the same eager steps; the CPU BLAS may pick another kernel
            # for a slice of the stacked tensor (its alignment differs),
            # so the two agree to an ulp, not always bitwise
            torch.testing.assert_close(a, c[w], rtol=1e-6, atol=1e-7)
    # workers with their own data orders diverge
    wq = state.bundle["params"]["blocks"]["attn"]["wq"]
    assert float((wq[0] - wq[1]).abs().max()) > 1e-6


def test_stack_host_batches_matches_jax():
    tr = _data(32, n_train=64)
    got = tloop.stack_host_batches(Loader(tr, 8, seed=2), 5, 3)
    want = jloop.stack_host_batches(JLoader(tr, 8, seed=2), 5, 3)
    for k in ("tokens", "labels", "aug_seed"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
