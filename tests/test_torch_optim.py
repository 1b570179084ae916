"""The port's schedules and optimizers against JAX's.

Schedules: the same f32 rate at every step (bitwise; the cosine schedule
to 1e-6 relative and 1e-7 absolute, as the f32 cos of torch and XLA
differ by an ulp). Optimizers: a few
updates from the same numpy params and grads agree with ``repro.optim`` to
1e-6 (relative and absolute); the port updates in place, so each test
passes it copies. Then the invariants of ``tests/test_optim.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs.base import OptimizerConfig as JOpt  # noqa: E402
from repro.configs.base import ScheduleConfig as JSched  # noqa: E402
from repro.core.schedules import schedule_fn as jschedule  # noqa: E402
from repro.optim.api import init_optimizer as jinit  # noqa: E402
from repro_torch.configs.base import OptimizerConfig  # noqa: E402
from repro_torch.configs.base import ScheduleConfig  # noqa: E402
from repro_torch.core.schedules import schedule_fn  # noqa: E402
from repro_torch.optim.api import init_optimizer  # noqa: E402

TOL = 1e-6

SCHEDULES = [
    dict(kind="const", peak_lr=0.3),
    dict(kind="warmup_linear", peak_lr=0.5, warmup_steps=30,
         total_steps=150),
    dict(kind="warmup_linear", peak_lr=0.0625, warmup_steps=0,
         total_steps=60),
    dict(kind="warmup_cosine", peak_lr=0.4, warmup_steps=7, total_steps=53,
         end_lr=0.01),
    dict(kind="cyclic", peak_lr=0.05, min_lr=0.001, cycle_steps=13),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["kind"])
def test_schedules_equal_jax_at_every_step(kw):
    jf, tf = jschedule(JSched(**kw)), schedule_fn(ScheduleConfig(**kw))
    got = [tf(step) for step in range(170)]
    want = [float(np.float32(jf(step))) for step in range(170)]
    if kw["kind"] == "warmup_cosine":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert got == want


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        schedule_fn(ScheduleConfig(kind="step"))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.standard_normal((3, 8, 5)).astype(np.float32),
                       "scale": rng.standard_normal((3, 5)).astype(
                           np.float32)},
            "head": {"w": rng.standard_normal((5, 7)).astype(np.float32)},
            "b": np.float32(rng.standard_normal())}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _close(t_tree, j_tree):
    for k in j_tree:
        if isinstance(j_tree[k], dict):
            _close(t_tree[k], j_tree[k])
        else:
            np.testing.assert_allclose(
                np.asarray(t_tree[k].numpy(), np.float32),
                np.asarray(j_tree[k], np.float32), rtol=TOL, atol=TOL,
                err_msg=k)


@pytest.mark.parametrize("kind,kw", [
    ("sgd", dict()),
    ("sgd", dict(nesterov=False, weight_decay=0.0)),
    ("lars", dict(trust_coefficient=0.02)),
    ("lars", dict(nesterov=False)),
    ("adamw", dict(weight_decay=0.01)),
])
def test_updates_match_jax(kind, kw):
    """Three updates with fresh grads each, lr from a schedule."""
    jinit_fn, jupdate = jinit(JOpt(kind=kind, **kw))
    tinit_fn, tupdate = init_optimizer(OptimizerConfig(kind=kind, **kw))
    params = _tree(0)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jinit_fn(jp), tinit_fn(tp)
    for i, lr in enumerate((0.1, 0.05, 0.3)):
        grads = _tree(10 + i)
        jp, js = jupdate(_to_jax(grads), js, jp, jnp.float32(lr))
        tp, ts = tupdate(_to_torch(grads), ts, tp, lr)
        _close(tp, jp)
        _close(ts["mu"], js["mu"])
    if kind == "adamw":
        _close(ts["nu"], js["nu"])
        assert int(ts["count"]) == int(js["count"]) == 3


def test_grads_promoted_to_the_master_dtype():
    """bf16 grads enter the update as f32, once (api.py)."""
    _, update = init_optimizer(OptimizerConfig(kind="sgd"))
    init, _ = init_optimizer(OptimizerConfig(kind="sgd"))
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 0.1, dtype=torch.bfloat16)}
    new, st_ = update(g, init(p), p, 1.0)
    assert new["w"].dtype == torch.float32 and st_["mu"]["w"].dtype == \
        torch.float32
    d = float(torch.tensor(0.1, dtype=torch.bfloat16)) + 5e-4
    np.testing.assert_allclose(new["w"].numpy(), 1.0 - (d + 0.9 * d),
                               rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        init_optimizer(OptimizerConfig(kind="rmsprop"))


# --- the invariants of tests/test_optim.py ---------------------------------


def _quadratic():
    return ({"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor(0.5)},
            {"w": torch.tensor([0.1, 0.2, -0.3]), "b": torch.tensor(0.05)})


def test_sgd_matches_pytorch_convention():
    init, update = init_optimizer(OptimizerConfig(
        kind="sgd", momentum=0.9, nesterov=True, weight_decay=0.01))
    params, grads = _quadratic()
    w0 = params["w"].clone()
    new, _ = update(grads, init(params), params, 0.1)
    d = grads["w"].numpy() + 0.01 * w0.numpy()
    np.testing.assert_allclose(new["w"].numpy(),
                               w0.numpy() - 0.1 * (d + 0.9 * d), rtol=1e-6)


def test_sgd_momentum_accumulates():
    init, update = init_optimizer(OptimizerConfig(
        kind="sgd", momentum=0.9, nesterov=False, weight_decay=0.0))
    params, grads = _quadratic()
    state = init(params)
    w0 = params["w"].clone()
    update(grads, state, params, 0.1)
    w1 = params["w"].clone()
    update(grads, state, params, 0.1)
    assert ((params["w"] - w1).abs() > (w1 - w0).abs()).all()


def test_lars_scales_by_trust_ratio_and_skips_1d():
    init, update = init_optimizer(OptimizerConfig(
        kind="lars", momentum=0.0, nesterov=False, weight_decay=0.0,
        trust_coefficient=0.001))
    params = {"w": torch.ones((4, 4)), "b": torch.ones(4)}
    grads = {"w": torch.full((4, 4), 2.0), "b": torch.full((4,), 2.0)}
    new, _ = update(grads, init(params), params, 1.0)
    trust = 0.001 * 4.0 / 8.0           # ||p|| = 4, ||g|| = 8
    np.testing.assert_allclose(new["w"].numpy(), 1.0 - trust * 2.0,
                               rtol=1e-5)
    np.testing.assert_allclose(new["b"].numpy(), 1.0 - 2.0, rtol=1e-6)


def test_adamw_bias_correction_first_step():
    init, update = init_optimizer(OptimizerConfig(
        kind="adamw", b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0))
    params, grads = _quadratic()
    w0 = params["w"].clone()
    new, _ = update(grads, init(params), params, 0.001)
    np.testing.assert_allclose((w0 - new["w"]).numpy(),
                               0.001 * np.sign(grads["w"].numpy()),
                               rtol=1e-3)


@settings(max_examples=15, deadline=None)
@given(kind=st.sampled_from(["sgd", "lars", "adamw"]),
       lr=st.floats(1e-5, 0.5), seed=st.integers(0, 50))
def test_property_optimizers_descend_quadratic(kind, lr, seed):
    init, update = init_optimizer(OptimizerConfig(kind=kind,
                                                  weight_decay=0.0,
                                                  momentum=0.9))
    w0 = np.random.default_rng(seed).standard_normal(8).astype(
        np.float32) + 3.0
    params = {"w": torch.from_numpy(w0)}
    state = init(params)
    before = 0.5 * float((params["w"] ** 2).sum())
    for _ in range(5):
        params, state = update({"w": params["w"].clone()}, state, params, lr)
    assert 0.5 * float((params["w"] ** 2).sum()) < before
