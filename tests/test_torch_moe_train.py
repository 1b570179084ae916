"""One SGD step of the MoE family and MLA in the port against JAX's.

The port's twin of ``tests/test_arch_smoke.py::test_one_train_step`` for
deepseek-v2-lite (MoE + MLA), granite-moe-3b-a800m and
qwen3-moe-235b-a22b (MoE + GQA), each with and without capacity drops, and
minicpm3-4b (MLA, dense FFN; its smoke config and the same at its full
MLA head dims, qk 64 + 32 = 96, v 64): the same JAX-initialized params and numpy
tokens through ``repro.train.steps.make_lm_train_step`` (jitted) and
``repro_torch.train.steps.make_lm_train_step``. The metrics (loss, router
aux loss) and every updated param are held at 1e-5 relative, the
accuracy exactly, as ``tests/test_torch_train.py`` holds a step; and,
so that the check sees the step and not only the params it starts from,
each leaf's update (new - old) by its relative L2 distance from JAX's at
that file's grad tolerance, 1e-4 (measured 2.6e-5 to 3.9e-5: grads summed
in another order, and each package's rounding of the new params to f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt  # noqa: E402
from repro.configs.base import ScheduleConfig as JSched  # noqa: E402
from repro.configs.base import replace as jreplace  # noqa: E402
from repro.core.schedules import schedule_fn as jschedule  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train.steps import make_lm_train_step as jmake_step  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import OptimizerConfig  # noqa: E402
from repro_torch.configs.base import ScheduleConfig  # noqa: E402
from repro_torch.configs.base import replace as treplace  # noqa: E402
from repro_torch.core.schedules import schedule_fn  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.steps import make_lm_train_step  # noqa: E402

STEP_TOL = 1e-5
LR = 0.01
UPDATE_L2 = 1e-4
NO_DROP = {"moe.capacity_factor": 4 / 2 * 1.1}
DROPS = {"moe.capacity_factor": 0.5}
CASES = {
    "minicpm3-4b": ("minicpm3-4b", {}),
    # at minicpm3-4b's own MLA head dims: the flash op at D 96
    "minicpm3-4b-d96": ("minicpm3-4b", {
        "head_dim": 64, "mla.qk_nope_head_dim": 64,
        "mla.qk_rope_head_dim": 32, "mla.v_head_dim": 64}),
    **{f"{arch}-{tag}": (arch, over)
       for arch in ("deepseek-v2-lite", "granite-moe-3b-a800m",
                    "qwen3-moe-235b-a22b")
       for tag, over in (("drops", DROPS), ("nodrop", NO_DROP))},
}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("case", list(CASES))
def test_one_train_step_matches_jax(case):
    arch, over = CASES[case]
    jcfg = jreplace(jreg.get_smoke_config(arch), **over)
    tcfg = treplace(treg.get_smoke_config(arch), **over)
    jmodel, tmodel = JModel(jcfg), Model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    jinit, jstep = jmake_step(jmodel, JOpt(kind="sgd"), jschedule(
        JSched(kind="const", peak_lr=LR)))
    jnew, _, jm = jax.jit(jstep)(
        jparams, jinit(jparams), {k: jnp.asarray(v) for k, v in
                                  batch.items()}, 0)
    tinit, tstep = make_lm_train_step(tmodel, OptimizerConfig(kind="sgd"),
                                      schedule_fn(ScheduleConfig(
                                          kind="const", peak_lr=LR)))
    tnew, _, tm = tstep(tparams, tinit(tparams),
                        {k: torch.from_numpy(v.copy())
                         for k, v in batch.items()}, 0)

    assert bool(jnp.isfinite(jm["loss"]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=STEP_TOL)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=STEP_TOL)
    assert (float(tm["aux"]) > 0) == bool(tcfg.moe)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    t, j = _flat(tnew), _flat(jax.device_get(jnew))
    j0 = _flat(jax.device_get(jparams))
    assert t.keys() == j.keys()
    moved = 0.0
    for k in j:
        got, want = t[k].numpy(), np.asarray(j[k])
        np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=k)
        start = np.asarray(j0[k], np.float64)
        step = np.linalg.norm(want - start)
        assert np.linalg.norm(got - want.astype(np.float64)) <= \
            UPDATE_L2 * step, k
        moved = max(moved, step)
    assert moved > 0
