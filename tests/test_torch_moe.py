"""Port's MoE FFN (``repro_torch.models.moe``) against the JAX package's.

The same numpy params and inputs go through ``repro.models.moe`` and its
twin, with and without capacity drops, in f32 and bf16. Which (token, k)
pairs are kept must be exactly JAX's; out is held at 1e-5 in f32 (f32 sums
in another order) and at 3e-2 in bf16 (the flash tests' bf16 bound: XLA and
PyTorch round the expert products to bf16 at other points, a few bf16 ulp),
each relative to the largest |out| (the expert outputs reach ~20 at unit
inputs: wi and wg take fan-in E, as in the reference); the aux loss at 1e-6
relative (one f32 mean in another order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import replace as jreplace  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import replace as treplace  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
AUX_RTOL = 1e-6

# (arch, overrides): the smoke configs' routers (4 experts top-2), a wider
# one (8 experts top-3), each at a capacity factor that drops tokens and at
# one that drops none (E / K * 1.1, as tests/test_arch_smoke.py takes it)
CASES = {
    "drops_e4k2": ("granite-moe-3b-a800m", {"moe.capacity_factor": 0.5}),
    "nodrop_e4k2": ("granite-moe-3b-a800m", {"moe.capacity_factor": 2.2}),
    "drops_e8k3": ("deepseek-v2-lite", {"moe.n_experts": 8, "moe.top_k": 3,
                                        "moe.capacity_factor": 0.75}),
    "nodrop_e8k3": ("deepseek-v2-lite", {"moe.n_experts": 8, "moe.top_k": 3,
                                         "moe.capacity_factor": 8 / 3 * 1.1}),
}


def _configs(arch, overrides):
    return (jreplace(jreg.get_smoke_config(arch), **overrides),
            treplace(treg.get_smoke_config(arch), **overrides))


def _params_and_x(jcfg, dtype, shape=(3, 40), seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    return (jp, jnp.asarray(x, getattr(jnp, dtype)),
            params_from_numpy(jax.device_get(jp)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _jax_keep(jp, x, cfg):
    """The reference's routing and kept mask (moe.py:53-69), from JAX's own
    primitives: (expert_idx (B,S,K), keep (B,S*K))."""
    m = cfg.moe
    B, S, _ = x.shape
    C = jmoe.capacity(cfg, S)
    probs = jax.nn.softmax(
        jnp.matmul(x.astype(jnp.float32), jp["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    flat_e = idx.reshape(B, S * m.top_k)
    pos_in_e = jnp.cumsum(jax.nn.one_hot(flat_e, m.n_experts, dtype=jnp.int32),
                          axis=1) - 1
    pos = jnp.take_along_axis(pos_in_e, flat_e[..., None], axis=2)[..., 0]
    return np.asarray(idx), np.asarray(pos < C)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=tol * np.abs(want).max(), rtol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_jax(case, dtype):
    jcfg, tcfg = _configs(*CASES[case])
    jp, jx, tp, tx = _params_and_x(jcfg, dtype)
    jout, jaux = jmoe.moe_forward(jp, jx, jcfg)
    tout, taux = tmoe.moe_forward(tp, tx, tcfg)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    _close(tout, jout, TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)

    # the kept (token, k) pairs are exactly the reference's
    want_idx, want_keep = _jax_keep(jp, jx, jcfg)
    _, _, idx = tmoe.route(tp, tx, tcfg)
    _, _, keep = tmoe.dispatch_slots(idx, tcfg.moe.n_experts,
                                     tmoe.capacity(tcfg, tx.shape[1]))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    dropped = (~want_keep).sum()
    assert (dropped > 0) == case.startswith("drops"), dropped


@pytest.mark.parametrize("case", ["nodrop_e4k2", "drops_e8k3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_dense_matches_jax(case, dtype):
    jcfg, tcfg = _configs(*CASES[case])
    jp, jx, tp, tx = _params_and_x(jcfg, dtype, seed=1)
    jout, jaux = jmoe.moe_forward_dense(jp, jx, jcfg)
    tout, taux = tmoe.moe_forward_dense(tp, tx, tcfg)
    _close(tout, jout, TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)


@pytest.mark.parametrize("case", ["nodrop_e4k2", "nodrop_e8k3"])
def test_no_drop_dispatch_equals_the_dense_oracle(case):
    """With capacity for every token, the gather dispatch computes what
    every expert on every token computes (f32, summation order apart)."""
    jcfg, tcfg = _configs(*CASES[case])
    _, _, tp, tx = _params_and_x(jcfg, "float32", seed=2)
    out, aux = tmoe.moe_forward(tp, tx, tcfg)
    want, want_aux = tmoe.moe_forward_dense(tp, tx, tcfg)
    _close(out, want.numpy(), TOL["float32"])
    assert float(aux) == float(want_aux)


def test_forced_router_ties_pick_jax_top_k_experts():
    """Experts 1 and 3 share their router column and expert 2 is a copy of
    expert 0's, so every token's probs tie in pairs: top-k must take the
    lower index first, as jax.lax.top_k does (torch.topk promises no order
    among ties)."""
    jcfg, tcfg = _configs("deepseek-v2-lite", {"moe.n_experts": 4,
                                               "moe.top_k": 2,
                                               "moe.capacity_factor": 1.0})
    jp, jx, _, tx = _params_and_x(jcfg, "float32", shape=(2, 24), seed=3)
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    jp = dict(jp, router=jnp.asarray(router))
    tp = params_from_numpy(jax.device_get(jp))
    probs, _, idx = tmoe.route(tp, tx, tcfg)
    assert bool((probs[..., 3] == probs[..., 1]).all())
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    # both tied experts of a pair are never taken before the lower one
    assert bool((idx[..., 0] < idx[..., 1])[idx[..., 0] % 2 ==
                                              idx[..., 1] % 2].all())
    jout, _ = jmoe.moe_forward(jp, jx, jcfg)
    tout, _ = tmoe.moe_forward(tp, tx, tcfg)
    _close(tout, jout, TOL["float32"])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite", "granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("full", [False, True])
def test_capacity_matches_jax(arch, full):
    get_j = jreg.get_config if full else jreg.get_smoke_config
    get_t = treg.get_config if full else treg.get_smoke_config
    for seq in (1, 3, 24, 40, 512, 513, 2048):
        assert tmoe.capacity(get_t(arch), seq) == jmoe.capacity(
            get_j(arch), seq)


def test_init_moe_shapes_and_fan_in():
    """The reference's leaves and shapes; wi/wg scaled by 1/sqrt(E) (the
    reference's dense_init of (E, d, f) takes fan-in E), wo by
    1/sqrt(d_ff), the router by 1/sqrt(d), each a normal truncated at 2
    sigma (std 0.8796 of the scale)."""
    tcfg = treg.get_smoke_config("deepseek-v2-lite")
    jcfg = jreg.get_smoke_config("deepseek-v2-lite")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, lead=(2,))
    jp = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: (2,) + v.shape for k, v in jp.items()}
    m, d = tcfg.moe, tcfg.d_model
    trunc_std = 0.8796
    for name, fan_in in (("router", d), ("wi", m.n_experts),
                         ("wg", m.n_experts), ("wo", m.d_ff)):
        t = p[name]
        scale = 1 / math.sqrt(fan_in)
        assert float(t.abs().max()) <= 2 * scale
        assert abs(float(t.std()) / (trunc_std * scale) - 1) < 0.05, name


@pytest.mark.parametrize("arch", ["whisper-base"])
def test_training_launcher_refuses_the_unported_families(arch):
    """The training launcher takes the MoE family, MLA, the hybrid and the
    vlm family; the audio family, which the model takes, is refused by the
    launcher itself (its token data has no frames, as the reference
    launcher's has none), before any data is made."""
    with pytest.raises(NotImplementedError, match="needs frames"):
        tlaunch.build(tlaunch.build_parser().parse_args(
            ["--arch", arch, "--device", "cpu", "--workers", "2"]))


def test_training_launcher_builds_the_vlm_smoke_run():
    """qwen2-vl-72b: its smoke and full models build (M-RoPE, no MoE
    layer), and the training launcher builds the smoke run on the CPU on
    token data, as the reference launcher does (no vision embeddings)."""
    for get in (treg.get_smoke_config, treg.get_config):
        model = TModel(get("qwen2-vl-72b"))
        assert model.cfg.family == "vlm" and model.cfg.mrope_sections
        assert not any(k.use_moe for k in model.unit_kinds + model.tail_kinds)
    swap = tlaunch.build(tlaunch.build_parser().parse_args(
        ["--arch", "qwen2-vl-72b", "--device", "cpu", "--workers", "2"]))
    assert swap.adapter.cfg.family == "vlm"
    assert swap.adapter.cfg.mrope_sections == (8, 12, 12)
    assert swap.adapter.model.n_units == 2


def test_training_launcher_takes_the_hybrid_family():
    """zamba2-7b: its smoke and full models build (no MoE layer: the
    router aux loss of a step is 0) and the training launcher builds the
    smoke run on the CPU."""
    for get in (treg.get_smoke_config, treg.get_config):
        model = TModel(get("zamba2-7b"))
        assert model.cfg.moe is None
        assert not any(k.use_moe for k in model.unit_kinds + model.tail_kinds)
    swap = tlaunch.build(tlaunch.build_parser().parse_args(
        ["--arch", "zamba2-7b", "--device", "cpu", "--workers", "2"]))
    assert swap.adapter.cfg.family == "hybrid"
    assert swap.adapter.model.n_units == 2
