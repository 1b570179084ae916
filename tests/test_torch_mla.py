"""Port's MLA (``repro_torch.models.attention``: init_mla, mla_forward,
mla_decode, mla_empty_cache) against the JAX package's, on the CPU.

The same numpy params and inputs go through ``repro.models.attention`` and
its twin: the smoke configs of deepseek-v2-lite (qk 32 + 16) and minicpm3-4b,
deepseek-v2-lite's smoke config at its full MLA head dims (qk 128 + 64 =
192, the flash head dim the kernels take), and minicpm3-4b's at its own
(qk 64 + 32 = 96, v 64 padded to 96: the flash head dim of its full
config). Here the flash op is the plain
version in both packages. Outputs and latent caches are held at 1e-5 in f32
and 3e-2 in bf16 (the flash tests' bounds), relative to the largest |value|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import replace as jreplace  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import replace as treplace  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
HEAD_192 = {"d_model": 256, "head_dim": 128, "mla.qk_nope_head_dim": 128,
            "mla.qk_rope_head_dim": 64, "mla.v_head_dim": 128}
HEAD_96 = {"head_dim": 64, "mla.qk_nope_head_dim": 64,
           "mla.qk_rope_head_dim": 32, "mla.v_head_dim": 64}
CONFIGS = {
    "deepseek_smoke": ("deepseek-v2-lite", {}),
    "minicpm3_smoke": ("minicpm3-4b", {}),
    "deepseek_head_dim_192": ("deepseek-v2-lite", HEAD_192),
    "minicpm3_head_dim_96": ("minicpm3-4b", HEAD_96),
}


def _setup(name, dtype="float32", seed=0):
    arch, over = CONFIGS[name]
    jcfg = jreplace(jreg.get_smoke_config(arch), dtype=dtype, **over)
    tcfg = treplace(treg.get_smoke_config(arch), dtype=dtype, **over)
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp))


def _x(cfg, shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _positions(B, S, offset=0):
    pos = np.broadcast_to(np.arange(offset, offset + S)[None], (B, S))
    return jnp.asarray(pos, jnp.int32), torch.from_numpy(pos.copy()).long()


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=tol * np.abs(want).max(), rtol=tol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_and_latent_cache_match_jax(name, dtype):
    jcfg, tcfg, jp, tp = _setup(name, dtype)
    B, S = 2, 37
    jx, tx = _x(jcfg, (B, S), dtype, seed=1)
    jpos, tpos = _positions(B, S)
    jout, jc = jattn.mla_forward(jp, jx, jcfg, positions=jpos,
                                 return_cache=True)
    tout, tc = tattn.mla_forward(tp, tx, tcfg, positions=tpos,
                                 return_cache=True)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    _close(tout, jout, TOL[dtype])
    assert set(tc) == set(jc) == {"c_kv", "k_rope"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        _close(tc[key], jc[key], TOL[dtype])
    # without a cache, the same output
    _close(tattn.mla_forward(tp, tx, tcfg, positions=tpos), jout, TOL[dtype])


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("per_row", [False, True])
def test_mla_decode_matches_jax(name, per_row):
    """Absorbed-latent decode over a prefilled latent cache, a few steps:
    one position for the batch (a Python int) or one per row (a (B,)
    vector, as the serving engine's slots decode), each row's writes and
    mask at its own position."""
    jcfg, tcfg, jp, tp = _setup(name, seed=2)
    B, S, L, T = 3, 20, 32, 4
    jx, tx = _x(jcfg, (B, S), "float32", seed=3)
    jpos, tpos = _positions(B, S)
    _, jc = jattn.mla_forward(jp, jx, jcfg, positions=jpos,
                              return_cache=True)
    jc = {k: jnp.pad(v, ((0, 0), (0, L - S), (0, 0))) for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    start = np.array([S, S - 5, S - 11]) if per_row else S
    for t in range(T):
        jxt, txt = _x(jcfg, (B, 1), "float32", seed=10 + t)
        if per_row:
            p = start + t
            jp_, tp_ = jnp.asarray(p, jnp.int32), torch.from_numpy(p).long()
        else:
            jp_ = tp_ = start + t
        jout, jc = jattn.mla_decode(jp, jxt, jc, jp_, jcfg)
        tout, tc_new = tattn.mla_decode(tp, txt, tc, tp_, tcfg)
        _close(tout, jout, TOL["float32"])
        for key in jc:
            _close(tc_new[key], jc[key], TOL["float32"])
        tc = tc_new


def test_mla_decode_leaves_its_input_cache():
    _, tcfg, _, tp = _setup("deepseek_smoke", seed=4)
    cache = tattn.mla_empty_cache(tcfg, 2, 8, torch.float32, "cpu")
    before = {k: v.clone() for k, v in cache.items()}
    x = torch.randn(2, 1, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, new = tattn.mla_decode(tp, x, cache, torch.tensor([0, 3]), tcfg)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert not torch.equal(new["c_kv"][1, 3], before["c_kv"][1, 3])
    assert torch.equal(new["c_kv"][1, 0], before["c_kv"][1, 0])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_and_empty_cache_match_jax_shapes(name):
    jcfg, tcfg, _, _ = _setup(name)
    want = jax.eval_shape(lambda: jattn.init_mla(jax.random.PRNGKey(0), jcfg))
    got = tattn.init_mla(torch.Generator().manual_seed(0), tcfg, lead=(3,))
    flat = lambda t, pre="": (
        {k2: v2 for k, v in t.items() for k2, v2 in flat(v, pre + k + "/")
         .items()} if isinstance(t, dict) else {pre[:-1]: tuple(t.shape)})
    assert flat(got) == {k: (3,) + v for k, v in flat(want).items()}
    jc = jattn.mla_empty_cache(jcfg, 2, 16, jnp.bfloat16)
    tc = tattn.mla_empty_cache(tcfg, 2, 16, torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == {
        k: (v.shape, torch.bfloat16) for k, v in jc.items()}
    assert all(bool((v == 0).all()) for v in tc.values())
