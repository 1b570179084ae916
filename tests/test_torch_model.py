"""Port's dense LM against the JAX package's, on the CPU.

JAX ``Model.init`` params are carried over with ``params_from_numpy``; the
same numpy tokens go through both. f32 smoke configs, atol = rtol = 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import replace as jreplace  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.checkpoint.io import _items, params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

TOL = 1e-4
DENSE = ["internlm2-1.8b", "qwen2.5-14b", "gemma3-1b"]


def _pair(arch, **overrides):
    jcfg = jreplace(jreg.get_smoke_config(arch), **overrides)
    tcfg = dataclasses.replace(treg.get_smoke_config(arch), **overrides)
    jm, tm = JModel(jcfg), TModel(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(jax.device_get(jp))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", DENSE)
def test_params_share_key_paths_and_shapes(arch):
    """The port's own init gives the reference's tree: same paths, shapes."""
    jm = JModel(jreg.get_smoke_config(arch))
    tm = TModel(treg.get_smoke_config(arch))
    want = {k: v.shape for k, v in _flat(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0))).items()}
    got = {k: tuple(v.shape) for k, v in _items(
        tm.init(torch.Generator().manual_seed(0)))}
    assert got == want


@pytest.mark.parametrize("arch", DENSE)
def test_apply_prefill_decode_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    B, S, T = 2, 40, 4              # S > gemma3-smoke's window of 32
    toks = _tokens(jm.cfg, (B, S + T))
    jl, _ = jm.apply(jp, jnp.asarray(toks))
    tl, aux = tm.apply(tp, torch.from_numpy(toks).long())
    _close(tl, jl)
    assert float(aux) == 0.0

    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + T)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                          cache_len=S + T)
    _close(tlog, jlog)
    tflat = dict(_items(tc))
    jflat = _flat(jc)
    assert set(tflat) == set(jflat)
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        _close(tflat[key], leaf)

    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), S + i)
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(), S + i)
        _close(tlog, jlog)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-1b"])
def test_int8_cache_prefill_decode_match_jax(arch):
    jm, jp, tm, tp = _pair(arch, kv_cache_dtype="int8")
    B, S, T = 2, 40, 3
    toks = _tokens(jm.cfg, (B, S + T), seed=1)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + T)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                          cache_len=S + T)
    _close(tlog, jlog)
    tflat = dict(_items(tc))
    for key, leaf in _flat(jc).items():
        if leaf.dtype == jnp.int8:
            # k/v agree to ~1e-6 before rounding, so a value that sits on a
            # rounding tie may land one step apart: allow that, and rarely
            assert tflat[key].dtype == torch.int8, key
            diff = np.abs(tflat[key].numpy().astype(np.int32)
                          - np.asarray(leaf, np.int32))
            assert diff.max() <= 1 and diff.mean() <= 1e-3, key
        else:
            _close(tflat[key], leaf)
    # one int8 step apart in a cached value moves a decode logit by up to
    # ~2e-4 at these widths, so decode logits are held at 1e-3 here
    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), S + i)
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(), S + i)
        _close(tlog, jlog, tol=1e-3)


def test_per_request_positions_decode_matches_jax():
    """Continuous batching: a (B,) vector of positions, as the engine uses."""
    jm, jp, tm, tp = _pair("gemma3-1b")
    B, L = 3, 48
    jc, tc = jm.empty_cache(B, L), tm.empty_cache(B, L, "cpu")
    toks = _tokens(jm.cfg, (6, B), seed=2)
    pos = np.array([0, 30, 33], np.int32)
    for step in range(6):
        tok = toks[step][:, None]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos + step))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos + step).long())
        _close(tlog, jlog)


def test_quantize_kv_matches_jax():
    from repro.models.attention import quantize_kv as jq
    x = np.random.default_rng(3).standard_normal((4, 16, 2, 32)).astype(
        np.float32)
    x[0, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]   # ties round half to even
    jv, js = jq(jnp.asarray(x))
    tv, ts = tattn.quantize_kv(torch.from_numpy(x))
    assert tv.dtype == torch.int8
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", sorted(jreg.list_archs()))
def test_config_asdict_parity(arch, full):
    get_j = jreg.get_config if full else jreg.get_smoke_config
    get_t = treg.get_config if full else treg.get_smoke_config
    assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))


def test_config_validates_impl_without_jax():
    from repro_torch.configs.base import ModelConfig
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ModelConfig(name="x", family="dense", n_layers=1, d_model=8,
                    n_heads=2, n_kv_heads=1, d_ff=8, vocab_size=8,
                    attention_impl="mosaic")


@pytest.mark.parametrize("arch", ["zamba2-7b", "minicpm3-4b",
                                  "qwen2-vl-72b", "whisper-base",
                                  "granite-moe-3b-a800m", "cifar-cnn"])
def test_model_refuses_configs_outside_the_slice(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        TModel(treg.get_smoke_config(arch))
