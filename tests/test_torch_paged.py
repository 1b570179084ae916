"""The model-level pieces of the compiled serving engine against the JAX
package's, on the CPU: ``prefill(length=)`` over a right-padded bucket,
the paged KV pool (``gqa_empty_page_pool``, ``gqa_decode_paged``,
``empty_cache(page_pool=)``, ``decode(block_tables=)``), ``mamba_forward(
length=, init_cache=)``, and the in-place decode the engine's CUDA graph
runs.

JAX ``Model.init`` params are carried over with ``params_from_numpy``, the
same numpy tokens go through both; f32 smoke configs at atol = rtol =
1e-4, as ``test_torch_model.py``; int8 cache values one step apart on
rounding ties, rarely, as there.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.checkpoint.io import _items, params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import replace as treplace  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

TOL = 1e-4
LENGTH_ARCHS = ["internlm2-1.8b", "gemma3-1b", "mamba2-2.7b", "zamba2-7b",
                "minicpm3-4b", "qwen2-vl-72b"]
_PAIRS = {}


def _pair(arch, **overrides):
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PAIRS:
        jcfg = jreplace(jreg.get_smoke_config(arch), **overrides)
        tcfg = treplace(treg.get_smoke_config(arch), **overrides)
        jm, tm = JModel(jcfg), TModel(tcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        _PAIRS[key] = (jm, jp, tm, params_from_numpy(jax.device_get(jp)))
    return _PAIRS[key]


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


def _close_tree(tcache, jcache, tol=TOL):
    tflat, jflat = dict(_items(tcache)), _flat(jcache)
    assert set(tflat) == set(jflat)
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        if leaf.dtype == jnp.int8:
            assert tflat[key].dtype == torch.int8, key
            diff = np.abs(tflat[key].numpy().astype(np.int32)
                          - np.asarray(leaf, np.int32))
            assert diff.max() <= 1 and diff.mean() <= 1e-3, key
        else:
            _close(tflat[key], leaf, tol)


@pytest.mark.parametrize("arch", LENGTH_ARCHS)
def test_prefill_length_matches_jax_and_unpadded(arch):
    """A prompt of 9 right-padded to a bucket of 16: the logits of token 8
    and every cache leaf equal JAX's padded prefill (the window slots, the
    SSM states and conv windows of the real tokens, MLA's latent rows,
    M-RoPE at default positions), and the logits equal the unpadded
    prefill's."""
    jm, jp, tm, tp = _pair(arch)
    S, P, max_seq = 9, 16, 48
    prompt = _tokens(jm.cfg, (1, S), seed=17)
    padded = np.pad(prompt, ((0, 0), (0, P - S)))
    jlog, jc = jax.jit(lambda p, t, L: jm.prefill(
        p, t, cache_len=max_seq, length=L))(jp, jnp.asarray(padded),
                                             jnp.int32(S))
    tpad = torch.from_numpy(padded).long()
    tlog, tc = tm.prefill(tp, tpad, cache_len=max_seq, length=S)
    _close(tlog, jlog)
    _close_tree(tc, jc)
    ulog, _ = tm.prefill(tp, torch.from_numpy(prompt).long(),
                         cache_len=max_seq)
    _close(tlog, ulog.numpy(), 1e-5)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "zamba2-7b"])
def test_padded_prefill_decodes_like_unpadded(arch):
    """The reference's check on the remaining cache families (MLA latent,
    hybrid): padded prefill then decode gives the unpadded run's argmax
    tokens, and the JAX padded run's logits, step by step."""
    jm, jp, tm, tp = _pair(arch)
    S, P, max_seq = 9, 16, 48
    prompt = _tokens(jm.cfg, (1, S), seed=17)
    padded = np.pad(prompt, ((0, 0), (0, P - S)))
    lu, cu = tm.prefill(tp, torch.from_numpy(prompt).long(),
                        cache_len=max_seq)
    lp, cp = tm.prefill(tp, torch.from_numpy(padded).long(),
                        cache_len=max_seq, length=S)
    _, jc = jm.prefill(jp, jnp.asarray(padded), cache_len=max_seq,
                       length=jnp.int32(S))
    assert int(torch.argmax(lu)) == int(torch.argmax(lp))
    tok = torch.argmax(lu, -1)[:, None]
    for i in range(3):
        pos = torch.tensor([S + i])
        l_u, cu = tm.decode(tp, cu, tok, pos)
        l_p, cp = tm.decode(tp, cp, tok, pos)
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok.numpy(), jnp.int32),
                           jnp.array([S + i]))
        assert int(torch.argmax(l_u)) == int(torch.argmax(l_p)), i
        _close(l_p, jl)
        tok = torch.argmax(l_u, -1)[:, None]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _pool_setup(cfg, seed, n_pages=9, page=4, B=2, M=3):
    """A random pool (the JAX and the port's copy), block tables giving
    each slot its own pages (page 0 past them) and per-slot positions."""
    rng = np.random.default_rng(seed)
    shape = (n_pages, page, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        pool = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.uniform(1e-3, 2e-2, shape[:3] + (1,))
                .astype(np.float32),
                "v_scale": rng.uniform(1e-3, 2e-2, shape[:3] + (1,))
                .astype(np.float32)}
    else:
        pool = {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    bt = np.array([[3, 5, 0], [7, 1, 2]][:B], np.int32)[:, :M]
    pos = np.array([6, 9][:B], np.int32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    return pool, bt, pos, x


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_gqa_decode_paged_matches_jax(kv):
    """One decode against a paged pool, f32 and int8: the output and
    every pool leaf equal JAX's; in place equals the written copy and
    leaves no other page touched."""
    over = {"kv_cache_dtype": "int8"} if kv == "int8" else {}
    jm, jp, tm, tp = _pair("internlm2-1.8b", **over)
    cfg = tm.cfg
    pool, bt, pos, x = _pool_setup(cfg, seed=3)
    jlayer = jax.tree_util.tree_map(lambda a: a[0, 0], jp["blocks"]["attn"])
    tlayer = {k: v[0, 0] for k, v in tp["blocks"]["attn"].items()}
    jout, jpool = jattn.gqa_decode_paged(
        jlayer, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(pos), jnp.asarray(bt), jm.cfg)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    args = (tlayer, torch.from_numpy(x), tpool, torch.from_numpy(pos).long(),
            torch.from_numpy(bt).long(), cfg)
    tout, tnew = tattn.gqa_decode_paged(*args)
    _close(tout, jout)
    _close_tree(tnew, jpool)
    for k, v in pool.items():                  # the input pool untouched
        assert np.array_equal(tpool[k].numpy(), v), k
    iout, inew = tattn.gqa_decode_paged(*args, inplace=True)
    assert torch.equal(iout, tout)
    for k in pool:
        assert inew[k] is tpool[k] and torch.equal(inew[k], tnew[k]), k
    # only the two written rows changed: slot 0 at 6 (page 5, row 2), slot
    # 1 at 9 (its third page, 2, row 1)
    changed = (tnew["k"] != torch.from_numpy(pool["k"])).flatten(2).any(-1)
    assert changed.nonzero().tolist() == [[2, 1], [5, 2]]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_empty_cache_with_page_pool_matches_jax(kv):
    """empty_cache(page_pool=): pool leaves under "p" for the pageable
    layers, dense leaves for the others, the reference's key paths,
    shapes, dtypes and values (int8 scales at 1e-8/127)."""
    over = {"kv_cache_dtype": "int8"} if kv == "int8" else {}
    for arch in ("internlm2-1.8b", "gemma3-1b", "zamba2-7b"):
        jm, _, tm, _ = _pair(arch, **over)
        jc = jm.empty_cache(2, 32, page_pool=(5, 8))
        tc = tm.empty_cache(2, 32, "cpu", page_pool=(5, 8))
        tflat, jflat = dict(_items(tc)), _flat(jc)
        assert set(tflat) == set(jflat), arch
        assert any("/p/" in k for k in tflat), arch
        for key, leaf in jflat.items():
            assert tuple(tflat[key].shape) == leaf.shape, (arch, key)
            assert str(tflat[key].dtype).split(".")[-1] == str(leaf.dtype), \
                (arch, key)
            np.testing.assert_array_equal(tflat[key].numpy(),
                                          np.asarray(leaf))
        # the pool leaves are distinct tensors (written in place later)
        ptrs = [t.data_ptr() for t in tflat.values()]
        assert len(set(ptrs)) == len(ptrs), arch


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b"])
def test_decode_with_block_tables_matches_jax(arch):
    """Model.decode over a cache whose pageable layers hold a pool: two
    steps from a prefill folded into each slot's pages, the logits and
    every leaf equal JAX's; in place equals the functional decode."""
    jm, jp, tm, tp = _pair(arch)
    B, S, P, n_pages = 2, 7, 4, 7
    toks = _tokens(jm.cfg, (B, S + 2), seed=5)
    bt = np.array([[1, 3, 5], [2, 4, 6]], np.int32)
    jc0 = jm.empty_cache(B, 12, page_pool=(n_pages, P))
    _, jpre = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=12)

    def fold(path, dst):
        ps = [str(getattr(p, "key", p)) for p in path]
        if ps[-2] != "p":
            return jpre_flat["/".join(ps)]
        src = jpre_flat["/".join(ps[:-2] + ["a", ps[-1]])]
        unit = ps[0] == "units"
        for b in range(B):
            rows = src[:, b] if unit else src[b]
            rows = rows.reshape((rows.shape[0], 3, P) + rows.shape[2:]
                                if unit else (3, P) + rows.shape[1:])
            dst = (dst.at[:, bt[b]].set(rows) if unit
                   else dst.at[bt[b]].set(rows))
        return dst

    jpre_flat = _flat(jpre)
    jc = jax.tree_util.tree_map_with_path(fold, jc0)
    tc = params_from_numpy(jax.device_get(jc))
    tc_in = params_from_numpy(jax.device_get(jc))
    tbt = torch.from_numpy(bt).long()
    for i in range(2):
        pos = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                           block_tables=jnp.asarray(bt))
        args = (tp, None, torch.from_numpy(tok).long(),
                torch.from_numpy(pos).long())
        tl, tc = tm.decode(args[0], tc, *args[2:], block_tables=tbt)
        il, same = tm.decode(args[0], tc_in, *args[2:], block_tables=tbt,
                             inplace=True)
        assert same is tc_in
        _close(tl, jl)
        assert torch.equal(il, tl)
        for (k, a), (_, b) in zip(_items(tc), _items(tc_in)):
            assert torch.equal(a, b), k
    _close_tree(tc, jc)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-2.7b", "minicpm3-4b",
                                  "qwen2-vl-72b", "granite-moe-3b-a800m"])
def test_inplace_decode_equals_functional(arch):
    """decode(inplace=True) writes into the cache it is given and returns
    it; logits and every leaf bitwise equal the functional decode's, which
    leaves its input as it was (window, SSM, MLA, M-RoPE and MoE
    layers)."""
    _, _, tm, tp = _pair(arch)
    B, S = 2, 20
    toks = _tokens(tm.cfg, (B, S + 3), seed=8)
    _, cache = tm.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                          cache_len=S + 3)
    mine = {k: v.clone() for k, v in _items(cache)}
    inplace = _clone(cache)
    pos = torch.tensor([S, S - 4])
    for i in range(3):
        tok = torch.from_numpy(toks[:, S + i:S + i + 1]).long()
        given = cache
        before = _clone(cache)
        fl, cache = tm.decode(tp, cache, tok, pos + i)
        for (k, a), (_, b) in zip(_items(given), _items(before)):
            assert torch.equal(a, b), (i, k)
        il, out = tm.decode(tp, inplace, tok, pos + i, inplace=True)
        assert out is inplace and torch.equal(il, fl)
        for (k, a), (_, b) in zip(_items(cache), _items(inplace)):
            assert torch.equal(a, b), (i, k)
    assert any(not torch.equal(mine[k], v) for k, v in _items(inplace))


def test_write_slot_drops_a_write_past_the_cache():
    """A per-row slot of L drops its row's write (a JAX scatter drops it),
    by fixed-shape ops, in place or on a copy."""
    buf = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    new = -torch.ones(2, 1, 3)
    slot = torch.tensor([1, 4])
    out = tattn._write_slot(buf, new, slot)
    want = buf.clone()
    want[0, 1] = -1
    assert torch.equal(out, want)
    assert not torch.equal(buf, want)
    same = tattn._write_slot(buf, new, slot, inplace=True)
    assert same is buf and torch.equal(buf, want)


def test_mamba_forward_length_and_init_cache_match_jax():
    """mamba_forward no longer refuses length= and init_cache=: a padded
    bucket (dt zeroed past the length, the conv window of the real
    tokens) and a continuation from a cache, out and cache against
    JAX's."""
    jm, jp, tm, tp = _pair("mamba2-2.7b")
    cfg, jcfg = tm.cfg, jm.cfg
    jlayer = jax.tree_util.tree_map(lambda a: a[0, 0], jp["blocks"]["mamba"])
    tlayer = {k: v[0, 0] for k, v in tp["blocks"]["mamba"].items()}
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jfwd = jax.jit(lambda p, x, L: jmamba.mamba_forward(
        p, x, jcfg, return_cache=True, length=L))
    for L in (1, 2, 9, 24):
        jout, jc = jfwd(jlayer, jnp.asarray(u), jnp.int32(L))
        tout, tc = tmamba.mamba_forward(tlayer, torch.from_numpy(u), cfg,
                                        return_cache=True, length=L)
        _close(tout, jout)
        _close_tree(tc, jc)
    # continuation: the first 10 tokens, then 14 from their cache, equal
    # the whole 24 at once (and JAX's continuation)
    whole, wc = tmamba.mamba_forward(tlayer, torch.from_numpy(u), cfg,
                                     return_cache=True)
    _, c10 = tmamba.mamba_forward(tlayer, torch.from_numpy(u[:, :10]), cfg,
                                  return_cache=True)
    rest, rc = tmamba.mamba_forward(tlayer, torch.from_numpy(u[:, 10:]), cfg,
                                    return_cache=True, init_cache=c10)
    _, jc10 = jax.jit(lambda p, x: jmamba.mamba_forward(
        p, x, jcfg, return_cache=True))(jlayer, jnp.asarray(u[:, :10]))
    jrest, jrc = jax.jit(lambda p, x, c: jmamba.mamba_forward(
        p, x, jcfg, return_cache=True, init_cache=c))(
            jlayer, jnp.asarray(u[:, 10:]), jc10)
    _close(rest, jrest)
    _close_tree(rc, jrc)
    _close(rest, whole[:, 10:].numpy())
    _close_tree(rc, {k: v.numpy() for k, v in wc.items()})


def test_int8_model_prefill_length_matches_jax():
    jm, jp, tm, tp = _pair("gemma3-1b", kv_cache_dtype="int8")
    S, P = 37, 64          # past the smoke window
    prompt = np.pad(_tokens(jm.cfg, (1, S), seed=2), ((0, 0), (0, P - S)))
    jlog, jc = jm.prefill(jp, jnp.asarray(prompt), cache_len=64,
                          length=jnp.int32(S))
    tlog, tc = tm.prefill(tp, torch.from_numpy(prompt).long(),
                          cache_len=64, length=S)
    _close(tlog, jlog)
    _close_tree(tc, jc)
    assert dataclasses.asdict(tm.cfg)["kv_cache_dtype"] == "int8"
