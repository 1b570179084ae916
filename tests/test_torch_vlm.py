"""Port's vlm family (qwen2-vl: M-RoPE, stub vision embeddings) against the
JAX package's, on the CPU.

The qwen2-vl smoke config in f32 (2 layers, d_model 256, 4 heads on 2 KV
heads of 64, sections 8/12/12, 16 vision tokens), and the same at the full
config's head dim of 128 with its sections 16/24/24 and its group of 8
query heads a KV head (8 heads on 1, as the card's exactness config takes
it). JAX ``Model.init`` params are carried over with ``params_from_numpy``;
the same numpy tokens, patch embeddings and positions go through both
packages. Every positions array has three components that differ (an
image grid of (t, h, w) on the vision tokens, then text at one index past
the grid's largest): with equal components M-RoPE is plain RoPE, and a
wrong section split would pass. atol = rtol = 1e-4 for the layers,
logits, caches and decode; one train step's loss at 1e-5 and every grad
leaf at rtol 1e-4, atol 1e-6 (the bounds of tests/test_torch_model.py);
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
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import rope_cos_sin as jrope  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.train.steps import lm_loss_and_metrics as jloss  # noqa: E402
from repro_torch.checkpoint.io import _items, params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.layers import rope_cos_sin  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.train.steps import lm_loss_and_metrics  # noqa: E402

ARCH = "qwen2-vl-72b"
TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# the smoke config, and the same at the full config's head dim, sections
# and group (G 8)
CONFIGS = {"smoke": {}, "d128": {"n_heads": 8, "n_kv_heads": 1,
                                 "head_dim": 128,
                                 "mrope_sections": (16, 24, 24)}}


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


def _vision(cfg, B, seed=0):
    return np.random.default_rng(100 + seed).standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)


def _grid_positions(B, S, nv, width=4, offset=0):
    """(B, 3, S) M-RoPE positions: the first ``nv`` tokens an image grid,
    (t, h, w) = (0, i // width, i % width), the text after it at one index
    past the grid's largest in all three components; row b shifted by
    ``offset * b``."""
    i = np.arange(nv)
    grid = np.stack([np.zeros(nv), i // width, i % width]).astype(np.int64)
    start = int(grid.max()) + 1
    text = np.broadcast_to(np.arange(start, start + S - nv), (3, S - nv))
    pos = np.concatenate([grid, text], axis=1)
    pos = np.stack([pos + offset * b for b in range(B)]).astype(np.int32)
    assert (pos[:, 0] != pos[:, 1]).any() and (pos[:, 1] != pos[:, 2]).any()
    return pos


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", sorted(CONFIGS))
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_mrope_cos_sin_matches_jax(case, theta):
    """``rope_cos_sin`` with sections over (B, 3, S) positions whose
    components differ, and the plain rope over (B, S); the M-RoPE table
    differs from the plain rope at any one component."""
    _, cfg = _cfgs(case)
    pos = _grid_positions(2, 40, cfg.n_vision_tokens, offset=3)
    got = rope_cos_sin(torch.from_numpy(pos), cfg.head_dim, theta,
                       cfg.mrope_sections)
    want = jrope(jnp.asarray(pos), cfg.head_dim, theta, cfg.mrope_sections)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 40, cfg.head_dim // 2)
        _close(g, w, tol=1e-5)
    for c in range(3):
        plain = rope_cos_sin(torch.from_numpy(pos[:, c]), cfg.head_dim,
                             theta)
        _close(plain[0], jrope(jnp.asarray(pos[:, c]), cfg.head_dim,
                               theta)[0], tol=1e-5)
        assert not torch.allclose(plain[0], got[0])
    with pytest.raises(ValueError, match="M-RoPE positions"):
        rope_cos_sin(torch.from_numpy(pos[:, :2]), cfg.head_dim, theta,
                     cfg.mrope_sections)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_gqa_forward_and_decode_with_mrope_match_jax(case):
    """One attention layer: the prefill with (B, 3, S) positions and its
    cache, then a decode at per-request positions given as (B, 3, 1), and
    one at a scalar position with its (B, 3, 1) positions."""
    jcfg, tcfg = _cfgs(case)
    jp = jattn.init_gqa(jax.random.PRNGKey(4), jcfg)
    tp = params_from_numpy(jax.device_get(jp))
    rng = np.random.default_rng(1)
    B, S, L = 2, 24, 32
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = _grid_positions(B, S, tcfg.n_vision_tokens, offset=2)
    jout, jc = jattn.gqa_forward(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos),
                                 return_cache=True)
    tout, tc = tattn.gqa_forward(tp, torch.from_numpy(x), tcfg,
                                 positions=torch.from_numpy(pos),
                                 return_cache=True)
    _close(tout, jout)
    assert set(tc) == set(jc) == {"k", "v"}
    for key in jc:
        _close(tc[key], jc[key])
    pad = ((0, 0), (0, L - S), (0, 0), (0, 0))
    jc = {k: jnp.pad(v, pad) for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    xd = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    vec = np.array([S, S - 3], np.int32)
    dpos = np.stack([vec, vec + 5, vec + 9], axis=1)[:, :, None]
    jout, jc2 = jattn.gqa_decode(jp, jnp.asarray(xd), jc, jnp.asarray(vec),
                                 jcfg, positions=jnp.asarray(dpos))
    tout, tc2 = tattn.gqa_decode(tp, torch.from_numpy(xd), tc,
                                 torch.from_numpy(vec).long(), tcfg,
                                 positions=torch.from_numpy(dpos).long())
    _close(tout, jout)
    for key in jc2:
        _close(tc2[key], jc2[key])
    jout, _ = jattn.gqa_decode(jp, jnp.asarray(xd), jc, S, jcfg,
                               positions=jnp.full((B, 3, 1), S, jnp.int32))
    tout, _ = tattn.gqa_decode(tp, torch.from_numpy(xd), tc, S, tcfg,
                               positions=torch.full((B, 3, 1), S))
    _close(tout, jout)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_params_share_key_paths_and_shapes(case):
    """The port's own init gives the reference's tree (the qkv biases of
    the vlm config among them), and ``params_from_numpy`` carries JAX's
    params across unchanged."""
    jcfg, tcfg = _cfgs(case)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in _flat(jp).items()}
    got = {k: tuple(v.shape) for k, v in _items(
        TModel(tcfg).init(torch.Generator().manual_seed(0)))}
    assert got == want
    d, H, Dh = tcfg.d_model, tcfg.n_heads, tcfg.head_dim
    assert got["blocks/attn/wq"] == (tcfg.n_layers, 1, d, H * Dh)
    assert got["blocks/attn/bk"] == (tcfg.n_layers, 1,
                                     tcfg.n_kv_heads * Dh)
    assert got["head/w"] == (d, tcfg.vocab_size)
    carried = dict(_items(params_from_numpy(jax.device_get(jp))))
    for k, v in _flat(jax.device_get(jp)).items():
        assert np.array_equal(carried[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_apply_prefill_decode_match_jax(case):
    """Vision embeddings on the first tokens and (B, 3, S) grid positions
    through ``apply`` and ``prefill`` (logits and every cache leaf), then
    decode steps at the grid's next (B, 3, 1) positions, which continue
    the full forward; one more at default positions."""
    jm, jp, tm, tp = _pair(case)
    B, S, T = 2, 24, 3
    toks = _tokens(jm.cfg, (B, S + T), seed=S)
    vis = _vision(tm.cfg, B)
    pos = _grid_positions(B, S + T, tm.cfg.n_vision_tokens, offset=1)
    jv, tv = jnp.asarray(vis), torch.from_numpy(vis)
    jl, _ = jm.apply(jp, jnp.asarray(toks), positions=jnp.asarray(pos),
                     vision_embeds=jv)
    tl, aux = tm.apply(tp, torch.from_numpy(toks).long(),
                       positions=torch.from_numpy(pos).long(),
                       vision_embeds=tv)
    _close(tl, jl)
    assert float(aux) == 0.0
    # the patch embeddings reach the logits of later tokens
    tl2, _ = tm.apply(tp, torch.from_numpy(toks).long(),
                      positions=torch.from_numpy(pos).long(),
                      vision_embeds=tv + 1.0)
    assert not torch.allclose(tl2[:, -1], tl[:, -1])

    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + T + 1,
                          positions=jnp.asarray(pos[..., :S]),
                          vision_embeds=jv)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                          cache_len=S + T + 1,
                          positions=torch.from_numpy(pos[..., :S]).long(),
                          vision_embeds=tv)
    _close(tlog, jlog)
    _close(tlog, jl[:, S - 1])
    tflat, jflat = dict(_items(tc)), _flat(jc)
    assert set(tflat) == set(jflat) == {"units/0/a/k", "units/0/a/v"}
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        _close(tflat[key], leaf)

    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        p = pos[..., S + i:S + i + 1]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), S + i,
                             positions=jnp.asarray(p))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(), S + i,
                             positions=torch.from_numpy(p).long())
        _close(tlog, jlog)
        _close(tlog, jl[:, S + i])        # decode continues the full forward
    jlog, jc = jm.decode(jp, jc, jnp.asarray(toks[:, -1:]), S + T)
    tlog, tc = tm.decode(tp, tc, torch.from_numpy(toks[:, -1:]).long(),
                         S + T)
    _close(tlog, jlog)
    for key, leaf in _flat(jc).items():
        _close(dict(_items(tc))[key], leaf)


def test_default_positions_are_the_index_in_all_three():
    """Without positions, apply's M-RoPE positions are (B, 3, S) with the
    token index in each component, as the reference's."""
    jm, jp, tm, tp = _pair("smoke")
    toks = _tokens(jm.cfg, (2, 20), seed=3)
    vis = _vision(tm.cfg, 2, seed=3)
    jl, _ = jm.apply(jp, jnp.asarray(toks), vision_embeds=jnp.asarray(vis))
    tl, _ = tm.apply(tp, torch.from_numpy(toks).long(),
                     vision_embeds=torch.from_numpy(vis))
    _close(tl, jl)
    pos = tm._default_positions(2, 20, "cpu")
    assert tuple(pos.shape) == (2, 3, 20)
    assert torch.equal(pos, torch.arange(20).expand(2, 3, 20))
    tl2, _ = tm.apply(tp, torch.from_numpy(toks).long(), positions=pos,
                      vision_embeds=torch.from_numpy(vis))
    assert torch.equal(tl, tl2)


def test_decode_per_request_positions_match_jax():
    """Continuous batching: a (B,) vector of positions, from which decode
    builds the (B, 3, 1) M-RoPE positions, as the reference's does."""
    jm, jp, tm, tp = _pair("d128")
    B, L = 3, 48
    jc, tc = jm.empty_cache(B, L), tm.empty_cache(B, L, "cpu")
    toks = _tokens(jm.cfg, (6, B), seed=2)
    pos = np.array([0, 30, 33], np.int32)
    for step in range(6):
        tok = toks[step][:, None]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok),
                             jnp.asarray(pos + step))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos + step).long())
        _close(tlog, jlog)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_embeds_cast_before_the_concatenation(dtype):
    """The patch embeddings are cast to the compute dtype and take the
    first n_vision_tokens places: the embedded sequence equals the
    reference's bitwise, in f32 and in bf16."""
    jm, jp, tm, tp = _pair("smoke", dtype=dtype)
    toks = _tokens(jm.cfg, (2, 20), seed=4)
    vis = _vision(tm.cfg, 2, seed=4)
    want = jm._embed(jp, jnp.asarray(toks), None, jnp.asarray(vis))
    got = tm._embed(tp, torch.from_numpy(toks).long(), None,
                    torch.from_numpy(vis))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    nv = tm.cfg.n_vision_tokens
    assert torch.equal(got[:, :nv], torch.from_numpy(vis).to(got.dtype))


def test_short_prompt_is_refused():
    """A prompt shorter than n_vision_tokens: the reference's
    concatenation returns more embeddings than the prompt has tokens and
    its forward fails; the port raises a ValueError naming both lengths.
    At exactly n_vision_tokens both agree."""
    jm, jp, tm, tp = _pair("smoke")
    nv = tm.cfg.n_vision_tokens
    vis = _vision(tm.cfg, 2)
    short = _tokens(jm.cfg, (2, nv - 4), seed=6)
    with pytest.raises(Exception):
        jm.apply(jp, jnp.asarray(short), vision_embeds=jnp.asarray(vis))
    with pytest.raises(ValueError, match=f"{nv} vision embeddings .* "
                                         f"{nv - 4} tokens"):
        tm.apply(tp, torch.from_numpy(short).long(),
                 vision_embeds=torch.from_numpy(vis))
    with pytest.raises(ValueError, match="vision embeddings"):
        tm.prefill(tp, torch.from_numpy(short).long(),
                   vision_embeds=torch.from_numpy(vis))
    exact = _tokens(jm.cfg, (2, nv), seed=6)
    jl, _ = jm.apply(jp, jnp.asarray(exact), vision_embeds=jnp.asarray(vis))
    tl, _ = tm.apply(tp, torch.from_numpy(exact).long(),
                     vision_embeds=torch.from_numpy(vis))
    _close(tl, jl)


@pytest.mark.parametrize("engine", ["loop", "compiled"])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_generate_is_token_exact_with_vision_embeds(case, engine):
    """Batched greedy generation with stub patch embeddings: the port's
    engines against JAX's, token for token."""
    jm, jp, tm, tp = _pair(case)
    prompts = _tokens(tm.cfg, (3, 22), seed=5)
    vis = _vision(tm.cfg, 3, seed=5)
    want, _ = jgenerate(jm, jp, jnp.asarray(prompts), 6,
                        extras={"vision_embeds": jnp.asarray(vis)},
                        engine=engine)
    got, stats = tserve.generate(
        tm, tp, torch.from_numpy(prompts), 6,
        extras={"vision_embeds": torch.from_numpy(vis)}, engine=engine)
    assert got.tolist() == np.asarray(want).tolist()
    assert stats["engine"] == engine


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_engine_per_request_positions_match_jax(case):
    """Text requests of several lengths (some shorter than
    n_vision_tokens: no patch embeddings go with them) through 2 slots:
    each slot decodes at its own (B, 3, 1) positions; tokens equal the
    JAX engine's."""
    jm, jp, tm, tp = _pair(case)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tm.cfg.vocab_size, (L,)).astype(np.int32)
               for L in (9, 23, 5, 17, 12)]
    jeng = JEngine(jm, jp, max_batch=2, max_seq=48)
    teng = TEngine(tm, tp, max_batch=2, max_seq=48)
    want = jeng.run([JRequest(rid=i, prompt=jnp.asarray(p),
                              max_new_tokens=5)
                     for i, p in enumerate(prompts)])
    got = teng.run([TRequest(rid=i, prompt=torch.from_numpy(p),
                             max_new_tokens=5)
                    for i, p in enumerate(prompts)])
    assert got == want
    assert all(len(v) == 5 for v in got.values())
    assert teng.active == 0 and not teng.waiting


def _batch(cfg, n=4, seq_len=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, seq_len + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "vision_embeds": _vision(cfg, n, seed)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_train_step_loss_and_grads_match_jax(case, remat):
    """The LM loss on a batch with vision embeddings and every grad leaf
    against ``jax.value_and_grad`` of the reference's loss, from JAX's
    init (the train step's loss, ``make_lm_train_step``'s)."""
    jm, jp, tm, tp = _pair(case, remat=remat)
    tr = _batch(tm.cfg)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss(jm, p, {k: jnp.asarray(v) for k, v in tr.items()}),
        has_aux=True)(jp)
    items = list(_items(tp))
    for _, t in items:
        t.requires_grad_()
    tl, metrics = lm_loss_and_metrics(tm, tp, {
        k: torch.from_numpy(v.copy()) for k, v in tr.items()})
    tg = torch.autograd.grad(tl, [t for _, t in items])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL)
    jflat = _flat(jax.device_get(jg))
    assert set(jflat) == {k for k, _ in items}
    for (k, _), got in zip(items, tg):
        np.testing.assert_allclose(got.numpy(), np.asarray(jflat[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    assert float(metrics["aux"]) == 0.0


def test_train_step_updates_match_jax():
    """One SGD step through both packages' ``make_lm_train_step`` on a
    batch with vision embeddings: the updated params at TOL."""
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.train.steps import make_lm_train_step as jstep_fn
    from repro_torch.configs.base import OptimizerConfig as TOpt
    from repro_torch.train.steps import make_lm_train_step as tstep_fn
    jm, jp, tm, tp = _pair("d128")
    tr = _batch(tm.cfg, seed=2)
    sched = lambda step: 0.1       # noqa: E731
    jinit, jstep = jstep_fn(jm, JOpt(), sched)
    tinit, tstep = tstep_fn(tm, TOpt(), sched)
    jnew, _, jmet = jstep(jp, jinit(jp), {k: jnp.asarray(v)
                                          for k, v in tr.items()}, 0)
    tnew, _, tmet = tstep(tp, tinit(tp), {k: torch.from_numpy(v.copy())
                                          for k, v in tr.items()}, 0)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_TOL)
    tflat = dict(_items(tnew))
    for k, v in _flat(jax.device_get(jnew)).items():
        _close(tflat[k], v)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def test_kernel_launches_follow_the_layer_plan(monkeypatch):
    """``attention_impl`` "kernel" with a test-only dispatch that sends the
    Function's launches to the plain versions on the CPU: a remat'd step
    on a batch with vision embeddings runs the flash forward twice a
    layer and its backward once, causal over S at head dim 128 and G 8;
    the grads equal plain autograd's."""
    calls = []

    def fwd(q, k, v, **kw):
        calls.append(("fwd", q.shape[2], k.shape[2], q.shape[3]))
        return fops._blockwise_fwd(q, k, v, chunk=512, **kw)

    def bwd(q, k, v, out, lse, do, **kw):
        calls.append(("bwd", q.shape[2], k.shape[2], q.shape[3]))
        return fref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)

    resolve = dispatch.resolve
    monkeypatch.setattr(dispatch, "resolve", lambda impl, dev: (
        "kernel" if impl == "kernel" else resolve(impl, dev)))
    monkeypatch.setattr(fkernel, "flash_fwd", fwd)
    monkeypatch.setattr(fkernel, "flash_bwd", bwd)
    _, cfg = _cfgs("d128", remat=True, remat_policy="dots")
    tr = _batch(cfg, n=2)
    batch = {k: torch.from_numpy(v.copy()) for k, v in tr.items()}
    params = TModel(cfg).init(torch.Generator().manual_seed(2))
    grads = {}
    for impl in ("kernel", "reference"):
        model = TModel(dataclasses.replace(cfg, attention_impl=impl))
        leaves = [t.detach().requires_grad_() for _, t in _items(params)]
        loss, _ = lm_loss_and_metrics(model, _rebuild(params, iter(leaves)),
                                      batch)
        grads[impl] = torch.autograd.grad(loss, leaves)
        if impl == "kernel":
            count = {c: calls.count(c) for c in set(calls)}
            assert count == {("fwd", 8, 1, 128): 2 * cfg.n_layers,
                             ("bwd", 8, 1, 128): cfg.n_layers}
    for (k, _), a, b in zip(_items(params), grads["kernel"],
                            grads["reference"]):
        assert k.endswith("/bk") or bool(b.abs().max() > 0), k
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)


def test_serve_main_on_cpu(capsys):
    """``launch.serve --arch qwen2-vl-72b --device cpu``: the smoke model
    served with patch embeddings made from the seed, both engines alike;
    a prompt shorter than n_vision_tokens is refused."""
    argv = ["--arch", ARCH, "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--new-tokens", "4"]
    out, stats = tserve.main(argv)
    again, _ = tserve.main(argv + ["--engine", "loop"])
    assert out.shape == (2, 4) and torch.equal(out, again)
    assert f"arch={ARCH}-smoke engine=compiled" in capsys.readouterr().out
    with pytest.raises(ValueError, match="16 vision embeddings"):
        tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "1",
                     "--prompt-len", "8", "--new-tokens", "2"])


def test_launcher_runs_swap_on_cpu(capsys):
    """``launch.train --arch qwen2-vl-72b --device cpu``: the smoke run
    (token data, no vision embeddings, as the reference launcher's) goes
    through SWAP's three phases with finite numbers."""
    res = tlaunch.main(["--arch", ARCH, "--device", "cpu", "--workers", "2",
                        "--phase1-steps", "3", "--phase2-steps", "2",
                        "--phase1-batch", "16", "--phase2-batch", "8",
                        "--seq-len", "24", "--elastic-deadline", "30"])
    assert res["phase1_steps"] == 3 and res["phase2_steps"] == 2
    assert res["phase2_live_workers"] == 2
    vals = ([e["loss"] for e in res["phase1_log"]]
            + [res[k] for k in ("phase1_test_acc", "before_avg_test_acc",
                                "after_avg_test_acc")]
            + res["worker_test_accs"])
    assert all(np.isfinite(v) for v in vals)
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke family=vlm" in out
    assert "SWAP: before avg" in out


def test_full_config_head_dim_and_params():
    """qwen2-vl-72b at full config: 64 heads of 128 on 8 KV heads (G 8), a
    head dim both flash kernels take; sections 16/24/24 fill the half-dim
    of 64; 72.70 B parameters, as the reference counts them; the model
    builds (no params made)."""
    cfg = treg.get_config(ARCH)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (64, 8, 128)
    assert sum(cfg.mrope_sections) == cfg.head_dim // 2
    assert cfg.head_dim in fkernel.FWD_HEAD_DIMS
    assert cfg.head_dim in fkernel.BWD_HEAD_DIMS
    assert abs(cfg.param_count() / 1e9 - 72.70) < 0.01
    assert cfg.param_count() == jreg.get_config(ARCH).param_count()
    model = TModel(cfg)
    assert model.use_rope and (model.n_units, model.tail_kinds) == (80, [])
