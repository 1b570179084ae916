"""Port's LM (dense, moe and ssm families; GQA and MLA) against the JAX
package's, on the CPU.

JAX ``Model.init`` params are carried over with ``params_from_numpy``; the
same numpy tokens go through both. f32 smoke configs, atol = rtol = 1e-4;
the MoE aux loss at 1e-6 relative.
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
from repro_torch.configs.base import replace as treplace  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

TOL = 1e-4
DENSE = ["internlm2-1.8b", "qwen2.5-14b", "gemma3-1b"]
# the MoE family (granite-moe, qwen3-moe: GQA; deepseek-v2-lite: MLA) and
# MLA in a dense model (minicpm3, smoke head dim 48 on the plain version)
MOE_MLA = ["deepseek-v2-lite", "granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
           "minicpm3-4b"]


def _pair(arch, **overrides):
    jcfg = jreplace(jreg.get_smoke_config(arch), **overrides)
    tcfg = treplace(treg.get_smoke_config(arch), **overrides)
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


@pytest.mark.parametrize("arch", DENSE + MOE_MLA)
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


def _no_drop(cfg):
    """The capacity factor that drops no token (tests/test_arch_smoke.py),
    under which prefill + decode reproduce apply."""
    return {"moe.capacity_factor": cfg.moe.n_experts / cfg.moe.top_k * 1.1}


@pytest.mark.parametrize("arch", MOE_MLA)
def test_moe_mla_apply_with_aux_matches_jax(arch):
    """Logits and the summed router aux loss of the whole smoke model at a
    capacity factor of 0.75, which drops tokens at this length (16 slots an
    expert for 20 assignments on average): the port drops the ones JAX
    drops."""
    cfg = treg.get_smoke_config(arch)
    jm, jp, tm, tp = _pair(arch, **({"moe.capacity_factor": 0.75}
                                    if cfg.moe else {}))
    toks = _tokens(jm.cfg, (2, 40), seed=5)
    jl, jaux = jm.apply(jp, jnp.asarray(toks))
    tl, taux = tm.apply(tp, torch.from_numpy(toks).long())
    _close(tl, jl)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert (float(taux) > 0) == (jm.cfg.family == "moe")


@pytest.mark.parametrize("arch", MOE_MLA)
def test_moe_mla_prefill_decode_match_jax_and_apply(arch):
    """Prefill (logits and the latent or K/V cache) and decode steps
    against JAX, and against the port's own apply, at the no-drop capacity
    factor; then decode with per-row positions as the engine's slots do."""
    cfg = treg.get_smoke_config(arch)
    jm, jp, tm, tp = _pair(arch, **(_no_drop(cfg) if cfg.moe else {}))
    B, S, T = 2, 24, 3
    toks = _tokens(jm.cfg, (B, S + T), seed=6)
    full, _ = tm.apply(tp, torch.from_numpy(toks).long())
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + T)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                          cache_len=S + T)
    _close(tlog, jlog)
    _close(tlog, full[:, S - 1].numpy())
    tflat, jflat = dict(_items(tc)), _flat(jc)
    assert set(tflat) == set(jflat)
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        _close(tflat[key], leaf)
    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), S + i)
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(), S + i)
        _close(tlog, jlog)
        _close(tlog, full[:, S + i].numpy())

    L = 32
    jc, tc = jm.empty_cache(B + 1, L), tm.empty_cache(B + 1, L, "cpu")
    steps = _tokens(jm.cfg, (4, B + 1), seed=7)
    pos = np.array([0, 9, 20], np.int32)
    for step in range(4):
        tok = steps[step][:, None]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.asarray(pos + step))
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos + step).long())
        _close(tlog, jlog)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_moe_mla_remat_keeps_logits_aux_and_grads(policy):
    """Under autograd each pattern unit is rematerialized (the unit returns
    the hidden state and the running aux loss): the same logits, aux and
    grads as without remat, bitwise (deepseek-v2-lite smoke: MLA + MoE)."""
    cfg = treg.get_smoke_config("deepseek-v2-lite")
    toks = torch.from_numpy(_tokens(cfg, (2, 20), seed=8)).long()
    params = TModel(cfg).init(torch.Generator().manual_seed(0))
    out = []
    for remat in (False, True):
        m = TModel(treplace(cfg, remat=remat, remat_policy=policy))
        leaves = [t.detach().clone().requires_grad_() for _, t in
                  _items(params)]
        tree = _rebuild(params, iter(leaves))
        logits, aux = m.apply(tree, toks)
        grads = torch.autograd.grad(logits.square().mean() + aux, leaves)
        out.append((logits.detach(), aux.detach(), grads))
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(a0, a1) and float(a0) > 0
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))


def _rebuild(tree, it):
    """``tree``'s structure with its leaves, in ``_items`` order, from it."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def test_dense_init_scales_in_place_bitwise():
    """dense_init and embed_init scale their draw in place: the values are
    bitwise those of the out-of-place product, with no second copy."""
    from repro_torch.models import layers
    shape, lead = (64, 48), (3,)
    got = layers.dense_init(torch.Generator().manual_seed(11), shape,
                            fan_in=7, lead=lead)
    t = torch.empty(lead + shape)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=torch.Generator().manual_seed(11))
    assert torch.equal(got, t * (1.0 / 7 ** 0.5))
    emb = layers.embed_init(torch.Generator().manual_seed(12), (32, 16))
    draw = torch.empty(32, 16).normal_(
        0.0, 1.0, generator=torch.Generator().manual_seed(12))
    assert torch.equal(emb, draw * 0.02)


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


# gemma3's smoke config at its full-width head dim of 256: 2 layers (one
# local at window 32, one global), sequences longer than the window. Logits
# at TOL; grads of the LM loss at the port's train-step bounds (rtol 1e-4,
# atol 1e-6: f32 sums in another order than XLA's)
NARROW_256 = dict(head_dim=256)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def test_gemma3_head_dim_256_logits_and_grads_match_jax():
    from repro.train.steps import lm_loss_and_metrics as jloss
    from repro_torch.train.steps import lm_loss_and_metrics as tloss
    jm, jp, tm, tp = _pair("gemma3-1b", **NARROW_256)
    assert tm.cfg.head_dim == 256 and tm.cfg.sliding_window == 32
    assert [k.window for k in tm.unit_kinds] == [32, 0]
    B, S = 2, 48
    toks = _tokens(jm.cfg, (B, S + 1), seed=4)
    jl, _ = jm.apply(jp, jnp.asarray(toks[:, :S]))
    tl, _ = tm.apply(tp, torch.from_numpy(toks[:, :S]).long())
    _close(tl, jl)

    jb = {"tokens": jnp.asarray(toks[:, :S]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :S]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    (jloss_v, _), jg = jax.value_and_grad(
        lambda p: jloss(jm, p, jb), has_aux=True)(jp)
    items = list(_items(tp))
    for _, t in items:
        t.requires_grad_()
    tloss_v, _ = tloss(tm, tp, tb)
    tg = torch.autograd.grad(tloss_v, [t for _, t in items])
    np.testing.assert_allclose(float(tloss_v.detach()), float(jloss_v),
                               rtol=1e-5)
    jflat = _flat(jax.device_get(jg))
    assert set(jflat) == {k for k, _ in items}
    for (k, _), got in zip(items, tg):
        np.testing.assert_allclose(got.numpy(), np.asarray(jflat[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


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


@pytest.mark.parametrize("what", ["family", "attention"])
def test_model_refuses_configs_outside_the_slice(what):
    """Every family of the reference's Model is ported (qwen2-vl's vlm the
    last): an unknown family is refused where the config is made, and an
    attention kind other than GQA and MLA by the model."""
    cfg = treg.get_smoke_config("qwen2-vl-72b")
    if what == "family":
        with pytest.raises(ValueError, match="unknown family 'retrieval'"):
            treplace(cfg, family="retrieval")
        return
    with pytest.raises(NotImplementedError, match="attention 'linear'"):
        TModel(treplace(cfg, attention="linear"))


def test_audio_family_left_the_refused_configs():
    """whisper-base builds at its smoke and full configs: one cross layer
    a pattern unit, no rope, the encoder's blocks stacked at
    ``encoder/blocks`` (its twin against JAX: tests/test_torch_whisper.py)."""
    for get in (treg.get_smoke_config, treg.get_config):
        cfg = get("whisper-base")
        model = TModel(cfg)
        assert model.unit_kinds[0].cross and not model.use_rope
        assert (model.n_units, model.tail_kinds) == (cfg.n_layers, [])
    params = TModel(treg.get_smoke_config("whisper-base")).init(
        torch.Generator().manual_seed(0))
    assert set(params["encoder"]) == {"blocks", "norm"}
    assert {"lnx", "xattn"} <= set(params["blocks"])


def test_hybrid_smoke_model_and_training_launcher_build():
    """zamba2-7b left the refused families: its smoke model builds (2
    units of 2 mamba layers, the shared block's params at ``shared``) and
    the training launcher builds its run on the CPU."""
    from repro_torch.launch import train as tlaunch
    model = TModel(treg.get_smoke_config("zamba2-7b"))
    params = model.init(torch.Generator().manual_seed(0))
    assert (model.n_units, len(model.unit_kinds), model.tail_kinds) == (
        2, 2, [])
    assert set(params["shared"]) == {"ln1", "ln2", "attn", "mlp"}
    swap = tlaunch.build(tlaunch.build_parser().parse_args(
        ["--arch", "zamba2-7b", "--device", "cpu", "--workers", "2"]))
    assert swap.adapter.cfg.family == "hybrid"
