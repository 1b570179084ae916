"""Port's audio family (whisper) against the JAX package's, on the CPU.

The whisper smoke config in f32 (2 encoder and 2 decoder layers, d_model
128, 4 heads of 32, encoder_seq 64), and the same at whisper-base's head
dim of 64 (2 heads, as the card's exactness config takes it). JAX
``Model.init`` params are carried over with ``params_from_numpy``; the
same numpy tokens and frames go through both packages. atol = rtol = 1e-4
for the layers, logits, caches and decode; one train step's loss and
every grad leaf 1e-5 in relative L2; serving token for token.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core.adapters import LMAdapter as JAdapter  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import sinusoidal_embedding as jsinus  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train.steps import lm_loss_and_metrics as jloss  # noqa: E402
from repro_torch.checkpoint.io import _items, params_from_numpy  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.layers import sinusoidal_embedding  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.optim.api import tree_leaves  # noqa: E402
from repro_torch.serve.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.train.steps import lm_loss_and_metrics  # noqa: E402

ARCH = "whisper-base"
TOL = 1e-4
STEP_TOL = 1e-5
# the smoke config (head dim 32) and the same at whisper-base's head dim
CONFIGS = {"smoke": {}, "d64": {"n_heads": 2, "n_kv_heads": 2,
                                "head_dim": 64}}


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


def _frames(cfg, B, seed=0):
    return np.random.default_rng(100 + seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("d_model", [128, 512])
@pytest.mark.parametrize("batched", [False, True])
def test_sinusoidal_embedding_matches_jax(d_model, batched):
    pos = np.arange(1500) if not batched else np.stack(
        [np.arange(7, 71), np.arange(64)])
    got = sinusoidal_embedding(torch.from_numpy(pos), d_model)
    want = jsinus(jnp.asarray(pos), d_model)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    # f32 angles up to 1500 rad, whose ulp is 1.2e-4: the two libraries'
    # exp may put a frequency one ulp apart, and their sin and cos reduce
    # the angle differently; held to two ulps of the largest angle
    tol = 2 * float(pos.max()) * 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


def _layer_params(cfg):
    jp = jattn.init_gqa(jax.random.PRNGKey(4), cfg, cross=True)
    return jp, params_from_numpy(jax.device_get(jp))


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_cross_attention_forward_and_cache_match_jax(case):
    """Cross ``gqa_forward``: q from the decoder, k and v (and the cache)
    from the encoder output, no rope, no mask, Sq != Skv."""
    jcfg, tcfg = _cfgs(case)
    jp, tp = _layer_params(jcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, tcfg.encoder_seq,
                               tcfg.d_model)).astype(np.float32)
    jout, jc = jattn.gqa_forward(jp, jnp.asarray(x), jcfg,
                                 cross_x=jnp.asarray(enc), return_cache=True)
    tout, tc = tattn.gqa_forward(tp, torch.from_numpy(x), tcfg,
                                 cross_x=torch.from_numpy(enc),
                                 return_cache=True)
    _close(tout, jout)
    assert set(tc) == set(jc) == {"k", "v"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape == (
            2, tcfg.encoder_seq, tcfg.n_kv_heads, tcfg.head_dim)
        _close(tc[key], jc[key])


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_cross_attention_decode_matches_jax(case):
    """Cross ``gqa_decode``: q alone, over the static encoder K/V, which
    comes back unchanged."""
    jcfg, tcfg = _cfgs(case)
    jp, tp = _layer_params(jcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 3, tcfg.encoder_seq, tcfg.n_kv_heads,
                              tcfg.head_dim)).astype(np.float32)
    jc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])}
    tc = {"k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1])}
    jout, _ = jattn.gqa_decode(jp, jnp.asarray(x), jc, 5, jcfg, cross=True)
    tout, tnew = tattn.gqa_decode(tp, torch.from_numpy(x), tc, 5, tcfg,
                                  cross=True)
    _close(tout, jout)
    assert tnew is tc


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_params_share_key_paths_and_shapes(case):
    """The port's own init gives the reference's tree (the decoder blocks'
    ``lnx``/``xattn``, the stacked ``encoder/blocks`` and its ``norm``),
    and ``params_from_numpy`` carries JAX's params across unchanged."""
    jcfg, tcfg = _cfgs(case)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in _flat(jp).items()}
    got = {k: tuple(v.shape) for k, v in _items(
        TModel(tcfg).init(torch.Generator().manual_seed(0)))}
    assert got == want
    d, H, Dh = tcfg.d_model, tcfg.n_heads, tcfg.head_dim
    assert got["blocks/xattn/wq"] == (tcfg.n_layers, 1, d, H * Dh)
    assert got["blocks/xattn/bk"] == (tcfg.n_layers, 1, H * Dh)
    assert got["encoder/blocks/attn/wq"] == (tcfg.n_encoder_layers, d, H * Dh)
    assert "encoder/blocks/xattn/wq" not in got
    assert got["encoder/norm/bias"] == (d,)
    carried = dict(_items(params_from_numpy(jax.device_get(jp))))
    for k, v in _flat(jax.device_get(jp)).items():
        assert np.array_equal(carried[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_encoder_matches_jax(case):
    """The encoder alone: sinusoidal positions, non-causal self attention
    in each block, the final norm."""
    jm, jp, tm, tp = _pair(case)
    frames = _frames(tm.cfg, 2)
    want = jm._encode(jp, jnp.asarray(frames))
    got = tm._encode(tp, torch.from_numpy(frames))
    _close(got, want)
    # non-causal: the first frame's output depends on the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    assert not torch.allclose(tm._encode(tp, torch.from_numpy(moved))[:, 0],
                              got[:, 0])


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_apply_prefill_decode_match_jax(case):
    jm, jp, tm, tp = _pair(case)
    B, S, T = 2, 12, 3
    toks = _tokens(jm.cfg, (B, S + T), seed=S)
    frames = _frames(tm.cfg, B)
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    jl, _ = jm.apply(jp, jnp.asarray(toks), frames=jf)
    tl, aux = tm.apply(tp, torch.from_numpy(toks).long(), frames=tf)
    _close(tl, jl)
    assert float(aux) == 0.0

    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache_len=S + T,
                          frames=jf)
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks[:, :S]).long(),
                          cache_len=S + T, frames=tf)
    _close(tlog, jlog)
    tflat, jflat = dict(_items(tc)), _flat(jc)
    assert set(tflat) == set(jflat)
    assert {"units/0/x/k", "units/0/x/v", "units/0/a/k"} <= set(tflat)
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        _close(tflat[key], leaf)

    for i in range(T):
        tok = toks[:, S + i:S + i + 1]
        jlog, jc = jm.decode(jp, jc, jnp.asarray(tok), S + i)
        tlog, tc = tm.decode(tp, tc, torch.from_numpy(tok).long(), S + i)
        _close(tlog, jlog)
        _close(tlog, jl[:, S + i])        # decode continues the full forward
    for key, leaf in _flat(jc).items():
        _close(dict(_items(tc))[key], leaf)


def test_empty_cache_matches_jax():
    jm, _, tm, _ = _pair("smoke")
    jc, tc = jm.empty_cache(3, 16), tm.empty_cache(3, 16, "cpu")
    tflat, jflat = dict(_items(tc)), _flat(jc)
    assert set(tflat) == set(jflat) and "units/0/x/v" in tflat
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        assert str(tflat[key].dtype).split(".")[-1] == str(leaf.dtype), key
        assert not bool(tflat[key].any())


def test_apply_without_frames_raises():
    _, _, tm, tp = _pair("smoke")
    with pytest.raises(ValueError, match="needs frames"):
        tm.apply(tp, torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("engine", ["loop", "compiled"])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_generate_is_token_exact_with_frames(case, engine):
    """Batched greedy generation with frames: the port's engines against
    JAX's, token for token."""
    jm, jp, tm, tp = _pair(case)
    prompts = _tokens(tm.cfg, (3, 10), seed=5)
    frames = _frames(tm.cfg, 3, seed=5)
    want, _ = jgenerate(jm, jp, jnp.asarray(prompts), 6,
                        extras={"frames": jnp.asarray(frames)},
                        engine=engine)
    got, stats = tserve.generate(tm, tp, torch.from_numpy(prompts), 6,
                                 extras={"frames": torch.from_numpy(frames)},
                                 engine=engine)
    assert got.tolist() == np.asarray(want).tolist()
    assert stats["engine"] == engine


def _batch(cfg, n=4, seq_len=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, seq_len + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "frames": _frames(cfg, n, seed)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_train_step_loss_and_grads_match_jax(case, remat):
    """The LM loss on a batch with frames and every grad leaf (the
    encoder's through the cross attention among them) against
    ``jax.value_and_grad`` of the reference's, from JAX's init; with remat
    the decoder units run under checkpoint, the encoder does not."""
    jcfg, tcfg = _cfgs(case, remat=remat)
    jad, tad = JAdapter(jcfg, jbase.OptimizerConfig()), LMAdapter(
        tcfg, tbase.OptimizerConfig())
    jp = jad.init(jax.random.PRNGKey(1))["params"]
    tp = params_from_numpy(jax.device_get(jp))
    tr = _batch(tcfg)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jloss(jad.model, p, {k: jnp.asarray(v)
                                       for k, v in tr.items()}),
        has_aux=True)(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tl, _ = lm_loss_and_metrics(tad.model, tp, {
        k: torch.from_numpy(v.copy()) for k, v in tr.items()})
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=STEP_TOL)
    jflat = _flat(jax.device_get(jg))
    keys = sorted(jflat)
    assert keys == [k for k, _ in _items(tp)]
    assert any(k.startswith("encoder/blocks/attn/") for k in keys)
    scale = max(float(np.abs(g).max()) for g in jflat.values())
    for k, got in zip(keys, tg):
        if k.endswith("/bk"):
            # a key bias adds q.bk to every score of a query's row, which
            # the softmax takes away: its true grad is 0, and both packages
            # give f32 noise
            assert float(np.abs(jflat[k]).max()) < 1e-6 * scale, k
            assert float(got.abs().max()) < 1e-6 * scale, k
            continue
        assert float(np.abs(jflat[k]).max()) > 0, k
        assert _rel_l2(got.numpy(), jflat[k]) <= STEP_TOL, k


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def test_kernel_launches_follow_the_layer_plan(monkeypatch):
    """``attention_impl`` "kernel" with a test-only dispatch that sends the
    Function's launches to the plain versions on the CPU: a step of the
    remat'd decoder runs the flash forward once an encoder layer, and
    twice each of a decoder layer's self and cross attention; its backward
    once each; the encoder's launches are non-causal over encoder_seq, the
    cross ones non-causal from the decoder's S to encoder_seq; the grads
    equal plain autograd's."""
    calls = []

    def fwd(q, k, v, **kw):
        calls.append(("fwd", q.shape[1], k.shape[1], kw["causal"]))
        return fops._blockwise_fwd(q, k, v, chunk=512, **kw)

    def bwd(q, k, v, out, lse, do, **kw):
        calls.append(("bwd", q.shape[1], k.shape[1], kw["causal"]))
        return fref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)

    resolve = dispatch.resolve
    monkeypatch.setattr(dispatch, "resolve", lambda impl, dev: (
        "kernel" if impl == "kernel" else resolve(impl, dev)))
    monkeypatch.setattr(fkernel, "flash_fwd", fwd)
    monkeypatch.setattr(fkernel, "flash_bwd", bwd)
    _, cfg = _cfgs("d64", remat=True, remat_policy="dots")
    tr = _batch(cfg, n=2, seq_len=16)
    batch = {k: torch.from_numpy(v.copy()) for k, v in tr.items()}
    params = TModel(cfg).init(torch.Generator().manual_seed(2))
    grads = {}
    E, S, n_enc, n_dec = cfg.encoder_seq, 16, cfg.n_encoder_layers, \
        cfg.n_layers
    for impl in ("kernel", "reference"):
        model = TModel(dataclasses.replace(cfg, attention_impl=impl))
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = lm_loss_and_metrics(model, _rebuild(params, iter(leaves)),
                                      batch)
        grads[impl] = torch.autograd.grad(loss, leaves)
        if impl == "kernel":
            count = {c: calls.count(c) for c in set(calls)}
            assert count == {
                ("fwd", E, E, False): n_enc, ("bwd", E, E, False): n_enc,
                ("fwd", S, S, True): 2 * n_dec, ("bwd", S, S, True): n_dec,
                ("fwd", S, E, False): 2 * n_dec, ("bwd", S, E, False): n_dec}
    keys = [k for k, _ in _items(params)]
    for k, a, b in zip(keys, grads["kernel"], grads["reference"]):
        assert k.endswith("/bk") or bool(b.abs().max() > 0), k
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)


def test_serve_main_on_cpu(capsys):
    """``launch.serve --arch whisper-base --device cpu``: the smoke model
    served with frames made from the seed, both engines alike."""
    argv = ["--arch", ARCH, "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "4"]
    out, stats = tserve.main(argv)
    again, _ = tserve.main(argv + ["--engine", "loop"])
    assert out.shape == (2, 4) and torch.equal(out, again)
    assert f"arch={ARCH}-smoke engine=compiled" in capsys.readouterr().out


def test_full_config_head_dim_and_params():
    """whisper-base at full config: 8 heads of 64 (G 1), a head dim both
    flash kernels take; 6 + 6 layers, encoder_seq 1500; 0.110 B
    parameters, as the reference counts them."""
    cfg = treg.get_config(ARCH)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (8, 8, 64)
    assert cfg.head_dim in fkernel.FWD_HEAD_DIMS
    assert cfg.head_dim in fkernel.BWD_HEAD_DIMS
    assert (cfg.n_layers, cfg.n_encoder_layers, cfg.encoder_seq) == (
        6, 6, 1500)
    assert abs(cfg.param_count() / 1e9 - 0.110) < 0.005
    assert cfg.param_count() == jreg.get_config(ARCH).param_count()
    model = TModel(cfg)
    assert model.unit_kinds[0].cross and not model.use_rope


def test_training_launcher_refuses_audio():
    """The reference's launcher makes no frames, so the port's refuses the
    audio family before any data is made, naming why."""
    with pytest.raises(NotImplementedError, match="needs frames"):
        tlaunch.build(tlaunch.build_parser().parse_args(
            ["--arch", ARCH, "--device", "cpu", "--workers", "2"]))


def test_continuous_engine_refuses_audio():
    _, _, tm, tp = _pair("smoke")
    with pytest.raises(NotImplementedError, match="takes no encoder frames"):
        TEngine(tm, tp, max_batch=2, max_seq=32)
