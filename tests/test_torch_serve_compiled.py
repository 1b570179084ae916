"""The port's compiled serving engine against the JAX package's, on the CPU.

Each scenario of ``tests/test_serve_compiled.py`` runs through the JAX
``CompiledServingEngine`` and the port's, on JAX ``Model.init`` params
carried across with ``params_from_numpy`` and the same numpy prompts from
a seed: the tokens of every request must be identical, and so must the
engines' ``stats`` (the same scheduling: decode calls, admissions, page
waits, compiled buckets), with ``decode_transfers == decode_calls``. The
port's tokens are also held against its own ``ServingEngine`` and
single-request ``generate`` where the reference's test holds them. The
paged-layout scenarios and the admission deadlines are in
``test_torch_serve_paged.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.compiled import CompiledServingEngine as JCompiled  # noqa: E402
from repro.serve.compiled import default_buckets as jdefault_buckets  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data import prng  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve import (CompiledServingEngine, DecodeState,  # noqa: E402
                               Request, ServingEngine, default_buckets)

_SETUP = {}


def setup(arch):
    """(JAX model, JAX params, port model, port params), made once."""
    if arch not in _SETUP:
        jm = JModel(jreg.get_smoke_config(arch))
        tm = TModel(treg.get_smoke_config(arch))
        jp = jm.init(jax.random.PRNGKey(0))
        _SETUP[arch] = (jm, jp, tm, params_from_numpy(jax.device_get(jp)))
    return _SETUP[arch]


def prompts(cfg, lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lengths]


class Side:
    """One package's engines, requests and generate, over numpy prompts."""

    def __init__(self, arch, jax_side: bool):
        jm, jp, tm, tp = setup(arch)
        self.jax = jax_side
        self.model, self.params = (jm, jp) if jax_side else (tm, tp)

    def compiled(self, **kw):
        cls = JCompiled if self.jax else CompiledServingEngine
        if "rng" in kw:
            kw["rng"] = (jax.random.PRNGKey if self.jax
                         else prng.PRNGKey)(kw["rng"])
        return cls(self.model, self.params, **kw)

    def oracle(self, **kw):
        cls = JEngine if self.jax else ServingEngine
        return cls(self.model, self.params, **kw)

    def request(self, rid, prompt, max_new_tokens, **kw):
        if self.jax:
            return JRequest(rid=rid, prompt=jnp.asarray(prompt),
                            max_new_tokens=max_new_tokens, **kw)
        return Request(rid=rid, prompt=torch.from_numpy(prompt),
                       max_new_tokens=max_new_tokens, **kw)

    def generate(self, prompt, n_new):
        if self.jax:
            out, _ = jgenerate(self.model, self.params,
                               jnp.asarray(prompt)[None], n_new)
        else:
            out, _ = tserve.generate(self.model, self.params,
                                     torch.from_numpy(prompt)[None], n_new)
        return [int(t) for t in np.asarray(out)[0]]


def both(arch, scenario):
    """``scenario(side)`` on the JAX package and on the port: (want,
    got)."""
    return scenario(Side(arch, True)), scenario(Side(arch, False))


def check_stats(jeng, teng):
    assert teng.stats == jeng.stats
    assert teng.stats["decode_transfers"] == teng.stats["decode_calls"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b"])
def test_compiled_matches_jax_oracle_and_generate(arch):
    """5 requests of different prompt lengths through 2 slots: the port's
    compiled engine gives the JAX compiled engine's tokens and stats, the
    JAX per-step engine's tokens, and each request's single-request
    generate."""
    cfg = setup(arch)[2].cfg
    ps = prompts(cfg, [9, 17, 5, 12, 8])

    def run(side):
        eng = side.compiled(max_batch=2, max_seq=64, decode_block=4)
        return eng, eng.run([side.request(i, p, 6) for i, p in enumerate(ps)])

    (jeng, want), (teng, got) = both(arch, run)
    assert got == want
    check_stats(jeng, teng)
    assert teng.stats["decode_calls"] > 0
    oracle = Side(arch, True).oracle(max_batch=2, max_seq=64).run(
        [Side(arch, True).request(i, p, 6) for i, p in enumerate(ps)])
    port = Side(arch, False)
    for i, p in enumerate(ps):
        assert got[i] == oracle[i], i
        assert got[i] == port.generate(p, 6), i
    assert isinstance(teng.state, DecodeState)
    assert teng.state.tokens.shape == (2,) and teng.kv_layout == (
        "paged" if arch == "internlm2-1.8b" else "dense")


def test_sliding_window_arch_with_padded_buckets_matches_jax():
    """gemma3 (window and global layers): bucket padding keeps the window
    slots arranged by real positions."""
    cfg = setup("gemma3-1b")[2].cfg
    ps = prompts(cfg, [7, 13])

    def run(side):
        eng = side.compiled(max_batch=2, max_seq=64, decode_block=2,
                            prefill_buckets=(16, 64))
        return eng, eng.run([side.request(i, p, 5) for i, p in enumerate(ps)])

    (jeng, want), (teng, got) = both("gemma3-1b", run)
    assert got == want
    check_stats(jeng, teng)
    port = Side("gemma3-1b", False)
    for i, p in enumerate(ps):
        assert got[i] == port.generate(p, 5), i


def test_staggered_arrivals_match_jax():
    """Requests submitted after decode blocks already ran come out
    token-exact; late arrivals wait for a free slot."""
    cfg = setup("internlm2-1.8b")[2].cfg
    ps = prompts(cfg, [9, 6, 11, 7], seed=3)

    def run(side):
        eng = side.compiled(max_batch=2, max_seq=64, decode_block=3)
        reqs = [side.request(i, p, 8) for i, p in enumerate(ps)]
        for r in reqs[:2]:
            eng.submit(r)
        eng.step()
        eng.submit(reqs[2])
        eng.step()
        eng.submit(reqs[3])
        steps = 0
        while (eng.active or eng.waiting) and steps < 100:
            eng.step()
            steps += 1
        return eng, [r.generated for r in reqs]

    (jeng, want), (teng, got) = both("internlm2-1.8b", run)
    assert got == want
    check_stats(jeng, teng)
    port = Side("internlm2-1.8b", False)
    for i, p in enumerate(ps):
        assert got[i] == port.generate(p, 8), i


def test_mid_stream_eos_matches_jax():
    """An EOS inside a decode block stops the request exactly where the
    oracle stops it."""
    port = Side("internlm2-1.8b", False)
    prompt = prompts(port.model.cfg, [8], seed=5)[0]
    ref = port.generate(prompt, 6)
    stop = next(j for j in range(1, len(ref)) if ref[j] not in ref[:j])
    eos = ref[stop]

    def run(side):
        eng = side.compiled(max_batch=2, max_seq=32, decode_block=4)
        req = side.request(0, prompt, 10, eos_id=eos)
        eng.run([req])
        return eng, req

    (jeng, jreq), (teng, treq) = both("internlm2-1.8b", run)
    assert treq.generated == jreq.generated
    assert treq.generated[-1] == eos and len(treq.generated) == stop + 1
    assert treq.done and teng.stats["decode_calls"] > 0
    check_stats(jeng, teng)
    oracle = port.oracle(max_batch=2, max_seq=32)
    r_o = port.request(0, prompt, 10, eos_id=eos)
    oracle.run([r_o])
    assert treq.generated == r_o.generated


def test_eos_as_first_token_finishes_at_admission():
    port = Side("internlm2-1.8b", False)
    prompt = prompts(port.model.cfg, [8], seed=6)[0]
    ref = port.generate(prompt, 2)

    def run(side):
        eng = side.compiled(max_batch=1, max_seq=32, decode_block=4)
        req = side.request(0, prompt, 10, eos_id=ref[0])
        eng.run([req])
        return eng, req

    (jeng, jreq), (teng, treq) = both("internlm2-1.8b", run)
    assert treq.done and treq.generated == [ref[0]] == jreq.generated
    assert teng.stats["decode_calls"] == 0
    check_stats(jeng, teng)


def test_slot_reuse_after_free_matches_jax():
    """3 requests through one slot: each admission re-prefills the slot's
    rows, so a request is exact despite the dirty slot it inherits."""
    cfg = setup("internlm2-1.8b")[2].cfg
    ps = prompts(cfg, [6, 10, 7], seed=7)

    def run(side):
        eng = side.compiled(max_batch=1, max_seq=32, decode_block=4)
        return eng, eng.run([side.request(i, p, 4) for i, p in enumerate(ps)])

    (jeng, want), (teng, got) = both("internlm2-1.8b", run)
    assert got == want
    check_stats(jeng, teng)
    port = Side("internlm2-1.8b", False)
    for i, p in enumerate(ps):
        assert got[i] == port.generate(p, 4), i
    assert teng.active == 0 and not teng.waiting


def test_admission_chain_when_request_finishes_at_admission():
    """A request that finishes at admission (budget 1) frees its slot in
    the same pass, so the requests behind it are not stranded (both of the
    port's engines)."""
    cfg = setup("internlm2-1.8b")[2].cfg
    ps = prompts(cfg, [6, 8, 7], seed=15)
    budgets = (5, 1, 5)

    def run(side):
        eng = side.compiled(max_batch=1, max_seq=32, decode_block=4)
        reqs = [side.request(i, p, n) for i, (p, n) in
                enumerate(zip(ps, budgets))]
        return eng, eng.run(reqs, max_steps=200), reqs

    (jeng, want, _), (teng, got, reqs) = both("internlm2-1.8b", run)
    assert got == want and all(r.done for r in reqs)
    check_stats(jeng, teng)
    port = Side("internlm2-1.8b", False)
    oracle = port.oracle(max_batch=1, max_seq=32)
    oreqs = [port.request(i, p, n) for i, (p, n) in
             enumerate(zip(ps, budgets))]
    assert oracle.run(oreqs, max_steps=200) == got
    assert all(r.done for r in oreqs)
    assert got[1] == port.generate(ps[1], 1)
    assert got[2] == port.generate(ps[2], 5)


def test_max_seq_truncation_matches_jax():
    """A request that would run past max_seq-1 stops at exactly the
    oracle's point (the position check after the increment)."""
    port = Side("internlm2-1.8b", False)
    prompt = prompts(port.model.cfg, [10], seed=9)[0]

    def run(side):
        eng = side.compiled(max_batch=1, max_seq=16, decode_block=4)
        req = side.request(0, prompt, 50)
        eng.run([req])
        return eng, req

    (jeng, jreq), (teng, treq) = both("internlm2-1.8b", run)
    assert treq.generated == jreq.generated
    assert len(treq.generated) < 50 and treq.done
    check_stats(jeng, teng)
    oracle = port.oracle(max_batch=1, max_seq=16)
    r_o = port.request(0, prompt, 50)
    oracle.run([r_o])
    assert treq.generated == r_o.generated


@pytest.mark.parametrize("block", [1, 5])
def test_decode_block_size_invariance(block):
    """K is a throughput knob: K = 1 and K = 5 give the same tokens, the
    JAX engine's at the same K."""
    cfg = setup("internlm2-1.8b")[2].cfg
    ps = prompts(cfg, [9, 12], seed=11)

    def run(side, k):
        eng = side.compiled(max_batch=2, max_seq=48, decode_block=k)
        return eng, eng.run([side.request(i, p, 7) for i, p in enumerate(ps)])

    (jeng, want), (teng, got) = both("internlm2-1.8b",
                                     lambda s: run(s, block))
    assert got == want
    check_stats(jeng, teng)
    _, other = run(Side("internlm2-1.8b", False), 6 - block)
    assert got == other


def test_categorical_sampling_matches_jax():
    """Sampling in the K-step block (a key split and Gumbel noise from
    ``data.prng``) gives the JAX engine's samples for the same key, and is
    reproducible."""
    cfg = setup("internlm2-1.8b")[2].cfg
    ps = prompts(cfg, [8, 6], seed=13)

    def run(side):
        eng = side.compiled(max_batch=2, max_seq=48, decode_block=4,
                            sample="categorical", temperature=0.8, rng=42)
        return eng, eng.run([side.request(i, p, 5) for i, p in enumerate(ps)])

    (jeng, want), (teng, got) = both("internlm2-1.8b", run)
    assert got == want
    check_stats(jeng, teng)
    _, again = run(Side("internlm2-1.8b", False))
    assert again == got
    assert all(len(v) == 5 for v in got.values())
    assert all(0 <= t < cfg.vocab_size for v in got.values() for t in v)
    np.testing.assert_array_equal(teng.state.rng.numpy(),
                                  np.asarray(jeng.state.rng))


def test_oversize_prompt_rejected_clearly():
    port = Side("internlm2-1.8b", False)
    prompt = prompts(port.model.cfg, [30], seed=19)[0]
    for make in (port.compiled, port.oracle):
        eng = make(max_batch=1, max_seq=24)
        with pytest.raises(ValueError, match="cannot fit the engine cache"):
            eng.submit(port.request(0, prompt, 4))


def test_default_buckets_shape():
    for max_seq in (256, 96, 16, 1024):
        assert default_buckets(max_seq) == jdefault_buckets(max_seq)
    assert default_buckets(256) == (16, 32, 64, 128, 256)
    assert default_buckets(96) == (16, 32, 64, 96)
    assert default_buckets(16) == (16,)


def test_capped_buckets_complete_to_max_seq_and_count_compiles():
    """Buckets capped below max_seq are completed with max_seq, and every
    bucket counts once in prefill_compiles, as in the JAX engine."""
    cfg = setup("internlm2-1.8b")[2].cfg

    def run(side):
        eng = side.compiled(max_batch=1, max_seq=32, decode_block=2,
                            prefill_buckets=(8,))
        out = [eng.run([side.request(L, prompts(cfg, [L], seed=L)[0], 2)])
               for L in (5, 9, 11, 13)]
        return eng, out

    (jeng, want), (teng, got) = both("internlm2-1.8b", run)
    assert got == want
    assert teng.buckets == (8, 32)
    assert teng.stats["prefill_compiles"] == 2
    check_stats(jeng, teng)
    e2 = Side("internlm2-1.8b", False).compiled(
        max_batch=1, max_seq=32, prefill_buckets=(8, 64, 128))
    assert e2.buckets == (8, 32)


def test_warmup_counts_each_bucket_once():
    cfg = setup("internlm2-1.8b")[2].cfg
    port = Side("internlm2-1.8b", False)
    eng = port.compiled(max_batch=1, max_seq=32, decode_block=2,
                        prefill_buckets=(8, 16))
    eng.warmup()
    assert eng.stats["prefill_compiles"] == len(eng.buckets) == 3
    got = eng.run([port.request(0, prompts(cfg, [9], seed=2)[0], 2)])
    assert eng.stats["prefill_compiles"] == 3
    assert got[0] == port.generate(prompts(cfg, [9], seed=2)[0], 2)
    assert not eng.graphed          # the CPU runs the K-step block eagerly


def test_unknown_modes_are_refused():
    port = Side("internlm2-1.8b", False)
    with pytest.raises(ValueError, match="unknown sample mode"):
        port.compiled(sample="beam")
    with pytest.raises(ValueError, match="unknown kv_layout"):
        port.compiled(kv_layout="ring")
    with pytest.raises(ValueError, match="admit_timeout_s must be positive"):
        port.compiled(admit_timeout_s=0.0)
    with pytest.raises(ValueError, match="page_size"):
        port.compiled(page_size=0)


def test_publishing_and_mesh_placement_are_refused():
    """Mesh placement is refused (ROADMAP A13c); live publishing is not:
    ``warmup(dual=True)`` takes the engine's own copies of both buffers and
    ``publish`` swaps in the next generation. The generation is read-only
    and pinned on every admitted request."""
    cfg = setup("internlm2-1.8b")[2].cfg
    port = Side("internlm2-1.8b", False)
    with pytest.raises(NotImplementedError, match="A13c"):
        port.compiled(dist=object())
    eng = port.compiled(max_batch=1, max_seq=32, generation=3)
    with pytest.raises(AttributeError):
        eng.generation = 4
    req = port.request(0, prompts(cfg, [6])[0], 2)
    eng.run([req])
    assert req.generation == 3 and eng.generation == 3
    eng.warmup(dual=True)
    assert eng._owned == [True, True] and not eng.graphed
    assert eng.params is not port.params
    assert eng.publish(port.params) is True and eng.generation == 4
    req = port.request(1, prompts(cfg, [6])[0], 2)
    eng.run([req])
    assert req.generation == 4 and req.generated == port.generate(
        prompts(cfg, [6])[0], 2)
    assert eng.stats["publish_swaps"] == 1


def test_audio_family_is_refused_as_by_the_oracle():
    tm = TModel(treg.get_smoke_config("whisper-base"))
    tp = tm.init(torch.Generator().manual_seed(0))
    for cls in (CompiledServingEngine, ServingEngine):
        with pytest.raises(NotImplementedError, match="no encoder frames"):
            cls(tm, tp)
