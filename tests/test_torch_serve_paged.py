"""The port's compiled engine on the paged KV layout, and its admission
deadlines, against the JAX package's engine on the CPU.

The scenarios of ``tests/test_serve_compiled.py`` on the paged layout and
the three admission-deadline scenarios of ``tests/test_resilience.py``
(with a fake clock), each run through the JAX ``CompiledServingEngine`` and
the port's on the same params and numpy prompts: tokens and ``stats``
identical, pages back in the pool once a workload drains.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve import ServingEngine  # noqa: E402
from test_torch_serve_compiled import (Side, both, check_stats,  # noqa: E402
                                       prompts, setup)


def test_kv_layout_auto_resolution():
    """auto is paged iff the model has a pageable (full-attention GQA)
    layer; asking for paged on a model without one is an error."""
    attn = Side("internlm2-1.8b", False)
    ssm = Side("mamba2-2.7b", False)
    e = attn.compiled(max_seq=32)
    assert e.kv_layout == "paged" and e.state.block_tables.shape == (4, 2)
    assert set(e.state.cache["units"]["0"]) == {"p"}
    e = ssm.compiled(max_seq=32)
    assert e.kv_layout == "dense" and e.state.block_tables.shape == (4, 0)
    with pytest.raises(ValueError, match="pageable"):
        ssm.compiled(max_seq=32, kv_layout="paged")
    for arch, want in (("internlm2-1.8b", True), ("gemma3-1b", True),
                       ("zamba2-7b", True), ("mamba2-2.7b", False),
                       ("minicpm3-4b", False), ("deepseek-v2-lite", False)):
        jm, _, tm, _ = setup(arch)
        assert tm.has_pageable == jm.has_pageable == want, arch


def _five(side, **kw):
    cfg = side.model.cfg
    eng = side.compiled(max_batch=2, max_seq=64, decode_block=4, **kw)
    got = eng.run([side.request(i, p, 6) for i, p in
                   enumerate(prompts(cfg, [9, 17, 5, 12, 8]))])
    return eng, got


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-1b",
                                  "zamba2-7b"])
def test_paged_matches_dense_and_jax_across_cache_families(arch):
    """Pure GQA, window + global layers (only the globals paged) and the
    hybrid (only the shared block paged): the paged engine's tokens equal
    the dense engine's and the JAX paged engine's."""
    (jeng, want), (teng, got) = both(
        arch, lambda s: _five(s, kv_layout="paged", page_size=16))
    assert got == want
    check_stats(jeng, teng)
    _, dense = _five(Side(arch, False), kv_layout="dense")
    assert got == dense
    pools = {eng: sorted(k for k in eng.state.cache["units"]
                         if "p" in eng.state.cache["units"][k])
             for eng in (jeng, teng)}
    assert pools[teng] == pools[jeng] and len(pools[teng]) == 1
    assert (pools[teng] == ["shared"]) == (arch == "zamba2-7b")
    assert len(teng._free_pages) == teng.n_pages - 1


def test_paged_staggered_eos_and_slot_reuse_match_jax_and_oracle():
    """Late arrivals into reused slots, a mid-block EOS and budgets of
    several sizes, with pages recycled in between."""
    port = Side("internlm2-1.8b", False)
    ps = prompts(port.model.cfg, [9, 6, 11, 7, 5], seed=3)
    eos = port.generate(ps[2], 3)[2]
    budgets = (8, 3, 9, 7, 5)

    def mk(side):
        return [side.request(i, p, n, eos_id=eos if i == 2 else None)
                for i, (p, n) in enumerate(zip(ps, budgets))]

    def run(side):
        eng = side.compiled(max_batch=2, max_seq=64, decode_block=3,
                            kv_layout="paged", page_size=16)
        reqs = mk(side)
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        eng.step()
        for r in reqs[2:]:
            eng.submit(r)
            eng.step()
        steps = 0
        while (eng.active or eng.waiting) and steps < 100:
            eng.step()
            steps += 1
        return eng, [r.generated for r in reqs]

    (jeng, want), (teng, got) = both("internlm2-1.8b", run)
    assert got == want
    check_stats(jeng, teng)
    oracle = port.oracle(max_batch=2, max_seq=64).run(mk(port))
    assert got == [oracle[i] for i in range(5)]
    assert len(teng._free_pages) == teng.n_pages - 1
    assert not any(teng.slot_pages) and not teng._host_bt.any()


def test_paged_int8_token_exact_trio():
    """kv_cache_dtype="int8" on the pool: paged int8, dense int8 and the
    int8 per-step oracle give the same tokens, the JAX paged int8
    engine's; the int8 pool holds fewer bytes than the f32 dense cache."""
    cfg = setup("internlm2-1.8b")[2].cfg

    def run(side, **kw):
        eng = side.compiled(max_batch=2, max_seq=64, decode_block=4,
                            kv_cache_dtype="int8", **kw)
        got = eng.run([side.request(i, p, 6) for i, p in
                       enumerate(prompts(cfg, [9, 14, 6], seed=21))])
        return eng, got

    (jeng, want), (teng, paged) = both(
        "internlm2-1.8b", lambda s: run(s, kv_layout="paged"))
    assert paged == want
    check_stats(jeng, teng)
    port = Side("internlm2-1.8b", False)
    _, dense = run(port, kv_layout="dense")
    int8 = TModel(dataclasses.replace(port.model.cfg, kv_cache_dtype="int8"))
    want_oracle = ServingEngine(int8, port.params, max_batch=2,
                                max_seq=64).run(
        [port.request(i, p, 6) for i, p in
         enumerate(prompts(cfg, [9, 14, 6], seed=21))])
    assert paged == dense == want_oracle
    pool = teng.state.cache["units"]["0"]["p"]
    assert pool["k"].dtype == torch.int8
    assert pool["k_scale"].dtype == torch.float32
    f32 = port.compiled(max_batch=2, max_seq=64, kv_layout="dense")
    assert teng.cache_bytes() < f32.cache_bytes()
    assert teng.cache_bytes() == jeng.cache_bytes()


def test_paged_small_pool_defers_admission_not_correctness():
    """A 3-page pool forces head-of-line page waits; the tokens stay
    exact and mid-decode growth never exhausts the pool."""
    (jeng, want), (teng, got) = both(
        "internlm2-1.8b",
        lambda s: _five(s, kv_layout="paged", page_size=16, n_pages=3))
    assert got == want
    check_stats(jeng, teng)
    assert teng.stats["admit_page_waits"] > 0
    _, dense = _five(Side("internlm2-1.8b", False), kv_layout="dense")
    assert got == dense
    assert len(teng._free_pages) == teng.n_pages - 1


def test_paged_rejects_unfittable_request():
    port = Side("internlm2-1.8b", False)
    eng = port.compiled(max_batch=2, max_seq=64, kv_layout="paged",
                        page_size=16, n_pages=3)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(port.request(0, prompts(port.model.cfg, [17])[0], 40))
    with pytest.raises(ValueError, match="n_pages >= 2"):
        port.compiled(kv_layout="paged", n_pages=1)


# ---------------------------------------------------------------------------
# admission deadlines
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _req(side, rid, n_new=8, deadline_s=None):
    prompt = prompts(side.model.cfg, [8], seed=100 + rid)[0]
    return side.request(rid, prompt, n_new, deadline_s=deadline_s)


def test_request_past_admission_deadline_is_rejected():
    """A request that cannot be admitted before its deadline is rejected
    (done, rejected, counted) and the run loop ends."""
    def run(side):
        clock = FakeClock()
        eng = side.compiled(max_batch=1, max_seq=64, decode_block=4,
                            clock=clock)
        r1, r2 = _req(side, 0, n_new=12), _req(side, 1, deadline_s=1.0)
        eng.submit(r1)
        eng.submit(r2)
        assert eng.waiting == [r2]
        clock.advance(2.0)
        steps = 0
        while (eng.active or eng.waiting) and steps < 50:
            eng.step()
            steps += 1
        assert steps < 50, "engine hung on an unadmittable request"
        return eng, (r1, r2)

    (jeng, (j1, j2)), (teng, (r1, r2)) = both("internlm2-1.8b", run)
    assert r2.rejected and r2.done and r2.generated == []
    assert teng.stats["rejections"] == 1
    assert len(r1.generated) == 12 and r1.generated == j1.generated
    assert r2.submit_t == 0.0
    check_stats(jeng, teng)


def test_engine_wide_admit_timeout():
    def run(side):
        clock = FakeClock()
        eng = side.compiled(max_batch=1, max_seq=64, decode_block=4,
                            admit_timeout_s=3.0, clock=clock)
        r1, r2 = _req(side, 0, n_new=12), _req(side, 1)
        eng.submit(r1)
        eng.submit(r2)
        clock.advance(10.0)
        eng.step()
        return eng, r2

    (jeng, j2), (teng, r2) = both("internlm2-1.8b", run)
    assert r2.rejected and teng.stats["rejections"] == 1
    assert j2.rejected
    check_stats(jeng, teng)


def test_waits_within_deadline_then_admits():
    """A deadline that has not passed keeps the request waiting for a slot;
    it then completes normally."""
    def run(side):
        clock = FakeClock()
        eng = side.compiled(max_batch=1, max_seq=64, decode_block=4,
                            clock=clock)
        r1, r2 = _req(side, 0, n_new=4), _req(side, 1, n_new=4,
                                               deadline_s=100.0)
        eng.submit(r1)
        eng.submit(r2)
        steps = 0
        while (eng.active or eng.waiting) and steps < 50:
            eng.step()
            steps += 1
        return eng, (r1, r2)

    (jeng, (j1, j2)), (teng, (r1, r2)) = both("internlm2-1.8b", run)
    assert not r2.rejected and len(r2.generated) == 4
    assert r2.generated == j2.generated and r1.generated == j1.generated
    assert teng.stats["rejections"] == 0
    check_stats(jeng, teng)


def test_oracle_ignores_the_deadline_fields():
    """ServingEngine takes the new Request fields and ignores them, as the
    reference's does."""
    port = Side("internlm2-1.8b", False)
    eng = port.oracle(max_batch=1, max_seq=64)
    r = _req(port, 0, n_new=3, deadline_s=1e-9)
    eng.run([r])
    assert not r.rejected and r.submit_t is None and r.generation is None
    assert len(r.generated) == 3
    assert np.asarray(r.generated).dtype.kind == "i"
