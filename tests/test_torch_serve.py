"""Port's serving path against the JAX package's, token for token, on the CPU.

JAX params are carried over with ``params_from_numpy``; prompts are numpy
arrays from a seed given to both packages. Greedy tokens must be identical.
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
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve.engine import Request as TRequest  # noqa: E402
from repro_torch.serve.engine import ServingEngine as TEngine  # noqa: E402


def _setup(arch):
    jm = JModel(jreg.get_smoke_config(arch))
    tm = TModel(treg.get_smoke_config(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_numpy(jax.device_get(jp))


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lengths]


def _serve_both(arch, prompts, *, max_batch, max_seq, n_new, eos=None):
    jm, jp, tm, tp = _setup(arch)
    jeng = JEngine(jm, jp, max_batch=max_batch, max_seq=max_seq)
    teng = TEngine(tm, tp, max_batch=max_batch, max_seq=max_seq)
    jreqs = [JRequest(rid=i, prompt=jnp.asarray(p), max_new_tokens=n_new,
                      eos_id=eos) for i, p in enumerate(prompts)]
    treqs = [TRequest(rid=i, prompt=torch.from_numpy(p), max_new_tokens=n_new,
                      eos_id=eos) for i, p in enumerate(prompts)]
    return jeng.run(jreqs), teng.run(treqs), teng


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-1b",
                                  "mamba2-2.7b"])
@pytest.mark.parametrize("engine", ["loop", "compiled"])
def test_generate_matches_jax(arch, engine):
    jm, jp, tm, tp = _setup(arch)
    prompts = np.stack(_prompts(jm.cfg, [24, 24], seed=0))
    want, _ = jgenerate(jm, jp, jnp.asarray(prompts), 5, engine=engine)
    got, stats = tserve.generate(tm, tp, torch.from_numpy(prompts), 5,
                                 engine=engine)
    assert got.shape == (2, 5) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["device"] == "cpu" and stats["prefill_tokens_per_s"] > 0


def test_engine_five_requests_two_slots_match_jax():
    """5 prompts of different lengths through 2 slots: slot reuse,
    per-slot positions and cache re-initialization."""
    cfg = treg.get_smoke_config("internlm2-1.8b")
    prompts = _prompts(cfg, [9, 17, 5, 12, 8], seed=1)
    want, got, eng = _serve_both("internlm2-1.8b", prompts, max_batch=2,
                                 max_seq=64, n_new=6)
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    assert eng.active == 0 and not eng.waiting


def test_engine_window_layers_match_jax():
    """gemma3's circular window caches under continuous batching."""
    cfg = treg.get_smoke_config("gemma3-1b")
    prompts = _prompts(cfg, [40, 7, 33], seed=2)
    want, got, _ = _serve_both("gemma3-1b", prompts, max_batch=2,
                               max_seq=64, n_new=5)
    assert got == want


def test_engine_slots_are_reused_match_jax():
    cfg = treg.get_smoke_config("internlm2-1.8b")
    prompts = _prompts(cfg, [6, 6, 6], seed=3)
    want, got, eng = _serve_both("internlm2-1.8b", prompts, max_batch=1,
                                 max_seq=32, n_new=3)
    assert got == want and all(len(v) == 3 for v in got.values())
    assert eng.active == 0 and not eng.waiting


def test_engine_eos_stops_early_match_jax():
    jm, jp, tm, tp = _setup("internlm2-1.8b")
    prompt = _prompts(jm.cfg, [8], seed=4)[0]
    ref, _ = tserve.generate(tm, tp, torch.from_numpy(prompt)[None], 4)
    eos = int(ref[0, 1])
    want, got, _ = _serve_both("internlm2-1.8b", [prompt], max_batch=2,
                               max_seq=32, n_new=10, eos=eos)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) <= 3


def test_idle_slot_positions_freeze_match_jax():
    """An idle slot's position stays put while another decodes toward
    max_seq - 1; a late request then runs right up to the truncation
    boundary, token-exact against JAX's engine."""
    jm, jp, tm, tp = _setup("internlm2-1.8b")
    max_seq = 16
    p_long, p_late = _prompts(jm.cfg, [6, 6], seed=5)
    teng = TEngine(tm, tp, max_batch=2, max_seq=max_seq)
    long_req = TRequest(rid=0, prompt=torch.from_numpy(p_long),
                        max_new_tokens=max_seq)
    teng.submit(long_req)
    while not long_req.done:
        teng.step()
        assert int(teng.positions[1]) == 0
    late = TRequest(rid=1, prompt=torch.from_numpy(p_late),
                    max_new_tokens=max_seq)
    teng.run([late])

    jeng = JEngine(jm, jp, max_batch=2, max_seq=max_seq)
    jlong = JRequest(rid=0, prompt=jnp.asarray(p_long), max_new_tokens=max_seq)
    jeng.submit(jlong)
    while not jlong.done:
        jeng.step()
    jlate = JRequest(rid=1, prompt=jnp.asarray(p_late), max_new_tokens=max_seq)
    jeng.run([jlate])
    assert long_req.generated == jlong.generated
    assert late.generated == jlate.generated
    assert len(late.generated) == max_seq - 6


def test_engine_matches_single_request_generate():
    """The port's engine against the port's own generate, per request."""
    _, _, tm, tp = _setup("internlm2-1.8b")
    prompts = _prompts(tm.cfg, [9, 17, 5], seed=6)
    eng = TEngine(tm, tp, max_batch=2, max_seq=48)
    got = eng.run([TRequest(rid=i, prompt=torch.from_numpy(p),
                            max_new_tokens=4) for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        ref, _ = tserve.generate(tm, tp, torch.from_numpy(p)[None], 4)
        assert got[i] == ref[0].tolist()


def test_main_runs_on_cpu_when_asked(capsys):
    out, stats = tserve.main(["--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--new-tokens", "3",
                              "--engine", "loop"])
    assert out.shape == (2, 3)
    assert "prompt tok/s" in capsys.readouterr().out


def test_main_kv_int8_on_cpu():
    out, _ = tserve.main(["--device", "cpu", "--batch", "1", "--prompt-len",
                          "8", "--new-tokens", "2", "--kv-int8"])
    assert out.shape == (1, 2)


def test_entry_point_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build_model("internlm2-1.8b", full=False)
