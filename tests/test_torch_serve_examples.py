"""The twins of ``examples/serve_continuous.py``, ``serve_batched.py`` and
``train_and_serve.py`` (``repro_torch.experiments``) on the CPU: the
reference's report lines, the reference's prompts, the compiled engine's
tokens equal to the per-step oracle's, the train -> publish -> serve
audit passing, and the refusal to run without a card unless the CPU is
asked for."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.data import prng  # noqa: E402
from repro_torch.experiments import (serve_batched, serve_continuous,  # noqa: E402
                                     train_and_serve)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b"])
def test_serve_continuous_prints_the_reference_report(arch, capsys):
    got, eng = serve_continuous.main(["--device", "cpu", "--arch", arch])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(
        rf"{arch} \[compiled\]: 6 requests through 2 slots -> 45 tokens in "
        r"[0-9.]+s", out[0])
    st = eng.stats
    assert out[1] == (f"  {st['decode_calls']} fused decode calls, "
                      f"{st['decode_transfers']} bulk host transfers, "
                      f"6 admissions")
    assert st["decode_calls"] == st["decode_transfers"] > 0
    for rid in range(6):
        assert out[2 + rid] == (f"  req {rid} ({6 + 3 * rid}-token prompt): "
                                f"{got[rid]}")
    want, _ = serve_continuous.main(["--device", "cpu", "--arch", arch,
                                     "--engine", "loop"])
    assert got == want
    assert all(len(got[i]) == 5 + i for i in range(6))


def test_serve_continuous_prompts_are_the_references():
    key = jax.random.PRNGKey(0)
    for i in range(3):
        want = jax.random.randint(jax.random.fold_in(key, i), (6 + 3 * i,),
                                  0, 512, dtype=jnp.int32)
        got = prng.randint(prng.fold_in(prng.PRNGKey(0), i), (6 + 3 * i,),
                           0, 512)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-72b",
                                  "whisper-base"])
def test_serve_batched_prints_the_reference_report(arch, capsys):
    out, stats = serve_batched.main(["--device", "cpu", "--arch", arch,
                                     "--batch", "2", "--prompt-len", "20",
                                     "--new-tokens", "3"])
    lines = capsys.readouterr().out.splitlines()
    family = {"gemma3-1b": "dense", "qwen2-vl-72b": "vlm",
              "whisper-base": "audio"}[arch]
    assert lines[0] == f"{arch} ({family}): batch=2 prompt=20 +3 tokens"
    assert re.fullmatch(r"prefill \d+ms  decode \d+ms  \d+ tok/s", lines[1])
    assert lines[2] == f"sample: {out[0].tolist()}"
    assert out.shape == (2, 3)


def test_train_and_serve_audits_every_request(tmp_path, capsys):
    """Phase 2 publishes at each of its two epoch boundaries into an
    engine that serves between chunks; every request finishes on its
    pinned generation, as the end-of-run audit (reloading each generation
    from the publish directory) checks."""
    out = train_and_serve.main(["--device", "cpu", "--steps1", "8",
                                "--steps2", "32", "--publish-dir",
                                str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    st = out["engine"].stats
    assert lines[0] == "model internlm2-1.8b-smoke: 1.4M params"
    assert re.fullmatch(r"phase1: 8 steps, test acc [0-9.]+", lines[2])
    assert re.fullmatch(r"SWAP averaged: [0-9.]+ \(before: [0-9.]+\)",
                        lines[3])
    assert lines[4] == f"published 2 generations to {tmp_path}"
    assert lines[5] == (f"engine: {st['decode_calls']} decode calls, "
                        f"{st['decode_transfers']} transfers, 2 swaps, "
                        f"{st['dual_decode_calls']} dual-generation calls")
    assert st["decode_calls"] == st["decode_transfers"] > 0
    assert st["dual_decode_calls"] > 0
    served = out["served"]
    assert out["checked"] == len(served) == 4
    assert {r.generation for r in served} == {1, 2}
    assert lines[6] == ("token-exactness audit: 4 requests across "
                        "generations [1, 2] all match their pinned "
                        "snapshots")


@pytest.mark.parametrize("main", [serve_continuous.main, serve_batched.main,
                                  train_and_serve.main])
def test_entry_points_refuse_a_missing_card(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
