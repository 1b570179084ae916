"""The twins of ``examples/serve_continuous.py`` and ``serve_batched.py``
(``repro_torch.experiments``) on the CPU: the reference's report lines,
the reference's prompts, the compiled engine's tokens equal to the
per-step oracle's, and the refusal to run without a card unless the CPU is
asked for."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.data import prng  # noqa: E402
from repro_torch.experiments import serve_batched, serve_continuous  # noqa: E402


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


@pytest.mark.parametrize("main", [serve_continuous.main, serve_batched.main])
def test_entry_points_refuse_a_missing_card(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
