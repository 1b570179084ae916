"""Port's flash-attention op against the JAX package's, on the CPU.

The same numpy inputs go through JAX (the Pallas kernel in interpret mode,
the blockwise reference and the oracle) and through the port's plain
versions. Tolerances are the JAX kernel tests' own: out f32 2e-5, bf16 3e-2,
lse 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas_fwd,
)
from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LSE_TOL = 1e-4

# (B, Sq, Skv, H, KVH, D): the JAX kernel tests' grid, then D = 64 and 128
SHAPES = [
    (1, 16, 16, 4, 4, 16),      # MHA tiny
    (2, 67, 67, 8, 2, 32),      # GQA, ragged seq
    (2, 128, 128, 4, 1, 64),    # kv=1 (gemma-style)
    (1, 33, 129, 4, 2, 24),     # cross-length, odd dims
    (1, 70, 70, 8, 2, 128),     # full-width head dim
]
MASKS = [(True, 0), (True, 16), (False, 0)]


def _inputs(shape, dtype="float32", seed=0):
    """Same values for both packages: numpy f32, rounded to bf16 (to
    nearest even) by each package when dtype is bfloat16."""
    B, Sq, Skv, H, KVH, D = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D))]
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(want, np.float32),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_fwd_matches_pallas_kernel_f32(shape, causal, window):
    """out and lse of the port's CPU forward against the Pallas kernel."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape)
    jo, jl = flash_attention_pallas_fwd(jq, jk, jv, causal=causal,
                                        window=window, interpret=True)
    to, tl = tops.flash_attention_fwd(tq, tk, tv, causal=causal,
                                      window=window)
    assert to.dtype == torch.float32 and tl.dtype == torch.float32
    _close(to, jo, TOL["float32"])
    _close(tl, jl, LSE_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_blockwise_and_oracle_match_jax(shape, dtype, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, seed=1)
    kw = dict(causal=causal, window=window, scale=None, q_offset=0)
    jb = jops._blockwise_reference(jq, jk, jv, chunk=32, **kw)
    tb = tops._blockwise_reference(tq, tk, tv, chunk=32, **kw)
    assert tb.dtype == getattr(torch, dtype)
    _close(tb, jb, TOL[dtype])
    _close(tref.attention_ref(tq, tk, tv, **kw),
           jref.attention_ref(jq, jk, jv, **kw), TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 40, 40, 4, 2, 32),
                                   (1, 64, 64, 4, 1, 64),
                                   (1, 33, 129, 4, 2, 128)])
def test_bf16_fwd_matches_pallas_kernel(shape):
    """bf16: the port's plain out at 3e-2; its lse on f32-upcast inputs
    (the kernel's own arithmetic) at 1e-4."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "bfloat16", seed=2)
    jo, jl = flash_attention_pallas_fwd(jq, jk, jv, causal=True,
                                        interpret=True)
    to, _ = tops.flash_attention_fwd(tq, tk, tv, causal=True)
    assert to.dtype == torch.bfloat16
    _close(to, jo, TOL["bfloat16"])
    _, tl = tops.flash_attention_fwd(tq.float(), tk.float(), tv.float(),
                                     causal=True)
    _close(tl, jl, LSE_TOL)


@pytest.mark.parametrize("shape,q_offset", [
    ((2, 1, 64, 8, 4, 32), 63),          # decode row
    ((1, 33, 129, 4, 2, 64), 96),        # chunked prefill offset
])
def test_q_offset_matches_pallas_kernel(shape, q_offset):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, seed=3)
    jo, jl = flash_attention_pallas_fwd(jq, jk, jv, causal=True,
                                        q_offset=q_offset, interpret=True)
    to, tl = tops.flash_attention_fwd(tq, tk, tv, causal=True,
                                      q_offset=q_offset)
    _close(to, jo, TOL["float32"])
    _close(tl, jl, LSE_TOL)
    _close(tops.flash_attention(tq, tk, tv, q_offset=q_offset, impl="naive"),
           jo, TOL["float32"])


def test_fully_masked_rows_give_zero_out_and_lse():
    """Rows whose position is before every key (q_offset < 0, causal) see
    nothing: out = 0 and lse = 0 in both packages (the NEG_INF contract)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 48, 48, 4, 2, 64), seed=4)
    jo, jl = flash_attention_pallas_fwd(jq, jk, jv, causal=True,
                                        q_offset=-8, interpret=True)
    to, tl = tops.flash_attention_fwd(tq, tk, tv, causal=True, q_offset=-8)
    assert bool((to[:, :8] == 0).all()) and bool((tl[:, :8] == 0).all())
    assert np.all(np.asarray(jo)[:, :8] == 0) and np.all(np.asarray(jl)[:, :8] == 0)
    _close(to, jo, TOL["float32"])
    _close(tl, jl, LSE_TOL)


def test_auto_on_cpu_resolves_to_reference():
    assert dispatch.resolve("auto", "cpu") == "reference"
    assert dispatch.resolve("auto", "cuda") == "kernel"
    assert dispatch.resolve("naive", "cpu") == "naive"
    (_, _, _), (tq, tk, tv) = _inputs((1, 20, 20, 4, 2, 64), seed=5)
    got = tops.flash_attention(tq, tk, tv, chunk=8)
    want = tops._blockwise_reference(tq, tk, tv, causal=True, window=0,
                                     scale=None, q_offset=0, chunk=8)
    assert torch.equal(got, want)


def test_kernel_impl_on_cpu_tensor_raises():
    (_, _, _), (tq, tk, tv) = _inputs((1, 8, 8, 2, 1, 64), seed=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.flash_attention(tq, tk, tv, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkernel.flash_fwd(tq, tk, tv)
    with pytest.raises(ValueError, match="unknown kernel impl"):
        tops.flash_attention(tq, tk, tv, impl="pallas")


def test_requires_grad_on_kernel_path_raises():
    (_, _, _), (tq, tk, tv) = _inputs((1, 8, 8, 2, 1, 64), seed=7)
    with pytest.raises(RuntimeError, match="forward only"):
        tkernel.flash_fwd(tq.requires_grad_(), tk, tv)
    with torch.inference_mode():     # the serving path: no grad, no raise
        with pytest.raises(RuntimeError, match="CUDA"):
            tkernel.flash_fwd(tq, tk, tv)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: without nvcc the build names it and raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library("flash_fwd", [tkernel.SOURCE])
    tkernel._library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        tkernel.build()
