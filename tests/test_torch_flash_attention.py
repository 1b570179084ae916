"""Port's flash-attention op against the JAX package's, on the CPU.

The same numpy inputs go through JAX (the Pallas kernels in interpret mode,
the blockwise reference and the oracle) and through the port's plain
versions. Tolerances are the JAX kernel tests' own: out f32 2e-5, bf16 3e-2,
lse 1e-4; the backward 2e-4 against the Pallas backward kernels and 5e-4
for autograd against ``jax.grad``. The autograd Function that runs the
CUDA kernels is tested here with its two launch functions replaced by the
plain versions (the kernels themselves run only on the card).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas_bwd, flash_attention_pallas_fwd,
)
from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LSE_TOL = 1e-4
BWD_TOL = 2e-4      # tests/test_kernels_flash_attention.py:97
GRAD_TOL = 5e-4     # tests/test_kernels_flash_attention.py:73

# (B, Sq, Skv, H, KVH, D): the JAX kernel tests' grid, then D = 64, 128,
# 112 (zamba2-7b's shared block, one KV head a query head; the Pallas
# kernel pads it to 128), 96 (minicpm3-4b's MLA: qk 64 + 32, one KV head a
# query head; padded to 128 likewise), 192 (deepseek-v2-lite's MLA: qk 128 + 64, one KV
# head a query head) and 256 (gemma3's, one KV head for four query heads)
SHAPES = [
    (1, 16, 16, 4, 4, 16),      # MHA tiny
    (2, 67, 67, 8, 2, 32),      # GQA, ragged seq
    (2, 128, 128, 4, 1, 64),    # kv=1 (gemma-style)
    (1, 33, 129, 4, 2, 24),     # cross-length, odd dims
    (1, 70, 70, 8, 2, 128),     # full-width head dim
    (1, 70, 70, 4, 4, 112),     # zamba2-7b's head dim
    (1, 70, 70, 4, 4, 96),      # minicpm3-4b's MLA head dim
    (1, 70, 70, 4, 4, 192),     # deepseek-v2-lite's MLA head dim
    (1, 70, 70, 4, 1, 256),     # gemma3's head dim
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
                                   (1, 33, 129, 4, 2, 128),
                                   (1, 70, 70, 4, 4, 112),
                                   (1, 70, 70, 4, 4, 96),
                                   (1, 70, 70, 4, 4, 192),
                                   (1, 70, 70, 4, 1, 256)])
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
    ((1, 33, 129, 4, 1, 256), 96),       # the same at gemma3's head dim
    ((1, 33, 129, 4, 4, 192), 96),       # and at deepseek's MLA head dim
    ((1, 33, 129, 4, 2, 112), 96),       # and at zamba2's, G 2
    ((1, 33, 129, 4, 4, 96), 96),        # and at minicpm3's MLA, G 1
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
    """Called directly, outside its autograd Function, the kernel would
    drop the graph: it raises and names the differentiable entry."""
    (_, _, _), (tq, tk, tv) = _inputs((1, 8, 8, 2, 1, 64), seed=7)
    with pytest.raises(RuntimeError, match="ops.flash_attention"):
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_takes_both_dtypes_up_to_the_device_check(dtype):
    """f32 (the FMA route) and bf16 (the wgmma route) pass every check that
    needs no card, at every head dim of the forward, and stop only at the
    device."""
    assert tkernel.FWD_HEAD_DIMS == (64, 96, 112, 128, 192, 256)
    for D in tkernel.FWD_HEAD_DIMS:
        (_, _, _), (tq, tk, tv) = _inputs((1, 8, 8, 4, 2, D), dtype, seed=9)
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            tkernel.flash_fwd(tq, tk, tv)


def _misaligned(t):
    """t's values in a contiguous tensor that starts one element past the
    allocation, so off a 16-byte boundary."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    view.copy_(t)
    return view


def _head_dim(t, D):
    """t's last dim cut or tiled to D, contiguous."""
    return t.repeat(1, 1, 1, -(-D // t.shape[-1]))[..., :D].contiguous()


# D 96, 112, 192 and 256 are head dims the forward takes (minicpm3-4b's
# MLA, zamba2-7b's, deepseek-v2-lite's MLA, gemma3's): they pass every
# check and stop only at the device; D 80 is one no family needs, which it
# refuses
REFUSED = {
    "head_dim_112": (lambda q, k, v: tuple(_head_dim(t, 112)
                                           for t in (q, k, v)),
                     RuntimeError, "needs CUDA tensors"),
    "head_dim_192": (lambda q, k, v: tuple(_head_dim(t, 192)
                                           for t in (q, k, v)),
                     RuntimeError, "needs CUDA tensors"),
    "head_dim_256": (lambda q, k, v: tuple(_head_dim(t, 256)
                                           for t in (q, k, v)),
                     RuntimeError, "needs CUDA tensors"),
    "head_dim_96": (lambda q, k, v: tuple(_head_dim(t, 96)
                                          for t in (q, k, v)),
                    RuntimeError, "needs CUDA tensors"),
    "head_dim_80": (lambda q, k, v: tuple(_head_dim(t, 80)
                                          for t in (q, k, v)),
                    ValueError, "head dim 80"),
    "float16": (lambda q, k, v: (q.half(), k.half(), v.half()),
                TypeError, "float32 or bfloat16"),
    "non_contiguous": (lambda q, k, v: (q.transpose(1, 2).contiguous()
                                        .transpose(1, 2), k, v),
                       ValueError, "contiguous"),
    "misaligned": (lambda q, k, v: (_misaligned(q), k, v),
                   ValueError, "16-byte boundary"),
    "cpu": (lambda q, k, v: (q, k, v), RuntimeError, "needs CUDA tensors"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_refuses_what_the_kernels_cannot_take(case, dtype):
    make, exc, msg = REFUSED[case]
    (_, _, _), (tq, tk, tv) = _inputs((1, 8, 8, 4, 2, 128), dtype, seed=10)
    q, k, v = make(tq, tk, tv)
    with pytest.raises(exc, match=msg):
        tkernel.flash_fwd(q, k, v)


def _fake_builds(monkeypatch):
    """build_library replaced by a recorder of what it is given."""
    seen = {}

    def fake_build(name, sources, headers=()):
        seen[name] = ([s.name for s in sources], [h.name for h in headers])
        raise RuntimeError("no nvcc here")

    monkeypatch.setattr(_build, "build_library", fake_build)
    return seen


def test_forward_library_is_built_from_both_sources(monkeypatch):
    """One library holds both routes; build_library hashes the sources and
    headers it is given, so all must be listed or an edited kernel reuses a
    stale build."""
    seen = _fake_builds(monkeypatch)
    tkernel._library.cache_clear()
    with pytest.raises(RuntimeError, match="no nvcc here"):
        tkernel.build()
    assert seen == {"flash_fwd": (["flash_fwd.cu", "flash_fwd_sm90.cu"],
                                  ["sm90.cuh"])}
    assert all((tkernel.SOURCE.parent / n).is_file()
               for n in sum(seen["flash_fwd"], []))


# The card grid's edge cases (chip_smoke._grid: ragged, window, q_offset,
# empty rows, skipped tiles), at the bf16 kernel's KV tile of 64 keys.
CARD_EDGE_CASES = [
    ((2, 67, 67, 4, 4, 64), True, 16, 0),      # ragged, window, G 1
    ((2, 67, 67, 4, 1, 128), True, 0, 0),      # ragged, G 4
    ((2, 1, 64, 8, 4, 64), True, 0, 63),       # decode row
    ((1, 33, 129, 4, 2, 128), True, 0, 96),    # chunked-prefill offset
    ((1, 33, 129, 4, 2, 64), False, 0, 0),     # ragged Skv
    ((1, 40, 40, 4, 1, 128), True, 16, 0),     # window
    ((1, 48, 48, 4, 2, 64), True, 0, -8),      # rows that see no key
    ((1, 200, 200, 8, 2, 64), True, 48, 0),    # tiles outside the window
    ((1, 150, 150, 4, 1, 256), True, 48, 0),   # D 256, binding window
    ((1, 33, 129, 4, 1, 256), True, 32, 96),   # D 256, window, q_offset
    ((1, 150, 150, 4, 4, 192), True, 0, 0),    # D 192 (MLA), G 1, ragged
    ((1, 33, 129, 4, 2, 192), False, 0, 0),    # D 192, G 2, ragged Skv
    ((1, 150, 150, 4, 4, 112), True, 0, 0),    # D 112, G 1, ragged
    ((1, 33, 129, 4, 2, 112), True, 16, 96),   # D 112, G 2, window, q_offset
    ((1, 70, 70, 4, 4, 96), True, 0, 0),       # D 96 (MLA), G 1, ragged
    ((1, 33, 129, 4, 2, 96), True, 16, 96),    # D 96, G 2, window, q_offset
    ((1, 64, 150, 4, 4, 64), False, 0, 0),     # cross attention, Sq != Skv
]
# The bf16 forward's odd-G route (G 1, and granite-moe's G 3): a CTA takes
# two 64-row tiles of one head, 128 rows, sharing each K/V tile; Sq <= 64
# keeps one warpgroup. Odd tile counts leave a lone last tile; a window
# splits the two tiles' KV ranges at both ends; a chunk after a cached
# prefix; rows that see no key. chip_smoke._grid holds the kernel to the
# plain version on the same schedule at every one of these head dims.
ODD_G_CASES = [
    ((1, 65, 65, 2, 2, 64), True, 0, 0),       # two tiles, the upper 1 row
    ((1, 129, 129, 6, 2, 96), True, 0, 0),     # three tiles, G 3
    ((1, 191, 191, 2, 2, 112), False, 0, 0),   # three tiles, non-causal
    ((1, 129, 129, 2, 2, 192), False, 0, 0),   # D 192, three tiles
    ((1, 191, 191, 6, 2, 192), True, 0, 0),    # D 192, G 3, causal
    ((1, 65, 65, 6, 2, 112), False, 0, 0),     # G 3, non-causal
    ((1, 200, 200, 2, 2, 96), True, 48, 0),    # window: both ends split
    ((1, 200, 200, 6, 2, 64), True, 100, 0),   # window 100, G 3
    ((1, 200, 200, 2, 2, 192), True, 100, 0),  # window 100, D 192
    ((1, 97, 129, 2, 2, 192), True, 0, 96),    # chunk after a cached prefix
    ((1, 97, 129, 6, 2, 64), True, 0, 96),     # the same at G 3
    ((1, 33, 129, 6, 2, 112), True, 0, 96),    # Sq <= 64: one warpgroup
    ((1, 64, 64, 2, 2, 96), True, 0, 0),       # Sq 64: one warpgroup
    ((1, 130, 130, 6, 2, 64), True, 0, -8),    # rows that see no key, G 3
    ((1, 130, 130, 2, 2, 112), True, 0, -8),   # the same at G 1
]
CARD_EDGE_CASES += ODD_G_CASES
# The routes of the bf16 forward redesigned since: D 64's pipelined loop
# over many KV tiles, non-causal (whisper's encoder and cross attention),
# Skv 1500 and 700 not multiples of 64 or 128; D 256 at G 4 (gemma3's
# global and local layers), causal, Sq 200 with and without a window of
# 100. chip_smoke._grid holds the kernel to the plain version on them.
# Appended to the forward's cases only, after every earlier one.
FWD_ROUTE_CASES = [
    ((1, 65, 1500, 2, 2, 64), False, 0, 0),
    ((2, 130, 700, 2, 2, 64), False, 0, 0),
    ((1, 200, 200, 4, 1, 256), True, 0, 0),
    ((1, 200, 200, 4, 1, 256), True, 100, 0),
]


@pytest.mark.parametrize("shape,causal,window,q_offset",
                         CARD_EDGE_CASES + FWD_ROUTE_CASES)
def test_plain_at_kv_tile_64_matches_pallas_kernel(shape, causal, window,
                                                   q_offset):
    """The rounding contract of the bf16 kernel (q * scale in bf16, 64-key
    tiles, p rounded to bf16 before P.V, l on the unrounded p), as the
    plain version computes it: out within the JAX tests' bf16 3e-2 of the
    Pallas kernel; out at 2e-5 and lse at 1e-4 on the f32-upcast inputs
    (the Pallas kernel scales q in f32, so its bf16 lse differs by the
    rounding of q * scale where the scale is not a power of 2)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "bfloat16", seed=30)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jo, _ = flash_attention_pallas_fwd(jq, jk, jv, interpret=True, **kw)
    to, tl = tops._blockwise_fwd(tq, tk, tv, scale=None, chunk=64, **kw)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    _close(to, jo, TOL["bfloat16"])
    up = [jnp.asarray(a, jnp.float32) for a in (jq, jk, jv)]
    jo32, jl32 = flash_attention_pallas_fwd(*up, interpret=True, **kw)
    to32, tl32 = tops._blockwise_fwd(tq.float(), tk.float(), tv.float(),
                                     scale=None, chunk=64, **kw)
    _close(to32, jo32, TOL["float32"])
    _close(tl32, jl32, LSE_TOL)
    if q_offset < 0:   # out = 0 and lse = 0 where a row sees no key
        assert bool((to[:, :-q_offset] == 0).all())
        assert bool((tl[:, :-q_offset] == 0).all())


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

BWD_CASES = [
    ((2, 67, 67, 8, 2, 32), True, 0, 0),       # GQA, ragged, multi-block
    ((1, 40, 40, 4, 1, 16), True, 16, 0),      # kv=1, sliding window
    ((2, 33, 64, 4, 4, 24), False, 0, 0),      # cross-length, non-causal
    ((1, 64, 64, 8, 2, 64), True, 0, 0),       # D 64
    ((1, 33, 129, 4, 2, 128), True, 0, 96),    # D 128, q_offset
    ((1, 48, 48, 4, 2, 64), True, 0, -8),      # rows that see no key
    ((1, 100, 100, 4, 1, 256), True, 32, 0),   # D 256, binding window
    ((1, 33, 129, 4, 1, 256), True, 0, 96),    # D 256, q_offset
    ((1, 70, 70, 4, 4, 192), True, 0, 0),      # D 192 (MLA), G 1, ragged
    ((1, 33, 129, 4, 4, 192), True, 0, 96),    # D 192, G 1, q_offset
    ((1, 70, 70, 4, 4, 112), True, 0, 0),      # D 112 (zamba2), G 1, ragged
    ((1, 33, 129, 4, 2, 112), True, 16, 96),   # D 112, G 2, window, q_offset
    ((1, 70, 70, 4, 4, 96), True, 0, 0),       # D 96 (minicpm3), G 1, ragged
    ((1, 33, 129, 4, 4, 96), True, 0, 96),     # D 96, G 1, q_offset
    ((2, 33, 150, 4, 4, 64), False, 0, 0),     # whisper's cross, D 64
    # whisper's encoder, D 64: non-causal self attention, three ragged
    # tiles each way
    ((2, 150, 150, 4, 4, 64), False, 0, 0),
] + [
    # the dQ/dK/dV kernel's route (D 256, one key and one query tile):
    # gemma3's S 64 at G 4, ragged at G 2 with a window, rows that see no
    # key, Sq < Skv non-causal
    ((2, 64, 64, 4, 1, 256), True, 0, 0),
    ((1, 37, 37, 4, 2, 256), True, 16, 0),
    ((1, 48, 48, 4, 1, 256), True, 0, -8),
    ((2, 33, 64, 4, 1, 256), False, 0, 0),
]
# the dQ/dK/dV kernel's route at D 192 (G 1, one key and one query tile):
# deepseek-v2-lite's S 64, causal, at its scale 192 ** -0.5 (not a power of
# 2 in bf16); ragged Sq < Skv with a window and a chunk after a cached
# prefix. Appended after every earlier case of the lists that take them.
DQKV192_CASES = [
    ((2, 64, 64, 4, 4, 192), True, 0, 0),
    ((1, 33, 64, 2, 2, 192), True, 16, 31),
]


def _grad_out(shape, dtype="float32", seed=20):
    B, Sq, _, H, _, D = shape
    a = np.random.default_rng(seed).standard_normal(
        (B, Sq, H, D)).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("shape,causal,window,q_offset",
                         BWD_CASES + DQKV192_CASES)
def test_bwd_ref_matches_pallas_bwd_kernels(shape, causal, window, q_offset):
    """The plain backward (the CUDA kernels' yardstick on the card) against
    the Pallas dQ and dK/dV kernels in interpret mode, on the same q, k, v,
    out, lse and dO."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, seed=11)
    jdo, tdo = _grad_out(shape)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jo, jl = flash_attention_pallas_fwd(jq, jk, jv, interpret=True, **kw)
    want = flash_attention_pallas_bwd(jq, jk, jv, jo, jl, jdo,
                                      interpret=True, **kw)
    to, tl = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl))
    got = tref.flash_attention_bwd_ref(tq, tk, tv, to, tl, tdo, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w, BWD_TOL)
    if q_offset < 0:
        assert bool((got[0][:, :-q_offset] == 0).all())


@pytest.mark.parametrize("shape,causal,window,q_offset", BWD_CASES[:5])
def test_autograd_through_reference_matches_jax_grad(shape, causal, window,
                                                     q_offset):
    """Training on the CPU differentiates the blockwise reference with
    autograd; JAX differentiates its blockwise reference with jax.grad."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, seed=12)
    jdo, tdo = _grad_out(shape, seed=21)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=16)

    def jloss(q, k, v):
        return (jops.flash_attention(q, k, v, impl="reference", **kw)
                * jdo).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.requires_grad_() for t in (tq, tk, tv)]
    out = tops.flash_attention(*ts, impl="reference", **kw)
    got = torch.autograd.grad((out * tdo).sum(), ts)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


@pytest.fixture
def plain_launches(monkeypatch):
    """The autograd Function's two launch functions, replaced by the plain
    versions, with their calls counted."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, **kw):
        calls["fwd"] += 1
        return tops._blockwise_fwd(q, k, v, chunk=512, **kw)

    def bwd(q, k, v, out, lse, do, **kw):
        calls["bwd"] += 1
        return tref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)

    monkeypatch.setattr(tkernel, "flash_fwd", fwd)
    monkeypatch.setattr(tkernel, "flash_bwd", bwd)
    return calls


@pytest.mark.parametrize("shape,causal,window,q_offset", BWD_CASES[3:])
def test_function_grads_match_jax_grad(plain_launches, shape, causal, window,
                                       q_offset):
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, seed=13)
    jdo, tdo = _grad_out(shape, seed=22)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def jloss(q, k, v):     # the blockwise reference: rows that see no
        return (jops.flash_attention(q, k, v, impl="reference", **kw)
                * jdo).sum()  # key get zero grads (naive gives NaN)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.requires_grad_() for t in (tq, tk, tv)]
    out, lse = tops.FlashAttention.apply(*ts, causal, window, None, q_offset)
    assert not lse.requires_grad
    got = torch.autograd.grad((out * tdo).sum(), ts)
    assert plain_launches == {"fwd": 1, "bwd": 1}
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("W", [1, 3])
def test_ensemble_runs_the_function_worker_by_worker(plain_launches,
                                                     monkeypatch, W):
    """The phase-2 ensemble with ``attention_impl="kernel"``: each step
    runs the Function once per layer and worker, forward and backward, and
    the workers end where the same steps on the plain attention leave
    them."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig, ScheduleConfig
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.core.schedules import schedule_fn
    from repro_torch.core.swap import _stack_bundles
    from repro_torch.data.pipeline import Loader
    from repro_torch.optim.api import tree_leaves
    from repro_torch.train import loop

    resolve = dispatch.resolve
    monkeypatch.setattr(dispatch, "resolve", lambda impl, dev: (
        "kernel" if impl == "kernel" else resolve(impl, dev)))
    smoke = registry.get_smoke_config("internlm2-1.8b")
    rng = np.random.default_rng(15)
    tokens = rng.integers(0, smoke.vocab_size, (64, 17))
    train = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    sched = schedule_fn(ScheduleConfig(kind="const", peak_lr=0.05))
    n_steps, final = 2, {}
    for impl in ("kernel", "reference"):
        adapter = LMAdapter(dataclasses.replace(smoke, attention_impl=impl),
                            OptimizerConfig())
        bundle = adapter.init(torch.Generator().manual_seed(4))
        stacked = _stack_bundles(bundle, W)
        state = loop.stack_train_state(stacked, adapter.init_opt(stacked), W)
        runner = loop.EpochRunner(adapter.make_train_step(sched),
                                  Loader(train, 8, seed=7), 0.9,
                                  ensemble=True)
        state, _ = runner.run_chunk(state, list(range(W)), n_steps)
        final[impl] = tree_leaves(state.bundle["params"])
    calls = n_steps * W * smoke.n_layers
    assert plain_launches == {"fwd": calls, "bwd": calls}
    for got, want in zip(final["kernel"], final["reference"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_bwd_kernel_on_cpu_raises_and_needs_nvcc(tmp_path, monkeypatch):
    (_, _, _), (tq, tk, tv) = _inputs((1, 8, 8, 2, 1, 64), seed=8)
    lse = torch.zeros(tq.shape[:3])
    with pytest.raises(RuntimeError, match="CUDA"):
        tkernel.flash_bwd(tq, tk, tv, tq, lse, tq)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkernel.flash_bwd_dq(tq, tk, tv, tq, lse, lse)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkernel.flash_bwd_dkv(tq, tk, tv, tq, lse, lse)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    tkernel._bwd_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        tkernel.build_bwd()


# ---------------------------------------------------------------------------
# the bf16 backward's rounding contract, and its wrappers
# ---------------------------------------------------------------------------

# CARD_EDGE_CASES (D 192 among them: G 1 causal, G 2 ragged Skv; D 112
# and 96: G 1 causal, G 2 with a window and q_offset; whisper's cross
# attention at D 64, non-causal, Sq != Skv), D 128 at
# G 2 and G 4 (the scale 128 ** -0.5 is not a power of 2, so q * scale in
# bf16 moves S there; nor is 192 ** -0.5), and D 192 at G 1 with q_offset;
# the odd-G cases, so that every earlier case keeps its place; then
# whisper's encoder at D 64 (non-causal, ragged tiles each way), the D-256
# dQ/dK/dV route's cases and the D-192 route's
ROUNDED_BWD_CASES = [c for c in CARD_EDGE_CASES if c not in ODD_G_CASES] + [
    ((2, 67, 67, 4, 2, 128), True, 0, 0),
    ((1, 130, 130, 8, 2, 128), True, 0, 0),
    ((1, 33, 129, 4, 4, 192), True, 0, 96),
] + ODD_G_CASES + [((2, 150, 150, 4, 4, 64), False, 0, 0)] + BWD_CASES[-4:]
ROUNDED_BWD_CASES += DQKV192_CASES


@pytest.mark.parametrize("shape,causal,window,q_offset", ROUNDED_BWD_CASES)
def test_rounded_bwd_ref_matches_pallas_bwd_bf16(shape, causal, window,
                                                 q_offset):
    """The bf16 kernels' rounding points (q * scale in bf16 for S, P and dS
    as hi + lo bf16 pairs), as the plain version computes them, on the
    port's bf16 forward (chunk 64, its rounding), against the JAX pair
    (Pallas forward and backward in interpret mode) on the same bf16
    inputs: within the card check's bf16 BWD_TOL 1e-2 (relative to 1 +
    |value|). On f32 inputs every option is the default."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "bfloat16", seed=31)
    jdo, tdo = _grad_out(shape, "bfloat16", seed=32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jo, jl = flash_attention_pallas_fwd(jq, jk, jv, interpret=True, **kw)
    want = flash_attention_pallas_bwd(jq, jk, jv, jo, jl, jdo,
                                      interpret=True, **kw)
    to, tl = tops._blockwise_fwd(tq, tk, tv, scale=None, chunk=64, **kw)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, to, tl, tdo, rounded=True,
                                       **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _close(g, w, 1e-2)
    if q_offset < 0:
        assert bool((got[0][:, :-q_offset] == 0).all())
    f32 = [t.float() for t in (tq, tk, tv, to, tl, tdo)]
    default = tref.flash_attention_bwd_ref(*f32, **kw)
    for opt in ("rounded", "scores_as_forward"):
        for r, d in zip(tref.flash_attention_bwd_ref(*f32, **{opt: True},
                                                     **kw), default):
            assert torch.equal(r, d)


@pytest.mark.parametrize("shape,causal,window,q_offset", ROUNDED_BWD_CASES)
def test_rounded_bwd_probs_rows_sum_to_one(shape, causal, window, q_offset):
    """The fault the rounded contract repairs: against the lse of the bf16
    forward (which takes q * scale in bf16), the backward's P rows sum to 1
    within 1e-5 only when S takes q * scale the same way. Where the scale
    is not a power of 2 (D 128), q * scale in f32 leaves them off by more.
    Rows that see no key have P = 0."""
    (_, _, _), (tq, tk, tv) = _inputs(shape, "bfloat16", seed=33)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, tl = tops._blockwise_fwd(tq, tk, tv, scale=None, chunk=64, **kw)
    scale = shape[-1] ** -0.5
    rows = tref._bwd_probs(tq, tk, tl, scale=scale, scores_as_forward=True,
                           **kw).sum(-1)
    live = rows > 0
    assert bool(live.any())
    assert float((rows[live] - 1).abs().max()) <= 1e-5
    if q_offset < 0:
        assert not bool(live[..., :-q_offset].any())
    if shape[-1] == 128:
        f32_rows = tref._bwd_probs(tq, tk, tl, scale=scale,
                                   scores_as_forward=False, **kw).sum(-1)
        assert float((f32_rows[live] - 1).abs().max()) > 1e-4


def test_split_bf16_keeps_sixteen_bits():
    """hi + lo: each a bf16 value, their sum within 2^-16 of x relative."""
    x = torch.from_numpy(np.random.default_rng(34).standard_normal(4096)
                         .astype(np.float32))
    y = tref.split_bf16(x)
    hi = x.bfloat16().float()
    assert torch.equal((y - hi).bfloat16().float(), y - hi)
    assert float(((y - x).abs() / x.abs()).max()) <= 2.0 ** -16
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -10


BWD_FNS = {"dq": tkernel.flash_bwd_dq, "dkv": tkernel.flash_bwd_dkv,
           # delta takes dO and the forward's out (here q, of dO's shape)
           "delta": lambda q, k, v, do, lse, delta:
           tkernel.flash_bwd_delta(do, q)}
# what delta does not read: its call reaches the device check
DELTA_IGNORES = ("lse_dtype", "delta_shape")


def _bwd_args(shape, dtype, seed):
    (_, _, _), (tq, tk, tv) = _inputs(shape, dtype, seed=seed)
    do = _grad_out(shape, dtype, seed=seed + 1)[1]
    lse = torch.zeros(tq.shape[:3])
    return tq, tk, tv, do, lse, lse.clone()


@pytest.mark.parametrize("fn", sorted(BWD_FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_wrappers_take_both_dtypes_up_to_the_device_check(fn, dtype):
    """f32 (the FMA route) and bf16 (the wgmma route) pass every check of
    the dQ, dK/dV and delta wrappers that needs no card, at every head dim,
    and stop only at the device."""
    assert tkernel.BWD_HEAD_DIMS == (64, 96, 112, 128, 192, 256)
    for D in tkernel.BWD_HEAD_DIMS:
        args = _bwd_args((1, 8, 8, 4, 2, D), dtype, seed=40)
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            BWD_FNS[fn](*args)


BWD_REFUSED = {
    "head_dim_256": (lambda q, k, v, do, l, d: (
        *(_head_dim(t, 256) for t in (q, k, v, do)), l, d),
        RuntimeError, "needs CUDA tensors"),
    # MLA's D 192 is taken: it passes every check and stops at the device
    "head_dim_192": (lambda q, k, v, do, l, d: (
        *(_head_dim(t, 192) for t in (q, k, v, do)), l, d),
        RuntimeError, "needs CUDA tensors"),
    # zamba2's D 112 is taken, on D 128's tiles
    "head_dim_112": (lambda q, k, v, do, l, d: (
        *(_head_dim(t, 112) for t in (q, k, v, do)), l, d),
        RuntimeError, "needs CUDA tensors"),
    # minicpm3's MLA D 96 is taken, on D 128's tiles
    "head_dim_96": (lambda q, k, v, do, l, d: (
        *(_head_dim(t, 96) for t in (q, k, v, do)), l, d),
        RuntimeError, "needs CUDA tensors"),
    # D 80 is one no family needs, which the backward refuses
    "head_dim_80": (lambda q, k, v, do, l, d: (
        *(_head_dim(t, 80) for t in (q, k, v, do)), l, d),
        ValueError, "head dim 80"),
    "float16": (lambda q, k, v, do, l, d: (q.half(), k.half(), v.half(),
                                           do.half(), l, d),
                TypeError, "float32 or bfloat16"),
    "dO_dtype": (lambda q, k, v, do, l, d: (
        q, k, v, do.to(torch.float16), l, d), ValueError, "dO must match"),
    "dO_shape": (lambda q, k, v, do, l, d: (q, k, v, do[:, :4], l, d),
                 ValueError, "dO must match"),
    "lse_dtype": (lambda q, k, v, do, l, d: (q, k, v, do, l.double(), d),
                  ValueError, "lse must be"),
    "delta_shape": (lambda q, k, v, do, l, d: (q, k, v, do, l, d[..., :1]),
                    ValueError, "delta must be"),
    "dO_non_contiguous": (lambda q, k, v, do, l, d: (
        q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2), l, d),
        ValueError, "dO must be contiguous"),
    "misaligned_dO": (lambda q, k, v, do, l, d: (q, k, v, _misaligned(do),
                                                 l, d),
                      ValueError, "dO must start on a 16-byte boundary"),
    "cpu": (lambda q, k, v, do, l, d: (q, k, v, do, l, d), RuntimeError,
            "needs CUDA tensors"),
}


@pytest.mark.parametrize("case", sorted(BWD_REFUSED))
@pytest.mark.parametrize("fn", sorted(BWD_FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_wrappers_refuse_what_the_kernels_cannot_take(case, fn, dtype):
    make, exc, msg = BWD_REFUSED[case]
    if fn == "delta" and case in DELTA_IGNORES:
        exc, msg = RuntimeError, "needs CUDA tensors"
    args = make(*_bwd_args((1, 8, 8, 4, 2, 128), dtype, seed=41))
    with pytest.raises(exc, match=msg):
        BWD_FNS[fn](*args)


def test_backward_library_is_built_from_both_sources(monkeypatch):
    """The flash_bwd library: the f32 FMA kernels and C entries, the bf16
    wgmma kernels, and the header the bf16 sources share."""
    seen = _fake_builds(monkeypatch)
    tkernel._bwd_library.cache_clear()
    with pytest.raises(RuntimeError, match="no nvcc here"):
        tkernel.build_bwd()
    assert seen == {"flash_bwd": (["flash_bwd.cu", "flash_bwd_sm90.cu"],
                                  ["sm90.cuh"])}
    assert all((tkernel.SOURCE.parent / n).is_file()
               for n in sum(seen["flash_bwd"], []))


class _FakeLib:
    """Stands in for ctypes.CDLL: every attribute a fresh namespace."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        import types
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_backward_library_binds_the_delta_entry(monkeypatch):
    """fa_bwd_delta's argtypes are set as its C signature has them (dO, O,
    delta pointers; rows as int64, D and dtype as int; the stream), so no
    pointer or row count is cut to 32 bits."""
    import ctypes
    monkeypatch.setattr(_build, "build_library", lambda name, sources,
                        headers=(): _build.Built(path=Path("libfake.so"),
                                                 seconds=0.0, log=""))
    monkeypatch.setattr(tkernel.ctypes, "CDLL", _FakeLib)
    tkernel._bwd_library.cache_clear()
    try:
        _, lib = tkernel._bwd_library()
    finally:
        tkernel._bwd_library.cache_clear()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    assert lib.fa_bwd_delta.argtypes == [ptr, ptr, ptr, ctypes.c_int64, i32,
                                         i32, ptr]
    assert lib.fa_bwd_delta.restype is i32
    assert lib.fa_bwd_dq.argtypes[:7] == [ptr] * 7
    # the dQ/dK/dV entry: q k v dO lse delta dq dk dv, then fa_bwd_dq's tail
    assert lib.fa_bwd_dqkv.argtypes == [ptr] * 9 + lib.fa_bwd_dq.argtypes[7:]
    assert lib.fa_bwd_dqkv.restype is i32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_delta_matches_the_reference_expression(dtype):
    """The plain delta (the kernel's yardstick on the card) against the JAX
    package's own expression, jnp.sum(do.astype(f32) * out.astype(f32),
    -1), on the same seeded inputs: within 1e-6 of rowsum(|dO * O|) on
    every row, at every head dim the kernel takes."""
    rng = np.random.default_rng(50)
    for D in tkernel.BWD_HEAD_DIMS:
        do, out = (rng.standard_normal((2, 9, 3, D)).astype(np.float32)
                   for _ in range(2))
        tdo, tout = (torch.from_numpy(a).to(getattr(torch, dtype))
                     for a in (do, out))
        jdo, jout = (jnp.asarray(a, getattr(jnp, dtype)) for a in (do, out))
        want = np.asarray(jnp.sum(jdo.astype(jnp.float32)
                                  * jout.astype(jnp.float32), -1))
        got = tkernel.bwd_delta(tdo, tout)
        assert got.dtype == torch.float32 and got.shape == (2, 9, 3)
        scale = (tdo.float() * tout.float()).abs().sum(-1).numpy()
        assert float((np.abs(got.numpy() - want) / scale).max()) <= 1e-6


def test_profile_files_delta_kernel_under_its_own_name():
    """The profiler's kernel categories give delta's kernel a row of its
    own beside dQ's and dK/dV's (both routes), not "other"."""
    from repro_torch.launch import profile_train
    cat = profile_train._category
    assert cat("void (anonymous namespace)::fa_bwd_delta_kernel"
               "<__nv_bfloat16, 128>(__nv_bfloat16 const*)") \
        == "flash_attention_bwd_delta"
    assert cat("fa_bwd_dq_sm90_kernel<128, 1, 3, 1>") \
        == "flash_attention_bwd_dq"
    assert cat("fa_bwd_dkv_kernel<float, 64>") == "flash_attention_bwd_dkv"
    assert cat("void (anonymous namespace)::fa_bwd_dqkv_sm90_kernel<4, 1>"
               "(CUtensorMap_st, CUtensorMap_st)") \
        == "flash_attention_bwd_dqkv"
    # the D-192 instantiation, the persistent kernel
    assert cat("void (anonymous namespace)::"
               "fa_bwd_dqkv_sm90_kernel_persistent<192>(CUtensorMap_st, "
               "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
               "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
               "float const*, int, int, int, int, float, int, int, int)") \
        == "flash_attention_bwd_dqkv"


def test_flash_bwd_forms_delta_with_the_kernel(monkeypatch):
    """kernel.flash_bwd runs delta's kernel wrapper first and hands its
    output to the dQ and dK/dV wrappers; the plain chain is not on it."""
    calls, plain_delta = [], tkernel.bwd_delta

    def delta_fn(do, out):
        calls.append("delta")
        return plain_delta(do, out)

    def dq_fn(q, k, v, do, lse, delta, **kw):
        calls.append("dq")
        seen["dq"] = delta
        return torch.zeros_like(q)

    def dkv_fn(q, k, v, do, lse, delta, **kw):
        calls.append("dkv")
        seen["dkv"] = delta
        return torch.zeros_like(k), torch.zeros_like(v)

    def plain(*args):
        raise AssertionError("the plain delta ran on the kernel path")

    seen = {}
    monkeypatch.setattr(tkernel, "flash_bwd_delta", delta_fn)
    monkeypatch.setattr(tkernel, "flash_bwd_dq", dq_fn)
    monkeypatch.setattr(tkernel, "flash_bwd_dkv", dkv_fn)
    (_, _, _), (tq, tk, tv) = _inputs((1, 8, 8, 4, 2, 64), seed=51)
    do = _grad_out((1, 8, 8, 4, 2, 64), seed=52)[1]
    lse = torch.zeros(tq.shape[:3])
    monkeypatch.setattr(tkernel, "bwd_delta", plain)
    tkernel.flash_bwd(tq, tk, tv, tq, lse, do)
    assert calls == ["delta", "dq", "dkv"]
    assert seen["dq"] is seen["dkv"]
    want = (do * tq).sum(-1)
    torch.testing.assert_close(seen["dq"], want, rtol=1e-6, atol=1e-6)


# (dtype, Sq, Skv, H, KVH, D, scale): the dQ/dK/dV route's boundary, each
# case against its neighbour across it
DQKV_ROUTE = {
    "gemma3_s64_g4": ((torch.bfloat16, 64, 64, 4, 1, 256, None), True),
    "skv_65": ((torch.bfloat16, 64, 65, 4, 1, 256, None), False),
    "sq_65": ((torch.bfloat16, 65, 64, 4, 1, 256, None), False),
    "g3": ((torch.bfloat16, 64, 64, 3, 1, 256, None), False),
    "g8_ragged": ((torch.bfloat16, 1, 37, 8, 1, 256, None), True),
    "g1": ((torch.bfloat16, 64, 64, 4, 4, 256, None), True),
    "g16": ((torch.bfloat16, 64, 64, 16, 1, 256, None), False),
    "d128": ((torch.bfloat16, 64, 64, 4, 1, 128, None), False),
    "float32": ((torch.float32, 64, 64, 4, 1, 256, None), False),
    "scale_pow2": ((torch.bfloat16, 64, 64, 4, 1, 256, 0.125), True),
    "scale_not_pow2": ((torch.bfloat16, 64, 64, 4, 1, 256, 0.1), False),
    "empty_sq": ((torch.bfloat16, 0, 64, 4, 1, 256, None), False),
    # D 192 (deepseek-v2-lite's MLA): G 1 at any finite scale; G 2, Skv 65
    # and f32 keep the pair; D 256 still needs a power-of-2 scale at G 1
    "d192_deepseek_s64_g1": ((torch.bfloat16, 64, 64, 16, 16, 192,
                              192 ** -0.5), True),
    "d192_ragged_default_scale": ((torch.bfloat16, 33, 64, 2, 2, 192, None),
                                  True),
    "d192_g2": ((torch.bfloat16, 64, 64, 16, 8, 192, None), False),
    "d192_skv_65": ((torch.bfloat16, 64, 65, 16, 16, 192, None), False),
    "d192_sq_65": ((torch.bfloat16, 65, 64, 16, 16, 192, None), False),
    "d192_float32": ((torch.float32, 64, 64, 16, 16, 192, None), False),
    "d192_scale_nan": ((torch.bfloat16, 64, 64, 16, 16, 192, float("nan")),
                       False),
    "d256_g1_scale_not_pow2": ((torch.bfloat16, 64, 64, 4, 4, 256,
                                192 ** -0.5), False),
}


@pytest.mark.parametrize("case", sorted(DQKV_ROUTE))
def test_dqkv_route_boundary(case):
    """kernel.takes_dqkv: bf16 with Sq and Skv in 1..64, at D 256 with G
    in (1, 2, 4, 8) and a power-of-2 scale in bf16 (1/16 by default), at D
    192 with G 1 and any finite scale, take the dQ/dK/dV kernel; one step
    past any bound keeps the pair."""
    (dtype, Sq, Skv, H, KVH, D, scale), want = DQKV_ROUTE[case]
    assert tkernel.takes_dqkv(dtype, Sq, Skv, H, KVH, D, scale) is want


@pytest.mark.parametrize("shape,dtype,route", [
    ((1, 64, 64, 4, 1, 256), "bfloat16", ["delta", "dqkv"]),
    ((2, 37, 37, 8, 2, 256), "bfloat16", ["delta", "dqkv"]),
    ((1, 64, 65, 4, 1, 256), "bfloat16", ["delta", "dq", "dkv"]),
    ((1, 64, 64, 3, 1, 256), "bfloat16", ["delta", "dq", "dkv"]),
    ((1, 64, 64, 4, 1, 256), "float32", ["delta", "dq", "dkv"]),
    ((1, 64, 64, 4, 1, 128), "bfloat16", ["delta", "dq", "dkv"]),
    # D 192 (MLA): G 1 takes the dQ/dK/dV kernel, G 2 the pair
    ((2, 64, 64, 4, 4, 192), "bfloat16", ["delta", "dqkv"]),
    ((1, 64, 64, 4, 2, 192), "bfloat16", ["delta", "dq", "dkv"]),
])
def test_flash_bwd_takes_dqkv_on_its_route(monkeypatch, shape, dtype, route):
    """kernel.flash_bwd runs delta's kernel, then on takes_dqkv's shapes the
    dQ/dK/dV kernel alone, elsewhere the dQ and dK/dV kernels, each handed
    delta's output; it returns what they return."""
    calls, seen = [], {}
    B, Sq, Skv, H, KVH, D = shape
    outs = {"dq": torch.full((B, Sq, H, D), 1.0),
            "dk": torch.full((B, Skv, KVH, D), 2.0),
            "dv": torch.full((B, Skv, KVH, D), 3.0)}

    def delta_fn(do, out):
        calls.append("delta")
        return tkernel.bwd_delta(do, out)

    def launch(name, *result):
        def fn(q, k, v, do, lse, delta, **kw):
            calls.append(name)
            seen[name] = (delta, kw)
            return result[0] if len(result) == 1 else result
        return fn

    monkeypatch.setattr(tkernel, "flash_bwd_delta", delta_fn)
    monkeypatch.setattr(tkernel, "flash_bwd_dq", launch("dq", outs["dq"]))
    monkeypatch.setattr(tkernel, "flash_bwd_dkv",
                        launch("dkv", outs["dk"], outs["dv"]))
    monkeypatch.setattr(tkernel, "flash_bwd_dqkv",
                        launch("dqkv", *outs.values()))
    (_, _, _), (tq, tk, tv) = _inputs(shape, dtype, seed=53)
    do = _grad_out(shape, dtype, seed=54)[1]
    lse = torch.zeros(tq.shape[:3])
    got = tkernel.flash_bwd(tq, tk, tv, tq, lse, do, causal=False, window=7,
                            q_offset=3)
    assert calls == route
    assert all(g is outs[n] for g, n in zip(got, ("dq", "dk", "dv")))
    for name in route[1:]:
        delta, kw = seen[name]
        torch.testing.assert_close(delta, tkernel.bwd_delta(do, tq))
        assert kw == dict(causal=False, window=7, scale=None, q_offset=3)


DQKV_REFUSED = {
    "float32": (lambda q, k, v, do, l, d: (q.float(), k.float(), v.float(),
                                           do.float(), l, d),
                ValueError, "flash_bwd_dqkv takes bfloat16"),
    "head_dim_128": (lambda q, k, v, do, l, d: (
        *(t[..., :128].contiguous() for t in (q, k, v, do)), l, d),
        ValueError, "flash_bwd_dqkv takes"),
    "skv_65": (lambda q, k, v, do, l, d: (
        q, *(torch.cat([t, t[:, :1]], 1) for t in (k, v)), do, l, d),
        ValueError, "flash_bwd_dqkv takes"),
    "g3": (lambda q, k, v, do, l, d: (
        q[:, :, :3].contiguous(), k, v, do[:, :, :3].contiguous(),
        l[..., :3].contiguous(), d[..., :3].contiguous()),
        ValueError, "flash_bwd_dqkv takes"),
    # D 192 is taken at G 1 only (here G 4)
    "head_dim_192_g4": (lambda q, k, v, do, l, d: (
        *(t[..., :192].contiguous() for t in (q, k, v, do)), l, d),
        ValueError, "flash_bwd_dqkv takes"),
    "dO_shape": (lambda q, k, v, do, l, d: (q, k, v, do[:, :4], l, d),
                 ValueError, "dO must match"),
    "lse_dtype": (lambda q, k, v, do, l, d: (q, k, v, do, l.double(), d),
                  ValueError, "lse must be"),
    "dO_non_contiguous": (lambda q, k, v, do, l, d: (
        q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2), l, d),
        ValueError, "dO must be contiguous"),
    "misaligned_dO": (lambda q, k, v, do, l, d: (q, k, v, _misaligned(do),
                                                 l, d),
                      ValueError, "dO must start on a 16-byte boundary"),
}


@pytest.mark.parametrize("shape", [(1, 64, 64, 4, 1, 256),
                                   (2, 37, 37, 4, 2, 256),
                                   (1, 1, 64, 8, 1, 256),
                                   (1, 64, 33, 4, 4, 256),
                                   (2, 64, 64, 4, 4, 192),
                                   (1, 37, 33, 2, 2, 192)])
def test_dqkv_wrapper_takes_its_route_up_to_the_device_check(shape):
    """bf16 on the dQ/dK/dV route (D 256 at G 4, 2, 8, 1; D 192 at G 1;
    ragged Sq and Skv) passes every check of ``flash_bwd_dqkv`` that needs
    no card, and stops only at the device."""
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        tkernel.flash_bwd_dqkv(*_bwd_args(shape, "bfloat16", seed=55))


@pytest.mark.parametrize("case", sorted(DQKV_REFUSED) + ["scale_not_pow2"])
def test_dqkv_wrapper_refuses_what_its_kernel_cannot_take(case):
    """Off the route (f32, D 128, Skv 65, G 3, D 192 at G 4, a scale that
    is not a power of 2 in bf16 at D 256) and on malformed dO, lse: a
    ValueError before the device check."""
    args = _bwd_args((1, 64, 64, 4, 1, 256), "bfloat16", seed=56)
    if case == "scale_not_pow2":
        with pytest.raises(ValueError, match="power-of-2 scale"):
            tkernel.flash_bwd_dqkv(*args, scale=0.1)
        return
    make, exc, msg = DQKV_REFUSED[case]
    with pytest.raises(exc, match=msg):
        tkernel.flash_bwd_dqkv(*make(*args))


def test_build_hashes_headers_and_puts_them_on_the_include_path(
        tmp_path, monkeypatch):
    """A header is hashed with the sources, so an edited header names a new
    library, and its directory is on nvcc's include path (so a source
    built from elsewhere, as the A/B scripts build variants, finds it).
    nvcc is a stand-in script that records its arguments."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text('#!/bin/sh\necho "$@" > "$NVCC_ARGS"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("NVCC_ARGS", str(tmp_path / "args"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src, hdr = tmp_path / "a.cu", tmp_path / "inc" / "h.cuh"
    hdr.parent.mkdir()
    src.write_text('#include "h.cuh"\n')
    hdr.write_text("// one\n")
    first = _build.build_library("x", [src], headers=[hdr])
    assert first.path.is_file() and first.seconds > 0
    args = (tmp_path / "args").read_text().split()
    assert f"-I{hdr.parent}" in args and str(hdr) not in args
    assert _build.build_library("x", [src], headers=[hdr]).seconds == 0.0
    hdr.write_text("// two\n")
    second = _build.build_library("x", [src], headers=[hdr])
    assert second.path != first.path and second.seconds > 0
