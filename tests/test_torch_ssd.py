"""Port's SSD op against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``repro.kernels.ssd`` and
``repro_torch.kernels.ssd``. The plain intra-chunk forward and backward (the
CUDA kernels' yardsticks on the card) are held against the Mosaic kernels in
interpret mode; the scan and its gradients against JAX's ``ssd_scan``. The
JAX SSD tests' bounds: 1e-4, and 2e-4 / 1e-3 for whole-scan gradients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ops as jops  # noqa: E402
from repro.kernels.ssd.kernel import (  # noqa: E402
    ssd_chunk_pallas, ssd_chunk_pallas_bwd,
)
from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.ssd import kernel as tkernel  # noqa: E402
from repro_torch.kernels.ssd import ops as tops  # noqa: E402

TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3

# (B, S, H, P, G, N): the JAX SSD tests' shapes (grouped, ragged)
SHAPES = [
    (1, 32, 2, 8, 1, 4),
    (2, 96, 4, 16, 2, 8),
    (2, 83, 4, 16, 1, 8),
    (1, 64, 8, 32, 4, 16),
]


def _np_inputs(B, S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(B, S, H, P)
    dt = np.log1p(np.exp(f(B, S, H)))            # softplus
    A = -np.exp(f(H))
    return x, dt, A, f(B, S, G, N), f(B, S, G, N), f(H)


def _both(arrays, dtype="float32"):
    """(jax arrays, torch tensors); x, B and C in ``dtype``."""
    cast = {0: dtype, 3: dtype, 4: dtype}
    j = [jnp.asarray(a, cast.get(i, "float32")) for i, a in enumerate(arrays)]
    t = [torch.from_numpy(a).to(getattr(torch, cast.get(i, "float32")))
         for i, a in enumerate(arrays)]
    return j, t


def _close(got, want, tol=TOL, rtol=None):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol if rtol is None else rtol)


def _padded(shape, chunk, seed):
    """Inputs with S padded to a multiple of chunk by zeros, as ``_chunked``
    pads them before the intra-chunk block."""
    B, S, H, P, G, N = shape
    arrays = list(_np_inputs(*shape, seed=seed))
    pad = (-S) % chunk
    for i in (0, 1, 3, 4):
        widths = [(0, 0)] * arrays[i].ndim
        widths[1] = (0, pad)
        arrays[i] = np.pad(arrays[i], widths)
    return arrays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_intra_chunk_matches_jnp_and_pallas_kernel(shape, dtype):
    chunk = 32
    (jx, jdt, jA, jB, jC, _), (tx, tdt, tA, tB, tC, _) = _both(
        _padded(shape, chunk, seed=1), dtype)
    got = tops._intra_chunk(tx, tdt, tA, tB, tC, chunk)
    want_jnp = jops._intra_chunk_jnp(jx, jdt, jA, jB, jC, chunk)
    want_pl = ssd_chunk_pallas(jx, jdt, jA, jB, jC, chunk=chunk,
                               interpret=True)
    for g, wj, wp in zip(got, want_jnp, want_pl):
        assert g.dtype == torch.float32 and tuple(g.shape) == wp.shape
        _close(g, wj)
        _close(g, wp)


def _cotangents(B, S, H, P, N, chunk, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, S, H, P), f(B, S // chunk, H, P, N), f(B, S, H)


@pytest.mark.parametrize("shape", SHAPES + [(1, 64, 2, 8, 1, 4)])
def test_intra_chunk_bwd_matches_pallas_bwd_and_autograd(shape):
    """The plain backward twin against the Mosaic backward kernel in
    interpret mode, and against autograd of the plain forward (as
    test_pallas_intra_backward_matches_vjp holds the kernel to jax.vjp)."""
    chunk = 32
    B, S, H, P, G, N = shape
    arrays = _padded(shape, chunk, seed=2)
    Sp = arrays[0].shape[1]
    cots = _cotangents(B, Sp, H, P, N, chunk, seed=3)
    (jx, jdt, jA, jB, jC, _), (tx, tdt, tA, tB, tC, _) = _both(arrays)
    got = tops._intra_chunk_bwd(tx, tdt, tA, tB, tC,
                                *map(torch.from_numpy, cots), chunk)
    want = ssd_chunk_pallas_bwd(jx, jdt, jA, jB, jC,
                                *map(jnp.asarray, cots), chunk=chunk,
                                interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)
    leaves = [t.clone().requires_grad_() for t in (tx, tdt, tA, tB, tC)]
    outs = tops._intra_chunk(*leaves, chunk)
    auto = torch.autograd.grad(outs, leaves,
                               [torch.from_numpy(c) for c in cots])
    for g, a in zip(got, auto):
        _close(g, a.numpy())


@pytest.mark.parametrize("impl", ["reference", "naive"])
@pytest.mark.parametrize("shape", SHAPES)
def test_scan_matches_jax(shape, impl):
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = _both(
        _np_inputs(*shape, seed=4))
    jy, js = jops.ssd_scan(jx, jdt, jA, jB, jC, jD, impl=impl, chunk=32)
    ty, ts = tops.ssd_scan(tx, tdt, tA, tB, tC, tD, impl=impl, chunk=32)
    assert ty.dtype == ts.dtype == torch.float32
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("chunk", [8, 16, 64, 128])
def test_chunk_size_invariance_against_jax_oracle(chunk):
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = _both(
        _np_inputs(2, 64, 2, 8, 1, 4, seed=5))
    jy, js = jops.ssd_scan(jx, jdt, jA, jB, jC, jD, impl="naive")
    ty, ts = tops.ssd_scan(tx, tdt, tA, tB, tC, tD, impl="reference",
                           chunk=chunk)
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("impl", ["reference", "naive"])
def test_init_state_chaining_matches_jax(impl):
    """Two halves with the state carried == one full JAX scan."""
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = _both(
        _np_inputs(2, 64, 4, 16, 2, 8, seed=6))
    jy, js = jops.ssd_scan(jx, jdt, jA, jB, jC, jD, impl="naive")
    h = lambda t, sl: t[:, sl]
    ya, sa = tops.ssd_scan(h(tx, slice(0, 32)), h(tdt, slice(0, 32)), tA,
                           h(tB, slice(0, 32)), h(tC, slice(0, 32)), tD,
                           impl=impl, chunk=16)
    yb, sb = tops.ssd_scan(h(tx, slice(32, None)), h(tdt, slice(32, None)),
                           tA, h(tB, slice(32, None)), h(tC, slice(32, None)),
                           tD, impl=impl, chunk=16, init_state=sa)
    _close(torch.cat([ya, yb], 1), jy)
    _close(sb, js)


def test_decode_after_scan_matches_jax():
    """Scan a prefix, then decode step by step: the state and every output
    equal JAX's scan over the whole sequence."""
    (jx, jdt, jA, jB, jC, jD), (tx, tdt, tA, tB, tC, tD) = _both(
        _np_inputs(2, 29, 4, 8, 2, 4, seed=7))
    jy, js = jops.ssd_scan(jx, jdt, jA, jB, jC, jD, impl="naive")
    y0, state = tops.ssd_scan(tx[:, :20], tdt[:, :20], tA, tB[:, :20],
                              tC[:, :20], tD, chunk=8)
    ys = [y0]
    for t in range(20, 29):
        y, state = tops.ssd_decode(tx[:, t], tdt[:, t], tA, tB[:, t],
                                   tC[:, t], tD, state)
        assert y.dtype == tx.dtype
        ys.append(y[:, None])
    _close(torch.cat(ys, 1), jy)
    _close(state, js)
    jyd, jsd = jops.ssd_decode(jx[:, 0], jdt[:, 0], jA, jB[:, 0], jC[:, 0],
                               jD, jnp.asarray(js))
    tyd, tsd = tops.ssd_decode(tx[:, 0], tdt[:, 0], tA, tB[:, 0], tC[:, 0],
                               tD, torch.from_numpy(np.array(js)))
    _close(tyd, jyd)
    _close(tsd, jsd)


@pytest.fixture
def plain_launches(monkeypatch):
    """The test-only dispatch: ``impl="kernel"`` resolves to the kernel path
    on the CPU, and the Function's two launch functions are replaced by the
    plain twins, with their calls counted."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(x, dt, A, Bm, Cm, *, chunk):
        calls["fwd"] += 1
        return tops._intra_chunk(x, dt, A, Bm, Cm, chunk)

    def bwd(x, dt, A, Bm, Cm, dy, dstates, dcum, *, chunk):
        calls["bwd"] += 1
        return tops._intra_chunk_bwd(x, dt, A, Bm, Cm, dy, dstates, dcum,
                                     chunk)

    resolve = dispatch.resolve
    monkeypatch.setattr(dispatch, "resolve", lambda impl, dev: (
        "kernel" if impl == "kernel" else resolve(impl, dev)))
    monkeypatch.setattr(tkernel, "ssd_fwd", fwd)
    monkeypatch.setattr(tkernel, "ssd_bwd", bwd)
    return calls


def _loss_grads_torch(arrays, impl, chunk, init=None):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    if init is not None:
        leaves.append(torch.from_numpy(init).requires_grad_())
    x, dt, A, Bm, Cm, D = leaves[:6]
    y, s = tops.ssd_scan(x, dt, A, Bm, Cm, D, impl=impl, chunk=chunk,
                         init_state=leaves[6] if init is not None else None)
    loss = (y ** 2).mean() + (s ** 2).mean()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("jimpl", ["pallas", "naive"])
@pytest.mark.parametrize("shape", [(1, 48, 2, 8, 1, 4), (2, 83, 4, 16, 2, 8)])
def test_function_grads_match_jax_grad(plain_launches, shape, jimpl):
    """Gradients of (y²).mean() + (s²).mean() through the port's Function
    (plain twins on the CPU) against jax.grad of the Pallas path (Mosaic
    kernels in interpret mode) and of the sequential oracle, for x, dt, A,
    B, C and D; grouped and ragged as in
    test_pallas_backward_kernel_all_operands."""
    arrays = _np_inputs(*shape, seed=8)

    def jloss(*a):
        y, s = jops.ssd_scan(*a, impl=jimpl, chunk=32)
        return (y ** 2).mean() + (s ** 2).mean()

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    got = _loss_grads_torch(arrays, "kernel", 32)
    assert plain_launches == {"fwd": 1, "bwd": 1}
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close(g, w, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("shape,chunk", [((2, 83, 4, 16, 2, 8), 32),
                                         ((1, 64, 8, 32, 4, 16), 64),
                                         ((2, 50, 2, 8, 1, 4), 16)])
def test_function_grads_equal_plain_autograd(plain_launches, shape, chunk):
    """What the kernels replace on the card: the Function's explicit
    backward against autograd through the plain chunked scan, including an
    init_state's gradient."""
    B, S, H, P, G, N = shape
    arrays = _np_inputs(*shape, seed=9)
    init = np.random.default_rng(10).standard_normal(
        (B, H, P, N)).astype(np.float32)
    got = _loss_grads_torch(arrays, "kernel", chunk, init)
    want = _loss_grads_torch(arrays, "reference", chunk, init)
    assert plain_launches == {"fwd": 1, "bwd": 1}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


def test_function_materializes_unused_cotangents(plain_launches):
    """Only y_intra feeds the loss: the backward still gets zero
    cotangents of states and cum, and matches autograd of the plain twin."""
    arrays = _padded((1, 40, 2, 8, 1, 4), 20, seed=11)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
    y, _, _ = tops.SSDIntraChunk.apply(*leaves, 20)
    got = torch.autograd.grad(y.sum(), leaves)
    outs = tops._intra_chunk(*leaves, 20)
    want = torch.autograd.grad(outs[0].sum(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


def test_auto_on_cpu_is_the_chunked_reference():
    _, (tx, tdt, tA, tB, tC, tD) = _both(_np_inputs(1, 40, 2, 8, 1, 4, 12))
    got = tops.ssd_scan(tx, tdt, tA, tB, tC, tD, chunk=16)
    want = tops._chunked_reference(tx, tdt, tA, tB, tC, tD, 16, None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_path_refuses_the_cpu_and_design_pins():
    _, (tx, tdt, tA, tB, tC, tD) = _both(_np_inputs(1, 16, 2, 8, 1, 4, 13))
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.ssd_scan(tx, tdt, tA, tB, tC, tD, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkernel.ssd_fwd(tx, tdt, tA, tB, tC, chunk=16)
    with pytest.raises(RuntimeError, match="ops.ssd_scan"):
        tkernel.ssd_fwd(tx.requires_grad_(), tdt, tA, tB, tC, chunk=16)
    z = torch.zeros(1, 16, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkernel.ssd_bwd(tx.detach(), tdt, tA, tB, tC, tx.detach(),
                        torch.zeros(1, 1, 2, 8, 4), z, chunk=16)
    with pytest.raises(NotImplementedError, match="tuning"):
        tops.ssd_scan(tx, tdt, tA, tB, tC, tD, design=(32, 32, 4, 2))
    with pytest.raises(ValueError, match="unknown kernel impl"):
        tops.ssd_scan(tx, tdt, tA, tB, tC, tD, impl="pallas")


# the bf16 route's widths (mamba2-2.7b P 64 / N 128, the zamba2-7b mamba
# blocks' N 64) at the engine's and training's chunk lengths and the full
# chunk, with 2 heads a group: (B, S, H, P, G, N), chunk
ROUTE_CASES = [((1, L * nc, 4, 64, 2, N), L)
               for N in (128, 64) for L, nc in ((37, 2), (64, 1), (256, 1))]


def _scaled(got, want):
    """max |got - want| / max |want|."""
    want = np.asarray(want, np.float64)
    return (np.abs(got.detach().double().numpy() - want).max()
            / np.abs(want).max())


@pytest.mark.parametrize("shape,chunk", [(s, 32) for s in SHAPES]
                         + ROUTE_CASES)
def test_rounded_matches_pallas_pair(shape, chunk):
    """The plain versions at the bf16 kernels' rounding points, on bf16
    inputs, against the Mosaic forward and backward kernels in interpret
    mode: within the JAX SSD tests' 1e-4 of max |ref|."""
    B, S, H, P, G, N = shape
    arrays = _padded(shape, chunk, seed=21)
    Sp = arrays[0].shape[1]
    cots = _cotangents(B, Sp, H, P, N, chunk, seed=22)
    (jx, jdt, jA, jB, jC, _), (tx, tdt, tA, tB, tC, _) = _both(arrays,
                                                               "bfloat16")
    got = tops._intra_chunk(tx, tdt, tA, tB, tC, chunk, rounded=True)
    want = ssd_chunk_pallas(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    got_b = tops._intra_chunk_bwd(tx, tdt, tA, tB, tC,
                                  *map(torch.from_numpy, cots), chunk,
                                  rounded=True)
    want_b = ssd_chunk_pallas_bwd(jx, jdt, jA, jB, jC,
                                  *map(jnp.asarray, cots), chunk=chunk,
                                  interpret=True)
    for name, g, w in zip(("y", "states", "cum", "dx", "ddt", "dA", "dB",
                           "dC"), got + got_b, want + want_b):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert _scaled(g, w) <= TOL, (name, _scaled(g, w))


@pytest.mark.parametrize("shape,chunk", [(SHAPES[1], 32), ROUTE_CASES[0]])
def test_rounded_equals_default_in_f32(shape, chunk):
    """The rounding points are the bf16 route's: on f32 inputs (the f32
    route) ``rounded=True`` is the default, bit for bit."""
    B, S, H, P, G, N = shape
    arrays = _padded(shape, chunk, seed=23)
    cots = [torch.from_numpy(c) for c in
            _cotangents(B, arrays[0].shape[1], H, P, N, chunk, seed=24)]
    _, (tx, tdt, tA, tB, tC, _) = _both(arrays)
    for r, d in zip(
            tops._intra_chunk(tx, tdt, tA, tB, tC, chunk, rounded=True)
            + tops._intra_chunk_bwd(tx, tdt, tA, tB, tC, *cots, chunk,
                                    rounded=True),
            tops._intra_chunk(tx, tdt, tA, tB, tC, chunk)
            + tops._intra_chunk_bwd(tx, tdt, tA, tB, tC, *cots, chunk)):
        assert torch.equal(r, d)


@pytest.mark.parametrize("head_block", [1, 2, 3, 5])
def test_head_block_partials_equal_per_head_sum(head_block):
    """dB and dC taken once per block of heads (on dG o seg and the state
    term summed over the block) and the blocks' partials then summed, as
    the bf16 kernel and its wrapper take them, equal the per-head sum
    within 1e-6 of max |ref|; the other outputs do not depend on it."""
    shape, chunk = (2, 96, 10, 16, 2, 8), 32
    B, S, H, P, G, N = shape
    arrays = _padded(shape, chunk, seed=25)
    cots = [torch.from_numpy(c) for c in
            _cotangents(B, S, H, P, N, chunk, seed=26)]
    _, (tx, tdt, tA, tB, tC, _) = _both(arrays)
    got = tops._intra_chunk_bwd(tx, tdt, tA, tB, tC, *cots, chunk,
                                head_block=head_block)
    want = tops._intra_chunk_bwd(tx, tdt, tA, tB, tC, *cots, chunk)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    for g, w in zip(got[3:], want[3:]):
        assert _scaled(g, w.numpy()) <= 1e-6


def test_rounded_backward_follows_the_kernel_head_block():
    """``rounded=True`` takes dB and dC per the kernels' head block unless
    told otherwise: the split of M happens once per block."""
    shape, chunk = ROUTE_CASES[1]
    B, S, H, P, G, N = shape
    arrays = _padded(shape, chunk, seed=27)
    cots = [torch.from_numpy(c) for c in
            _cotangents(B, S, H, P, N, chunk, seed=28)]
    _, (tx, tdt, tA, tB, tC, _) = _both(arrays, "bfloat16")
    hb = tkernel.head_block(H // G, chunk, bwd=True)
    got = tops._intra_chunk_bwd(tx, tdt, tA, tB, tC, *cots, chunk,
                                rounded=True)
    want = tops._intra_chunk_bwd(tx, tdt, tA, tB, tC, *cots, chunk,
                                 rounded=True, head_block=hb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,P,N,route", [
    ("bfloat16", 64, 128, True), ("bfloat16", 64, 64, True),
    ("float32", 64, 128, False), ("bfloat16", 32, 16, False),
    ("bfloat16", 64, 16, False), ("bfloat16", 48, 128, False)])
def test_route_rule(dtype, P, N, route):
    """bf16 x, B, C with P 64 and N 64 or 128 take the wgmma route; f32 and
    the smoke widths stay on the FMA kernels."""
    x = torch.zeros(1, 4, 2, P, dtype=getattr(torch, dtype))
    Bm = torch.zeros(1, 4, 1, N, dtype=getattr(torch, dtype))
    assert tkernel.sm90_route(x, Bm) is route


def test_head_block_rule():
    """8 heads a forward CTA; 16 / ceil(L / 64) a backward CTA, so that its
    per-head sums of L floats fit; never more than the group."""
    assert tkernel.head_block(80, 256, bwd=False) == 8
    assert tkernel.head_block(80, 64, bwd=True) == 16
    assert [tkernel.head_block(80, L, bwd=True)
            for L in (1, 37, 65, 128, 129, 200, 256)] == [16, 16, 8, 8, 5, 4,
                                                           4]
    assert tkernel.head_block(2, 64, bwd=True) == 2
    assert tkernel.head_block(3, 37, bwd=False) == 3


def _route_inputs(S=64, H=4, G=1, N=128):
    x = torch.zeros(1, S, H, 64, dtype=torch.bfloat16)
    Bm = torch.zeros(1, S, G, N, dtype=torch.bfloat16)
    return x, torch.ones(1, S, H), -torch.ones(H), Bm, Bm.clone()


def test_route_refuses_views_tma_cannot_read():
    """The bf16 route reads x, B and C by TMA: a view whose start or
    strides are not a multiple of 16 bytes is refused before the device is
    asked for; the model's views of its conv output pass."""
    x, dt, A, Bm, Cm = _route_inputs()
    conv = torch.zeros(1, 64, 4 * 64 + 2 * 128 + 8, dtype=torch.bfloat16)
    xv = conv[..., :256].reshape(1, 64, 4, 64)
    bv = conv[..., 256:384].reshape(1, 64, 1, 128)
    cv = conv[..., 384:512].reshape(1, 64, 1, 128)
    tkernel._check_tma(xv, bv, cv)               # 16-byte strides: fine
    with pytest.raises(RuntimeError, match="CUDA"):
        tkernel.ssd_fwd(xv, dt, A, bv, cv, chunk=64)
    odd = torch.zeros(1, 64, 4 * 64 + 2 * 128 + 4, dtype=torch.bfloat16)
    xo = odd[..., :256].reshape(1, 64, 4, 64)    # step stride 520 bytes
    bo = odd[..., 258:386].reshape(1, 64, 1, 128)    # starts 516 bytes in
    for args in ((xo, dt, A, Bm, Cm), (x, dt, A, bo, Cm), (x, dt, A, Bm, bo)):
        with pytest.raises(ValueError, match="TMA"):
            tkernel.ssd_fwd(*args, chunk=64)
        with pytest.raises(ValueError, match="TMA"):
            tkernel.ssd_bwd(*args, torch.zeros(1, 64, 4, 64),
                            torch.zeros(1, 1, 4, 64, 128),
                            torch.zeros(1, 64, 4), chunk=64)


@pytest.mark.parametrize("bad", ["chunk", "P", "N", "dtype", "dt"])
def test_wrappers_refuse_what_the_kernels_cannot_take(bad):
    """Refused on the host, with the reason, before the device is asked
    for: a chunk past 256 or not dividing S, widths past the kernels',
    mixed dtypes, a non-f32 dt."""
    x, dt, A, Bm, Cm = _route_inputs(S=512)
    chunk = 64
    if bad == "chunk":
        chunk = 512
    elif bad == "P":
        x = torch.zeros(1, 512, 4, 128, dtype=torch.bfloat16)
    elif bad == "N":
        Bm = Cm = torch.zeros(1, 512, 1, 256, dtype=torch.bfloat16)
    elif bad == "dtype":
        Bm = Bm.float()
    else:
        dt = dt.bfloat16()
    with pytest.raises((ValueError, TypeError)):
        tkernel.ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk)


def test_entry_arguments_strides_and_route_flag():
    """The C entries get the nine (batch, step, head-or-group) strides of
    the views as they lie, with a size-1 dim given its dense stride (its
    index is always 0, and TMA wants a stride of a multiple of 16 bytes),
    and an explicit flag that forces the FMA kernel."""
    conv = torch.zeros(2, 64, 4 * 64 + 2 * 128, dtype=torch.bfloat16)
    x = conv[..., :256].reshape(2, 64, 4, 64)
    Bm = conv[..., 256:384].as_strided((2, 64, 1, 128), (64 * 512, 512, 7, 1),
                                       storage_offset=256)
    Cm = conv[..., 384:].reshape(2, 64, 1, 128)
    assert list(tkernel._strides(x, Bm, Cm)) == [
        64 * 512, 512, 64, 64 * 512, 512, 128, 64 * 512, 512, 128]
    assert tkernel._dims(x, Bm, 64, 8, False) == [2, 64, 4, 64, 1, 128, 64,
                                                  1, 8, 0]
    assert tkernel._dims(x.float(), Bm, 64, 0, True)[-3:] == [0, 0, 1]


def test_libraries_build_from_both_sources_and_the_headers(monkeypatch):
    """Each library is one nvcc of its f32 source (with the C entry) and
    its bf16 wgmma/TMA source, hashed with the Hopper headers they
    include; the bf16 sources issue wgmma and TMA copies and name the TPU
    kernel they replace."""
    calls = {}

    def fake(name, sources, headers=()):
        calls[name] = ([p.name for p in sources], [p.name for p in headers])
        raise RuntimeError("no nvcc here")

    monkeypatch.setattr(_build, "build_library", fake)
    tkernel._library.cache_clear()
    try:
        for name in ("ssd_fwd", "ssd_bwd"):
            with pytest.raises(RuntimeError, match="no nvcc"):
                tkernel._library(name)
    finally:
        tkernel._library.cache_clear()
    assert calls == {
        name: ([f"{name}.cu", f"{name}_sm90.cu"], ["sm90.cuh", "ssd_sm90.cuh"])
        for name in ("ssd_fwd", "ssd_bwd")}
    for name, line in (("ssd_fwd", 29), ("ssd_bwd", 61)):
        src = (tkernel.CSRC / f"{name}_sm90.cu").read_text()
        assert f"repro/kernels/ssd/kernel.py:{line}" in src
        assert '#include "ssd_sm90.cuh"' in src
        entry = (tkernel.CSRC / f"{name}.cu").read_text()
        assert f"{name}_sm90(" in entry
    header = (tkernel.CSRC / "ssd_sm90.cuh").read_text()
    assert '#include "sm90.cuh"' in header
    assert "cp.async.bulk.tensor.5d" in header
    assert all(h.is_file() for h in tkernel.HEADERS)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: without nvcc both libraries name it and raise."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert _build.find_nvcc() is None
    tkernel._library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        tkernel.build()
    for name in ("ssd_fwd", "ssd_bwd"):
        with pytest.raises(RuntimeError, match=f"{name}.*nvcc"):
            tkernel._library(name)
