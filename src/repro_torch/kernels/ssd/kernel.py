"""ctypes bindings of the hand-written Hopper SSD intra-chunk kernels.

  * ``ssd_fwd`` launches the ``ssd_fwd`` library, which replaces the Pallas
    TPU kernel ``repro/kernels/ssd/kernel.py::_ssd_chunk_kernel``;
  * ``ssd_bwd`` launches the ``ssd_bwd`` library, which replaces
    ``_ssd_chunk_bwd_kernel``, and sums its dA over (batch, chunk) in plain
    PyTorch, as ``ssd_chunk_pallas_bwd`` does around its kernel.

Each library is built from two sources. bf16 x, B and C with P = 64 and
N in {64, 128} (mamba2-2.7b, the zamba2-7b mamba blocks) take the route of
``csrc/ssd_fwd_sm90.cu`` / ``csrc/ssd_bwd_sm90.cu``: every L x L and state
product on wgmma tensor cores, x, B and C brought by TMA, and what depends
on the group alone (C.B^T, and in the backward dB and dC) formed once per
block of ``head_block(...)`` heads. Everything else (f32 inputs, other
widths) takes the f32 FMA kernels of ``csrc/ssd_fwd.cu`` /
``csrc/ssd_bwd.cu``, which hold the C entries of both routes and choose
between them by the same rule as ``sm90_route``. The bf16 route's backward
writes dB and dC once per head block, and the wrapper sums those partials
(none when one block covers the group); the f32 route writes them per head
and the wrapper sums them over each group's heads. Both sources of the
bf16 route include ``flash_attention/csrc/sm90.cuh`` (the Hopper helpers of
the flash kernels) and ``csrc/ssd_sm90.cuh``, listed as headers of both
builds.

x (B,S,H,P) and Bm, Cm (B,S,G,N) may be strided views (the model's slices
of its conv output): the kernels read them in place through their strides,
which the wrappers pass; only the last dim must be contiguous, and on the
bf16 route (TMA) every view must start on a 16-byte boundary and have
strides of a multiple of 16 bytes. dt (B,S,H) and A (H,) are f32. Each
wrapper launches on PyTorch's current stream, checks device, dtype, shape
and strides, allocates its outputs with ``torch.empty``, raises if the
launch is refused, and counts its launches in ``<fn>.launches`` and those
of the bf16 route also in ``<fn>.launches_sm90``. No route is taken
because the other failed. The libraries are built from the repository's
sources at first use (``repro_torch.kernels._build``). The differentiable
entry is ``ops.ssd_scan`` (its autograd Function ``SSDIntraChunk`` runs
both kernels).
"""
from __future__ import annotations

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
HEADERS = (CSRC.parents[1] / "flash_attention" / "csrc" / "sm90.cuh",
           CSRC / "ssd_sm90.cuh")
MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128
SM90_P, SM90_N = 64, (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# pointer arguments of each entry point, before its 10 ints (batch S H P G N
# L dtype head_block fma) and its (strides, stream)
_POINTERS = {"ssd_fwd": 8,     # x dt A B C y states cum
             "ssd_bwd": 14}    # x dt A B C dy dS dcum dx ddt db dc da scratch


def sources(name: str) -> list[Path]:
    """The two sources of library ``name``: the f32 route with the C entry,
    and the bf16 tensor-core route."""
    return [CSRC / f"{name}.cu", CSRC / f"{name}_sm90.cu"]


@functools.cache
def _library(name: str):
    """Build (or reuse) and load library ``name`` from ``sources(name)``;
    returns (build, entry point, error-string function)."""
    built = _build.build_library(name, sources(name), headers=HEADERS)
    lib = ctypes.CDLL(str(built.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    fn.argtypes = [ptr] * _POINTERS[name] + [i32] * 10 + [ptr, ptr]
    fn.restype = i32
    lib.ssd_error_string.argtypes = [i32]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return built, fn, lib.ssd_error_string


def build() -> list[_build.Built]:
    """Build (or reuse) and load the forward and backward libraries, one
    nvcc each, started together; returns their builds."""
    with ThreadPoolExecutor(len(_POINTERS)) as pool:
        return [b for b, _, _ in pool.map(_library, _POINTERS)]


def _check(x, dt, A, Bm, Cm, chunk) -> bool:
    """Raises on what the kernels do not take, the device last; returns
    whether the inputs take the bf16 route (``sm90_route``)."""
    if x.dtype not in _DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"x, Bm and Cm must all be float32 or bfloat16; got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, "
                        f"{A.dtype}")
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"expected x (B,S,H,P) and Bm, Cm (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (Bm.shape[:2] != x.shape[:2] or G < 1 or H % G
            or dt.shape != (Bsz, S, H) or A.shape != (H,)):
        raise ValueError(f"incompatible x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if not (1 <= chunk <= MAX_CHUNK) or S % chunk:
        raise ValueError(f"chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide S = {S}")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"head dim {P} / state dim {N} not supported by the "
                         f"kernels (at most {MAX_P} / {MAX_N})")
    if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("x, Bm and Cm must be contiguous in their last dim")
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("dt and A must be contiguous")
    if Bsz > 65535 or H > 65535:
        raise ValueError(f"batch {Bsz} or heads {H} above the grid limit")
    sm90 = sm90_route(x, Bm)
    if sm90:
        _check_tma(x, Bm, Cm)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"the SSD kernels need CUDA tensors; got {x.device}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, Bm and Cm must lie on one device")
    return sm90


def sm90_route(x, Bm) -> bool:
    """Whether (x, Bm) take the bf16 tensor-core route; the C entries
    choose by the same rule."""
    return (x.dtype == torch.bfloat16 and x.shape[3] == SM90_P
            and Bm.shape[3] in SM90_N)


def head_block(rep: int, chunk: int, bwd: bool) -> int:
    """Heads of one group that a CTA of the bf16 route takes, with C.B^T
    (and in the backward dB, dC) formed once for them: 8 in the forward; in
    the backward 16 / ceil(chunk / 64), so that its per-head sums of L
    floats stay within shared memory; never more than the group's ``rep``."""
    return min(rep, 16 // -(-chunk // 64) if bwd else 8)


def _check_tma(x, Bm, Cm):
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        bad = [d for d in range(3)
               if t.shape[d] > 1 and t.stride(d) * t.element_size() % 16]
        if t.data_ptr() % 16 or bad:
            raise ValueError(
                f"{name} {tuple(t.shape)} with strides {t.stride()} at "
                f"address {t.data_ptr():#x}: the bf16 SSD kernels read it by "
                f"TMA, which needs a 16-byte-aligned start and strides of a "
                f"multiple of 16 bytes")


def _strides(x, Bm, Cm):
    """The nine (batch, step, head-or-group) element strides of x, Bm and
    Cm; a dim of size 1 gets its contiguous stride (its index is always 0,
    and TMA still needs a stride of a multiple of 16 bytes)."""
    st = []
    for t in (x, Bm, Cm):
        inner = t.shape[3]
        dense = [t.shape[1] * t.shape[2] * inner, t.shape[2] * inner, inner]
        st += [t.stride(d) if t.shape[d] > 1 else dense[d] for d in range(3)]
    return (ctypes.c_longlong * 9)(*st)


def _dims(x, Bm, chunk, hb, fma):
    """The ints of an entry point: shapes, dtype, the bf16 route's head
    block, and whether to force the f32 FMA kernel."""
    Bsz, S, H, P = x.shape
    return [Bsz, S, H, P, Bm.shape[2], Bm.shape[3], chunk, _DTYPES[x.dtype],
            hb, int(fma)]


def ssd_fwd(x, dt, A, Bm, Cm, *, chunk: int, fma: bool = False):
    """Intra-chunk SSD on the card. Returns (y_intra (B,S,H,P), states
    (B,nc,H,P,N), cum (B,S,H)), all f32; S must be a multiple of chunk.
    ``fma``: run the f32 FMA kernel whatever the inputs (the card check
    times the kernel the bf16 route replaces)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise RuntimeError(
            "ssd_fwd launches the kernel outside autograd; call ops.ssd_scan, "
            "whose autograd Function runs the forward and backward kernels, "
            "for a differentiable call.")
    sm90 = _check(x, dt, A, Bm, Cm, chunk) and not fma
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, S, H, P), **f32)
    states = torch.empty((Bsz, S // chunk, H, P, N), **f32)
    cum = torch.empty((Bsz, S, H), **f32)
    if y.numel() == 0:
        return y, states, cum
    hb = head_block(H // G, chunk, bwd=False) if sm90 else 0
    _, launch, error_string = _library("ssd_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                     states.data_ptr(), cum.data_ptr(),
                     *_dims(x, Bm, chunk, hb, fma), _strides(x, Bm, Cm),
                     stream)
    if err != 0:
        raise RuntimeError(f"SSD forward kernel launch failed "
                           f"({'bf16 sm90' if sm90 else 'f32'} route): "
                           f"{error_string(err).decode()} ({err})")
    ssd_fwd.launches += 1
    ssd_fwd.launches_sm90 += sm90
    return y, states, cum


ssd_fwd.launches = 0
ssd_fwd.launches_sm90 = 0


def ssd_bwd(x, dt, A, Bm, Cm, dy, dstates, dcum, *, chunk: int,
            fma: bool = False):
    """Backward of ``ssd_fwd`` on the card, from the cotangents dy
    (B,S,H,P), dstates (B,nc,H,P,N) and dcum (B,S,H), all f32 and
    contiguous. Returns (dx, ddt, dA, dBm, dCm) in f32, with dBm/dCm summed
    over the heads of each group and dA over (batch, chunk). ``fma`` as in
    ``ssd_fwd``."""
    sm90 = _check(x, dt, A, Bm, Cm, chunk) and not fma
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = S // chunk
    for name, t, shape in (("dy", dy, (Bsz, S, H, P)),
                           ("dstates", dstates, (Bsz, nc, H, P, N)),
                           ("dcum", dcum, (Bsz, S, H))):
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {x.device}; got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    if sm90:
        if any(t.data_ptr() % 16 for t in (dy, dstates)):
            raise ValueError("dy and dstates must start on a 16-byte "
                             "boundary (the bf16 SSD backward reads them by "
                             "TMA)")
    f32 = dict(dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return (torch.empty((Bsz, S, H, P), **f32),
                torch.empty((Bsz, S, H), **f32), torch.zeros((H,), **f32),
                torch.zeros((Bsz, S, G, N), **f32),
                torch.zeros((Bsz, S, G, N), **f32))
    dx = torch.empty((Bsz, S, H, P), **f32)
    ddt = torch.empty((Bsz, S, H), **f32)
    da = torch.empty((Bsz, H, nc), **f32)
    if sm90:
        # dB, dC once per head block of each group; the CTAs of chunks of
        # more than one 64-row tile keep their score and dG o seg tiles in
        # the scratch (two caches of ceil(L / 64) tiles of 64 x 64 f32)
        hb = head_block(rep, chunk, bwd=True)
        parts = -(-rep // hb)
        db = torch.empty((parts, Bsz, S, G, N), **f32)
        dc = torch.empty((parts, Bsz, S, G, N), **f32)
        tiles = -(-chunk // 64)
        scratch = torch.empty(
            (Bsz * nc * G * parts * 2 * tiles * 4096 if tiles > 1 else 0,),
            **f32)
    else:
        hb = 0
        db = torch.empty((Bsz, S, H, N), **f32)
        dc = torch.empty((Bsz, S, H, N), **f32)
        scratch = torch.empty((0,), **f32)
    _, launch, error_string = _library("ssd_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
                     dstates.data_ptr(), dcum.data_ptr(), dx.data_ptr(),
                     ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
                     da.data_ptr(), scratch.data_ptr(),
                     *_dims(x, Bm, chunk, hb, fma), _strides(x, Bm, Cm),
                     stream)
    if err != 0:
        raise RuntimeError(f"SSD backward kernel launch failed "
                           f"({'bf16 sm90' if sm90 else 'f32'} route): "
                           f"{error_string(err).decode()} ({err})")
    ssd_bwd.launches += 1
    ssd_bwd.launches_sm90 += sm90
    if sm90:
        db, dc = (db[0], dc[0]) if parts == 1 else (db.sum(0), dc.sum(0))
    else:
        db = db.reshape(Bsz, S, G, rep, N).sum(3)
        dc = dc.reshape(Bsz, S, G, rep, N).sum(3)
    return dx, ddt, da.sum((0, 2)), db, dc


ssd_bwd.launches = 0
ssd_bwd.launches_sm90 = 0
