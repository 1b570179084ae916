"""ctypes bindings of the hand-written Hopper SSD intra-chunk kernels.

  * ``ssd_fwd`` launches ``csrc/ssd_fwd.cu``, which replaces the Pallas TPU
    kernel ``repro/kernels/ssd/kernel.py::_ssd_chunk_kernel``;
  * ``ssd_bwd`` launches ``csrc/ssd_bwd.cu``, which replaces
    ``_ssd_chunk_bwd_kernel``, and sums its per-head dB/dC over the heads
    of each group and its dA over (batch, chunk) in plain PyTorch, as
    ``ssd_chunk_pallas_bwd`` does around its kernel.

x (B,S,H,P) and Bm, Cm (B,S,G,N) are f32 or bf16 and may be strided views
(the model's slices of its conv output): the kernels read them in place
through their strides, which the wrappers pass; only the last dim must be
contiguous. dt (B,S,H) and A (H,) are f32. Each wrapper launches on
PyTorch's current stream, checks device, dtype, shape and strides, allocates
its outputs with ``torch.empty``, raises if the launch is refused, and
counts its launches in ``<fn>.launches``. The libraries are built from the
repository's sources at first use (``repro_torch.kernels._build``). The
differentiable entry is ``ops.ssd_scan`` (its autograd Function
``SSDIntraChunk`` runs both kernels).
"""
from __future__ import annotations

import ctypes
import functools
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# pointer arguments of each entry point, before its 8 ints (batch S H P G N
# L dtype) and its (strides, stream)
_POINTERS = {"ssd_fwd": 8,     # x dt A B C y states cum
             "ssd_bwd": 13}    # x dt A B C dy dS dcum dx ddt db dc da


@functools.cache
def _library(name: str):
    """Build (or reuse) and load ``csrc/<name>.cu``; returns (build, entry
    point, error-string function)."""
    built = _build.build_library(name, [CSRC / f"{name}.cu"])
    lib = ctypes.CDLL(str(built.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    fn.argtypes = [ptr] * _POINTERS[name] + [i32] * 8 + [ptr, ptr]
    fn.restype = i32
    lib.ssd_error_string.argtypes = [i32]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return built, fn, lib.ssd_error_string


def build() -> list[_build.Built]:
    """Build (or reuse) and load the forward and backward libraries, one
    nvcc each, started together; returns their builds."""
    with ThreadPoolExecutor(len(_POINTERS)) as pool:
        return [b for b, _, _ in pool.map(_library, _POINTERS)]


def _check(x, dt, A, Bm, Cm, chunk):
    if x.device.type != "cuda":
        raise RuntimeError(
            f"the SSD kernels need CUDA tensors; got {x.device}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, Bm and Cm must lie on one device")
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


def _strides(x, Bm, Cm):
    st = [x.stride(0), x.stride(1), x.stride(2), Bm.stride(0), Bm.stride(1),
          Bm.stride(2), Cm.stride(0), Cm.stride(1), Cm.stride(2)]
    return (ctypes.c_longlong * 9)(*st)


def _dims(x, Bm, chunk):
    Bsz, S, H, P = x.shape
    return [Bsz, S, H, P, Bm.shape[2], Bm.shape[3], chunk, _DTYPES[x.dtype]]


def ssd_fwd(x, dt, A, Bm, Cm, *, chunk: int):
    """Intra-chunk SSD on the card. Returns (y_intra (B,S,H,P), states
    (B,nc,H,P,N), cum (B,S,H)), all f32; S must be a multiple of chunk."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise RuntimeError(
            "ssd_fwd launches the kernel outside autograd; call ops.ssd_scan, "
            "whose autograd Function runs the forward and backward kernels, "
            "for a differentiable call.")
    _check(x, dt, A, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, S, H, P), **f32)
    states = torch.empty((Bsz, S // chunk, H, P, N), **f32)
    cum = torch.empty((Bsz, S, H), **f32)
    if y.numel() == 0:
        return y, states, cum
    _, launch, error_string = _library("ssd_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                     states.data_ptr(), cum.data_ptr(),
                     *_dims(x, Bm, chunk), _strides(x, Bm, Cm), stream)
    if err != 0:
        raise RuntimeError(f"SSD forward kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")
    ssd_fwd.launches += 1
    return y, states, cum


ssd_fwd.launches = 0


def ssd_bwd(x, dt, A, Bm, Cm, dy, dstates, dcum, *, chunk: int):
    """Backward of ``ssd_fwd`` on the card, from the cotangents dy
    (B,S,H,P), dstates (B,nc,H,P,N) and dcum (B,S,H), all f32 and
    contiguous. Returns (dx, ddt, dA, dBm, dCm) in f32, with dBm/dCm summed
    over the heads of each group and dA over (batch, chunk)."""
    _check(x, dt, A, Bm, Cm, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk
    for name, t, shape in (("dy", dy, (Bsz, S, H, P)),
                           ("dstates", dstates, (Bsz, nc, H, P, N)),
                           ("dcum", dcum, (Bsz, S, H))):
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {x.device}; got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, P), **f32)
    ddt = torch.empty((Bsz, S, H), **f32)
    db = torch.empty((Bsz, S, H, N), **f32)
    dc = torch.empty((Bsz, S, H, N), **f32)
    da = torch.empty((Bsz, H, nc), **f32)
    if dx.numel() == 0:
        return (dx, ddt, torch.zeros((H,), **f32),
                torch.zeros((Bsz, S, G, N), **f32),
                torch.zeros((Bsz, S, G, N), **f32))
    _, launch, error_string = _library("ssd_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     Bm.data_ptr(), Cm.data_ptr(), dy.data_ptr(),
                     dstates.data_ptr(), dcum.data_ptr(), dx.data_ptr(),
                     ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
                     da.data_ptr(), *_dims(x, Bm, chunk),
                     _strides(x, Bm, Cm), stream)
    if err != 0:
        raise RuntimeError(f"SSD backward kernel launch failed: "
                           f"{error_string(err).decode()} ({err})")
    ssd_bwd.launches += 1
    rep = H // G
    return (dx, ddt, da.sum((0, 2)),
            db.reshape(Bsz, S, G, rep, N).sum(3),
            dc.reshape(Bsz, S, G, rep, N).sum(3))


ssd_bwd.launches = 0
