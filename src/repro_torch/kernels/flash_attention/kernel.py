"""ctypes bindings of the hand-written Hopper flash-attention kernels.

  * ``flash_fwd`` launches the ``flash_fwd`` library, which replaces the
    Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py::_fa_kernel``:
    bf16 inputs run ``csrc/flash_fwd_sm90.cu`` (wgmma tensor cores fed by
    TMA), f32 inputs the f32 FMA kernel of ``csrc/flash_fwd.cu``, which
    holds the C entry of both;
  * ``flash_bwd_dq`` and ``flash_bwd_dkv`` launch the ``flash_bwd``
    library, which replaces ``_fa_bwd_dq_kernel`` and ``_fa_bwd_dkv_kernel``:
    bf16 inputs run ``csrc/flash_bwd_sm90.cu`` (wgmma tensor cores fed by
    TMA, q * scale in bf16 as the bf16 forward takes it), f32 inputs the f32
    FMA kernels of ``csrc/flash_bwd.cu``, which holds the C entries of both;
  * ``flash_bwd_delta`` launches that library's ``fa_bwd_delta``, delta =
    rowsum(dO * O) in f32 from dO and O in their own dtype; it replaces no
    Pallas kernel (the JAX package forms delta in plain jnp) but the plain
    PyTorch chain ``bwd_delta``, which wrote an f32 product tensor and read
    it back;
  * ``flash_bwd_dqkv`` launches that library's ``fa_bwd_dqkv`` (in
    ``csrc/flash_bwd_sm90.cu``): dQ, dK and dV of bf16 inputs in one
    kernel where one key tile and one query tile hold the sequence
    (``takes_dqkv``: Sq and Skv <= 64). At D 256 and G in ``DQKV_GROUPS``
    (gemma3-1b's training shapes) one CTA a (batch, KV head) takes its G
    query heads in turn; at D 192 and G 1 (deepseek-v2-lite's MLA training
    shapes) persistent CTAs, one an SM, take (batch, head) items in turn,
    the item after next loading under this one's work, a warpgroup a
    product (dV, dK, dQ) over the whole D. It replaces both Pallas kernels
    there.

``flash_bwd`` runs delta, then dQ and dK/dV: on ``takes_dqkv``'s shapes
``flash_bwd_dqkv``, elsewhere ``flash_bwd_dq`` and ``flash_bwd_dkv``.

The two bf16 sources include ``csrc/sm90.cuh``, the Hopper helpers they
share, which each library lists as a header of its build. Both
directions take the head dims of ``FWD_HEAD_DIMS`` and ``BWD_HEAD_DIMS``:
64 and 128 (internlm2, qwen2.5, granite-moe, whisper-base, the smoke
configs), 96 (minicpm3-4b's MLA: qk 64 + 32, v padded to 96), 112
(zamba2-7b's shared attention block), 192 (deepseek-v2-lite's MLA: qk 128
+ 64, v padded to 192) and 256 (gemma3). D 96 and 112 run on D 128's
tiles, the columns past D zero-filled by TMA and never stored. D 192 and
256 have tilings of their own (one CTA an SM; dK/dV on warpgroups that
split the columns, three at 192 and two at 256; so does the dQ/dK/dV
kernel at 256).

Each launches on PyTorch's current stream, checks device, dtype,
contiguity and shapes, allocates its outputs with ``torch.empty``, raises if
the launch is refused, and counts its launches in ``<fn>.launches`` (those
on the bf16 wgmma route, bf16 inputs, also in ``<fn>.launches_sm90``). The
libraries are built from the repository's sources at first use
(``repro_torch.kernels._build``). The differentiable entry is
``ops.flash_attention`` (its autograd Function runs these kernels).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
SM90_SOURCE = SOURCE.with_name("flash_fwd_sm90.cu")
BWD_SOURCE = SOURCE.with_name("flash_bwd.cu")
BWD_SM90_SOURCE = SOURCE.with_name("flash_bwd_sm90.cu")
HEADERS = (SOURCE.with_name("sm90.cuh"),)
FWD_HEAD_DIMS = (64, 96, 112, 128, 192, 256)
BWD_HEAD_DIMS = (64, 96, 112, 128, 192, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the group sizes H / KVH of ``flash_bwd_dqkv`` at D 256: the query heads a
# CTA takes (at D 192 it takes G 1 only)
DQKV_GROUPS = (1, 2, 4, 8)


@functools.cache
def _library():
    built = _build.build_library("flash_fwd", [SOURCE, SM90_SOURCE],
                                 headers=HEADERS)
    lib = ctypes.CDLL(str(built.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fa_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr,          # q k v o lse
                           i32, i32, i32, i32, i32, i32,     # B Sq Skv H KVH D
                           i32, ctypes.c_float,              # dtype, scale
                           i32, i32, i32,                    # causal window q_offset
                           ptr]                              # stream
    lib.fa_fwd.restype = i32
    lib.fa_error_string.argtypes = [i32]
    lib.fa_error_string.restype = ctypes.c_char_p
    return built, lib


@functools.cache
def _bwd_library():
    built = _build.build_library("flash_bwd", [BWD_SOURCE, BWD_SM90_SOURCE],
                                 headers=HEADERS)
    lib = ctypes.CDLL(str(built.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [i32, i32, i32, i32, i32, i32,       # B Sq Skv H KVH D
              i32, ctypes.c_float,                # dtype, scale
              i32, i32, i32,                      # causal window q_offset
              ptr]                                # stream
    lib.fa_bwd_dq.argtypes = [ptr] * 7 + common   # q k v dO lse delta dq
    lib.fa_bwd_dkv.argtypes = [ptr] * 8 + common  # ... dk dv
    lib.fa_bwd_dqkv.argtypes = [ptr] * 9 + common  # ... dq dk dv
    lib.fa_bwd_dq.restype = lib.fa_bwd_dkv.restype = i32
    lib.fa_bwd_dqkv.restype = i32
    lib.fa_bwd_delta.argtypes = [ptr, ptr, ptr,             # dO O delta
                                 ctypes.c_int64, i32, i32,  # rows D dtype
                                 ptr]                       # stream
    lib.fa_bwd_delta.restype = i32
    lib.fa_bwd_error_string.argtypes = [i32]
    lib.fa_bwd_error_string.restype = ctypes.c_char_p
    return built, lib


def build() -> _build.Built:
    """Build (or reuse) and load the forward library; returns the build."""
    return _library()[0]


def build_bwd() -> _build.Built:
    """Build (or reuse) and load the backward library; returns the build."""
    return _bwd_library()[0]


def _check(q, k, v, head_dims=FWD_HEAD_DIMS):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_fwd launches the kernel outside autograd; call "
            "ops.flash_attention, whose autograd Function runs the forward "
            "and backward kernels, for a differentiable call.")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v must all be float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Sq,H,D) and k, v (B,Skv,KVH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}")
    if D not in head_dims:
        raise ValueError(f"head dim {D} not supported by the kernel "
                         f"(supported: {head_dims})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the "
                         "kernels read them 16 bytes at a time, or by TMA)")
    if q.device.type != "cuda":
        raise RuntimeError(
            f"the flash-attention kernel needs CUDA tensors; got {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_fwd(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, q_offset: int = 0):
    """q: (B,Sq,H,D); k, v: (B,Skv,KVH,D), contiguous, f32 or bf16, D in
    FWD_HEAD_DIMS. Returns (out (B,Sq,H,D) in q.dtype, lse (B,Sq,H) f32)."""
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    if B == 0 or Sq == 0:
        return out, lse
    _, lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(),
                         B, Sq, Skv, H, KVH, D, _DTYPES[q.dtype], scale,
                         int(bool(causal)), int(window), int(q_offset),
                         stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: "
                           f"{lib.fa_error_string(err).decode()} ({err})")
    _count(flash_fwd, q)
    return out, lse


def _count(fn, q):
    fn.launches += 1
    fn.launches_sm90 += int(q.dtype == torch.bfloat16)


flash_fwd.launches = flash_fwd.launches_sm90 = 0


def _check_bwd(q, k, v, do, lse, delta):
    """The backward's own checks, then ``_check``'s (the device last)."""
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (B,Sq,H) float32; got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("dO", do), ("lse", lse), ("delta", delta)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if do.data_ptr() % 16:
        raise ValueError("dO must start on a 16-byte boundary")
    _check(q, k, v, BWD_HEAD_DIMS)
    for name, t in (("dO", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device:
            raise ValueError(f"{name} must lie on {q.device}; got {t.device}")


def _bwd_args(q, k, scale, causal, window, q_offset):
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return [B, Sq, Skv, H, KVH, D, _DTYPES[q.dtype], scale,
            int(bool(causal)), int(window), int(q_offset), stream]


def _raise_if(err, lib, which):
    if err != 0:
        raise RuntimeError(f"flash-attention {which} kernel launch failed: "
                           f"{lib.fa_bwd_error_string(err).decode()} ({err})")


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 window: int = 0, scale: float | None = None,
                 q_offset: int = 0):
    """dQ (B,Sq,H,D) in q.dtype from q, k, v, dO, the forward's lse and
    delta = rowsum(dO * O), both (B,Sq,H) f32 and contiguous."""
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    if k.shape[1] == 0:
        return dq.zero_()
    _, lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.fa_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dq.data_ptr(),
                            *_bwd_args(q, k, scale, causal, window, q_offset))
    _raise_if(err, lib, "dQ")
    _count(flash_bwd_dq, q)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  window: int = 0, scale: float | None = None,
                  q_offset: int = 0):
    """(dK, dV), each (B,Skv,KVH,D) in k.dtype, summed over the query heads
    of each KV head."""
    _check_bwd(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0:
        return dk, dv
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    _, lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.fa_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             do.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             *_bwd_args(q, k, scale, causal, window,
                                        q_offset))
    _raise_if(err, lib, "dK/dV")
    _count(flash_bwd_dkv, q)
    return dk, dv


def _pow2_bf16(scale: float) -> bool:
    """Whether ``scale`` rounded to bf16 is a power of 2 (as the C entries'
    ``pow2_bf16``): then q * scale in bf16 is exact."""
    f = torch.tensor(scale, dtype=torch.bfloat16).item()
    return f > 0 and math.isfinite(f) and math.frexp(f)[0] == 0.5


def takes_dqkv(dtype, Sq: int, Skv: int, H: int, KVH: int, D: int,
               scale: float | None = None) -> bool:
    """Whether ``flash_bwd`` sends a backward of these shapes to
    ``flash_bwd_dqkv``: bf16 with one tile of queries and one of keys (1 <=
    Sq, Skv <= 64), and either D 256 with G = H / KVH in ``DQKV_GROUPS``
    and a scale (by default D ** -0.5, 1/16) that is a power of 2 in bf16,
    or D 192 at G 1 with any finite scale (by default 192 ** -0.5)."""
    scale = scale if scale is not None else D ** -0.5
    if not (dtype == torch.bfloat16 and 0 < Sq <= 64 and 0 < Skv <= 64
            and KVH > 0 and H % KVH == 0):
        return False
    if D == 256:
        return H // KVH in DQKV_GROUPS and _pow2_bf16(scale)
    return D == 192 and H == KVH and math.isfinite(scale)


def flash_bwd_dqkv(q, k, v, do, lse, delta, *, causal: bool = True,
                   window: int = 0, scale: float | None = None,
                   q_offset: int = 0):
    """(dQ, dK, dV) of bf16 inputs in one launch, on the shapes that
    ``takes_dqkv`` accepts; the arguments as ``flash_bwd_dq``'s. dK and dV
    sum the G query heads of each KV head in head order (at D 192, G 1,
    nothing is summed across heads), so the result repeats bitwise and a
    batch's bits do not depend on the others."""
    if q.dim() != 4 or k.dim() != 4 or not takes_dqkv(
            q.dtype, q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], scale):
        raise ValueError(
            f"flash_bwd_dqkv takes bfloat16 q (B,Sq,H,D) and k (B,Skv,KVH,D)"
            f" with 1 <= Sq, Skv <= 64, and at D 256 H / KVH in "
            f"{DQKV_GROUPS} and a power-of-2 scale, at D 192 H = KVH and a "
            f"finite scale; got q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)}, scale {scale}")
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.shape[0] == 0:
        return dq, dk, dv
    _, lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.fa_bwd_dqkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(),
                              dk.data_ptr(), dv.data_ptr(),
                              *_bwd_args(q, k, scale, causal, window,
                                         q_offset))
    _raise_if(err, lib, "dQ/dK/dV")
    _count(flash_bwd_dqkv, q)
    return dq, dk, dv


def bwd_delta(do, out):
    """delta = rowsum(dO * O) in f32, (B,Sq,H): the plain version of
    ``flash_bwd_delta``, as the JAX package forms it (its kernel.py:288). A
    bf16 O is promoted inside the product rather than copied to f32 first:
    the same values (each product of two bf16 values is exact in f32) with
    one f32 copy fewer."""
    return (do.float() * out).sum(-1)


def flash_bwd_delta(do, out):
    """delta = rowsum(dO * O) (B,Sq,H) f32 on the card, from dO and the
    forward's out, (B,Sq,H,D) contiguous, both f32 or both bf16, D in
    BWD_HEAD_DIMS. Sums in its own order: within 1e-6 of ``bwd_delta``
    relative to rowsum(|dO * O|)."""
    if out.shape != do.shape or out.dtype != do.dtype:
        raise ValueError(f"dO must match out {tuple(out.shape)} {out.dtype}; "
                         f"got {tuple(do.shape)} {do.dtype}")
    if do.dtype not in _DTYPES:
        raise TypeError(f"dO and out must be float32 or bfloat16; got "
                        f"{do.dtype}")
    if do.dim() != 4 or do.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {do.shape[-1]} of dO {tuple(do.shape)} "
                         f"not supported by the kernel (supported: "
                         f"{BWD_HEAD_DIMS})")
    for name, t in (("dO", do), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if do.device.type != "cuda":
        raise RuntimeError(f"the flash-attention kernel needs CUDA tensors; "
                           f"got {do.device}")
    if out.device != do.device:
        raise ValueError(f"out must lie on {do.device}; got {out.device}")
    delta = torch.empty(do.shape[:3], dtype=torch.float32, device=do.device)
    if delta.numel() == 0:
        return delta
    _, lib = _bwd_library()
    with torch.cuda.device(do.device):
        err = lib.fa_bwd_delta(do.data_ptr(), out.data_ptr(),
                               delta.data_ptr(), delta.numel(), do.shape[3],
                               _DTYPES[do.dtype],
                               torch.cuda.current_stream(do.device).cuda_stream)
    _raise_if(err, lib, "delta")
    _count(flash_bwd_delta, do)
    return delta


def flash_bwd(q, k, v, out, lse, do, *, causal: bool = True, window: int = 0,
              scale: float | None = None, q_offset: int = 0):
    """Flash backward on the card: (dq, dk, dv) in the input dtypes, from
    the forward's q, k, v, out and lse and the output grad dO (all
    contiguous CUDA tensors, as ``flash_fwd`` takes them). After delta's
    kernel, one launch of ``flash_bwd_dqkv`` where ``takes_dqkv`` holds,
    else ``flash_bwd_dq`` and ``flash_bwd_dkv``."""
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out must match q {tuple(q.shape)} {q.dtype}; got "
                         f"{tuple(out.shape)} {out.dtype}")
    delta = flash_bwd_delta(do, out)
    kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
    if k.dim() == 4 and takes_dqkv(q.dtype, q.shape[1], k.shape[1],
                                   q.shape[2], k.shape[2], q.shape[3],
                                   scale):
        return flash_bwd_dqkv(q, k, v, do, lse, delta, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


flash_bwd_dq.launches = flash_bwd_dq.launches_sm90 = 0
flash_bwd_dkv.launches = flash_bwd_dkv.launches_sm90 = 0
flash_bwd_delta.launches = flash_bwd_delta.launches_sm90 = 0
flash_bwd_dqkv.launches = flash_bwd_dqkv.launches_sm90 = 0
