"""ctypes binding of the hand-written Hopper flash-attention forward.

``flash_fwd`` launches ``csrc/flash_fwd.cu`` (which replaces the Pallas TPU
kernel ``repro/kernels/flash_attention/kernel.py::_fa_kernel``) on PyTorch's
current stream. It checks device, dtype, contiguity and shapes, allocates
the outputs with ``torch.empty``, and raises if the launch is refused.
``flash_fwd.launches`` counts the launches. The library is built from the
repository's source at first use (``repro_torch.kernels._build``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library():
    built = _build.build_library("flash_fwd", [SOURCE])
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


def build() -> _build.Built:
    """Build (or reuse) and load the kernel library; returns the build."""
    return _library()[0]


def _check(q, k, v):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel is forward only in this slice; its "
            "backward (dQ/dKV) kernels come with the training slice. Run "
            "serving under torch.inference_mode(), or use "
            "impl='reference' for a differentiable path.")
    if q.device.type != "cuda":
        raise RuntimeError(
            f"the flash-attention kernel needs CUDA tensors; got {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
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
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the "
                         "kernel reads them 16 bytes at a time)")


def flash_fwd(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, q_offset: int = 0):
    """q: (B,Sq,H,D); k, v: (B,Skv,KVH,D), contiguous, f32 or bf16, D in
    HEAD_DIMS. Returns (out (B,Sq,H,D) in q.dtype, lse (B,Sq,H) f32)."""
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
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0
