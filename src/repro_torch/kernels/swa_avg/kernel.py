"""ctypes binding of the hand-written Hopper streaming-average kernel.

``running_average`` launches ``csrc/swa_avg.cu`` (which replaces the Pallas
TPU kernel ``repro/kernels/swa_avg/kernel.py::_avg_kernel``) on PyTorch's
current stream: one launch per buffer, any length, bitwise equal to
``ref.running_average_ref``. It checks its arguments and raises on what the
kernel does not take, allocates the output with ``torch.empty`` unless
``out`` is given (``out`` may be ``avg`` itself: the update is
elementwise), and raises if the launch is refused.
``running_average.launches`` counts the launches. The library is built from
the repository's source at first use (``repro_torch.kernels._build``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "swa_avg.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library():
    built = _build.build_library("swa_avg", [SOURCE])
    lib = ctypes.CDLL(str(built.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swa_avg.argtypes = [ptr, ptr, ptr, ctypes.c_int64, ctypes.c_float,
                            i32, i32, i32, ptr]
    lib.swa_avg.restype = i32
    lib.swa_avg_error_string.argtypes = [i32]
    lib.swa_avg_error_string.restype = ctypes.c_char_p
    return built, lib


def build() -> _build.Built:
    """Build (or reuse) and load the kernel library; returns the build."""
    return _library()[0]


@functools.cache
def _max_blocks(index: int) -> int:
    return 16 * torch.cuda.get_device_properties(index).multi_processor_count


def running_average(avg, w, n, *, out=None):
    """avg + (w - avg) / (n + 1) on the card. avg (and out): f32 or bf16;
    w: f32 or bf16, same shape; all contiguous CUDA tensors on one device.
    Returns ``out`` (a new tensor unless given)."""
    if avg.device.type != "cuda":
        raise RuntimeError(
            f"the streaming-average kernel needs CUDA tensors; got "
            f"{avg.device}")
    if avg.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"avg and w must be float32 or bfloat16; got "
                        f"{avg.dtype}, {w.dtype}")
    if w.shape != avg.shape or w.device != avg.device:
        raise ValueError(f"w {tuple(w.shape)} on {w.device} must match avg "
                         f"{tuple(avg.shape)} on {avg.device}")
    if not (avg.is_contiguous() and w.is_contiguous()):
        raise ValueError("avg and w must be contiguous")
    if out is None:
        out = torch.empty_like(avg)
    elif (out.shape != avg.shape or out.dtype != avg.dtype
          or out.device != avg.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like avg")
    if avg.numel() == 0:
        return out
    _, lib = _library()
    with torch.cuda.device(avg.device):
        stream = torch.cuda.current_stream(avg.device).cuda_stream
        err = lib.swa_avg(avg.data_ptr(), w.data_ptr(), out.data_ptr(),
                          avg.numel(), float(n), _DTYPES[avg.dtype],
                          _DTYPES[w.dtype], _max_blocks(avg.device.index),
                          stream)
    if err != 0:
        raise RuntimeError(f"streaming-average kernel launch failed: "
                           f"{lib.swa_avg_error_string(err).decode()} ({err})")
    running_average.launches += 1
    return out


running_average.launches = 0
