"""Kernel dispatch: which implementation of an op runs for a tensor.

``resolve`` is a pure function of the requested impl and the tensor's device
type; there is no tuning cache yet.

  requested      device   -> impl
  --------------------------------------
  "auto"         cuda     -> "kernel"     (the hand-written Hopper kernel)
  "auto"         cpu      -> "reference"  (the plain PyTorch version)
  "kernel"       cuda     -> "kernel"
  "kernel"       cpu      -> raises: a CUDA kernel has no CPU mode
  "reference"    any      -> "reference"
  "naive"        any      -> "naive"      (the oracle; tests)

On a CUDA tensor a kernel path launches its kernel or raises; nothing falls
back to the plain version.
"""
from __future__ import annotations

import torch

KERNEL_IMPLS = ("auto", "kernel", "reference", "naive")


def validate_impl(requested: str, where: str = "impl") -> str:
    """Raise a ValueError listing KERNEL_IMPLS for an unknown impl string."""
    if requested not in KERNEL_IMPLS:
        raise ValueError(
            f"unknown kernel impl {requested!r} for {where}; expected one "
            f"of {KERNEL_IMPLS}")
    return requested


def resolve(requested: str, device) -> str:
    """Map a requested impl to "kernel" | "reference" | "naive" for a
    tensor on ``device`` (a ``torch.device`` or its type string)."""
    validate_impl(requested)
    dev = torch.device(device).type
    if requested == "auto":
        return "kernel" if dev == "cuda" else "reference"
    if requested == "kernel" and dev != "cuda":
        raise RuntimeError(
            f"impl='kernel' needs a CUDA tensor; got one on {dev!r} (use "
            f"'auto' or 'reference' for the plain PyTorch version)")
    return requested


def require_device(device: str = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
