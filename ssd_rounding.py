#!/usr/bin/env python3
"""What the bf16 SSD kernels' rounding contract costs, measured on the CPU.

    PYTHONPATH=src python3 ssd_rounding.py

Over the bf16 cases of ``chip_smoke.py``'s SSD grid, at its sizes and with
its seeds' distributions (drawn here on the CPU), for every output of the
intra-chunk forward and backward, prints max |err| / max |ref| of

  * the plain versions at the kernels' rounding points
    (``ops._intra_chunk(..., rounded=True)``, ``_intra_chunk_bwd(...,
    rounded=True)``) against the plain f32 math: what the contract costs;
  * the same contract in f32 against the same contract in f64: what f32
    summation order alone moves, the scale of the card check's
    ``SSD_ROUNDED_TOL``.

The f64 runs take the plain versions as they are, with ``Tensor.float``
sending every tensor to f64 for their duration.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels.ssd import ops  # noqa: E402

NAMES = ("y", "states", "cum", "dx", "ddt", "dA", "dB", "dC")


@contextlib.contextmanager
def _in_f64():
    orig, dtype = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda self: self.double()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = orig
        torch.set_default_dtype(dtype)


def _inputs(shape, L, seed):
    B, S, H, P, G, N = shape
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g)
    x = mk(B, S, H, P).bfloat16()
    dt = torch.nn.functional.softplus(mk(B, S, H))
    A = -torch.exp(mk(H))
    args = (x, dt, A, mk(B, S, G, N).bfloat16(), mk(B, S, G, N).bfloat16())
    return args, (mk(B, S, H, P), mk(B, S // L, H, P, N), mk(B, S, H))


def _outputs(args, cots, L, rounded):
    return (ops._intra_chunk(*args, L, rounded=rounded)
            + ops._intra_chunk_bwd(*args, *cots, L, rounded=rounded))


def _scaled(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def main() -> None:
    torch.set_num_threads(4)
    cost, order = {}, {}
    cases = [c for c in smoke._ssd_grid() if c[2] == "bfloat16"]
    for i, (shape, L, _) in enumerate(cases):
        args, cots = _inputs(shape, L, seed=300 + i)
        f32 = _outputs(args, cots, L, rounded=False)
        r32 = _outputs(args, cots, L, rounded=True)
        with _in_f64():
            r64 = _outputs(args, cots, L, rounded=True)
        route = shape[3] == 64 and shape[5] in (64, 128)
        for n, a, b, c in zip(NAMES, r32, f32, r64):
            key = (n, route)
            cost[key] = max(cost.get(key, 0.0), _scaled(a, b))
            order[key] = max(order.get(key, 0.0), _scaled(a, c))
    print(f"{len(cases)} bf16 cases of chip_smoke._ssd_grid(); max |err| / "
          f"max |ref| per output")
    for route in (True, False):
        print("bf16-route widths (P 64, N 64 or 128):" if route
              else "other widths (the contract does not run there):")
        for n in NAMES:
            print(f"  {n:6s} contract against the f32 math "
                  f"{cost[n, route]:.2e}; f32 against f64 of the contract "
                  f"{order[n, route]:.2e}")


if __name__ == "__main__":
    main()
