#!/usr/bin/env python3
"""Compare sources of the bf16 SSD intra-chunk kernels on one card.

    python3 ab_ssd.py [VARIANT.cu ...]

A VARIANT whose name holds "bwd" replaces ``csrc/ssd_bwd_sm90.cu`` in the
``ssd_bwd`` library, any other ``csrc/ssd_fwd_sm90.cu`` in ``ssd_fwd``.
Builds each library once with the repository's source ("main") and once
with each variant in its place (named by its stem), all nvcc runs started
together, and prints each build's ``-Xptxas -v`` lines. Then, for each
build, through the wrapper (``kernel.ssd_fwd`` / ``ssd_bwd``, its library
swapped in): the bf16-route cases of ``chip_smoke.py``'s SSD grid against
the plain versions at ``SSD_TOL`` and at their rounding points at
``SSD_ROUNDED_TOL`` (a count of failing cases), and device times at the
main paths' shapes (the serve prefill and SWAP phase 1 for the forward,
phase 1 for the backward), taken in turns (main, variants, variants
reversed, main) behind the sleep kernel. Needs a card; compare variants
only within one run.
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as smoke


def _case_errors(kernel, ops, bwd, args, cots, L):
    """Per-output (error against the f32 math, against the rounded plain
    version)."""
    if bwd:
        got = kernel.ssd_bwd(*args, *cots, chunk=L)
        want = ops._intra_chunk_bwd(*args, *cots, L)
        want_r = ops._intra_chunk_bwd(*args, *cots, L, rounded=True)
        names = ("dx", "ddt", "dA", "dB", "dC")
    else:
        got = kernel.ssd_fwd(*args, chunk=L)
        want = ops._intra_chunk(*args, L)
        want_r = ops._intra_chunk(*args, L, rounded=True)
        names = ("y", "states", "cum")
    return {n: (smoke._scaled_err(g, w), smoke._scaled_err(g, r))
            for n, g, w, r in zip(names, got, want, want_r)}


def main(argv) -> None:
    smoke.phase_device()
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import kernel, ops
    builds = {}                       # (library, build name) -> sources
    for lib in ("ssd_fwd", "ssd_bwd"):
        builds[lib, "main"] = kernel.sources(lib)
    for p in map(Path, argv):
        lib = "ssd_bwd" if "bwd" in p.stem else "ssd_fwd"
        builds[lib, p.stem] = [kernel.sources(lib)[0], p.resolve()]
    with ThreadPoolExecutor(len(builds)) as pool:
        jobs = {key: pool.submit(_build.build_library,
                                 f"{key[0]}_ab_{key[1]}", srcs,
                                 kernel.HEADERS)
                for key, srcs in builds.items()}
        built = {key: job.result() for key, job in jobs.items()}
    libs = {}
    real = kernel._library
    for key, b in built.items():
        for line in b.log.splitlines():
            if "sm90" in line or "registers" in line or "spill" in line:
                if "Function properties" not in line:
                    print(f"[{key[0]} {key[1]}] {line.strip()}")
        # the wrapper's own ctypes setup, on this build
        real.cache_clear()
        orig = _build.build_library
        _build.build_library = lambda *a, _b=b, **k: _b
        try:
            libs[key] = real(key[0])
        finally:
            _build.build_library = orig
    real.cache_clear()

    def use(key):
        kernel._library = lambda name, _l=libs[key]: _l

    for key in libs:
        use(key)
        bwd = key[0] == "ssd_bwd"
        bad, worst = 0, 0.0
        for i, (shape, L, dtype) in enumerate(smoke._ssd_grid()):
            args = smoke._ssd_inputs(shape, getattr(torch, dtype),
                                     seed=300 + i)
            if not kernel.sm90_route(args[0], args[3]):
                continue
            cots = smoke._ssd_cotangents(shape, L, seed=400 + i)
            errs = _case_errors(kernel, ops, bwd, args, cots, L)
            ok = all(e <= smoke.SSD_TOL and r <= smoke.SSD_ROUNDED_TOL[n]
                     for n, (e, r) in errs.items())
            bad += not ok
            worst = max([worst] + [e for e, _ in errs.values()])
            if not ok:
                print(f"[{key[0]} {key[1]}] case {i} {shape} L={L}: {errs}")
        print(f"[{key[0]} {key[1]}] route cases outside the bounds: {bad}; "
              f"worst against the f32 math {worst:.3e}", flush=True)

    shapes = {"ssd_fwd": (("serve prefill", smoke.SSD_SERVE_SHAPE),
                          ("training phase 1", smoke.SSD_TRAIN_SHAPE)),
              "ssd_bwd": (("training phase 1", smoke.SSD_TRAIN_SHAPE),)}
    for lib, cases in shapes.items():
        names = [n for (lb, n) in libs if lb == lib]
        order = names + names[::-1]
        for where, shape7 in cases:
            *shape, L = shape7
            args = smoke._ssd_inputs(tuple(shape), torch.bfloat16, seed=7)
            cots = smoke._ssd_cotangents(tuple(shape), L, seed=8)
            times = {n: [] for n in names}
            for n in order:
                use((lib, n))
                run = ((lambda: kernel.ssd_bwd(*args, *cots, chunk=L))
                       if lib == "ssd_bwd"
                       else (lambda: kernel.ssd_fwd(*args, chunk=L)))
                times[n].append(smoke._device_ms(run, 20))
            print(f"[{lib}] {where} {shape7}: " + ", ".join(
                f"{n} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                for n, ts in times.items()), flush=True)
            del args, cots
            torch.cuda.empty_cache()
    kernel._library = real


if __name__ == "__main__":
    main(sys.argv[1:])
