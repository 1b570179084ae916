#!/usr/bin/env python3
"""Compare sources of the bf16 flash-attention forward kernel on one card.

    python3 ab_flash_fwd.py [--routes[=NAME,...]] [VARIANT.cu ...]

Builds the ``flash_fwd`` library once with the repository's bf16 kernel
(``csrc/flash_fwd_sm90.cu``, named "main") and once with each VARIANT.cu in
its place (named by its stem), all nvcc runs started together, and prints
each build's ``-Xptxas -v`` lines and wgmma notes; a build that fails is
reported and left out. ``--routes`` adds variants made from the main
source by setting its constants (``--routes=a,b`` only those named) (written under ``build/``): the two-tile
CTA at odd G also at D 64 (``row_pair_d64``: kRowPairMinCols 64); a ring
of two stages also when Skv <= 64 (``ring2``: kShortRing 2); a K/V ring
of three stages (``stages3``); the pipelined loop at every head dim
(``pipe_all``: kPipeWideCols 64); D 192 and 256 on the serial loop of
the other head dims (``serial_wide``: kPipeWideCols 512); and D 64 asked for two
CTAs an SM, not five (``ctas2_d64``: kMinCtas64 2).

To hold a change against an earlier source, pass that source as a variant
(``git show <commit>:src/repro_torch/kernels/flash_attention/csrc/
flash_fwd_sm90.cu > results/var/old.cu``). Then, for each build: the bf16
cases of ``chip_smoke.py``'s forward grid against the plain version at
its bounds (a count of failing cases, and of those the build refuses to
launch); warm times at the main paths' shapes (internlm2's prefill and
phase 1, G 2; minicpm3's, zamba2's and deepseek's prefill and phase 1, G
1; gemma3's prefill in a global and a local layer and its phase 1, D 256,
G 4; whisper's encoder at its serving batch of 8 and its train batch of
128, its cross attention, G 1, non-causal, and its decoder at the train
batch; granite's prefill and phase 1, G 3), taken in turns (main,
variants, variants reversed, main) beside SDPA's in the same call, with
whether each build's out and lse equal main's bitwise; times with L2
flushed; and the host cost of one call of the C entry for bf16 against
f32. Needs a card; compare variants only within one run.
"""
from __future__ import annotations

import ctypes
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as smoke

# name: {constant: value} set in the main source
ROUTES = {"row_pair_d64": {"kRowPairMinCols": 64},
          "ring2": {"kShortRing": 2},
          "stages3": {"kStages": 3},
          "pipe_all": {"kPipeWideCols": 64},
          "serial_wide": {"kPipeWideCols": 512},
          "ctas2_d64": {"kMinCtas64": 2}}
# (label, shape, causal, window): the shapes the main paths give the
# forward
SHAPES = (
    ("internlm2 prefill", smoke.PREFILL_SHAPE, True, 0),
    ("internlm2 phase-1", smoke.TRAIN_SHAPE, True, 0),
    ("minicpm3 prefill", smoke.MINICPM_PREFILL_SHAPE, True, 0),
    ("minicpm3 phase-1", smoke.MINICPM_TRAIN_SHAPE, True, 0),
    ("zamba2 prefill", smoke.ZAMBA_PREFILL_SHAPE, True, 0),
    ("zamba2 phase-1", smoke.ZAMBA_TRAIN_SHAPE, True, 0),
    ("deepseek prefill", smoke.DEEPSEEK_PREFILL_SHAPE, True, 0),
    ("deepseek phase-1", smoke.DEEPSEEK_TRAIN_SHAPE, True, 0),
    ("gemma3 prefill, global", smoke.GEMMA_PREFILL_SHAPE, True, 0),
    ("gemma3 prefill, local", smoke.GEMMA_PREFILL_SHAPE, True,
     smoke.GEMMA_WINDOW),
    ("gemma3 phase-1", smoke.GEMMA_TRAIN_SHAPE, True, 0),
    ("whisper encoder", smoke.WHISPER_ENCODER_SHAPE, False, 0),
    ("whisper encoder, train batch", smoke.WHISPER_ENCODER_TRAIN_SHAPE,
     False, 0),
    ("whisper cross", smoke.WHISPER_CROSS_SHAPE, False, 0),
    ("whisper decoder, train batch",
     (smoke.WHISPER_TRAIN_BATCH,) + smoke.WHISPER_DECODER_SHAPE[1:], True,
     0),
    ("granite prefill", smoke.GRANITE_PREFILL_SHAPE, True, 0),
    ("granite phase-1", smoke.GRANITE_TRAIN_SHAPE, True, 0),
)


def _route_variant(name, main_src: Path) -> Path:
    text = main_src.read_text()
    for const, value in ROUTES[name].items():
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            smoke.fail(f"{main_src.name} has no single {const} constant")
    out = smoke.ROOT / "build" / "ab_flash_fwd" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def _load(built):
    lib = ctypes.CDLL(str(built.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fa_fwd.argtypes = ([ptr] * 5 + [i32] * 7 + [ctypes.c_float]
                           + [i32] * 3 + [ptr])
    lib.fa_fwd.restype = i32
    return lib


def _runner(lib, q, k, v, causal=True, window=0, q_offset=0):
    """A closure launching lib's fa_fwd on (q, k, v); returns (out, lse)."""
    import torch
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Sq, Skv, H, KVH, D,
            int(q.dtype == torch.bfloat16), D ** -0.5, int(causal), window,
            q_offset, torch.cuda.current_stream().cuda_stream)

    def run():
        err = lib.fa_fwd(*args)
        if err:   # a variant may refuse a shape (too much shared memory)
            raise RuntimeError(f"launch failed ({err})")
        return out, lse
    return run


def main(argv) -> None:
    smoke.phase_device()
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel, ops
    sources = {"main": kernel.SM90_SOURCE}
    for a in [a for a in argv if a.startswith("--routes")]:
        argv.remove(a)
        names = a.split("=", 1)[1].split(",") if "=" in a else ROUTES
        for name in names:
            sources[name] = _route_variant(name, kernel.SM90_SOURCE)
    sources.update({Path(p).stem: Path(p).resolve() for p in argv})
    with ThreadPoolExecutor(len(sources)) as pool:
        jobs = {n: pool.submit(_build.build_library, f"flash_fwd_ab_{n}",
                               [kernel.SOURCE, p], kernel.HEADERS)
                for n, p in sources.items()}
        built = {}
        for n, job in jobs.items():
            try:
                built[n] = job.result()
            except RuntimeError as e:
                if n == "main":
                    raise
                print(f"[{n}] build failed, left out: {e}", flush=True)
    libs = {}
    for n, b in built.items():
        fn = ""
        for line in b.log.splitlines():
            entry = re.search(r"(fa_fwd_sm90_kernelILi\d+ELi\d+E)", line)
            if "Compiling entry function" in line:
                fn = entry.group(1) if entry else ""
            elif fn and ("registers" in line or "spill" in line):
                print(f"[{n}] {fn}: {line.strip()}")
            elif re.search(r"C75\d\d", line):
                print(f"[{n}] {line.strip()}")
        libs[n] = _load(b)

    bad, refused = {n: 0 for n in libs}, {n: 0 for n in libs}
    cases = [c for c in smoke._grid() if c[1] == "bfloat16"]
    for i, (shape, dtype, causal, window, q_offset) in enumerate(cases):
        q, k, v = smoke._qkv(shape, torch.bfloat16, seed=i)
        ref, ref_lse = ops._blockwise_fwd(
            q, k, v, causal=causal, window=window, scale=None,
            q_offset=q_offset, chunk=512)
        bound = smoke.TOL[dtype] * (1 + ref.float().abs())
        for n, lib in libs.items():
            try:
                out, lse = _runner(lib, q, k, v, causal, window, q_offset)()
            except RuntimeError:
                refused[n] += 1
                continue
            ok = bool(((out.float() - ref.float()).abs() <= bound).all())
            ok &= bool(((lse - ref_lse).abs()
                        <= smoke.LSE_TOL * (1 + ref_lse.abs())).all())
            bad[n] += not ok
    for n in libs:
        print(f"[{n}] bf16 grid cases outside the bounds: {bad[n]} of "
              f"{len(cases)}; refused (launch failed): {refused[n]}",
              flush=True)

    order = list(libs) + list(libs)[::-1]
    for label, shape, causal, window in SHAPES:
        B, Sq, Skv, H, KVH, D = shape
        q, k, v = smoke._qkv(shape, torch.bfloat16, seed=7)
        runs = {n: _runner(lib, q, k, v, causal, window)
                for n, lib in libs.items()}
        want = [t.clone() for t in runs["main"]()]
        same = {}
        for n in libs:
            try:
                same[n] = all(torch.equal(g, w)
                              for g, w in zip(runs[n](), want))
            except RuntimeError:     # the build refuses the shape
                same[n] = "refused"
                del runs[n]
        warm = {n: [] for n in runs}
        for n in order:
            if n in runs:
                warm[n].append(smoke._device_ms(runs[n], 100))
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
        if window:   # a boolean mask: not SDPA's flash backend
            pos = torch.arange(Sq, device="cuda")
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)
        else:
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal)
        mask_name = (f"window {window}" if window
                     else "causal" if causal else "non-causal")
        print(f"[bitwise] {label} {shape} {mask_name}: out and lse equal to "
              f"main's: " + ", ".join(f"{n} {v}" for n, v in same.items()))
        print(f"[time] {label} {shape} {mask_name}"
              f" warm ms: " + ", ".join(
                  f"{n} {sum(t) / len(t):.4f} "
                  f"({' '.join(f'{x:.4f}' for x in t)})"
                  for n, t in warm.items())
              + f"; SDPA {smoke._device_ms(sdpa, 100):.4f}")
        print(f"[time] {label} L2 flushed ms: " + ", ".join(
            f"{n} {smoke._device_ms(runs[n], 30, flush=True):.4f}"
            for n in runs)
            + f"; SDPA {smoke._device_ms(sdpa, 30, flush=True):.4f}",
            flush=True)

    # host cost of one call of the C entry (a decode row: launch-bound)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = smoke._qkv((1, 1, 64, 16, 8, 128), dtype, seed=3)
        run = _runner(libs["main"], q, k, v, q_offset=63)
        for _ in range(50):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            run()
        us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(f"[host] {dtype}: {us:.1f} us a call of the C entry")


if __name__ == "__main__":
    main(sys.argv[1:])
