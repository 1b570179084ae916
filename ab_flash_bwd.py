#!/usr/bin/env python3
"""Compare sources of the bf16 flash-attention backward kernels on one card.

    python3 ab_flash_bwd.py [--occupancy] [--ring] [--fold] [--phases]
                            [VARIANT.cu ...]

Builds the ``flash_bwd`` library once with the repository's bf16 kernels
(``csrc/flash_bwd_sm90.cu``, named "main") and once with each VARIANT.cu
in its place (named by its stem), all nvcc runs started together, and
prints each build's ``-Xptxas -v`` lines and wgmma notes for its sm90
kernels; a build that fails is reported and left out. The flags add
variants made from the main source by setting its constants (written
under ``build/ab_flash_bwd/``):

* ``--occupancy``: the dQ kernel's other CTA shapes from D 96 to 128 (the
  main one: one warpgroup a CTA, three CTAs an SM, a K/V ring of one
  stage): two warpgroups a CTA, one CTA an SM, a ring of two
  (``dq_2wg_1cta``), and one warpgroup asked for two CTAs an SM with a ring
  of two (``dq_1wg_2cta``); at D 64, dQ at three CTAs an SM instead of four
  (``dq64_3cta``) and the folded dK/dV loop at two instead of three
  (``dkv64_fold2cta``);
* ``--ring``: the rings at D 64 at other depths: dQ's K/V ring
  (``kDq64Stages``, one stage in the main source) of two and three
  (``dq64_ring2``, ``dq64_ring3``), and the folded dK/dV loop's Q/dO ring
  (``kFoldStages``, two) of three and four (``dkv64_ring3`` ...);
* ``--fold``: the dK/dV kernel at D 64 without its folded loop
  (``dkv_inplace``: the loop of the other head dims, q * scale in place
  each iteration);
* ``--phases``: after the comparison, the main source built once more
  with ``DQKV_PROF`` defined (``build/ab_flash_bwd/phases.cu``), and the
  SM clocks an item that each warpgroup of the D-192 dQ/dK/dV kernel spends
  in each phase between its stamps, at deepseek-v2-lite's phase-1 and
  phase-2 shapes (a mean over every CTA's items; the stamps are in the
  kernel's comment).

To hold a change against an earlier source, pass that source as a variant
(``git show <commit>:src/repro_torch/kernels/flash_attention/csrc/
flash_bwd_sm90.cu > results/var/old.cu``). Then, for each build: the bf16
cases of ``chip_smoke.py``'s backward grid against the plain version's f32
math and against it at the kernels' rounding points, at chip_smoke's
bounds (a count of failing cases), and its dQ and dK/dV kernels' outputs
against main's, bitwise (a count of equal cases); the dQ/dK/dV kernel
likewise on the cases ``kernel.takes_dqkv`` sends to it, in the builds
whose entry takes them (a source from before it has none; one from before
its D-192 route refuses D 192); and device times of the
dQ and dK/dV kernels and, where it takes the shape, the dQ/dK/dV kernel,
taken in turns (main, variants, variants reversed, main), beside the
library's fused backward timed alone in the same call, at the phase-1 and
phase-2 training shapes of internlm2-1.8b (D 128), of gemma3-1b (D 256,
G 4) and of deepseek-v2-lite (MLA, D 192, G 1: both the dQ/dK/dV kernel's),
granite-moe's phase 1 (D 64, G 3), and whisper-base's encoder (D 64, G 1,
non-causal over 1500 frames) at its train batch of 128 and its serving
batch of 8; at the four internlm2 and deepseek S-64 shapes also each
build's delta kernel (``fa_bwd_delta``, which ``kernel.flash_bwd`` runs)
beside the plain-PyTorch forms of delta = rowsum(dO * O), timed in turns,
with their largest difference. Needs a card; compare variants only within
one run.
"""
from __future__ import annotations

import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as smoke

# flag: {variant: {constant of the main source: value}}
CONST_VARIANTS = {
    "--occupancy": {
        "dq_2wg_1cta": {"kDqHeads": 2, "kDqMinBlocks": 1, "kDqStages": 2},
        "dq_1wg_2cta": {"kDqHeads": 1, "kDqMinBlocks": 2, "kDqStages": 2},
        "dq64_3cta": {"kDq64MinBlocks": 3},
        "dkv64_fold2cta": {"kFoldMinBlocks": 2}},
    "--ring": {**{f"dq64_ring{n}": {"kDq64Stages": n} for n in (2, 3)},
               **{f"dkv64_ring{n}": {"kFoldStages": n} for n in (3, 4)}},
    "--fold": {"dkv_inplace": {"kFolded": "false"}},
}
# (label, shape, causal, timed launches): the S-64 training shapes, then
# whisper-base's encoder at its train and serving batch; gemma3's last
SHAPES = (("phase-1", smoke.TRAIN_SHAPE, True, 100),
          ("phase-2", (32,) + smoke.TRAIN_SHAPE[1:], True, 100),
          ("deepseek phase-1", smoke.DEEPSEEK_TRAIN_SHAPE, True, 100),
          ("deepseek phase-2", (32,) + smoke.DEEPSEEK_TRAIN_SHAPE[1:], True,
           100),
          ("granite phase-1", smoke.GRANITE_TRAIN_SHAPE, True, 100),
          ("whisper encoder", smoke.WHISPER_ENCODER_TRAIN_SHAPE, False, 20),
          ("whisper encoder", smoke.WHISPER_ENCODER_SHAPE, False, 100),
          ("gemma3 phase-1", smoke.GEMMA_TRAIN_SHAPE, True, 100),
          ("gemma3 phase-2", smoke.GEMMA_PHASE2_SHAPE, True, 100))
DELTA_SHAPES = 4          # delta's forms at the first four
# what each warpgroup of the D-192 dQ/dK/dV kernel does between its stamps
# (--phases); phase 0 is the wait at the item's first barrier
PHASES = (("(0)", "tiles in", "q scaled", "S^T, P^T written", "(P)",
           "dV", "dV staged"),
          ("(0)", "tiles in", "dP^T", "(P)", "dS^T, dS written", "dK",
           "dK staged"),
          ("(0)", "store, refill, tiles in", "(D)", "dQ", "dQ staged"))


def _const_variant(name, values, main_src: Path):
    """The main source with ``values`` for its constants, or None where
    they already hold there."""
    text = main_src.read_text()
    same = True
    for const, value in values.items():
        pat = rf"constexpr (int|bool) {const} = (\w+);"
        found = re.findall(pat, text)
        if len(found) != 1:
            smoke.fail(f"{main_src.name} has no single {const} constant")
        same = same and found[0][1] == str(value)
        text = re.sub(pat, rf"constexpr \g<1> {const} = {value};", text)
    if same:
        return None
    out = smoke.ROOT / "build" / "ab_flash_bwd" / f"{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def _load(built):
    lib = ctypes.CDLL(str(built.path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [i32] * 7 + [ctypes.c_float] + [i32] * 3 + [ptr]
    lib.fa_bwd_dq.argtypes = [ptr] * 7 + common
    lib.fa_bwd_dkv.argtypes = [ptr] * 8 + common
    lib.fa_bwd_dq.restype = lib.fa_bwd_dkv.restype = i32
    lib.fa_bwd_delta.argtypes = [ptr] * 3 + [ctypes.c_int64, i32, i32, ptr]
    lib.fa_bwd_delta.restype = i32
    if hasattr(lib, "fa_bwd_dqkv"):     # not in a source from before it
        lib.fa_bwd_dqkv.argtypes = [ptr] * 9 + common
        lib.fa_bwd_dqkv.restype = i32
    return lib


def _runners(lib, q, k, v, do, lse, delta, causal=True, window=0,
             q_offset=0):
    """Closures launching lib's dQ, dK/dV and dQ/dK/dV kernels; they return
    dq, (dk, dv) and (dq, dk, dv). The third is None where lib has no
    dQ/dK/dV kernel or it does not take the shape: ``kernel.takes_dqkv``
    refuses it, or lib's entry does (a source from before D 192 took it
    returns an error there and launches nothing)."""
    import torch
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tail = (B, Sq, Skv, H, KVH, D, 1, D ** -0.5, int(causal), window,
            q_offset, torch.cuda.current_stream().cuda_stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())

    def run_dq():
        err = lib.fa_bwd_dq(*ins, dq.data_ptr(), *tail)
        if err:
            smoke.fail(f"dQ launch failed ({err})")
        return dq

    def run_dkv():
        err = lib.fa_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail)
        if err:
            smoke.fail(f"dK/dV launch failed ({err})")
        return dk, dv

    def run_dqkv():
        err = lib.fa_bwd_dqkv(*ins, dq.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(), *tail)
        if err:
            smoke.fail(f"dQ/dK/dV launch failed ({err})")
        return dq, dk, dv
    from repro_torch.kernels.flash_attention.kernel import takes_dqkv
    fused = (hasattr(lib, "fa_bwd_dqkv")
             and takes_dqkv(q.dtype, Sq, Skv, H, KVH, D)
             and lib.fa_bwd_dqkv(*ins, dq.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), *tail) == 0)
    return run_dq, run_dkv, run_dqkv if fused else None


def _phases(main_src: Path) -> None:
    """``--phases``: the main source with DQKV_PROF, its per-phase clocks."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel
    src = smoke.ROOT / "build" / "ab_flash_bwd" / "phases.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text("#define DQKV_PROF\n" + main_src.read_text())
    lib = _load(_build.build_library("flash_bwd_ab_phases",
                                     [kernel.BWD_SOURCE, src],
                                     kernel.HEADERS))
    lib.dqkv_prof.argtypes = [ctypes.c_void_p]
    lib.dqkv_prof.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * 24)()
    for label, shape in (("deepseek phase-1", smoke.DEEPSEEK_TRAIN_SHAPE),
                         ("deepseek phase-2", smoke.DEEPSEEK_PHASE2_SHAPE)):
        q, k, v = smoke._qkv(shape, torch.bfloat16, seed=7)
        do = smoke._qkv(shape, torch.bfloat16, seed=8)[0]
        out, lse = kernel.flash_fwd(q, k, v)
        run = _runners(lib, q, k, v, do, lse, kernel.bwd_delta(do, out))[2]
        launches = 20
        for n in (3, launches):           # warm-up, then the counted runs
            lib.dqkv_prof(ctypes.cast(sums, ctypes.c_void_p))
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        if lib.dqkv_prof(ctypes.cast(sums, ctypes.c_void_p)):
            smoke.fail("reading the phase clocks failed")
        items = shape[0] * shape[3] * launches
        for w, names in enumerate(PHASES):
            clocks = [sums[8 * w + p] / items for p in range(len(names))]
            print(f"[phases] {label} {shape} warpgroup {w}: "
                  + ", ".join(f"{n} {c:.0f}" for n, c in zip(names, clocks))
                  + f"; {sum(clocks):.0f} SM clocks an item", flush=True)


def _clones(out):
    """A kernel's output, or its outputs, as a tuple of copies."""
    return tuple(t.clone() for t in (out if isinstance(out, tuple)
                                      else (out,)))


def _delta_forms(do, out, libs):
    """delta = rowsum(dO * O) in f32: each build's kernel, then plain-PyTorch
    forms. Each product of two bf16 values is exact in f32, so they differ
    by summation order only."""
    import torch
    B, Sq, H, D = do.shape
    delta = torch.empty((B, Sq, H), dtype=torch.float32, device=do.device)

    def kernel_form(lib):
        def run():
            err = lib.fa_bwd_delta(do.data_ptr(), out.data_ptr(),
                                   delta.data_ptr(), delta.numel(), D, 1,
                                   torch.cuda.current_stream().cuda_stream)
            if err:
                smoke.fail(f"delta launch failed ({err})")
            return delta
        return run
    return {
        **{f"kernel_{n}": kernel_form(lib) for n, lib in libs.items()},
        "two_casts": lambda: (do.float() * out.float()).sum(-1),
        "one_cast": lambda: (do.float() * out).sum(-1),
        "bmm_f32_out": lambda: torch.bmm(
            do.view(-1, 1, D), out.view(-1, D, 1),
            out_dtype=torch.float32).view(B, Sq, H),
    }


def main(argv) -> None:
    smoke.phase_device()
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel
    sources = {"main": kernel.BWD_SM90_SOURCE}
    phases = "--phases" in argv
    argv = [a for a in argv if a != "--phases"]
    for flag, variants in CONST_VARIANTS.items():
        if flag in argv:
            argv = [a for a in argv if a != flag]
            for name, values in variants.items():
                src = _const_variant(name, values, kernel.BWD_SM90_SOURCE)
                if src is not None:
                    sources[name] = src
    sources.update({Path(p).stem: Path(p).resolve() for p in argv})
    with ThreadPoolExecutor(len(sources)) as pool:
        jobs = {n: pool.submit(_build.build_library, f"flash_bwd_ab_{n}",
                               [kernel.BWD_SOURCE, p], kernel.HEADERS)
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
            entry = re.search(r"entry function '\S*?(fa_\w+_sm90_kernel\w*?)E"
                              r"v", line)
            if "Compiling entry function" in line:
                fn = entry.group(1) if entry else ""
            elif fn and ("registers" in line or "spill" in line):
                print(f"[{n}] {fn}: {line.strip()}")
            elif re.search(r"C75\d\d", line) and "bwd" in line:
                print(f"[{n}] {line.strip()}")
        libs[n] = _load(b)

    cases = [i for i, c in enumerate(smoke._bwd_grid()) if c[1] == "bfloat16"]
    bad = {n: 0 for n in libs}
    same = {n: 0 for n in libs}
    fused_bad = {n: 0 for n in libs}
    fused_cases = {n: 0 for n in libs}
    for i in cases:
        (q, k, v, out, lse, do), kw, want, want_r = smoke._bwd_case(i)
        delta = kernel.bwd_delta(do, out)
        kw.pop("scale")
        pair = {}
        for n, lib in libs.items():
            run_dq, run_dkv, run_dqkv = _runners(lib, q, k, v, do, lse,
                                                 delta, **kw)
            got = (run_dq().clone(), *(t.clone() for t in run_dkv()))
            torch.cuda.synchronize()
            bad[n] += not smoke._bwd_ok(
                smoke._bwd_errors(got, want, want_r), "bfloat16")
            pair[n] = got
            same[n] += all(torch.equal(g, w)
                           for g, w in zip(got, pair["main"]))
            if run_dqkv is not None:
                got = tuple(t.clone() for t in run_dqkv())
                torch.cuda.synchronize()
                fused_cases[n] += 1
                fused_bad[n] += not smoke._bwd_ok(
                    smoke._bwd_errors(got, want, want_r), "bfloat16")
    for n in libs:
        print(f"[{n}] bf16 backward grid cases outside the bounds: dQ and "
              f"dK/dV kernels {bad[n]} of {len(cases)}, their outputs "
              f"bitwise main's in {same[n]}; dQ/dK/dV kernel "
              f"{fused_bad[n]} of the {fused_cases[n]} it takes",
              flush=True)

    order = list(libs) + list(libs)[::-1]
    for si, (label, shape, causal, iters) in enumerate(SHAPES):
        q, k, v = smoke._qkv(shape, torch.bfloat16, seed=7)
        do = smoke._qkv(shape, torch.bfloat16, seed=8)[0]
        out, lse = kernel.flash_fwd(q, k, v, causal=causal)
        delta = kernel.bwd_delta(do, out)
        runs = {n: _runners(lib, q, k, v, do, lse, delta, causal=causal)
                for n, lib in libs.items()}
        # each build's dq, dk, dv against main's, bitwise: the dQ and dK/dV
        # kernels', and the dQ/dK/dV kernel's against main's own
        mask = "causal" if causal else "non-causal"
        for which, idx in (("dQ and dK/dV", slice(0, 2)),
                           ("dQ/dK/dV", slice(2, 3))):
            outs = {n: sum((_clones(f()) for f in r[idx]), ())
                    for n, r in runs.items() if None not in r[idx]}
            if "main" not in outs:
                continue
            same = {n: all(torch.equal(g, w) for g, w in zip(o, outs["main"]))
                    for n, o in outs.items()}
            print(f"[bitwise] {label} {shape} {mask} {which}: dq, dk, dv "
                  f"equal to main's in " + ", ".join(
                      f"{n} {'yes' if e else 'NO'}" for n, e in same.items()),
                  flush=True)
        for which, idx in (("dQ", 0), ("dK/dV", 1), ("dQ/dK/dV", 2)):
            have = [n for n in order if runs[n][idx] is not None]
            if not have:
                continue
            times = {n: [] for n in dict.fromkeys(have)}
            for n in have:
                times[n].append(smoke._device_ms(runs[n][idx], iters))
            print(f"[time] {label} {shape} {mask} {which} ms: " + ", ".join(
                f"{n} {sum(t) / len(t):.4f} ({' '.join(f'{x:.4f}' for x in t)})"
                for n, t in times.items()), flush=True)
        B, Sq, Skv, H, KVH, D = shape
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
        kt.requires_grad_()
        vt.requires_grad_()
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = smoke._device_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True), iters)
        del o
        print(f"[time] {label} {shape} {mask} library backward alone (dq, "
              f"dk, dv): {lib_ms:.4f} ms", flush=True)
        if si >= DELTA_SHAPES:
            continue
        forms = _delta_forms(do, out, libs)
        ref = forms["two_casts"]()
        times = {n: [] for n in forms}
        for n in list(forms) + list(forms)[::-1]:
            times[n].append(smoke._device_ms(forms[n], 100))
        print(f"[delta] {label} {shape} ms: " + ", ".join(
            f"{n} {sum(t) / len(t):.4f} (max |diff| "
            f"{smoke._rel_err(forms[n](), ref):.2e})"
            for n, t in times.items()), flush=True)
    if phases:
        _phases(kernel.BWD_SM90_SOURCE)


if __name__ == "__main__":
    main(sys.argv[1:])
