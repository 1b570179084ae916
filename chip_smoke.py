#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from the repository's sources,
   one nvcc per source, all started together;
3. kernels vs plain: hold each kernel against its plain PyTorch version on
   the card over a grid of shapes, dtypes and masks (the flash forward,
   the flash backward's dQ and dK/dV kernels, in bf16 also against the
   plain version at their own rounding points, the streaming average,
   bitwise, the SSD intra-chunk forward and backward), and time each at
   the shape the main path gives it, beside its bound, its plain version
   and a library call where one computes the same function (the flash
   forward, whose bf16 route is the wgmma kernel, at both the prefill and
   the phase-1 training shape, and at the prefill also with L2 flushed;
   the bf16 flash backward, the whole call and its delta at the phase-1
   and phase-2 training shapes, beside the library's backward alone);
4. full-width serve (internlm2-1.8b, random weights from a seed): a main
   path, with every kernel's launch count set to 0 just before it and read
   just after; then prefill logits with the kernel against the plain
   attention on the card (in f32) and against the f32 model (in bf16);
5. full-width SWAP training (``repro_torch.launch.train`` with --full
   --workers 2 and the elastic phase 3): the training main path, counted
   the same way; every kernel of the path must launch in it, losses and
   accuracies must be finite, and the elastic average must agree with the
   plain mean of the same phase-2 models;
6. smoke-width exactness in f32: continuous batching against
   single-request generation, token for token; whole-model gradients with
   the kernels against plain autograd; a whole SWAP run with the kernels
   against the same run on the plain versions;
7. phases 4-6 again for mamba2-2.7b (the ssm family, on the SSD kernels):
   serving at full width (64 layers), SWAP training at full width with the
   depth cut to 56 layers (MAMBA_TRAIN_LAYERS: 64 layers do not fit the
   card: 62 ran out of memory in phase 2), and the smoke exactness checks.

The line before the last is one JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s of
# the tensor cores by input type (f32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}       # out, as the JAX tests
LSE_TOL = 1e-4
# dq/dk/dv against the plain backward's f32 math: f32 at the JAX kernel
# tests' 2e-4. In bf16 both read the same bf16 inputs and sum in f32; they
# differ by summation order, by where dq/dk/dv round to bf16, and by the
# bf16 kernels' hi + lo pairs for P and dS, so the bound is 1e-2 (relative
# to 1 + |value|, about 2 bf16 ulp). The f32 math forms S as the forward
# that wrote lse formed it (scores_as_forward: q * scale in bf16 for bf16
# inputs, as the bf16 forward kernel takes it): with S from q * scale in
# f32, P = exp(S - lse) is not that forward's softmax (its rows miss 1 by
# up to ~3e-3 at D 128) and the gradient is another function's
BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}

# bf16 kernels against the plain backward at their own rounding points
# (ref.flash_attention_bwd_ref(..., rounded=True)), fed the same lse: the
# two round the same f32 sums, which differ only by summation order and
# ex2.approx against expf (~1e-6 relative; a hi + lo pair keeps P and dS to
# 2^-16 wherever hi lands), so an output may land one bf16 ulp away, plus
# 2^-12 of the tensor's largest value for the f32 sums; and those flips are
# rare, so the relative L2 error stays under 1e-3. A wrong descriptor,
# fragment index or mask moves values by O(1).
BWD_ROUNDED_ABS, BWD_ROUNDED_L2 = 2.0 ** -12, 1e-3
# whole-model grads in f32, held leaf by leaf: max |err| / max |ref| at the
# JAX attention-grad tests' 5e-4, and the relative L2 at 1e-5 (leaves of a
# smoke LM are ~1e-2, and the kernel's grads differ from plain autograd by
# summation order only, ~1e-6)
GRAD_TOL, GRAD_L2_TOL = 5e-4, 1e-5
PREFILL_SHAPE = (8, 512, 512, 16, 8, 128)        # B, Sq, Skv, H, KVH, D
ENGINE_PROMPTS = (37, 200, 513, 128)             # ServingEngine requests
# SWAP phase 1 of internlm2-1.8b at the launcher's batch and length
TRAIN_SHAPE = (256, 64, 64, 16, 8, 128)          # B, Sq, Skv, H, KVH, D
TRAIN_ARGV = ["--full", "--workers", "2", "--phase1-steps", "4",
              "--phase2-steps", "4", "--elastic-deadline", "30",
              "--device", "cuda"]
MAMBA = "mamba2-2.7b"
# SSD kernels against their plain versions: max |err| / max |ref|, the JAX
# SSD tests' 1e-4. Both compute in f32 from the same (f32 or bf16) inputs,
# so bf16 inputs are held to the same bound.
SSD_TOL = 1e-4
# (B, S, H, P, G, N, chunk): mamba2-2.7b's serving prefill (batch 8, prompt
# 512) and its SWAP phase 1 (batch 256, the launcher's sequence of 64)
SSD_SERVE_SHAPE = (8, 512, 80, 64, 1, 128, 256)
SSD_TRAIN_SHAPE = (256, 64, 80, 64, 1, 128, 64)
# 64 layers of mamba2-2.7b are 2.83 B parameters. On an H100 the training
# run's phase-3 peak was 53.10 GB at 40 layers and 68.54 GB at 56, 0.965 GB
# a layer, so 64 layers would need ~76.3 GB, over the 75 GB line of
# PERF.md. 62 layers (~74.3 GB by that slope) ran out of device memory all
# the same: a 6.25 GiB allocation of phase 2's update failed with 61.56 GiB
# allocated and 15.08 GiB reserved but free in pieces. 56 is the deepest
# that ran.
MAMBA_TRAIN_LAYERS = 56


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    # f32 products in full f32 on the card (no TF32), for the tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    print(card, flush=True)
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.swa_avg import kernel as swa_kernel
    builds = {"flash_fwd": kernel.build, "flash_bwd": kernel.build_bwd,
              "swa_avg": swa_kernel.build,
              "ssd": ssd_kernel.build}     # ssd_fwd and ssd_bwd, together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = {name: pool.submit(fn) for name, fn in builds.items()}
        done = {name: f.result() for name, f in done.items()}
    done.update(zip(("ssd_fwd", "ssd_bwd"), done.pop("ssd")))
    print(f"[build] {len(done)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for name, built in done.items():
        print(f"[build] {name}: {built.path.name}, nvcc "
              f"{built.seconds:.2f} s")
        for line in built.log.splitlines():
            if ("registers" in line or "smem" in line or "spill" in line
                    or "Function properties" in line):
                print(f"[build]   {line.strip()}")
    sys.stdout.flush()


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version, and its times
# ---------------------------------------------------------------------------


def _qkv(shape, dtype, seed):
    import torch
    B, Sq, Skv, H, KVH, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    return mk(B, Sq, H, D), mk(B, Skv, KVH, D), mk(B, Skv, KVH, D)


def _visible_pairs(Sq, Skv, causal, window, q_offset):
    import torch
    qpos = torch.arange(Sq) + q_offset
    kpos = torch.arange(Skv)
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return int(mask.sum())


def _cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _grid():
    cases = []
    for dtype in ("float32", "bfloat16"):
        for D in (64, 128):
            for G in (1, 2, 4):
                for causal, window in ((True, 0), (True, 16), (False, 0)):
                    cases.append(((2, 67, 67, 4, 4 // G, D), dtype, causal,
                                  window, 0))
        for D in (64, 128):
            cases += [
                ((2, 1, 64, 8, 4, D), dtype, True, 0, 63),       # decode row
                ((1, 33, 129, 4, 2, D), dtype, True, 0, 96),     # q_offset
                ((1, 33, 129, 4, 2, D), dtype, False, 0, 0),     # ragged Skv
                ((1, 40, 40, 4, 1, D), dtype, True, 16, 0),      # window
                ((1, 48, 48, 4, 2, D), dtype, True, 0, -8),      # empty rows
                ((1, 200, 200, 8, 2, D), dtype, True, 48, 0),    # tile skip
            ]
    # the shapes the main paths give the kernel: generate's batched
    # prefill, the engine's batch-1 prefills, and the training steps of
    # phase 1 (batch 256) and phase 2 (batch 32 per worker)
    cases.append((PREFILL_SHAPE, "bfloat16", True, 0, 0))
    for S in ENGINE_PROMPTS:
        cases.append(((1, S, S, 16, 8, 128), "bfloat16", True, 0, 0))
    cases.append((TRAIN_SHAPE, "bfloat16", True, 0, 0))
    cases.append(((32,) + TRAIN_SHAPE[1:], "bfloat16", True, 0, 0))
    return cases


def phase_kernel():
    import torch
    from repro_torch.kernels.flash_attention import kernel, ops
    worst, path_err = {}, {}
    for i, (shape, dtype, causal, window, q_offset) in enumerate(_grid()):
        q, k, v = _qkv(shape, getattr(torch, dtype), seed=i)
        kw = dict(causal=causal, window=window, scale=None,
                  q_offset=q_offset)
        out, lse = kernel.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = ops._blockwise_fwd(q, k, v, chunk=512, **kw)
        check(out.dtype == q.dtype and out.shape == q.shape
              and lse.shape == q.shape[:3], f"case {i}: output shape/dtype")
        check(bool(torch.isfinite(out).all()), f"case {i}: non-finite out")
        err = (out.float() - ref_out.float()).abs()
        bound = TOL[dtype] * (1 + ref_out.float().abs())
        check(bool((err <= bound).all()),
              f"case {i} {shape} {dtype} causal={causal} window={window} "
              f"q_offset={q_offset}: out max err {err.max().item():.3e}")
        lerr = (lse - ref_lse).abs()
        check(bool((lerr <= LSE_TOL * (1 + ref_lse.abs())).all()),
              f"case {i} {shape} {dtype}: lse max err {lerr.max().item():.3e}")
        if q_offset < 0:   # rows that see no key: out = 0 and lse = 0
            dead = slice(0, -q_offset)
            check(bool((out[:, dead] == 0).all() and (lse[:, dead] == 0).all()),
                  f"case {i}: fully masked rows are not out=0, lse=0")
        worst[dtype] = max(worst.get(dtype, 0.0), err.max().item())
        if shape in (PREFILL_SHAPE, TRAIN_SHAPE):   # the two main paths'
            path_err[shape] = err.max().item()
    print(f"[kernel] {len(_grid())} cases match the plain version; max |out "
          f"err| f32 {worst['float32']:.3e} bf16 {worst['bfloat16']:.3e}")

    # times at the two main paths' shapes: the internlm2-1.8b prefill, and
    # the phase-1 training step (48 launches a step with remat)
    prefill = _fwd_times(PREFILL_SHAPE, "prefill", seed=1234, cold=True)
    train = _fwd_times(TRAIN_SHAPE, "phase-1 training", seed=1235)
    sys.stdout.flush()
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
        "launches": None, "max_abs_err": path_err[PREFILL_SHAPE],
        **prefill,
        "train_shape": {"max_abs_err": path_err[TRAIN_SHAPE], **train},
    }


def _device_ms(fn, iters: int, flush: bool = False) -> float:
    """Mean device time of fn over iters launches. The launches are queued
    behind a ~50 ms sleep kernel, so that the host's cost of issuing fn
    (tens of microseconds of Python a call, more than a short kernel takes)
    does not show between the events. With flush, the 50 MB L2 is
    overwritten (a 256 MB write) before each launch and each launch is
    timed alone."""
    import torch
    fn()
    torch.cuda.synchronize()
    event = lambda: torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)        # GPU clock cycles
    if not flush:
        start, end = event(), event()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    events = [(event(), event()) for _ in range(iters)]
    for start, end in events:
        scrub.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _fwd_times(shape, label, seed, cold=False):
    """The bf16 forward's device time at one shape, warm (and, with cold,
    with L2 flushed), beside its bound, its plain version and SDPA, timed
    the same way."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ops
    B, Sq, Skv, H, KVH, D = shape
    q, k, v = _qkv(shape, torch.bfloat16, seed=seed)
    run = lambda: kernel.flash_fwd(q, k, v, causal=True)
    ms = _device_ms(run, 50)
    plain_ms = _cuda_ms(lambda: ops._blockwise_fwd(
        q, k, v, causal=True, window=0, scale=None, q_offset=0, chunk=512), 5)
    # yardstick only, never called by the port: one fused library call on
    # the same function (K/V heads repeated beforehand, outside the timing)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    lib_ms = _device_ms(sdpa, 50)
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + B * Sq * H * 4
    flops = 4 * D * B * H * _visible_pairs(Sq, Skv, True, 0, 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    times = {"shape": f"B{B} S{Sq} H{H} KVH{KVH} D{D} bf16 causal",
             "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": lib_ms}
    line = (f"[kernel] {label} shape {times['shape']}: kernel {ms:.4f} ms, "
            f"bound {max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} "
            f"MB, {flops / 1e9:.2f} GFLOP), plain {plain_ms:.4f} ms, library "
            f"{lib_ms:.4f} ms")
    if cold:
        times["ms_l2_flushed"] = _device_ms(run, 30, flush=True)
        times["library_ms_l2_flushed"] = _device_ms(sdpa, 30, flush=True)
        line += (f"; L2 flushed: kernel {times['ms_l2_flushed']:.4f} ms, "
                 f"library {times['library_ms_l2_flushed']:.4f} ms")
    print(line)
    return times


def _bwd_grid():
    cases = []
    for dtype in ("float32", "bfloat16"):
        for D in (64, 128):
            for G in (1, 2, 4):
                for causal, window in ((True, 0), (True, 16), (False, 0)):
                    cases.append(((2, 67, 67, 4, 4 // G, D), dtype, causal,
                                  window, 0))
            cases += [
                ((1, 33, 129, 4, 2, D), dtype, True, 0, 96),     # q_offset
                ((1, 33, 129, 8, 2, D), dtype, False, 0, 0),     # ragged Skv
                ((1, 48, 48, 4, 2, D), dtype, True, 0, -8),      # empty rows
                ((1, 200, 200, 8, 2, D), dtype, True, 48, 0),    # tile skip
                ((2, 131, 131, 4, 1, D), dtype, True, 0, -5),    # odd, empty
            ]
    # the shapes the training path gives it: phase 1 and phase 2
    cases.append((TRAIN_SHAPE, "bfloat16", True, 0, 0))
    cases.append(((32,) + TRAIN_SHAPE[1:], "bfloat16", True, 0, 0))
    return cases


def _rel_err(got, want):
    return ((got.float() - want.float()).abs()
            / (1 + want.float().abs())).max().item()


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits; 0 at 0)."""
    import torch
    m, e = torch.frexp(x.float())
    return torch.ldexp((m != 0).float(), e - 8)


def _bwd_case(i):
    """Case i of the backward grid on the card: (args of the kernels' call
    (q, k, v, out, lse, dO), the mask keywords, the plain version's f32
    math, and in bf16 the plain version at the kernels' rounding points,
    else None), all on the lse of the kernel's forward."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ref
    shape, dtype, causal, window, q_offset = _bwd_grid()[i]
    q, k, v = _qkv(shape, getattr(torch, dtype), seed=100 + i)
    do = _qkv(shape, getattr(torch, dtype), seed=200 + i)[0]
    kw = dict(causal=causal, window=window, scale=None, q_offset=q_offset)
    out, lse = kernel.flash_fwd(q, k, v, **kw)
    args = (q, k, v, out, lse, do)
    want = ref.flash_attention_bwd_ref(*args, scores_as_forward=True, **kw)
    want_r = None if dtype == "float32" else ref.flash_attention_bwd_ref(
        *args, rounded=True, **kw)
    return args, kw, want, want_r


def _bwd_errors(got, want, want_r):
    """Per output: max |err|/(1+|ref|) against the f32 math, and against
    the rounded plain version (bf16 only) the worst ratio to its elementwise
    bound (1 bf16 ulp + BWD_ROUNDED_ABS max|ref|) and the relative L2."""
    import torch
    errs = {}
    for name, g, w, wr in zip(("dq", "dk", "dv"), got, want,
                              want_r or (None,) * 3):
        e = {"rel": _rel_err(g, w)}
        if wr is not None:
            d = (g.float() - wr.float()).abs()
            bound = _bf16_ulp(wr) + BWD_ROUNDED_ABS * wr.float().abs().max()
            e["ratio"] = (d / bound).max().item()
            e["l2"] = (torch.linalg.vector_norm(d)
                       / torch.linalg.vector_norm(wr.float())).item()
        errs[name] = e
    return errs


def _bwd_ok(errs, dtype):
    return all(e["rel"] <= BWD_TOL[dtype] and e.get("ratio", 0) <= 1
               and e.get("l2", 0) <= BWD_ROUNDED_L2 for e in errs.values())


def phase_kernel_bwd():
    import torch
    from repro_torch.kernels.flash_attention import kernel
    worst, worst_r = {}, {"ratio": 0.0, "l2": 0.0}
    for i, (shape, dtype, causal, window, q_offset) in enumerate(_bwd_grid()):
        args, kw, want, want_r = _bwd_case(i)
        got = kernel.flash_bwd(*args, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"bwd case {i}: {name} shape/dtype")
            check(bool(torch.isfinite(g).all()),
                  f"bwd case {i}: non-finite {name}")
        errs = _bwd_errors(got, want, want_r)
        check(_bwd_ok(errs, dtype),
              f"bwd case {i} {shape} {dtype} causal={causal} window={window}"
              f" q_offset={q_offset}: {errs} (limits {BWD_TOL[dtype]} "
              f"against the f32 math; in bf16 ratio 1 and relative L2 "
              f"{BWD_ROUNDED_L2} against the rounded plain version)")
        for e in errs.values():
            worst[dtype] = max(worst.get(dtype, 0.0), e["rel"])
            for key in worst_r:
                worst_r[key] = max(worst_r[key], e.get(key, 0.0))
        if q_offset < 0:   # rows that see no key: dq = 0
            check(bool((got[0][:, :-q_offset] == 0).all()),
                  f"bwd case {i}: fully masked rows have dq != 0")
        if shape == TRAIN_SHAPE:
            train_err = {n: (g.float() - w.float()).abs().max().item()
                         for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    print(f"[kernel-bwd] {len(_bwd_grid())} cases match the plain version's "
          f"f32 math; max |err|/(1+|ref|) f32 {worst['float32']:.3e} (limit "
          f"{BWD_TOL['float32']}), bf16 {worst['bfloat16']:.3e} (limit "
          f"{BWD_TOL['bfloat16']}); bf16 against the plain version at the "
          f"kernels' rounding points: worst {worst_r['ratio']:.3f} of the "
          f"bound (1 bf16 ulp + {BWD_ROUNDED_ABS:.2e} max|ref|), relative L2 "
          f"{worst_r['l2']:.3e} (limit {BWD_ROUNDED_L2})")

    # times at the phase-1 training shape (the JSON rows) and phase 2's
    phase1 = _bwd_times(TRAIN_SHAPE, "phase-1")
    phase2 = _bwd_times((32,) + TRAIN_SHAPE[1:], "phase-2")
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_bwd_sm90.cu",
             "replaces": f"src/repro/kernels/flash_attention/kernel.py:{line}",
             "launches": None, "max_abs_err": err, **phase1[name],
             "phase2_shape": phase2[name]}
            for name, line, err in (
                ("flash_attention_bwd_dq", 202, train_err["dq"]),
                ("flash_attention_bwd_dkv", 232,
                 max(train_err["dk"], train_err["dv"])))]


def _bwd_times(shape, label):
    """Device times of the bf16 dQ and dK/dV kernels, of the whole
    ``kernel.flash_bwd`` call (delta included) and of delta alone
    (``kernel.bwd_delta``, plain PyTorch), each behind the sleep kernel,
    beside their bounds, the plain backward and the library's fused
    attention backward timed alone (one forward with its graph kept, then
    the backward again and again)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ref
    B, Sq, Skv, H, KVH, D = shape
    q, k, v = _qkv(shape, torch.bfloat16, seed=4321)
    do = _qkv(shape, torch.bfloat16, seed=4322)[0]
    out, lse = kernel.flash_fwd(q, k, v, causal=True)
    delta = kernel.bwd_delta(do, out)
    dq_ms = _device_ms(lambda: kernel.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   causal=True), 50)
    dkv_ms = _device_ms(lambda: kernel.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                     causal=True), 50)
    bwd_ms = _device_ms(lambda: kernel.flash_bwd(q, k, v, out, lse, do,
                                                 causal=True), 50)
    delta_ms = _device_ms(lambda: kernel.bwd_delta(do, out), 50)
    plain_ms = _cuda_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=True), 5)
    # yardstick only, never called by the port: the library's fused
    # attention backward alone, on K/V with their heads repeated beforehand
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    kt.requires_grad_()
    vt.requires_grad_()
    dot = do.transpose(1, 2).contiguous()
    o = sdpa(qt, kt, vt, is_causal=True)
    lib_ms = _device_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), dot, retain_graph=True), 50)
    del o
    pairs = _visible_pairs(Sq, Skv, True, 0, 0) * B * H
    elt = 2                                            # bf16
    read = (q.numel() * 2 + k.numel() + v.numel()) * elt \
        + 2 * B * Sq * H * 4                       # q, dO, k, v, lse, delta
    times = {}
    for name, ms, written, flops in (
            ("flash_attention_bwd_dq", dq_ms, q.numel() * elt, 6 * D * pairs),
            ("flash_attention_bwd_dkv", dkv_ms, 2 * k.numel() * elt,
             8 * D * pairs)):
        nbytes = read + written
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        print(f"[kernel-bwd] {label} {name} at B{B} S{Sq} H{H} KVH{KVH} D{D} "
              f"bf16 causal: kernel {ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), plain (dq, dk, dv together) "
              f"{plain_ms:.4f} ms, library backward alone (dq, dk, dv "
              f"together) {lib_ms:.4f} ms")
        times[name] = {"shape": f"B{B} S{Sq} H{H} KVH{KVH} D{D} bf16 causal",
                       "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations"),
                       "library_ms": lib_ms}
    # the whole backward: read q, out, dO, k, v, lse; write dq, dk, dv
    nbytes = 4 * (q.numel() + k.numel()) * elt + B * Sq * H * 4
    t_whole = max(nbytes / HBM_BYTES_PER_S,
                  10 * D * pairs / PEAK_FLOPS["bfloat16"]) * 1e3
    print(f"[kernel-bwd] {label} kernel.flash_bwd (delta, dQ, dK/dV): "
          f"{bwd_ms:.4f} ms, bound {t_whole * 1e3:.2f} us ({nbytes / 1e6:.1f}"
          f" MB), library backward alone {lib_ms:.4f} ms "
          f"({bwd_ms / lib_ms:.2f}x); delta's chain alone {delta_ms:.4f} ms",
          flush=True)
    for t in times.values():
        t.update(flash_bwd_ms=bwd_ms, flash_bwd_bound_ms=t_whole,
                 delta_ms=delta_ms)
    return times


def phase_swa_avg():
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.swa_avg import kernel, ref
    from repro_torch.models.model import Model
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n in (0, 1, 7):
            for size in (1, 8191, 8193, 92544 * 2048):   # last: the embedding
                g = torch.Generator(device="cuda").manual_seed(size + n)
                avg = torch.randn(size, generator=g, device="cuda").to(dtype)
                w = torch.randn(size, generator=g, device="cuda")
                got = kernel.running_average(avg, w, n)
                torch.cuda.synchronize()
                want = ref.running_average_ref(avg, w, n)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                check(torch.equal(got.view(bits), want.view(bits)),
                      f"swa_avg {dtype} n={n} size={size}: not bitwise "
                      f"equal to the plain version")
                n_cases += 1
    print(f"[swa_avg] {n_cases} cases bitwise equal to the plain version")

    # times on the full-width internlm2-1.8b parameter tree (f32)
    model = Model(registry.get_config("internlm2-1.8b"))
    g = torch.Generator(device="cuda").manual_seed(7)
    avg = list(_leaves(model.init(g)))
    w = list(_leaves(model.init(g)))
    numel = sum(t.numel() for t in avg)

    def fold_kernel():
        for a, x in zip(avg, w):
            kernel.running_average(a, x, 1, out=a)

    def fold_plain():
        for a, x in zip(avg, w):
            a.copy_(ref.running_average_ref(a, x, 1))

    ms = _cuda_ms(fold_kernel, 5)
    plain_ms = _cuda_ms(fold_plain, 3)
    lib_ms = _cuda_ms(lambda: torch._foreach_lerp_(avg, w, 0.5), 5)
    nbytes = 3 * 4 * numel
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * numel / PEAK_FLOPS["float32"] * 1e3
    print(f"[swa_avg] full-width tree, {len(avg)} leaves, {numel} f32: "
          f"kernel {ms:.4f} ms ({len(avg)} launches), bound "
          f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e9:.2f} GB), plain "
          f"{plain_ms:.4f} ms, library _foreach_lerp_ {lib_ms:.4f} ms",
          flush=True)
    del avg, w
    torch.cuda.empty_cache()
    return {
        "name": "swa_avg", "route": "cuda",
        "source": "src/repro_torch/kernels/swa_avg/csrc/swa_avg.cu",
        "replaces": "src/repro/kernels/swa_avg/kernel.py:24",
        "launches": None, "max_abs_err": 0.0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms}


def _ssd_inputs(shape, dtype, seed):
    """x, dt, A, Bm, Cm as the JAX SSD tests draw them; x, Bm and Cm in
    ``dtype``, dt and A in f32."""
    import torch
    B, S, H, P, G, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    x = mk(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(mk(B, S, H))
    A = -torch.exp(mk(H))
    return x, dt, A, mk(B, S, G, N).to(dtype), mk(B, S, G, N).to(dtype)


def _ssd_cotangents(shape, chunk, seed):
    import torch
    B, S, H, P, G, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return mk(B, S, H, P), mk(B, S // chunk, H, P, N), mk(B, S, H)


def _scaled_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _ssd_grid():
    """(B, S, H, P, G, N), chunk, dtype: every L in 1..256 the main paths
    give the kernels (1, engine prompts 37 and 200, training 64, the full
    chunk 256), with 1 to 3 chunks, 1 or 2 groups, both (P, N)."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for P, N in ((64, 128), (32, 16)):
            for G in (1, 2):
                for k, L in enumerate((1, 37, 64, 200, 256)):
                    nc = 1 + (k + G + P // 32) % 3
                    cases.append(((2, L * nc, 4, P, G, N), L, dtype))
    return cases


def _ssd_work(shape, chunk, elt, bwd: bool):
    """(bytes, flops) the function must move and do: each input read once,
    each output written once; the pairs j <= i of each chunk. What depends
    on B and C alone is counted once per group, the rest once per head: the
    C.B^T scores, and in the backward the dC and dB products, taken on
    dG o seg summed over the group's heads (dC and dB are per group)."""
    B, S, H, P, G, N = shape
    nc = S // chunk
    pairs = chunk * (chunk + 1) // 2
    inputs = (B * S * H * P + 2 * B * S * G * N) * elt + (B * S * H + H) * 4
    if not bwd:
        out = (B * S * H * P + B * nc * H * P * N + B * S * H) * 4
        # per group C.B^T; per head y = (scores o seg) (dt x) and the state
        flops = B * nc * (G * pairs * 2 * N
                          + H * (pairs * 2 * P + 2 * P * N * chunk))
        return inputs + out, flops
    cots = (B * S * H * P + B * nc * H * P * N + B * S * H) * 4
    out = (B * S * H * P + B * S * H + H + 2 * B * S * G * N) * 4
    # per group C.B^T, dC and dB; per head dG, d_dx, the sum of dG o seg
    # over the group and the state terms (B dS^T, x dS)
    flops = B * nc * (G * pairs * 6 * N
                      + H * (pairs * (4 * P + 1) + 4 * P * N * chunk))
    return inputs + cots + out, flops


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_ssd():
    import torch
    from repro_torch.kernels.ssd import kernel, ops
    worst = {}
    for i, (shape, L, dtype) in enumerate(_ssd_grid()):
        args = _ssd_inputs(shape, getattr(torch, dtype), seed=300 + i)
        got = kernel.ssd_fwd(*args, chunk=L)
        cots = _ssd_cotangents(shape, L, seed=400 + i)
        got_b = kernel.ssd_bwd(*args, *cots, chunk=L)
        torch.cuda.synchronize()
        want = ops._intra_chunk(*args, L)
        want_b = ops._intra_chunk_bwd(*args, *cots, L)
        for name, g, w in zip(("y", "states", "cum", "dx", "ddt", "dA", "dB",
                               "dC"), got + got_b, want + want_b):
            check(g.shape == w.shape and g.dtype == torch.float32,
                  f"ssd case {i}: {name} shape/dtype")
            check(bool(torch.isfinite(g).all()),
                  f"ssd case {i}: non-finite {name}")
            err = _scaled_err(g, w)
            check(err <= SSD_TOL, f"ssd case {i} {shape} L={L} {dtype}: "
                                  f"{name} error {err:.3e} > {SSD_TOL}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    # ragged S through the scan: padding, chunk chaining and, in f32, the
    # Function's grads (bf16 leaves would get bf16-rounded grads, which two
    # paths that differ in the last f32 bits may round one bf16 step apart)
    for S, chunk in ((83, 32), (513, 256)):
        shape = (2, S, 4, 64, 2, 128)
        for dtype in ("float32", "bfloat16"):
            x, dt, A, Bm, Cm = _ssd_inputs(shape, getattr(torch, dtype),
                                           seed=S)
            D = torch.randn(4, device="cuda")
            outs = {}
            for impl in ("kernel", "reference"):
                ts = [t.detach().clone().requires_grad_(dtype == "float32")
                      for t in (x, dt, A, Bm, Cm, D)]
                with torch.set_grad_enabled(dtype == "float32"):
                    y, st = ops.ssd_scan(*ts, chunk=chunk, impl=impl)
                outs[impl] = [y, st]
                if dtype == "float32":
                    loss = (y ** 2).mean() + (st ** 2).mean()
                    outs[impl] += torch.autograd.grad(loss, ts)
            for name, g, w in zip(("y", "state", "dx", "ddt", "dA", "dB",
                                   "dC", "dD"), *outs.values()):
                err = _scaled_err(g, w)
                check(err <= SSD_TOL, f"ssd_scan S={S} chunk={chunk} "
                                      f"{dtype}: {name} error {err:.3e}")
                worst[dtype] = max(worst[dtype], err)
    print(f"[ssd] {len(_ssd_grid())} kernel cases (fwd and bwd) and 4 ragged "
          f"scans (f32 with grads) match the plain versions; max |err|/max "
          f"|ref| "
          f"f32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e} (limit "
          f"{SSD_TOL})")

    # each kernel's JSON row is taken at the shape of the main path its
    # launches are counted on; the forward is also timed at the training
    # shape (PERF.md)
    rows = []
    for name, shape7, bwd, src, where, row in (
            ("ssd_fwd", SSD_SERVE_SHAPE, False,
             "src/repro/kernels/ssd/kernel.py:29", "serve prefill", True),
            ("ssd_fwd", SSD_TRAIN_SHAPE, False,
             "src/repro/kernels/ssd/kernel.py:29", "training phase 1", False),
            ("ssd_bwd", SSD_TRAIN_SHAPE, True,
             "src/repro/kernels/ssd/kernel.py:61", "training phase 1", True)):
        *shape, chunk = shape7
        args = _ssd_inputs(tuple(shape), torch.bfloat16, seed=7)
        if bwd:
            cots = _ssd_cotangents(tuple(shape), chunk, seed=8)
            got = kernel.ssd_bwd(*args, *cots, chunk=chunk)
            want = ops._intra_chunk_bwd(*args, *cots, chunk)
            ms = _cuda_ms(lambda: kernel.ssd_bwd(*args, *cots, chunk=chunk),
                          10)
            plain_ms = _cuda_ms(lambda: ops._intra_chunk_bwd(
                *args, *cots, chunk), 3)
        else:
            got = kernel.ssd_fwd(*args, chunk=chunk)
            want = ops._intra_chunk(*args, chunk)
            ms = _cuda_ms(lambda: kernel.ssd_fwd(*args, chunk=chunk), 10)
            plain_ms = _cuda_ms(lambda: ops._intra_chunk(*args, chunk), 3)
        errs = [_scaled_err(g, w) for g, w in zip(got, want)]
        check(max(errs) <= SSD_TOL, f"{name} at the {where} shape: error "
                                    f"{max(errs):.3e}")
        max_abs = max((g - w).abs().max().item() for g, w in zip(got, want))
        del got, want
        nbytes, flops = _ssd_work(tuple(shape), chunk, 2, bwd)
        bound_ms, bound_by = _bound(nbytes, flops)
        B, S, H, P, G, N = shape
        print(f"[ssd] {name} at the {where} shape B{B} S{S} H{H} P{P} G{G} "
              f"N{N} L{chunk} bf16: kernel {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), plain {plain_ms:.4f} ms, library "
              f"none (no PyTorch call computes it); max |err| {max_abs:.3e}",
              flush=True)
        if row:
            rows.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/ssd/csrc/{name}.cu",
                "replaces": src, "launches": None, "max_abs_err": max_abs,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 4: full-width serve
# ---------------------------------------------------------------------------


def phase_serve(card: str):
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = registry.get_config("internlm2-1.8b")
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(g)
    B, S, T = 8, 512, 32
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device="cuda")
    lengths, n_new, max_seq = ENGINE_PROMPTS, 16, 1024
    reqs = [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (L,), generator=g, device="cuda"),
        max_new_tokens=n_new) for i, L in enumerate(lengths)]
    n_layers = cfg.n_layers
    print(f"[serve] {cfg.name}: {n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B f32",
          flush=True)

    generate(model, params, prompts, 2, engine="compiled")   # warm-up
    # --- the main path, with the launch counts read around it ---
    for fn in _launch_counts().values():
        fn.launches = 0
    out_loop, st_loop = generate(model, params, prompts, T, engine="loop")
    out_comp, st_comp = generate(model, params, prompts, T,
                                 engine="compiled")
    engine = ServingEngine(model, params, max_batch=2, max_seq=max_seq)
    t0 = time.perf_counter()
    with torch.inference_mode():
        done = engine.run(reqs)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    launches = kernel.flash_fwd.launches
    # -------------------------------------------------------------

    check(out_loop.shape == (B, T) and torch.equal(out_loop, out_comp),
          "loop and compiled engines disagree at full width")
    check(bool(((out_loop >= 0) & (out_loop < cfg.vocab_size)).all()),
          "generated token ids out of range")
    for st in (st_loop, st_comp):
        print(f"[serve] generate engine={st['engine']} batch {B} prompt {S} "
              f"new {T} on {card}: prefill {st['prefill_s'] * 1e3:.2f} ms "
              f"({st['prefill_tokens_per_s']:.1f} prompt tok/s), decode "
              f"{st['decode_s'] * 1e3:.2f} ms "
              f"({st['decode_tokens_per_s']:.1f} tok/s)")
    for r in reqs:
        check(r.done and len(done[r.rid]) == n_new,
              f"engine request {r.rid} (prompt {r.prompt.shape[0]}) ended "
              f"with {len(done[r.rid])} of {n_new} tokens")
    n_prefills = 2 + len(reqs)
    print(f"[serve] ServingEngine: {len(reqs)} requests (prompts "
          f"{list(lengths)}) through 2 slots, max_seq {max_seq}: "
          f"{n_new} tokens each in {t_engine:.2f} s")
    print(f"[serve] flash_attention_fwd launches on the main path: "
          f"{launches} for {n_prefills} prefills of {n_layers} layers")
    check(launches >= n_layers * n_prefills,
          f"kernel launched {launches} times, fewer than {n_layers} per "
          f"prefill")

    # prefill logits: kernel against the plain attention, on the card
    # prefill logits, kernel against the plain attention on the card. The
    # limit of 1e-2 is held in f32 compute, where the kernel is the only
    # difference. In bf16, 24 layers of bf16 rounding put any two paths that
    # are not bitwise equal ~1.4e-2 apart (the plain version and the naive
    # oracle too), so there the kernel is held to the f32 model instead: no
    # further from it than the plain version is, within 10%.
    logits = {}
    for dtype, impl in (("float32", "kernel"), ("float32", "reference"),
                        ("float32", "naive"), ("bfloat16", "kernel"),
                        ("bfloat16", "reference")):
        m = Model(dataclasses.replace(cfg, dtype=dtype, attention_impl=impl))
        with torch.inference_mode():
            logits[dtype, impl] = m.prefill(params, prompts)[0].float()

    def rel(a, b):
        return (torch.linalg.vector_norm(logits[a] - logits[b])
                / torch.linalg.vector_norm(logits[b])).item()

    truth = ("float32", "naive")
    r32 = rel(("float32", "kernel"), ("float32", "reference"))
    r16 = rel(("bfloat16", "kernel"), ("bfloat16", "reference"))
    e_k = rel(("bfloat16", "kernel"), truth)
    e_r = rel(("bfloat16", "reference"), truth)
    print(f"[serve] prefill logits, kernel vs plain attention: relative L2 "
          f"error {r32:.3e} in f32 (limit 1e-2), {r16:.3e} in bf16")
    print(f"[serve] bf16 prefill logits against the f32 model with naive "
          f"attention: kernel {e_k:.3e}, plain {e_r:.3e} (limit 1.1x plain); "
          f"f32 kernel {rel(('float32', 'kernel'), truth):.3e}", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in logits.values()),
          "non-finite prefill logits")
    check(r32 <= 1e-2, f"f32 prefill logits differ: relative L2 {r32:.3e}")
    check(e_k <= 1.1 * e_r,
          f"bf16 kernel prefill is further from the f32 model ({e_k:.3e}) "
          f"than the plain version ({e_r:.3e})")


def phase_mamba_serve(card: str):
    """mamba2-2.7b at full width (64 layers) on the serving main path;
    returns the SSD forward's launches on it."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.ssd import kernel
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServingEngine

    torch.cuda.empty_cache()
    cfg = registry.get_config(MAMBA)
    model = Model(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(g)
    B, S, T = 8, 512, 32
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                            device="cuda")
    lengths, n_new, max_seq = ENGINE_PROMPTS, 16, 1024
    reqs = [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (L,), generator=g, device="cuda"),
        max_new_tokens=n_new) for i, L in enumerate(lengths)]
    s = cfg.ssm
    print(f"[mamba-serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, SSD heads {s.expand * cfg.d_model // s.head_dim}x"
          f"{s.head_dim}, state {s.d_state}, groups {s.n_groups}, chunk "
          f"{s.chunk_size}, vocab {cfg.vocab_size}, {cfg.dtype}; params "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B f32",
          flush=True)

    generate(model, params, prompts, 2, engine="compiled")   # warm-up
    # --- the main path, with the launch counts read around it ---
    for fn in _launch_counts().values():
        fn.launches = 0
    out_loop, st_loop = generate(model, params, prompts, T, engine="loop")
    out_comp, st_comp = generate(model, params, prompts, T,
                                 engine="compiled")
    engine = ServingEngine(model, params, max_batch=2, max_seq=max_seq)
    t0 = time.perf_counter()
    with torch.inference_mode():
        done = engine.run(reqs)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    launches = kernel.ssd_fwd.launches
    # -------------------------------------------------------------

    check(out_loop.shape == (B, T) and torch.equal(out_loop, out_comp),
          "mamba2: loop and compiled engines disagree at full width")
    check(bool(((out_loop >= 0) & (out_loop < cfg.vocab_size)).all()),
          "mamba2: generated token ids out of range")
    for st in (st_loop, st_comp):
        print(f"[mamba-serve] generate engine={st['engine']} batch {B} "
              f"prompt {S} new {T} on {card}: prefill "
              f"{st['prefill_s'] * 1e3:.2f} ms "
              f"({st['prefill_tokens_per_s']:.1f} prompt tok/s), decode "
              f"{st['decode_s'] * 1e3:.2f} ms "
              f"({st['decode_tokens_per_s']:.1f} tok/s)")
    for r in reqs:
        check(r.done and len(done[r.rid]) == n_new,
              f"mamba2 engine request {r.rid} (prompt {r.prompt.shape[0]}) "
              f"ended with {len(done[r.rid])} of {n_new} tokens")
    n_prefills = 2 + len(reqs)
    print(f"[mamba-serve] ServingEngine: {len(reqs)} requests (prompts "
          f"{list(lengths)}) through 2 slots: {n_new} tokens each in "
          f"{t_engine:.2f} s")
    print(f"[mamba-serve] ssd_fwd launches on the main path: {launches} for "
          f"{n_prefills} prefills of {cfg.n_layers} layers")
    check(launches >= cfg.n_layers * n_prefills,
          f"ssd_fwd launched {launches} times, fewer than {cfg.n_layers} per "
          f"prefill")

    # prefill logits, kernel against the plain SSD on the card: in f32,
    # where the kernel is the only difference (limit 1e-2 relative L2, as
    # for the dense path; the two sum in another order); in bf16, no
    # further from the f32 model with the plain SSD than the plain version
    # is, within 10% (as the dense path's check holds its kernel)
    logits = {}
    for dtype, impl in (("float32", "kernel"), ("float32", "reference"),
                        ("bfloat16", "kernel"), ("bfloat16", "reference")):
        m = Model(dataclasses.replace(cfg, dtype=dtype, ssd_impl=impl))
        with torch.inference_mode():
            logits[dtype, impl] = m.prefill(params, prompts)[0].float()

    def rel(a, b):
        return (torch.linalg.vector_norm(logits[a] - logits[b])
                / torch.linalg.vector_norm(logits[b])).item()

    truth = ("float32", "reference")
    r32 = rel(("float32", "kernel"), truth)
    r16 = rel(("bfloat16", "kernel"), ("bfloat16", "reference"))
    e_k = rel(("bfloat16", "kernel"), truth)
    e_r = rel(("bfloat16", "reference"), truth)
    print(f"[mamba-serve] prefill logits, kernel vs plain SSD: relative L2 "
          f"{r32:.3e} in f32 (limit 1e-2), {r16:.3e} in bf16; bf16 against "
          f"the f32 model: kernel {e_k:.3e}, plain {e_r:.3e} (limit 1.1x "
          f"plain)", flush=True)
    check(all(bool(torch.isfinite(v).all()) for v in logits.values()),
          "mamba2: non-finite prefill logits")
    check(r32 <= 1e-2, f"mamba2 f32 prefill logits differ: {r32:.3e}")
    check(e_k <= 1.1 * e_r,
          f"mamba2 bf16 kernel prefill is further from the f32 model "
          f"({e_k:.3e}) than the plain version ({e_r:.3e})")
    del params, logits
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 6: smoke-width serving exactness
# ---------------------------------------------------------------------------


def phase_exact(arch="internlm2-1.8b"):
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServingEngine

    model = Model(registry.get_smoke_config(arch))               # f32
    g = torch.Generator(device="cuda").manual_seed(1)
    params = model.init(g)
    prompts = [torch.randint(0, model.cfg.vocab_size, (L,), generator=g,
                             device="cuda") for L in (9, 17, 5, 12, 8)]
    engine = ServingEngine(model, params, max_batch=2, max_seq=64)
    with torch.inference_mode():
        got = engine.run([Request(rid=i, prompt=p, max_new_tokens=6)
                          for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        want, _ = generate(model, params, p[None], 6)
        check(got[i] == want[0].tolist(),
              f"smoke request {i}: engine {got[i]} != generate "
              f"{want[0].tolist()}")
    print(f"[exact] f32 {arch} smoke: ServingEngine tokens equal "
          f"single-request generate for {len(prompts)} requests through 2 "
          f"slots")


# ---------------------------------------------------------------------------
# phase 5: SWAP training at full width
# ---------------------------------------------------------------------------


def _rel_l2(a_tree, b_tree) -> float:
    import torch
    num = den = 0.0
    for a, b in zip(_leaves(a_tree), _leaves(b_tree)):
        num += torch.linalg.vector_norm((a.float() - b.float())).item() ** 2
        den += torch.linalg.vector_norm(b.float()).item() ** 2
    return (num / den) ** 0.5


def _launch_counts():
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.swa_avg import kernel as swa_kernel
    return {"flash_attention_fwd": kernel.flash_fwd,
            "flash_attention_bwd_dq": kernel.flash_bwd_dq,
            "flash_attention_bwd_dkv": kernel.flash_bwd_dkv,
            "swa_avg": swa_kernel.running_average,
            "ssd_fwd": ssd_kernel.ssd_fwd,
            "ssd_bwd": ssd_kernel.ssd_bwd}


DENSE_TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv", "swa_avg")
MAMBA_TRAIN_KERNELS = ("ssd_fwd", "ssd_bwd", "swa_avg")


def phase_train(card: str, argv=TRAIN_ARGV, cfg=None,
                required=DENSE_TRAIN_KERNELS, tag="train"):
    """The launcher's own run (``train.main(argv, cfg=cfg)``) as a main
    path: every kernel in ``required`` must launch in it."""
    import math
    import torch
    from repro_torch.core.averaging import average_stacked
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    cut = f" (cfg: {cfg.n_layers} layers)" if cfg is not None else ""
    print(f"[{tag}] python -m repro_torch.launch.train {' '.join(argv)}{cut}",
          flush=True)
    # --- the main path, with every launch count read around it ---
    for fn in _launch_counts().values():
        fn.launches = 0
    res = train.main(argv, cfg=cfg)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in _launch_counts().items()}
    # -------------------------------------------------------------
    print(f"[{tag}] launches on the training path: {launches}")
    for name in required:
        check(launches[name] > 0,
              f"{name} was not launched on the {tag} path")
    values = ([e[k] for e in res["phase1_log"] for k in ("loss", "accuracy")]
              + res["worker_test_accs"]
              + [res[k] for k in ("phase1_test_acc", "before_avg_test_acc",
                                  "after_avg_test_acc", "phase1_train_acc")])
    check(all(math.isfinite(x) for x in values),
          f"non-finite loss or accuracy: {values}")
    check(res["phase2_live_workers"] == 2, "elastic phase 3 dropped a worker")
    rel = _rel_l2(res["final_bundle"]["params"],
                  average_stacked(res["stacked_params"]))
    print(f"[{tag}] elastic average (swa_avg kernel) against the plain mean "
          f"of the same phase-2 models: relative L2 {rel:.3e} (limit 1e-6)")
    check(rel <= 1e-6, f"elastic average differs from the plain mean: {rel}")
    st = res["device"]
    p1, p2 = res["phase1_steps"], res["phase2_steps"]
    tok1 = p1 * 256 * 64 / st["phase1_train_s"]
    tok2 = p2 * 2 * 32 * 64 / st["phase2_train_s"]
    print(f"[{tag}] on {card}: phase 1 {p1} steps of 256x64 tokens, "
          f"{st['phase1_train_s'] / p1 * 1e3:.1f} ms/step ({tok1:.0f} tok/s); "
          f"phase 2 {p2} steps of 2 workers x 32x64 tokens, "
          f"{st['phase2_train_s'] / p2 * 1e3:.1f} ms/step ({tok2:.0f} tok/s); "
          f"phase 3 {res['phase3_time'] * 1e3:.1f} ms")
    print(f"[{tag}] memory peak: phase 1 {st['phase1_peak_gb']:.2f} GB, "
          f"phase 2 {st['phase2_peak_gb']:.2f} GB, phase 3 "
          f"{st['phase3_peak_gb']:.2f} GB (torch.cuda.max_memory_allocated)",
          flush=True)
    del res
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: smoke-width training exactness
# ---------------------------------------------------------------------------


def phase_exact_train(arch="internlm2-1.8b", field="attention_impl"):
    """Smoke exactness with the kernels (``field`` = "kernel") against the
    plain versions (``field`` = "reference")."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, PhaseConfig,
                                          ScheduleConfig, SWAPConfig)
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.core.averaging import elastic_average_stacked
    from repro_torch.core.swap import SWAP
    from repro_torch.data.pipeline import Loader, make_markov_lm
    from repro_torch.dist.config import DistConfig
    from repro_torch.models.model import Model
    from repro_torch.optim.api import tree_leaves
    from repro_torch.train.steps import lm_loss_and_metrics

    smoke = registry.get_smoke_config(arch)                  # f32
    data = make_markov_lm(1, vocab=smoke.vocab_size, n_train=1024,
                          n_test=256, seq_len=64)
    batch = {"tokens": torch.from_numpy(data["train_tokens"][:16]).cuda(),
             "labels": torch.from_numpy(data["train_labels"][:16]).cuda()}
    params = Model(smoke).init(torch.Generator(device="cuda").manual_seed(3))
    grads = {}
    for impl in ("kernel", "reference"):
        model = Model(dataclasses.replace(smoke, **{field: impl}))
        req = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(req)
        tree = _rebuild(params, it)
        loss, _ = lm_loss_and_metrics(model, tree, batch)
        grads[impl] = torch.autograd.grad(loss, req)
    err = l2 = 0.0
    for a, b in zip(grads["kernel"], grads["reference"]):
        check(bool(b.abs().max() > 0), f"zero grad leaf {tuple(b.shape)}")
        d = a - b
        err = max(err, (d.abs().max() / b.abs().max()).item())
        l2 = max(l2, (torch.linalg.vector_norm(d)
                      / torch.linalg.vector_norm(b)).item())
    print(f"[exact] f32 {arch} smoke: whole-model grads with the kernels "
          f"against plain autograd, worst leaf: max |err|/max |ref| "
          f"{err:.3e} (limit {GRAD_TOL}), relative L2 {l2:.3e} (limit "
          f"{GRAD_L2_TOL})")
    check(err <= GRAD_TOL and l2 <= GRAD_L2_TOL,
          f"smoke grads differ: {err:.3e}, relative L2 {l2:.3e}")

    train = {"tokens": data["train_tokens"], "labels": data["train_labels"]}
    dist = DistConfig(n_workers=2, elastic_deadline_s=30.0)
    sched = ScheduleConfig(kind="warmup_linear", peak_lr=0.5,
                           warmup_steps=2, total_steps=8)
    cfg = SWAPConfig(n_workers=2, seed=1,
                     phase1=PhaseConfig(batch_size=64, max_steps=8,
                                        schedule=sched),
                     phase2=PhaseConfig(batch_size=16, max_steps=6,
                                        schedule=dataclasses.replace(
                                            sched, peak_lr=0.125,
                                            warmup_steps=0, total_steps=6)))
    runs = {}
    for impl in ("kernel", "reference"):
        adapter = LMAdapter(dataclasses.replace(smoke, **{field: impl}),
                            OptimizerConfig())
        test = Loader({"tokens": data["test_tokens"],
                       "labels": data["test_labels"]}, 64, device="cuda")
        runs[impl] = SWAP(adapter, cfg, train, test, dist=dist).run(
            torch.Generator(device="cuda").manual_seed(5))
    ref_avg, _ = elastic_average_stacked(runs["reference"]["stacked_params"],
                                         dist, impl="reference")
    ref_final = runs["reference"]["final_bundle"]["params"]
    check(all(torch.equal(a, b) for a, b in zip(_leaves(ref_avg),
                                                 _leaves(ref_final))),
          "elastic average on the kernel is not bitwise the plain fold")
    rel = _rel_l2(runs["kernel"]["final_bundle"]["params"], ref_avg)
    acc = abs(runs["kernel"]["after_avg_test_acc"]
              - runs["reference"]["after_avg_test_acc"])
    print(f"[exact] f32 {arch} smoke SWAP (8 + 6 steps, W 2, elastic): "
          f"kernels against plain versions, averaged params relative L2 "
          f"{rel:.3e} (limit 1e-4), averaged test acc |diff| {acc:.3e} "
          f"(limit 2e-3)")
    check(rel <= 1e-4, f"smoke SWAP averaged params differ: {rel:.3e}")
    check(acc <= 2e-3, f"smoke SWAP averaged accuracy differs: {acc:.3e}")


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def main() -> None:
    import dataclasses
    card = phase_device()
    phase_build()
    rows = [phase_kernel(), *phase_kernel_bwd(), phase_swa_avg(),
            *phase_ssd()]
    phase_serve(card)
    launches = phase_train(card)
    phase_exact()
    phase_exact_train()
    # the ssm family: serving at full width, training at a cut depth
    from repro_torch.configs import registry
    ssd_serve = phase_mamba_serve(card)
    cut = dataclasses.replace(registry.get_config(MAMBA),
                              n_layers=MAMBA_TRAIN_LAYERS)
    ssd_train = phase_train(card, ["--arch", MAMBA] + TRAIN_ARGV, cut,
                            MAMBA_TRAIN_KERNELS, tag="mamba-train")
    phase_exact(MAMBA)
    phase_exact_train(MAMBA, "ssd_impl")
    # launches: the dense kernels' on the dense training path; the SSD
    # forward's on the mamba serving path (the shape its time is taken
    # at), the SSD backward's on the mamba training path
    launches.update(ssd_fwd=ssd_serve, ssd_bwd=ssd_train["ssd_bwd"])
    print(f"[mamba-train] ssd_fwd launched {ssd_train['ssd_fwd']} times on "
          f"the training path too")
    for row in rows:
        row["launches"] = launches[row["name"]]
    import torch
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
