#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from the repository's sources,
   one nvcc per source, all started together;
3. kernels vs plain: hold each kernel against its plain PyTorch version on
   the card over a grid of shapes, dtypes and masks (the flash forward,
   the flash backward's dQ and dK/dV kernels, the streaming average,
   bitwise), and time each at the shape the main path gives it, beside its
   bound, its plain version and a library call;
4. full-width serve (internlm2-1.8b, random weights from a seed): a main
   path, with every kernel's launch count set to 0 just before it and read
   just after; then prefill logits with the kernel against the plain
   attention on the card (in f32) and against the f32 model (in bf16);
5. full-width SWAP training (``repro_torch.launch.train`` with --full
   --workers 2 and the elastic phase 3): the training main path, counted
   the same way; every kernel must launch in it, losses and accuracies
   must be finite, and the elastic average must agree with the plain mean
   of the same phase-2 models;
6. smoke-width exactness in f32: continuous batching against
   single-request generation, token for token; whole-model gradients with
   the kernels against plain-attention autograd; a whole SWAP run with the
   kernels against the same run on the plain versions.

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
# dq/dk/dv against the plain backward: f32 at the JAX kernel tests' 2e-4.
# In bf16 both read the same bf16 inputs and sum in f32; they differ by
# summation order and by where dq/dk/dv round to bf16, so the bound is
# 1e-2 (relative to 1 + |value|, about 2 bf16 ulp)
BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
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
    from repro_torch.kernels.swa_avg import kernel as swa_kernel
    builds = {"flash_fwd": kernel.build, "flash_bwd": kernel.build_bwd,
              "swa_avg": swa_kernel.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = {name: pool.submit(fn) for name, fn in builds.items()}
        done = {name: f.result() for name, f in done.items()}
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
    worst, path_err = {}, 0.0
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
            path_err = max(path_err, err.max().item())
    print(f"[kernel] {len(_grid())} cases match the plain version; max |out "
          f"err| f32 {worst['float32']:.3e} bf16 {worst['bfloat16']:.3e}")

    # times at the prefill shape of internlm2-1.8b (what each layer gives it)
    B, Sq, Skv, H, KVH, D = PREFILL_SHAPE
    q, k, v = _qkv(PREFILL_SHAPE, torch.bfloat16, seed=1234)
    ms = _cuda_ms(lambda: kernel.flash_fwd(q, k, v, causal=True), 50)
    plain_ms = _cuda_ms(lambda: ops._blockwise_fwd(
        q, k, v, causal=True, window=0, scale=None, q_offset=0, chunk=512), 5)
    # yardstick only, never called by the port: one fused library call on
    # the same function (K/V heads repeated beforehand, outside the timing)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    lib_ms = _cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 50)
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + B * Sq * H * 4
    flops = 4 * D * B * H * _visible_pairs(Sq, Skv, True, 0, 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    print(f"[kernel] prefill shape B{B} S{Sq} H{H} KVH{KVH} D{D} bf16 causal: "
          f"kernel {ms:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.2f} us "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms", flush=True)
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
        "launches": None, "max_abs_err": path_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }


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


def phase_kernel_bwd():
    import torch
    from repro_torch.kernels.flash_attention import kernel, ref
    worst = {}
    for i, (shape, dtype, causal, window, q_offset) in enumerate(_bwd_grid()):
        q, k, v = _qkv(shape, getattr(torch, dtype), seed=100 + i)
        do = _qkv(shape, getattr(torch, dtype), seed=200 + i)[0]
        kw = dict(causal=causal, window=window, scale=None,
                  q_offset=q_offset)
        out, lse = kernel.flash_fwd(q, k, v, **kw)
        got = kernel.flash_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"bwd case {i}: {name} shape/dtype")
            check(bool(torch.isfinite(g).all()),
                  f"bwd case {i}: non-finite {name}")
            err = _rel_err(g, w)
            check(err <= BWD_TOL[dtype],
                  f"bwd case {i} {shape} {dtype} causal={causal} "
                  f"window={window} q_offset={q_offset}: {name} error "
                  f"{err:.3e} > {BWD_TOL[dtype]}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        if q_offset < 0:   # rows that see no key: dq = 0
            check(bool((got[0][:, :-q_offset] == 0).all()),
                  f"bwd case {i}: fully masked rows have dq != 0")
        if shape == TRAIN_SHAPE:
            train_err = {n: (g.float() - w.float()).abs().max().item()
                         for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    print(f"[kernel-bwd] {len(_bwd_grid())} cases match the plain version; "
          f"max |err|/(1+|ref|) f32 {worst['float32']:.3e} (limit "
          f"{BWD_TOL['float32']}), bf16 {worst['bfloat16']:.3e} (limit "
          f"{BWD_TOL['bfloat16']})")

    # times at the phase-1 training shape
    B, Sq, Skv, H, KVH, D = TRAIN_SHAPE
    q, k, v = _qkv(TRAIN_SHAPE, torch.bfloat16, seed=4321)
    do = _qkv(TRAIN_SHAPE, torch.bfloat16, seed=4322)[0]
    out, lse = kernel.flash_fwd(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1)
    dq_ms = _cuda_ms(lambda: kernel.flash_bwd_dq(q, k, v, do, lse, delta,
                                                 causal=True), 20)
    dkv_ms = _cuda_ms(lambda: kernel.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                   causal=True), 20)
    plain_ms = _cuda_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=True), 5)
    # yardstick only, never called by the port: the library's fused
    # attention backward, as (forward + backward) less the forward, on
    # K/V with their heads repeated beforehand
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
    kt.requires_grad_()
    vt.requires_grad_()
    dot = do.transpose(1, 2).contiguous()

    def fwd_bwd():
        o = sdpa(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    with torch.no_grad():
        fwd_ms = _cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 20)
    lib_ms = _cuda_ms(fwd_bwd, 20) - fwd_ms
    pairs = _visible_pairs(Sq, Skv, True, 0, 0) * B * H
    elt = 2                                            # bf16
    read = (q.numel() * 2 + k.numel() + v.numel()) * elt \
        + 2 * B * Sq * H * 4                       # q, dO, k, v, lse, delta
    rows = []
    for name, ms, written, flops, src in (
            ("flash_attention_bwd_dq", dq_ms, q.numel() * elt, 6 * D * pairs,
             "src/repro/kernels/flash_attention/kernel.py:202"),
            ("flash_attention_bwd_dkv", dkv_ms, 2 * k.numel() * elt,
             8 * D * pairs,
             "src/repro/kernels/flash_attention/kernel.py:232")):
        nbytes = read + written
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        print(f"[kernel-bwd] {name} at B{B} S{Sq} H{H} KVH{KVH} D{D} bf16 "
              f"causal: kernel {ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops) * 1e3:.2f} us ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP), plain (dq, dk, dv together) "
              f"{plain_ms:.4f} ms, library backward (dq, dk, dv together) "
              f"{lib_ms:.4f} ms")
        err = (train_err["dq"] if name.endswith("dq")
               else max(train_err["dk"], train_err["dv"]))
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_bwd.cu",
            "replaces": src, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})
    sys.stdout.flush()
    return rows


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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 6: smoke-width serving exactness
# ---------------------------------------------------------------------------


def phase_exact():
    import torch
    from repro_torch.configs import registry
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServingEngine

    model = Model(registry.get_smoke_config("internlm2-1.8b"))   # f32
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
    print(f"[exact] f32 smoke: ServingEngine tokens equal single-request "
          f"generate for {len(prompts)} requests through 2 slots")


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
    from repro_torch.kernels.swa_avg import kernel as swa_kernel
    return {"flash_attention_fwd": kernel.flash_fwd,
            "flash_attention_bwd_dq": kernel.flash_bwd_dq,
            "flash_attention_bwd_dkv": kernel.flash_bwd_dkv,
            "swa_avg": swa_kernel.running_average}


def phase_train(card: str):
    import math
    import torch
    from repro_torch.core.averaging import average_stacked
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    print(f"[train] python -m repro_torch.launch.train {' '.join(TRAIN_ARGV)}",
          flush=True)
    # --- the main path, with every launch count read around it ---
    for fn in _launch_counts().values():
        fn.launches = 0
    res = train.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in _launch_counts().items()}
    # -------------------------------------------------------------
    print(f"[train] launches on the training path: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the training path")
    values = ([e[k] for e in res["phase1_log"] for k in ("loss", "accuracy")]
              + res["worker_test_accs"]
              + [res[k] for k in ("phase1_test_acc", "before_avg_test_acc",
                                  "after_avg_test_acc", "phase1_train_acc")])
    check(all(math.isfinite(x) for x in values),
          f"non-finite loss or accuracy: {values}")
    check(res["phase2_live_workers"] == 2, "elastic phase 3 dropped a worker")
    rel = _rel_l2(res["final_bundle"]["params"],
                  average_stacked(res["stacked_params"]))
    print(f"[train] elastic average (swa_avg kernel) against the plain mean "
          f"of the same phase-2 models: relative L2 {rel:.3e} (limit 1e-6)")
    check(rel <= 1e-6, f"elastic average differs from the plain mean: {rel}")
    st = res["device"]
    p1, p2 = res["phase1_steps"], res["phase2_steps"]
    tok1 = p1 * 256 * 64 / st["phase1_train_s"]
    tok2 = p2 * 2 * 32 * 64 / st["phase2_train_s"]
    print(f"[train] on {card}: phase 1 {p1} steps of 256x64 tokens, "
          f"{st['phase1_train_s'] / p1 * 1e3:.1f} ms/step ({tok1:.0f} tok/s); "
          f"phase 2 {p2} steps of 2 workers x 32x64 tokens, "
          f"{st['phase2_train_s'] / p2 * 1e3:.1f} ms/step ({tok2:.0f} tok/s); "
          f"phase 3 {res['phase3_time'] * 1e3:.1f} ms")
    print(f"[train] memory peak: phase 1 {st['phase1_peak_gb']:.2f} GB, "
          f"phase 2 {st['phase2_peak_gb']:.2f} GB, phase 3 "
          f"{st['phase3_peak_gb']:.2f} GB (torch.cuda.max_memory_allocated)",
          flush=True)
    del res
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: smoke-width training exactness
# ---------------------------------------------------------------------------


def phase_exact_train():
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

    smoke = registry.get_smoke_config("internlm2-1.8b")      # f32
    data = make_markov_lm(1, vocab=smoke.vocab_size, n_train=1024,
                          n_test=256, seq_len=64)
    batch = {"tokens": torch.from_numpy(data["train_tokens"][:16]).cuda(),
             "labels": torch.from_numpy(data["train_labels"][:16]).cuda()}
    params = Model(smoke).init(torch.Generator(device="cuda").manual_seed(3))
    grads = {}
    for impl in ("kernel", "reference"):
        model = Model(dataclasses.replace(smoke, attention_impl=impl))
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
    print(f"[exact] f32 smoke: whole-model grads with the kernels against "
          f"plain-attention autograd, worst leaf: max |err|/max |ref| "
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
        adapter = LMAdapter(dataclasses.replace(smoke, attention_impl=impl),
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
    print(f"[exact] f32 smoke SWAP (8 + 6 steps, W 2, elastic): kernels "
          f"against plain versions, averaged params relative L2 {rel:.3e} "
          f"(limit 1e-4), averaged test acc |diff| {acc:.3e} (limit 2e-3)")
    check(rel <= 1e-4, f"smoke SWAP averaged params differ: {rel:.3e}")
    check(acc <= 2e-3, f"smoke SWAP averaged accuracy differs: {acc:.3e}")


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def main() -> None:
    card = phase_device()
    phase_build()
    rows = [phase_kernel(), *phase_kernel_bwd(), phase_swa_avg()]
    phase_serve(card)
    launches = phase_train(card)
    phase_exact()
    phase_exact_train()
    for row in rows:
        row["launches"] = launches[row["name"]]
    import torch
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
