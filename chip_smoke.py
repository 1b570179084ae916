#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check exits non-zero:

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from the repository's sources;
3. kernel vs plain: hold each kernel against its plain PyTorch version on
   the card over a grid of shapes, dtypes and masks, and time it at the
   shape the main path gives it, beside its bound and a library call;
4. full-width serve (internlm2-1.8b, random weights from a seed): the main
   path, with every kernel's launch count set to 0 just before it and read
   just after; then prefill logits with the kernel against the plain
   attention on the card (in f32) and against the f32 model (in bf16);
5. smoke-width exactness: continuous batching against single-request
   generation, token for token, in f32.

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
PREFILL_SHAPE = (8, 512, 512, 16, 8, 128)        # B, Sq, Skv, H, KVH, D
ENGINE_PROMPTS = (37, 200, 513, 128)             # ServingEngine requests


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
    from repro_torch.kernels.flash_attention import kernel
    t0 = time.perf_counter()
    built = kernel.build()
    print(f"[build] flash_fwd: {built.path.name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
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
    # the shapes the main path gives the kernel: generate's batched prefill
    # and the engine's batch-1 prefills
    cases.append((PREFILL_SHAPE, "bfloat16", True, 0, 0))
    for S in ENGINE_PROMPTS:
        cases.append(((1, S, S, 16, 8, 128), "bfloat16", True, 0, 0))
    return cases


def phase_kernel():
    import torch
    from repro_torch.kernels.flash_attention import kernel, ops
    worst = {}
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
        if shape == PREFILL_SHAPE:
            prefill_err = err.max().item()
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
        "launches": None, "max_abs_err": prefill_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
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
    # --- the main path, with the launch count read around it ---
    kernel.flash_fwd.launches = 0
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
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 5: smoke-width exactness
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


def main() -> None:
    card = phase_device()
    phase_build()
    report = phase_kernel()
    report["launches"] = phase_serve(card)
    phase_exact()
    import torch
    print(json.dumps({"kernels": [report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
