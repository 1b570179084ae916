"""Batched serving launcher: prefill a batch of prompts, decode N tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      [--full] [--engine {loop,compiled}] [--batch 8] [--prompt-len 64] \
      [--new-tokens 32] [--ckpt model.ckpt] [--seed 0] [--kv-int8] \
      [--device {cuda,cpu}] [--follow DIR ...]

Twin of ``repro/launch/serve.py`` (single device). Two decode engines that
give identical greedy tokens:
  * ``loop`` -- one decode step per iteration, each step's tokens read back
    to the host;
  * ``compiled`` -- tokens stay on the device in one (B, new_tokens)
    buffer, with one bulk copy to the host at the end.

gemma3-1b at full width, with a prompt past its local layers' window of
512: ``--arch gemma3-1b --full --prompt-len 2048``. The MoE family and MLA:
``--arch deepseek-v2-lite --full`` (MLA, the flash forward at head dim 192;
15.7 B parameters, 62.7 GB in f32 on an 80 GB card) and ``--arch
granite-moe-3b-a800m --full``; ``--device cpu`` without ``--full`` serves
their smoke configs on the plain versions. The hybrid family: ``--arch
zamba2-7b --full`` (81 mamba layers on the SSD kernels, the one shared
attention block before every 6 on the flash forward at head dim 112; 6.75
B parameters, 27.0 GB in f32). minicpm3-4b: ``--arch minicpm3-4b --full``
(MLA, the flash forward at head dim 96). The audio family: ``--arch
whisper-base --full`` (encoder-decoder; stub frame embeddings (batch, 1500,
512) made from the seed, as the reference makes them; decoder prompts up
to its context of 448 tokens). The vlm family: ``--arch qwen2-vl-72b``
(M-RoPE; stub patch embeddings (batch, n_vision_tokens, d_model) from the
seed in place of the first prompt tokens, as the reference makes them, so
a prompt holds at least n_vision_tokens: 256 at full width, 16 in the
smoke config). Its full width holds 72.7 B parameters, 291 GB in f32:
one 80 GB card serves it with the depth cut (``chip_smoke.py`` serves
QWEN_VL_SERVE_LAYERS of its 80 layers).

Prefill and decode rates are reported separately (prompt tok/s vs generated
tok/s), plus an overall rate that includes prefill. Runs on CUDA unless
``--device cpu`` is given; with no card visible it raises.

Live following, the consumer half of the train -> serve loop
(``serve/publish.py``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --follow ckpts/ [--follow-timeout 10] [--kv-layout {auto,dense,paged}] \
      [--page-size 16] [--decode-block 4] [--admit-timeout 0]

tails ``ckpts/`` for the atomic publish snapshots of a ``WeightPublisher``,
swaps each new weight generation into a running ``CompiledServingEngine``
without dropping in-flight requests, and serves a continuous synthetic
request stream (the reference's prompts, ``data.prng`` under ``fold_in``
of key seed + 1) until no new generation appears for ``--follow-timeout``
seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint.io import load_pytree
from repro_torch.configs import registry
from repro_torch.data import prng
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.model import Model


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decode_loop(model, params, cache, tok, S, new_tokens):
    """Per-step engine: each step's tokens are read back to the host."""
    tokens = []
    for i in range(new_tokens):
        tokens.append(tok.cpu())
        logits, cache = model.decode(params, cache, tok, S + i)
        tok = torch.argmax(logits, -1)[:, None]
    return torch.cat(tokens, dim=1)


def _decode_compiled(model, params, cache, tok, S, new_tokens):
    """Tokens stay on the device; one bulk host copy at the end."""
    out = torch.empty((tok.shape[0], new_tokens), dtype=torch.long,
                      device=tok.device)
    for i in range(new_tokens):
        out[:, i] = tok[:, 0]
        logits, cache = model.decode(params, cache, tok, S + i)
        tok = torch.argmax(logits, -1)[:, None]
    return out.cpu()


@torch.inference_mode()
def generate(model: Model, params, prompts, new_tokens: int,
             extras=None, engine: str = "loop"):
    """Batched greedy generation. prompts: (B, S) integer tensor on the
    params' device; ``extras``: keywords of the prefill (the vlm family's
    ``vision_embeds``, the audio family's ``frames``); decode takes none.
    Returns (tokens (B, new_tokens) long on the CPU,
    stats)."""
    if engine not in ("loop", "compiled"):
        raise ValueError(f"unknown engine {engine!r}")
    extras = extras or {}
    prompts = prompts.long()
    device = prompts.device
    B, S = prompts.shape

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts, cache_len=S + new_tokens,
                                  **extras)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, -1)[:, None]
    decode = _decode_compiled if engine == "compiled" else _decode_loop
    t0 = time.perf_counter()
    out = decode(model, params, cache, tok, S, new_tokens)
    _sync(device)
    t_decode = time.perf_counter() - t0

    gen = B * new_tokens
    total = t_prefill + t_decode
    return out, {
        "engine": engine,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "prefill_tokens_per_s": B * S / max(t_prefill, 1e-9),
        "decode_tokens_per_s": gen / max(t_decode, 1e-9),
        "tokens_per_s": gen / max(total, 1e-9),
    }


def build_model(arch: str, *, full: bool, kv_int8: bool = False,
                seed: int = 0, device: str = "cuda"):
    """(model, params) for an arch, with random params from ``seed``."""
    dev = require_device(device)
    cfg = registry.get_config(arch) if full else registry.get_smoke_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    return model, params


def follow(model: Model, cfg, params, args) -> dict:
    """Serve a continuous synthetic request stream while tailing
    ``args.follow`` for publish snapshots, swapping each new weight
    generation into the live engine without dropping in-flight requests.
    Ends after ``--follow-timeout`` seconds with no new generation (each
    pickup restarts the clock), then finishes what was admitted. Returns
    {pickups, per_generation: {gen: {requests, tokens}}, stats}."""
    from repro_torch.serve.compiled import CompiledServingEngine
    from repro_torch.serve.engine import Request
    from repro_torch.serve.publish import PublishFollower

    dev = params["embed"]["table"].device
    max_seq = args.prompt_len + args.new_tokens + 8
    engine = CompiledServingEngine(
        model, params, max_batch=args.batch, max_seq=max_seq,
        decode_block=args.decode_block, prefill_buckets=[args.prompt_len],
        kv_layout=args.kv_layout, page_size=args.page_size,
        admit_timeout_s=args.admit_timeout or None)
    follower = PublishFollower(args.follow, template=params)
    upd = follower.poll()
    if upd is not None:                       # seed from the newest publish
        gen, new = upd
        engine.publish(new, generation=gen)
        print(f"seeded from publish generation {gen}")
    engine.warmup(dual=True)                  # both buffers' graphs, dual's

    key = prng.PRNGKey(args.seed + 1)
    rid = 0
    requests: list = []

    def _feed():
        """Keep every slot busy, so that swaps land on a loaded engine."""
        nonlocal rid
        while len(engine.waiting) + engine.active < args.batch:
            prompt = prng.randint(prng.fold_in(key, rid), (args.prompt_len,),
                                  0, cfg.vocab_size)
            req = Request(rid=rid, prompt=prompt.long().to(dev),
                          max_new_tokens=args.new_tokens)
            requests.append(req)
            engine.submit(req)
            rid += 1

    pickups = 0
    deadline = time.time() + args.follow_timeout
    while time.time() < deadline:
        upd = follower.poll()
        if upd is not None:
            gen, new = upd
            engine.publish(new, generation=gen)
            applied = "applied" if engine.generation == gen else "deferred"
            print(f"picked up generation {gen} ({applied}); "
                  f"{engine.active} requests in flight")
            pickups += 1
            deadline = time.time() + args.follow_timeout
        _feed()
        engine.step()
    while engine.active or engine.waiting:    # finish what was admitted
        engine.step()

    per_gen: dict = {}
    for req in requests:
        if req.done:
            e = per_gen.setdefault(req.generation, {"requests": 0,
                                                    "tokens": 0})
            e["requests"] += 1
            e["tokens"] += len(req.generated)
    st = engine.stats
    if st["decode_transfers"] != st["decode_calls"]:
        raise RuntimeError(
            "publish broke the single-transfer-per-decode-call invariant: "
            f"{st['decode_transfers']} block reads for {st['decode_calls']} "
            f"decode calls")
    return {"pickups": pickups, "per_generation": per_gen, "stats": st}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=registry.list_archs())
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--engine", default="compiled",
                    choices=["loop", "compiled"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache")
    ap.add_argument("--kv-layout", default="auto",
                    choices=["auto", "dense", "paged"],
                    help="the compiled engine's KV layout in --follow mode "
                         "(auto = paged where the arch has a pageable "
                         "layer)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens a KV page for --kv-layout paged")
    ap.add_argument("--follow", default="",
                    help="live-follow a publish directory: swap new weight "
                         "generations into a running engine while serving "
                         "(see repro_torch.serve.publish)")
    ap.add_argument("--follow-timeout", type=float, default=10.0,
                    help="leave --follow mode after this many seconds "
                         "without a new generation")
    ap.add_argument("--decode-block", type=int, default=4,
                    help="decode steps a host call in --follow")
    ap.add_argument("--admit-timeout", type=float, default=0.0,
                    help="seconds a request may wait for admission before "
                         "it is rejected (0 = no bound)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    model, params = build_model(args.arch, full=args.full,
                                kv_int8=args.kv_int8, seed=args.seed,
                                device=args.device)
    cfg = model.cfg
    if args.ckpt:
        params = load_pytree(args.ckpt, params)
        print(f"restored {args.ckpt}")
    if args.follow:
        report = follow(model, cfg, params, args)
        print(f"follow mode done: {report['pickups']} generation pickups")
        for gen in sorted(report["per_generation"]):
            e = report["per_generation"][gen]
            print(f"  generation {gen}: {e['requests']} requests, "
                  f"{e['tokens']} tokens")
        st = report["stats"]
        print(f"decode_calls={st['decode_calls']} "
              f"decode_transfers={st['decode_transfers']} "
              f"publish_swaps={st['publish_swaps']} "
              f"dual_decode_calls={st['dual_decode_calls']}")
        return report
    dev = params["embed"]["table"].device
    g = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, device=dev)
    extras = {}
    if cfg.family == "vlm":         # stub patch embeddings from the seed
        extras["vision_embeds"] = torch.randn(
            (args.batch, cfg.n_vision_tokens, cfg.d_model), generator=g,
            device=dev).to(model.dtype)
    if cfg.family == "audio":       # stub frame embeddings from the seed
        extras["frames"] = torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), generator=g,
            device=dev).to(model.dtype)
    out, stats = generate(model, params, prompts, args.new_tokens,
                          extras=extras, engine=args.engine)
    print(f"arch={cfg.name} engine={args.engine} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new_tokens} "
          f"device={stats['device']}")
    print(f"prefill {stats['prefill_s']*1e3:.1f} ms "
          f"({stats['prefill_tokens_per_s']:.1f} prompt tok/s), decode "
          f"{stats['decode_s']*1e3:.1f} ms "
          f"({stats['decode_tokens_per_s']:.1f} tok/s), overall "
          f"{stats['tokens_per_s']:.1f} tok/s incl. prefill")
    print("first sequences:", out[:2, :16].tolist())
    return out, stats


if __name__ == "__main__":
    main()
