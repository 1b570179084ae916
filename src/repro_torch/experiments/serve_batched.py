"""Batched serving: prefill a batch of prompts on any assigned architecture
and decode tokens with the KV/state cache (full-attention, sliding-window,
MLA-latent and SSM caches all exercised). Twin of
``examples/serve_batched.py``.

  PYTHONPATH=src python -m repro_torch.experiments.serve_batched \
      [--arch mamba2-2.7b] [--batch 4] [--prompt-len 48] \
      [--new-tokens 24] [--device {cuda,cpu}]

The prompts (``data.prng.randint`` under key 0) and the vlm's patch or the
audio family's frame embeddings (``data.prng.normal``) are the reference's;
the params are the port's own random init from seed 0.
"""
import argparse

import torch

from repro_torch.configs import registry
from repro_torch.data import prng
from repro_torch.kernels.dispatch import require_device
from repro_torch.launch.serve import generate
from repro_torch.models.model import Model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b",
                    choices=registry.ASSIGNED_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = registry.get_smoke_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    key = prng.PRNGKey(0)

    B = args.batch
    prompts = prng.randint(key, (B, args.prompt_len), 0, cfg.vocab_size)
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = prng.normal(
            key, (B, cfg.n_vision_tokens, cfg.d_model)).to(dev, model.dtype)
    if cfg.family == "audio":
        extras["frames"] = prng.normal(
            key, (B, cfg.encoder_seq, cfg.d_model)).to(dev, model.dtype)

    out, stats = generate(model, params, prompts.long().to(dev),
                          args.new_tokens, extras=extras)
    print(f"{args.arch} ({cfg.family}): batch={B} "
          f"prompt={args.prompt_len} +{args.new_tokens} tokens")
    print(f"prefill {stats['prefill_s']*1e3:.0f}ms  "
          f"decode {stats['decode_s']*1e3:.0f}ms  "
          f"{stats['tokens_per_s']:.0f} tok/s")
    print("sample:", out[0].tolist())
    return out, stats


if __name__ == "__main__":
    main()
