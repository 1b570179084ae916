"""Continuous-batching serving: requests of different lengths stream
through a fixed slot pool sharing one decode step and one cache. Twin of
``examples/serve_continuous.py``.

  PYTHONPATH=src python -m repro_torch.experiments.serve_continuous \
      [--arch mamba2-2.7b] [--engine {loop,compiled}] [--slots 2] \
      [--requests 6] [--device {cuda,cpu}]

``compiled`` decodes K = 4 tokens a host call (one CUDA graph on the card)
and prints its decode-call and bulk-transfer counts, which must be equal;
``loop`` is the per-step oracle and prints the same token ids. The prompts
are the reference's (``data.prng.randint`` under ``fold_in`` of key 0);
the params are the port's own random init from seed 0, so the tokens are
not the reference's.
"""
import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.data import prng
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.model import Model
from repro_torch.serve import CompiledServingEngine, Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=registry.ASSIGNED_ARCHS)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--engine", default="compiled",
                    choices=["loop", "compiled"],
                    help="compiled = K decode steps a host call (a CUDA "
                         "graph on the card); loop = the per-step oracle")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = registry.get_smoke_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    if args.engine == "compiled":
        engine = CompiledServingEngine(model, params, max_batch=args.slots,
                                       max_seq=96, decode_block=4)
    else:
        engine = ServingEngine(model, params, max_batch=args.slots,
                               max_seq=96)

    key = prng.PRNGKey(0)
    reqs = []
    for i in range(args.requests):
        L = 6 + 3 * i
        prompt = prng.randint(prng.fold_in(key, i), (L,), 0, cfg.vocab_size)
        reqs.append(Request(rid=i, prompt=prompt.long().to(dev),
                            max_new_tokens=5 + i))

    t0 = time.perf_counter()
    with torch.inference_mode():
        results = engine.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    print(f"{args.arch} [{args.engine}]: {args.requests} requests through "
          f"{args.slots} slots -> {total} tokens in {dt:.1f}s")
    if args.engine == "compiled":
        st = engine.stats
        print(f"  {st['decode_calls']} fused decode calls, "
              f"{st['decode_transfers']} bulk host transfers, "
              f"{st['admissions']} admissions")
    for rid, toks in results.items():
        print(f"  req {rid} ({len(reqs[rid].prompt)}-token prompt): {toks}")
    return results, engine


if __name__ == "__main__":
    main()
