"""Train, publish and serve in one process. Twin of
``examples/train_and_serve.py``.

SWAP phase 2 runs W independent small-batch workers; at every epoch
boundary a ``WeightPublisher`` hook folds the across-worker mean into a
running average (online SWA over the SWAP ensemble, on the swa_avg kernel
on the card) and swaps the new weight generation into a
``CompiledServingEngine`` that answers requests between training chunks.
In-flight requests finish token-exact on the weights they were admitted
under; new admissions take the latest average.

  PYTHONPATH=src python -m repro_torch.experiments.train_and_serve \
      [--workers 2] [--steps2 48] [--publish-dir ckpts_pub/] \
      [--device {cuda,cpu}]

At the end each served request is held against an isolated ``generate`` on
the weights it is pinned to, reloaded from the publish directory: the
train -> publish -> serve path is audited token for token. The model is
the arch's smoke config; the params and prompts come from the port's own
seeds, so the tokens are not the reference's.
"""
import argparse
import tempfile

import torch

from repro_torch.checkpoint.state import list_publishes, load_publish
from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, PhaseConfig,
                                      ScheduleConfig, SWAPConfig)
from repro_torch.core import SWAP, LMAdapter
from repro_torch.data import prng
from repro_torch.data.pipeline import Loader, make_markov_lm
from repro_torch.kernels.dispatch import require_device
from repro_torch.launch.serve import generate
from repro_torch.serve import CompiledServingEngine, Request, WeightPublisher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--steps1", type=int, default=24)
    ap.add_argument("--steps2", type=int, default=48)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--publish-dir", default="",
                    help="publish snapshot dir (default: a temp dir)")
    ap.add_argument("--requests-per-epoch", type=int, default=2)
    ap.add_argument("--new-tokens", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = registry.get_smoke_config(args.arch)
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    pub_dir = args.publish_dir or tempfile.mkdtemp(prefix="swap_publish_")

    # a small corpus, so that phase 2 crosses several epoch boundaries (each
    # one a publish): 512 samples / batch 32 = 16 steps an epoch
    data = make_markov_lm(0, vocab=min(cfg.vocab_size, 2048), n_train=512,
                          n_test=256, seq_len=args.seq_len)
    train = {"tokens": data["train_tokens"] % cfg.vocab_size,
             "labels": data["train_labels"] % cfg.vocab_size}
    test_loader = Loader({"tokens": data["test_tokens"] % cfg.vocab_size,
                          "labels": data["test_labels"] % cfg.vocab_size},
                         128, device=dev)

    adapter = LMAdapter(cfg, OptimizerConfig(kind="sgd"))
    swap_cfg = SWAPConfig(
        n_workers=args.workers,
        phase1=PhaseConfig(batch_size=64, max_steps=args.steps1,
                           stop_accuracy=0.7,
                           schedule=ScheduleConfig(
                               kind="warmup_linear", peak_lr=0.5,
                               warmup_steps=max(1, args.steps1 // 5),
                               total_steps=args.steps1)),
        phase2=PhaseConfig(batch_size=32, max_steps=args.steps2,
                           schedule=ScheduleConfig(
                               kind="warmup_linear", peak_lr=0.1,
                               warmup_steps=0, total_steps=args.steps2)))

    # the engine exists before training ends: it starts on a random init
    # (generation 0) and takes each generation phase 2 publishes
    model = adapter.model
    init_params = model.init(torch.Generator(device=dev).manual_seed(7))
    prompt_len = 8
    engine = CompiledServingEngine(
        model, init_params, max_batch=2,
        max_seq=prompt_len + args.new_tokens + 8, decode_block=4,
        prefill_buckets=[prompt_len])
    engine.warmup(dual=True)
    publisher = WeightPublisher([engine], directory=pub_dir)

    served = []
    pkey = prng.PRNGKey(123)

    def pump(state, done):
        """Admit new requests and advance the engine a little between
        training chunks, without draining it, so that the next publish
        lands while requests are in flight (the dual-generation block)."""
        for _ in range(args.requests_per_epoch):
            prompt = prng.randint(prng.fold_in(pkey, len(served)),
                                  (prompt_len,), 0, cfg.vocab_size)
            # staggered budgets: every other request runs longer, so slots
            # pinned to the previous generation overlap with new ones
            budget = args.new_tokens + (len(served) % 2) * 7
            req = Request(rid=len(served), prompt=prompt.long().to(dev),
                          max_new_tokens=budget)
            served.append(req)
            engine.submit(req)
        for _ in range(2):
            engine.step()

    # the publisher first, the pump second: every admission happens at a
    # just-published generation, never the random init
    res = SWAP(adapter, swap_cfg, train, test_loader).run(
        torch.Generator(device=dev).manual_seed(0),
        phase2_hooks=[publisher.on_epoch, pump])
    while engine.active or engine.waiting:
        engine.step()

    print(f"\nphase1: {res['phase1_steps']} steps, "
          f"test acc {res['phase1_test_acc']:.4f}")
    print(f"SWAP averaged: {res['after_avg_test_acc']:.4f} "
          f"(before: {res['before_avg_test_acc']:.4f})")
    print(f"published {publisher.generation} generations to {pub_dir}")

    st = engine.stats
    if st["decode_transfers"] != st["decode_calls"]:
        raise RuntimeError("publishing added host syncs to the decode loop: "
                           f"{st['decode_transfers']} block reads for "
                           f"{st['decode_calls']} decode calls")
    print(f"engine: {st['decode_calls']} decode calls, "
          f"{st['decode_transfers']} transfers, "
          f"{st['publish_swaps']} swaps, "
          f"{st['dual_decode_calls']} dual-generation calls")

    # the audit: each request against an isolated generate on the snapshot
    # it is pinned to, reloaded from the publish directory
    by_gen = {p["generation"]: p["path"] for p in list_publishes(pub_dir)}
    checked = 0
    for req in served:
        if not req.done or req.generation not in by_gen:
            continue
        params_g = load_publish(by_gen[req.generation], init_params)
        out, _ = generate(model, params_g, req.prompt[None, :],
                          len(req.generated))
        ref = out[0].tolist()
        if req.generated != ref:
            raise RuntimeError(
                f"request {req.rid} (generation {req.generation}) diverged "
                f"from its pinned snapshot: {req.generated} vs {ref}")
        checked += 1
    gens = sorted({r.generation for r in served if r.done})
    print(f"token-exactness audit: {checked} requests across "
          f"generations {gens} all match their pinned snapshots")
    return {"served": served, "engine": engine, "publisher": publisher,
            "result": res, "checked": checked}


if __name__ == "__main__":
    main()
