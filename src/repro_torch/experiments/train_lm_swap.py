"""End-to-end driver: SWAP-train a ~100M-parameter transformer LM for a few
hundred steps on the synthetic Markov-chain corpus. Twin of
``examples/train_lm_swap.py``.

The default is the ~100M model (12L x d768, vocab 2048); ``--smoke`` runs
internlm2-1.8b's smoke config for 40 + 15 steps. Any assigned
architecture's smoke config runs with ``--arch``.

  PYTHONPATH=src python -m repro_torch.experiments.train_lm_swap [--smoke] \
      [--arch internlm2-1.8b] [--workers 4] \
      [--checkpoint-dir ckpts/ --checkpoint-every 20] [--resume] \
      [--mesh worker:4,data:2] [--elastic-deadline 30] [--device cpu]

With ``--checkpoint-dir`` the run snapshots its TrainState every
``--checkpoint-every`` steps (epoch-aligned); a relaunch with ``--resume``
continues bit-exactly from the newest snapshot.

The ``--mesh`` / ``--workers`` / ``--elastic-*`` / multi-process flag group
is ``repro_torch.dist.DistConfig``'s, the same as
``repro_torch.launch.train``'s. Two processes of the smoke run on the CPU:

  for i in 0 1; do PYTHONPATH=src python -m \
      repro_torch.experiments.train_lm_swap --smoke --device cpu \
      --workers 2 --mesh worker:2 --coordinator 127.0.0.1:29512 \
      --num-processes 2 --process-id $i & done; wait

Rank 0 prints the summary.
"""
import argparse

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      PhaseConfig, ScheduleConfig,
                                      SWAPConfig)
from repro_torch.core import SWAP, LMAdapter
from repro_torch.data.pipeline import Loader, make_markov_lm
from repro_torch.dist.config import DistConfig, add_dist_args
from repro_torch.kernels.dispatch import require_device


def repro_100m() -> ModelConfig:
    """~100M-param dense LM sized for a few hundred steps."""
    return ModelConfig(
        name="repro-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=2048,
        attention="gqa", rope_theta=10000.0, norm="rmsnorm", act="silu",
        dtype="float32", remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--arch", default="")
    add_dist_args(ap)
    ap.add_argument("--steps1", type=int, default=200)
    ap.add_argument("--steps2", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--phase1-precision", default="float32",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    dist = DistConfig.from_args(args, n_workers_default=4)
    backend = dist.initialize(device=args.device)
    try:
        return _run(args, dist)
    finally:
        if backend is not None:
            torch.distributed.destroy_process_group()


def _run(args, dist: DistConfig):
    dev = require_device(args.device)
    rank0 = dist.process_id == 0
    if args.dump_dist_config:
        dist.to_json(args.dump_dist_config)

    if args.arch:
        cfg = registry.get_smoke_config(args.arch)
    elif args.smoke:
        cfg = registry.get_smoke_config("internlm2-1.8b")
    else:
        cfg = repro_100m()
    if rank0:
        print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    data = make_markov_lm(0, vocab=min(cfg.vocab_size, 2048), n_train=4096,
                          n_test=1024, seq_len=args.seq_len)
    train = {"tokens": data["train_tokens"] % cfg.vocab_size,
             "labels": data["train_labels"] % cfg.vocab_size}
    test_loader = Loader({"tokens": data["test_tokens"] % cfg.vocab_size,
                          "labels": data["test_labels"] % cfg.vocab_size},
                         256, device=dev)

    adapter = LMAdapter(cfg, OptimizerConfig(kind="sgd"))
    steps1 = 40 if args.smoke else args.steps1
    steps2 = 15 if args.smoke else args.steps2
    swap_cfg = SWAPConfig(
        n_workers=dist.n_workers,
        phase1=PhaseConfig(batch_size=64, max_steps=steps1, stop_accuracy=0.7,
                           precision=args.phase1_precision,
                           grad_accum_steps=args.grad_accum,
                           schedule=ScheduleConfig(kind="warmup_linear",
                                                   peak_lr=0.5,
                                                   warmup_steps=steps1 // 5,
                                                   total_steps=steps1)),
        phase2=PhaseConfig(batch_size=16, max_steps=steps2,
                           schedule=ScheduleConfig(kind="warmup_linear",
                                                   peak_lr=0.1,
                                                   warmup_steps=0,
                                                   total_steps=steps2)),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    res = SWAP(adapter, swap_cfg, train, test_loader, dist=dist).run(
        torch.Generator(device=dev).manual_seed(0), resume=args.resume)
    if rank0:
        print(f"phase1: {res['phase1_steps']} steps, "
              f"test acc {res['phase1_test_acc']:.4f}")
        print(f"workers: {['%.4f' % a for a in res['worker_test_accs']]}")
        print(f"SWAP averaged: {res['after_avg_test_acc']:.4f} "
              f"(before: {res['before_avg_test_acc']:.4f})")
        print(f"times: p1 {res['phase1_time']:.1f}s p2 "
              f"{res['phase2_time']:.1f}s (+{res['phase2_eval_time']:.1f}s "
              f"eval) p3 {res['phase3_time']:.1f}s")
    return res


if __name__ == "__main__":
    main()
