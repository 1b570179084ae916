"""SWAP training launcher: twin of ``repro/launch/train.py``, one process.

Runs the three-phase SWAP schedule on an LM architecture of the dense or
ssm family (the smoke config by default; ``--full`` for the full one) on
the synthetic Markov-LM task:

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      [--full] [--workers 4] [--phase1-steps 150] [--phase2-steps 60] \
      [--stop-acc 0.55] [--optimizer sgd|lars|adamw] [--save out.ckpt] \
      [--phase1-precision bfloat16] [--grad-accum 4] \
      [--elastic-deadline 30] [--lost-workers 3] [--device {cuda,cpu}]

Flags, defaults and the printed summary are the reference launcher's.
Runs on CUDA unless ``--device cpu`` is given; with no card visible it
raises. Not ported yet, and so not accepted: ``--checkpoint-*`` and
``--resume`` (ROADMAP A10), ``--supervise``, ``--mesh`` and the other
distribution flags (A13).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint.io import save_pytree
from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, PhaseConfig,
                                      ScheduleConfig, SWAPConfig)
from repro_torch.core.adapters import LMAdapter
from repro_torch.core.swap import SWAP
from repro_torch.data.pipeline import Loader, make_markov_lm
from repro_torch.dist.config import DistConfig, add_dist_args
from repro_torch.kernels.dispatch import require_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=registry.list_archs())
    ap.add_argument("--full", action="store_true",
                    help="use the full (assigned) config instead of smoke")
    add_dist_args(ap)
    ap.add_argument("--lost-workers", default="",
                    help="comma-separated worker indices that never report "
                         "in phase 3 (elastic-averaging drill; needs "
                         "--elastic-deadline > 0)")
    ap.add_argument("--phase1-steps", type=int, default=150)
    ap.add_argument("--phase2-steps", type=int, default=60)
    ap.add_argument("--phase1-batch", type=int, default=256)
    ap.add_argument("--phase2-batch", type=int, default=32)
    ap.add_argument("--stop-acc", type=float, default=0.55)
    ap.add_argument("--peak-lr", type=float, default=0.5)
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "lars", "adamw"])
    ap.add_argument("--phase1-precision", default="float32",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--phase2-precision", default="float32",
                    choices=["float32", "bfloat16", "float16"])
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="phase-1 microbatch accumulation")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default="")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def build(args, cfg=None) -> SWAP:
    """The SWAP run that the parsed flags describe: model, data, optimizer,
    phase schedules and the phase-3 average, on ``args.device``. ``cfg``
    (a Python keyword, not a flag) replaces the config that ``--arch`` and
    ``--full`` select with one of the same arch, e.g. at a cut depth."""
    dev = require_device(args.device)
    dist = DistConfig.from_args(args, n_workers_default=4)
    if cfg is None:
        cfg = (registry.get_config(args.arch) if args.full
               else registry.get_smoke_config(args.arch))
    elif not cfg.name.startswith(args.arch):
        raise ValueError(f"cfg {cfg.name!r} is not of --arch {args.arch}")
    if cfg.family == "cnn":
        raise SystemExit("the CNN path is not ported yet (ROADMAP A9)")

    data = make_markov_lm(args.seed, vocab=min(cfg.vocab_size, 512),
                          n_train=4096, n_test=1024, seq_len=args.seq_len)
    train = {"tokens": data["train_tokens"] % cfg.vocab_size,
             "labels": data["train_labels"] % cfg.vocab_size}
    test_loader = Loader({"tokens": data["test_tokens"] % cfg.vocab_size,
                          "labels": data["test_labels"] % cfg.vocab_size},
                         256, device=dev)

    lr_small = args.peak_lr * args.phase2_batch / args.phase1_batch
    opt = OptimizerConfig(kind=args.optimizer,
                          weight_decay=5e-4 if args.optimizer != "adamw"
                          else 0.01)
    if args.optimizer == "adamw":
        args.peak_lr, lr_small = 3e-3, 1e-3
    adapter = LMAdapter(cfg, opt)
    swap_cfg = SWAPConfig(
        n_workers=dist.n_workers,
        phase1=PhaseConfig(
            batch_size=args.phase1_batch, max_steps=args.phase1_steps,
            stop_accuracy=args.stop_acc,
            precision=args.phase1_precision,
            grad_accum_steps=args.grad_accum,
            schedule=ScheduleConfig(kind="warmup_linear", peak_lr=args.peak_lr,
                                    warmup_steps=args.phase1_steps // 5,
                                    total_steps=args.phase1_steps)),
        phase2=PhaseConfig(
            batch_size=args.phase2_batch, max_steps=args.phase2_steps,
            precision=args.phase2_precision,
            schedule=ScheduleConfig(kind="warmup_linear", peak_lr=lr_small,
                                    warmup_steps=0,
                                    total_steps=args.phase2_steps)),
        seed=args.seed)

    return SWAP(adapter, swap_cfg, train, test_loader, dist=dist)


def main(argv=None, *, cfg=None):
    """Parse ``argv``, run SWAP, print the summary. Returns the results
    dict of ``SWAP.run``. ``cfg``: as for ``build``."""
    args = build_parser().parse_args(argv)
    swap = build(args, cfg)
    cfg, dist = swap.adapter.cfg, swap.dist
    lost = [int(w) for w in args.lost_workers.split(",") if w.strip()]
    if lost and not dist.elastic:
        raise SystemExit("--lost-workers needs --elastic-deadline > 0 "
                         "(a strict phase-3 barrier cannot drop workers)")
    worker_arrivals = ([float("inf") if w in lost else 0.0
                        for w in range(dist.n_workers)] if lost else None)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count() / 1e6:.1f}M "
          f"workers={dist.n_workers} engine=loop")
    t0 = time.time()
    res = swap.run(torch.Generator(device=args.device).manual_seed(args.seed),
                   worker_arrivals=worker_arrivals)
    out = {k: v for k, v in res.items()
           if isinstance(v, (int, float, list)) and k != "phase1_log"}
    out["wall_s"] = time.time() - t0
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, list)}, indent=1))
    print(f"worker accs: {['%.4f' % a for a in res['worker_test_accs']]}")
    if dist.elastic:
        print(f"elastic: {res['phase2_live_workers']}/{dist.n_workers} "
              f"workers in the average, live mask "
              f"{res['worker_live_mask']}")
    print(f"SWAP: before avg {res['before_avg_test_acc']:.4f} -> "
          f"after avg {res['after_avg_test_acc']:.4f}")
    st = res["device"]
    if "phase1_peak_gb" in st:
        print(f"device {st['name']}: memory peak phase 1 "
              f"{st['phase1_peak_gb']:.2f} GB, phase 2 "
              f"{st['phase2_peak_gb']:.2f} GB, phase 3 "
              f"{st['phase3_peak_gb']:.2f} GB")
    if args.save:
        save_pytree(args.save, res["final_bundle"]["params"])
        print(f"saved averaged model to {args.save}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return res


if __name__ == "__main__":
    main()
