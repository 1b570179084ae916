"""SWAP training launcher: twin of ``repro/launch/train.py``.

Runs the three-phase SWAP schedule on an LM architecture of the dense,
moe, ssm, hybrid or vlm family with GQA or MLA attention (the smoke config
by default; ``--full`` for the full one) on the synthetic Markov-LM task
(the CNN is refused, as by the reference: its runs are
``repro_torch.experiments``; the audio family too, since this token data
has no encoder frames, nor has the reference launcher's: its train step is
``train.steps.make_lm_train_step`` on batches with ``frames``). The vlm
family (qwen2-vl-72b) trains on the tokens alone, with no vision
embeddings and M-RoPE at its default positions, as the reference launcher
trains it; at full width it fits no card (~26 bytes a parameter of SWAP
state for 72.7 B parameters), so ``--arch qwen2-vl-72b`` runs its smoke
config:

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      [--full] [--workers 4] [--phase1-steps 150] [--phase2-steps 60] \
      [--stop-acc 0.55] [--optimizer sgd|lars|adamw] [--save out.ckpt] \
      [--phase1-precision bfloat16] [--grad-accum 4] \
      [--checkpoint-dir ckpts/ --checkpoint-every 50] [--resume] \
      [--elastic-deadline 30] [--lost-workers 3] [--supervise 2] \
      [--heartbeat-dir hb/ --heartbeat-interval 5] [--device {cuda,cpu}]

gemma3-1b at full width on one 80 GB card takes a phase-1 batch of 128
(at 256 its 262144-wide logits run the card out of memory):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --full --workers 2 --phase1-batch 128 --elastic-deadline 30

The MoE family and MLA (the router's aux loss is in the step's loss) at
full width on one 80 GB card take a cut depth, as ``chip_smoke.py`` trains
them: deepseek-v2-lite at 3 of 27 layers, granite-moe-3b-a800m at 23 of
32 (``main(argv, cfg=...)``, a Python keyword, takes the cut config):

  PYTHONPATH=src python -c "import dataclasses; \
      from repro_torch.configs import registry; \
      from repro_torch.launch import train; \
      train.main(['--arch', 'deepseek-v2-lite', '--full', '--workers', '2', \
                  '--elastic-deadline', '30'], cfg=dataclasses.replace( \
                  registry.get_config('deepseek-v2-lite'), n_layers=3))"

The hybrid family (zamba2-7b: mamba layers on the SSD kernels, the shared
attention block on the flash kernels at head dim 112) takes the same
keyword: at full width on one 80 GB card ``chip_smoke.py`` trains it at
ZAMBA_TRAIN_LAYERS of its 81 layers (``--arch zamba2-7b --full`` with
``cfg=dataclasses.replace(registry.get_config('zamba2-7b'),
n_layers=...)``); ``--arch zamba2-7b --device cpu`` runs its smoke config.
minicpm3-4b (MLA at the flash head dim 96) likewise, at MINICPM_TRAIN_LAYERS
= 37 of its 62 layers (``--arch minicpm3-4b --full`` with its config cut).

Flags, defaults and the printed summary are the reference launcher's.
Runs on CUDA unless ``--device cpu`` is given; with no card visible it
raises. Long jobs: ``--checkpoint-dir``/``--checkpoint-every`` write
epoch-aligned TrainState snapshots, and a relaunch with ``--resume``
continues bit-exactly from the newest one, mid-phase-1 or mid-phase-2.

Resilience (``resilience``): ``--heartbeat-dir`` switches the elastic
arrivals from the simulated ``--lost-workers`` to real per-worker beacons
(this launcher beats every live worker at each phase-2 chunk boundary; a
``--lost-workers`` worker then never beats, and the monitor declares it
dead). ``--supervise N`` runs both phases under a ``PhaseSupervisor``
with N retries: a divergence rolls back to the last verified snapshot (or
the phase's initial state), and a worker whose beacon goes stale mid-phase
2 is dropped and the phase resumes with the survivors.

Across processes (``--mesh``, ``--coordinator``, ``--num-processes``,
``--process-id``; ``DistConfig.initialize`` runs first thing): one
process a card, phase 1 data parallel over every process, phase 2 on the
``sharded`` engine each worker block training its own workers, phase 3
gathered in worker order (``repro_torch.core.swap``). Two processes of
the smoke config on the CPU, over gloo:

  for i in 0 1; do PYTHONPATH=src python -m repro_torch.launch.train \
      --device cpu --workers 2 --mesh worker:2 --elastic-deadline 30 \
      --coordinator 127.0.0.1:29511 --num-processes 2 --process-id $i & \
  done; wait

On cards the backend is NCCL, one card a process; processes that share
one card take ``--dist-backend gloo`` (NCCL refuses them). Rank 0 prints
the summary and writes ``--save`` / ``--json-out``; a rank that fails
exits non-zero, and so do the others when their next collective finds it
gone (or at the timeout, ``dist.config.DEFAULT_TIMEOUT_S``). A ``model``
axis, ``--supervise``, ``--heartbeat-dir`` and ``--checkpoint-dir``
writes across processes are refused (ROADMAP A13c).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch.checkpoint.io import save_pytree
from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, PhaseConfig,
                                      ScheduleConfig, SWAPConfig)
from repro_torch.core.adapters import LMAdapter
from repro_torch.core.swap import SWAP
from repro_torch.data.pipeline import Loader, make_markov_lm
from repro_torch.dist.config import DistConfig, add_dist_args
from repro_torch.dist.heartbeat import (HeartbeatMonitor, HeartbeatWriter,
                                        beat_on_chunk)
from repro_torch.kernels.dispatch import require_device
from repro_torch.resilience import PhaseSupervisor, SupervisorConfig

N_WORKERS_DEFAULT = 4


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
    ap.add_argument("--checkpoint-dir", default="",
                    help="directory for periodic TrainState snapshots")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot cadence in steps (epoch-aligned); 0 = off")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest snapshot in "
                         "--checkpoint-dir (bit-exact, mid-phase)")
    ap.add_argument("--supervise", type=int, default=0, metavar="RETRIES",
                    help="run both phases under a resilience."
                         "PhaseSupervisor with this retry budget (0 = "
                         "unsupervised): a divergence rolls back to the "
                         "last verified checkpoint, a worker whose "
                         "heartbeat goes stale is dropped")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


class Resilience(NamedTuple):
    """What ``--supervise``, ``--heartbeat-*`` and ``--lost-workers``
    make: the supervisor for ``SWAP``, and ``SWAP.run``'s ``heartbeats``,
    ``phase2_hooks`` and ``worker_arrivals``."""
    supervisor: Optional[PhaseSupervisor]
    monitor: Optional[HeartbeatMonitor]
    phase2_hooks: List
    worker_arrivals: Optional[List[float]]


def resilience(args, dist: DistConfig) -> Resilience:
    """The resilience wiring of the parsed flags. With ``--heartbeat-dir``
    every worker that is not in ``--lost-workers`` gets a writer that
    beats once now and at each phase-2 chunk boundary, and one monitor
    serves the supervisor and phase 3; without it ``--lost-workers`` is
    the simulated arrivals of the elastic phase 3."""
    lost = [int(w) for w in args.lost_workers.split(",") if w.strip()]
    if lost and not dist.elastic:
        raise SystemExit("--lost-workers needs --elastic-deadline > 0 "
                         "(a strict phase-3 barrier cannot drop workers)")
    monitor, hooks, arrivals = None, [], None
    if dist.heartbeats:
        writers = [HeartbeatWriter(dist.heartbeat_dir, w,
                                   interval_s=dist.heartbeat_interval_s)
                   for w in range(dist.n_workers) if w not in lost]
        for wtr in writers:
            wtr.beat()                       # everyone alive at launch
        monitor = HeartbeatMonitor(dist.heartbeat_dir, dist.n_workers,
                                   timeout_s=dist.resolved_heartbeat_timeout)
        hooks.append(beat_on_chunk(writers))
    elif lost:
        arrivals = [float("inf") if w in lost else 0.0
                    for w in range(dist.n_workers)]
    supervisor = (PhaseSupervisor(SupervisorConfig(max_retries=args.supervise),
                                  monitor=monitor)
                  if args.supervise > 0 else None)
    return Resilience(supervisor, monitor, hooks, arrivals)


def build(args, cfg=None, supervisor=None) -> SWAP:
    """The SWAP run that the parsed flags describe: model, data, optimizer,
    phase schedules and the phase-3 average, on ``args.device``. ``cfg``
    (a Python keyword, not a flag) replaces the config that ``--arch`` and
    ``--full`` select with one of the same arch, e.g. at a cut depth;
    ``supervisor``: ``resilience(args, dist).supervisor``."""
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    dev = require_device(args.device)
    dist = DistConfig.from_args(args, n_workers_default=N_WORKERS_DEFAULT)
    if cfg is None:
        cfg = (registry.get_config(args.arch) if args.full
               else registry.get_smoke_config(args.arch))
    elif not cfg.name.startswith(args.arch):
        raise ValueError(f"cfg {cfg.name!r} is not of --arch {args.arch}")
    if cfg.family == "cnn":
        raise SystemExit("use python -m repro_torch.experiments."
                         "table1_cifar10 for the CNN")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the training launcher makes token data only, and "
            f"the encoder-decoder model needs frames; the reference's "
            f"launcher (repro/launch/train.py) builds none either. Train it "
            f"with train.steps.make_lm_train_step on batches that carry "
            f"'frames'")

    lr_small = args.peak_lr * args.phase2_batch / args.phase1_batch
    opt = OptimizerConfig(kind=args.optimizer,
                          weight_decay=5e-4 if args.optimizer != "adamw"
                          else 0.01)
    if args.optimizer == "adamw":
        args.peak_lr, lr_small = 3e-3, 1e-3
    # the model first: a config the port refuses is refused before the data
    adapter = LMAdapter(cfg, opt)

    data = make_markov_lm(args.seed, vocab=min(cfg.vocab_size, 512),
                          n_train=4096, n_test=1024, seq_len=args.seq_len)
    train = {"tokens": data["train_tokens"] % cfg.vocab_size,
             "labels": data["train_labels"] % cfg.vocab_size}
    test_loader = Loader({"tokens": data["test_tokens"] % cfg.vocab_size,
                          "labels": data["test_labels"] % cfg.vocab_size},
                         256, device=dev)
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
        seed=args.seed, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)

    return SWAP(adapter, swap_cfg, train, test_loader, dist=dist,
                supervisor=supervisor)


def main(argv=None, *, cfg=None):
    """Parse ``argv``, initialize the process group of a multi-process run,
    run SWAP, print the summary (rank 0). Returns the results dict of
    ``SWAP.run``. ``cfg``: as for ``build``."""
    args = build_parser().parse_args(argv)
    dist = DistConfig.from_args(args, n_workers_default=N_WORKERS_DEFAULT)
    backend = dist.initialize(device=args.device)
    try:
        return _main(args, dist, backend, cfg)
    finally:
        if backend is not None:
            torch.distributed.destroy_process_group()


def _main(args, dist: DistConfig, backend: Optional[str], cfg):
    if backend is not None:
        print(f"dist: process {dist.process_id}/{dist.num_processes} "
              f"backend={backend} coordinator={dist.coordinator} "
              f"device={args.device}", flush=True)
    if args.dump_dist_config:
        dist.to_json(args.dump_dist_config)
    rank0 = dist.process_id == 0
    wiring = resilience(args, dist)
    swap = build(args, cfg, supervisor=wiring.supervisor)
    cfg = swap.adapter.cfg
    if rank0:
        print(f"arch={cfg.name} family={cfg.family} "
              f"params={cfg.param_count() / 1e6:.1f}M "
              f"workers={dist.n_workers} "
              f"engine={dist.resolved_engine(swap.mesh)}"
              + (f" mesh={'x'.join(map(str, dist.mesh_shape))}"
                 if dist.mesh_shape else ""))
    t0 = time.time()
    res = swap.run(torch.Generator(device=args.device).manual_seed(args.seed),
                   resume=args.resume,
                   worker_arrivals=wiring.worker_arrivals,
                   phase2_hooks=wiring.phase2_hooks,
                   heartbeats=wiring.monitor)
    if not rank0:
        return res
    out = {k: v for k, v in res.items()
           if isinstance(v, (int, float, list))
           and k not in ("phase1_log", "collectives")}
    out["wall_s"] = time.time() - t0
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, list)}, indent=1))
    print(f"worker accs: {['%.4f' % a for a in res['worker_test_accs']]}")
    if dist.elastic:
        print(f"elastic: {res['phase2_live_workers']}/{dist.n_workers} "
              f"workers in the average, live mask "
              f"{res['worker_live_mask']}")
    for ev in res["recovery_events"]:
        print(f"recovery: {ev['kind']} in {ev['tag']} (attempt "
              f"{ev['attempt']}) -> resumed from {ev['restored_from']} at "
              f"step {ev['restored_step']}")
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
