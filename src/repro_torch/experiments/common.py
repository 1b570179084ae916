"""Shared experiment scaffolding: twin of the task and runner half of
``benchmarks/common.py``. Synthetic CIFAR/LM analogs and SWAP/SGD/SWA
runners with paper-shaped hyper-parameter schedules.

The paper's absolute numbers are V100/CIFAR-specific; these experiments
reproduce the CLAIM STRUCTURE (orderings and time ratios) on synthetic data:
  - small-batch > large-batch test accuracy at equal epochs,
  - SWAP(after avg) ~ small-batch accuracy at ~large-batch wall-clock,
  - SWAP beats every individual phase-2 worker,
  - sequential SWA needs a multiple of SWAP's time for the same quality.

``cnn_task``, ``lm_task``, ``run_sgd`` and ``run_swap`` take ``device=``
(CUDA unless the caller asks for the CPU; raises when no card is visible);
``run_swa`` trains on the device of the bundle it starts from.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      PhaseConfig, ScheduleConfig, SWAConfig,
                                      SWAPConfig)
from repro_torch.core.adapters import CNNAdapter, LMAdapter
from repro_torch.core.swa import SWA
from repro_torch.core.swap import SWAP, SGDRun
from repro_torch.data.pipeline import Loader, make_gmm_images, make_markov_lm
from repro_torch.kernels.dispatch import require_device


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def cnn_task(seed: int = 0, n_classes: int = 10, noise: float = 2.0,
             n_train: int = 2048, n_test: int = 1024, *,
             cfg: ModelConfig = None, device: str = "cuda"):
    """(adapter, train arrays, test loader). ``cfg`` (a Python keyword, not
    a flag) replaces the cifar-cnn smoke config, e.g. with ``config()`` at
    full width; the images take its ``image_size``. The model's classes
    are the task's ``n_classes``: the reference keeps the config's 10
    for Table 4's 20-class task, where ``take_along_axis`` reads NaN for
    every label past 9 and the loss is NaN from the first step."""
    dev = require_device(device)
    if cfg is None:
        cfg = registry.get_smoke_config("cifar-cnn")
    if cfg.n_classes != n_classes:
        cfg = dataclasses.replace(cfg, n_classes=n_classes)
    data = make_gmm_images(seed, n_classes=n_classes,
                           image_size=cfg.image_size, n_train=n_train,
                           n_test=n_test, noise=noise)
    train = {"images": data["train_images"], "labels": data["train_labels"]}
    test_loader = Loader({"images": data["test_images"],
                          "labels": data["test_labels"]}, 256, device=dev)
    adapter = CNNAdapter(cfg, OptimizerConfig(kind="sgd", momentum=0.9,
                                              weight_decay=5e-4))
    return adapter, train, test_loader


def lm_task(seed: int = 0, arch: str = "internlm2-1.8b", seq_len: int = 32,
            n_train: int = 2048, n_test: int = 512,
            temperature: float = 0.15, *, device: str = "cuda"):
    dev = require_device(device)
    cfg = registry.get_smoke_config(arch)
    data = make_markov_lm(seed, vocab=min(cfg.vocab_size, 256),
                          n_train=n_train, n_test=n_test, seq_len=seq_len,
                          temperature=temperature)
    train = {"tokens": data["train_tokens"] % cfg.vocab_size,
             "labels": data["train_labels"] % cfg.vocab_size}
    test_loader = Loader({"tokens": data["test_tokens"] % cfg.vocab_size,
                          "labels": data["test_labels"] % cfg.vocab_size},
                         256, device=dev)
    adapter = LMAdapter(cfg, OptimizerConfig(kind="sgd", momentum=0.9,
                                             weight_decay=5e-4))
    return adapter, train, test_loader


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------


def run_sgd(adapter, train, test_loader, *, batch_size: int, steps: int,
            peak_lr: float, warmup_frac: float = 0.2, seed: int = 0,
            stop_accuracy: float = 1.01, device: str = "cuda") -> Dict:
    """One plain SGD training run (small-batch or large-batch baseline)."""
    dev = require_device(device)
    phase = PhaseConfig(
        batch_size=batch_size, max_steps=steps, stop_accuracy=stop_accuracy,
        schedule=ScheduleConfig(kind="warmup_linear", peak_lr=peak_lr,
                                warmup_steps=int(steps * warmup_frac),
                                total_steps=steps))
    run = SGDRun(adapter, phase, train, seed=seed, device=dev)
    bundle = adapter.init(torch.Generator(device=dev).manual_seed(seed))
    t0 = time.perf_counter()
    bundle, opt_state, taken, ema = run.run(bundle)
    t1 = time.perf_counter()
    return {"test_acc": adapter.eval_accuracy(bundle, test_loader),
            "train_ema": ema, "steps": taken, "time": t1 - t0,
            "bundle": bundle, "opt_state": opt_state}


def swap_config(*, workers: int, b1: int, b2: int, steps1: int,
                steps2: int, lr1: float, lr2: float, stop_acc: float,
                seed: int = 0) -> SWAPConfig:
    """The SWAP schedule of ``run_swap``: warmup-linear phase 1 to
    ``stop_acc``, linear-decay phase 2, BN recompute over 4 x 256 images."""
    return SWAPConfig(
        n_workers=workers,
        phase1=PhaseConfig(batch_size=b1, max_steps=steps1,
                           stop_accuracy=stop_acc,
                           schedule=ScheduleConfig(
                               kind="warmup_linear", peak_lr=lr1,
                               warmup_steps=max(1, steps1 // 5),
                               total_steps=steps1)),
        phase2=PhaseConfig(batch_size=b2, max_steps=steps2,
                           schedule=ScheduleConfig(
                               kind="warmup_linear", peak_lr=lr2,
                               warmup_steps=0, total_steps=steps2)),
        bn_recompute_batches=4, bn_recompute_batch_size=256, seed=seed)


def run_swap(adapter, train, test_loader, *, seed: int = 0,
             collect_curves: bool = False, device: str = "cuda",
             **hp) -> Dict:
    """SWAP on ``swap_config(seed=seed, **hp)``."""
    dev = require_device(device)
    cfg = swap_config(seed=seed, **hp)
    return SWAP(adapter, cfg, train, test_loader).run(
        torch.Generator(device=dev).manual_seed(seed),
        collect_curves=collect_curves)


def run_swa(adapter, train, test_loader, *, start_bundle, n_samples: int,
            cycle_steps: int, batch_size: int, peak_lr: float,
            seed: int = 0) -> Dict:
    """Sequential SWA from ``start_bundle``, on its device."""
    cfg = SWAConfig(
        n_samples=n_samples, cycle_steps=cycle_steps, batch_size=batch_size,
        schedule=ScheduleConfig(kind="cyclic", peak_lr=peak_lr,
                                min_lr=peak_lr * 0.1,
                                cycle_steps=cycle_steps),
        seed=seed)
    return SWA(adapter, cfg, train, test_loader).run(start_bundle)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def mean_std(vals: List[float]) -> str:
    if len(vals) == 1:
        return f"{vals[0]:.4f}"
    return f"{statistics.mean(vals):.4f} ± {statistics.stdev(vals):.4f}"
