"""Learning-rate schedules: twin of ``repro/core/schedules.py``.

Each schedule is a function of the step index returning the rate as a
Python float, computed in float32 tensors op for op as the JAX package
computes it (so the rates are the same floats).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ScheduleConfig


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule_fn(cfg: ScheduleConfig):
    if cfg.kind == "const":
        return lambda step: float(_f32(cfg.peak_lr))

    if cfg.kind in ("warmup_linear", "warmup_cosine"):
        def fn(step):
            step = _f32(step)
            warm = cfg.peak_lr * step / _f32(max(cfg.warmup_steps, 1))
            t = (step - cfg.warmup_steps) / _f32(
                max(cfg.total_steps - cfg.warmup_steps, 1))
            t = torch.clamp(t, 0.0, 1.0)
            if cfg.kind == "warmup_linear":
                decay = cfg.peak_lr + (cfg.end_lr - cfg.peak_lr) * t
            else:
                decay = cfg.end_lr + 0.5 * (cfg.peak_lr - cfg.end_lr) * (
                    1.0 + torch.cos(_f32(math.pi) * t))
            return float(torch.where(step < cfg.warmup_steps, warm, decay))
        return fn

    if cfg.kind == "cyclic":
        # SWA triangular cycles: peak_lr at each cycle start, decaying
        # linearly to min_lr at the cycle end
        def fn(step):
            c = _f32(max(cfg.cycle_steps, 1))
            t = torch.remainder(_f32(step), c) / c
            return float(cfg.peak_lr + (cfg.min_lr - cfg.peak_lr) * t)
        return fn

    raise ValueError(f"unknown schedule kind {cfg.kind!r}")
