"""Table 3 analog (ImageNet): the paper speeds up a transformer-scale
pipeline with two phase-2 workers and no tuning beyond doubling the LR
with the batch size. The same on the LM task with a transformer (the
internlm2 smoke config: f32, head dim 64, on the f32 flash kernels on the
card): large batch = 2x the small, LR doubled, phase 2 = 2 workers on the
original schedule. Twin of ``benchmarks/table3_imagenet.py``.

  PYTHONPATH=src python -m repro_torch.experiments.table3_imagenet \
      [--device {cuda,cpu}]

Writes ``results/table3_torch.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.experiments.common import (lm_task, mean_std, run_sgd,
                                            run_swap)

SMALL = dict(batch_size=64, steps=240, peak_lr=0.5)
LARGE = dict(batch_size=128, steps=120, peak_lr=1.0)
SWAP_HP = dict(workers=2, b1=128, b2=64, steps1=120, steps2=60,
               lr1=1.0, lr2=0.25, stop_acc=0.68)


def run(seeds=(0, 1, 2), verbose=True, device="cuda"):
    rows = {"SGD (small-batch)": [], "SGD (large-batch)": [],
            "SWAP (before averaging)": [], "SWAP (after averaging)": []}
    times = {k: [] for k in rows}
    for seed in seeds:
        task = lm_task(seed=seed, device=device)
        small = run_sgd(*task, seed=seed, device=device, **SMALL)
        large = run_sgd(*task, seed=seed, device=device, **LARGE)
        swap = run_swap(*task, seed=seed, device=device, **SWAP_HP)
        rows["SGD (small-batch)"].append(small["test_acc"])
        rows["SGD (large-batch)"].append(large["test_acc"])
        rows["SWAP (before averaging)"].append(swap["before_avg_test_acc"])
        rows["SWAP (after averaging)"].append(swap["after_avg_test_acc"])
        times["SGD (small-batch)"].append(small["time"])
        times["SGD (large-batch)"].append(large["time"])
        swap_t = swap["phase1_time"] + swap["phase2_time"]
        times["SWAP (before averaging)"].append(swap_t)
        times["SWAP (after averaging)"].append(swap_t + swap["phase3_time"])
    out = {}
    if verbose:
        print("\n== Table 3 analog (ImageNet protocol / LM task, 2 workers) ==")
        print(f"{'row':28s} {'test acc':>20s} {'time (s)':>20s}")
    for k in rows:
        out[k] = {"acc": rows[k], "time": times[k]}
        if verbose:
            print(f"{k:28s} {mean_std(rows[k]):>20s} {mean_std(times[k]):>20s}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    path = Path("results/table3_torch.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
