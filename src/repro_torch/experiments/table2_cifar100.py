"""Table 2 analog (CIFAR100): the protocol of Table 1 on a harder task
(more classes, more noise), where the paper saw SWAP exceed the
small-batch accuracy (78.18 vs 77.01): harder tasks gain more from
averaging. Twin of ``benchmarks/table2_cifar100.py``.

  PYTHONPATH=src python -m repro_torch.experiments.table2_cifar100 \
      [--device {cuda,cpu}]

The model gets the task's 20 classes (``common.cnn_task``); the reference
keeps its config's 10, so its loss is NaN from the first step. Writes
``results/table2_torch.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.experiments.common import (cnn_task, mean_std, run_sgd,
                                            run_swap)

SMALL = dict(batch_size=64, steps=640, peak_lr=0.4)
LARGE = dict(batch_size=512, steps=120, peak_lr=1.2)
SWAP_HP = dict(workers=8, b1=512, b2=64, steps1=120, steps2=96,
               lr1=1.2, lr2=0.15, stop_acc=0.88)
N_CLASSES, NOISE = 20, 3.0


def run(seeds=(0, 1, 2), verbose=True, cfg=None, device="cuda"):
    """The table's rows over ``seeds``. ``cfg``: the CNN config (the
    cifar-cnn smoke config by default; see ``common.cnn_task``)."""
    rows = {"SGD (small-batch)": [], "SGD (large-batch)": [],
            "SWAP (before averaging)": [], "SWAP (after averaging)": []}
    times = {k: [] for k in rows}
    for seed in seeds:
        task = cnn_task(seed=seed, n_classes=N_CLASSES, noise=NOISE,
                        cfg=cfg, device=device)
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
        print("\n== Table 2 analog (CIFAR100 / harder synthetic task) ==")
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
    path = Path("results/table2_torch.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
