"""Table 1 analog (CIFAR10): small-batch vs large-batch vs SWAP on the
CNN+BN model over the synthetic image task. Twin of
``benchmarks/table1_cifar10.py``.

  PYTHONPATH=src python -m repro_torch.experiments.table1_cifar10 \
      [--device {cuda,cpu}]

Paper (CIFAR10): small 95.24 / 254s; large 94.77 / 133s; SWAP(before) 94.70
/ 168s; SWAP(after) 95.23 / 169s. We reproduce the ordering:
  acc: SWAP(after) ~ small > large ~ SWAP(before);
  time: SWAP ~ large << small.
Writes ``results/table1_torch.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.experiments.common import (cnn_task, mean_std, run_sgd,
                                            run_swap)

# Grid-searched like the paper (Appendix A): small-batch 20 epochs at
# lr 0.4; large-batch 30 epochs (paper uses 1.5x epochs for LB) at lr 1.2
# (~linear scaling of 8x batch, paper: 0.3 -> 1.2); SWAP phase 1 stops at
# 93% train accuracy, phase 2 runs 8 workers at the small batch size.
SMALL = dict(batch_size=64, steps=640, peak_lr=0.4)
LARGE = dict(batch_size=512, steps=120, peak_lr=1.2)
SWAP_HP = dict(workers=8, b1=512, b2=64, steps1=120, steps2=96,
               lr1=1.2, lr2=0.15, stop_acc=0.93)
NOISE = 3.5


def run(seeds=(0, 1, 2), verbose=True, cfg=None, device="cuda",
        results=None):
    """The table's rows over ``seeds``. ``cfg``: the CNN config (the
    cifar-cnn smoke config by default; see ``common.cnn_task``).
    ``results``: a list to which each seed's runs are appended, as
    {"seed", "task": (adapter, train, test_loader), "small", "large",
    "swap"}, bundles included."""
    rows = {"SGD (small-batch)": [], "SGD (large-batch)": [],
            "SWAP (before averaging)": [], "SWAP (after averaging)": []}
    times = {k: [] for k in rows}
    updates = {k: [] for k in rows}
    for seed in seeds:
        task = cnn_task(seed=seed, noise=NOISE, cfg=cfg, device=device)
        small = run_sgd(*task, seed=seed, device=device, **SMALL)
        large = run_sgd(*task, seed=seed, device=device, **LARGE)
        swap = run_swap(*task, seed=seed, device=device, **SWAP_HP)
        if results is not None:
            results.append({"seed": seed, "task": task, "small": small,
                            "large": large, "swap": swap})
        rows["SGD (small-batch)"].append(small["test_acc"])
        rows["SGD (large-batch)"].append(large["test_acc"])
        rows["SWAP (before averaging)"].append(swap["before_avg_test_acc"])
        rows["SWAP (after averaging)"].append(swap["after_avg_test_acc"])
        times["SGD (small-batch)"].append(small["time"])
        times["SGD (large-batch)"].append(large["time"])
        swap_t = swap["phase1_time"] + swap["phase2_time"]
        times["SWAP (before averaging)"].append(swap_t)
        times["SWAP (after averaging)"].append(swap_t + swap["phase3_time"])
        # sequential update counts -- the scaling-relevant time proxy (one
        # device runs the W workers one after another)
        updates["SGD (small-batch)"].append(small["steps"])
        updates["SGD (large-batch)"].append(large["steps"])
        swap_u = swap["phase1_steps"] + SWAP_HP["steps2"]
        updates["SWAP (before averaging)"].append(swap_u)
        updates["SWAP (after averaging)"].append(swap_u)
    out = {}
    if verbose:
        print("\n== Table 1 analog (CIFAR10 / CNN+BN on synthetic images) ==")
        print(f"{'row':28s} {'test acc':>20s} {'time (s)':>18s} "
              f"{'updates':>9s}")
    for k in rows:
        out[k] = {"acc": rows[k], "time": times[k], "updates": updates[k]}
        if verbose:
            u = int(sum(updates[k]) / len(updates[k]))
            print(f"{k:28s} {mean_std(rows[k]):>20s} "
                  f"{mean_std(times[k]):>18s} {u:>9d}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    path = Path("results/table1_torch.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
