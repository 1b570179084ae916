"""Beyond the paper: SWAP's accuracy against the worker count W (the paper
fixes W = 8 for CIFAR and 2 for ImageNet), swept at a fixed phase-2
schedule to see where the averaging gain saturates. Twin of
``benchmarks/ablation_workers.py``.

  PYTHONPATH=src python -m repro_torch.experiments.ablation_workers \
      [--device {cuda,cpu}]

Writes ``results/ablation_workers_torch.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.experiments.common import cnn_task, mean_std, run_swap

BASE = dict(b1=512, b2=64, steps1=120, steps2=96, lr1=1.2, lr2=0.15,
            stop_acc=0.93)
WORKERS = (1, 2, 4, 8)
NOISE = 3.5


def run(seeds=(0, 1), verbose=True, cfg=None, device="cuda",
        results=None):
    """Rows {W: {"before", "after"}} over ``seeds``. ``cfg``: the CNN
    config (the cifar-cnn smoke config by default). ``results``: a list
    to which each run is appended as {"workers", "seed", "swap"}."""
    rows = {}
    for W in WORKERS:
        accs_b, accs_a = [], []
        for seed in seeds:
            task = cnn_task(seed=seed, noise=NOISE, cfg=cfg, device=device)
            s = run_swap(*task, workers=W, seed=seed, device=device, **BASE)
            if results is not None:
                results.append({"workers": W, "seed": seed, "swap": s})
            accs_b.append(s["before_avg_test_acc"])
            accs_a.append(s["after_avg_test_acc"])
        rows[W] = {"before": accs_b, "after": accs_a}
    if verbose:
        print("\n== Ablation: SWAP vs worker count ==")
        print(f"{'W':>3s} {'before avg':>18s} {'after avg':>18s} {'gain':>8s}")
        for W, v in rows.items():
            gain = (sum(v["after"]) - sum(v["before"])) / len(v["after"])
            print(f"{W:3d} {mean_std(v['before']):>18s} "
                  f"{mean_std(v['after']):>18s} {gain:+8.4f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    path = Path("results/ablation_workers_torch.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
