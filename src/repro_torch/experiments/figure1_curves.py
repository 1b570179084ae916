"""Figure 1 analog: each worker's test accuracy against the averaged
model's during phase 2; the averaged model should sit above every worker
curve. Twin of ``benchmarks/figure1_curves.py``.

  PYTHONPATH=src python -m repro_torch.experiments.figure1_curves \
      [--device {cuda,cpu}]

Writes ``results/figure1_torch.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.experiments.common import cnn_task, run_swap

SWAP_HP = dict(workers=4, b1=512, b2=64, steps1=120, steps2=48,
               lr1=1.2, lr2=0.15, stop_acc=0.93)
NOISE = 3.5


def run(verbose=True, cfg=None, device="cuda"):
    """``cfg``: the CNN config (the cifar-cnn smoke config by default)."""
    task = cnn_task(seed=0, noise=NOISE, cfg=cfg, device=device)
    swap = run_swap(*task, seed=0, collect_curves=True, device=device,
                    **SWAP_HP)
    curves = swap["phase2_curves"]
    n_above = sum(c["avg_test_acc"] >= max(c["worker_test_accs"]) - 1e-9
                  for c in curves[len(curves) // 2:])
    if verbose:
        print("\n== Figure 1 analog (phase-2 curves) ==")
        print("step, worker_accs..., avg_acc")
        for c in curves:
            ws = " ".join(f"{a:.3f}" for a in c["worker_test_accs"])
            print(f"{c['step']:4d}  [{ws}]  avg={c['avg_test_acc']:.3f}")
        print(f"averaged model >= best worker in {n_above}/"
              f"{len(curves) - len(curves) // 2} late-phase steps")
    return {"curves": curves, "late_steps_avg_above_best": n_above}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    path = Path("results/figure1_torch.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
