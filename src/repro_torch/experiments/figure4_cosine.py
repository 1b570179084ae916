"""Figure 4 analog: the cosine between the descent direction (-g) and the
direction to the final SWAP point, along one small-batch trajectory. The
paper: the cosine decays late in training (the iterate moves mostly
across the direction to the basin's center). Twin of
``benchmarks/figure4_cosine.py``.

  PYTHONPATH=src python -m repro_torch.experiments.figure4_cosine \
      [--device {cuda,cpu}]

Writes ``results/figure4_torch.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch.configs.base import ScheduleConfig
from repro_torch.core.averaging import average_list
from repro_torch.core.schedules import schedule_fn
from repro_torch.data.pipeline import Loader
from repro_torch.experiments.common import cnn_task
from repro_torch.optim.api import tree_leaves, tree_map
from repro_torch.train.precision import default_scale_state

STEPS = 240        # long enough that training converges: the decay is a
                   # late-training phenomenon (paper Fig. 4)
NOISE = 3.5


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def run(verbose=True, cfg=None, device="cuda"):
    """``cfg``: the CNN config (the cifar-cnn smoke config by default)."""
    adapter, train, test_loader = cnn_task(seed=0, noise=NOISE, cfg=cfg,
                                           device=device)
    dev = test_loader.device
    loader = Loader(train, 64, seed=3, device=dev)
    sched = schedule_fn(ScheduleConfig(kind="warmup_linear", peak_lr=0.2,
                                       warmup_steps=24, total_steps=STEPS,
                                       end_lr=0.02))
    step_fn = adapter.make_train_step(sched)

    bundle = adapter.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = adapter.init_opt(bundle)
    scale = default_scale_state()

    # the trajectory and the gradient at each of its points (the step
    # updates the params in place, so each point is a copy)
    params_hist, grads_hist = [], []
    for step in range(STEPS):
        batch = loader.batch(step)
        params_hist.append(tree_map(lambda t: t.detach().clone(),
                                    bundle["params"]))
        p = tree_map(lambda t: t.detach().requires_grad_(),
                     params_hist[-1])
        loss = adapter._loss(p, bundle["state"], batch)[0]
        grads_hist.append(torch.cat([
            g.reshape(-1) for g in torch.autograd.grad(loss, tree_leaves(p))]))
        bundle, opt_state, scale, _ = step_fn(bundle, opt_state, batch,
                                              step, scale)

    # the SWAP point: the average of the tail iterates (a stand-in for the
    # worker average)
    theta_swap = _flat(average_list(params_hist[STEPS // 2:]))

    sims = []
    for t in range(STEPS):
        g = grads_hist[t]
        d = theta_swap - _flat(params_hist[t])
        sims.append(float(torch.dot(-g, d)
                          / (torch.linalg.norm(g) * torch.linalg.norm(d)
                             + 1e-12)))
    # mid-training (past the warmup, nearing the basin) against late
    early = sum(sims[STEPS // 4:STEPS // 2]) / (STEPS // 4)
    late = sum(sims[-STEPS // 4:]) / (STEPS // 4)
    if verbose:
        print("\n== Figure 4 analog (cosine similarity decay) ==")
        for t in range(0, STEPS, max(1, STEPS // 12)):
            print(f"step {t:3d}: cos = {sims[t]: .4f}")
        print(f"early-mean {early:.4f} -> late-mean {late:.4f} "
              f"(paper: decays toward ~0)")
    return {"sims": sims, "early_mean": early, "late_mean": late}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    path = Path("results/figure4_torch.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
