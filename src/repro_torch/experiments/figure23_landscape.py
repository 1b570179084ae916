"""Figures 2/3 analog: train and test error on the plane through the
phase-1 output ("LB"), one phase-2 worker ("SGD") and the averaged model
("SWAP"). The paper's observation: LB and the workers sit on the edges of
an almost convex train-loss basin, SWAP nearer its center, and SWAP wins
on test error. The error grid comes back with its plane coordinates, and
the errors at the three points themselves. Twin of
``benchmarks/figure23_landscape.py``; ``landscape_viz`` draws the map.

  PYTHONPATH=src python -m repro_torch.experiments.figure23_landscape \
      [--device {cuda,cpu}]

Writes ``results/figure23_torch.json``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.averaging import average_stacked
from repro_torch.data.pipeline import Loader
from repro_torch.experiments.common import cnn_task, run_swap
from repro_torch.optim.api import tree_leaves, tree_map

SWAP_HP = dict(workers=4, b1=512, b2=64, steps1=120, steps2=64,
               lr1=1.2, lr2=0.15, stop_acc=0.93)
GRID = 9
NOISE = 3.5


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def _unflat(vec: torch.Tensor, template):
    """``vec`` cut into the leaves of ``template`` (in its flattening
    order), as a tree of the same structure."""
    pieces, off = {}, 0
    for i, t in enumerate(tree_leaves(template)):
        pieces[i] = vec[off:off + t.numel()].reshape(t.shape)
        off += t.numel()
    it = iter(range(len(pieces)))

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return pieces[next(it)]
    return rebuild(template)


def run(verbose=True, cfg=None, device="cuda"):
    """``cfg``: the CNN config (the cifar-cnn smoke config by default)."""
    task = cnn_task(seed=0, noise=NOISE, cfg=cfg, device=device)
    adapter, train, test_loader = task
    dev = test_loader.device
    train_loader = Loader(train, 256, device=dev)
    swap = run_swap(*task, seed=0, device=device, **SWAP_HP)

    theta_lb = _flat(swap["phase1_bundle"]["params"])
    theta_sgd = _flat(tree_map(lambda a: a[0], swap["stacked_params"]))
    theta_swap = _flat(average_stacked(swap["stacked_params"]))

    # orthonormal plane basis through the three points (Garipov-style)
    u = theta_sgd - theta_lb
    v = theta_swap - theta_lb
    v = v - u * (torch.dot(u, v) / torch.dot(u, u))
    uhat, vhat = u / torch.linalg.norm(u), v / torch.linalg.norm(v)

    def coords(theta):
        d = theta - theta_lb
        return float(torch.dot(d, uhat)), float(torch.dot(d, vhat))

    pts = {"LB": coords(theta_lb), "SGD": coords(theta_sgd),
           "SWAP": coords(theta_swap)}

    # the error over the bounding grid (with a margin), BN statistics
    # recomputed at each plane point as the paper does
    all_a = [p[0] for p in pts.values()]
    all_b = [p[1] for p in pts.values()]
    amin, amax = min(all_a), max(all_a)
    bmin, bmax = min(all_b), max(all_b)
    ma, mb = 0.4 * (amax - amin + 1e-9), 0.4 * (bmax - bmin + 1e-9)
    alphas = np.linspace(amin - ma, amax + ma, GRID)
    betas = np.linspace(bmin - mb, bmax + mb, GRID)

    template = swap["phase1_bundle"]["params"]
    grid = []
    for a in alphas:
        for b in betas:
            theta = theta_lb + float(a) * uhat + float(b) * vhat
            bundle = adapter.finalize(_unflat(theta, template), train_loader,
                                      n_batches=2)
            tr = adapter.eval_accuracy(bundle, Loader(train, 256, device=dev),
                                       max_batches=2)
            te = adapter.eval_accuracy(bundle, test_loader, max_batches=2)
            grid.append({"alpha": float(a), "beta": float(b),
                         "train_err": 1 - tr, "test_err": 1 - te})

    # the errors at the three points themselves (grid cells are too coarse
    # to separate them), BN statistics recomputed at each
    exact = {}
    for name, theta in (("LB", theta_lb), ("SGD", theta_sgd),
                        ("SWAP", theta_swap)):
        bundle = adapter.finalize(_unflat(theta, template), train_loader,
                                  n_batches=4)
        exact[name] = {
            "train_err": 1 - adapter.eval_accuracy(
                bundle, Loader(train, 256, device=dev), max_batches=4),
            "test_err": 1 - adapter.eval_accuracy(bundle, test_loader,
                                                  max_batches=4)}

    result = {"points": pts, "grid": grid,
              "train_err": {k: exact[k]["train_err"] for k in exact},
              "test_err": {k: exact[k]["test_err"] for k in exact}}
    if verbose:
        print("\n== Figure 2/3 analog (loss-landscape plane) ==")
        print("points (plane coords):", {k: tuple(round(x, 2) for x in v)
                                         for k, v in pts.items()})
        print("nearest-grid train err:", {k: round(v, 3) for k, v
                                          in result["train_err"].items()})
        print("nearest-grid test err: ", {k: round(v, 3) for k, v
                                          in result["test_err"].items()})
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = run(device=args.device)
    path = Path("results/figure23_torch.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
