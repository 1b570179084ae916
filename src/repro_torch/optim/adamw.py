"""AdamW for the LM architectures. Twin of ``repro/optim/adamw.py``;
updates in place."""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig


def init(params):
    from repro_torch.optim.api import tree_map
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32)}


def update(grads, state, params, lr, cfg: OptimizerConfig):
    from repro_torch.optim.api import tree_leaves
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    count = state["count"] + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32),
                         count.float())
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32),
                         count.float())
    for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                            tree_leaves(state["nu"]), tree_leaves(params)):
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        c1d, c2d = c1.to(p.device), c2.to(p.device)
        step = (mu / c1d) / (torch.sqrt(nu / c2d) + eps) + wd * p
        p.sub_(lr * step)
    state["count"] = count
    return params, state
