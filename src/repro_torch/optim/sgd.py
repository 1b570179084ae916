"""SGD with (Nesterov) momentum and L2 weight decay folded into the
gradient: the paper's optimizer (momentum 0.9, wd 5e-4, PyTorch update
convention). Twin of ``repro/optim/sgd.py``; updates in place, one
elementwise pass per line (each ``a + s * b`` may round once, where the
reference rounds the product and the sum: they agree to an ulp)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig


def init(params):
    from repro_torch.optim.api import tree_map
    return {"mu": tree_map(torch.zeros_like, params)}


def update(grads, state, params, lr, cfg: OptimizerConfig):
    from repro_torch.optim.api import tree_leaves
    m, wd = cfg.momentum, cfg.weight_decay
    for g, buf, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                         tree_leaves(params)):
        d = torch.add(g, p, alpha=wd)             # d = g + wd * p
        torch.add(d, buf, alpha=m, out=buf)       # buf = m * buf + d
        step = d.add_(buf, alpha=m) if cfg.nesterov else buf
        p.add_(step, alpha=-lr)                   # p - lr * step
    return params, state
