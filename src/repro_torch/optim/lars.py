"""LARS (You et al. 2017): layer-wise adaptive rate scaling, for large
phase-1 batches. 1-D parameters (norm scales, biases) skip the scaling.
Twin of ``repro/optim/lars.py``; updates in place."""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig


def init(params):
    from repro_torch.optim.api import tree_map
    return {"mu": tree_map(torch.zeros_like, params)}


def update(grads, state, params, lr, cfg: OptimizerConfig):
    from repro_torch.optim.api import tree_leaves
    m, wd, tc = cfg.momentum, cfg.weight_decay, cfg.trust_coefficient
    for g, buf, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                         tree_leaves(params)):
        d = g + wd * p
        if p.dim() > 1:
            p_norm = torch.linalg.vector_norm(p)
            d_norm = torch.linalg.vector_norm(d)
            trust = torch.where((p_norm > 0) & (d_norm > 0),
                                tc * p_norm / (d_norm + 1e-12), 1.0)
            d = d * trust
        buf.mul_(m).add_(d)
        step = d + m * buf if cfg.nesterov else buf
        p.sub_(lr * step)
    return params, state
