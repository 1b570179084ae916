"""Optimizer factory: (init_fn, update_fn) pairs keyed by OptimizerConfig.

Twin of ``repro/optim/api.py``. Parameters and the optimizer state that
mirrors them live in their master dtype (float32); ``update_fn`` promotes
every gradient to its parameter's dtype once, so the update math runs in
full precision whatever dtype the gradients arrived in.

Trees are nested dicts of tensors. The update writes the new values into
the params and state it is given, under ``torch.no_grad`` (at full width a
functional update would hold a second copy of every parameter), and
returns them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim import adamw, lars, sgd

_MODS = {"sgd": sgd, "lars": lars, "adamw": adamw}


def tree_leaves(tree):
    """Leaves of a nested dict in sorted-key order (JAX's flattening)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_optimizer(cfg: OptimizerConfig):
    """Returns (init_fn(params) -> state, update_fn(grads, state, params,
    lr) -> (params, state)), the update in place."""
    mod = _MODS.get(cfg.kind)
    if mod is None:
        raise ValueError(f"unknown optimizer {cfg.kind!r}")

    @torch.no_grad()
    def update_fn(grads, state, params, lr):
        grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
        return mod.update(grads, state, params, lr, cfg)

    return mod.init, update_fn
