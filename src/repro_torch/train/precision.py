"""Mixed precision and gradient accumulation: twin of
``repro/train/precision.py``.

  * ``PrecisionPolicy`` -- the numerics of one training phase: master
    dtype, compute dtype, the dtype gradients are cast to after unscaling,
    and (for float16) dynamic loss scaling with inf/nan step skipping.
    Master weights stay in ``param_dtype``, so the optimizer update and
    everything SWAP averages are full precision.
  * ``LossScaleState`` -- (scale, growth_count, skipped) as small CPU
    tensors: 0-d for one model, (W,) for a phase-2 ensemble.
  * ``make_precision_train_step`` -- the engine's step
    ``(bundle, opt_state, batch, step, scale) -> (bundle, opt_state,
    scale, metrics)``: compute-dtype casting, loss scaling, ``k``
    sequential microbatches with summed gradients, with a process group
    the mean over its ranks (data parallelism), the skip on a non-finite
    step, and the master-weight optimizer update.

Gradients come from one ``torch.autograd.grad`` over params that are
detached views of the master tensors (so the update can write into them in
place). A skipped step leaves params, optimizer state and model state as
they were: the finiteness test reads only the gradients, so it is made
before the update instead of selecting after it.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim.api import tree_leaves, tree_map


class LossScaleState(NamedTuple):
    scale: Any         # float32 -- current loss scale
    growth_count: Any  # int32 -- finite steps since the last scale change
    skipped: Any       # int32 -- cumulative inf/nan-skipped steps


@dataclass(frozen=True)
class PrecisionPolicy:
    """Numerics of one training phase. Frozen and hashable."""

    name: str = "float32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    grad_dtype: str = "float32"
    loss_scale: float = 1.0
    dynamic: bool = False
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200

    @property
    def scaled(self) -> bool:
        return self.dynamic or self.loss_scale != 1.0

    @property
    def casts_compute(self) -> bool:
        return self.compute_dtype != self.param_dtype

    def cast_for_compute(self, tree):
        """Cast floating leaves to the compute dtype (no-op for f32/f32)."""
        if not self.casts_compute:
            return tree
        dt = getattr(torch, self.compute_dtype)
        return tree_map(lambda a: a.to(dt) if a.is_floating_point() else a,
                        tree)

    def init_scale_state(self) -> LossScaleState:
        return LossScaleState(
            scale=torch.tensor(self.loss_scale, dtype=torch.float32),
            growth_count=torch.zeros((), dtype=torch.int32),
            skipped=torch.zeros((), dtype=torch.int32))

    def update_scale(self, st: LossScaleState, finite) -> LossScaleState:
        """Back off on overflow; grow after ``growth_interval`` consecutive
        finite steps."""
        finite = torch.as_tensor(finite)
        grown = st.growth_count + 1 >= self.growth_interval
        scale = torch.where(
            finite, torch.where(grown, st.scale * self.growth_factor,
                                st.scale),
            st.scale * self.backoff_factor)
        count = torch.where(finite & ~grown, st.growth_count + 1, 0)
        return LossScaleState(
            scale=scale.to(torch.float32),
            growth_count=count.to(torch.int32),
            skipped=(st.skipped + (1 - finite.to(torch.int32))).to(
                torch.int32))


F32 = PrecisionPolicy()
BF16 = PrecisionPolicy(name="bfloat16", compute_dtype="bfloat16")
F16 = PrecisionPolicy(name="float16", compute_dtype="float16",
                      loss_scale=2.0 ** 15, dynamic=True)

_PRESETS = {
    "": F32, "f32": F32, "float32": F32, "fp32": F32,
    "bf16": BF16, "bfloat16": BF16,
    "f16": F16, "float16": F16, "fp16": F16,
}


def default_scale_state() -> LossScaleState:
    return F32.init_scale_state()


def stack_scale_state(st: LossScaleState, n: int) -> LossScaleState:
    """Broadcast a scale state to a leading worker axis."""
    return LossScaleState(*(t.expand(n).clone() for t in st))


def resolve_policy(name: str, opt_cfg=None) -> PrecisionPolicy:
    """Preset name -> policy, folding in the deprecated
    ``OptimizerConfig.grad_dtype`` alias."""
    policy = _PRESETS.get((name or "").lower())
    if policy is None:
        raise ValueError(
            f"unknown precision preset {name!r}; "
            f"expected one of {sorted(k for k in _PRESETS if k)}")
    if (opt_cfg is not None and opt_cfg.grad_dtype != "float32"
            and policy.grad_dtype == "float32"):
        warnings.warn(
            "OptimizerConfig.grad_dtype is deprecated: set "
            "PhaseConfig.precision / PrecisionPolicy.grad_dtype instead "
            "(the value still applies, now inside the precision step)",
            DeprecationWarning, stacklevel=2)
        policy = dataclasses.replace(policy, grad_dtype=opt_cfg.grad_dtype)
    return policy


def split_microbatches(batch, k: int):
    """Every batch leaf ``(B, ...) -> (k, B/k, ...)``; 0-d leaves (the
    per-batch ``aug_seed``) broadcast across the microbatches."""
    def split(v):
        if v.dim() == 0:
            return v.expand(k)
        if v.shape[0] % k:
            raise ValueError(f"batch dim {v.shape[0]} not divisible by "
                             f"grad_accum_steps={k}")
        return v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
    return tree_map(split, batch)


def all_finite(tree) -> bool:
    """Whether every floating leaf of ``tree`` is finite."""
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree)
               if t.is_floating_point())


def _unflatten(tree, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _group_mean(group, tensors) -> None:
    """Each floating tensor of ``tensors`` set to its mean over the
    group, in place: every rank ends with the same bits."""
    for t in tensors:
        if t.is_floating_point():
            group.mean_(t)


def make_precision_train_step(loss_with_aux: Callable, opt_update: Callable,
                              schedule_fn: Callable,
                              policy: Optional[PrecisionPolicy] = None,
                              grad_accum_steps: int = 1,
                              cast_inputs: bool = True,
                              group=None) -> Callable:
    """The engine-facing train step with the full precision pipeline.

    ``loss_with_aux(params, model_state, batch) -> (loss, (metrics,
    new_model_state))``. ``cast_inputs=False`` skips the pre-cast of params
    and batch for models that cast per matmul from their own config (the
    LM's ``mdot``). With ``policy.dynamic``, a step whose unscaled grads are
    not all finite is skipped: nothing is updated, the scale backs off, and
    ``metrics["skipped"]`` is 1.

    ``group``: a ``repro_torch.dist.sharding.RecordedGroup`` whose ranks
    each hold a shard of the batch. After the backward and before the
    update the gradients, the metrics and the new model state (BN running
    statistics) are set to their means over the group, so every decision
    that must match across ranks is taken from reduced values: the skip
    (a non-finite gradient on one rank is non-finite in the mean) and the
    accuracy EMA. BN normalizes with each rank's own batch statistics
    (no synchronized BN)."""
    policy = policy or F32
    k = int(grad_accum_steps)
    if k < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {k}")
    grad_dtype = getattr(torch, policy.grad_dtype)

    def value_and_grad(params, scale, mstate, mb):
        req = tree_map(lambda t: t.detach().requires_grad_(), params)
        p = req
        if cast_inputs:
            p, mb = policy.cast_for_compute(req), policy.cast_for_compute(mb)
        loss, (metrics, new_st) = loss_with_aux(p, mstate, mb)
        new_st = tree_map(lambda n, o: n.detach().to(o.dtype), new_st,
                          mstate)
        if policy.scaled:
            loss = loss * float(scale)
        leaves = tree_leaves(req)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        metrics = {n: m.detach() for n, m in metrics.items()}
        return _unflatten(req, grads), metrics, new_st

    def train_step(bundle, opt_state, batch, step, scale_state):
        params, mstate = bundle["params"], bundle["state"]
        scale = scale_state.scale
        if k == 1:
            grads, metrics, new_mstate = value_and_grad(params, scale,
                                                        mstate, batch)
        else:
            micro = split_microbatches(batch, k)
            grads = metrics = None
            new_mstate = mstate
            for i in range(k):
                g_i, m_i, new_mstate = value_and_grad(
                    params, scale, new_mstate,
                    tree_map(lambda v: v[i], micro))
                grads = g_i if grads is None else tree_map(torch.add,
                                                           grads, g_i)
                metrics = m_i if metrics is None else {
                    n: metrics[n] + m_i[n] for n in metrics}
            metrics = {n: m / k for n, m in metrics.items()}

        # unscale (and average over microbatches) in one multiply, then
        # cast to the gradient dtype
        if policy.scaled or k > 1:
            inv = torch.tensor(1.0 / k, dtype=torch.float32)
            inv = float(inv / scale if policy.scaled else inv)   # f32 value
            grads = tree_map(lambda g: g * inv, grads)
        if grad_dtype != torch.float32:
            grads = tree_map(lambda g: g.to(grad_dtype), grads)
        if group is not None:
            _group_mean(group, tree_leaves(grads) + tree_leaves(new_mstate))
            names = sorted(metrics)
            reduced = group.mean_(torch.stack(
                [metrics[n].to(torch.float32) for n in names]))
            metrics = {n: r.to(metrics[n].dtype)
                       for n, r in zip(names, reduced)}

        lr = schedule_fn(step)
        finite = all_finite(grads) if policy.dynamic else True
        if finite:
            opt_update(grads, opt_state, params, lr)
            mstate = tree_map(lambda o, n: o.copy_(n), mstate, new_mstate)
        # host-side metrics stay on the CPU: a small copy to the card
        # would stall the host every step
        if policy.dynamic:
            new_scale = policy.update_scale(scale_state, finite)
            metrics = dict(metrics,
                           skipped=torch.tensor(0.0 if finite else 1.0),
                           loss_scale=scale.clone())
        else:
            new_scale = scale_state
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        return ({"params": params, "state": mstate}, opt_state, new_scale,
                metrics)

    return train_step
