"""Step factories for training and eval: twin of ``repro/train/steps.py``.

Prefill and decode live with serving (``launch/serve.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models.model import Model
from repro_torch.optim.api import init_optimizer
from repro_torch.train.precision import (
    PrecisionPolicy, make_precision_train_step, resolve_policy,
)


def lm_loss_and_metrics(model: Model, params, batch: Dict):
    """Cross-entropy next-token loss; metrics incl. accuracy (the paper's
    phase-1 stopping criterion is TRAIN accuracy).

    The reference's masked reduction: logits in f32, shifted by their
    (non-differentiated) row max, logz = log(sum(exp(shifted))), and the
    label's shifted logit, taken here with ``gather`` (the reference's
    masked sum adds zeros to that one value, so the two are equal). The
    row max and the argmax are read off the logits in their own dtype: the
    cast to f32 is exact and keeps order, so they are the reference's, and
    no f32 copy of the logits outlives the shift (at full width one f32
    copy of a 256 x 64 x 92544 batch is 6 GB). Without a graph (eval) the
    shift and the exp run in place on one f32 copy: the same values, with
    two f32 copies fewer alive at once (gemma3-1b's eval batch of 256 x 64
    x 262144 logits is 17.2 GB a copy). The vlm family's stub patch
    embeddings are ``batch["vision_embeds"]``, the audio family's encoder
    input ``batch["frames"]``."""
    logits, aux = model.apply(params, batch["tokens"],
                              vision_embeds=batch.get("vision_embeds"),
                              frames=batch.get("frames"))
    labels = batch["labels"].long()
    acc = (torch.argmax(logits, dim=-1) == labels).float().mean()
    m = logits.detach().amax(dim=-1, keepdim=True).float()
    graph = logits.requires_grad
    shifted = logits.float() - m if graph else logits.float().sub_(m)
    del logits
    l_y = shifted.gather(-1, labels[..., None])[..., 0]
    logz = torch.log((torch.exp(shifted) if graph else shifted.exp_())
                     .sum(dim=-1))
    del shifted
    loss = (logz - l_y).mean()
    return loss + aux, {"loss": loss, "aux": aux, "accuracy": acc}


def make_lm_train_step(model: Model, opt_cfg: OptimizerConfig,
                       schedule_fn: Callable,
                       policy: Optional[PrecisionPolicy] = None,
                       grad_accum_steps: int = 1):
    """Returns (opt_init, train_step). train_step: (params, opt_state,
    batch, step) -> (params, opt_state, metrics); the update is in place.
    Dynamic loss scaling is stateful and engine-only (``EpochRunner``)."""
    opt_init, opt_update = init_optimizer(opt_cfg)
    policy = policy if policy is not None \
        else resolve_policy("float32", opt_cfg)
    if policy.dynamic:
        raise ValueError(
            "dynamic loss scaling needs the stateful engine step — use "
            "adapter.make_train_step / EpochRunner (TrainState.scale)")

    def loss_with_aux(params, state, batch):
        total, metrics = lm_loss_and_metrics(model, params, batch)
        return total, (metrics, state)

    step5 = make_precision_train_step(
        loss_with_aux, opt_update, schedule_fn, policy=policy,
        grad_accum_steps=grad_accum_steps, cast_inputs=False)
    const_scale = policy.init_scale_state()

    def train_step(params, opt_state, batch, step):
        bundle, new_opt, _, metrics = step5(
            {"params": params, "state": {}}, opt_state, batch, step,
            const_scale)
        return bundle["params"], new_opt, metrics

    return opt_init, train_step


def make_lm_eval_fn(model: Model):
    @torch.no_grad()
    def eval_fn(params, batch):
        _, metrics = lm_loss_and_metrics(model, params, batch)
        return metrics
    return eval_fn
