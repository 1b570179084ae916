"""Model adapters: a uniform (init / train_step / eval / finalize) surface
over the models SWAP trains. Twin of ``repro/core/adapters.py``.

A *bundle* is {"params": trainable tree, "state": non-trainable tree}
(empty for the norm-stat-free LMs). ``LMAdapter`` covers the ported dense
family; the CNN+BN adapter comes with the CNN path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.data.pipeline import Loader
from repro_torch.models.model import Model
from repro_torch.optim.api import init_optimizer
from repro_torch.train.precision import (
    PrecisionPolicy, make_precision_train_step,
)
from repro_torch.train.steps import lm_loss_and_metrics


class LMAdapter:
    kind = "lm"

    def __init__(self, cfg: ModelConfig, opt_cfg: OptimizerConfig):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.model = Model(cfg)
        self.opt_init, self._opt_update = init_optimizer(opt_cfg)

    def init(self, gen: torch.Generator) -> Dict:
        """Random params on ``gen.device``."""
        return {"params": self.model.init(gen), "state": {}}

    def init_opt(self, bundle):
        return self.opt_init(bundle["params"])

    def make_train_step(self, schedule_fn: Callable,
                        policy: Optional[PrecisionPolicy] = None,
                        grad_accum_steps: int = 1):
        """Engine-facing train step. The LM casts per matmul from
        ``ModelConfig.dtype``, so a reduced-precision policy threads its
        compute dtype through the model config; master params stay f32."""
        model = self.model
        if (policy is not None and policy.casts_compute
                and self.cfg.dtype != policy.compute_dtype):
            model = Model(dataclasses.replace(
                self.cfg, dtype=policy.compute_dtype))

        def loss_with_aux(params, state, batch):
            total, metrics = lm_loss_and_metrics(model, params, batch)
            return total, (metrics, state)

        return make_precision_train_step(
            loss_with_aux, self._opt_update, schedule_fn, policy=policy,
            grad_accum_steps=grad_accum_steps, cast_inputs=False)

    @torch.no_grad()
    def _eval_batch(self, bundle, batch):
        _, metrics = lm_loss_and_metrics(self.model, bundle["params"], batch)
        return metrics

    def eval_accuracy(self, bundle, loader: Loader, max_batches: int = 8):
        accs = [self._eval_batch(bundle, loader.batch(i))["accuracy"]
                for i in range(min(max_batches, loader.steps_per_epoch))]
        return sum(float(a) for a in accs) / len(accs)

    def finalize(self, params, loader: Loader, n_batches: int = 8) -> Dict:
        """No norm statistics to recompute for RMSNorm/LayerNorm LMs."""
        return {"params": params, "state": {}}
