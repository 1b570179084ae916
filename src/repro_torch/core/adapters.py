"""Model adapters: a uniform (init / train_step / eval / finalize) surface
over the two model kinds SWAP trains. Twin of ``repro/core/adapters.py``.

  * LMAdapter  -- the ported LM families (``Model``);
  * CNNAdapter -- the paper-faithful CNN+BatchNorm (phase-3 stat recompute).

A *bundle* is {"params": trainable tree, "state": non-trainable tree}
(BN running stats for the CNN; empty for the norm-stat-free LMs).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core.averaging import recompute_bn_stats
from repro_torch.data.augment import augment_images
from repro_torch.data.pipeline import Loader
from repro_torch.models import cnn as cnn_mod
from repro_torch.models.model import Model
from repro_torch.optim.api import init_optimizer, tree_leaves
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
                        grad_accum_steps: int = 1, group=None):
        """Engine-facing train step. The LM casts per matmul from
        ``ModelConfig.dtype``, so a reduced-precision policy threads its
        compute dtype through the model config; master params stay f32.
        ``group``: the data-parallel process group
        (``make_precision_train_step``)."""
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
            grad_accum_steps=grad_accum_steps, cast_inputs=False,
            group=group)

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


class CNNAdapter:
    kind = "cnn"

    def __init__(self, cfg: ModelConfig, opt_cfg: OptimizerConfig):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.opt_init, self._opt_update = init_optimizer(opt_cfg)

    def init(self, gen: torch.Generator) -> Dict:
        """Random params and BN state on ``gen.device``."""
        params, state = cnn_mod.init_cnn(gen, self.cfg)
        return {"params": params, "state": state}

    def init_opt(self, bundle):
        return self.opt_init(bundle["params"])

    def _loss(self, params, state, batch):
        images = batch["images"]
        if "aug_seed" in batch:
            images = augment_images(images, batch["aug_seed"])
        # the augmentation's math runs f32; re-align the images with the
        # (possibly reduced-precision) params so the conv sees one compute
        # dtype -- a no-op for the f32 policy
        images = images.to(tree_leaves(params)[0].dtype)
        logits, new_state = cnn_mod.apply_cnn(params, state, images,
                                              self.cfg, train=True)
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, ({"loss": loss, "accuracy": acc,
                       "aux": torch.zeros((), device=loss.device)},
                      new_state)

    def make_train_step(self, schedule_fn: Callable,
                        policy: Optional[PrecisionPolicy] = None,
                        grad_accum_steps: int = 1, group=None):
        """Engine-facing train step. The CNN has no per-op compute-dtype
        plumbing, so reduced-precision policies pre-cast params and batch
        (``cast_inputs=True``); the precision step casts the BN running
        stats back to their master dtype. ``group``: as for the LM."""
        return make_precision_train_step(
            self._loss, self._opt_update, schedule_fn, policy=policy,
            grad_accum_steps=grad_accum_steps, cast_inputs=True,
            group=group)

    @torch.no_grad()
    def _eval_batch(self, bundle, batch):
        logits, _ = cnn_mod.apply_cnn(bundle["params"], bundle["state"],
                                      batch["images"], self.cfg, train=False)
        return (logits.argmax(-1) == batch["labels"].long()).float().mean()

    def eval_accuracy(self, bundle, loader: Loader, max_batches: int = 8):
        accs = [self._eval_batch(bundle, loader.batch(i))
                for i in range(min(max_batches, loader.steps_per_epoch))]
        return sum(float(a) for a in accs) / len(accs)

    def finalize(self, params, loader: Loader, n_batches: int = 8) -> Dict:
        """Paper Algorithm 1 line 28: recompute BN statistics for the
        averaged weights with a pass over the training data."""
        batches = (loader.batch(i) for i in
                   range(min(n_batches, loader.steps_per_epoch)))
        state = recompute_bn_stats(
            lambda p, batch: cnn_mod.cnn_batch_stats(p, batch["images"],
                                                     self.cfg),
            params, batches)
        return {"params": params, "state": state}
