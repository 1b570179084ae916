"""Deterministic synthetic data: twin of ``repro/data/pipeline.py``.

The same seed gives the same data and the same batches as the JAX package,
through ``repro_torch.data.prng`` (a twin of ``jax.random``):

  * ``make_markov_lm`` -- a finite next-token dataset sampled from a fixed
    random low-entropy Markov chain (train: a finite sample; test: fresh
    draws from the same chain);
  * ``make_gmm_images`` -- Gaussian-mixture images: ``n_classes`` cluster
    means in (H, W, 3) image space plus per-sample noise, for the
    paper-faithful CNN+BN (its augmentation is ``repro_torch.data.augment``);
  * ``Loader`` -- epoch-permuted batches, a pure function of (seed, worker,
    epoch), so each SWAP phase-2 worker walks the whole dataset in its own
    order. The epoch permutations are cached per (worker, epoch).

Arrays stay on the CPU as numpy; ``Loader.batch`` returns tensors on the
loader's device.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.data import prng


def make_markov_lm(seed: int, vocab: int = 64, n_train: int = 2048,
                   n_test: int = 512, seq_len: int = 64,
                   temperature: float = 0.35) -> Dict[str, np.ndarray]:
    """Finite LM dataset from a fixed random Markov chain. Lower temperature
    -> lower-entropy chain -> higher attainable accuracy."""
    key = prng.PRNGKey(seed)
    k_mat, k_train, k_test = prng.split(key, 3)
    logits = prng.normal(k_mat, (vocab, vocab)) / torch.tensor(
        temperature, dtype=torch.float32)

    def sample(key, n):
        k0, kseq = prng.split(key)
        tok = prng.randint(k0, (n,), 0, vocab).long()
        seq = [tok]
        for k in prng.split(kseq, seq_len):
            tok = prng.categorical(k, logits[tok], axis=-1)
            seq.append(tok)
        return torch.stack(seq, dim=1).to(torch.int32).numpy()  # (n, S+1)

    train = sample(k_train, n_train)
    test = sample(k_test, n_test)
    return {
        "train_tokens": train[:, :-1], "train_labels": train[:, 1:],
        "test_tokens": test[:, :-1], "test_labels": test[:, 1:],
        "transition_logits": logits.numpy(),
    }


def make_gmm_images(seed: int, n_classes: int = 10, image_size: int = 16,
                    n_train: int = 4096, n_test: int = 1024,
                    noise: float = 1.5) -> Dict[str, np.ndarray]:
    """Gaussian-mixture image classification. `noise` controls task
    difficulty (and therefore the size of the generalization gap)."""
    key = prng.PRNGKey(seed)
    k_means, k_train, k_test, k_ltr, k_lte = prng.split(key, 5)
    shape = (image_size, image_size, 3)
    means = prng.normal(k_means, (n_classes,) + shape)

    def sample(kimg, klab, n):
        labels = prng.randint(klab, (n,), 0, n_classes)
        imgs = means[labels.long()] + noise * prng.normal(kimg, (n,) + shape)
        return imgs.numpy(), labels.numpy()

    tr_x, tr_y = sample(k_train, k_ltr, n_train)
    te_x, te_y = sample(k_test, k_lte, n_test)
    return {"train_images": tr_x, "train_labels": tr_y,
            "test_images": te_x, "test_labels": te_y}


class Loader:
    """Epoch-permuted batches over a finite dataset.

    ``batch(step, worker)`` is a pure function of (seed, worker, epoch):
    each worker walks the full dataset in its own random order. Phase 1
    uses worker 0. ``shard=(index, count)`` gives host ``index`` its
    contiguous ``batch_size // count`` rows of every global batch (the
    union of the shards is the unsharded batch, in permutation order);
    ``steps_per_epoch`` and ``aug_seed`` stay global.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, shard: Optional[Tuple[int, int]] = None,
                 device="cpu"):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        sizes = {v.shape[0] for v in self.arrays.values()}
        if len(sizes) != 1:
            raise ValueError(
                f"all arrays must share the leading dim, got sizes {sizes}")
        self.n = sizes.pop()
        if batch_size > self.n:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size {self.n}")
        if shard is not None:
            index, count = shard
            if not (0 <= index < count):
                raise ValueError(f"shard index {index} out of range for "
                                 f"count {count}")
            if batch_size % count != 0:
                raise ValueError(
                    f"batch_size {batch_size} is not divisible by the "
                    f"shard count {count} — every host must hold an equal "
                    f"slice of each global batch")
        self.shard = shard
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device)
        self.steps_per_epoch = self.n // batch_size
        self.dropped_per_epoch = self.n % batch_size
        if self.dropped_per_epoch:
            warnings.warn(
                f"Loader drops {self.dropped_per_epoch} of {self.n} samples "
                f"every epoch ({batch_size=} does not divide the dataset); "
                f"each epoch covers only steps_per_epoch*batch_size = "
                f"{self.steps_per_epoch * batch_size} samples",
                stacklevel=2)
        self._dev_arrays: Dict[str, torch.Tensor] = {}
        self._perms: Dict[Tuple[int, int], torch.Tensor] = {}

    def _perm(self, worker: int, epoch: int) -> torch.Tensor:
        """The epoch permutation, computed once per (worker, epoch) and
        kept on the loader's device (one host-to-device copy an epoch)."""
        perm = self._perms.get((worker, epoch))
        if perm is None:
            key = prng.fold_in(prng.fold_in(prng.PRNGKey(self.seed), worker),
                               epoch)
            perm = prng.permutation(key, self.n).long().to(self.device)
            self._perms = {k: v for k, v in self._perms.items()
                           if k[0] != worker}      # keep one epoch per worker
            self._perms[worker, epoch] = perm
        return perm

    def aug_seed(self, step: int, worker: int = 0) -> int:
        """The per-(seed, worker, step) augmentation seed, as the JAX
        package's uint32 arithmetic gives it."""
        m = 2 ** 31 - 1
        base = (self.seed * 1000003) % m
        rest = (((worker * 9176) & prng.M32) + step) & prng.M32
        return (base + rest % m) % m

    def _on_device(self) -> Dict[str, torch.Tensor]:
        if not self._dev_arrays:
            self._dev_arrays = {k: torch.from_numpy(v.copy()).to(self.device)
                                for k, v in self.arrays.items()}
        return self._dev_arrays

    def batch(self, step: int, worker: int = 0) -> Dict[str, torch.Tensor]:
        step, worker = int(step), int(worker)
        epoch = step // self.steps_per_epoch
        offset = (step % self.steps_per_epoch) * self.batch_size
        local = self.batch_size
        if self.shard is not None:
            index, count = self.shard
            local = self.batch_size // count
            offset += index * local
        idx = self._perm(worker, epoch)[offset:offset + local]
        out = {k: v[idx] for k, v in self._on_device().items()}
        out["aug_seed"] = torch.tensor(self.aug_seed(step, worker),
                                       dtype=torch.int32)
        return out

    def epoch_of(self, step) -> int:
        return step // self.steps_per_epoch
