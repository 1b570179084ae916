"""Train-time image augmentation: twin of ``repro/data/augment.py``.

For the synthetic GMM task the paper's cutout + CIFAR augmentation becomes
fresh additive noise around the stored sample (same label, perturbed
input) plus cutout, drawn from the loader's ``aug_seed`` (a pure function
of (seed, worker, step)), so phase-2 workers see different augmentations
of the same finite dataset. The noise's bits are hashed on the images'
device (``repro_torch.data.prng``'s device path), as ``jax.random`` runs on
the accelerator: the same bits as on the host, without a host hash of the
whole batch each step. The cutout corners (B of them) are hashed on the
host (on the card each hash is ~160 launches of int64 ops) and copied over
with ``non_blocking``: the driver stages so small a copy from pageable
memory at once, where a blocking copy would first wait for every kernel
queued before it.
"""
from __future__ import annotations

import torch

from repro_torch.data import prng


def augment_images(images: torch.Tensor, seed, *, noise: float = 1.5,
                   cutout: int = 4) -> torch.Tensor:
    """images: (B, H, W, C) float; seed: an int or an int32 scalar tensor.
    Returns f32 images (the noise is f32, as ``jax.random`` draws it)."""
    key = prng.fold_in(prng.PRNGKey(0), int(seed))
    k_noise, k_cx, k_cy = prng.split(key, 3)
    B, H, W, C = images.shape
    dev = images.device
    out = images + noise * prng.normal(k_noise, tuple(images.shape),
                                       device=dev)
    if cutout > 0:
        cx = prng.randint(k_cx, (B,), 0, H - cutout + 1).to(
            dev, non_blocking=True)
        cy = prng.randint(k_cy, (B,), 0, W - cutout + 1).to(
            dev, non_blocking=True)
        ii = torch.arange(H, device=dev)[None, :, None]
        jj = torch.arange(W, device=dev)[None, None, :]
        cx, cy = cx[:, None, None], cy[:, None, None]
        mask = ((ii >= cx) & (ii < cx + cutout)
                & (jj >= cy) & (jj < cy + cutout))
        out = torch.where(mask[..., None], 0.0, out)
    return out
