"""Naive oracle for (GQA, causal, sliding-window) attention.

The simplest correct implementation: materializes the full score matrix.
Twin of ``repro/kernels/flash_attention/ref.py``; ground truth for tests.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None, q_offset: int = 0):
    """Naive attention.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) with H % KVH == 0.
    ``q_offset``: absolute position of q[0] (for decode: Skv - Sq).
    ``window`` > 0 -> sliding-window: key j visible to query i iff
    i - window < j <= i (causal).
    Returns (B, Sq, H, D) in q.dtype, accumulation in f32.
    """
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = scale if scale is not None else D ** -0.5

    qf = (q.float() * scale).reshape(B, Sq, KVH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())   # (B,KVH,G,Sq,Skv)

    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, -torch.inf)

    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                            window: int = 0, scale: float | None = None,
                            q_offset: int = 0):
    """The plain version of the backward kernels: the f32 math of the JAX
    ``_fa_bwd_dq_kernel`` / ``_fa_bwd_dkv_kernel`` over the whole score
    matrix. q*scale in f32; masked scores are NEG_INF = -1e30, so
    P = exp(S - lse) is 0 there (and everywhere in a row that sees no key,
    whose lse is 0). Returns (dq, dk, dv) in the input dtypes."""
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = scale if scale is not None else D ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, KVH, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, KVH, G, D)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    s = torch.where(mask, s, -1e30)
    lse_ = lse.reshape(B, Sq, KVH, G).permute(0, 2, 3, 1)[..., None]
    p = torch.exp(s - lse_)                                 # (B,KVH,G,Sq,Skv)
    delta = (do.float() * out.float()).sum(-1)              # (B,Sq,H)
    delta = delta.reshape(B, Sq, KVH, G).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
