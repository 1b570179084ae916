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


def _bwd_probs(q, k, lse, *, causal, window, scale, q_offset,
               scores_as_forward):
    """P = exp(S - lse) as (B,KVH,G,Sq,Skv). Masked scores are NEG_INF =
    -1e30, so P is 0 there (and everywhere in a row that sees no key, whose
    lse is 0). ``scores_as_forward``: S from q * scale taken in q.dtype, as
    the port's forward (``ops._blockwise_fwd`` and the bf16 kernel) takes
    it when it writes lse, else in f32 (as the JAX kernels take it)."""
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    if scores_as_forward:
        qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    else:
        qs = q.float() * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs.reshape(B, Sq, KVH, G, D),
                     k.float())
    s = torch.where(mask, s, -1e30)
    lse_ = lse.reshape(B, Sq, KVH, G).permute(0, 2, 3, 1)[..., None]
    return torch.exp(s - lse_)


def split_bf16(x):
    """x as the sum of two bf16 values, hi + lo, in f32: the two A operands
    the bf16 kernels give a product for an f32 operand (~16 bits)."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool = True,
                            window: int = 0, scale: float | None = None,
                            q_offset: int = 0,
                            scores_as_forward: bool = False,
                            rounded: bool = False):
    """The plain version of the backward kernels over the whole score
    matrix. Returns (dq, dk, dv) in the input dtypes.

    Default: the f32 math of the JAX ``_fa_bwd_dq_kernel`` /
    ``_fa_bwd_dkv_kernel``, S from q * scale in f32.
    ``scores_as_forward``: the same f32 math with S formed as the port's
    forward forms it when it writes lse (q * scale in q.dtype), so that
    P = exp(S - lse) is that forward's softmax: the gradient of the function
    the port's bf16 forward computes. ``rounded``: that, at the rounding
    points of the bf16 kernels (``csrc/flash_bwd_sm90.cu``): P, then
    dS = P (dP - delta), enter their products as hi + lo bf16 pairs
    (``split_bf16``). Every sum in f32; dq and dk from q and k times scale
    in f32. In f32 all three are the same."""
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = scale if scale is not None else D ** -0.5
    p = _bwd_probs(q, k, lse, causal=causal, window=window, scale=scale,
                   q_offset=q_offset,
                   scores_as_forward=scores_as_forward or rounded)
    split = rounded and q.dtype == torch.bfloat16   # the kernels' A operands
    if split:
        p = split_bf16(p)
    qf = (q.float() * scale).reshape(B, Sq, KVH, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, KVH, G, D)
    delta = (do.float() * out.float()).sum(-1)              # (B,Sq,H)
    delta = delta.reshape(B, Sq, KVH, G).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta)
    if split:
        ds = split_bf16(ds)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
