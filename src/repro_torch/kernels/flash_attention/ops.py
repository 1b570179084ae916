"""Public attention op (twin of ``repro/kernels/flash_attention/ops.py``).

``impl="kernel"``: the hand-written Hopper kernels (``kernel.py``), run by
the autograd Function ``FlashAttention``: its forward launches
``csrc/flash_fwd.cu`` and saves (q, k, v, out, lse); its backward launches
the delta, dQ and dK/dV kernels of ``csrc/flash_bwd.cu`` (the twin of the JAX
``custom_vjp`` in ``repro/kernels/flash_attention/ops.py``). The phase-2
ensemble runs it worker by worker (``repro_torch.train.loop``), so it has
no ``vmap`` rule.

``impl="reference"``: the blockwise plain-PyTorch flash formulation (loop
over KV chunks, online softmax), the twin of the JAX ``_blockwise_reference``.
It is what ``"auto"`` runs on the CPU.

``impl="naive"``: the oracle (tests only).

``impl="auto"`` (the config default): the kernel on CUDA, the blockwise
reference on the CPU (``repro_torch.kernels.dispatch``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref

NEG_INF = -1e30


def _blockwise_fwd(q, k, v, *, causal, window, scale, q_offset, chunk):
    """Online-softmax attention chunked over KV; returns (out, lse).

    Q/K/V stay in their own dtype (q is scaled in q.dtype), the dots
    accumulate in f32, running max/sum and the softmax are f32, and p is
    rounded to v.dtype before P.V, as the JAX blockwise reference does.
    lse is m + log(l) in f32, and 0 for rows that see no key."""
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    scale = scale if scale is not None else D ** -0.5
    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)

    qf = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, Sq, KVH, G, D)
    qf = qf.float()
    qpos = torch.arange(Sq, device=q.device) + q_offset

    m = torch.full((B, Sq, KVH, G, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Sq, KVH, G, D), dtype=torch.float32,
                      device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb.float())
        kpos = ci * chunk + torch.arange(kb.shape[1], device=q.device)
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        p = torch.where(m_new > -1e29, p, 0.0)
        alpha = torch.where(m > -1e29, torch.exp(m - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), vb.float())
        m = m_new
    empty = l == 0.0
    l = torch.where(empty, 1.0, l)
    out = (acc / l).reshape(B, Sq, H, D).to(q.dtype)
    lse = torch.where(empty, 0.0, m + torch.log(l)).reshape(B, Sq, H)
    return out, lse


def _blockwise_reference(q, k, v, *, causal, window, scale, q_offset, chunk):
    """Twin of the JAX ``_blockwise_reference``: the output only."""
    return _blockwise_fwd(q, k, v, causal=causal, window=window, scale=scale,
                          q_offset=q_offset, chunk=chunk)[0]


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0):
    """Forward returning (out (B,Sq,H,D) in q.dtype, lse (B,Sq,H) f32).

    A CUDA tensor goes to the hand-written kernel, which launches or
    raises; a CPU tensor goes to the plain blockwise version (chunk 512)."""
    if q.device.type == "cpu":
        return _blockwise_fwd(q, k, v, causal=causal, window=window,
                              scale=scale, q_offset=q_offset, chunk=512)
    return _kernel.flash_fwd(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset)


class FlashAttention(torch.autograd.Function):
    """(out, lse) = flash attention of (q, k, v), with the kernels on both
    passes. ``apply(q, k, v, causal, window, scale, q_offset)``; lse is not
    differentiable."""

    @staticmethod
    def forward(q, k, v, causal, window, scale, q_offset):
        return _kernel.flash_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal,
                                 window=window, scale=scale,
                                 q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, scale, q_offset = inputs
        out, lse = output
        ctx.save_for_backward(q.contiguous(), k.contiguous(),
                              v.contiguous(), out, lse)
        ctx.kw = dict(causal=causal, window=window, scale=scale,
                      q_offset=q_offset)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _kernel.flash_bwd(q, k, v, out, lse, dout.contiguous(),
                                       **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0,
                    chunk: int = 512, impl: str = "auto"):
    """GQA flash attention. q: (B,Sq,H,D); k,v: (B,Skv,KVH,D)."""
    which = dispatch.resolve(impl, q.device)
    if which == "naive":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale, q_offset=q_offset)
    if which == "reference":
        return _blockwise_reference(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset,
                                    chunk=chunk)
    return FlashAttention.apply(q, k, v, causal, window, scale, q_offset)[0]
