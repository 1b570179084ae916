"""Mixture-of-experts FFN with top-k routing and capacity-gather dispatch.

Twin of ``repro/models/moe.py``: top-k routing per token in f32, the
position of each (token, k) in its expert by a cumulative count in (s, k)
scan order, a gather of tokens into dense (batch, experts, capacity, d)
blocks, one batched einsum per expert weight, then a gather back and a
gate-weighted sum over k. Capacity overflow drops a token's contribution
from that expert (slot C, cut away), exactly the tokens the reference
drops. The router's aux load-balance loss is Switch/GShard's.

The reference's ``logical_constraint`` calls on the dispatched blocks are
sharding hints for a device mesh; on one card they have no counterpart
(the model axis is ROADMAP A13c).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, mdot


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead=()):
    """The reference's leaves and distributions: ``wi``/``wg`` of shape
    (E, d, f) take dense_init's default fan-in, the leading E, as the
    reference's ``dense_init(key, (E, d, f))`` does."""
    m = cfg.moe
    d = cfg.d_model
    return {
        "router": dense_init(gen, (d, m.n_experts), lead=lead),
        "wi": dense_init(gen, (m.n_experts, d, m.d_ff), lead=lead),
        "wg": dense_init(gen, (m.n_experts, d, m.d_ff), lead=lead),
        "wo": dense_init(gen, (m.n_experts, m.d_ff, d), fan_in=m.d_ff,
                         lead=lead),
    }


def capacity(cfg: ModelConfig, seq: int) -> int:
    m = cfg.moe
    c = int(seq * m.top_k / m.n_experts * m.capacity_factor)
    return max(4, min(seq, (c + 3) // 4 * 4))


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    broken by the lower index first, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, x, cfg: ModelConfig):
    """Router probabilities (B,S,E) f32, and each token's top-k gates
    (normalized over k) and experts, (B,S,K)."""
    logits = mdot(x, params["router"], torch.float32)       # router in f32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, cfg.moe.top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, expert_idx


def aux_loss(probs, expert_idx, cfg: ModelConfig):
    """Switch's load-balance loss: E * sum_e f_e * p_e, weighted."""
    E = cfg.moe.n_experts
    me = probs.mean(dim=(0, 1))                                    # (E,)
    ce = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    return E * (me * ce).sum() * cfg.moe.aux_loss_weight


def dispatch_slots(expert_idx, E: int, C: int) -> Tuple[torch.Tensor, ...]:
    """(flat_e, pos, keep), each (B, S*K): the expert of each (token, k) in
    (s, k) scan order, its position in that expert's queue, and whether it
    fits the capacity C."""
    B, S, K = expert_idx.shape
    flat_e = expert_idx.reshape(B, S * K)
    onehot = F.one_hot(flat_e, E)                                  # (B,SK,E)
    pos_in_e = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]
    return flat_e, pos, pos < C


def moe_forward(params, x, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar f32)."""
    m = cfg.moe
    B, S, d = x.shape
    dtype = x.dtype
    K, E = m.top_k, m.n_experts
    C = capacity(cfg, S)

    probs, gate_vals, expert_idx = route(params, x, cfg)
    aux = aux_loss(probs, expert_idx, cfg)
    flat_e, pos, keep = dispatch_slots(expert_idx, E, C)

    # scatter token indices into (B, E, C) dispatch slots; dropped
    # (token, k) go to slot C, which is cut away
    tok_idx = (torch.arange(S * K, device=x.device) // K).expand(B, S * K)
    safe_pos = torch.where(keep, pos, C)
    bidx = torch.arange(B, device=x.device)[:, None]
    dispatch = torch.zeros((B, E, C + 1), dtype=torch.long, device=x.device)
    filled = torch.zeros((B, E, C + 1), dtype=torch.bool, device=x.device)
    dispatch[bidx, flat_e, safe_pos] = tok_idx
    # a device value: a Python True would be copied from the host, which
    # a CUDA graph capture (the compiled engine's decode) refuses
    filled[bidx, flat_e, safe_pos] = keep.new_ones(())
    dispatch, filled = dispatch[..., :C], filled[..., :C]          # (B,E,C)

    # gather tokens into dense expert blocks
    xg = torch.gather(x, 1, dispatch.reshape(B, E * C, 1).expand(-1, -1, d))
    xg = xg.reshape(B, E, C, d) * filled[..., None].to(dtype)

    h = torch.einsum("becd,edf->becf", xg, params["wi"].to(dtype))
    g = torch.einsum("becd,edf->becf", xg, params["wg"].to(dtype))
    y = torch.einsum("becf,efd->becd", h * F.silu(g),
                     params["wo"].to(dtype))                      # (B,E,C,d)

    # gather back per (token, k): flat slot index e*C + pos
    slot = flat_e * C + torch.clamp(safe_pos, max=C - 1)           # (B,SK)
    yk = torch.gather(y.reshape(B, E * C, d), 1,
                      slot[..., None].expand(-1, -1, d))           # (B,SK,d)
    w = (gate_vals.reshape(B, S * K) * keep.float()).to(dtype)
    out = (yk * w[..., None]).reshape(B, S, K, d).sum(dim=2)
    return out, aux


def moe_forward_dense(params, x, cfg: ModelConfig):
    """Every expert on every token, no capacity (the oracle of the tests)."""
    dtype = x.dtype
    probs, gate_vals, expert_idx = route(params, x, cfg)
    gates = torch.zeros_like(probs).scatter(-1, expert_idx, gate_vals)
    h = torch.einsum("bsd,edf->bsef", x, params["wi"].to(dtype))
    g = torch.einsum("bsd,edf->bsef", x, params["wg"].to(dtype))
    y = torch.einsum("bsef,efd->bsed", h * F.silu(g), params["wo"].to(dtype))
    out = torch.einsum("bsed,bse->bsd", y, gates.to(dtype))
    return out, aux_loss(probs, expert_idx, cfg)
