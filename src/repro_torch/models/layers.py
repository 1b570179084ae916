"""Shared layer primitives: inits, norms, RoPE, MLP, embeds.

Twin of ``repro/models/layers.py`` for the dense, moe, ssm, hybrid, audio
(whisper's fixed sinusoidal positions) and vlm (M-RoPE) families. Params
stay f32 and are cast to the compute dtype at each matmul (``mdot``).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers (explicit torch.Generator; the generator's device decides
# where the params live)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               fan_in: int | None = None, lead: Tuple[int, ...] = ()):
    """Truncated normal at +-2 sigma scaled by 1/sqrt(fan_in) (LeCun
    normal). ``lead``: leading stacking axes (units, layers) that share the
    same fan-in. Scaled in place: a stacked leaf can be tens of GB (deepseek-
    v2-lite's expert ``wi``, 19.9 GB in f32), and ``t * std`` would hold a
    second copy of it; the values are bitwise the same."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return t.mul_(std)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...]):
    """N(0, 1) * 0.02, scaled in place as ``dense_init`` is."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return t.normal_(0.0, 1.0, generator=gen).mul_(0.02)


# ---------------------------------------------------------------------------
# mixed-precision matmul helper
# ---------------------------------------------------------------------------


def mdot(x, w, dtype):
    """Matmul with explicit compute dtype (params stay f32)."""
    return torch.matmul(x.to(dtype), w.to(dtype))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, device, lead: Tuple[int, ...] = ()):
    shape = tuple(lead) + (d,)
    if kind == "rmsnorm":
        return {"scale": torch.ones(shape, device=device)}
    return {"scale": torch.ones(shape, device=device),
            "bias": torch.zeros(shape, device=device)}


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * params["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
            + params["bias"]
    return out.to(x.dtype)


def gated_rmsnorm(x, z, scale, eps: float = 1e-6):
    """Mamba-2 RMSNormGated: norm(x * silu(z)) * scale."""
    xf = (x * F.silu(z)).float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    return rope_freqs(head_dim, theta, device)


def rope_freqs(head_dim: int, theta: float, device=None):
    """Inverse frequencies for the half-dim."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def rope_cos_sin(positions, head_dim: int, theta: float,
                 mrope_sections: Tuple[int, ...] = ()):
    """positions: (..., S) int for standard rope, or (..., 3, S) for M-RoPE
    (``mrope_sections``: the widths of the temporal, height and width
    sections of the half-dim; section i takes component i of the
    positions). Returns (cos, sin) of shape (..., S, head_dim//2)."""
    # one table per (head_dim, theta, device), made once: building it
    # copies theta to the device, which would stall the host every layer
    inv = _rope_freqs_on(head_dim, theta, positions.device)
    if mrope_sections:
        if positions.shape[-2] != len(mrope_sections):
            raise ValueError(
                f"M-RoPE positions must be (..., {len(mrope_sections)}, S); "
                f"got {tuple(positions.shape)}")
        parts, off = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(positions[..., i, :, None].float()
                         * inv[off:off + sec])
            off += sec
        ang = torch.cat(parts, dim=-1)
    else:
        ang = positions[..., :, None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2).
    Llama-style rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_embedding(positions, d_model: int):
    """Whisper-style fixed sinusoidal embeddings, f32. positions: (S,) or
    (B, S) integers; returns (..., d_model): sines then cosines."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             lead: Tuple[int, ...] = ()):
    return {
        "wi": dense_init(gen, (d_model, d_ff), lead=lead),
        "wg": dense_init(gen, (d_model, d_ff), lead=lead),
        "wo": dense_init(gen, (d_ff, d_model), fan_in=d_ff, lead=lead),
    }


def apply_mlp(params, x, act: str, dtype):
    h = mdot(x, params["wi"], dtype)
    g = mdot(x, params["wg"], dtype)
    # jax.nn.gelu defaults to the tanh approximation
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return mdot(h * g, params["wo"], dtype)
