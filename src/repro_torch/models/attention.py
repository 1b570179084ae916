"""GQA attention (+bias, sliding window): train, prefill and decode.

Twin of the GQA part of ``repro/models/attention.py``. Prefill attention
goes through the flash-attention op (the hand-written kernel on CUDA);
single-token decode attends over the cache in plain PyTorch, as the
reference does in plain jnp. Caches are plain dicts of tensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, mdot, rope_cos_sin

# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def init_gqa(gen: torch.Generator, cfg: ModelConfig, lead=()):
    d, H, KVH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, H * Dh), lead=lead),
        "wk": dense_init(gen, (d, KVH * Dh), lead=lead),
        "wv": dense_init(gen, (d, KVH * Dh), lead=lead),
        "wo": dense_init(gen, (H * Dh, d), fan_in=H * Dh, lead=lead),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", KVH), ("bv", KVH)):
            p[name] = torch.zeros(tuple(lead) + (n * Dh,), device=gen.device)
    return p


def _qkv(params, x, kv_x, cfg: ModelConfig, dtype):
    B, S, _ = x.shape
    Skv = kv_x.shape[1]
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = mdot(x, params["wq"], dtype)
    k = mdot(kv_x, params["wk"], dtype)
    v = mdot(kv_x, params["wv"], dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dtype)
        k = k + params["bk"].to(dtype)
        v = v + params["bv"].to(dtype)
    return (q.reshape(B, S, H, Dh), k.reshape(B, Skv, KVH, Dh),
            v.reshape(B, Skv, KVH, Dh))


def _rope(cfg: ModelConfig, q, k, positions):
    if positions is None:
        return q, k
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def gqa_forward(params, x, cfg: ModelConfig, *, positions=None,
                window: int = 0, causal: bool = True,
                return_cache: bool = False):
    """Train/prefill path. x: (B,S,d). Returns out or (out, cache)."""
    dtype = x.dtype
    q, k, v = _qkv(params, x, x, cfg, dtype)
    q, k = _rope(cfg, q, k, positions)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          chunk=cfg.attention_chunk, impl=cfg.attention_impl)
    B, S = x.shape[:2]
    out = mdot(out.reshape(B, S, -1), params["wo"], dtype)
    if not return_cache:
        return out
    if window > 0:
        k = _window_slots(k, window)
        v = _window_slots(v, window)
    return out, _maybe_quant_cache(cfg, k, v)


# ---------------------------------------------------------------------------
# int8 KV cache (symmetric per-(token, head) quantization)
# ---------------------------------------------------------------------------


def quantize_kv(x):
    """x: (..., Dh) -> (int8 values, f32 scale with trailing 1-dim).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _maybe_quant_cache(cfg: ModelConfig, k, v):
    if cfg.kv_cache_dtype != "int8":
        return {"k": k, "v": v}
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}


def _cache_kv(cache, dtype):
    if "k_scale" in cache:
        return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
                dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def _window_slots(kv, window: int):
    """Arrange the last `window` entries into circular slot order.
    kv: (B,S,KVH,Dh) -> (B,window,KVH,Dh) where slot i holds the latest
    position p <= S-1 with p = i (mod window), or zeros if none."""
    B, S, KVH, Dh = kv.shape
    if S <= window:
        return torch.cat([kv, kv.new_zeros(B, window - S, KVH, Dh)], dim=1)
    slots = torch.arange(S - window, S, device=kv.device) % window
    out = kv.new_zeros(B, window, KVH, Dh)
    out[:, slots] = kv[:, S - window:]
    return out


def _slot_positions(pos, cache_len: int, window: int):
    """Absolute position stored in each slot of a (possibly circular) cache
    after the token at `pos` has been written; -1 = empty. pos: a Python
    int or a (B,) tensor; returns (L,) or (B, L) accordingly."""
    if isinstance(pos, torch.Tensor):
        i = torch.arange(cache_len, device=pos.device)[None, :]
        pos = pos[:, None]
    else:
        i = torch.arange(cache_len)
    if window > 0:
        p = pos - torch.remainder(pos - i, cache_len)
        return torch.where(p >= 0, p, -1)
    return torch.where(i <= pos, i, -1)


def gqa_decode(params, x, cache, pos, cfg: ModelConfig, *, window: int = 0):
    """One-token decode. x: (B,1,d); cache{k,v}: (B,L,KVH,Dh); pos: a Python
    int (one position for the batch) or a (B,) long tensor (per-request
    positions, continuous batching). Returns (out, new_cache); the input
    cache is left as it was."""
    dtype = x.dtype
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, x, cfg, dtype)
    vec = isinstance(pos, torch.Tensor)
    positions = (pos[:, None] if vec
                 else torch.full((B, 1), pos, device=x.device))
    q, k_new = _rope(cfg, q, k_new, positions)

    L = cache["k"].shape[1]
    slot = (torch.remainder(pos, L) if vec else pos % L) if window > 0 else pos

    def upd(buf, new):
        out = buf.clone()
        if vec:
            # out-of-range slots drop their write, as a JAX scatter does
            ok = slot < L
            out[torch.arange(B, device=buf.device)[ok], slot[ok]] = \
                new[ok, 0].to(buf.dtype)
        else:
            out[:, slot] = new[:, 0].to(buf.dtype)
        return out

    if "k_scale" in cache:      # int8 cache: quantize the new token
        knq, kns = quantize_kv(k_new)
        vnq, vns = quantize_kv(v_new)
        new_cache = {"k": upd(cache["k"], knq),
                     "k_scale": upd(cache["k_scale"], kns),
                     "v": upd(cache["v"], vnq),
                     "v_scale": upd(cache["v_scale"], vns)}
    else:
        new_cache = {"k": upd(cache["k"], k_new), "v": upd(cache["v"], v_new)}
    k, v = _cache_kv(new_cache, dtype)

    kpos = _slot_positions(pos, L, window).to(x.device)
    out = _cache_attend(q, k, v, kpos=kpos)
    out = mdot(out.reshape(B, 1, -1), params["wo"], dtype)
    return out, new_cache


def _cache_attend(q, k, v, kpos):
    """Single-query attention over a cache. q: (B,1,H,Dh); k/v:
    (B,L,KVH,Dh); kpos: (L,) or per-request (B,L) absolute positions."""
    B, _, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qf = (q.float() * Dh ** -0.5).reshape(B, KVH, G, Dh)
    s = torch.einsum("bhgd,blhd->bhgl", qf, k.float())
    kp = kpos if kpos.dim() == 2 else kpos[None, :]
    s = torch.where(kp[:, None, None, :] >= 0, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgl,blhd->bhgd", p, v.float())
    return o.reshape(B, 1, H * Dh).to(q.dtype)


def gqa_empty_cache(cfg: ModelConfig, batch: int, cache_len: int,
                    window: int, dtype, device):
    L = min(cache_len, window) if window > 0 else cache_len
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        zq = torch.zeros(shape, dtype=torch.int8, device=device)
        zs = torch.full(shape[:3] + (1,), 1e-8 / 127.0, dtype=torch.float32,
                        device=device)
        return {"k": zq, "k_scale": zs, "v": zq.clone(), "v_scale": zs.clone()}
    z = torch.zeros(shape, dtype=dtype, device=device)
    return {"k": z, "v": z.clone()}
