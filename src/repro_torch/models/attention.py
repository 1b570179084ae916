"""GQA attention (+bias, sliding window, cross, M-RoPE) and MLA: train,
prefill and decode.

Twin of the GQA and MLA parts of ``repro/models/attention.py``. Prefill
attention goes through the flash-attention op (the hand-written kernel on
CUDA; MLA's at qk's head dim, 192 for deepseek-v2-lite and 96 for
minicpm3-4b); single-token decode attends over the cache in plain PyTorch,
as the reference does in plain jnp (MLA's absorbed decode in the latent
space). Cross attention (whisper's decoder) takes k and v from the encoder
output, with no rope and no mask, and caches them once at prefill; its
decode computes q alone and attends over that static cache. Caches are
plain dicts of tensors; MLA's is the latent ``{c_kv, k_rope}``, not
per-head K/V.

The paged KV pool (``gqa_empty_page_pool``, ``gqa_decode_paged``) holds
full-attention GQA caches as one ``(n_pages, page_size, KVH, Dh)`` pool
shared by every slot of the compiled serving engine, read through per-slot
block tables. Decode writes take fixed shapes only (no boolean indexing,
no ``.item()``), so a decode step can be captured in a CUDA graph; with
``inplace=True`` a decode writes its new row into the cache it was given,
where by default it returns a written copy and leaves the input as it
was. ``write_mask`` (a (B,) bool tensor) limits those writes to the rows
of the slots it marks: the others keep their cache rows, so two
evaluations of one step, each on its own weights, can share one cache
(the compiled engine's two weight generations).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (
    apply_norm, apply_rope, dense_init, mdot, rope_cos_sin,
)

# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def init_gqa(gen: torch.Generator, cfg: ModelConfig, lead=(),
             cross: bool = False):
    """Self or (``cross``) cross attention: the same params either way."""
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
    """Rope on q and k at ``positions``: (B, S), or (B, 3, S) under M-RoPE
    (``cfg.mrope_sections``)."""
    if positions is None:
        return q, k
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.mrope_sections)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def gqa_forward(params, x, cfg: ModelConfig, *, positions=None,
                window: int = 0, causal: bool = True, cross_x=None,
                return_cache: bool = False, length=None):
    """Train/prefill path. x: (B,S,d). cross_x: the encoder output for
    cross attention (k and v from it; no rope, no mask). Returns out or
    (out, cache). ``length``: the count of real tokens (an int) when x is
    right-padded to a prefill bucket: window caches then take their slots
    from real positions only."""
    dtype = x.dtype
    kv_src = cross_x if cross_x is not None else x
    q, k, v = _qkv(params, x, kv_src, cfg, dtype)
    if cross_x is None:
        q, k = _rope(cfg, q, k, positions)
    out = flash_attention(q, k, v, causal=causal and cross_x is None,
                          window=window, chunk=cfg.attention_chunk,
                          impl=cfg.attention_impl)
    B, S = x.shape[:2]
    out = mdot(out.reshape(B, S, -1), params["wo"], dtype)
    if not return_cache:
        return out
    if window > 0:
        k = _window_slots(k, window, length)
        v = _window_slots(v, window, length)
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


def _window_slots(kv, window: int, length=None):
    """Arrange the last `window` entries into circular slot order.
    kv: (B,S,KVH,Dh) -> (B,window,KVH,Dh) where slot i holds the latest
    position p <= S-1 with p = i (mod window), or zeros if none.
    ``length``: the count of real tokens; rows past it are bucket padding
    and land in no slot."""
    B, S, KVH, Dh = kv.shape
    if length is not None:
        # the same rule with the real length: p = latest real pos = i mod W
        i = torch.arange(window, device=kv.device)
        p = (length - 1) - torch.remainder(length - 1 - i, window)
        rows = kv.index_select(1, p.clamp(0, S - 1))
        return torch.where((p >= 0)[None, :, None, None], rows,
                           torch.zeros_like(rows))
    if S <= window:
        return torch.cat([kv, kv.new_zeros(B, window - S, KVH, Dh)], dim=1)
    slots = torch.arange(S - window, S, device=kv.device) % window
    out = kv.new_zeros(B, window, KVH, Dh)
    out[:, slots] = kv[:, S - window:]
    return out


def _row_mask(mask, like):
    """A (B,) bool mask shaped to broadcast over ``like``'s dims past the
    first."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _write_slot(buf, new, slot, inplace: bool = False, mask=None):
    """The cache ``buf`` (B, L, ...) with ``new[b, 0]`` written at ``slot``
    of each row b: a copy, or ``buf`` itself with ``inplace``. ``slot`` is a
    Python int, or a (B,) tensor of per-row slots, where one past L drops
    its write, as a JAX scatter does: the index is clamped and the row's
    old value written back, so the op's shapes never depend on the
    data. ``mask`` ((B,) bool): rows b where it is False keep their old
    value the same way."""
    out = buf if inplace else buf.clone()
    val = new[:, 0].to(buf.dtype)
    if isinstance(slot, torch.Tensor):
        L = buf.shape[1]
        rows = torch.arange(buf.shape[0], device=buf.device)
        idx = slot.clamp(max=L - 1)
        keep = slot < L
        if mask is not None:
            keep = keep & mask
        out[rows, idx] = torch.where(_row_mask(keep, val), val,
                                     out[rows, idx])
    elif mask is not None:
        out[:, slot] = torch.where(_row_mask(mask, val), val, out[:, slot])
    else:
        out[:, slot] = val
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


def gqa_decode(params, x, cache, pos, cfg: ModelConfig, *, window: int = 0,
               positions=None, cross: bool = False, use_rope: bool = True,
               inplace: bool = False, write_mask=None):
    """One-token decode. x: (B,1,d); cache{k,v}: (B,L,KVH,Dh); pos: a Python
    int (one position for the batch) or a (B,) long tensor (per-request
    positions, continuous batching). ``positions``: the token's rope
    positions, (B, 1) or (B, 3, 1) under M-RoPE; (B, 1) ``pos`` by
    default. ``cross``: the cache is the encoder's static K/V, and
    only q is computed. Returns (out, new_cache); the input cache is left
    as it was, unless ``inplace``: then the new row is written into it and
    it is returned. ``write_mask``: the slots whose rows are written (all
    by default)."""
    dtype = x.dtype
    B = x.shape[0]
    H, Dh = cfg.n_heads, cfg.head_dim
    if cross:
        q = mdot(x, params["wq"], dtype)
        if cfg.qkv_bias:
            q = q + params["bq"].to(dtype)
        k, v = _cache_kv(cache, dtype)
        out = _cache_attend(q.reshape(B, 1, H, Dh), k, v, kpos=None)
        return mdot(out.reshape(B, 1, -1), params["wo"], dtype), cache

    q, k_new, v_new = _qkv(params, x, x, cfg, dtype)
    vec = isinstance(pos, torch.Tensor)
    if use_rope:
        if positions is None:
            positions = (pos[:, None] if vec
                         else torch.full((B, 1), pos, device=x.device))
        q, k_new = _rope(cfg, q, k_new, positions)

    L = cache["k"].shape[1]
    slot = (torch.remainder(pos, L) if vec else pos % L) if window > 0 else pos

    if "k_scale" in cache:      # int8 cache: quantize the new token
        knq, kns = quantize_kv(k_new)
        vnq, vns = quantize_kv(v_new)
        new = {"k": knq, "k_scale": kns, "v": vnq, "v_scale": vns}
    else:
        new = {"k": k_new, "v": v_new}
    new_cache = {key: _write_slot(cache[key], t, slot, inplace, write_mask)
                 for key, t in new.items()}
    k, v = _cache_kv(new_cache, dtype)

    kpos = _slot_positions(pos, L, window).to(x.device)
    out = _cache_attend(q, k, v, kpos=kpos)
    out = mdot(out.reshape(B, 1, -1), params["wo"], dtype)
    return out, new_cache


def _cache_attend(q, k, v, kpos):
    """Single-query attention over a cache. q: (B,1,H,Dh); k/v:
    (B,L,KVH,Dh); kpos: (L,) or per-request (B,L) absolute positions, or
    None (cross attention: every row is visible)."""
    B, _, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qf = (q.float() * Dh ** -0.5).reshape(B, KVH, G, Dh)
    s = torch.einsum("bhgd,blhd->bhgl", qf, k.float())
    if kpos is not None:
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


# ---------------------------------------------------------------------------
# paged KV pool (block tables over one pool shared by every slot)
# ---------------------------------------------------------------------------


def gqa_empty_page_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                        dtype, device):
    """The KV page pool shared by every slot: ``(n_pages, page_size, KVH,
    Dh)`` a leaf. Page 0 is the reserved null page: block-table entries of
    unallocated regions (and of freed slots) point at it, so writes past a
    slot's pages land in rows that the position mask never admits. The
    int8 pool's scales start at ``1e-8 / 127``, as the dense cache's."""
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        zq = torch.zeros(shape, dtype=torch.int8, device=device)
        zs = torch.full(shape[:3] + (1,), 1e-8 / 127.0, dtype=torch.float32,
                        device=device)
        return {"k": zq, "k_scale": zs, "v": zq.clone(), "v_scale": zs.clone()}
    z = torch.zeros(shape, dtype=dtype, device=device)
    return {"k": z, "v": z.clone()}


def _write_page(buf, new, page, off, inplace: bool, mask=None):
    """``buf`` (n_pages, P, ...) with ``new[b, 0]`` written at row ``off[b]``
    of page ``page[b]`` for every b (a copy, or ``buf`` with
    ``inplace``); with ``mask`` ((B,) bool) only for the b it marks, the
    others writing the row's old value back (a slot's rows lie in its own
    pages, or in the null page)."""
    out = buf if inplace else buf.clone()
    val = new[:, 0].to(buf.dtype)
    if mask is not None:
        val = torch.where(_row_mask(mask, val), val, out[page, off])
    out[page, off] = val
    return out


def gqa_decode_paged(params, x, cache, pos, block_tables, cfg: ModelConfig,
                     *, positions=None, use_rope: bool = True,
                     inplace: bool = False, write_mask=None):
    """One-token decode against a paged KV pool.

    cache leaves: ``(n_pages, page_size, KVH, Dh)``, the pool;
    ``block_tables``: (B, M) long page ids a slot (0 = the null page); pos:
    (B,) long per-slot positions; ``positions``: the token's rope positions,
    (B, 1) or (B, 3, 1) under M-RoPE, (B, 1) ``pos`` by default.

    The new token is written to ``pool[bt[b, pos // P], pos % P]``, then
    each slot's pages are gathered into a (B, M*P) view. Rows <= pos of
    that view hold what a dense per-slot cache would, and rows > pos are
    masked out of the softmax, so greedy tokens equal the dense layout's.
    Returns (out, new_cache); with ``inplace`` the pool is written in place
    and returned, else a written copy is. ``write_mask``: the slots whose
    rows are written (all by default)."""
    dtype = x.dtype
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, x, cfg, dtype)
    if use_rope:
        if positions is None:
            positions = pos[:, None]
        q, k_new = _rope(cfg, q, k_new, positions)

    P = cache["k"].shape[1]                      # page size
    M = block_tables.shape[1]
    rows = torch.arange(B, device=x.device)
    # a JAX gather clamps an index past the table, as this does
    page = block_tables[rows, torch.div(pos, P, rounding_mode="floor")
                        .clamp(max=M - 1)]
    off = torch.remainder(pos, P)
    if "k_scale" in cache:      # int8 pool: quantize the new token
        knq, kns = quantize_kv(k_new)
        vnq, vns = quantize_kv(v_new)
        new = {"k": knq, "k_scale": kns, "v": vnq, "v_scale": vns}
    else:
        new = {"k": k_new, "v": v_new}
    new_cache = {key: _write_page(cache[key], t, page, off, inplace,
                                  write_mask)
                 for key, t in new.items()}

    def gather(buf):                   # (B, M, P, ...) -> (B, M*P, ...)
        return buf[block_tables].reshape((B, M * P) + buf.shape[2:])

    k, v = _cache_kv({key: gather(t) for key, t in new_cache.items()}, dtype)
    out = _cache_attend(q, k, v, kpos=_slot_positions(pos, M * P, 0))
    out = mdot(out.reshape(B, 1, -1), params["wo"], dtype)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3/DeepSeek-V2 style)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, lead=()):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    lead = tuple(lead)
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    r = m.kv_lora_rank
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), lead=lead),
        "q_norm": {"scale": torch.ones(lead + (m.q_lora_rank,),
                                       device=gen.device)},
        "wq_b": dense_init(gen, (m.q_lora_rank, H * qh),
                           fan_in=m.q_lora_rank, lead=lead),
        "wkv_a": dense_init(gen, (d, r + m.qk_rope_head_dim), lead=lead),
        "kv_norm": {"scale": torch.ones(lead + (r,), device=gen.device)},
        "wk_b": dense_init(gen, (r, H * m.qk_nope_head_dim), fan_in=r,
                           lead=lead),
        "wv_b": dense_init(gen, (r, H * m.v_head_dim), fan_in=r, lead=lead),
        "wo": dense_init(gen, (H * m.v_head_dim, d), fan_in=H * m.v_head_dim,
                         lead=lead),
    }


def _mla_q(params, x, cfg: ModelConfig, positions, dtype):
    m = cfg.mla
    B, S, _ = x.shape
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    q_lat = apply_norm(params["q_norm"], mdot(x, params["wq_a"], dtype),
                       "rmsnorm", cfg.norm_eps)
    q = mdot(q_lat, params["wq_b"], dtype).reshape(B, S, cfg.n_heads, qh)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_latent(params, x, cfg: ModelConfig, positions, dtype):
    """(c_kv (B,S,r) normed, k_rope (B,S,rope) rotated): what the cache
    holds."""
    m = cfg.mla
    kv = mdot(x, params["wkv_a"], dtype)
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = apply_norm(params["kv_norm"], c_kv, "rmsnorm", cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]


def mla_forward(params, x, cfg: ModelConfig, *, positions,
                return_cache: bool = False):
    """Expanded (train/prefill) MLA: per-head K/V made from the latent, the
    rope part of k shared by every head, v zero-padded to qk's head dim for
    the flash op (deepseek-v2-lite: 128 + 64 = 192) and sliced back after.
    Returns out, or (out, latent cache {c_kv, k_rope})."""
    m = cfg.mla
    dtype = x.dtype
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(params, x, cfg, positions, dtype)
    c_kv, k_rope = _mla_latent(params, x, cfg, positions, dtype)

    k_nope = mdot(c_kv, params["wk_b"], dtype).reshape(
        B, S, H, m.qk_nope_head_dim)
    v = mdot(c_kv, params["wv_b"], dtype).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    qh = q.shape[-1]
    vpad = F.pad(v, (0, qh - m.v_head_dim))
    out = flash_attention(q, k, vpad, causal=True, chunk=cfg.attention_chunk,
                          impl=cfg.attention_impl, scale=qh ** -0.5)
    out = out[..., :m.v_head_dim].reshape(B, S, -1)
    out = mdot(out, params["wo"], dtype)
    if not return_cache:
        return out
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(params, x, cache, pos, cfg: ModelConfig, positions=None,
               inplace: bool = False, write_mask=None):
    """Absorbed-latent decode: attention runs in the kv_lora_rank space over
    the (B, L, r) + (B, L, rope) cache, in plain PyTorch as the reference
    runs it in plain jnp. pos: a Python int or a (B,) long tensor (per-slot
    positions); ``positions``: the token's (B, 1) rope positions, ``pos``
    by default. Returns (out, new_cache); the input cache is left as it
    was, unless ``inplace``: then it is written and returned.
    ``write_mask``: the slots whose rows are written (all by default)."""
    m = cfg.mla
    dtype = x.dtype
    B = x.shape[0]
    H = cfg.n_heads
    vec = isinstance(pos, torch.Tensor)
    if positions is None:
        positions = (pos[:, None] if vec
                     else torch.full((B, 1), pos, device=x.device))
    q_nope, q_rope = _mla_q(params, x, cfg, positions, dtype)    # (B,1,H,.)
    c_new, kr_new = _mla_latent(params, x, cfg, positions, dtype)

    c_kv = _write_slot(cache["c_kv"], c_new, pos, inplace, write_mask)
    k_rope = _write_slot(cache["k_rope"], kr_new, pos, inplace, write_mask)

    L = c_kv.shape[1]
    r = m.kv_lora_rank
    wk_b = params["wk_b"].to(dtype).reshape(r, H, m.qk_nope_head_dim)
    # absorb: q' = q_nope @ W_k^T per head -> latent space
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wk_b)       # (B,H,r)
    s = torch.einsum("bhr,blr->bhl", q_lat, c_kv.to(dtype))
    s = s + torch.einsum("bhd,bld->bhl", q_rope[:, 0], k_rope.to(dtype))
    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
    s = s.float() * (qh ** -0.5)
    limit = pos[:, None, None] if vec else pos
    s = torch.where(torch.arange(L, device=x.device)[None, None, :] <= limit,
                    s, -1e30)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhl,blr->bhr", p.to(dtype), c_kv.to(dtype))
    wv_b = params["wv_b"].to(dtype).reshape(r, H, m.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", o_lat, wv_b).reshape(B, 1, -1)
    out = mdot(o, params["wo"], dtype)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_empty_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                    device):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, cache_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }
