"""Mamba-2 block (SSD), twin of ``repro/models/mamba2.py``: in_proj ->
causal depthwise conv -> SSD scan -> gated RMSNorm -> out_proj.

Train and prefill run the chunked SSD (``kernels/ssd/ops.ssd_scan``: the
hand-written intra-chunk kernels on CUDA, the plain chunked version on the
CPU); decode keeps a (conv window, SSD state) cache, O(1) per token. The
views of the conv output that the scan takes (x, B, C) are strided slices,
which the kernels read in place.

``mamba_forward``'s ``length=`` and ``init_cache=`` serve the compiled
serving engine's right-padded prefill buckets and a chunked prefill's
continuation, as in the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd.ops import ssd_decode, ssd_scan
from repro_torch.models.layers import dense_init, gated_rmsnorm, mdot


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nh, conv_dim


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = ()):
    """Params of ``prod(lead)`` blocks stacked on the ``lead`` axes, on
    ``gen.device``, under the reference's keys and with its distributions
    (the numbers differ from JAX's for the same seed)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_dim = _dims(cfg)
    lead = tuple(lead)
    dev = gen.device
    # dt bias init so softplus(dt_bias) spans [dt_min, dt_max] (mamba2 init)
    u = torch.rand(lead + (nh,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                   + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))            # inverse softplus
    a0, a1 = s.a_init_range
    A = torch.rand(lead + (nh,), generator=gen, device=dev) * (a1 - a0) + a0
    return {
        "in_proj": dense_init(
            gen, (d, 2 * d_in + 2 * s.n_groups * s.d_state + nh), lead=lead),
        "conv_w": dense_init(gen, (s.d_conv, conv_dim), fan_in=s.d_conv,
                             lead=lead),
        "conv_b": torch.zeros(lead + (conv_dim,), device=dev),
        "dt_bias": dt_bias,
        "A_log": torch.log(A),
        "D": torch.ones(lead + (nh,), device=dev),
        "norm_scale": torch.ones(lead + (d_in,), device=dev),
        "out_proj": dense_init(gen, (d_in, d), fan_in=d_in, lead=lead),
    }


def _split_proj(cfg: ModelConfig, proj):
    s = cfg.ssm
    d_in, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * gn]
    dt_raw = proj[..., d_in + d_in + 2 * gn:]
    return z, xbc, dt_raw


def _causal_conv(xbc, w, b, dtype):
    """Depthwise causal conv via shifted adds (d_conv is tiny)."""
    K = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    acc = torch.zeros_like(xbc)
    for i in range(K):
        acc = acc + w[i].to(dtype) * pad[:, i:i + S]
    return F.silu(acc + b.to(dtype))


def mamba_forward(params, u, cfg: ModelConfig, *, return_cache: bool = False,
                  init_cache=None, length=None):
    """u: (B,S,d). Returns out or (out, cache{conv, state}).

    ``init_cache``: a cache to continue from (a chunked prefill): its conv
    window is prepended to the conv's input and its state starts the scan.
    ``length``: the count of real tokens (an int) when u is right-padded
    to a prefill bucket. dt is zeroed past it (decay exp(0 A) = 1,
    contribution 0), so the final state is the state after exactly
    ``length`` tokens, and the conv cache holds the last d_conv-1 real
    inputs, not the padded tail."""
    s = cfg.ssm
    dtype = u.dtype
    B, S, _ = u.shape
    d_in, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state

    proj = mdot(u, params["in_proj"], dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    if init_cache is not None:
        hist = init_cache["conv"].to(dtype)
        conv = _causal_conv(torch.cat([hist, xbc], dim=1), params["conv_w"],
                            params["conv_b"], dtype)[:, hist.shape[1]:]
    else:
        conv = _causal_conv(xbc, params["conv_w"], params["conv_b"], dtype)
    x = conv[..., :d_in].reshape(B, S, nh, s.head_dim)
    Bm = conv[..., d_in:d_in + gn].reshape(B, S, s.n_groups, s.d_state)
    Cm = conv[..., d_in + gn:].reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    if length is not None:
        dt = torch.where(torch.arange(S, device=u.device)[None, :, None]
                         < length, dt, 0.0)
    A = -torch.exp(params["A_log"])

    y, final_state = ssd_scan(
        x, dt, A, Bm, Cm, params["D"],
        init_state=None if init_cache is None else init_cache["state"],
        chunk=s.chunk_size, impl=cfg.ssd_impl, design=cfg.ssd_design or None)
    y = y.to(dtype).reshape(B, S, d_in)
    y = gated_rmsnorm(y, z, params["norm_scale"], cfg.norm_eps)
    out = mdot(y, params["out_proj"], dtype)
    if not return_cache:
        return out
    K1 = s.d_conv - 1
    if length is not None:
        idx = length - K1 + torch.arange(K1, device=u.device)
        rows = xbc.index_select(1, idx.clamp(0, S - 1))
        conv_cache = torch.where((idx >= 0)[None, :, None], rows,
                                 torch.zeros_like(rows))
    else:
        conv_cache = (xbc[:, S - K1:] if S >= K1
                      else F.pad(xbc, (0, 0, K1 - S, 0)))
    return out, {"conv": conv_cache, "state": final_state}


def mamba_decode(params, u, cache, cfg: ModelConfig, inplace: bool = False,
                 write_mask=None):
    """One-token decode. u: (B,1,d); cache{conv (B,K-1,conv_dim),
    state (B,nh,P,N)}. Returns (out, new_cache); the cache is left as it
    was, unless ``inplace``: then the new conv window and state are copied
    into it and it is returned. ``write_mask`` ((B,) bool): only the slots
    it marks take the new window and state; the others keep theirs."""
    s = cfg.ssm
    dtype = u.dtype
    B = u.shape[0]
    d_in, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state

    proj = mdot(u, params["in_proj"], dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = xbc[:, 0]                                       # (B, conv_dim)

    w = params["conv_w"].to(dtype)                        # (K, conv_dim)
    hist = cache["conv"].to(dtype)                        # (B, K-1, conv_dim)
    conv = (w[:-1][None] * hist).sum(dim=1) + w[-1][None] * xbc
    conv = F.silu(conv + params["conv_b"].to(dtype))
    new_conv = torch.cat([hist[:, 1:], xbc[:, None]], dim=1)

    x = conv[..., :d_in].reshape(B, nh, s.head_dim)
    Bm = conv[..., d_in:d_in + gn].reshape(B, s.n_groups, s.d_state)
    Cm = conv[..., d_in + gn:].reshape(B, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    y, new_state = ssd_decode(x, dt, A, Bm, Cm, params["D"], cache["state"])
    y = y.to(dtype).reshape(B, 1, d_in)
    y = gated_rmsnorm(y, z, params["norm_scale"], cfg.norm_eps)
    out = mdot(y, params["out_proj"], dtype)
    new_conv = new_conv.to(cache["conv"].dtype)
    if write_mask is not None:
        def keep(new, old):
            m = write_mask.reshape((-1,) + (1,) * (new.dim() - 1))
            return torch.where(m, new, old)
        new_conv = keep(new_conv, cache["conv"])
        new_state = keep(new_state, cache["state"])
    if inplace:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
        return out, cache
    return out, {"conv": new_conv, "state": new_state}


def mamba_empty_cache(cfg: ModelConfig, batch: int, dtype, device):
    s = cfg.ssm
    _, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }
