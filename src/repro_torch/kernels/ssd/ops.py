"""Public SSD scan op (Mamba-2 state-space duality), twin of
``repro/kernels/ssd/ops.py``.

``impl="kernel"``: the intra-chunk block on the hand-written Hopper kernels
(``kernel.py``), run by the autograd Function ``SSDIntraChunk``: its
forward launches ``csrc/ssd_fwd.cu`` and saves its inputs, its backward
launches ``csrc/ssd_bwd.cu`` on the cotangents of (y_intra, states, cum).
The inter-chunk combine (``_inter_chunk``) stays outside the Function under
plain autograd, as the JAX ``_pallas_bwd`` differentiates it with
``jax.vjp``.

``impl="reference"``: the chunked plain-PyTorch SSD (``_intra_chunk``, the
twin of ``_intra_chunk_jnp``, plus ``_inter_chunk``), differentiated by
autograd. It is what ``"auto"`` runs on the CPU.

``impl="naive"``: the sequential-recurrence oracle (tests only).

``impl="auto"`` (the config default): the kernels on CUDA, the chunked
reference on the CPU (``repro_torch.kernels.dispatch``).

``_intra_chunk_bwd`` is the plain twin of the backward kernel, written op
for op as the TPU kernel body (``repro/kernels/ssd/kernel.py:61``); the card
check holds the backward kernel against it.

``rounded=True`` (bf16 inputs only; a no-op on f32) takes both twins at the
rounding points of the bf16 tensor-core kernels (``csrc/ssd_fwd_sm90.cu``,
``csrc/ssd_bwd_sm90.cu``): every f32 operand of a product enters it as a
hi + lo pair of bf16 values (``_split``), two products where the partner
is exact bf16 (x, B, C) and three (hi.hi + hi.lo + lo.hi) where both are
f32, with dt and the state weight w folded into G or x first; the
backward sums dG o seg and the state term over a block of heads before
dB and dC (``head_block``), as one kernel CTA does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd import kernel as _kernel
from repro_torch.kernels.ssd import ref as _ref


def _split(t):
    """f32 t as the nearest sum of two bf16 values: (hi, lo) in f32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _mm2(a, b):
    """a @ b with both f32 factors split: hi.hi + hi.lo + lo.hi."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _intra_chunk(x, dt, A, Bm, Cm, chunk, *, rounded=False):
    """Plain twin of the intra-chunk kernel (``_intra_chunk_jnp``).
    Returns (y_intra (B,S,H,P), states (B,nc,H,P,N), cum (B,S,H)), f32.
    ``rounded``: at the bf16 kernel's rounding points (module doc)."""
    rounded = rounded and x.dtype == torch.bfloat16
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    nc = S // chunk
    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    bf = Bm.float().reshape(Bsz, nc, chunk, G, N)
    cf = Cm.float().reshape(Bsz, nc, chunk, G, N)

    cum = torch.cumsum(dtf * A.float(), dim=2)              # (B,nc,L,H)
    # seg[i,j] = exp(cum_i - cum_j), lower triangular; masked BEFORE exp
    # (the upper triangle's diff is positive and would overflow)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,L,L,H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    seg = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                float("-inf")))

    scores = torch.einsum("bclgn,bcmgn->bclmg", cf, bf)      # (B,nc,L,L,G)
    scores = scores.repeat_interleave(rep, dim=-1)           # (B,nc,L,L,H)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtf             # (B,nc,L,H)
    if rounded:
        # G = (s o seg) o dt_j and x o w, each split; x and B exact
        g_hi, g_lo = _split(scores * seg * dtf[:, :, None])
        y_intra = (torch.einsum("bclmh,bcmhp->bclhp", g_hi, xf)
                   + torch.einsum("bclmh,bcmhp->bclhp", g_lo, xf))
        xw_hi, xw_lo = _split(xf * w[..., None])
        br = bf.repeat_interleave(rep, dim=3)
        states = (torch.einsum("bclhp,bclhn->bchpn", xw_hi, br)
                  + torch.einsum("bclhp,bclhn->bchpn", xw_lo, br))
        return (y_intra.reshape(Bsz, S, H, P), states,
                cum.reshape(Bsz, S, H))
    dx = dtf[..., None] * xf                                 # (B,nc,L,H,P)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", scores * seg, dx)

    bw = bf.repeat_interleave(rep, dim=3) * w[..., None]     # (B,nc,L,H,N)
    states = torch.einsum("bclhp,bclhn->bchpn", xf, bw)      # (B,nc,H,P,N)
    return y_intra.reshape(Bsz, S, H, P), states, cum.reshape(Bsz, S, H)


def _per_head(t, Bsz, nc, L, H):
    """(B, S, H, ...) -> (B, nc, H, L, ...)."""
    return t.reshape((Bsz, nc, L, H) + t.shape[3:]).transpose(2, 3)


def _intra_chunk_bwd(x, dt, A, Bm, Cm, dy, dstates, dcum, chunk, *,
                     rounded=False, head_block=None):
    """Plain twin of the intra-chunk backward kernel: the TPU body
    (``_ssd_chunk_bwd_kernel``) op for op, over all (batch, chunk, head)
    tiles at once. Cotangents: dy (B,S,H,P) of y_intra, dstates
    (B,nc,H,P,N) of the chunk-local states, dcum (B,S,H) of cum. Returns
    (dx, ddt, dA, dBm, dCm) in f32, the grouped B/C gradients summed over
    the heads of each group and dA over (batch, chunk).

    ``head_block``: dB and dC are taken once per block of that many heads
    of a group, on dG o seg (and the state term) summed over the block, and
    the blocks' partials are then summed, as the bf16 kernel and its
    wrapper take them; None sums per-head products. ``rounded``: at the
    bf16 kernel's rounding points (module doc), with its head block unless
    one is given."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = chunk
    nc = S // L
    rounded = rounded and x.dtype == torch.bfloat16
    if rounded and head_block is None:
        head_block = _kernel.head_block(rep, chunk, bwd=True)
    xf = _per_head(x.float(), Bsz, nc, L, H)                 # (B,nc,H,L,P)
    dtf = _per_head(dt.float(), Bsz, nc, L, H)               # (B,nc,H,L)
    bm = _per_head(Bm.float().repeat_interleave(rep, dim=2), Bsz, nc, L, H)
    cm = _per_head(Cm.float().repeat_interleave(rep, dim=2), Bsz, nc, L, H)
    a = A.float()[None, None, :, None]                       # (1,1,H,1)
    dyf = _per_head(dy.float(), Bsz, nc, L, H)               # (B,nc,H,L,P)
    dS = dstates.float()                                     # (B,nc,H,P,N)
    dcum_t = _per_head(dcum.float(), Bsz, nc, L, H)          # (B,nc,H,L)

    cum = torch.cumsum(dtf * a, dim=-1)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    seg = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                                float("-inf")))
    scores = cm @ bm.transpose(-1, -2)                       # C·Bᵀ (L,L)
    Gm = scores * seg
    dx_in = dtf[..., None] * xf                              # (L,P)

    # --- y_intra = G @ dx_in ---
    if rounded:
        # dG = (dy x^T) o dt_j with dy split; d_dx = G^T dy, both split
        dy_hi, dy_lo = _split(dyf)
        xt = xf.transpose(-1, -2)
        dG = (dy_hi @ xt + dy_lo @ xt) * dtf[..., None, :]
        d_dx = _mm2(Gm.transpose(-1, -2), dyf)
    else:
        dG = dyf @ dx_in.transpose(-1, -2)                   # (L,L)
        d_dx = Gm.transpose(-1, -2) @ dyf                    # (L,P)
    dGseg = dG * seg                                         # masked
    E = dG * Gm
    dcum_t = dcum_t + E.sum(-1) - E.sum(-2)

    # --- state = Σ_j w_j x_j ⊗ B_j, w_j = exp(cum_L - cum_j)·dt_j ---
    wexp = torch.exp(cum[..., -1:] - cum)                    # (L,)
    w = wexp * dtf
    if rounded:
        ds_hi, ds_lo = _split(dS)
        dS_b = bm @ ds_hi.transpose(-1, -2) + bm @ ds_lo.transpose(-1, -2)
        wxds = _mm2(xf * w[..., None], dS)                   # (L,N)
    else:
        dS_b = bm @ dS.transpose(-1, -2)                     # (L,P)
        wxds = w[..., None] * (xf @ dS)                      # (L,N)
    dw = (xf * dS_b).sum(-1)                                 # (L,)
    dx = w[..., None] * dS_b
    dcum_t = dcum_t - dw * w
    last = torch.zeros_like(dcum_t)
    last[..., -1] = (dw * w).sum(-1)
    dcum_t = dcum_t + last
    ddt = dw * wexp

    # --- dx_in = dt ∘ x ---
    ddt = ddt + (d_dx * xf).sum(-1)
    dx = dx + dtf[..., None] * d_dx

    # --- cum = cumsum(dt·a): reverse-cumsum the dcum ---
    rev = torch.cumsum(dcum_t.flip(-1), dim=-1).flip(-1)
    ddt = ddt + a * rev
    da = (dtf * rev).sum(-1)                                 # (B,nc,H)

    def unflat(t):
        return t.transpose(2, 3).reshape((Bsz, S, H) + t.shape[4:])

    def per_group(t):          # (B,nc,H,L,N) summed over each group's heads
        return unflat(t).reshape(Bsz, S, G, rep, N).sum(3)

    if head_block is None:
        db = per_group(dGseg.transpose(-1, -2) @ cm + wxds)
        dc = per_group(dGseg @ bm)
        return unflat(dx), unflat(ddt), da.sum((0, 1)), db, dc
    # per block of heads of a group: M = Σ dG o seg, then dC = M B and
    # dB = M^T C + Σ (state term); the blocks' partials summed in order
    parts_b, parts_c = [], []
    for h0 in range(0, rep, head_block):
        db_p = torch.zeros((Bsz, nc, G, L, N), device=x.device)
        dc_p = torch.zeros_like(db_p)
        for g in range(G):
            hs = slice(g * rep + h0, g * rep + min(h0 + head_block, rep))
            M = dGseg[:, :, hs].sum(2)                       # (B,nc,L,L)
            sx = wxds[:, :, hs].sum(2)                       # (B,nc,L,N)
            bg, cg = bm[:, :, g * rep], cm[:, :, g * rep]    # (B,nc,L,N)
            if rounded:
                m_hi, m_lo = _split(M)
                db_p[:, :, g] = (sx + m_hi.transpose(-1, -2) @ cg
                                 + m_lo.transpose(-1, -2) @ cg)
                dc_p[:, :, g] = m_hi @ bg + m_lo @ bg
            else:
                db_p[:, :, g] = sx + M.transpose(-1, -2) @ cg
                dc_p[:, :, g] = M @ bg
        parts_b.append(db_p.transpose(2, 3).reshape(Bsz, S, G, N))
        parts_c.append(dc_p.transpose(2, 3).reshape(Bsz, S, G, N))
    return (unflat(dx), unflat(ddt), da.sum((0, 1)),
            torch.stack(parts_b).sum(0), torch.stack(parts_c).sum(0))


def _inter_chunk(y_intra, states, cum, x, dt, A, Cm, D, chunk, init_state):
    """Combine chunk-local states into the full scan and add corrections.
    JAX's ``lax.associative_scan`` over chunks is a loop over nc here."""
    Bsz, S, H, P = y_intra.shape
    G, N = Cm.shape[2], Cm.shape[3]
    rep = H // G
    nc = S // chunk
    cumr = cum.reshape(Bsz, nc, chunk, H)
    chunk_decay = torch.exp(cumr[:, :, -1, :])               # (B,nc,H)

    # s_c = a_c * s_{c-1} + b_c, s_{-1} = init_state (or 0)
    s = None if init_state is None else init_state.float()
    s_in = []
    for c in range(nc):
        s_in.append(torch.zeros_like(states[:, 0]) if s is None else s)
        b = states[:, c]
        s = b if s is None else chunk_decay[:, c][..., None, None] * s + b
    s_in = torch.stack(s_in, dim=1)                          # (B,nc,H,P,N)

    cf = Cm.float().reshape(Bsz, nc, chunk, G, N)
    y_inter = torch.einsum("bclgn,bcgrpn->bclgrp", cf,
                           s_in.reshape(Bsz, nc, G, rep, P, N))
    y_inter = (y_inter.reshape(Bsz, nc, chunk, H, P)
               * torch.exp(cumr)[..., None])
    y = y_intra + y_inter.reshape(Bsz, S, H, P)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y, s


class SSDIntraChunk(torch.autograd.Function):
    """(y_intra, states, cum) of the intra-chunk SSD block, with the
    kernels on both passes. ``apply(x, dt, A, Bm, Cm, chunk)``; S must be a
    multiple of ``chunk``. The backward takes the cotangents of all three
    outputs (zeros where an output is unused) and returns f32 gradients
    cast to the inputs' dtypes."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, chunk):
        return _kernel.ssd_fwd(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, Bm, Cm, chunk = inputs
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, dstates, dcum):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        dx, ddt, dA, dB, dC = _kernel.ssd_bwd(
            x, dt, A, Bm, Cm, dy.float().contiguous(),
            dstates.float().contiguous(), dcum.float().contiguous(),
            chunk=ctx.chunk)
        return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
                dB.to(Bm.dtype), dC.to(Cm.dtype), None)


def _chunked(intra, x, dt, A, Bm, Cm, D, chunk, init_state):
    """Pad S to a multiple of c = min(chunk, S), run ``intra`` on the
    chunks, combine. Padded steps have dt = 0: decay 1 and contribution 0,
    so the final state is exact."""
    S = x.shape[1]
    c = min(chunk, S)
    pad = (-S) % c
    dt, A = dt.contiguous(), A.contiguous()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    y_intra, states, cum = intra(x, dt, A, Bm, Cm, c)
    y, final = _inter_chunk(y_intra, states, cum, x, dt, A, Cm, D, c,
                            init_state)
    return (y[:, :S] if pad else y), final


def _chunked_reference(x, dt, A, Bm, Cm, D, chunk, init_state):
    return _chunked(_intra_chunk, x, dt, A, Bm, Cm, D, chunk, init_state)


def ssd_scan(x, dt, A, Bm, Cm, D=None, *, init_state=None, chunk: int = 128,
             impl: str = "auto", design=None):
    """Mamba-2 SSD scan. x: (B,S,H,P); dt: (B,S,H) post-softplus; A: (H,)
    negative; Bm, Cm: (B,S,G,N); D: (H,) or None.
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32)."""
    if design:
        raise NotImplementedError(
            "SSD design points wait for the kernel-tuning slice; the port "
            "has no tuning cache yet")
    which = dispatch.resolve(impl, x.device)
    if which == "naive":
        return _ref.ssd_ref(x, dt, A, Bm, Cm, D, init_state)
    if which == "reference":
        return _chunked_reference(x, dt, A, Bm, Cm, D, chunk, init_state)
    return _chunked(SSDIntraChunk.apply, x, dt, A, Bm, Cm, D, chunk,
                    init_state)


ssd_decode = _ref.ssd_decode_ref
