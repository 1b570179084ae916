"""Plain oracle for the Mamba-2 SSD scan: the literal sequential recurrence.

    s_t = exp(dt_t * A) * s_{t-1} + dt_t * (x_t ⊗ B_t)
    y_t = (s_t @ C_t) + D * x_t

Twin of ``repro/kernels/ssd/ref.py``. ``ssd_ref`` is a Python loop over S,
for tests only; ``ssd_decode_ref`` is the one-token step that decode runs
on every device (no kernel does decode).
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, A, Bm, Cm, D=None, init_state=None):
    """x: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B,S,G,N) with H % G == 0; D: (H,) or None.
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf, dtf = x.float(), dt.float()
    Bf = Bm.float().repeat_interleave(rep, dim=2)          # (B,S,H,N)
    Cf = Cm.float().repeat_interleave(rep, dim=2)
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)[..., None, None]  # (B,H,1,1)
        s = (decay * s + dtf[:, t, :, None, None] * xf[:, t, :, :, None]
             * Bf[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((Bsz, 0, H, P), device=x.device))
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y, s


def ssd_decode_ref(x, dt, A, Bm, Cm, D, state):
    """Single-token decode. x: (B,H,P); dt: (B,H); Bm, Cm: (B,G,N);
    state: (B,H,P,N) f32. Returns (y (B,H,P) in x.dtype, new_state f32)."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    bt = Bm.float().repeat_interleave(rep, dim=1)
    ct = Cm.float().repeat_interleave(rep, dim=1)
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A)[..., None, None]
    state = (decay * state + dtf[..., None, None] * xf[..., None]
             * bt[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, ct)
    if D is not None:
        y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), state
