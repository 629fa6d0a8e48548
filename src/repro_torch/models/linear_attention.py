"""Chunked gated linear attention — shared recurrence core for RWKV6 (Finch,
per-channel data-dependent decay) and Mamba2 (SSD, per-head scalar decay).

Recurrence (state S in R^{Dk x Dv}, decay applied before the token enters):
    S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
    y_t = q_t S_t                      (include_current=True, Mamba2)
    y_t = q_t S_{t-1} + (q_t . (u*k_t)) v_t
                                       (include_current=False + bonus u, RWKV6)

Chunked parallel form, with L_t = cumsum of w inside a chunk:
    inter:  y_t += (q_t * exp(Lq_t)) @ S_in
    intra:  A[t,s] = sum_d q_td k_sd exp(Lq_td - L_sd)   (masked s<t or s<=t)
    state:  S_out = exp(L_last)*S_in + sum_s (k_s exp(L_last - L_s)) v_s^T
where Lq_t = L_t (Mamba) or L_{t-1} (RWKV).  All exponents in live positions
are <= 0, so the computation is overflow-safe; the masked region is clamped
before the exp.  Scalar decay uses a cheap [L, L] outer form instead of the
[L, L, Dk] per-channel tensor.

The port's plain-torch copy of ``repro.models.linear_attention`` (jnp
there, not a Pallas kernel): a loop over chunks in place of ``lax.scan``,
float32 inside.  The hand-written ``kernels/gla_chunk`` computes the same
chunked form; the models call this one, as the reference's do.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def chunked_gla(q, k, v, log_decay, *, chunk: int, state=None,
                include_current: bool = True, bonus=None):
    """q, k: [B, H, T, Dk]; v: [B, H, T, Dv];
    log_decay: [B, H, T, Dk] (per-channel) or [B, H, T, 1] (scalar).
    bonus: [H, Dk] current-token bonus (RWKV u) or None.
    Returns (y [B, H, T, Dv], final_state [B, H, Dk, Dv])."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    assert t % chunk == 0, (t, chunk)
    scalar_decay = log_decay.shape[-1] == 1
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=F32, device=q.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device),
                     0 if include_current else -1)
    eye = torch.eye(chunk, dtype=F32, device=q.device)
    bonus32 = None if bonus is None else bonus.to(F32)
    s_in = state
    ys = []
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        qi, ki, vi = q[:, :, sl].to(F32), k[:, :, sl].to(F32), v[:, :, sl].to(F32)
        wi = log_decay[:, :, sl].to(F32)
        lc = torch.cumsum(wi, dim=2)                          # [B,H,L,{Dk|1}]
        lq = lc if include_current else lc - wi               # Lq_t
        l_last = lc[:, :, -1:, :]                             # [B,H,1,{Dk|1}]

        # inter-chunk
        y = torch.einsum("bhld,bhdv->bhlv", qi * torch.exp(lq), s_in)

        # intra-chunk
        if scalar_decay:
            diff = lq[:, :, :, None, 0] - lc[:, :, None, :, 0]    # [B,H,L,L]
            diff = torch.where(tri, diff, -torch.inf)
            a = torch.einsum("bhld,bhmd->bhlm", qi, ki) * torch.exp(diff)
        else:
            diff = lq[:, :, :, None, :] - lc[:, :, None, :, :]    # [B,H,L,L,Dk]
            diff = torch.where(tri[:, :, None], diff, -torch.inf)
            a = torch.einsum("bhld,bhmd,bhlmd->bhlm", qi, ki,
                             torch.exp(diff))
        if bonus32 is not None:
            diag = (qi * bonus32[None, :, None, :] * ki).sum(-1)  # [B,H,L]
            a = a + eye[None, None] * diag[:, :, :, None]
        y = y + torch.einsum("bhlm,bhmv->bhlv", a, vi)

        # state update
        k_scaled = ki * torch.exp(l_last - lc)
        decay = (l_last.transpose(2, 3) if not scalar_decay
                 else l_last[:, :, 0, :, None])
        s_in = torch.exp(decay) * s_in + torch.einsum(
            "bhld,bhlv->bhdv", k_scaled, vi)
        ys.append(y.to(q.dtype))
    return torch.cat(ys, dim=2), s_in


def gla_decode_step(q1, k1, v1, w1, state, *, include_current: bool = True,
                    bonus=None):
    """Single-token recurrence.  q1/k1: [B, H, Dk]; v1: [B, H, Dv];
    w1: [B, H, Dk] or [B, H, 1] log decay; state [B, H, Dk, Dv].
    Returns (y [B, H, Dv], new_state)."""
    q1, k1, v1 = q1.to(F32), k1.to(F32), v1.to(F32)
    decay = torch.exp(w1.to(F32))[..., None]                  # [B,H,Dk|1,1]
    kv = k1[..., :, None] * v1[..., None, :]                  # [B,H,Dk,Dv]
    if include_current:
        new_state = decay * state + kv
        y = torch.einsum("bhd,bhdv->bhv", q1, new_state)
    else:
        y = torch.einsum("bhd,bhdv->bhv", q1, state)
        if bonus is not None:
            y = y + (q1 * bonus.to(F32) * k1).sum(-1, keepdim=True) * v1
        new_state = decay * state + kv
    return y, new_state
