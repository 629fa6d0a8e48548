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
there, not a Pallas kernel), float32 inside, differentiable by autograd
(the training path's), with ``ref_recurrent_gla`` the step-by-step
oracle.  Where the reference scans the chunks, the port computes every
chunk's terms at once and loops only over the carried state.  The
hand-written ``kernels/gla_chunk`` computes the same chunked form; the
models call this one, as the reference's do.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _intra_per_channel(qi, ki, lq, lc, tri):
    """One chunk's intra-chunk scores under per-channel decay: the
    [B, H, L, L, Dk] tensor a chunk at a time bounds its memory."""
    diff = lq[:, :, :, None, :] - lc[:, :, None, :, :]        # [B,H,L,L,Dk]
    diff = torch.where(tri[:, :, None], diff, -torch.inf)
    return torch.einsum("bhld,bhmd,bhlmd->bhlm", qi, ki, torch.exp(diff))


def chunked_gla(q, k, v, log_decay, *, chunk: int, state=None,
                include_current: bool = True, bonus=None):
    """q, k: [B, H, T, Dk]; v: [B, H, T, Dv];
    log_decay: [B, H, T, Dk] (per-channel) or [B, H, T, 1] (scalar).
    bonus: [H, Dk] current-token bonus (RWKV u) or None.
    Returns (y [B, H, T, Dv], final_state [B, H, Dk, Dv]).

    Every chunk's intra-chunk terms and state contribution are computed
    at once (a chunk axis N beside the batch); only the carried state
    walks the chunks, two operations a chunk.  Under autograd that keeps
    a layer's operations near constant in T / chunk."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    assert t % chunk == 0, (t, chunk)
    nc = t // chunk
    scalar_decay = log_decay.shape[-1] == 1

    def split(x):                                             # [B,H,N,L,D]
        return x.reshape(b, h, nc, chunk, x.shape[-1]).to(F32)
    qc, kc, vc, wc = split(q), split(k), split(v), split(log_decay)
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=F32, device=q.device)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device),
                     0 if include_current else -1)
    lc = torch.cumsum(wc, dim=3)                      # [B,H,N,L,{Dk|1}]
    lq = lc if include_current else lc - wc                   # Lq_t
    l_last = lc[:, :, :, -1:, :]                      # [B,H,N,1,{Dk|1}]

    # intra-chunk
    if scalar_decay:
        diff = lq[..., :, None, 0] - lc[..., None, :, 0]      # [B,H,N,L,L]
        diff = torch.where(tri, diff, -torch.inf)
        a = torch.einsum("bhnld,bhnmd->bhnlm", qc, kc) * torch.exp(diff)
    else:
        a = torch.stack([_intra_per_channel(qc[:, :, n], kc[:, :, n],
                                            lq[:, :, n], lc[:, :, n], tri)
                         for n in range(nc)], dim=2)
    if bonus is not None:
        diag = (qc * bonus.to(F32)[None, :, None, None, :] * kc).sum(-1)
        a = a + torch.eye(chunk, dtype=F32, device=q.device) * diag[..., None]

    # each chunk's state contribution, then the carried state
    kv = torch.einsum("bhnld,bhnlv->bhndv", kc * torch.exp(l_last - lc), vc)
    decay = torch.exp(l_last.transpose(3, 4) if not scalar_decay
                      else l_last[:, :, :, 0, :, None])   # [B,H,N,{Dk|1},1]
    s_in, starts = state, []
    for dec_n, kv_n in zip(decay.unbind(2), kv.unbind(2)):
        starts.append(s_in)
        s_in = dec_n * s_in + kv_n

    # inter-chunk, then intra
    y = torch.einsum("bhnld,bhndv->bhnlv", qc * torch.exp(lq),
                     torch.stack(starts, dim=2))
    y = y + torch.einsum("bhnlm,bhnmv->bhnlv", a, vc)
    return y.reshape(b, h, t, dv).to(q.dtype), s_in


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


def ref_recurrent_gla(q, k, v, log_decay, *, state=None,
                      include_current=True, bonus=None):
    """O(T) reference recurrence (oracle for tests and the kernel)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=F32, device=q.device)
    ys = []
    for i in range(t):
        y, state = gla_decode_step(
            q[:, :, i], k[:, :, i], v[:, :, i], log_decay[:, :, i], state,
            include_current=include_current, bonus=bonus)
        ys.append(y)
    return torch.stack(ys, dim=2).to(q.dtype), state
