"""Plain oracles of the kernel entry point (:mod:`repro_torch.kernels.ops`),
with the JAX package's layouts and dtypes: the straightforward loops and
dense products that the kernels and their plain versions are held
against.  Torch on whatever device the inputs lie; ``ref_spmv_from_edges``
is numpy in float64."""
from __future__ import annotations

import numpy as np
import torch


def _t(a, dtype=None):
    x = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def ref_block_csr_spmv(tiles, tile_col, row_ptr, x, *, tile: int):
    """Dense reference for the block-CSR SpMV: row block by row block,
    tile by tile, in float32."""
    tiles, x = _t(tiles, torch.float32), _t(x, torch.float32)
    tile_col, row_ptr = _t(tile_col).tolist(), _t(row_ptr).tolist()
    n_rows = len(row_ptr) - 1
    out = torch.zeros(n_rows * tile, dtype=torch.float32, device=x.device)
    for r in range(n_rows):
        acc = torch.zeros(tile, dtype=torch.float32, device=x.device)
        for ti in range(row_ptr[r], row_ptr[r + 1]):
            col = tile_col[ti]
            acc = acc + tiles[ti] @ x[col * tile:(col + 1) * tile]
        out[r * tile:(r + 1) * tile] = acc
    return out


def ref_spmv_from_edges(src, dst, data, x, num_vertices):
    """Edge-list oracle: out[d] = sum over edges (s->d) data * x[s]."""
    out = np.zeros(num_vertices, np.float64)
    np.add.at(out, np.asarray(dst), np.asarray(data)
              * np.asarray(x, np.float64)[np.asarray(src)])
    return out


NEG_INF = -1e30   # masked scores: finite, so a row with no valid key is
                  # the mean of v where -inf would give NaN


def softcap_and_mask(s, q0, *, causal, window, softcap):
    """Scaled float32 scores ``s`` [BH, rows, Skv] of the query positions
    ``q0, q0 + 1, ...``: ``tanh(s / softcap) * softcap`` when ``softcap``,
    then every masked score set to ``NEG_INF`` (positions count from 0 for
    q and kv alike)."""
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    dev = s.device
    qp = torch.arange(q0, q0 + s.shape[1], device=dev)
    kp = torch.arange(s.shape[2], device=dev)
    keep = torch.ones((s.shape[1], s.shape[2]), dtype=torch.bool,
                      device=dev)
    if causal:
        keep &= kp[None, :] <= qp[:, None]
    if window:
        keep &= kp[None, :] > qp[:, None] - window
    return torch.where(keep[None], s, torch.tensor(NEG_INF, device=dev))


def ref_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: [BH, Sq, D]; k/v: [BH, Skv, D].  Masked scores are the finite
    -1e30, so a row with no valid key is the mean of v."""
    d = q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    s = softcap_and_mask(s, 0, causal=causal, window=window,
                         softcap=softcap)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ref_gla(q, k, v, w, u=None, *, include_current=True):
    """Recurrent oracle.  q/k/w: [BH, T, Dk]; v: [BH, T, Dv]; u: [BH, Dk].
    Returns (y [BH, T, Dv] in q.dtype, final state [BH, Dk, Dv] f32)."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    s = torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
    qf, kf, vf, wf = (a.float() for a in (q, k, v, w))
    ys = []
    for i in range(t):
        decay = torch.exp(wf[:, i])[:, :, None]
        kv = kf[:, i, :, None] * vf[:, i, None, :]
        if include_current:
            s = decay * s + kv
            y = torch.einsum("bd,bdv->bv", qf[:, i], s)
        else:
            y = torch.einsum("bd,bdv->bv", qf[:, i], s)
            if u is not None:
                y = y + torch.einsum("bd,bd,bd,bv->bv", qf[:, i], u.float(),
                                     kf[:, i], vf[:, i])
            s = decay * s + kv
        ys.append(y)
    return torch.stack(ys, 1).to(q.dtype), s
