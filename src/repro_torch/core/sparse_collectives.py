"""DFO collectives of the graph engine (DESIGN.md §12) — the graph half of
``repro.core.sparse_collectives`` on a :class:`~repro_torch.core.mesh.ProcessMesh`.

The paper's phases 2-3 (filter -> inter-node pass -> intra-node dispatch)
move only the payloads a destination needs.  On the mesh, phase 2 is a
real all-to-all: the dense slab (:func:`filtered_all_to_all`), or the
compacted exchange that ships at most ``capacity`` (value, source-index)
pairs per peer (:func:`masked_compacted_all_to_all`, its multi-query
panel twin, and :func:`compacted_all_to_all` for one destination per
entry), re-densified on the receive side by
:func:`compacted_scatter_back` so phases 3-4 see the exact dense layout.

Each collective is a rank-local compaction (``*_send``: the buffers this
rank hands ``all_to_all`` and its live-count maximum), the mesh's
``all_to_all``, and the ``pmax``'d overflow flag — so the local halves
run, and are tested, without a process group.  The scatters mirror the
reference's (adds into zeros, maxima into -1), so every buffer is
bit-identical to the reference's.

The MoE and embedding half of the reference module (``topk_routing``,
``dense_dispatch``, ``dense_combine``, ``vocab_sharded_embed``,
``take_embed``) belongs to the LM stack and is not here.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def blocked_cumsum(x: torch.Tensor, block: int) -> torch.Tensor:
    """Two-level cumulative sum along dim 0: cumsum within blocks plus the
    exclusive cumsum of the block totals — the reference's blocked routing
    scan, the same values as ``torch.cumsum(x, 0)`` (exactly so for
    integer inputs)."""
    n = x.shape[0]
    if n <= block:
        return torch.cumsum(x, dim=0, dtype=x.dtype)
    pad = (-n) % block
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    nb = xp.shape[0] // block
    xb = xp.reshape((nb, block) + tuple(x.shape[1:]))
    within = torch.cumsum(xb, dim=1, dtype=x.dtype)
    totals = within[:, -1]
    offsets = torch.cumsum(totals, dim=0, dtype=x.dtype) - totals
    out = (within + offsets[:, None]).reshape((nb * block,)
                                              + tuple(x.shape[1:]))
    return out[:n]


def capacity_bucket(count: int, floor: int = 8) -> int:
    """Round a live-count bound up to a power-of-two capacity bucket (at
    least ``floor``): the reference's bucketing, which bounds its compiled
    variants at ``log2(v_max)`` per algorithm and never undershoots the
    bound, so the overflow fallback is a backstop, not a steady path."""
    n = max(int(count), 1)
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# Dense slab (the legacy physical wire)
# ---------------------------------------------------------------------------

def filtered_send(payload: torch.Tensor, send_mask: torch.Tensor):
    """Local half of :func:`filtered_all_to_all`: the [P, V, ...] masked
    payload slab and the int8 presence slab this rank ships."""
    shape = tuple(send_mask.shape) + (1,) * (payload.dim() - 1)
    send = torch.where(send_mask.reshape(shape), payload[None],
                       torch.zeros((), dtype=payload.dtype,
                                   device=payload.device))
    return send, send_mask.to(torch.int8)


def filtered_all_to_all(payload: torch.Tensor, send_mask: torch.Tensor,
                        mesh):
    """Per-destination masked exchange (paper phase 2).

    payload: [V, ...] local values; send_mask: [P, V] bool — which local
    entries each destination rank needs.  Returns (recv_payload
    [P, V, ...], recv_mask [P, V] bool): entry [p, v] is source rank p's
    value v, present iff p sent it."""
    send, mask8 = filtered_send(payload, send_mask)
    return mesh.all_to_all(send), mesh.all_to_all(mask8) > 0


# ---------------------------------------------------------------------------
# Compacted exchanges (DESIGN.md §12)
# ---------------------------------------------------------------------------

def _live_slots(mask: torch.Tensor, capacity: int):
    """The compaction of a [P, V] send mask: row-major positions of the
    kept entries (live and among the first ``capacity`` of their row, in
    order), each one's slot ``row * capacity + position`` in the [P *
    capacity] buffer, and the largest row count (a 0-d tensor).

    Every kept entry owns its slot, so writing ``x + 0.0`` there equals the
    reference's add into a zero buffer (the sum turns -0.0 into +0.0 as
    that add does), and writing its index equals its max into -1."""
    p, v = mask.shape
    mi = mask.to(I32)
    pos = torch.cumsum(mi, dim=1) - 1
    ok = mask & (pos < capacity)
    sel = torch.nonzero(ok.reshape(-1)).reshape(-1)
    slot = (sel // v) * capacity + pos.reshape(-1)[sel]
    return sel, slot, (torch.max(torch.sum(mi, dim=1)) if p
                       else mi.new_zeros(()))


def _added(x):
    return x + torch.zeros((), dtype=x.dtype, device=x.device)


def compacted_send(payload: torch.Tensor, dest: torch.Tensor, capacity: int,
                   p: int):
    """Local half of :func:`compacted_all_to_all`: entries grouped by
    destination in stable order, at most ``capacity`` per destination.

    payload [V, D]; dest [V] int (-1 = inactive).  Returns (buf
    [P, capacity, D], src_index [P, capacity] int32 — -1 at padding,
    the largest per-destination live count as a 0-d tensor)."""
    v, d = payload.shape
    dev = payload.device
    mask = (dest.long()[None, :]
            == torch.arange(p, device=dev)[:, None])            # [P, V]
    sel, slot, cmax = _live_slots(mask, capacity)
    src = sel % v
    buf = torch.zeros((p * capacity, d), dtype=payload.dtype, device=dev)
    buf[slot] = _added(payload[src])
    idx = torch.full((p * capacity,), -1, dtype=I32, device=dev)
    idx[slot] = src.to(I32)
    return buf.reshape(p, capacity, d), idx.reshape(p, capacity), cmax


def compacted_all_to_all(payload: torch.Tensor, dest: torch.Tensor,
                         capacity: int, mesh):
    """DCSR-analogue exchange: live entries compacted per destination
    before sending, at most ``capacity`` per peer (the |L_ij| bound).

    payload [V, D]; dest [V] (-1 = inactive).  Returns (recv
    [P, capacity, D], recv_src_index [P, capacity] int32, overflow bool).
    Padding contract: slots a peer did not fill carry ``recv_src_index ==
    -1`` and zero payload rows; ``recv_src_index >= 0`` is the only
    validity signal.  ``overflow`` is the ``pmax``'d live-count check,
    identical on every rank: True iff any (source, destination) pair had
    more than ``capacity`` live entries — the result is then truncated
    and the caller must fall back to :func:`filtered_all_to_all`."""
    buf, idx, cmax = compacted_send(payload, dest, capacity, mesh.size)
    overflow = bool(mesh.pmax(cmax.reshape(1).to(I32)).item() > capacity)
    return mesh.all_to_all(buf), mesh.all_to_all(idx), overflow


def masked_compacted_send(payload: torch.Tensor, send_mask: torch.Tensor,
                          capacity: int):
    """Local half of :func:`masked_compacted_all_to_all`: each destination
    row of the [P, V] send mask compacted to at most ``capacity`` (value,
    source-local index) pairs.  Returns (buf [P, capacity], src_index
    [P, capacity] int32, the largest per-destination live count)."""
    p, v = send_mask.shape
    dev = payload.device
    sel, slot, cmax = _live_slots(send_mask, capacity)
    src = sel % v
    buf = torch.zeros(p * capacity, dtype=payload.dtype, device=dev)
    buf[slot] = _added(payload[src])
    idx = torch.full((p * capacity,), -1, dtype=I32, device=dev)
    idx[slot] = src.to(I32)
    return buf.reshape(p, capacity), idx.reshape(p, capacity), cmax


def masked_compacted_all_to_all(payload: torch.Tensor,
                                send_mask: torch.Tensor, capacity: int,
                                mesh):
    """Mask-form compacted exchange: the graph engine's phase-2 wire.

    A DFO message travels to every destination whose need-list holds it,
    so the send decision is a [P, V] mask (``phases.filter_sendmask``);
    each destination row ships its <= ``capacity`` live entries as
    (value, source-local index) pairs.  payload [V]; send_mask [P, V]
    bool.  Returns (recv [P, capacity], recv_src_index [P, capacity]
    int32, overflow) with :func:`compacted_all_to_all`'s padding and
    ``pmax``'d overflow contract."""
    buf, idx, cmax = masked_compacted_send(payload, send_mask, capacity)
    overflow = bool(mesh.pmax(cmax.reshape(1).to(I32)).item() > capacity)
    return mesh.all_to_all(buf), mesh.all_to_all(idx), overflow


def masked_compacted_send_mq(values: torch.Tensor, send_maskp: torch.Tensor,
                             capacity: int):
    """Local half of :func:`masked_compacted_all_to_all_mq`: entries
    compacted by the UNION (any-query) mask — one shared source-index
    stream per peer, Q value columns and Q int8 presence flags.  Returns
    (vals [P, capacity, Q], presence [P, capacity, Q] int8, src_index
    [P, capacity] int32, the largest per-destination union count)."""
    p, v, q = send_maskp.shape
    dev = values.device
    sel, slot, cmax = _live_slots(torch.any(send_maskp, dim=-1), capacity)
    src = sel % v
    present = send_maskp.reshape(p * v, q)[sel]                  # [L, Q]
    zero = torch.zeros((), dtype=values.dtype, device=dev)
    bufv = torch.zeros((p * capacity, q), dtype=values.dtype, device=dev)
    bufv[slot] = _added(torch.where(present, values[src], zero))
    bufm = torch.zeros((p * capacity, q), dtype=torch.int8, device=dev)
    bufm[slot] = present.to(torch.int8)
    idx = torch.full((p * capacity,), -1, dtype=I32, device=dev)
    idx[slot] = src.to(I32)
    return (bufv.reshape(p, capacity, q), bufm.reshape(p, capacity, q),
            idx.reshape(p, capacity), cmax)


def masked_compacted_all_to_all_mq(values: torch.Tensor,
                                   send_maskp: torch.Tensor, capacity: int,
                                   mesh):
    """Multi-query panel variant of :func:`masked_compacted_all_to_all`
    (DESIGN.md §11 wire, §12 physical): values [V, Q], send_maskp
    [P, V, Q] bool.  Returns (recv_vals [P, capacity, Q], recv_maskp
    [P, capacity, Q] bool, recv_src_index [P, capacity] int32, overflow);
    ``capacity`` bounds the per-peer UNION count."""
    bufv, bufm, idx, cmax = masked_compacted_send_mq(values, send_maskp,
                                                     capacity)
    overflow = bool(mesh.pmax(cmax.reshape(1).to(I32)).item() > capacity)
    return (mesh.all_to_all(bufv), mesh.all_to_all(bufm) > 0,
            mesh.all_to_all(idx), overflow)


# ---------------------------------------------------------------------------
# Receive side: re-densify into the [P, V] slab layout
# ---------------------------------------------------------------------------

def _valid_targets(recv_idx, v_max):
    """Flat receive slots holding a live pair and the cell each one fills
    in the [P * v_max] slab (source indices are unique within a row, so
    every cell takes at most one pair)."""
    p, cap = recv_idx.shape
    sel = torch.nonzero(recv_idx.reshape(-1) >= 0).reshape(-1)
    cell = (sel // cap) * v_max + recv_idx.reshape(-1)[sel].long()
    return sel, cell


def compacted_scatter_back(recv: torch.Tensor, recv_idx: torch.Tensor,
                           v_max: int):
    """Re-densify a compacted receive into the [P, v_max] slab layout.

    Each live (value, source index) pair lands at its source-local
    position; padding slots (``recv_src_index == -1``) contribute nothing.
    Source indices within one peer row are unique, so every cell takes at
    most one add into zero and the result is the dense
    :func:`filtered_all_to_all` slab bit for bit.  Returns (msg [P, V],
    mask [P, V] bool)."""
    p = recv_idx.shape[0]
    sel, cell = _valid_targets(recv_idx, v_max)
    msg = torch.zeros(p * v_max, dtype=recv.dtype, device=recv.device)
    msg[cell] = _added(recv.reshape(-1)[sel])
    mask = torch.zeros(p * v_max, dtype=torch.bool, device=recv.device)
    mask[cell] = True
    return msg.reshape(p, v_max), mask.reshape(p, v_max)


def compacted_scatter_back_mq(recv_vals: torch.Tensor,
                              recv_maskp: torch.Tensor,
                              recv_idx: torch.Tensor, v_max: int):
    """Panel twin of :func:`compacted_scatter_back`: a [P, capacity, Q]
    compacted panel back to the [P, v_max, Q] slab the multi-query combine
    reads, bit-identical to the dense panel exchange."""
    p, cap, q = recv_vals.shape
    sel, cell = _valid_targets(recv_idx, v_max)
    dev = recv_vals.device
    vals = torch.zeros((p * v_max, q), dtype=recv_vals.dtype, device=dev)
    vals[cell] = _added(recv_vals.reshape(p * cap, q)[sel])
    maskp = torch.zeros((p * v_max, q), dtype=torch.bool, device=dev)
    maskp[cell] = recv_maskp.reshape(p * cap, q)[sel]
    return vals.reshape(p, v_max, q), maskp.reshape(p, v_max, q)
