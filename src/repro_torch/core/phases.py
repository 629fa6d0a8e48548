"""ProcessEdges phase implementations (DESIGN.md §1) — the LOCAL subset of
``repro.core.phases`` on torch tensors.

The paper's four phases (§4.2–§4.4):

  1. generating          — active vertices produce messages (``signal``),
  2. inter-node pass     — ``filter_sendmask`` decides, per destination,
                           which messages cross the wire (paper §4.3),
  3. intra-node dispatch — ``dispatch_one_dest`` routes messages to
                           destination batches via the dispatching graph
                           (= the DCSR arrays, §4.2),
  4. processing          — ``process_segment_one_dest`` (flat segment
                           reference) or ``process_block_one_dest`` (the
                           block-CSR combine kernel) combine ``slot``
                           contributions per destination vertex.

The reference writes phases 3–4 for one destination and ``vmap``s them;
here the vmap axis is written out: every ``*_one_dest`` function takes its
per-destination arrays with a leading destination axis Q and returns
per-destination results ``[Q, ...]``, so phase 4 of a whole ProcessEdges
is one kernel launch.  Functions the host (numpy) executors share keep
the reference's ``xp=`` switch (numpy or torch).

The ``mq_*`` functions price a multi-query pass (DESIGN.md §11): the
wire batches and chunk reads of the union of Q frontiers, paid once.
:func:`reduce_worker_counters` sums the dist_ooc workers' private counters
in worker order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exchange import batch_wire_bytes
from repro_torch.kernels.csr_spmv import block_csr_combine

F32 = torch.float32


def _f32(x, xp):
    return x.astype(np.float32) if xp is np else x.to(F32)


# ---------------------------------------------------------------------------
# Phase 2: message filtering (paper §4.3)
# ---------------------------------------------------------------------------


def filter_sendmask(amask, need, need_counts, m, cfg, xp=torch):
    """Source partitions' send decisions toward every destination.

    amask [..., V] bool: the partition's active (message-producing) vertices.
    need [..., Q, V] bool: need-bitmaps — v has >=1 out-edge into q.
    need_counts [..., Q] int: |L_pq| need-list lengths.
    m [...]: |M_p| = number of messages the partition generated.

    Returns sendmask [..., Q, V]: which messages travel to each
    destination.  The filter is skipped (send everything) when the
    need-list is not substantially smaller than the message file (the
    paper's 2x threshold).  Leading axes are source partitions (the
    reference's vmap axis, written out)."""
    base = xp.broadcast_to(amask[..., None, :], need.shape)
    if not cfg.enable_filtering:
        return base
    filtered = amask[..., None, :] & need
    skip = _f32(need_counts, xp) >= (
        cfg.filter_skip_threshold * xp.asarray(m)[..., None])
    return xp.where(skip[..., None], base, filtered)


def routing_counts(recv_mask, xp=torch):
    """Filter output -> the per-(destination, source) routing structure:
    counts[..., q, p] = messages partition p sends partition q.  This one
    reduction feeds the analytic network model (:func:`net_bytes_model`).
    Host (numpy) callers count in float64 — exact against measured bytes —
    while the torch path keeps the counters' float32."""
    if xp is np:
        return np.sum(recv_mask, axis=-1).astype(np.float64)
    return torch.sum(recv_mask, dim=-1, dtype=F32)


def batch_value_uniform(mask, values, xp=torch):
    """Per-batch uniformity of the masked message values: True where every
    value the batch actually sends is identical (and the batch is
    nonempty).  Reduces over the last axis; ``values`` broadcasts against
    ``mask``.  The same masked min == max reduction an encoder runs before
    choosing the single-value ``uval`` wire encoding (exact float32
    comparison — a NaN anywhere in the batch reads as non-uniform)."""
    if xp is np:
        hi = np.max(np.where(mask, values, -np.inf), axis=-1)
        lo = np.min(np.where(mask, values, np.inf), axis=-1)
        return (hi == lo) & np.any(mask, axis=-1)
    hi = torch.amax(torch.where(mask, values, -torch.inf), dim=-1)
    lo = torch.amin(torch.where(mask, values, torch.inf), dim=-1)
    return (hi == lo) & torch.any(mask, dim=-1)


def net_bytes_model(counts, cross, v_max, msg_bytes, gap_bytes=None,
                    uniform=None, xp=torch):
    """Analytic network bytes shared by every executor.

    counts: routing counts (any shape); cross: same-shape bool — True where
    the (p, q) batch crosses a node boundary.  Each nonempty crossing
    batch is priced at its adaptively chosen wire encoding
    (:func:`repro_torch.core.exchange.batch_wire_bytes`).  ``gap_bytes``
    (the delta-varint index-stream size of each batch's send mask)
    enables the compressed ``vpairs`` encoding; ``uniform``
    (:func:`batch_value_uniform`) additionally enables ``uval``.  Returns
    ``(net, net_raw)``: the priced bytes under the running choice and the
    legacy pairs/slab price of the same counts (equal with
    ``gap_bytes=None``)."""
    raw = xp.sum(xp.where(
        cross, batch_wire_bytes(counts, v_max, msg_bytes, xp=xp), 0.0))
    if gap_bytes is None:
        return raw, raw
    net = xp.sum(xp.where(
        cross, batch_wire_bytes(counts, v_max, msg_bytes,
                                gap_bytes=gap_bytes, uniform=uniform,
                                xp=xp), 0.0))
    return net, raw


def mq_wire_bytes(counts, union_count, v_max, msg_bytes, gap_bytes=None,
                  union_gap=None, uniform=None, xp=torch):
    """Adaptive wire price of one multi-query (p, q) message batch
    (DESIGN.md §11).

    ``counts`` [Q, ...] per-query routing counts; ``union_count`` [...] the
    routing counts of the OR of the per-query send masks; ``gap_bytes`` /
    ``uniform`` [Q, ...] the per-query delta-varint index-stream sizes and
    value-uniformity flags; ``union_gap`` [...] the index-stream size of
    the union mask.  Two arms, min-combined per batch: the **legacy sum**
    (each nonempty query column as its own solo batch) and, with
    compression, the **panel** (one union gap stream, then per
    participating query a presence bitmap over the union positions plus
    its value column, or one value when uniform).  So a Q-query batch
    never prices above its Q solo batches.  Host (numpy) callers price in
    float64, the torch path in float32, as the reference.  Zero where the
    union is empty."""
    legacy = batch_wire_bytes(counts, v_max, msg_bytes, gap_bytes=gap_bytes,
                              uniform=uniform, xp=xp)
    if xp is np:
        legacy_sum = np.sum(np.asarray(legacy, np.float64), axis=0)
        if gap_bytes is None:
            return legacy_sum
        c = np.asarray(counts, np.float64)
        pres = np.floor((np.asarray(union_count, np.float64) + 7.0) / 8.0)
        vb = np.where(uniform, float(msg_bytes), c * float(msg_bytes))
        percol = np.where(c > 0, pres[None] + vb, 0.0)
        panel = np.asarray(union_gap, np.float64) + np.sum(percol, axis=0)
        return np.where(union_count > 0, np.minimum(panel, legacy_sum), 0.0)
    legacy_sum = torch.sum(legacy.to(F32), dim=0)
    if gap_bytes is None:
        return legacy_sum
    c = counts.to(F32)
    pres = torch.floor((union_count.to(F32) + 7.0) / 8.0)
    vb = torch.where(uniform, float(msg_bytes), c * float(msg_bytes))
    percol = torch.where(c > 0, pres[None] + vb, 0.0)
    panel = union_gap.to(F32) + torch.sum(percol, dim=0)
    return torch.where(union_count > 0, torch.minimum(panel, legacy_sum),
                       0.0)


def mq_net_bytes_model(counts, union_count, cross, v_max, msg_bytes,
                       gap_bytes=None, union_gap=None, uniform=None,
                       xp=torch):
    """Analytic network bytes of a multi-query pass.

    ``counts``/``gap_bytes``/``uniform`` carry a leading query axis over
    the solo shapes; ``cross`` matches the union shape.  Returns
    ``(net, net_raw)``: each crossing batch priced by
    :func:`mq_wire_bytes`, and the sum of the per-query legacy pairs/slab
    prices — the compressed/raw twins of :func:`net_bytes_model`."""
    raw = xp.sum(xp.where(
        cross[None], batch_wire_bytes(counts, v_max, msg_bytes, xp=xp),
        0.0))
    if gap_bytes is None:
        return raw, raw
    net = xp.sum(xp.where(
        cross, mq_wire_bytes(counts, union_count, v_max, msg_bytes,
                             gap_bytes=gap_bytes, union_gap=union_gap,
                             uniform=uniform, xp=xp), 0.0))
    return net, raw


def net_payload_elems_model(p_cnt: int, v_max: int, capacity=None,
                            nq: int = 1) -> float:
    """Physical payload elements ONE rank ships to its peers in a mesh
    exchange (DESIGN.md §12) — tensor elements, not bytes: the collective
    moves typed arrays.  Summed over the mesh this is the wire volume the
    ``measured_net_payload_elems`` counter must equal.

    Dense slab (``capacity=None``): each of the p_cnt - 1 peers gets a
    v_max value column and a v_max presence column, per query.
    Compacted: each peer gets ``capacity`` values per query, one shared
    ``capacity`` source-index stream and, for panels (nq > 1),
    ``capacity`` presence flags per query (a solo compacted exchange needs
    none: ``recv_src_index == -1`` marks its padding)."""
    if capacity is None:
        return float((p_cnt - 1) * 2 * v_max * nq)
    per_slot = 2 if nq == 1 else 2 * nq + 1
    return float((p_cnt - 1) * capacity * per_slot)


# ---------------------------------------------------------------------------
# Phase 3: intra-node dispatch over the dispatching graph (paper §4.2)
# ---------------------------------------------------------------------------


def dispatch_one_dest(dsrc, dpart, dbatch, dvalid, recv_mask, v_max, b_cnt):
    """Phase 3 accounting via the dispatching graph (DCSR entries).

    dsrc/dpart/dbatch/dvalid [Q, S]; recv_mask [Q, P, V].
    Returns (chunk_active [Q, P, B] — chunk has >=1 present source — and
    the number of dispatched (message, batch) deliveries [Q])."""
    q_cnt, p_cnt = recv_mask.shape[:2]
    flat_mask = recv_mask.reshape(q_cnt, p_cnt * v_max)
    gidx = dpart.long() * v_max + dsrc.long()
    present = torch.gather(flat_mask, 1, gidx.clamp(0, p_cnt * v_max - 1)
                           ) & dvalid                               # [Q, S]
    cid = dpart.long() * b_cnt + dbatch.long()
    chunk_any = torch.zeros((q_cnt, p_cnt * b_cnt), dtype=torch.int32,
                            device=present.device)
    chunk_any.scatter_reduce_(1, cid, present.to(torch.int32), reduce="amax")
    chunk_active = chunk_any.reshape(q_cnt, p_cnt, b_cnt) > 0
    return chunk_active, torch.sum(present, dim=1, dtype=F32)


def format_choice_matrix(dcsr_ptr, has_csr, csr_bytes, dcsr_bytes,
                         dcsr_delta_bytes, csr_raw_bytes, dcsr_raw_bytes,
                         part_sizes, gamma, msgs_from, compression,
                         xp=torch):
    """Paper §4.1 per-chunk runtime format selection, extended to the
    three-way {CSR-pruned, DCSR-raw, DCSR-delta} choice of the compression
    tier (DESIGN.md §9).

    dcsr_ptr [..., P, B+1]; has_csr and all byte arrays [..., P, B];
    part_sizes [P]; msgs_from [..., P] — messages received from each
    source partition; ``compression`` selects the byte-model family.

    The CSR-vs-DCSR arm is the paper's seek-cost rule and is independent
    of compression; within the DCSR arm, compression picks the smaller of
    the raw-pair and delta-varint sections (ties to raw).  The cost
    arithmetic is pinned to float32 on both paths, as in the reference.

    Returns (use_csr, use_delta, seek, read_bytes, read_bytes_raw), each
    [..., P, B]."""
    nnz = _f32(dcsr_ptr[..., 1:] - dcsr_ptr[..., :-1], xp)
    v_src = _f32(part_sizes, xp)[:, None]                      # [P, 1]
    m = _f32(msgs_from, xp)[..., None]
    # a Python float scales a float32 array in float32 on both paths
    cost_dcsr = 2.0 * nnz
    cost_csr = xp.minimum(float(gamma) * m, v_src)
    use_csr = has_csr & (cost_csr < cost_dcsr)
    seek = xp.where(use_csr, cost_csr, cost_dcsr)
    per_raw = xp.where(use_csr, csr_raw_bytes, dcsr_raw_bytes)
    if compression:
        use_delta = (~use_csr) & (dcsr_delta_bytes < dcsr_bytes)
        per_chunk = xp.where(use_csr, csr_bytes,
                             xp.where(use_delta, dcsr_delta_bytes,
                                      dcsr_bytes))
    else:
        use_delta = xp.zeros_like(use_csr)
        per_chunk = per_raw
    return use_csr, use_delta, seek, per_chunk, per_raw


def format_choice_one_dest(dcsr_ptr, has_csr, csr_bytes, dcsr_bytes,
                           dcsr_delta_bytes, csr_raw_bytes, dcsr_raw_bytes,
                           part_sizes, gamma, msgs_from, compression,
                           chunk_active):
    """Reduce :func:`format_choice_matrix` over each destination's active
    chunks ([Q, P, B] -> [Q]).

    Returns the per-destination counter contributions: seek cost, the
    compressed/raw read-byte twins, and the per-format active-chunk
    counts."""
    return _reduce_choice(format_choice_matrix(
        dcsr_ptr, has_csr, csr_bytes, dcsr_bytes, dcsr_delta_bytes,
        csr_raw_bytes, dcsr_raw_bytes, part_sizes, gamma, msgs_from,
        compression), chunk_active)


def _reduce_choice(choice, chunk_active):
    """A format-choice matrix reduced over each destination's active
    chunks ([Q, P, B] -> [Q]), as counter contributions."""
    use_csr, use_delta, seek, per_chunk, per_raw = choice

    def red(x):
        return torch.sum(torch.where(chunk_active, x.to(F32), 0.0),
                         dim=(1, 2), dtype=F32)

    return {
        "seek_cost": red(seek),
        "edge_read_bytes": red(per_chunk),
        "edge_read_bytes_raw": red(per_raw),
        "chunks_read_csr": red(use_csr),
        "chunks_read_dcsr_delta": red(use_delta),
        "chunks_read_dcsr": red(~use_csr & ~use_delta),
    }


def mq_format_choice_matrix(dcsr_ptr, has_csr, csr_bytes, dcsr_bytes,
                            dcsr_delta_bytes, csr_raw_bytes, dcsr_raw_bytes,
                            part_sizes, gamma, msgs_from, compression,
                            xp=torch):
    """Per-chunk format selection for a multi-query (union-frontier) pass.

    Same arguments and results as :func:`format_choice_matrix`, but the
    choice is **pure min-bytes** over the stored representations instead
    of the solo seek-cost rule: the byte columns are static per chunk, so
    each chunk the union schedule reads costs at most what any solo run
    would have paid for it — which is what bounds a batched run's edge
    bytes by the sum of its solo runs'.  ``msgs_from`` (union counts) only
    feeds the modeled seek term of the chosen arm."""
    nnz = _f32(dcsr_ptr[..., 1:] - dcsr_ptr[..., :-1], xp)
    v_src = _f32(part_sizes, xp)[:, None]                      # [P, 1]
    m = _f32(msgs_from, xp)[..., None]
    cost_dcsr = 2.0 * nnz
    cost_csr = xp.minimum(float(gamma) * m, v_src)
    if compression:
        dcsr_best = xp.minimum(dcsr_bytes, dcsr_delta_bytes)
        use_csr = has_csr & (csr_bytes < dcsr_best)
        use_delta = (~use_csr) & (dcsr_delta_bytes < dcsr_bytes)
        per_chunk = xp.where(use_csr, csr_bytes,
                             xp.where(use_delta, dcsr_delta_bytes,
                                      dcsr_bytes))
    else:
        use_csr = has_csr & (csr_raw_bytes < dcsr_raw_bytes)
        use_delta = xp.zeros_like(use_csr)
        per_chunk = xp.where(use_csr, csr_raw_bytes, dcsr_raw_bytes)
    seek = xp.where(use_csr, cost_csr, cost_dcsr)
    per_raw = xp.where(use_csr, csr_raw_bytes, dcsr_raw_bytes)
    return use_csr, use_delta, seek, per_chunk, per_raw


def mq_format_choice_one_dest(dcsr_ptr, has_csr, csr_bytes, dcsr_bytes,
                              dcsr_delta_bytes, csr_raw_bytes,
                              dcsr_raw_bytes, part_sizes, gamma, msgs_from,
                              compression, chunk_active):
    """:func:`mq_format_choice_matrix` reduced over each destination's
    union-active chunks — the multi-query twin of
    :func:`format_choice_one_dest`, same counter keys."""
    return _reduce_choice(mq_format_choice_matrix(
        dcsr_ptr, has_csr, csr_bytes, dcsr_bytes, dcsr_delta_bytes,
        csr_raw_bytes, dcsr_raw_bytes, part_sizes, gamma, msgs_from,
        compression), chunk_active)


# ---------------------------------------------------------------------------
# Phase 4 (reference): flat segment combine over per-edge arrays
# ---------------------------------------------------------------------------


def process_segment_one_dest(esp, esl, edl, edata, evalid, recv_msg,
                             recv_mask, slot_fn, monoid, v_max):
    """Phase 4: slot along edges + monoid combine per destination vertex.

    esp/esl/edl/edata/evalid: per-edge arrays [Q, E].
    recv_msg/recv_mask: [Q, P, V] messages (and presence) from each source.
    Returns (agg [Q, V], has_msg [Q, V], edges_touched [Q])."""
    q_cnt, p_cnt = recv_msg.shape[:2]
    gidx = (esp.long() * v_max + esl.long()).clamp(0, p_cnt * v_max - 1)
    mv = torch.gather(recv_msg.reshape(q_cnt, -1), 1, gidx)          # [Q, E]
    em = torch.gather(recv_mask.reshape(q_cnt, -1), 1, gidx) & evalid
    contrib = slot_fn(mv, edata)
    contrib = torch.where(em, contrib, monoid.identity)
    dst = edl.long()
    agg = monoid.segment(contrib, dst, v_max)
    hits = torch.zeros((q_cnt, v_max), dtype=torch.int32, device=em.device)
    hits.scatter_add_(1, dst, em.to(torch.int32))
    return agg, hits > 0, torch.sum(em, dim=1, dtype=F32)


# ---------------------------------------------------------------------------
# Phase 4 (block-CSR): selective tile combine (DESIGN.md §4)
# ---------------------------------------------------------------------------


def compact_live_slots(bt, chunk_active, rb_map, n_rows):
    """The selective schedule: a tile is live iff its (src partition, dst
    batch) chunk is active.  Live tiles are compacted to the front of their
    row's slot range (slots are stored row-sorted, so an exclusive cumsum
    of the live mask gives each live tile's target position — no sort
    needed) so the kernel sweeps live tiles only.

    bt: dict of [Q, ...] tile-structure arrays; chunk_active [Q, P, B];
    rb_map [R, B] bool.  Returns (tile_idx [Q, S], tile_col [Q, S],
    row_cnt [Q, R]) int32, dead positions zeroed."""
    q_cnt, p_cnt = chunk_active.shape[:2]
    rb_active = torch.einsum("qpk,rk->qpr", chunk_active.to(F32),
                             rb_map.to(F32)) > 0                 # [Q, P, R]
    part_row = bt["slot_part"].long() * n_rows + bt["slot_row"].long()
    live = bt["slot_valid"] & torch.gather(
        rb_active.reshape(q_cnt, p_cnt * n_rows), 1, part_row)
    row = bt["slot_row"].long()
    livei = live.to(torch.int32)
    row_cnt = torch.zeros((q_cnt, n_rows), dtype=torch.int32,
                          device=live.device)
    row_cnt.scatter_add_(1, row, livei)
    cnt_cum = torch.cumsum(row_cnt, dim=1) - row_cnt   # exclusive, per row
    rank = torch.cumsum(livei, dim=1) - livei          # exclusive, per slot
    n_slots = live.shape[1]
    dest = torch.where(
        live, torch.gather(bt["row_ptr"], 1, row) + rank
        - torch.gather(cnt_cum, 1, row), n_slots).long()
    # dead slots all land in the extra column n_slots, which is cut off
    slots = torch.arange(n_slots, dtype=torch.int32, device=live.device)
    tile_idx = torch.zeros((q_cnt, n_slots + 1), dtype=torch.int32,
                           device=live.device)
    tile_col = torch.zeros_like(tile_idx)
    tile_idx.scatter_(1, dest, slots.expand(q_cnt, -1))
    tile_col.scatter_(1, dest, bt["slot_col"].to(torch.int32))
    return (tile_idx[:, :n_slots].contiguous(),
            tile_col[:, :n_slots].contiguous(), row_cnt)


def process_block_one_dest(bt, vals, recv_msg, recv_mask, chunk_active,
                           monoid, rb_map, *, tile, v_pad, n_rows):
    """Phase 4 through :func:`repro_torch.kernels.csr_spmv.block_csr_combine`
    — one launch for all Q destinations.

    bt: dict of the tile-structure arrays (slot_row/slot_col/slot_part/
        slot_valid [Q, S], row_ptr [Q, R+1], tiles_cnt [Q, S, T, T]).
    vals: dict with the slot-lowered value tiles for the running
        (slot_fn, monoid) — ``mode`` plus ``tiles_v``/``tiles_b``/``a``
        (see executor.probe_slot_affine + executor.build_value_tiles).
    chunk_active [Q, P, B]: phase-3 output; tiles belonging to chunks that
        received no message are compacted out of the kernel's row sweep.
    rb_map [R, B] bool (static): row block r overlaps destination batch k.

    Returns (agg [Q, V], has_msg [Q, V], edges_touched [Q])."""
    q_cnt, p_cnt, v_max = recv_msg.shape
    identity = float(monoid.identity)
    mode = vals["mode"]
    tile_idx, tile_col, row_cnt = compact_live_slots(
        bt, chunk_active, rb_map, n_rows)

    # Source vectors: per-partition spans padded to v_pad, then flattened so
    # column block c = p * (v_pad // T) + u // T never straddles partitions.
    pad = (0, v_pad - v_max)
    mask_p = torch.nn.functional.pad(recv_mask, pad)
    msg_p = torch.nn.functional.pad(recv_msg, pad)
    xc = mask_p.to(F32).reshape(q_cnt, -1)
    if mode in ("add", "add_b"):
        xv = torch.where(mask_p, msg_p, 0.0).reshape(q_cnt, -1)
    else:
        xv = torch.where(mask_p, vals["a"] * msg_p, identity).reshape(
            q_cnt, -1)

    val, hascnt = block_csr_combine(
        bt["row_ptr"], tile_idx, tile_col, row_cnt,
        vals.get("tiles_v"), vals.get("tiles_b"), bt["tiles_cnt"],
        xv, xc, mode=mode, tile=tile, identity=identity)
    agg = val[:, :v_max]
    has = hascnt[:, :v_max] > 0.5
    return agg, has, torch.sum(hascnt, dim=1, dtype=F32)


# ---------------------------------------------------------------------------
# Order-independent counter reduction for parallel workers (DESIGN.md §8)
# ---------------------------------------------------------------------------


def reduce_worker_counters(counters, per_worker):
    """Reduce per-worker counter contributions into ``counters``, in worker
    index order.

    The parallel dist_ooc executor runs its W workers concurrently; each
    accumulates every float it produces into a private dict (in an order
    fixed by its own schedule), and this reduction runs after all have
    joined, walking ``per_worker`` in worker index order — so the result
    is the same whether the workers ran one after another or raced on a
    thread pool.  ``counters`` is mutated and returned; missing keys start
    at 0.0."""
    for cw in per_worker:
        for k, v in cw.items():
            counters[k] = counters.get(k, 0.0) + float(v)
    return counters


# ---------------------------------------------------------------------------
# Vertex-batch I/O model (paper §4.4)
# ---------------------------------------------------------------------------


def batch_touched(mask, batch_size):
    """Number of vertices in batches containing >=1 set bit (I/O model:
    vertex data is loaded per batch, paper §4.4)."""
    pad = (-mask.shape[-1]) % batch_size
    m = torch.nn.functional.pad(mask, (0, pad))
    batch_any = m.reshape(*m.shape[:-1], -1, batch_size).any(dim=-1)
    return torch.sum(batch_any, dtype=F32) * batch_size


def bitmap_model_bytes(mask) -> float:
    """On-disk bytes of the row-packed active bitmap for a [..., V] mask.

    Static (shape-only); equals what the out-of-core vertex spill
    physically writes, keeping measured == modeled exact."""
    rows = int(np.prod(mask.shape[:-1])) if mask.ndim > 1 else 1
    return float(rows * ((mask.shape[-1] + 7) // 8))
