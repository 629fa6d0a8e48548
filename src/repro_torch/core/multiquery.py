"""Multi-query (Q-panel) ProcessEdges executors (DESIGN.md §11) — the
port of ``repro.core.multiquery``: LOCAL, SHARD_MAP (the mesh), OOC and
DIST_OOC.

Concurrent query serving amortizes ONE selective chunk stream across Q
simultaneous queries: vertex state grows a trailing query axis
([P, v_max, Q] panels), the scheduled active set is the bitwise OR of the
per-query frontiers, and per-query masks keep every monoid combine
independent — each query's column is bit-identical to the solo run that
query would have made, while the chunk reads, the decode and the disk
seeks are paid once for the whole batch.

Counter semantics, as the reference's:

* **logical counters** — ``msgs_generated`` / ``msgs_sent`` /
  ``edges_touched`` / the vertex byte terms — are the SUM over queries of
  the solo formulas; vertex spill traffic is physically per query (each
  query owns ``{key}@q{j}`` columns and an ``active_q{j}`` bitmap), so
  measured == Σ solo exactly.
* **shared-stream counters** — ``msgs_dispatched`` / ``chunks_read`` /
  ``seek_cost`` / ``edge_read_bytes`` / ``net_bytes`` — are priced ONCE
  over the union frontier (:func:`repro_torch.core.phases.mq_format_choice_matrix`,
  :func:`repro_torch.core.phases.mq_wire_bytes`), so the batched pass
  never costs more than the Q solo passes it replaces.

A query whose frontier has died is physically skipped on OOC and
DIST_OOC: none of its spill batches or bitmaps are read (zero cost); LOCAL
gates its shape-static bitmap term on an aliveness flag so the counters
agree.
"""
from __future__ import annotations

import functools
import threading
import time

import numpy as np
import torch

from repro_torch.core import codec, phases, sparse_collectives
from repro_torch.core import exchange as exchange_mod
from repro_torch.core.chunkstore import (
    REP_CSR, REP_DCSR, REP_DCSR_DELTA, ChunkPrefetcher, HBMChunkSource,
)
from repro_torch.core.executor import (
    F32, DestHeader, _apply_and_account, _batch_any, _block_dest_vectors,
    _combine_stream_batch, _device_state, _host_state, _stream_tile_layout,
    _stream_value_tiles, _sync, _zero_counters, arbitrate_wire,
    log_mesh_call, make_sharded_probe, record_worker_traffic,
    reduce_mesh_counters, run_worker_pool,
)
from repro_torch.core.formats import _np
from repro_torch.kernels.csr_spmv import block_csr_combine_mq
from repro_torch.utils import ceil_div, token_ctx


def mq_base_names(spill) -> list[str]:
    """Base state-array names of a multi-query spill (the ``{key}@q{j}``
    flattening inverted), in the insertion order of the loaded state."""
    suffix = "@q0"
    return [n[: -len(suffix)] for n in spill.names() if n.endswith(suffix)]


def mq_query_keys(base: list[str], j: int) -> list[str]:
    return [f"{k}@q{j}" for k in base]


# ---------------------------------------------------------------------------
# Shared host-side pieces (OOC)
# ---------------------------------------------------------------------------

def _dispatch_schedule_one_dest_mq(source, q, union_mask_q, part_sizes,
                                   gamma, compression):
    """Multi-query twin of ``executor._dispatch_schedule_one_dest``:
    dispatch presence over the UNION receive mask and the pure min-bytes
    format choice — the one decision that both prices the model and drives
    the physical chunk reads.  The byte sums run in float64, as the solo
    twin's: the reference's float32 sums round past 2**24 bytes per
    destination, and ``verify_io`` would then fail."""
    p_cnt, b_cnt = source.has_csr.shape[1], source.has_csr.shape[2]
    present = (union_mask_q[source.dcsr_part[q], source.dcsr_src[q]]
               & source.dcsr_valid[q])
    chunk_active = np.zeros((p_cnt, b_cnt), bool)
    chunk_active[source.dcsr_part[q][present],
                 source.dcsr_batch[q][present]] = True
    msgs_from = union_mask_q.sum(axis=1)
    uc, ud, seek, per_chunk, per_raw = phases.mq_format_choice_matrix(
        source.dcsr_ptr[q], source.has_csr[q],
        source.csr_bytes[q].astype(np.float32),
        source.dcsr_bytes[q].astype(np.float32),
        source.dcsr_delta_bytes[q].astype(np.float32),
        source.csr_raw_bytes[q].astype(np.float32),
        source.dcsr_raw_bytes[q].astype(np.float32),
        part_sizes, gamma, msgs_from, compression, xp=np)
    rep = np.where(uc, REP_CSR, np.where(ud, REP_DCSR_DELTA, REP_DCSR))
    cd = {
        "msgs_dispatched": float(present.sum()),
        "chunks_read": float(chunk_active.sum()),
        "seek_cost": float(seek[chunk_active].sum()),
        "edge_read_bytes": float(per_chunk[chunk_active].sum(
            dtype=np.float64)),
        "edge_read_bytes_raw": float(per_raw[chunk_active].sum(
            dtype=np.float64)),
        "chunks_read_csr": float((chunk_active & uc).sum()),
        "chunks_read_dcsr_delta": float((chunk_active & ud).sum()),
        "chunks_read_dcsr": float((chunk_active & ~uc & ~ud).sum()),
    }
    schedule = []
    for k in range(b_cnt):
        ps = np.nonzero(chunk_active[:, k])[0]
        if ps.size:
            schedule.append((q, k, [(int(p), int(rep[p, k])) for p in ps]))
    return cd, chunk_active, schedule


def _mq_panel_vectors(recv_mask, recv_msg, mode, a_const, identity,
                      v_pad_t):
    """Stack the per-query ``_block_dest_vectors`` into the [C*T, Q] value
    and presence panels one panel-kernel launch consumes (a dead query's
    all-False mask gives an identity / zero column), on the device.

    recv_mask [Q, P, V] bool and recv_msg [Q, P, V]: each query's receive
    view of one destination and its messages."""
    cols = [_block_dest_vectors(recv_mask[j], recv_msg[j], mode, a_const,
                                identity, v_pad_t)
            for j in range(recv_mask.shape[0])]
    return (torch.stack([xv for xv, _ in cols], dim=1),
            torch.stack([xc for _, xc in cols], dim=1))


def _ooc_combine_batch_mq(work, xv_panel, xc_panel, slot_fn, monoid, mode,
                          *, tile, pb, n_rows_b, bs):
    """Phase 4 for one streamed dst-batch through the panel combine: the
    ragged tile layout and the value tiles are built ONCE from the decoded
    chunk edges (they do not depend on the query) and one launch, with a
    leading destination axis of 1, combines them against all Q columns —
    "one decode feeds Q combines".  Returns (val, hascnt) [R*T, Q]."""
    row_ptr, tile_idx, tile_col, row_cnt, cells, n_slots = (
        _stream_tile_layout(work, tile=tile, pb=pb, n_rows_b=n_rows_b,
                            n_col_blocks=xc_panel.shape[0] // tile, bs=bs))
    tiles_cnt, tiles_v, tiles_b = _stream_value_tiles(
        work, cells, n_slots, slot_fn, monoid, mode, tile)
    one = lambda x: None if x is None else x[None]
    val, hc = block_csr_combine_mq(
        one(row_ptr), one(tile_idx), one(tile_col), one(row_cnt),
        one(tiles_v), one(tiles_b), one(tiles_cnt), one(xv_panel),
        one(xc_panel), mode=mode, tile=tile,
        identity=float(monoid.identity))
    return val[0], hc[0]


# ---------------------------------------------------------------------------
# LOCAL executor (one device, trailing query axis)
# ---------------------------------------------------------------------------

def make_local_pe_mq(engine, signal_fn, slot_fn, monoid, apply_fn, nq):
    """Multi-query LOCAL ProcessEdges (segment backend):
    ``step(state, active, g, fmts, global_id)`` ->
    (new_state panels, new_active [P, V, Q], totals [Q], counters).

    The query axis is unrolled and each column runs the solo ops (phases
    1, 2, 4 and apply), so columns are bit-identical to solo runs; the
    chunk model and the network price run once over the union frontier."""
    cfg = engine.config
    spec = engine.graph.spec
    p_cnt, v_max, b_cnt = (spec.num_partitions, spec.v_max,
                           spec.num_batches)
    dev = engine.device
    gamma = engine.fmts.gamma
    part_sizes = torch.as_tensor(spec.partition_sizes(), dtype=F32,
                                 device=dev)
    cross = (torch.arange(p_cnt, device=dev)[:, None]
             != torch.arange(p_cnt, device=dev)[None, :])
    counter_keys = engine.counter_keys
    mb = cfg.msg_bytes + 4

    def step(state, active, g, fmts, global_id):
        counters = _zero_counters(counter_keys, dev)
        # Phases 1 + 2 per query: the solo ops on the query's column.
        amasks, msgs, recv_masks = [], [], []
        for j in range(nq):
            state_j = {k: v[..., j] for k, v in state.items()}
            amask_j = (g.vertex_valid if active is None
                       else (active[..., j] & g.vertex_valid))
            msg_j = signal_fn(state_j, global_id)                # [P, V]
            m_p = torch.sum(amask_j, dim=1, dtype=F32)           # [P]
            n_active = torch.sum(m_p)
            counters["msgs_generated"] += n_active
            counters["msg_disk_bytes"] += n_active * mb
            recv_mask_j = phases.filter_sendmask(
                amask_j, g.need, g.need_counts, m_p, cfg
            ).transpose(0, 1).contiguous()                       # [Q, P, V]
            counters["msgs_sent"] += torch.sum(recv_mask_j, dtype=F32)
            counters["msgs_sent_nofilter"] += p_cnt * n_active
            counters["net_bytes_nofilter"] += (p_cnt - 1) * n_active * mb
            amasks.append(amask_j)
            msgs.append(msg_j)
            recv_masks.append(recv_mask_j)

        # Union frontier: one scheduled active set for the whole batch.
        union_mask = recv_masks[0]
        for j in range(1, nq):
            union_mask = union_mask | recv_masks[j]

        # Network model: per-batch min(panel, Σ legacy) over the union.
        counts = torch.stack([phases.routing_counts(rm)
                              for rm in recv_masks])            # [nq, Q, P]
        ucounts = phases.routing_counts(union_mask)             # [Q, P]
        gapb = unib = ugap = None
        if cfg.compression:
            gapb = torch.stack([codec.mask_gap_bytes(rm, xp=torch)
                                for rm in recv_masks])
            unib = torch.stack([phases.batch_value_uniform(
                rm, m[None, :, :]) for rm, m in zip(recv_masks, msgs)])
            ugap = codec.mask_gap_bytes(union_mask, xp=torch)
        counters["net_bytes"], counters["net_bytes_raw"] = (
            phases.mq_net_bytes_model(counts, ucounts, cross, v_max,
                                      cfg.msg_bytes, gap_bytes=gapb,
                                      union_gap=ugap, uniform=unib))

        # Phase 3 + the chunk model once, over the union frontier.
        d = HBMChunkSource.dest_arrays(fmts)
        chunk_active, dispatched = phases.dispatch_one_dest(
            d["dcsr_src"], d["dcsr_part"], d["dcsr_batch"], d["dcsr_valid"],
            union_mask, v_max, b_cnt)
        counters["msgs_dispatched"] += torch.sum(dispatched)
        counters["chunks_read"] += torch.sum(chunk_active, dtype=F32)
        cd = phases.mq_format_choice_one_dest(
            d["dcsr_ptr"], d["has_csr"], d["csr_bytes"], d["dcsr_bytes"],
            d["dcsr_delta_bytes"], d["csr_raw_bytes"], d["dcsr_raw_bytes"],
            part_sizes, gamma,
            torch.sum(union_mask, dim=2).to(torch.int32), cfg.compression,
            chunk_active)
        for k, v in cd.items():
            counters[k] += torch.sum(v)

        # Phase 4 + apply per query (the solo ops; presence masks keep
        # every foreign edge of the union out of a query's column).
        e = HBMChunkSource.edge_arrays(g)
        new_cols, new_act, totals = {k: [] for k in state}, [], []
        for j in range(nq):
            recv_msg_j = torch.where(recv_masks[j], msgs[j][None, :, :], 0.0)
            agg, has, touched = phases.process_segment_one_dest(
                e["edge_src_part"], e["edge_src_local"], e["edge_dst_local"],
                e["edge_data"], e["edge_valid"], recv_msg_j, recv_masks[j],
                slot_fn, monoid, v_max)
            counters["edges_touched"] += torch.sum(touched)
            state_j = {k: v[..., j] for k, v in state.items()}
            ns_j, na_j, total_j, io = _apply_and_account(
                state_j, agg, has, global_id, g.vertex_valid, apply_fn,
                cfg, spec.batch_size, amasks[j])
            # The bitmap term of the vertex model is shape-static: gate the
            # query's vertex I/O on it being alive, so a converged query
            # prices zero, as the physical skip on OOC does.
            alive_f = torch.any(amasks[j]).to(F32)
            for k, v in io.items():
                counters[k] += alive_f * v
            for k in state:
                new_cols[k].append(ns_j[k])
            new_act.append(na_j)
            totals.append(total_j)

        new_state = {k: torch.stack(cols, dim=-1)
                     for k, cols in new_cols.items()}
        return (new_state, torch.stack(new_act, dim=-1),
                torch.stack(totals), counters)

    return step


# ---------------------------------------------------------------------------
# SHARD_MAP executor (mesh axis, one panel all_to_all)
# ---------------------------------------------------------------------------

def _dense_panel(send_valsp, send_maskp, mesh):
    """The dense [P, V, Q] panel exchange: one value and one int8 presence
    all_to_all (each column a pure permutation, so bit-identical to its
    solo exchange).  Returns (recv_vals, recv_maskp, payload elements)."""
    sent0 = mesh.sent_elems
    sv = torch.where(send_maskp, send_valsp[None], 0.0)          # [P, V, nq]
    rv = mesh.all_to_all(sv)
    rm = mesh.all_to_all(send_maskp.to(torch.int8)) > 0
    return rv, rm, float(mesh.sent_elems - sent0)


def _compacted_panel(send_valsp, send_maskp, capacity, mesh):
    """The union-compacted panel (DESIGN.md §12): one shared source-index
    stream per peer, Q value columns and Q presence flags, re-densified to
    the dense panel's layout.  ``capacity`` bounds the ``pmax``'d union
    count, so no rank can overflow it (as in the solo exchange)."""
    sent0 = mesh.sent_elems
    bufv, bufm, idx, cmax = sparse_collectives.masked_compacted_send_mq(
        send_valsp, send_maskp, capacity)
    assert int(cmax) <= capacity, (int(cmax), capacity)
    rv, rm = mesh.all_to_all(bufv), mesh.all_to_all(bufm) > 0
    ridx = mesh.all_to_all(idx)
    rvf, rmf = sparse_collectives.compacted_scatter_back_mq(
        rv, rm, ridx, send_maskp.shape[1])
    return rvf, rmf, float(mesh.sent_elems - sent0)


def make_sharded_pe_mq(engine, signal_fn, slot_fn, monoid, apply_fn, nq):
    """Multi-query mesh ProcessEdges for this rank (segment backend):
    ``step(state, active, garrs)`` over [1, V, Q] rows.

    Phases 1-2 run per query on the rank's row; ONE panel exchange ships
    the [P, V, Q] slab, or the union-compacted panel when the host's
    arbitration (``choose_physical_exchange(..., nq=Q)``) picks it — each
    column bit-identical to the solo exchange; the network model prices
    each crossing batch at the multi-query minimum; phase 3 and the chunk
    model run once over the union of the received columns, phase 4 and
    apply per query.  Counters and totals are ``psum``'d."""
    cfg = engine.config
    spec = engine.graph.spec
    p_cnt, v_max, b_cnt = (spec.num_partitions, spec.v_max,
                           spec.num_batches)
    mesh, dev = engine.mesh, engine.device
    gamma = engine.fmts.gamma
    part_sizes = torch.as_tensor(spec.partition_sizes(), dtype=F32,
                                 device=dev)
    cross = torch.arange(p_cnt, device=dev) != mesh.rank
    counter_keys = engine.counter_keys
    probe = make_sharded_probe(engine)
    is0 = 1.0 if mesh.rank == 0 else 0.0
    mb = cfg.msg_bytes + 4
    dense_elems = phases.net_payload_elems_model(p_cnt, v_max, nq=nq)

    def step(state, active, garrs):
        t_start, wire0 = time.perf_counter(), mesh.wire_s
        counters = _zero_counters(counter_keys, dev)
        vertex_valid = garrs["vertex_valid"]                     # [1, V]

        amasks, msgs, sendmasks = [], [], []
        for j in range(nq):
            state_j = {k: v[..., j] for k, v in state.items()}
            amask_j = (vertex_valid if active is None
                       else (active[..., j] & vertex_valid))
            msg_j = signal_fn(state_j, garrs["global_id"])      # [1, V]
            m_p = torch.sum(amask_j, dtype=F32)
            counters["msgs_generated"] += m_p
            counters["msg_disk_bytes"] += m_p * mb
            sendmask_j = phases.filter_sendmask(
                amask_j[0], garrs["need"][0], garrs["need_counts"][0],
                m_p, cfg)                                        # [P, V]
            counters["msgs_sent"] += torch.sum(sendmask_j, dtype=F32)
            counters["msgs_sent_nofilter"] += p_cnt * m_p
            counters["net_bytes_nofilter"] += (p_cnt - 1) * m_p * mb
            amasks.append(amask_j)
            msgs.append(msg_j)
            sendmasks.append(sendmask_j)

        union_sm = sendmasks[0]
        for j in range(1, nq):
            union_sm = union_sm | sendmasks[j]                   # [P, V]
        counts = torch.stack([phases.routing_counts(sm)
                              for sm in sendmasks])              # [nq, P]
        ucounts = phases.routing_counts(union_sm)                # [P]
        gapb = unib = ugap = None
        if cfg.compression:
            gapb = torch.stack([codec.mask_gap_bytes(sm, xp=torch)
                                for sm in sendmasks])
            unib = torch.stack([phases.batch_value_uniform(
                sm, m[0][None, :]) for sm, m in zip(sendmasks, msgs)])
            ugap = codec.mask_gap_bytes(union_sm, xp=torch)
        counters["net_bytes"], counters["net_bytes_raw"] = (
            phases.mq_net_bytes_model(counts, ucounts, cross, v_max,
                                      cfg.msg_bytes, gap_bytes=gapb,
                                      union_gap=ugap, uniform=unib))

        # ONE panel exchange, dense or union-compacted, arbitrated as the
        # solo path's.
        send_valsp = torch.stack([m[0] for m in msgs], dim=-1)   # [V, nq]
        send_maskp = torch.stack(sendmasks, dim=-1)              # [P, V, nq]
        capacity = arbitrate_wire(engine, probe, sendmasks, nq=nq)
        counters["net_payload_elems_dense"] = dense_elems
        _sync(dev)
        t0, bytes0 = time.perf_counter(), mesh.sent_bytes
        if capacity is None:
            recv_vals, recv_maskp, measured = _dense_panel(
                send_valsp, send_maskp, mesh)
            counters["net_payload_elems"] = dense_elems
            counters["exchange_dense_iters"] = is0
        else:
            recv_vals, recv_maskp, measured = _compacted_panel(
                send_valsp, send_maskp, capacity, mesh)
            counters["net_payload_elems"] = phases.net_payload_elems_model(
                p_cnt, v_max, capacity=capacity, nq=nq)
            counters["exchange_compacted_iters"] = is0
        counters["measured_net_payload_elems"] = measured
        _sync(dev)
        exchange = (time.perf_counter() - t0, measured,
                    mesh.sent_bytes - bytes0)

        # Phase 3 + the chunk model over the union of the received columns.
        d = HBMChunkSource.dest_arrays(garrs)
        union_recv = torch.any(recv_maskp, dim=-1)[None]         # [1, P, V]
        chunk_active, dispatched = phases.dispatch_one_dest(
            d["dcsr_src"], d["dcsr_part"], d["dcsr_batch"], d["dcsr_valid"],
            union_recv, v_max, b_cnt)
        counters["msgs_dispatched"] += torch.sum(dispatched)
        counters["chunks_read"] += torch.sum(chunk_active, dtype=F32)
        cd = phases.mq_format_choice_one_dest(
            d["dcsr_ptr"], d["has_csr"], d["csr_bytes"], d["dcsr_bytes"],
            d["dcsr_delta_bytes"], d["csr_raw_bytes"], d["dcsr_raw_bytes"],
            part_sizes, gamma, torch.sum(union_recv, dim=2).to(torch.int32),
            cfg.compression, chunk_active)
        for k, v in cd.items():
            counters[k] += torch.sum(v)

        # Phase 4 + apply per query on this rank's destination row.
        e = HBMChunkSource.edge_arrays(garrs)
        new_cols, new_act, totals, ios = {k: [] for k in state}, [], [], []
        for j in range(nq):
            rmask_j = recv_maskp[..., j][None]
            rmsg_j = torch.where(rmask_j, recv_vals[..., j][None], 0.0)
            agg, has, touched = phases.process_segment_one_dest(
                e["edge_src_part"], e["edge_src_local"], e["edge_dst_local"],
                e["edge_data"], e["edge_valid"], rmsg_j, rmask_j, slot_fn,
                monoid, v_max)
            counters["edges_touched"] += torch.sum(touched)
            state_j = {k: v[..., j] for k, v in state.items()}
            ns_j, na_j, total_j, io = _apply_and_account(
                state_j, agg, has, garrs["global_id"], vertex_valid,
                apply_fn, cfg, spec.batch_size, amasks[j])
            ios.append(io)
            for k in state:
                new_cols[k].append(ns_j[k])
            new_act.append(na_j)
            totals.append(total_j)
        # A query's vertex I/O stays priced while its frontier is alive on
        # ANY rank, as a solo run's would: one pmax of the [nq] counts.
        alive = mesh.pmax(torch.stack([torch.sum(a, dtype=F32)
                                       for a in amasks]).cpu()) > 0
        for j, io in enumerate(ios):
            if bool(alive[j]):
                for k, v in io.items():
                    counters[k] += v

        new_state = {k: torch.stack(cols, dim=-1)
                     for k, cols in new_cols.items()}
        counters, totals = reduce_mesh_counters(
            mesh, counters, counter_keys, torch.stack(totals))
        log_mesh_call(engine, t_start, wire0, exchange, capacity)
        return new_state, torch.stack(new_act, dim=-1), totals, counters

    return step


# ---------------------------------------------------------------------------
# OOC executor (one spill with per-query columns, one union chunk stream)
# ---------------------------------------------------------------------------

def make_ooc_pe_mq(engine, signal_fn, slot_fn, monoid, apply_fn, backend,
                   mode_meta, nq):
    """Multi-query fully-out-of-core ProcessEdges: ``step(active)`` ->
    (new_state panels, new_active [P, V, Q], totals [Q], counters).

    Vertex traffic is physically per query (``{key}@q{j}`` columns,
    ``active_q{j}`` bitmaps — a dead query costs zero bytes); phases 1–2
    run per alive query on the host, phase 3 once over the union, and the
    edge stream runs ONCE over the union schedule.  Each streamed batch
    feeds every alive query's combine on the engine's device: the segment
    scatter per query, or one launch of the panel kernel for all of them.
    Host wall seconds per stage accumulate in ``engine.ooc_wall``, as in
    the solo executor."""
    cfg = engine.config
    g = engine._host_graph
    spec = g.spec
    source = engine.ooc_source
    spill = engine.spill
    dev = engine.device
    p_cnt, v_max = spec.num_partitions, spec.v_max
    b_cnt, bs = spec.num_batches, spec.batch_size
    need = _np(g.need)
    need_counts = _np(g.need_counts).astype(np.float64)
    vertex_valid = _np(g.vertex_valid)
    global_id = engine.global_id
    part_sizes = np.asarray(spec.partition_sizes(), np.float32)
    gamma = engine.fmts.gamma
    identity = float(monoid.identity)
    mb = cfg.msg_bytes + 4
    mode = blk = a_const = v_pad_t = None
    if backend == "block_csr":
        tile = cfg.block_tile
        v_pad_t = ceil_div(v_max, tile) * tile
        blk = dict(tile=tile, pb=v_pad_t // tile, n_rows_b=ceil_div(bs, tile),
                   bs=bs)
        mode, a_const = mode_meta

    def step(active):
        t_start = time.perf_counter()
        wall = engine.ooc_wall
        counters = {k: 0.0 for k in engine.counter_keys}
        sr0, sw0 = spill.bytes_read, spill.bytes_written
        base = mq_base_names(spill)
        bitmap = float(spill.bitmap_nbytes())
        amask = [(vertex_valid if active is None
                  else _np(active[..., j]).astype(bool) & vertex_valid)
                 for j in range(nq)]
        alive = [j for j in range(nq) if amask[j].any()]

        # Phase 1 per alive query: its bitmap + its active batches only.
        # A dead query's messages stay zero (its receive mask is empty).
        msgs = np.zeros((nq, p_cnt, v_max), np.float32)
        msgs_d = torch.zeros((nq, p_cnt, v_max), dtype=F32, device=dev)
        gen_v = {}
        for j in alive:
            keys_j = mq_query_keys(base, j)
            spill.read_bitmap(name=f"active_q{j}")              # measured
            gen_b = _batch_any(amask[j], bs, b_cnt)
            gread = spill.read(gen_b, keys=keys_j)              # measured
            gstate = {bk: gread[f"{bk}@q{j}"][:, :v_max] for bk in base}
            msgs_d[j] = signal_fn(_device_state(gstate, dev),
                                  global_id).to(F32)
            msgs[j] = msgs_d[j].cpu().numpy()
            gen_v[j] = float(gen_b.sum()) * bs
            n_active = float(amask[j].sum())
            counters["msgs_generated"] += n_active
            counters["msg_disk_bytes"] += n_active * mb
            counters["msgs_sent_nofilter"] += p_cnt * n_active
            counters["net_bytes_nofilter"] += (p_cnt - 1) * n_active * mb

        # Phase 2 per alive query, then the union frontier.
        recv = np.zeros((nq, p_cnt, p_cnt, v_max), bool)
        for j in alive:
            m_p = amask[j].sum(axis=1).astype(np.float64)
            for p in range(p_cnt):
                recv[j][:, p] = phases.filter_sendmask(
                    amask[j][p], need[p], need_counts[p], m_p[p], cfg,
                    xp=np)
            counters["msgs_sent"] += float(recv[j].sum())
        union = recv.any(axis=0)                         # [Q, P, v_max]

        counts = np.stack([phases.routing_counts(recv[j], xp=np)
                           for j in range(nq)])          # [nq, Q, P]
        gapb = unib = ugap = None
        if cfg.compression:
            gapb = np.zeros((nq, p_cnt, p_cnt), np.float64)
            unib = np.zeros((nq, p_cnt, p_cnt), bool)
            for j in alive:
                gapb[j] = codec.mask_gap_bytes(recv[j], xp=np)
                unib[j] = phases.batch_value_uniform(
                    recv[j], msgs[j][None, :, :], xp=np)
            ugap = codec.mask_gap_bytes(union, xp=np)
        ucounts = phases.routing_counts(union, xp=np)
        cross = np.arange(p_cnt)[:, None] != np.arange(p_cnt)[None, :]
        net, net_raw = phases.mq_net_bytes_model(
            counts, ucounts, cross, v_max, cfg.msg_bytes, gap_bytes=gapb,
            union_gap=ugap, uniform=unib, xp=np)
        counters["net_bytes"] = float(net)
        counters["net_bytes_raw"] = float(net_raw)

        # Phases 3 + 3.5 once, over the union frontier.
        schedule = []
        for q in range(p_cnt):
            cd, _, sched_q = _dispatch_schedule_one_dest_mq(
                source, q, union[q], part_sizes, gamma, cfg.compression)
            for ck, cv in cd.items():
                counters[ck] += cv
            schedule.extend(sched_q)
        wall["phases_s"] += time.perf_counter() - t_start

        # Phase 4: ONE chunk stream; each batch combines into every alive
        # query's column on the device.
        agg = torch.full((nq, p_cnt, v_max), identity, dtype=F32, device=dev)
        has = torch.zeros((nq, p_cnt, v_max), dtype=torch.bool, device=dev)
        touched = torch.zeros((), dtype=torch.float64, device=dev)
        alive_d = torch.as_tensor(alive, dtype=torch.long, device=dev)
        recv_cache, vec_cache = {}, {}

        def recv_q(q):
            if q not in recv_cache:
                recv_cache[q] = torch.from_numpy(
                    np.ascontiguousarray(recv[:, q])).to(dev)  # [nq, P, V]
                if backend == "block_csr":
                    vec_cache[q] = _mq_panel_vectors(
                        recv_cache[q], msgs_d, mode, a_const, identity,
                        v_pad_t)
            return recv_cache[q], vec_cache.get(q)

        t0 = time.perf_counter()
        for w in ChunkPrefetcher(source, schedule,
                                 depth=cfg.ooc_prefetch_depth,
                                 device_decode=engine.device_decode,
                                 device=dev):
            t1 = time.perf_counter()
            mask_q, panels = recv_q(w.q)
            if backend == "segment":
                for j in alive:
                    touched += _combine_stream_batch(
                        w, mask_q[j], msgs_d[j], slot_fn, monoid, agg[j],
                        has[j], backend="segment", mode=None, blk=None,
                        xv=None, xc=None, v_max=v_max)
            else:
                val, hc = _ooc_combine_batch_mq(
                    w, panels[0], panels[1], slot_fn, monoid, mode, **blk)
                lo = w.k * bs
                hi = min(lo + bs, v_max)
                agg[alive_d, w.q, lo:hi] = val[:hi - lo, alive_d].T
                has[alive_d, w.q, lo:hi] = (hc[:hi - lo, alive_d] > 0.5).T
                touched += torch.sum(hc[:, alive_d], dtype=torch.float64)
            counters["measured_chunks_read"] += w.n_chunks
            counters["measured_edge_read_bytes"] += w.nbytes
            counters["measured_chunks_device_decoded"] += w.n_device_chunks
            wall["read_s"] += w.read_s
            wall["decode_s"] += w.decode_s
            t0, wait = time.perf_counter(), t1 - t0
            wall["wait_s"] += wait
            wall["combine_s"] += t0 - t1
        counters["edges_touched"] = float(touched)

        # Apply per alive query into its own columns + bitmap.
        t_apply = time.perf_counter()
        has_np = has.cpu().numpy()
        new_active = np.zeros((p_cnt, v_max, nq), bool)
        totals = np.zeros(nq, np.float64)
        for j in alive:
            keys_j = mq_query_keys(base, j)
            ab_j = spill.arrays_bytes(keys_j)
            upd = has_np[j] & vertex_valid
            upd_b = _batch_any(upd, bs, b_cnt)
            astate_pad = spill.read(upd_b, keys=keys_j)         # measured
            state_j = {bk: astate_pad[f"{bk}@q{j}"][:, :v_max]
                       for bk in base}
            updates, na, ret = apply_fn(_device_state(state_j, dev), agg[j],
                                        has[j], global_id)
            spill.merge_write(
                astate_pad, {f"{bk}@q{j}": v
                             for bk, v in _host_state(updates).items()},
                upd, upd_b)                                     # measured
            na = _np(na).astype(bool) & vertex_valid
            spill.write_bitmap(na, name=f"active_q{j}")         # measured
            new_active[:, :, j] = na
            totals[j] = float(np.where(upd, _np(ret).astype(np.float32),
                                       0.0).sum())
            upd_v = float(upd_b.sum()) * bs
            counters["vertex_read_bytes"] += ((gen_v[j] + upd_v) * ab_j
                                              + bitmap)
            counters["vertex_write_bytes"] += upd_v * ab_j + bitmap
        counters["measured_vertex_read_bytes"] = spill.bytes_read - sr0
        counters["measured_vertex_write_bytes"] = (spill.bytes_written
                                                   - sw0)
        wall["apply_s"] += time.perf_counter() - t_apply
        return mq_state_views(spill, base, nq), new_active, totals, counters

    return step


def mq_state_views(spill, base, nq):
    """The [P, v_max, Q] state panels assembled from a spill's per-query
    columns (copies — the spill stays authoritative)."""
    views = spill.state_views()
    return {bk: np.stack([views[f"{bk}@q{j}"] for j in range(nq)], axis=-1)
            for bk in base}


# ---------------------------------------------------------------------------
# DIST_OOC executor (per-worker shards, shared-index wire panels)
# ---------------------------------------------------------------------------

def make_dist_ooc_pe_mq(engine, signal_fn, slot_fn, monoid, apply_fn,
                        backend, mode_meta, nq):
    """Multi-query distributed fully-out-of-core ProcessEdges:
    ``step(active)`` -> (new_state panels, new_active [P, V, Q], totals
    [Q], counters).

    The worker pipeline of the solo ``executor.make_dist_ooc_pe`` (send
    pool -> phase barrier -> one receive pipeline per worker, a
    :class:`~repro_torch.core.exchange.DecodeAhead` feeding one
    :class:`~repro_torch.core.chunkstore.ChunkPrefetcher`), with three
    differences: each worker generates per alive query from that query's
    spill columns and bitmap (a dead query costs zero); each nonempty
    (p, q) send is ONE multi-query batch
    (:meth:`~repro_torch.core.exchange.Exchange.post_mq`: a shared-index
    panel or Q solo-format batches, whichever is shorter); and each
    streamed chunk batch of a worker's union schedule combines into every
    alive query's column — one panel-kernel launch (block_csr) or the
    segment scatter per query.  Every float a worker makes stays private
    and is reduced in worker order after the join, and each worker writes
    only its own destination rows of ``agg`` / ``has`` / ``new_active``,
    so parallel workers are bit-identical to sequential ones."""
    cfg = engine.config
    g = engine._host_graph
    spec = g.spec
    dev = engine.device
    p_cnt, v_max = spec.num_partitions, spec.v_max
    b_cnt, bs = spec.num_batches, spec.batch_size
    n_workers = cfg.num_workers
    worker_parts = engine.worker_parts
    worker_of = engine.worker_of
    spills = engine.spills
    sources = engine.dist_sources
    need = _np(g.need)
    need_counts = _np(g.need_counts).astype(np.float64)
    vertex_valid = _np(g.vertex_valid)
    global_id = engine.global_id
    part_sizes = np.asarray(spec.partition_sizes(), np.float32)
    gamma = engine.fmts.gamma
    identity = float(monoid.identity)
    mb = cfg.msg_bytes + 4
    mode = blk = a_const = v_pad_t = None
    if backend == "block_csr":
        tile = cfg.block_tile
        v_pad_t = ceil_div(v_max, tile) * tile
        blk = dict(tile=tile, pb=v_pad_t // tile, n_rows_b=ceil_div(bs, tile),
                   bs=bs)
        mode, a_const = mode_meta
    parallel = cfg.parallel_workers
    wire_device = dev if engine.device_decode else None
    cross = worker_of[np.newaxis, :] != worker_of[:, np.newaxis]

    def step(active):
        base = mq_base_names(spills[0])
        counters = {k: 0.0 for k in engine.counter_keys}
        amask = [(vertex_valid if active is None
                  else _np(active[..., j]).astype(bool) & vertex_valid)
                 for j in range(nq)]
        alive = [j for j in range(nq) if amask[j].any()]
        spill_io0 = [(sp.bytes_read, sp.bytes_written) for sp in spills]
        store_io0 = [(src.store.chunks_read, src.store.bytes_read)
                     for src in sources]
        ex = exchange_mod.Exchange(n_workers, v_max,
                                   compression=cfg.compression)
        token = threading.Lock() if parallel else None
        tok = token_ctx(token)

        # Phases 1 + 2 per worker: generate per alive query from its own
        # columns and bitmap, filter per query, and post ONE multi-query
        # batch per nonempty (p, q) over the queries' send masks.
        def send_task(w):
            t0 = time.perf_counter()
            parts = worker_parts[w]
            lo, hi = parts[0], parts[-1] + 1
            spill = spills[w]
            bitmap_w = float(spill.bitmap_nbytes())
            msg_w = np.zeros((nq, len(parts), v_max), np.float32)
            vr_model_w = 0.0
            for j in alive:
                keys_j = mq_query_keys(base, j)
                ab_j = spill.arrays_bytes(keys_j)
                with tok:                   # compute token: generate burst
                    spill.read_bitmap(name=f"active_q{j}")      # measured
                    gen_b = _batch_any(amask[j][lo:hi], bs, b_cnt)
                    gread = spill.read(gen_b, keys=keys_j)      # measured
                    gstate = {bk: gread[f"{bk}@q{j}"][:, :v_max]
                              for bk in base}
                    msg = signal_fn(_device_state(gstate, dev),
                                    global_id[lo:hi])
                    msg_w[j] = msg.to(F32).cpu().numpy()
                vr_model_w += float(gen_b.sum()) * bs * ab_j + bitmap_w
            counts_w = np.zeros((nq, p_cnt, len(parts)), np.float64)
            gapb_w = np.zeros((nq, p_cnt, len(parts)), np.float64)
            unib_w = np.zeros((nq, p_cnt, len(parts)), bool)
            ugap_w = np.zeros((p_cnt, len(parts)), np.float64)
            ucounts_w = np.zeros((p_cnt, len(parts)), np.float64)
            post_s = 0.0
            for i, p in enumerate(parts):
                with tok:                   # compute token: filter + encode
                    sm = np.zeros((nq, p_cnt, v_max), bool)
                    for j in alive:
                        sm[j] = phases.filter_sendmask(
                            amask[j][p], need[p], need_counts[p],
                            float(amask[j][p].sum()), cfg, xp=np)
                        counts_w[j, :, i] = phases.routing_counts(sm[j],
                                                                  xp=np)
                        if cfg.compression:
                            gapb_w[j, :, i] = codec.mask_gap_bytes(sm[j],
                                                                   xp=np)
                            unib_w[j, :, i] = phases.batch_value_uniform(
                                sm[j], msg_w[j, i][None, :], xp=np)
                    union_sm = sm.any(axis=0)
                    ucounts_w[:, i] = union_sm.sum(axis=1)
                    if cfg.compression:
                        ugap_w[:, i] = codec.mask_gap_bytes(union_sm, xp=np)
                    t1 = time.perf_counter()
                    for q in range(p_cnt):
                        cj = [int(c) for c in counts_w[:, q, i]]
                        if any(cj):
                            ex.post_mq(w, int(worker_of[q]), p, q, sm[:, q],
                                       msg_w[:, i], cj)
                    post_s += time.perf_counter() - t1
            return (counts_w, gapb_w, unib_w, ugap_w, ucounts_w, vr_model_w,
                    time.perf_counter() - t0, post_s)

        send_out = run_worker_pool(
            [functools.partial(send_task, w) for w in range(n_workers)],
            parallel, pool=engine.worker_pool)
        counts = np.zeros((nq, p_cnt, p_cnt), np.float64)   # [j, q, p]
        gapb = np.zeros((nq, p_cnt, p_cnt), np.float64)
        unib = np.zeros((nq, p_cnt, p_cnt), bool)
        ugap = np.zeros((p_cnt, p_cnt), np.float64)
        ucounts = np.zeros((p_cnt, p_cnt), np.float64)
        for w, (counts_w, gapb_w, unib_w, ugap_w, ucounts_w, vr_model_w,
                dt, post_s) in enumerate(send_out):
            lo, hi = worker_parts[w][0], worker_parts[w][-1] + 1
            counts[:, :, lo:hi] = counts_w
            gapb[:, :, lo:hi] = gapb_w
            unib[:, :, lo:hi] = unib_w
            ugap[:, lo:hi] = ugap_w
            ucounts[:, lo:hi] = ucounts_w
            counters["vertex_read_bytes"] += vr_model_w
            engine.worker_times[w]["send_s"] += dt
            engine.worker_times[w]["post_s"] += post_s

        for j in alive:
            n_active = float(amask[j].sum())
            counters["msgs_generated"] += n_active
            counters["msg_disk_bytes"] += n_active * mb
            counters["msgs_sent_nofilter"] += p_cnt * n_active
            counters["net_bytes_nofilter"] += (p_cnt - 1) * n_active * mb
        counters["msgs_sent"] = float(counts.sum())
        net, net_raw = phases.mq_net_bytes_model(
            counts, ucounts, cross, v_max, cfg.msg_bytes,
            gap_bytes=gapb if cfg.compression else None,
            union_gap=ugap if cfg.compression else None,
            uniform=unib if cfg.compression else None, xp=np)
        counters["net_bytes"] = float(net)
        counters["net_bytes_raw"] = float(net_raw)
        counters["measured_net_bytes"] = ex.bytes_sent
        counters["net_pair_batches"] = float(ex.pair_batches)
        counters["net_slab_batches"] = float(ex.slab_batches)
        counters["net_vpair_batches"] = float(ex.vpair_batches)
        counters["net_uval_batches"] = float(ex.uval_batches)

        # Phases 3 + 4 + apply per worker over its own shard: one chunk
        # stream per worker over the union schedule.  Rows of agg / has /
        # new_active are partitioned by ownership.
        agg = torch.full((nq, p_cnt, v_max), identity, dtype=F32, device=dev)
        has = torch.zeros((nq, p_cnt, v_max), dtype=torch.bool, device=dev)
        new_active = np.zeros((p_cnt, v_max, nq), bool)
        alive_d = torch.as_tensor(alive, dtype=torch.long, device=dev)

        def recv_task(w):
            t0 = time.perf_counter()
            parts = worker_parts[w]
            lo, hi = parts[0], parts[-1] + 1
            spill = spills[w]
            source = sources[w]
            bitmap_w = float(spill.bitmap_nbytes())
            cw = {}                       # worker-private counter deltas
            wall = dict.fromkeys(("take_s", "read_s", "decode_s", "wait_s",
                                  "combine_s", "apply_s"), 0.0)
            decoders = []

            def lazy_schedule():
                ahead = exchange_mod.DecodeAhead(
                    ex, w, parts, p_cnt, compute_lock=token,
                    runner=engine.pipeline_pool, device=wire_device,
                    num_queries=nq)
                decoders.append(ahead)
                for q, pmask, pmsg in ahead:
                    with tok:               # compute token: dispatch burst
                        cd, _, sched_q = _dispatch_schedule_one_dest_mq(
                            source, q, pmask.any(axis=0), part_sizes, gamma,
                            cfg.compression)
                        header = DestHeader(q=q, recv_mask=pmask,
                                            recv_msg=pmsg, counter_delta=cd)
                    yield header
                    yield from sched_q

            touched = torch.zeros((), dtype=torch.float64, device=dev)
            dev_chunks = 0
            cur = mask_q = msg_q = panels = None
            t_wait = time.perf_counter()
            for item in ChunkPrefetcher(
                    source, lazy_schedule(), depth=cfg.ooc_prefetch_depth,
                    compute_lock=token, device_decode=engine.device_decode,
                    device=dev, runner=engine.pipeline_pool):
                t1 = time.perf_counter()
                wall["wait_s"] += t1 - t_wait
                if isinstance(item, DestHeader):
                    cur = item
                    mask_q = msg_q = panels = None
                    for ck, cv in item.counter_delta.items():
                        cw[ck] = cw.get(ck, 0.0) + cv
                    t_wait = time.perf_counter()
                    continue
                dev_chunks += item.n_device_chunks
                wall["read_s"] += item.read_s
                wall["decode_s"] += item.decode_s
                with tok:                   # compute token: combine burst
                    if mask_q is None:
                        mask_q = torch.from_numpy(cur.recv_mask).to(dev)
                        msg_q = torch.from_numpy(cur.recv_msg).to(dev)
                        if backend == "block_csr":
                            panels = _mq_panel_vectors(
                                mask_q, msg_q, mode, a_const, identity,
                                v_pad_t)
                    if backend == "segment":
                        for j in alive:
                            touched += _combine_stream_batch(
                                item, mask_q[j], msg_q[j], slot_fn, monoid,
                                agg[j], has[j], backend="segment", mode=None,
                                blk=None, xv=None, xc=None, v_max=v_max)
                    else:
                        val, hc = _ooc_combine_batch_mq(
                            item, panels[0], panels[1], slot_fn, monoid,
                            mode, **blk)
                        klo = item.k * bs
                        khi = min(klo + bs, v_max)
                        agg[alive_d, item.q, klo:khi] = \
                            val[:khi - klo, alive_d].T
                        has[alive_d, item.q, klo:khi] = \
                            (hc[:khi - klo, alive_d] > 0.5).T
                        touched += torch.sum(hc[:, alive_d],
                                             dtype=torch.float64)
                t_wait = time.perf_counter()
                wall["combine_s"] += t_wait - t1
            wall["take_s"] = sum(d.take_s for d in decoders)

            # Apply per alive query into this worker's spill columns.
            t_apply = time.perf_counter()
            totals_w = np.zeros(nq, np.float64)
            upd_model_r = upd_model_w = 0.0
            with tok:
                has_w = has[:, lo:hi].cpu().numpy()
            for j in alive:
                keys_j = mq_query_keys(base, j)
                ab_j = spill.arrays_bytes(keys_j)
                with tok:                   # compute token: apply burst
                    upd_wj = has_w[j] & vertex_valid[lo:hi]
                    upd_b = _batch_any(upd_wj, bs, b_cnt)
                    astate_pad = spill.read(upd_b, keys=keys_j)  # measured
                    state_j = {bk: astate_pad[f"{bk}@q{j}"][:, :v_max]
                               for bk in base}
                    updates, na_wj, ret = apply_fn(
                        _device_state(state_j, dev), agg[j, lo:hi],
                        has[j, lo:hi], global_id[lo:hi])
                    spill.merge_write(
                        astate_pad, {f"{bk}@q{j}": v for bk, v in
                                     _host_state(updates).items()},
                        upd_wj, upd_b)                          # measured
                    na_wj = _np(na_wj).astype(bool) & vertex_valid[lo:hi]
                    spill.write_bitmap(na_wj, name=f"active_q{j}")  # measured
                    new_active[lo:hi, :, j] = na_wj
                    totals_w[j] = float(np.where(
                        upd_wj, _np(ret).astype(np.float32), 0.0).sum())
                upd_v = float(upd_b.sum()) * bs
                upd_model_r += upd_v * ab_j
                upd_model_w += upd_v * ab_j + bitmap_w
            cw["vertex_read_bytes"] = upd_model_r
            cw["vertex_write_bytes"] = upd_model_w
            wall["apply_s"] = time.perf_counter() - t_apply

            record_worker_traffic(engine, w, cw, ex, store_io0[w],
                                  spill_io0[w], dev_chunks, float(touched))
            return cw, totals_w, time.perf_counter() - t0, wall

        recv_out = run_worker_pool(
            [functools.partial(recv_task, w) for w in range(n_workers)],
            parallel, pool=engine.worker_pool)
        phases.reduce_worker_counters(counters, [o[0] for o in recv_out])
        totals = np.zeros(nq, np.float64)
        for w, (_, totals_w, dt, wall) in enumerate(recv_out):
            totals += totals_w
            engine.worker_times[w]["recv_s"] += dt
            for k, v in wall.items():
                engine.worker_times[w][k] += v
        return (dist_mq_state_views(spills, base, nq), new_active, totals,
                counters)

    return step


def dist_mq_state_views(spills, base, nq):
    """The [P, v_max, Q] state panels assembled from the per-worker spills'
    per-query columns (contiguous partition blocks, in worker order;
    copies, each element written once — the spills stay authoritative)."""
    views = [sp.state_views() for sp in spills]
    out = {}
    for bk in base:
        first = views[0][f"{bk}@q0"]
        rows = [v[f"{bk}@q0"].shape[0] for v in views]
        panel = np.empty((sum(rows), first.shape[1], nq), first.dtype)
        lo = 0
        for v, n_rows in zip(views, rows):
            for j in range(nq):
                panel[lo:lo + n_rows, :, j] = v[f"{bk}@q{j}"]
            lo += n_rows
        out[bk] = panel
    return out
