"""Chunk-scheduled ProcessEdges executors and the block-CSR slot lowering
(DESIGN.md §1, §2, §6–§8, §12) — the port of ``repro.core.executor``.

* ``make_local_pe`` runs on one device with the partition axis as a
  leading tensor axis.  The inter-partition exchange is a re-axis (the
  send masks of every source partition, viewed receive-major as
  [Q, P, V]).
* ``make_sharded_pe`` runs on one rank of a mesh
  (:mod:`repro_torch.core.mesh`): the partition axis is the mesh axis,
  the exchange a real all-to-all (the dense slab or the compacted
  collective the host arbitrates each iteration), and counters are
  summed over the mesh.
* ``make_ooc_pe`` is fully out of core: edge chunks and vertex arrays live
  on disk (:class:`~repro_torch.core.chunkstore.ChunkStore` /
  :class:`~repro_torch.core.chunkstore.VertexSpill`); the executor walks
  dst-batches streaming only the chunks the selective schedule marks
  active, overlapping reads and decodes with the combine through a
  prefetch thread, and reports **measured** I/O counters next to the
  analytic ones.
* ``make_dist_ooc_pe`` is distributed and fully out of core: W workers,
  each with its own chunk-store shard and vertex spill, exchange
  need-list-filtered message batches over a measured wire
  (:mod:`repro_torch.core.exchange`), sequentially or on thread pools
  with bit-identical results.

All price "network" traffic analytically with the same model
(``phases.routing_counts`` -> ``phases.net_bytes_model``).

Phase 4 runs on one of two compute backends (``EngineConfig.compute_backend``):

* ``"segment"``   — flat per-edge gather + scatter reduction; the reference.
* ``"block_csr"`` — the block-CSR combine kernel over per-(source
  partition, destination batch) tiles, zero-skipping tiles whose chunk
  received no messages — one launch per ProcessEdges.

The block backend requires the slot function to be *affine in the message*
per edge — ``slot(m, d) = a(d) * m + b(d)`` — which every monoid-compatible
slot in the paper's four algorithms satisfies (DESIGN.md §2).  The slot is
probed numerically; non-affine slots fall back to the segment backend with
a warning.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait

import numpy as np
import torch

from repro_torch.core import codec, phases, sparse_collectives
from repro_torch.core import exchange as exchange_mod
from repro_torch.core.chunkstore import (
    REP_CSR, REP_DCSR, REP_DCSR_DELTA, ChunkPrefetcher, HBMChunkSource,
    ScheduleMark,
)
from repro_torch.core.formats import BlockTilesHost, _np
from repro_torch.core.partition import row_block_batch_map
from repro_torch.kernels.csr_spmv import block_csr_combine, build_tile_struct
from repro_torch.utils import ceil_div, token_ctx

F32 = torch.float32


# ---------------------------------------------------------------------------
# Slot lowering for the block-CSR backend (DESIGN.md §2)
# ---------------------------------------------------------------------------

def fn_code_key(fn):
    """Hashable behavioral identity for a user callback, or None.

    Algorithm loops create fresh lambdas every iteration; the code object
    (plus consts, defaults, and closure values) identifies the behavior
    across iterations so probes and executors are cached per algorithm,
    not re-built per call."""
    try:
        code = fn.__code__
        key = (code.co_code, code.co_consts, fn.__defaults__,
               tuple(c.cell_contents for c in (fn.__closure__ or ())))
        hash(key)
        return key
    except (AttributeError, TypeError, ValueError):
        return None


def slot_probe_key(slot_fn, monoid):
    """Cache key for the affine-slot probe (see :func:`fn_code_key`)."""
    key = fn_code_key(slot_fn)
    return None if key is None else (monoid.name,) + key


def probe_slot_affine(slot_fn, monoid, edge_data, edge_valid):
    """Numerically probe ``slot(m, d) = a(d) * m + b(d)``.

    edge_data/edge_valid: [P, E] tensors (padding masked by edge_valid),
    on any device — the slot runs where they live, its results come back
    as host arrays.  Returns (cache_key, mode, a_const, a [P, E],
    b [P, E]) or None when the slot is not affine in the message (or, for
    extremum monoids, when the slope varies across edges so per-cell
    minima cannot be precombined)."""
    d = edge_data

    def at(t):
        return slot_fn(torch.full_like(d, t), d).to(F32).cpu().numpy()

    b = at(0.0)
    a = at(1.0) - b
    m = edge_valid.cpu().numpy()
    # Check the fitted line at non-integer points too: slots built from
    # round/floor/mod are linear at integer probes but not in between.
    for t in (2.0, 0.37282, 2.414214):
        if not np.allclose(at(t)[m], (np.float32(t) * a + b)[m],
                           rtol=1e-4, atol=1e-5):
            return None
    a_const = 1.0
    if monoid.name in ("min", "max"):
        av = a[m]
        if av.size:
            a_const = float(av.flat[0])
            if not np.allclose(av, a_const, rtol=1e-5, atol=1e-7):
                return None
        mode = monoid.name
    elif monoid.name == "add":
        mode = "add_b" if np.any(np.abs(b[m]) > 0) else "add"
    else:
        return None
    key = hashlib.sha1(
        monoid.name.encode() + a.tobytes() + b.tobytes()).hexdigest()
    return key, mode, a_const, a, b


def build_value_tiles(host: BlockTilesHost, monoid, mode: str,
                      a: np.ndarray, b: np.ndarray) -> dict:
    """Scatter the probed per-edge (a, b) into value tiles (numpy, as the
    reference, so parallel edges accumulate in the same order).

    add / add_b : tiles_v[cell] = sum a_e (+ tiles_b[cell] = sum b_e) —
                  parallel edges accumulate, so the tile product reproduces
                  the per-edge segment sum.
    min / max   : tiles_b[cell] = extremum of b_e over the cell's edges
                  (valid because the slope is constant), identity elsewhere.
    """
    p_cnt, _ = host.edge_slot.shape
    s_max, t = host.s_max, host.tile
    m = host.edge_valid
    qi = np.broadcast_to(np.arange(p_cnt)[:, None], host.edge_slot.shape)[m]
    cell = (qi, host.edge_slot[m], host.edge_roff[m], host.edge_coff[m])
    out = {}
    if mode in ("add", "add_b"):
        tv = np.zeros((p_cnt, s_max, t, t), np.float32)
        np.add.at(tv, cell, a[m])
        out["tiles_v"] = tv
        if mode == "add_b":
            tb = np.zeros((p_cnt, s_max, t, t), np.float32)
            np.add.at(tb, cell, b[m])
            out["tiles_b"] = tb
    else:
        tb = np.full((p_cnt, s_max, t, t), monoid.identity, np.float32)
        scatter = np.minimum if mode == "min" else np.maximum
        scatter.at(tb, cell, b[m])
        out["tiles_b"] = tb
    return out


# ---------------------------------------------------------------------------
# Shared destination-side pipeline (phases 3 + 4 on every destination)
# ---------------------------------------------------------------------------

def _dest_phases(d, recv_msg, recv_mask, *, slot_fn, monoid, spec, cfg,
                 backend, part_sizes, gamma, mode_meta, rb_map, bt_static):
    """Dispatch + process for every destination partition at once.

    d: dict of [Q, ...] destination arrays (DCSR dispatch/format arrays,
    plus per-edge arrays for the segment backend or tile arrays for
    block_csr).  Returns (agg [Q, V], has [Q, V], counter contributions
    dict of [Q] tensors)."""
    v_max, b_cnt = spec.v_max, spec.num_batches
    chunk_active, dispatched = phases.dispatch_one_dest(
        d["dcsr_src"], d["dcsr_part"], d["dcsr_batch"], d["dcsr_valid"],
        recv_mask, v_max, b_cnt)
    c = {"msgs_dispatched": dispatched,
         "chunks_read": torch.sum(chunk_active, dim=(1, 2), dtype=F32)}
    if cfg.enable_adaptive_formats:
        msgs_from = torch.sum(recv_mask, dim=2).to(torch.int32)
        c.update(phases.format_choice_one_dest(
            d["dcsr_ptr"], d["has_csr"], d["csr_bytes"], d["dcsr_bytes"],
            d["dcsr_delta_bytes"], d["csr_raw_bytes"], d["dcsr_raw_bytes"],
            part_sizes, gamma, msgs_from, cfg.compression, chunk_active))
    else:
        # Non-adaptive baseline: CSR for every chunk (the behavior the
        # paper improves on; model-only).  The CSR family still follows
        # cfg.compression so the disk and wire counters of one run price
        # one layout; the raw twin keeps the fully-legacy number.
        base = d["csr_bytes"] if cfg.compression else d["csr_raw_bytes"]
        red = lambda x: torch.sum(torch.where(chunk_active, x, 0.0),
                                  dim=(1, 2), dtype=F32)
        zero = torch.zeros_like(c["chunks_read"])
        c["seek_cost"] = zero
        c["edge_read_bytes"] = red(base)
        c["edge_read_bytes_raw"] = red(d["csr_raw_bytes"])
        c["chunks_read_csr"] = c["chunks_read"]
        c["chunks_read_dcsr"] = zero
        c["chunks_read_dcsr_delta"] = zero

    if backend == "segment":
        agg, has, touched = phases.process_segment_one_dest(
            d["edge_src_part"], d["edge_src_local"], d["edge_dst_local"],
            d["edge_data"], d["edge_valid"], recv_msg, recv_mask,
            slot_fn, monoid, v_max)
    else:
        bt = {k: d[k] for k in ("slot_row", "slot_col", "slot_part",
                                "slot_valid", "row_ptr", "tiles_cnt")}
        vals = {"mode": mode_meta[0], "a": mode_meta[1],
                "tiles_v": d.get("tiles_v"), "tiles_b": d.get("tiles_b")}
        agg, has, touched = phases.process_block_one_dest(
            bt, vals, recv_msg, recv_mask, chunk_active, monoid, rb_map,
            tile=bt_static.tile, v_pad=bt_static.v_pad,
            n_rows=bt_static.n_rows)
    c["edges_touched"] = touched
    return agg, has, c


def _apply_and_account(state, agg, has, global_id, vertex_valid, apply_fn,
                       cfg, batch_size, amask):
    """Shared apply: masked state update + vertex-batch I/O accounting.

    The vertex I/O model (paper §4.4): the generating phase reads the
    active bitmap plus the vertex arrays of batches containing active
    vertices; apply reads and writes the arrays of updated batches and
    writes the new-active bitmap."""
    updates, new_active, ret = apply_fn(state, agg, has, global_id)
    new_state = dict(state)
    upd_mask = has & vertex_valid
    for k, v in updates.items():
        new_state[k] = torch.where(upd_mask, v, state[k])
    new_active = new_active & vertex_valid
    total = torch.sum(torch.where(upd_mask, ret, 0).to(F32))
    io = {}
    if cfg.account_io:
        arrays_bytes = sum(v.element_size() for v in state.values())
        bitmap = phases.bitmap_model_bytes(amask)
        touched_v = phases.batch_touched(upd_mask, batch_size)
        gen_v = phases.batch_touched(amask, batch_size)
        io["vertex_read_bytes"] = ((gen_v + touched_v) * arrays_bytes
                                   + bitmap)
        io["vertex_write_bytes"] = touched_v * arrays_bytes + bitmap
    return new_state, new_active, total, io


def _zero_counters(keys, device):
    return {k: torch.zeros((), dtype=F32, device=device) for k in keys}


# ---------------------------------------------------------------------------
# LOCAL executor (single device, stacked partition axis)
# ---------------------------------------------------------------------------

def make_local_pe(engine, signal_fn, slot_fn, monoid, apply_fn, backend,
                  mode_meta):
    """Build one algorithm's ProcessEdges step:
    ``step(state, active, g, fmts, global_id, bt, vals)`` ->
    (new_state, new_active, total, counters)."""
    cfg = engine.config
    spec = engine.graph.spec
    p_cnt = spec.num_partitions
    dev = engine.device
    gamma = engine.fmts.gamma
    part_sizes = torch.as_tensor(spec.partition_sizes(), dtype=F32,
                                 device=dev)
    bt_static = engine._block if backend == "block_csr" else None
    rb_map = (torch.as_tensor(row_block_batch_map(spec, bt_static.tile),
                              device=dev)
              if backend == "block_csr" else None)
    cross = (torch.arange(p_cnt, device=dev)[:, None]
             != torch.arange(p_cnt, device=dev)[None, :])
    counter_keys = engine.counter_keys

    def step(state, active, g, fmts, global_id, bt, vals):
        counters = _zero_counters(counter_keys, dev)
        amask = g.vertex_valid if active is None else (active & g.vertex_valid)
        # Phase 1: generate
        msg = signal_fn(state, global_id)                        # [P, V]
        m_p = torch.sum(amask, dim=1, dtype=F32)                 # [P]
        counters["msgs_generated"] = torch.sum(m_p)
        counters["msg_disk_bytes"] = torch.sum(m_p) * (cfg.msg_bytes + 4)

        # Phase 2: filter + pass.  Every source partition's send mask
        # toward every destination, viewed receive-major [Q, P, V].
        recv_mask = phases.filter_sendmask(
            amask, g.need, g.need_counts, m_p, cfg
        ).transpose(0, 1).contiguous()
        recv_msg = torch.where(recv_mask, msg[None, :, :], 0.0)
        total_sent = torch.sum(recv_mask, dtype=F32)
        n_active = torch.sum(amask, dtype=F32)
        counters["msgs_sent"] = total_sent
        counters["msgs_sent_nofilter"] = p_cnt * n_active
        # Network model from the routing structure: each nonempty off-node
        # (p, q) message batch is priced at its adaptive wire encoding.
        counts = phases.routing_counts(recv_mask)                # [Q, P]
        gapb = unib = None
        if cfg.compression:
            gapb = codec.mask_gap_bytes(recv_mask, xp=torch)
            unib = phases.batch_value_uniform(recv_mask, msg[None, :, :])
        counters["net_bytes"], counters["net_bytes_raw"] = (
            phases.net_bytes_model(counts, cross, spec.v_max,
                                   cfg.msg_bytes, gap_bytes=gapb,
                                   uniform=unib))
        counters["net_bytes_nofilter"] = ((p_cnt - 1) * n_active
                                          * (cfg.msg_bytes + 4))

        # Phases 3 + 4 for every destination partition (in-HBM ChunkSource)
        d = HBMChunkSource.dest_arrays(fmts)
        if backend == "segment":
            d.update(HBMChunkSource.edge_arrays(g))
        else:
            d.update(slot_row=bt.slot_row, slot_col=bt.slot_col,
                     slot_part=bt.slot_part, slot_valid=bt.slot_valid,
                     row_ptr=bt.row_ptr, tiles_cnt=bt.tiles_cnt, **vals)
        agg, has, cd = _dest_phases(
            d, recv_msg, recv_mask, slot_fn=slot_fn, monoid=monoid,
            spec=spec, cfg=cfg, backend=backend, part_sizes=part_sizes,
            gamma=gamma, mode_meta=mode_meta, rb_map=rb_map,
            bt_static=bt_static)
        counters.update({k: torch.sum(v) for k, v in cd.items()})

        new_state, new_active, total, io = _apply_and_account(
            state, agg, has, global_id, g.vertex_valid, apply_fn, cfg,
            spec.batch_size, amask)
        counters.update(io)
        return new_state, new_active, total, counters

    return step


# ---------------------------------------------------------------------------
# SHARD_MAP executor (partition axis = mesh axis, all_to_all exchange)
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dense_exchange(msg_row, sendmask, mesh):
    """The legacy physical wire: one dense [P, V] slab per peer (values +
    int8 presence).  Returns (recv_msg [P, V], recv_mask [P, V], the
    payload elements this rank handed its P - 1 peers)."""
    sent0 = mesh.sent_elems
    recv_msg, recv_mask = sparse_collectives.filtered_all_to_all(
        msg_row, sendmask, mesh)
    return recv_msg, recv_mask, float(mesh.sent_elems - sent0)


def _compacted_exchange(msg_row, sendmask, capacity, mesh):
    """The compacted physical wire (DESIGN.md §12): <= ``capacity``
    (value, source-index) pairs per peer, re-densified on the receive side
    so phases 3-4 see the exact dense-slab layout.  The host bucketed
    ``capacity`` from the ``pmax``'d exact bound of these send masks, so
    no rank can overflow it and the collective's ``pmax``'d overflow flag
    is not paid for."""
    sent0 = mesh.sent_elems
    buf, idx, cmax = sparse_collectives.masked_compacted_send(
        msg_row, sendmask, capacity)
    assert int(cmax) <= capacity, (int(cmax), capacity)
    recv, recv_idx = mesh.all_to_all(buf), mesh.all_to_all(idx)
    recv_msg, recv_mask = sparse_collectives.compacted_scatter_back(
        recv, recv_idx, sendmask.shape[1])
    return recv_msg, recv_mask, float(mesh.sent_elems - sent0)


def make_sharded_probe(engine):
    """Capacity probe of the physical sparse exchange: ``probe(sendmasks)``
    returns the ``pmax``'d largest per-(source, destination) live count of
    this iteration's send decision — of the UNION of the given [P, V]
    send masks for multi-query, the panel's capacity bound.

    The reference runs it as a separate pass that re-runs the phase-2
    filter, because its compacted collective's capacity is a static shape
    that must be known before the step traces; here the step hands it the
    send masks it just computed, so the bound is exact by construction and
    costs one ``pmax``.  The host buckets it to a power-of-two capacity
    (:func:`~repro_torch.core.sparse_collectives.capacity_bucket`), never
    below the bound, so the reference's in-step fallback to the dense slab
    on overflow has nothing to catch here."""
    mesh = engine.mesh

    def probe(sendmasks):
        union = sendmasks[0]
        for sm in sendmasks[1:]:
            union = union | sm
        cmax = torch.max(torch.sum(union, dim=-1, dtype=torch.int32))
        return int(mesh.pmax(cmax.reshape(1).cpu()).item())
    return probe


def arbitrate_wire(engine, probe, sendmasks, nq=1):
    """The host's per-iteration wire choice (DESIGN.md §12): the bucketed
    capacity when the compacted collective wins, None for the dense slab.
    Identical on every rank, since the probe's bound is ``pmax``'d."""
    if not engine.physical_sparse_exchange:
        return None
    cap = sparse_collectives.capacity_bucket(probe(sendmasks))
    spec, cfg = engine.graph.spec, engine.config
    if exchange_mod.choose_physical_exchange(cap, spec.v_max, cfg.msg_bytes,
                                             nq=nq):
        return cap
    return None


def reduce_mesh_counters(mesh, counters, keys, totals):
    """``psum`` every counter (float32, as the reference's) and the
    total(s) in one all-reduce; every rank gets the same values.  Returns
    (counters as 0-d host tensors, the reduced totals [n] on the host)."""
    dev = totals.device
    vec = torch.cat([torch.stack([
        torch.as_tensor(counters[k], dtype=F32, device=dev).reshape(())
        for k in keys]), totals.reshape(-1).to(F32)]).cpu()
    red = mesh.psum(vec)
    return dict(zip(keys, red[:len(keys)].unbind())), red[len(keys):]


def log_mesh_call(engine, t_start, wire0, exchange, capacity):
    """One record of ``engine.mesh_log`` per mesh ProcessEdges: the
    exchange's wall seconds (staging copies included), the payload
    elements and bytes this rank shipped and whether they went compacted,
    and the step's seconds split into collectives (``wire_s``: the probe,
    the exchange, the counter reduction) and compute."""
    _sync(engine.device)
    step_s = time.perf_counter() - t_start
    wire_s = engine.mesh.wire_s - wire0
    exchange_s, elems, nbytes = exchange
    engine.mesh_log.append(dict(
        step_s=step_s, exchange_s=exchange_s, wire_s=wire_s,
        compute_s=step_s - wire_s, compacted=capacity is not None,
        capacity=capacity, payload_elems=elems, payload_bytes=nbytes))


def make_sharded_pe(engine, signal_fn, slot_fn, monoid, apply_fn, backend,
                    mode_meta):
    """Build one algorithm's mesh ProcessEdges step for this rank:
    ``step(state, active, garrs, bt, vals)`` -> (new_state, new_active,
    total, counters), over this rank's rows ([1, V] state and ``garrs``,
    [1, ...] tiles).

    Phase 1 and the filter run on the rank's row; the network is priced
    with ``phases.net_bytes_model`` with every other rank as a crossing;
    the exchange is the dense slab or the compacted collective the host
    arbitrated this iteration (:func:`arbitrate_wire`); phases 3-4 are
    LOCAL's :func:`_dest_phases` on the rank's one destination row (one
    ``block_csr_combine`` launch under ``block_csr``).  Every counter and
    the total are ``psum``'d, so every rank returns the same values;
    ``measured_net_payload_elems`` counts the elements of the tensors
    handed to ``all_to_all``, ``net_payload_elems`` is the model."""
    cfg = engine.config
    spec = engine.graph.spec
    p_cnt, v_max = spec.num_partitions, spec.v_max
    mesh, dev = engine.mesh, engine.device
    gamma = engine.fmts.gamma
    part_sizes = torch.as_tensor(spec.partition_sizes(), dtype=F32,
                                 device=dev)
    bt_static = engine._block if backend == "block_csr" else None
    rb_map = (torch.as_tensor(row_block_batch_map(spec, bt_static.tile),
                              device=dev)
              if backend == "block_csr" else None)
    cross = torch.arange(p_cnt, device=dev) != mesh.rank
    counter_keys = engine.counter_keys
    probe = make_sharded_probe(engine)
    is0 = 1.0 if mesh.rank == 0 else 0.0
    dense_elems = phases.net_payload_elems_model(p_cnt, v_max)

    def step(state, active, garrs, bt, vals):
        t_start, wire0 = time.perf_counter(), mesh.wire_s
        counters = _zero_counters(counter_keys, dev)
        vertex_valid = garrs["vertex_valid"]                     # [1, V]
        amask = vertex_valid if active is None else (active & vertex_valid)
        # Phase 1: generate
        msg = signal_fn(state, garrs["global_id"])               # [1, V]
        m_p = torch.sum(amask, dtype=F32)
        counters["msgs_generated"] = m_p
        counters["msg_disk_bytes"] = m_p * (cfg.msg_bytes + 4)

        # Phase 2: filter + the real exchange.  The network model is
        # LOCAL's on this rank's row: per-destination batch counts priced
        # at the adaptive wire encoding, this rank's own batch excluded.
        sendmask = phases.filter_sendmask(
            amask[0], garrs["need"][0], garrs["need_counts"][0], m_p, cfg)
        counters["msgs_sent"] = torch.sum(sendmask, dtype=F32)
        counters["msgs_sent_nofilter"] = p_cnt * m_p
        counts = phases.routing_counts(sendmask)                 # [P]
        gapb = unib = None
        if cfg.compression:
            gapb = codec.mask_gap_bytes(sendmask, xp=torch)
            unib = phases.batch_value_uniform(sendmask, msg[0][None, :])
        counters["net_bytes"], counters["net_bytes_raw"] = (
            phases.net_bytes_model(counts, cross, v_max, cfg.msg_bytes,
                                   gap_bytes=gapb, uniform=unib))
        counters["net_bytes_nofilter"] = ((p_cnt - 1) * m_p
                                          * (cfg.msg_bytes + 4))
        # Physical wire: the dense slab, or the compacted collective at the
        # capacity the host arbitrated (the same on every rank, so every
        # rank takes the same branch and the collectives stay in lockstep).
        # Either way phases 3-4 see the exact dense layout.
        capacity = arbitrate_wire(engine, probe, [sendmask])
        counters["net_payload_elems_dense"] = dense_elems
        _sync(dev)
        t0, bytes0 = time.perf_counter(), mesh.sent_bytes
        if capacity is None:
            recv_msg, recv_mask, measured = _dense_exchange(
                msg[0], sendmask, mesh)
            counters["net_payload_elems"] = dense_elems
            counters["exchange_dense_iters"] = is0
        else:
            recv_msg, recv_mask, measured = _compacted_exchange(
                msg[0], sendmask, capacity, mesh)
            counters["net_payload_elems"] = phases.net_payload_elems_model(
                p_cnt, v_max, capacity=capacity)
            counters["exchange_compacted_iters"] = is0
        counters["measured_net_payload_elems"] = measured
        _sync(dev)
        exchange = (time.perf_counter() - t0, measured,
                    mesh.sent_bytes - bytes0)

        # Phases 3 + 4 on this rank's destination row (in-HBM ChunkSource)
        d = HBMChunkSource.dest_arrays(garrs)
        if backend == "segment":
            d.update(HBMChunkSource.edge_arrays(garrs))
        else:
            d.update(slot_row=bt.slot_row, slot_col=bt.slot_col,
                     slot_part=bt.slot_part, slot_valid=bt.slot_valid,
                     row_ptr=bt.row_ptr, tiles_cnt=bt.tiles_cnt, **vals)
        agg, has, cd = _dest_phases(
            d, recv_msg[None], recv_mask[None], slot_fn=slot_fn,
            monoid=monoid, spec=spec, cfg=cfg, backend=backend,
            part_sizes=part_sizes, gamma=gamma, mode_meta=mode_meta,
            rb_map=rb_map, bt_static=bt_static)
        counters.update({k: torch.sum(v) for k, v in cd.items()})

        new_state, new_active, total, io = _apply_and_account(
            state, agg, has, garrs["global_id"], vertex_valid, apply_fn,
            cfg, spec.batch_size, amask)
        counters.update(io)
        counters, total = reduce_mesh_counters(mesh, counters, counter_keys,
                                               total)
        log_mesh_call(engine, t_start, wire0, exchange, capacity)
        return new_state, new_active, total[0], counters

    return step


# ---------------------------------------------------------------------------
# OOC executor (disk-resident chunks + vertex spill, streamed dst-batches)
# ---------------------------------------------------------------------------
#
# The reference sized one fixed-shape Pallas grid for every streamed batch
# (``_max_tiles_per_batch_row``: n_rows_b x the most tiles any batch row
# holds), so one compiled program served them all.  At R-MAT scale 21 that
# is ~58k tiles x 5,844 rows, some 87 GB per tile array per batch.  The CUDA
# kernel takes ragged rows, so each batch is laid out with its real tiles
# only and that bound is not ported.

def _batch_any(mask, batch_size, num_batches):
    """[P, V] bool -> [P, B]: which intra-node batches contain a set bit."""
    p_cnt = mask.shape[0]
    pad = num_batches * batch_size - mask.shape[1]
    m = np.pad(np.asarray(mask, bool), ((0, 0), (0, pad)))
    return m.reshape(p_cnt, num_batches, batch_size).any(axis=2)


def _stream_tile_layout(work, *, tile, pb, n_rows_b, n_col_blocks, bs):
    """Block-CSR layout of one streamed dst-batch's real tiles, built on
    the device from the decoded triples.

    Returns (row_ptr [R+1], tile_idx [S], tile_col [S], row_cnt [R],
    cells, n_slots): every tile is live (the batch holds only the chunks
    the schedule marked active), and ``cells`` is the (slot, row offset,
    column offset) of each edge — the query-independent half of the
    kernel's inputs."""
    t = tile
    dst_b = work.dst - work.k * bs
    slot_row, slot_col, rp, eslot = build_tile_struct(
        dst_b // t, work.part.long() * pb + work.src // t, n_rows_b,
        n_col_blocks)
    n_slots = slot_row.numel()
    tile_idx = torch.arange(n_slots, dtype=torch.int32, device=rp.device)
    cells = (eslot.long(), (dst_b % t).long(), (work.src % t).long())
    return rp, tile_idx, slot_col, rp[1:] - rp[:-1], cells, n_slots


def _stream_value_tiles(work, cells, n_slots, slot_fn, monoid, mode, tile):
    """Scatter the per-edge affine coefficients of one streamed dst-batch
    into value tiles (tiles_cnt, tiles_v, tiles_b) on the device.  The
    coefficients are probed on the streamed edge data (affinity was
    certified by the engine's slot probe).  Counts are small integers and
    min/max folds exact, so these tiles equal the reference's; add tiles
    sum parallel edges' slopes (exact for slope 1, as in PageRank)."""
    t = tile
    d = work.data
    b_e = slot_fn(torch.zeros_like(d), d).to(F32)
    a_e = slot_fn(torch.ones_like(d), d).to(F32) - b_e
    flat = (cells[0] * t + cells[1]) * t + cells[2]
    size = n_slots * t * t

    def summed(x):
        return torch.zeros(size, dtype=F32, device=d.device).index_add_(
            0, flat, x).reshape(n_slots, t, t)

    tiles_cnt = summed(torch.ones_like(a_e))
    tiles_v = tiles_b = None
    if mode in ("add", "add_b"):
        tiles_v = summed(a_e)
        if mode == "add_b":
            tiles_b = summed(b_e)
    else:
        tiles_b = torch.full((size,), float(monoid.identity), dtype=F32,
                             device=d.device).scatter_reduce_(
            0, flat, b_e, reduce="amin" if mode == "min" else "amax"
        ).reshape(n_slots, t, t)
    return tiles_cnt, tiles_v, tiles_b


def _ooc_combine_batch(work, xv_q, xc_q, slot_fn, monoid, mode,
                       *, tile, pb, n_rows_b, bs):
    """Phase 4 for one streamed dst-batch through the CUDA combine kernel
    (a leading destination axis of 1): ragged layout + value tiles
    (helpers above), one launch."""
    row_ptr, tile_idx, tile_col, row_cnt, cells, n_slots = (
        _stream_tile_layout(work, tile=tile, pb=pb, n_rows_b=n_rows_b,
                            n_col_blocks=xc_q.shape[0] // tile, bs=bs))
    tiles_cnt, tiles_v, tiles_b = _stream_value_tiles(
        work, cells, n_slots, slot_fn, monoid, mode, tile)
    one = lambda x: None if x is None else x[None]
    val, hc = block_csr_combine(
        one(row_ptr), one(tile_idx), one(tile_col), one(row_cnt),
        one(tiles_v), one(tiles_b), one(tiles_cnt), one(xv_q), one(xc_q),
        mode=mode, tile=tile, identity=float(monoid.identity))
    return val[0], hc[0]


def _dispatch_schedule_one_dest(source, q, recv_mask_q, part_sizes, gamma,
                                compression):
    """Host-side phases 3 + 3.5 for one destination partition: dispatch
    presence over the memory-resident DCSR graph, the runtime three-way
    format choice (CSR-pruned / DCSR-raw / DCSR-delta when
    ``compression``, the legacy two-way otherwise), and the streamed-chunk
    schedule.  The exact decision both prices the model and drives the
    physical reads, so measured bytes match modeled bytes by design.

    Returns (counter contributions dict, chunk_active [P, B],
    schedule items [(q, k, [(p, rep), ...]), ...])."""
    p_cnt, b_cnt = source.has_csr.shape[1], source.has_csr.shape[2]
    present = (recv_mask_q[source.dcsr_part[q], source.dcsr_src[q]]
               & source.dcsr_valid[q])
    chunk_active = np.zeros((p_cnt, b_cnt), bool)
    chunk_active[source.dcsr_part[q][present],
                 source.dcsr_batch[q][present]] = True
    msgs_from = recv_mask_q.sum(axis=1)
    # The shared pricing function on host numpy, float32-pinned so the
    # decision is bit-identical to the tensor model.
    uc, ud, seek, per_chunk, per_raw = phases.format_choice_matrix(
        source.dcsr_ptr[q], source.has_csr[q],
        source.csr_bytes[q].astype(np.float32),
        source.dcsr_bytes[q].astype(np.float32),
        source.dcsr_delta_bytes[q].astype(np.float32),
        source.csr_raw_bytes[q].astype(np.float32),
        source.dcsr_raw_bytes[q].astype(np.float32),
        part_sizes, gamma, msgs_from, compression, xp=np)
    rep = np.where(uc, REP_CSR, np.where(ud, REP_DCSR_DELTA, REP_DCSR))
    # Each chunk's byte size is exact in float32, but their float32 sum is
    # not once a destination reads more than 2**24 bytes (R-MAT scale 21);
    # the reference sums in float32 and its verify_io then fails.  Summed
    # in float64 the model stays exact against the measured bytes.
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


def _block_dest_vectors(recv_mask_q, msg_q, mode, a_const, identity,
                        v_pad_t):
    """Flattened source vectors (xv, xc) for one destination's per-batch
    block_csr combine, on the device: the [P, V] receive view padded to
    tile-aligned per-partition spans, message presence in xc, and the
    affine slope pre-applied for the extremum modes."""
    pad = (0, v_pad_t - recv_mask_q.shape[1])
    mask_p = torch.nn.functional.pad(recv_mask_q, pad)
    msg_p = torch.nn.functional.pad(torch.where(recv_mask_q, msg_q, 0.0),
                                    pad)
    xc = mask_p.to(F32).reshape(-1)
    if mode in ("add", "add_b"):
        return msg_p.reshape(-1), xc
    return torch.where(mask_p, a_const * msg_p, identity).reshape(-1), xc


def _combine_stream_batch(wk, recv_mask_q, msg, slot_fn, monoid, agg, has,
                          *, backend, mode, blk, xv, xc, v_max):
    """Phase 4 for one prefetched dst-batch work item, on the engine's
    device: combine into ``agg[wk.q]`` / ``has[wk.q]`` with a monoid
    scatter (segment) or the block-CSR kernel (block_csr); returns the
    edges touched as a 0-d float64 tensor.

    recv_mask_q / msg: destination ``wk.q``'s [P, V] receive view and the
    [P, V] messages (garbage where the mask is False — never read).
    blk: (tile, pb, n_rows_b, bs); xv / xc: the destination's flattened
    source vectors."""
    if backend == "segment":
        gi = wk.part.long() * v_max + wk.src.long()
        pm = recv_mask_q.reshape(-1)[gi]
        contrib = slot_fn(msg.reshape(-1)[gi], wk.data).to(F32)
        dsts = wk.dst[pm].long()
        red = {"add": "sum", "min": "amin", "max": "amax"}[monoid.name]
        agg[wk.q].scatter_reduce_(0, dsts, contrib[pm], reduce=red)
        has[wk.q].index_fill_(0, dsts, True)
        return torch.sum(pm, dtype=torch.float64)
    tile, pb, n_rows_b, bs = blk
    val, hc = _ooc_combine_batch(wk, xv, xc, slot_fn, monoid, mode,
                                 tile=tile, pb=pb, n_rows_b=n_rows_b, bs=bs)
    lo = wk.k * bs
    hi = min(lo + bs, v_max)
    agg[wk.q, lo:hi] = val[:hi - lo]
    has[wk.q, lo:hi] = hc[:hi - lo] > 0.5
    return torch.sum(hc, dtype=torch.float64)


OOC_WALL_KEYS = ("phases_s", "read_s", "decode_s", "wait_s", "combine_s",
                 "apply_s")


def _host_state(state):
    return {k: _np(v) for k, v in state.items()}


def _device_state(state_np, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in state_np.items()}


def make_ooc_pe(engine, signal_fn, slot_fn, monoid, apply_fn, backend,
                mode_meta):
    """Fully-out-of-core ProcessEdges (DESIGN.md §6).

    Phases 1–3 run on the host in numpy on the memory-resident control
    state (active masks, need-bitmaps, the DCSR dispatching graph — the
    paper's in-memory metadata), where the byte model is priced.  Bulk
    data moves through measured requests only: vertex arrays batch by
    batch via the spill, edge chunks via the store with a prefetch thread
    feeding phase 4, which runs on the engine's device (segment scatter or
    the block-CSR kernel, one launch per streamed batch).  The signal,
    slot and apply callbacks get torch tensors on the device; their
    results come back to numpy for the host phases and the spill.

    Host wall seconds per stage accumulate in ``engine.ooc_wall``
    (``OOC_WALL_KEYS``): the host phases 1–3, the chunk reads and decodes
    on the prefetch thread, the combine thread's wait for them and its own
    combine calls, and the apply.  Device work is asynchronous, so a stage
    is charged for its launches until a later host copy waits for it."""
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
        blk = (tile, v_pad_t // tile, ceil_div(bs, tile), bs)
        mode, a_const = mode_meta

    def step(active):
        t_start = time.perf_counter()
        wall = engine.ooc_wall
        counters = {k: 0.0 for k in engine.counter_keys}
        sr0, sw0 = spill.bytes_read, spill.bytes_written
        amask = (vertex_valid if active is None
                 else _np(active).astype(bool) & vertex_valid)
        arrays_bytes = spill.arrays_bytes()
        bitmap = float(spill.bitmap_nbytes())

        # Phase 1: generate — read the active bitmap + active batches.
        # Unread (inactive) batches hold zeros; their messages are garbage
        # by contract (recv_mask never selects them).
        spill.read_bitmap()                                     # measured
        gen_batches = _batch_any(amask, bs, b_cnt)
        gstate = {k: v[:, :v_max]
                  for k, v in spill.read(gen_batches).items()}  # measured
        msg_d = signal_fn(_device_state(gstate, dev), global_id).to(F32)
        msg = msg_d.cpu().numpy()
        m_p = amask.sum(axis=1).astype(np.float64)
        counters["msgs_generated"] = float(m_p.sum())
        counters["msg_disk_bytes"] = float(m_p.sum()) * mb

        # Phase 2: filter (receive-major [Q, P, V]; traffic is analytic —
        # single host, nothing crosses a wire)
        recv_mask = np.empty((p_cnt, p_cnt, v_max), bool)
        for p in range(p_cnt):
            recv_mask[:, p] = phases.filter_sendmask(
                amask[p], need[p], need_counts[p], m_p[p], cfg, xp=np)
        n_active = float(amask.sum())
        counters["msgs_sent"] = float(recv_mask.sum())
        counters["msgs_sent_nofilter"] = p_cnt * n_active
        counts = phases.routing_counts(recv_mask, xp=np)         # [Q, P]
        gapb = unib = None
        if cfg.compression:
            gapb = codec.mask_gap_bytes(recv_mask, xp=np)
            unib = phases.batch_value_uniform(recv_mask, msg[None, :, :],
                                              xp=np)
        cross = np.arange(p_cnt)[:, None] != np.arange(p_cnt)[None, :]
        net, net_raw = phases.net_bytes_model(
            counts, cross, v_max, cfg.msg_bytes, gap_bytes=gapb,
            uniform=unib, xp=np)
        counters["net_bytes"] = float(net)
        counters["net_bytes_raw"] = float(net_raw)
        counters["net_bytes_nofilter"] = (p_cnt - 1) * n_active * mb

        # Phases 3 + 3.5 + schedule per destination: the runtime format
        # decision prices the model AND drives the disk reads below.
        schedule = []
        for q in range(p_cnt):
            cd, _, sched_q = _dispatch_schedule_one_dest(
                source, q, recv_mask[q], part_sizes, gamma,
                cfg.compression)
            for ck, cv in cd.items():
                counters[ck] += cv
            schedule.extend(sched_q)
        wall["phases_s"] += time.perf_counter() - t_start

        # Phase 4: stream active chunks dst-batch by dst-batch onto the
        # device and combine there.
        agg = torch.full((p_cnt, v_max), identity, dtype=F32, device=dev)
        has = torch.zeros((p_cnt, v_max), dtype=torch.bool, device=dev)
        touched = torch.zeros((), dtype=torch.float64, device=dev)
        recv_cache, vec_cache = {}, {}

        def recv(q):
            if q not in recv_cache:
                recv_cache[q] = torch.from_numpy(recv_mask[q]).to(dev)
                if backend == "block_csr":
                    vec_cache[q] = _block_dest_vectors(
                        recv_cache[q], msg_d, mode, a_const, identity,
                        v_pad_t)
            return recv_cache[q], vec_cache.get(q, (None, None))

        t0 = time.perf_counter()
        for w in ChunkPrefetcher(source, schedule,
                                 depth=cfg.ooc_prefetch_depth,
                                 device_decode=engine.device_decode,
                                 device=dev):
            t1 = time.perf_counter()
            mask_q, (xv_q, xc_q) = recv(w.q)
            touched += _combine_stream_batch(
                w, mask_q, msg_d, slot_fn, monoid, agg, has,
                backend=backend, mode=mode, blk=blk, xv=xv_q, xc=xc_q,
                v_max=v_max)
            counters["measured_chunks_read"] += w.n_chunks
            counters["measured_edge_read_bytes"] += w.nbytes
            counters["measured_chunks_device_decoded"] += w.n_device_chunks
            wall["read_s"] += w.read_s
            wall["decode_s"] += w.decode_s
            t0, wait = time.perf_counter(), t1 - t0
            wall["wait_s"] += wait
            wall["combine_s"] += t0 - t1
        counters["edges_touched"] = float(touched)

        # Apply: read updated batches, masked update, write back + bitmap
        t_apply = time.perf_counter()
        has_np = has.cpu().numpy()
        upd_mask = has_np & vertex_valid
        upd_batches = _batch_any(upd_mask, bs, b_cnt)
        astate_pad = spill.read(upd_batches)                    # measured
        astate = {k: v[:, :v_max] for k, v in astate_pad.items()}
        updates, new_active, ret = apply_fn(
            _device_state(astate, dev), agg, has, global_id)
        spill.merge_write(astate_pad, _host_state(updates), upd_mask,
                          upd_batches)                          # measured
        new_active = _np(new_active).astype(bool) & vertex_valid
        spill.write_bitmap(new_active)                          # measured
        total = float(np.where(upd_mask, _np(ret).astype(np.float32),
                               0.0).sum())

        # Modeled vertex I/O (same formulas as _apply_and_account) next to
        # the measured bytes the spill actually served.
        gen_v = float(gen_batches.sum()) * bs
        upd_v = float(upd_batches.sum()) * bs
        counters["vertex_read_bytes"] = ((gen_v + upd_v) * arrays_bytes
                                         + bitmap)
        counters["vertex_write_bytes"] = upd_v * arrays_bytes + bitmap
        counters["measured_vertex_read_bytes"] = spill.bytes_read - sr0
        counters["measured_vertex_write_bytes"] = spill.bytes_written - sw0
        wall["apply_s"] += time.perf_counter() - t_apply
        return spill.state_views(), new_active, total, counters

    return step


# ---------------------------------------------------------------------------
# DIST_OOC executor (per-worker chunk shards + filtered sparse exchange)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DestHeader(ScheduleMark):
    """Per-destination-partition header of the lazy dist_ooc schedule.

    Made on the prefetch thread as :class:`~repro_torch.core.exchange.
    DecodeAhead` delivers partition q's receive view and phase 3's dispatch
    runs over it, and forwarded through the chunk prefetch queue ahead of
    q's work items, so the consumer learns each partition's receive view
    and dispatch counters in stream order."""
    q: int
    recv_mask: np.ndarray      # [P, v_max] message presence per source part
    #                            ([Q, P, v_max] on the multi-query executor)
    recv_msg: np.ndarray       # [P, v_max] message values (0 off the mask)
    counter_delta: dict        # phase-3 contributions of
    #                            _dispatch_schedule_one_dest


def run_worker_pool(thunks, parallel: bool, pool=None):
    """Run one phase's per-worker thunks; results in worker index order.

    ``parallel=False`` runs them inline — the sequential reference order.
    ``parallel=True`` runs worker 0 on the calling thread and the others
    on ``pool`` (or on a pool made for the call) and joins them all before
    returning: the phase barrier the dist_ooc executor relies on (every
    send posted before any receive drains the exchange).  Results, and an
    exception (re-raised from the lowest-indexed failing worker after
    every worker has finished), are the same either way."""
    if not parallel or len(thunks) <= 1:
        return [t() for t in thunks]
    if pool is None:
        with ThreadPoolExecutor(max_workers=len(thunks) - 1,
                                thread_name_prefix="dist-worker") as tmp:
            futures = [tmp.submit(t) for t in thunks[1:]]
            first = thunks[0]()
            return [first] + [f.result() for f in futures]
    futures = [pool.submit(t) for t in thunks[1:]]
    try:
        first = thunks[0]()
    except BaseException:
        futures_wait(futures)      # a full barrier even when worker 0
        raise                      # fails on the calling thread
    futures_wait(futures)
    return [first] + [f.result() for f in futures]


# Host wall seconds per worker and stage, accumulated in
# ``engine.worker_times`` beside the reference's send_s / recv_s / pv_s:
# the wire's encode + post inside the send loop and its decode + assembly
# on the decode-ahead thread, then the receive pipeline's OOC split.
DIST_WALL_KEYS = ("send_s", "recv_s", "pv_s", "post_s", "take_s", "read_s",
                  "decode_s", "wait_s", "combine_s", "apply_s")


def record_worker_traffic(engine, w, cw, ex, store_io0, spill_io0,
                          dev_chunks, edges):
    """Worker ``w``'s measured traffic of one dist_ooc ProcessEdges call —
    its shard's chunks and bytes read since ``store_io0``, its spill's
    bytes since ``spill_io0``, the chunks decoded on the device and the
    edges touched — into its private counter deltas ``cw`` and its
    ``engine.worker_totals`` (with the wire bytes it sent on ``ex``)."""
    store, spill = engine.dist_sources[w].store, engine.spills[w]
    cr0, br0 = store_io0
    sr0, sw0 = spill_io0
    edge_b = store.bytes_read - br0
    cw["measured_chunks_read"] = store.chunks_read - cr0
    cw["measured_edge_read_bytes"] = edge_b
    cw["measured_chunks_device_decoded"] = dev_chunks
    cw["measured_vertex_read_bytes"] = spill.bytes_read - sr0
    cw["measured_vertex_write_bytes"] = spill.bytes_written - sw0
    cw["edges_touched"] = edges
    wt = engine.worker_totals[w]
    wt["disk_bytes"] += edge_b + ((spill.bytes_read - sr0)
                                  + (spill.bytes_written - sw0))
    wt["net_bytes"] += float(ex.bytes_by_sender[w])
    wt["edges_touched"] += edges


def make_dist_ooc_pe(engine, signal_fn, slot_fn, monoid, apply_fn, backend,
                     mode_meta):
    """Distributed fully-out-of-core ProcessEdges (DESIGN.md §7, §8).

    W workers each own a contiguous block of destination partitions backed
    by their own chunk-store shard and vertex spill.  Send side (host
    numpy, as OOC's phases 1–3): each worker reads its active vertex
    batches, generates messages on the engine's device, filters them and
    posts one batch per nonempty (p, q) send list through an
    :class:`~repro_torch.core.exchange.Exchange` — serialized in the
    adaptively chosen wire format when it crosses workers (measured
    network bytes), by reference otherwise.  Receive side: one long-lived
    pipeline per worker — a lazy schedule advanced on the prefetch thread
    iterates :class:`~repro_torch.core.exchange.DecodeAhead` (partition
    q+1's batches decode, their gap streams on the device when
    ``device_decode``, while q is in flight), prices q's dispatch with the
    float64 host model as its view lands, and feeds a :class:`DestHeader`
    and the selective schedule's chunk reads to one
    :class:`~repro_torch.core.chunkstore.ChunkPrefetcher`.  The consumer
    combines each streamed batch on the device (one block-CSR launch per
    batch over its real tiles, or the segment scatter) into its own rows
    of ``agg`` / ``has`` and applies into its spill.

    With ``EngineConfig.parallel_workers`` the W send loops and the W
    receive pipelines run on thread pools; every float a worker produces
    accumulates in worker-private state (its edges-touched tensor
    included) and is reduced in worker order after the join
    (``phases.reduce_worker_counters``), so parallel runs are
    bit-identical to sequential ones.

    In process mode (``engine.proc_ctx``, DESIGN.md §13) this rank runs
    only the logical workers its :class:`~repro_torch.core.transport.
    ProcContext` assigns it: batches for another rank's workers travel
    the socket mesh through a
    :class:`~repro_torch.core.transport.ProcExchange`, and the phase
    barriers become allgathers keyed by logical worker, reduced in worker
    order — so process mode is bit-identical to thread mode."""
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
        blk = (tile, v_pad_t // tile, ceil_div(bs, tile), bs)
        mode, a_const = mode_meta
    parallel = cfg.parallel_workers
    wire_device = dev if engine.device_decode else None
    cross = worker_of[np.newaxis, :] != worker_of[:, np.newaxis]
    ctx = engine.proc_ctx
    if ctx is not None:
        from repro_torch.core import transport as transport_mod
        merge_op = {"min": np.minimum, "max": np.maximum,
                    "add": np.add}[monoid.name]

    def _gather_by_worker(payload_mine, extra):
        """Allgather ``({worker: value}, extra)`` over the ranks; returns
        (the [W] values in worker order, the extras in rank order).  A
        worker no live rank reported is its owner's death: an owner that
        died before the collective began leaves a silent empty slot."""
        by_w, extras = {}, []
        for got in ctx.allgather((payload_mine, extra)):
            if got is None:
                continue
            mine_r, extra_r = got
            for w, o in mine_r.items():
                if w in by_w:
                    raise transport_mod.TransportError(
                        f"logical worker {w} reported by two ranks")
                by_w[w] = o
            extras.append(extra_r)
        missing = [w for w in range(n_workers) if w not in by_w]
        if missing:
            with ctx.mesh.cv:
                dead = ({ctx.assign[w] for w in missing}
                        & set(ctx.mesh.dead))
            if dead:
                raise transport_mod.WorkerDied(dead)
            raise transport_mod.TransportError(
                f"no live rank reported workers {missing}")
        return [by_w[w] for w in range(n_workers)], extras

    def step(active):
        counters = {k: 0.0 for k in engine.counter_keys}
        inj = ctx.injector if ctx is not None else None
        if inj is not None:
            inj.maybe_kill(ctx, "start")
        local_workers = (ctx.my_workers() if ctx is not None
                         else list(range(n_workers)))
        amask = (vertex_valid if active is None
                 else _np(active).astype(bool) & vertex_valid)
        arrays_bytes = spills[local_workers[0]].arrays_bytes()
        spill_io0 = [(sp.bytes_read, sp.bytes_written) for sp in spills]
        store_io0 = [(src.store.chunks_read, src.store.bytes_read)
                     for src in sources]
        ex = (transport_mod.ProcExchange(n_workers, v_max, cfg.compression,
                                         ctx, merge_op)
              if ctx is not None else
              exchange_mod.Exchange(n_workers, v_max,
                                    compression=cfg.compression))
        # The shared compute token (utils.token_ctx): the host bursts of
        # the W pipelines take turns; queue hand-offs and blocking waits
        # happen outside it.
        token = threading.Lock() if parallel else None
        tok = token_ctx(token)

        # Phases 1 + 2 per worker: generate from the worker's spill, filter
        # and post.  Each returns its own routing columns, assembled in
        # worker order after the join.
        def send_task(w):
            t0 = time.perf_counter()
            parts = worker_parts[w]
            lo, hi = parts[0], parts[-1] + 1
            spill = spills[w]
            with tok:                       # compute token: generate burst
                spill.read_bitmap()                         # measured
                am_w = amask[lo:hi]
                gen_b = _batch_any(am_w, bs, b_cnt)
                gstate = {k: v[:, :v_max]
                          for k, v in spill.read(gen_b).items()}  # measured
                msg_w = signal_fn(_device_state(gstate, dev),
                                  global_id[lo:hi]).to(F32).cpu().numpy()
            counts_w = np.zeros((p_cnt, len(parts)), np.float64)
            gapb_w = np.zeros((p_cnt, len(parts)), np.float64)
            unib_w = np.zeros((p_cnt, len(parts)), bool)
            post_s = 0.0
            for i, p in enumerate(parts):
                with tok:                   # compute token: filter + encode
                    m_p = float(am_w[i].sum())
                    sendmask = phases.filter_sendmask(
                        am_w[i], need[p], need_counts[p], m_p, cfg, xp=np)
                    counts_w[:, i] = phases.routing_counts(sendmask, xp=np)
                    if cfg.compression:
                        # the model's data-dependent terms, on the very
                        # masks the wire serializes
                        gapb_w[:, i] = codec.mask_gap_bytes(sendmask, xp=np)
                        unib_w[:, i] = phases.batch_value_uniform(
                            sendmask, msg_w[i][None, :], xp=np)
                    t1 = time.perf_counter()
                    for q in range(p_cnt):
                        c = int(counts_w[q, i])
                        if c:
                            ex.post(w, int(worker_of[q]), p, q, sendmask[q],
                                    msg_w[i], count=c)
                    post_s += time.perf_counter() - t1
            return (counts_w, gapb_w, unib_w, float(gen_b.sum()),
                    time.perf_counter() - t0, post_s)

        send_out = run_worker_pool(
            [functools.partial(send_task, w) for w in local_workers],
            parallel, pool=engine.worker_pool)
        if ctx is not None:
            # Send barrier: every rank contributes its workers' routing
            # columns and its exchange's counters.  TCP is FIFO per link,
            # so a sender's data frames precede its contribution: once the
            # gather completes, every expected frame has arrived, was
            # dropped (the ledger resends it below) or is held (deferred).
            send_rows, ex_snaps = _gather_by_worker(
                dict(zip(local_workers, send_out)), ex.counter_snapshot())
        else:
            send_rows = send_out
        counts = np.zeros((p_cnt, p_cnt), np.float64)       # [q, p] routing
        gapb = np.zeros((p_cnt, p_cnt), np.float64)
        unib = np.zeros((p_cnt, p_cnt), bool)
        gen_batches_total = 0.0
        for w, (counts_w, gapb_w, unib_w, gen_b_sum, dt, post_s) in \
                enumerate(send_rows):
            lo, hi = worker_parts[w][0], worker_parts[w][-1] + 1
            counts[:, lo:hi] = counts_w
            gapb[:, lo:hi] = gapb_w
            unib[:, lo:hi] = unib_w
            gen_batches_total += gen_b_sum
            engine.worker_times[w]["send_s"] += dt
            engine.worker_times[w]["post_s"] += post_s

        n_active = float(amask.sum())
        counters["msgs_generated"] = n_active
        counters["msg_disk_bytes"] = n_active * mb
        counters["msgs_sent"] = float(counts.sum())
        counters["msgs_sent_nofilter"] = p_cnt * n_active
        counters["net_bytes_nofilter"] = (p_cnt - 1) * n_active * mb
        # Modeled network traffic from the routing counts the wire used;
        # a batch crosses iff its source and destination workers differ.
        net, net_raw = phases.net_bytes_model(
            counts, cross, v_max, cfg.msg_bytes,
            gap_bytes=gapb if cfg.compression else None,
            uniform=unib if cfg.compression else None, xp=np)
        counters["net_bytes"] = float(net)
        counters["net_bytes_raw"] = float(net_raw)
        snaps = ex_snaps if ctx is not None else [ex.counter_snapshot()]
        # Wire counters are global: the ranks' integer tallies summed in
        # rank order (exact, so process mode equals thread mode's one sum)
        for ck, nk in (("bytes_sent", "measured_net_bytes"),
                       ("pair_batches", "net_pair_batches"),
                       ("slab_batches", "net_slab_batches"),
                       ("vpair_batches", "net_vpair_batches"),
                       ("uval_batches", "net_uval_batches")):
            counters[nk] = float(sum(sn[ck] for sn in snaps))
        if ctx is not None:
            posted_total = np.zeros((n_workers, n_workers), np.int64)
            for sn in ex_snaps:
                posted_total += np.asarray(sn["posted"], np.int64)
            # Receive barrier: every frame for this rank's workers has
            # arrived, been redelivered from its sender's ledger (a drop)
            # or been acknowledged as held (a delay, merged next op).  The
            # receive pipelines below start only after it, so no
            # DecodeAhead drains an inbox this op's frames still fill.
            if inj is not None:
                inj.maybe_kill(ctx, "recv")
            ctx.resolve_arrivals(posted_total)

        # Phases 3 + 4 + apply per worker, against its own shard.  The
        # send pool has joined, so every batch is posted before a receive
        # drains the exchange.  Rows of agg / has / new_active are
        # partitioned by ownership: the concurrent writes never alias.
        agg = torch.full((p_cnt, v_max), identity, dtype=F32, device=dev)
        has = torch.zeros((p_cnt, v_max), dtype=torch.bool, device=dev)
        new_active = np.zeros((p_cnt, v_max), bool)

        def recv_task(w):
            t0 = time.perf_counter()
            parts = worker_parts[w]
            lo, hi = parts[0], parts[-1] + 1
            spill = spills[w]
            source = sources[w]
            cw = {}                       # worker-private counter deltas
            wall = dict.fromkeys(("take_s", "read_s", "decode_s", "wait_s",
                                  "combine_s", "apply_s"), 0.0)
            decoders = []

            def lazy_schedule():
                # Runs on the prefetch thread: as DecodeAhead delivers q's
                # receive view, the dispatch and the runtime format choice
                # price q's reads and emit them right behind q's header.
                ahead = exchange_mod.DecodeAhead(
                    ex, w, parts, p_cnt, compute_lock=token,
                    runner=engine.pipeline_pool, device=wire_device)
                decoders.append(ahead)
                for q, recv_mask_q, recv_msg_q in ahead:
                    with tok:               # compute token: dispatch burst
                        cd, _, sched_q = _dispatch_schedule_one_dest(
                            source, q, recv_mask_q, part_sizes, gamma,
                            cfg.compression)
                        header = DestHeader(
                            q=q, recv_mask=recv_mask_q, recv_msg=recv_msg_q,
                            counter_delta=cd)
                    yield header
                    yield from sched_q

            touched = torch.zeros((), dtype=torch.float64, device=dev)
            dev_chunks = 0
            cur = mask_q = msg_q = xv_q = xc_q = None
            t_wait = time.perf_counter()
            for item in ChunkPrefetcher(
                    source, lazy_schedule(), depth=cfg.ooc_prefetch_depth,
                    compute_lock=token, device_decode=engine.device_decode,
                    device=dev, runner=engine.pipeline_pool):
                t1 = time.perf_counter()
                wall["wait_s"] += t1 - t_wait
                if isinstance(item, DestHeader):
                    cur = item
                    mask_q = msg_q = xv_q = xc_q = None
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
                            xv_q, xc_q = _block_dest_vectors(
                                mask_q, msg_q, mode, a_const, identity,
                                v_pad_t)
                    touched += _combine_stream_batch(
                        item, mask_q, msg_q, slot_fn, monoid, agg, has,
                        backend=backend, mode=mode, blk=blk, xv=xv_q,
                        xc=xc_q, v_max=v_max)
                t_wait = time.perf_counter()
                wall["combine_s"] += t_wait - t1
            wall["take_s"] = sum(d.take_s for d in decoders)

            # Apply into this worker's spill (measured vertex I/O).
            t_apply = time.perf_counter()
            with tok:                       # compute token: apply burst
                upd_w = has[lo:hi].cpu().numpy() & vertex_valid[lo:hi]
                upd_b = _batch_any(upd_w, bs, b_cnt)
                astate_pad = spill.read(upd_b)              # measured
                astate = {k: v[:, :v_max] for k, v in astate_pad.items()}
                updates, na_w, ret = apply_fn(
                    _device_state(astate, dev), agg[lo:hi], has[lo:hi],
                    global_id[lo:hi])
                spill.merge_write(astate_pad, _host_state(updates), upd_w,
                                  upd_b)                    # measured
                na_w = _np(na_w).astype(bool) & vertex_valid[lo:hi]
                spill.write_bitmap(na_w)                    # measured
                new_active[lo:hi] = na_w
                total_w = float(np.where(
                    upd_w, _np(ret).astype(np.float32), 0.0).sum())
            wall["apply_s"] = time.perf_counter() - t_apply

            record_worker_traffic(engine, w, cw, ex, store_io0[w],
                                  spill_io0[w], dev_chunks, float(touched))
            return (cw, total_w, float(upd_b.sum()),
                    time.perf_counter() - t0, wall)

        recv_out = run_worker_pool(
            [functools.partial(recv_task, w) for w in local_workers],
            parallel, pool=engine.worker_pool)
        pending = 0
        if ctx is not None:
            if inj is not None:
                inj.maybe_kill(ctx, "apply")
            # Final collective: per-worker results, new-active rows and the
            # authoritative worker_totals, by logical worker; each rank's
            # deferred count rides along, so a round with held (delayed)
            # frames cannot read as converged.
            mine = {w: out + (new_active[worker_parts[w][0]:
                                         worker_parts[w][-1] + 1].copy(),
                              dict(engine.worker_totals[w]))
                    for w, out in zip(local_workers, recv_out)}
            recv_rows, deferred = _gather_by_worker(
                mine, ctx.pending_deferred())
            recv_out = []
            for w, row in enumerate(recv_rows):
                lo, hi = worker_parts[w][0], worker_parts[w][-1] + 1
                new_active[lo:hi] = np.asarray(row[5], bool)
                engine.worker_totals[w] = dict(row[6])
                recv_out.append(row[:5])
            pending = int(sum(int(d) for d in deferred))
        # Deterministic reduction: every float above accumulated in
        # worker-private state; summing in worker order after the join
        # makes parallel runs bit-identical to sequential ones.
        phases.reduce_worker_counters(counters, [o[0] for o in recv_out])
        total = 0.0
        upd_batches_total = 0.0
        for w, (_, total_w, upd_b_sum, dt, wall) in enumerate(recv_out):
            total += total_w
            upd_batches_total += upd_b_sum
            engine.worker_times[w]["recv_s"] += dt
            for k, v in wall.items():
                engine.worker_times[w][k] += v
        # Held (delayed) frames apply next op through the slot monoid; the
        # promise keeps fixpoint drivers (they stop on total == 0) going
        # until the deferred contributions land.
        total += float(pending)

        # Modeled vertex I/O: the formulas of the other executors (the
        # per-worker bitmaps sum to the full [P, V] bitmap's bytes).
        bitmap = float(sum(sp.bitmap_nbytes() for sp in spills))
        gen_v = gen_batches_total * bs
        upd_v = upd_batches_total * bs
        counters["vertex_read_bytes"] = ((gen_v + upd_v) * arrays_bytes
                                         + bitmap)
        counters["vertex_write_bytes"] = upd_v * arrays_bytes + bitmap
        return engine._dist_state_views(), new_active, total, counters

    return step
