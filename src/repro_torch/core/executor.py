"""The LOCAL ProcessEdges executor and the block-CSR slot lowering
(DESIGN.md §1, §2) — the LOCAL half of ``repro.core.executor``.

``make_local_pe`` runs on one device with the partition axis as a leading
tensor axis.  The inter-partition exchange is a re-axis (the send masks of
every source partition, viewed receive-major as [Q, P, V]), and "network"
traffic is accounted analytically by counters priced with the same model
every executor uses (``phases.routing_counts`` -> ``phases.net_bytes_model``).

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

import hashlib

import numpy as np
import torch

from repro_torch.core import codec, phases
from repro_torch.core.chunkstore import HBMChunkSource
from repro_torch.core.formats import BlockTilesHost
from repro_torch.core.partition import row_block_batch_map

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
