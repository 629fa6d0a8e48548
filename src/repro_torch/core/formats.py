"""Adaptive CSR / DCSR chunk representations (paper §4.1).

Every edge chunk gets a DCSR ((src, idx) pairs for sources that actually
have edges in the chunk).  Chunks whose CSR index would not be too inflated
(|V_src| / |E_chunk| <= inflate_ratio, default 32) additionally get a CSR.

On top of the representation choice sits the compression tier (DESIGN.md
§9): the (src, idx) pair stream is additionally stored delta-varint
encoded, and the compressed payload is columnar — dst residues (delta to
the previous edge's dst, restarting per source run against the batch base;
derivable-from-index information pruned to its varint residue) next to the
f32 data column — so the runtime choice becomes three-way
{CSR-pruned, DCSR-raw, DCSR-delta} per chunk.  Both the compressed byte
model and the legacy uncompressed ``*_raw`` twins are kept on
:class:`ChunkFormats`; ``EngineConfig.compression`` selects which family
prices (and, out of core, physically serves) the reads.

At process time the engine chooses per chunk with the paper's seek-cost
model:
    cost_DCSR = 2 * |V_src, outdeg != 0|          (scan the (src, idx) array)
    cost_CSR  = min(gamma * |M|, |V_src|)          (seek per message or scan idx)
with gamma = 1024 ("the cost of each seek equals scanning gamma elements").

The *bytes* of the chosen representation are what the I/O model prices;
the seek-cost model prices the per-source random lookups.  The DCSR arrays
below also serve as the intra-node "dispatching graph" of §4.2 (Fig. 1e):
an entry (src, batch k) says "messages from src go to batch k".

The host builders are numpy copied from ``repro.core.formats`` (``np.add.at``
accumulates parallel edges in the reference's order, so every array is
bit-equal to JAX's); the results are dataclasses of CPU tensors that the
engine moves to its device once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.partition import DistGraph, tensors_to
from repro_torch.kernels.csr_spmv import build_tile_struct_np
from repro_torch.utils import ceil_div

DEFAULT_INFLATE_RATIO = 32
DEFAULT_GAMMA = 1024.0


@dataclasses.dataclass
class ChunkFormats:
    """Per-chunk representation metadata + DCSR device arrays.

    DCSR arrays are concatenated over chunks per destination partition q,
    grouped in (src partition p, dst batch k) order; chunk (p, k) occupies
    DCSR slots dcsr_ptr[q, p, k] : dcsr_ptr[q, p, k + 1].

    Two byte models live side by side (DESIGN.md §9): the **compressed**
    read sizes (``csr_bytes`` — pruned-dst CSR, ``dcsr_bytes`` — raw pairs
    over the compressed columnar payload, ``dcsr_delta_bytes`` —
    delta-varint pairs) price the compressed on-disk layout, while the
    ``*_raw`` twins keep the legacy uncompressed pricing (raw pairs / idx
    + interleaved 8 B/edge payload).  ``EngineConfig.compression`` selects
    which family the runtime choice and counters use; the raw twins are
    also reported next to the compressed counters for the Fig.5-style
    compressed-vs-raw ratios.
    """
    # --- DCSR device arrays, [P, S_max] ---
    dcsr_src: torch.Tensor        # int32, source local id (within partition p)
    dcsr_edge_start: torch.Tensor # int32, first edge slot of this src's run
    dcsr_edge_count: torch.Tensor # int32, number of edges in the run
    dcsr_batch: torch.Tensor      # int32, destination batch of this entry
    dcsr_part: torch.Tensor       # int32, source partition of this entry
    dcsr_valid: torch.Tensor      # bool, padding mask
    dcsr_ptr: torch.Tensor        # int32 [P, P, B + 1]
    # --- per-chunk format decision + cost/storage model (constant arrays) ---
    has_csr: torch.Tensor         # bool [P, P, B]
    csr_bytes: torch.Tensor       # float32 [P, P, B]  idx + dstv + data
    dcsr_bytes: torch.Tensor      # float32 [P, P, B]  raw pairs + dstv + data
    dcsr_delta_bytes: torch.Tensor # float32 [P, P, B] delta pairs + dstv + data
    csr_raw_bytes: torch.Tensor   # float32 [P, P, B]  legacy idx + (dst, data)
    dcsr_raw_bytes: torch.Tensor  # float32 [P, P, B]  legacy pairs + (dst, data)
    stored_bytes: torch.Tensor    # float32 [P, P, B]  compressed-layout bytes
    #                               on disk: every section of the chunk
    # --- static metadata (hashable) ---
    s_max: int
    inflate_ratio: float
    gamma: float
    # Unweighted graph (every valid edge weight is exactly 1.0): the
    # compressed layout elides the uniform f32 data column entirely — the
    # last uncompressed 4 B/edge — and the compressed byte model above
    # prices the chunks without it (DESIGN.md §10).  The ``*_raw`` twins
    # keep the legacy interleaved (dst, data) pricing either way.
    values_elided: bool = False

    def to(self, device) -> "ChunkFormats":
        return tensors_to(self, device)



def _np(x, dtype=None):
    """Host numpy view of a tensor (or array) field."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x) if dtype is None else np.asarray(x, dtype)


def _t(x, dtype=None):
    """Numpy -> CPU tensor (zero-copy when no cast is needed)."""
    return torch.from_numpy(np.ascontiguousarray(
        x if dtype is None else np.asarray(x, dtype)))


_IDX_BYTES = 4       # one int32 per CSR idx entry
_SRCIDX_BYTES = 8    # (src, idx) pair per DCSR entry
_EDGE_BYTES = 8      # (dst, data) per edge (legacy interleaved payload)
_DATA_BYTES = 4      # f32 data column of the compressed columnar payload


def build_formats(g: DistGraph, *, inflate_ratio: float = DEFAULT_INFLATE_RATIO,
                  gamma: float = DEFAULT_GAMMA) -> ChunkFormats:
    spec = g.spec
    p_cnt, b_cnt = spec.num_partitions, spec.num_batches
    part_sizes = spec.partition_sizes()            # |V_p| per source partition
    chunk_edges_np = _np(g.chunk_edges, np.int64)
    chunk_nnz_np = _np(g.chunk_nnz_src, np.int64)

    # --- format decision (static, from preprocessing stats) ---
    v_src = np.broadcast_to(part_sizes[None, :, None],
                            (p_cnt, p_cnt, b_cnt)).astype(np.float64)
    edges = chunk_edges_np.astype(np.float64)
    with np.errstate(divide="ignore"):
        ratio = np.where(edges > 0, v_src / np.maximum(edges, 1), np.inf)
    has_csr = (ratio <= inflate_ratio) & (edges > 0)

    csr_raw_bytes = ((v_src + 1) * _IDX_BYTES
                     + edges * _EDGE_BYTES).astype(np.int64)
    dcsr_raw_bytes = (chunk_nnz_np * _SRCIDX_BYTES
                      + chunk_edges_np * _EDGE_BYTES).astype(np.int64)
    empty = chunk_edges_np == 0
    csr_raw_bytes[~has_csr] = 0
    csr_raw_bytes[empty] = 0
    dcsr_raw_bytes[empty] = 0

    # --- DCSR device arrays (host pass over the already-sorted edges) ---
    src_local = _np(g.edge_src_local)
    dst_local = _np(g.edge_dst_local)
    valid = _np(g.edge_valid)
    chunk_ptr = _np(g.chunk_ptr)
    bs = spec.batch_size

    # Compressed-section sizes (DESIGN.md §9), measured per chunk on the
    # exact delta streams the store will write — model == disk by
    # construction.  One vectorized pass per destination partition over
    # all its chunks at once (run boundaries = src change or chunk
    # boundary), mirroring the batched encode in ChunkStore.build.
    pair_delta_nb = np.zeros((p_cnt, p_cnt, b_cnt), np.int64)
    dst_delta_nb = np.zeros((p_cnt, p_cnt, b_cnt), np.int64)
    n_chunks = p_cnt * b_cnt

    per_q_entries = []
    for q in range(p_cnt):
        n_q = int(chunk_ptr[q, -1, -1])
        flat = np.concatenate([chunk_ptr[q, :, :-1].reshape(-1),
                               chunk_ptr[q, -1, -1:]]).astype(np.int64)
        src_q = src_local[q, :n_q].astype(np.int64)
        dst_q = dst_local[q, :n_q].astype(np.int64)
        cid = np.repeat(np.arange(n_chunks), np.diff(flat))
        is_start = np.empty(n_q, bool)
        if n_q:
            is_start[0] = True
            is_start[1:] = (src_q[1:] != src_q[:-1]) | (cid[1:] != cid[:-1])
        sidx = np.flatnonzero(is_start)          # global run start offsets
        run_cid = cid[sidx]
        first = np.empty(sidx.size, bool)
        prev_src = np.empty(sidx.size, np.int64)
        prev_rel = np.empty(sidx.size, np.int64)
        rel = sidx - flat[run_cid]               # chunk-relative offsets
        if sidx.size:
            first[0] = True
            first[1:] = run_cid[1:] != run_cid[:-1]
            prev_src[0] = prev_rel[0] = 0
            prev_src[1:] = src_q[sidx[:-1]]
            prev_rel[1:] = rel[:-1]
        ds = np.where(first, src_q[sidx], src_q[sidx] - prev_src)
        di = np.where(first, rel, rel - prev_rel)
        pair_sz = (codec.varint_sizes(ds.astype(np.uint64))
                   + codec.varint_sizes(di.astype(np.uint64)))
        pair_delta_nb[q] = np.bincount(
            run_cid, weights=pair_sz.astype(np.float64),
            minlength=n_chunks).astype(np.int64).reshape(p_cnt, b_cnt)
        res = np.empty(n_q, np.int64)
        if n_q:
            res[1:] = dst_q[1:] - dst_q[:-1]
            res[sidx] = dst_q[sidx] - (cid[sidx] % b_cnt) * bs
        dst_delta_nb[q] = np.bincount(
            cid, weights=codec.varint_sizes(res.astype(np.uint64)).astype(
                np.float64),
            minlength=n_chunks).astype(np.int64).reshape(p_cnt, b_cnt)
        if sidx.size:
            run_len = np.diff(np.append(sidx, n_q))
            per_q_entries.append(np.stack([
                src_q[sidx],                     # src
                sidx,                            # edge_start
                run_len,                         # edge_count
                run_cid % b_cnt,                 # batch
                run_cid // b_cnt,                # src partition
            ], axis=1))
        else:
            per_q_entries.append(np.zeros((0, 5), np.int64))

    # Values-elided layout (DESIGN.md §10): an unweighted graph carries a
    # uniform 1.0 in every valid edge slot, so the compressed payload
    # drops the f32 data column entirely and decode re-synthesizes it.
    # Derived from the same arrays the store serializes, so model and
    # disk agree by construction; the raw twins keep the legacy pricing.
    evalid = _np(g.edge_valid)
    values_elided = bool(
        np.all(_np(g.edge_data)[evalid] == np.float32(1.0)))

    # Compressed read sizes: shared columnar payload (dst residues + f32
    # data unless elided) under one of three index sections; empty chunks
    # cost 0.
    data_nb = 0 if values_elided else chunk_edges_np * _DATA_BYTES
    shared = dst_delta_nb + data_nb
    dcsr_bytes = chunk_nnz_np * _SRCIDX_BYTES + shared
    dcsr_delta_bytes = pair_delta_nb + shared
    csr_bytes = (v_src.astype(np.int64) + 1) * _IDX_BYTES + shared
    csr_bytes[~has_csr] = 0
    for arr in (dcsr_bytes, dcsr_delta_bytes, csr_bytes):
        arr[empty] = 0
    # Storage cost of the compressed layout: every section of the chunk
    # (both pair encodings always, idx when accepted, shared payload once).
    stored = (chunk_nnz_np * _SRCIDX_BYTES + pair_delta_nb + shared
              + np.where(has_csr,
                         (v_src.astype(np.int64) + 1) * _IDX_BYTES, 0))
    stored[empty] = 0

    s_max = max(1, max(r.shape[0] for r in per_q_entries))
    dcsr_src = np.zeros((p_cnt, s_max), np.int32)
    dcsr_edge_start = np.zeros((p_cnt, s_max), np.int32)
    dcsr_edge_count = np.zeros((p_cnt, s_max), np.int32)
    dcsr_batch = np.zeros((p_cnt, s_max), np.int32)
    dcsr_part = np.zeros((p_cnt, s_max), np.int32)
    dcsr_valid = np.zeros((p_cnt, s_max), bool)
    dcsr_ptr = np.zeros((p_cnt, p_cnt, b_cnt + 1), np.int32)
    for q, rows in enumerate(per_q_entries):
        n = rows.shape[0]
        if n:
            dcsr_src[q, :n] = rows[:, 0]
            dcsr_edge_start[q, :n] = rows[:, 1]
            dcsr_edge_count[q, :n] = rows[:, 2]
            dcsr_batch[q, :n] = rows[:, 3]
            dcsr_part[q, :n] = rows[:, 4]
            dcsr_valid[q, :n] = True
        # offsets: count entries per (p, k); row boundaries overlap into the
        # global cumulative array (see partition.build_dist_graph)
        counts = np.zeros((p_cnt, b_cnt), np.int64)
        if n:
            np.add.at(counts, (rows[:, 4], rows[:, 3]), 1)
        flat = np.concatenate([[0], np.cumsum(counts.ravel())])
        idx = (np.arange(p_cnt)[:, None] * b_cnt
               + np.arange(b_cnt + 1)[None, :])
        dcsr_ptr[q] = flat[idx]

    return ChunkFormats(
        dcsr_src=_t(dcsr_src),
        dcsr_edge_start=_t(dcsr_edge_start),
        dcsr_edge_count=_t(dcsr_edge_count),
        dcsr_batch=_t(dcsr_batch),
        dcsr_part=_t(dcsr_part),
        dcsr_valid=_t(dcsr_valid),
        dcsr_ptr=_t(dcsr_ptr),
        has_csr=_t(has_csr),
        csr_bytes=_t(csr_bytes, np.float32),
        dcsr_bytes=_t(dcsr_bytes, np.float32),
        dcsr_delta_bytes=_t(dcsr_delta_bytes, np.float32),
        csr_raw_bytes=_t(csr_raw_bytes, np.float32),
        dcsr_raw_bytes=_t(dcsr_raw_bytes, np.float32),
        stored_bytes=_t(stored, np.float32),
        s_max=s_max,
        inflate_ratio=float(inflate_ratio),
        gamma=float(gamma),
        values_elided=values_elided,
    )


# ---------------------------------------------------------------------------
# Block-CSR compute tiles (DESIGN.md §4) — the edge format the engine's
# block_csr backend feeds to the combine kernel.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockTiles:
    """Per-destination-partition block-CSR tile structure, padded + stacked.

    For destination partition q the incoming adjacency is a [v_pad x
    P * v_pad] matrix (rows = local dst vertices, columns = source vertices
    laid out per-partition, each padded to ``v_pad``), tiled into T x T
    blocks; only nonempty tiles get a slot.  Slots are sorted by (row block,
    column block); ``row_ptr`` gives each row block's slot range.  The
    *value* tiles depend on the running (slot_fn, monoid) and are lowered at
    runtime (executor.probe_slot_affine + executor.build_value_tiles);
    only the structure and the
    valid-edge multiplicity tiles (``tiles_cnt``) are static.
    """
    # --- per-slot, [P, S_max] ---
    slot_row: torch.Tensor        # int32, destination row block
    slot_col: torch.Tensor        # int32, global source column block
    slot_part: torch.Tensor       # int32, source partition of the column
    slot_valid: torch.Tensor      # bool, padding mask
    # --- [P, R + 1] ---
    row_ptr: torch.Tensor         # int32 slot offsets per row block
    # --- [P, S_max, T, T] ---
    tiles_cnt: torch.Tensor       # float32 valid-edge multiplicity per cell
    # --- static metadata (hashable) ---
    tile: int
    v_pad: int
    n_rows: int
    n_col_blocks: int
    s_max: int
    max_tiles_per_row: int

    def to(self, device) -> "BlockTiles":
        return tensors_to(self, device)




@dataclasses.dataclass
class BlockTilesHost:
    """Host-side per-edge -> tile-cell mapping (numpy, kept on the engine
    so per-algorithm value tiles are one numpy scatter to build)."""
    edge_slot: np.ndarray         # int32 [P, E] slot of each edge's cell
    edge_roff: np.ndarray         # int32 [P, E] row offset within the tile
    edge_coff: np.ndarray         # int32 [P, E] col offset within the tile
    edge_valid: np.ndarray        # bool  [P, E]
    edge_data: np.ndarray         # f32   [P, E]
    s_max: int
    tile: int


def build_block_tiles(g: DistGraph, *, tile: int = 8, device=None,
                      rows=None) -> tuple[BlockTiles, BlockTilesHost]:
    """Host-side preprocessing: per destination partition, group the (dst
    batch x src partition) adjacency into T x T block-CSR tiles (reusing the
    kernel-side :func:`build_tile_struct` core, which sorts the tile keys
    on ``device``, the CPU by default).

    ``rows`` (destination partitions, all by default) builds only those
    rows, stacked in that order: a mesh rank builds its own row alone."""

    spec = g.spec
    p_cnt, v_max = spec.num_partitions, spec.v_max
    t = tile
    v_pad = ceil_div(v_max, t) * t
    pb = v_pad // t                   # column blocks per source partition
    n_rows = v_pad // t
    n_col_blocks = p_cnt * pb

    qs = list(range(p_cnt)) if rows is None else [int(q) for q in rows]
    n_q = len(qs)
    pick = _np if rows is None else (lambda x: _np(x)[qs])
    esl = pick(g.edge_src_local)
    esp = pick(g.edge_src_part)
    edl = pick(g.edge_dst_local)
    evalid = pick(g.edge_valid)
    edata = pick(g.edge_data)
    e_max = esl.shape[1]

    per_q = []
    edge_slot = np.full((n_q, e_max), 0, np.int32)
    for q in range(n_q):
        m = evalid[q]
        v, u, p = edl[q][m], esl[q][m], esp[q][m]
        slot_row, slot_col, row_ptr, eslot = build_tile_struct_np(
            v // t, p * pb + u // t, n_rows, n_col_blocks, device=device)
        edge_slot[q, m] = eslot
        per_q.append((slot_row, slot_col, row_ptr))

    s_max = max(1, max(sr.shape[0] for sr, _, _ in per_q))
    max_tpr = max(1, max(int((rp[1:] - rp[:-1]).max()) for _, _, rp in per_q))

    slot_row = np.full((n_q, s_max), n_rows - 1, np.int32)
    slot_col = np.zeros((n_q, s_max), np.int32)
    slot_part = np.zeros((n_q, s_max), np.int32)
    slot_valid = np.zeros((n_q, s_max), bool)
    row_ptr = np.zeros((n_q, n_rows + 1), np.int32)
    tiles_cnt = np.zeros((n_q, s_max, t, t), np.float32)
    for q, (sr, sc, rp) in enumerate(per_q):
        n = sr.shape[0]
        slot_row[q, :n] = sr
        slot_col[q, :n] = sc
        slot_part[q, :n] = sc // pb
        slot_valid[q, :n] = True
        row_ptr[q] = rp
        m = evalid[q]
        np.add.at(tiles_cnt[q],
                  (edge_slot[q][m], edl[q][m] % t, esl[q][m] % t), 1.0)

    bt = BlockTiles(
        slot_row=_t(slot_row),
        slot_col=_t(slot_col),
        slot_part=_t(slot_part),
        slot_valid=_t(slot_valid),
        row_ptr=_t(row_ptr),
        tiles_cnt=_t(tiles_cnt),
        tile=t, v_pad=v_pad, n_rows=n_rows, n_col_blocks=n_col_blocks,
        s_max=s_max, max_tiles_per_row=max_tpr,
    )
    host = BlockTilesHost(
        edge_slot=edge_slot,
        edge_roff=(edl % t).astype(np.int32),
        edge_coff=(esl % t).astype(np.int32),
        edge_valid=evalid,
        edge_data=edata,
        s_max=s_max, tile=t,
    )
    return bt, host


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def storage_summary(fmts: ChunkFormats, g: DistGraph) -> dict:
    """Totals for the Fig.5-style I/O claims: adaptive store vs raw pairs
    (numpy on host copies; the reference's sums, dtype for dtype).

    ``adaptive_best_read_bytes`` prices the three-way compressed choice
    (pruned CSR / raw-pair DCSR / delta-varint DCSR over the columnar
    payload); ``adaptive_raw_read_bytes`` prices the legacy two-way
    uncompressed layout for the same chunks, so their ratio is the
    compression win at full-scan density."""
    has_csr = _host(fmts.has_csr)
    csr_bytes = _host(fmts.csr_bytes)
    dcsr_bytes = _host(fmts.dcsr_bytes)
    dcsr_delta = _host(fmts.dcsr_delta_bytes)
    raw_pair_bytes = int(_host(g.edge_valid).sum()) * 8
    csr_only = float(np.where(has_csr, csr_bytes, 0).sum())
    dcsr_only = float(dcsr_bytes.sum())
    best_dcsr = np.minimum(dcsr_bytes, dcsr_delta)
    adaptive_read = float(np.minimum(
        np.where(has_csr, csr_bytes, np.inf), best_dcsr).sum())
    adaptive_raw = float(np.minimum(
        np.where(has_csr, _host(fmts.csr_raw_bytes), np.inf),
        _host(fmts.dcsr_raw_bytes)).sum())
    # non-adaptive baseline the paper improves on: CSR for EVERY live chunk
    # (each pays the full |V_src|+1 idx array regardless of sparsity)
    edges = _host(g.chunk_edges).astype(np.float64)
    v_src = np.broadcast_to(
        g.spec.partition_sizes()[None, :, None].astype(np.float64),
        edges.shape)
    csr_all = float(np.where(
        edges > 0, (v_src + 1) * _IDX_BYTES + edges * _EDGE_BYTES, 0).sum())
    return dict(raw_pair_bytes=raw_pair_bytes,
                csr_total_bytes=csr_only,
                csr_all_chunks_bytes=csr_all,
                dcsr_total_bytes=dcsr_only,
                adaptive_best_read_bytes=adaptive_read,
                adaptive_raw_read_bytes=adaptive_raw,
                compressed_over_raw=adaptive_read / max(adaptive_raw, 1.0),
                adaptive_over_csr_all=adaptive_read / max(csr_all, 1.0),
                stored_bytes=float(_host(fmts.stored_bytes).sum()),
                csr_chunk_fraction=float(has_csr.mean()))
