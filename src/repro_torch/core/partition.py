"""Two-level column-oriented partitioning (paper §2.2).

Level 1 (inter-node): vertices with contiguous IDs are range-partitioned
across P partitions, balancing  alpha * |V_i| + |E_i_in| + |E_i_out|  with
alpha defaulting to 2P-1 (derived from the per-phase work model, paper §4.5 /
Table 2).

Level 2 (intra-node): inside each partition, vertices form fixed-size
*batches*; edges are grouped into *chunks* keyed by (source partition,
destination batch) — "column-oriented" because a chunk holds one column
stripe of the adjacency matrix restricted to one destination batch.

All preprocessing here is host-side numpy, copied from ``repro.core.
partition`` so the arrays are bit-equal to the reference's; the device-side
structure (`DistGraph`) is a dataclass of padded, stacked torch tensors
(leading axis = partition) that the builders return on the CPU and
:meth:`DistGraph.to` moves to the engine's device once.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.data.graphs import GraphData
from repro_torch.utils import ceil_div


@dataclasses.dataclass(frozen=True)
class TwoLevelSpec:
    """Static description of a two-level partition."""
    num_vertices: int
    num_partitions: int          # P (inter-node)
    boundaries: tuple            # P+1 global vertex ids, boundaries[p] .. boundaries[p+1]
    v_max: int                   # max partition size (padding target)
    batch_size: int              # vertices per intra-node batch
    num_batches: int             # B = ceil(v_max / batch_size)
    alpha: float

    def partition_sizes(self) -> np.ndarray:
        b = np.asarray(self.boundaries)
        return b[1:] - b[:-1]

    def owner_of(self, v: np.ndarray) -> np.ndarray:
        """Partition id owning each (global) vertex id."""
        return np.searchsorted(np.asarray(self.boundaries), v, side="right") - 1

    def local_id(self, v: np.ndarray, owner: np.ndarray | None = None) -> np.ndarray:
        owner = self.owner_of(v) if owner is None else owner
        return v - np.asarray(self.boundaries)[owner]

    def batch_of_local(self, v_local: np.ndarray) -> np.ndarray:
        return v_local // self.batch_size


def balanced_boundaries(out_deg: np.ndarray, in_deg: np.ndarray,
                        num_partitions: int, alpha: float) -> np.ndarray:
    """Range-partition vertices balancing alpha*|Vi| + |Ei_in| + |Ei_out|.

    Greedy sweep over the prefix-sum of per-vertex cost; each boundary is
    placed where the running cost crosses the next multiple of total/P.
    """
    n = out_deg.shape[0]
    p = num_partitions
    cost = alpha + out_deg.astype(np.float64) + in_deg.astype(np.float64)
    csum = np.concatenate([[0.0], np.cumsum(cost)])
    total = csum[-1]
    targets = total * np.arange(1, p) / p
    cuts = np.searchsorted(csum[1:], targets, side="left") + 1
    # Boundaries must be strictly increasing and inside [0, n]; fix degenerate
    # cuts (can happen for tiny graphs / huge P).
    bounds = [0]
    for c in cuts:
        bounds.append(int(min(max(c, bounds[-1] + 1), n - (p - len(bounds)))))
    bounds.append(n)
    return np.asarray(bounds, dtype=np.int64)


def choose_batch_size(v_max: int, *, vertex_bytes: int = 8,
                      num_threads: int = 8,
                      memory_budget: int | None = None,
                      min_batches_per_partition: int | None = None) -> int:
    """Paper §2.2 batch-size rule.

    Fully-out-of-core: batch vertex data * T  <  memory/2
      (here: batch vertex data < VMEM/2 per concurrently-processed block).
    Semi-out-of-core: at least 1.5*T batches per partition for load balance.
    """
    if memory_budget is not None:
        by_mem = max(1, memory_budget // (2 * num_threads * vertex_bytes))
        size = min(v_max, by_mem)
    else:
        size = v_max
    if min_batches_per_partition is None:
        min_batches_per_partition = max(1, int(1.5 * num_threads))
    by_balance = max(1, ceil_div(v_max, min_batches_per_partition))
    return max(1, min(size, by_balance))


def make_spec(graph: GraphData, num_partitions: int, *,
              alpha: float | None = None,
              batch_size: int | None = None,
              num_threads: int = 8,
              memory_budget: int | None = None) -> TwoLevelSpec:
    p = num_partitions
    if alpha is None:
        alpha = 2.0 * p - 1.0          # paper default
    out_deg = graph.out_degrees()
    in_deg = graph.in_degrees()
    bounds = balanced_boundaries(out_deg, in_deg, p, alpha)
    sizes = bounds[1:] - bounds[:-1]
    v_max = int(sizes.max())
    if batch_size is None:
        batch_size = choose_batch_size(
            v_max, num_threads=num_threads, memory_budget=memory_budget)
    num_batches = ceil_div(v_max, batch_size)
    return TwoLevelSpec(graph.num_vertices, p, tuple(int(b) for b in bounds),
                        v_max, batch_size, num_batches, alpha)


# ---------------------------------------------------------------------------
# Device-side distributed graph structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistGraph:
    """Padded, stacked two-level-partitioned graph.

    All arrays have leading axis P = num destination partitions.

    Edge storage (per destination partition q, incoming edges):
      edges sorted by (src_partition p, dst_batch k, dst, src); chunk (p, k)
      occupies edge slots chunk_ptr[q, p, k] : chunk_ptr[q, p, k + 1].
    """
    # --- per-edge, [P, E_max] ---
    edge_src_local: torch.Tensor  # int32, src local id within its partition
    edge_src_part: torch.Tensor   # int32, partition of source vertex
    edge_dst_local: torch.Tensor  # int32, dst local id within this partition
    edge_data: torch.Tensor       # float32 ([P, E_max]); ones if unweighted
    edge_valid: torch.Tensor      # bool, padding mask
    # --- chunk index, [P, P, B + 1] ---
    chunk_ptr: torch.Tensor       # int32 offsets into the edge arrays
    # --- per-vertex, [P, V_max] ---
    out_degree: torch.Tensor      # int32, global out-degree of local vertices
    vertex_valid: torch.Tensor    # bool, padding mask
    # --- message filtering (paper §4.3), stored on the *source* side ---
    need: torch.Tensor            # bool [P, P, V_max]; need[p, q, v]: v (local
    #                               in p) has >=1 out-edge into partition q
    # --- chunk statistics for format/dispatch decisions (constant arrays) ---
    chunk_nnz_src: torch.Tensor   # int32 [P, P, B] distinct srcs per chunk
    chunk_edges: torch.Tensor     # int32 [P, P, B] edges per chunk
    need_counts: torch.Tensor     # int32 [P, P]  |L_pq| need-list lengths
    # --- static metadata (hashable) ---
    spec: TwoLevelSpec
    e_max: int


    def to(self, device) -> "DistGraph":
        """The same graph with every tensor on ``device``."""
        return tensors_to(self, device)


def tensors_to(obj, device):
    """Copy of a dataclass of tensors with every tensor field on
    ``device`` (static fields carried over)."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _edge_order(n, p_cnt, b_cnt, dst, src, dst_batch, src_part, dst_part):
    """``np.lexsort((dst, src, dst_batch, src_part, dst_part))``: as one
    stable sort of a combined int64 key when the keys' ranges fit in 63
    bits (it sorts one array instead of five), else the lexsort itself."""
    if (p_cnt * p_cnt * max(b_cnt, 1)).bit_length() + 2 * max(
            n - 1, 1).bit_length() > 63:
        return np.lexsort((dst, src, dst_batch, src_part, dst_part))
    key = dst_part.astype(np.int64) * p_cnt + src_part
    key *= b_cnt
    key += dst_batch
    key *= n
    key += src
    key *= n
    key += dst
    return np.argsort(key, kind="stable")


def build_dist_graph(graph: GraphData, spec: TwoLevelSpec) -> DistGraph:
    """Host-side preprocessing: group edges into (src partition, dst batch)
    chunks per destination partition, build filter need-lists, pad + stack."""
    p_cnt = spec.num_partitions
    bounds = np.asarray(spec.boundaries)
    b_cnt = spec.num_batches
    v_max = spec.v_max

    src, dst = graph.src, graph.dst
    data = graph.data if graph.data is not None else np.ones_like(src, dtype=np.float32)

    src_part = spec.owner_of(src)
    dst_part = spec.owner_of(dst)
    src_local = (src - bounds[src_part]).astype(np.int64)
    dst_local = (dst - bounds[dst_part]).astype(np.int64)
    dst_batch = dst_local // spec.batch_size

    out_deg_g = graph.out_degrees()

    # Sort edges by (dst_partition, src_partition, dst_batch, src, dst):
    # column-oriented chunk order, CSR-by-source inside each chunk (so DCSR
    # (src, idx) seek ranges are contiguous; segment-reduce by dst does not
    # need dst-sorted order).
    order = _edge_order(graph.num_vertices, p_cnt, b_cnt, dst, src,
                        dst_batch, src_part, dst_part)
    src_part_s = src_part[order]
    dst_part_s = dst_part[order]
    src_local_s = src_local[order]
    dst_local_s = dst_local[order]
    dst_batch_s = dst_batch[order]
    data_s = data[order]

    per_q_counts = np.bincount(dst_part_s, minlength=p_cnt)
    e_max = int(per_q_counts.max()) if graph.num_edges else 1
    e_max = max(e_max, 1)

    edge_src_local = np.zeros((p_cnt, e_max), np.int32)
    edge_src_part = np.zeros((p_cnt, e_max), np.int32)
    edge_dst_local = np.zeros((p_cnt, e_max), np.int32)
    edge_data = np.zeros((p_cnt, e_max), np.float32)
    edge_valid = np.zeros((p_cnt, e_max), bool)
    chunk_ptr = np.zeros((p_cnt, p_cnt, b_cnt + 1), np.int32)
    chunk_nnz_src = np.zeros((p_cnt, p_cnt, b_cnt), np.int64)
    chunk_edges = np.zeros((p_cnt, p_cnt, b_cnt), np.int64)

    q_starts = np.concatenate([[0], np.cumsum(per_q_counts)])
    for q in range(p_cnt):
        lo, hi = q_starts[q], q_starts[q + 1]
        cnt = hi - lo
        edge_src_local[q, :cnt] = src_local_s[lo:hi]
        edge_src_part[q, :cnt] = src_part_s[lo:hi]
        edge_dst_local[q, :cnt] = dst_local_s[lo:hi]
        edge_data[q, :cnt] = data_s[lo:hi]
        edge_valid[q, :cnt] = True
        # chunk offsets: edges within q are sorted by (p, k).  Row p's B+1
        # boundaries overlap into the global cumulative array: the end of
        # (p, B-1) is the start of (p+1, 0).
        pk = src_part_s[lo:hi] * b_cnt + dst_batch_s[lo:hi]
        counts = np.bincount(pk, minlength=p_cnt * b_cnt).reshape(p_cnt, b_cnt)
        chunk_edges[q] = counts
        flat = np.concatenate([[0], np.cumsum(counts.ravel())]).astype(np.int32)
        idx = (np.arange(p_cnt)[:, None] * b_cnt
               + np.arange(b_cnt + 1)[None, :])
        chunk_ptr[q] = flat[idx]
        # distinct sources per chunk (for DCSR size / CSR inflate ratio)
        for p in range(p_cnt):
            for k in range(b_cnt):
                s, e = flat[p * b_cnt + k], flat[p * b_cnt + k + 1]
                if e > s:
                    chunk_nnz_src[q, p, k] = np.unique(src_local_s[lo + s:lo + e]).size

    # vertex-side arrays
    out_degree = np.zeros((p_cnt, v_max), np.int32)
    vertex_valid = np.zeros((p_cnt, v_max), bool)
    for p in range(p_cnt):
        n_p = bounds[p + 1] - bounds[p]
        out_degree[p, :n_p] = out_deg_g[bounds[p]:bounds[p + 1]]
        vertex_valid[p, :n_p] = True

    # need bitmaps (paper §4.3): need[p, q, v_local] — lives on source side
    need = np.zeros((p_cnt, p_cnt, v_max), bool)
    need[src_part, dst_part, src_local] = True
    need_counts = need.sum(axis=2).astype(np.int64)

    t = torch.from_numpy
    return DistGraph(
        edge_src_local=t(edge_src_local),
        edge_src_part=t(edge_src_part),
        edge_dst_local=t(edge_dst_local),
        edge_data=t(edge_data),
        edge_valid=t(edge_valid),
        chunk_ptr=t(chunk_ptr),
        out_degree=t(out_degree),
        vertex_valid=t(vertex_valid),
        need=t(need),
        chunk_nnz_src=t(chunk_nnz_src.astype(np.int32)),
        chunk_edges=t(chunk_edges.astype(np.int32)),
        need_counts=t(need_counts.astype(np.int32)),
        spec=spec,
        e_max=e_max,
    )


def row_block_batch_map(spec: TwoLevelSpec, tile: int) -> np.ndarray:
    """Static [R, B] bool map: tile row block r (rows r*T .. (r+1)*T - 1 of
    the padded destination axis) overlaps intra-node batch k.

    The block-CSR compute backend schedules tiles, the I/O model schedules
    (src partition, dst batch) chunks; this map translates runtime
    ``chunk_active`` into live tile rows.  When ``batch_size`` is a multiple
    of ``tile`` each row maps to exactly one batch (the intended layout);
    otherwise a row conservatively activates with any overlapping batch."""
    v_pad = ceil_div(spec.v_max, tile) * tile
    n_rows = v_pad // tile
    out = np.zeros((n_rows, spec.num_batches), bool)
    for r in range(n_rows):
        k_lo = (r * tile) // spec.batch_size
        k_hi = min((r * tile + tile - 1) // spec.batch_size,
                   spec.num_batches - 1)
        out[r, k_lo:k_hi + 1] = True
    return out


def scatter_vertex_values(spec: TwoLevelSpec, values: np.ndarray,
                          fill=0) -> np.ndarray:
    """Global [N] vertex values -> padded [P, V_max]."""
    out = np.full((spec.num_partitions, spec.v_max), fill,
                  dtype=values.dtype)
    b = np.asarray(spec.boundaries)
    for p in range(spec.num_partitions):
        out[p, :b[p + 1] - b[p]] = values[b[p]:b[p + 1]]
    return out


def gather_vertex_values(spec: TwoLevelSpec, padded) -> np.ndarray:
    """Padded [P, V_max] (numpy or a tensor on any device) -> global [N]
    vertex values."""
    if isinstance(padded, torch.Tensor):
        padded = padded.cpu().numpy()
    padded = np.asarray(padded)
    b = np.asarray(spec.boundaries)
    return np.concatenate([
        padded[p, :b[p + 1] - b[p]] for p in range(spec.num_partitions)])
