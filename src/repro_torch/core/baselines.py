"""Baseline engines the paper compares against (§5.2, §5.3, Fig. 5).

These are *behaviourally faithful* re-implementations of the competing
systems' I/O and communication patterns, producing identical algorithm
results (same monoid semantics) while accounting I/O/traffic the way those
systems incur it:

* ``ChaosLikeEngine`` — edge-centric GAS à la Chaos/X-Stream: every iteration
  *streams all edges* (no per-vertex index → edge I/O ∝ |E| regardless of the
  active set) and emits **one update per edge** with an active source (no
  source-side message combining → traffic ∝ active out-edges).  Edges are
  hash-striped across nodes; an update whose destination vertex lives on a
  different node crosses the network.  This is why the paper measures
  DFOGraph sending only 1.9% of Chaos's messages (Fig. 5): DFOGraph sends one
  message per (active vertex, needed partition), Chaos one per active edge.

* ``GridLikeEngine`` — GridGraph's 2-level hierarchical grid on one machine:
  edges in Q×Q blocks, streamed block-by-block with dual sliding windows;
  vertex data accessed through memory-mapped arrays, so every pass over a
  block column re-reads the source vertex window (the paper's §1.1 point:
  excessive page swaps when memory is insufficient).  Selective scheduling
  skips blocks with no active source (GridGraph does support this).

Both run on one device (``"cuda"`` unless the caller passes ``device``)
with global [N] vertex arrays; the comparison axes are the modeled I/O /
traffic counters and wall-clock on the same host.

The folds mirror the reference's segment ops: a MIN destination with no
in-edge keeps the identity ``+inf`` (``scatter_reduce_`` with
``include_self`` on a buffer filled with it), an inactive edge offers
``finfo(float32).max``.  Chaos's counts are exact integers (the reference
sums them in float32, which rounds past 2^24 active edges a step).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.graphs import GraphData
from repro_torch.utils import resolve_device

UPDATE_BYTES = 12     # Chaos update record: (dst, value) + header, X-Stream-ish
EDGE_BYTES = 8
F32_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class BaselineCounters:
    edge_read_bytes: float = 0.0
    vertex_read_bytes: float = 0.0
    vertex_write_bytes: float = 0.0
    net_bytes: float = 0.0
    updates_generated: float = 0.0
    messages_sent: float = 0.0

    def add(self, **kw):
        for k, v in kw.items():
            setattr(self, k, getattr(self, k) + float(v))

    def as_dict(self):
        return dataclasses.asdict(self)


def _edges_to(graph: GraphData, dev):
    """(src, dst, data) of ``graph`` on ``dev`` (int64 indices, float32
    data: all ones when the graph has none)."""
    src = torch.as_tensor(graph.src, device=dev).long()
    dst = torch.as_tensor(graph.dst, device=dev).long()
    data = (torch.as_tensor(graph.data, device=dev).float()
            if graph.data is not None
            else torch.ones(graph.num_edges, dtype=torch.float32, device=dev))
    return src, dst, data


def _fold(msg, act_e, dst, n, monoid: str):
    """The gather phase: (agg, has) per destination, as the reference's
    segment_sum / segment_min / segment_max."""
    if monoid == "add":
        agg = torch.zeros(n, dtype=msg.dtype, device=msg.device)
        agg.index_add_(0, dst, torch.where(act_e, msg, 0.0))
    else:
        agg = torch.full((n,), float("inf"), dtype=msg.dtype,
                         device=msg.device)
        agg.scatter_reduce_(0, dst, torch.where(act_e, msg, F32_MAX),
                            "amin", include_self=True)
    has = torch.zeros(n, dtype=torch.bool, device=msg.device)
    has[dst[act_e]] = True
    return agg, has


def _outdeg(src, n):
    deg = torch.zeros(n, dtype=torch.float32, device=src.device)
    deg.index_add_(0, src, torch.ones(src.shape[0], dtype=torch.float32,
                                      device=src.device))
    return torch.clamp(deg, min=1.0)


def _point(n, source, hit, miss, dev):
    idx = torch.arange(n, device=dev)
    return (torch.where(idx == source, hit, miss).to(torch.float32),
            idx == source)


class ChaosLikeEngine:
    """Edge-centric streaming over hash-striped edge partitions."""

    def __init__(self, graph: GraphData, num_nodes: int, device=None):
        self.device = dev = resolve_device(device)
        self.n = graph.num_vertices
        self.num_nodes = num_nodes
        self.src, self.dst, self.data = _edges_to(graph, dev)
        # Chaos stripes edges uniformly; vertices are hashed across nodes.
        e = graph.num_edges
        edge_node = (torch.arange(e, dtype=torch.int64, device=dev)
                     * num_nodes) // max(e, 1)
        vertex_node = torch.arange(self.n, device=dev) % num_nodes
        self.cross = edge_node != vertex_node[self.dst]   # remote update

    def _step(self, values, active, slot_add_data: bool, monoid: str):
        """One edge-centric scatter+gather: (agg, has, counters)."""
        msg = values[self.src]                  # value of source, per edge
        if slot_add_data:
            msg = msg + self.data
        act_e = active[self.src]
        agg, has = _fold(msg, act_e, self.dst, self.n, monoid)
        updates = torch.count_nonzero(act_e)
        remote = torch.count_nonzero(act_e & self.cross)
        counters = dict(
            edge_read_bytes=self.src.shape[0] * EDGE_BYTES,
            updates_generated=updates,
            messages_sent=updates,
            net_bytes=remote * UPDATE_BYTES,
            vertex_read_bytes=self.n * 4,
            vertex_write_bytes=self.n * 4,
        )
        return agg, has, counters

    @staticmethod
    def _account(counters: BaselineCounters, c: dict) -> None:
        # one device-to-host copy for the step's two counts
        counts = torch.stack([c["updates_generated"],
                              c["net_bytes"]]).tolist()
        c = dict(c, updates_generated=counts[0], messages_sent=counts[0],
                 net_bytes=counts[1])
        counters.add(**c)

    def run_pagerank(self, num_iters=5, damping=0.85):
        n, dev = self.n, self.device
        outdeg = _outdeg(self.src, n)
        rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        counters = BaselineCounters()
        for _ in range(num_iters):
            agg, has, c = self._step(rank / outdeg, active, False, "add")
            self._account(counters, c)
            rank = (1 - damping) / n + damping * agg
        return rank.cpu().numpy(), counters

    def _relax(self, values, active, offset, slot_add_data, max_iters):
        counters = BaselineCounters()
        it = 0
        while it < max_iters:
            agg, has, c = self._step(values + offset, active, slot_add_data,
                                     "min")
            self._account(counters, c)
            improved = has & (agg < values)
            values = torch.minimum(values, agg)
            active = improved
            it += 1
            if not bool(improved.any()):
                break
        return values.cpu().numpy(), counters, it

    def run_sssp(self, source, max_iters=10_000):
        dist, active = _point(self.n, source, 0.0, F32_MAX / 4, self.device)
        return self._relax(dist, active, 0.0, True, max_iters)

    def run_bfs(self, source, max_iters=10_000):
        level, active = _point(self.n, source, 0.0, F32_MAX, self.device)
        return self._relax(level, active, 1.0, False, max_iters)


class GridLikeEngine:
    """GridGraph-style 2-level grid, single machine, with mmap-style vertex
    I/O accounting.  ``memory_budget`` (bytes) models available RAM for the
    vertex windows: when a source/destination window exceeds the resident
    budget, each block pass re-reads it (page-swap behaviour the paper
    demonstrates in Table 6 / §1.1)."""

    def __init__(self, graph: GraphData, grid: int,
                 memory_budget: float = float("inf"), device=None):
        self.device = dev = resolve_device(device)
        self.n = graph.num_vertices
        self.q = grid
        self.memory_budget = memory_budget
        rng_size = -(-self.n // grid)
        self.rng_size = rng_size
        src, dst, data = _edges_to(graph, dev)
        # the reference's lexsort by (src block, dst block, src, dst), ties
        # in input order: a stable sort by (src, dst), then a stable sort
        # of the block ids in that order
        blk = (src // rng_size) * grid + dst // rng_size
        order = torch.sort(src * self.n + dst, stable=True).indices
        order = order[torch.sort(blk[order], stable=True).indices]
        self.src, self.dst, self.data = src[order], dst[order], data[order]
        self.blk = blk[order]
        counts = torch.bincount(self.blk, minlength=grid * grid).cpu().numpy()
        self.block_ptr = np.concatenate([[0], np.cumsum(counts)])

    def _step(self, values, active, slot_add_data: bool, monoid: str):
        """(agg, has, blk_active): blk_active flags the blocks holding an
        edge with an active source (selective scheduling)."""
        msg = values[self.src]
        if slot_add_data:
            msg = msg + self.data
        act_e = active[self.src]
        agg, has = _fold(msg, act_e, self.dst, self.n, monoid)
        blk_active = torch.zeros(self.q * self.q, dtype=torch.bool,
                                 device=self.device)
        blk_active[self.blk[act_e]] = True
        return agg, has, blk_active

    def _account(self, counters: BaselineCounters, blk_active) -> None:
        """Edge and vertex-window bytes of one pass: one device-to-host copy
        of the q x q block flags."""
        blk_active = blk_active.cpu().numpy().reshape(self.q, self.q)
        sizes = np.diff(self.block_ptr).reshape(self.q, self.q)
        edge_bytes = int(sizes[blk_active].sum()) * EDGE_BYTES
        # vertex window I/O: per active block, source window read; dest
        # window read+write once per block column.  If both windows fit in
        # the budget they are read once per iteration instead (page cache).
        win_bytes = self.rng_size * 4
        windows_needed = 2 * win_bytes
        if windows_needed <= self.memory_budget:
            active_cols = blk_active.any(axis=0).sum()
            active_rows = blk_active.any(axis=1).sum()
            vr = (active_rows + active_cols) * win_bytes
            vw = active_cols * win_bytes
        else:  # thrash: every active block re-reads both windows
            vr = 2 * blk_active.sum() * win_bytes
            vw = blk_active.sum() * win_bytes
        counters.add(edge_read_bytes=edge_bytes, vertex_read_bytes=vr,
                     vertex_write_bytes=vw)

    def run_pagerank(self, num_iters=5, damping=0.85):
        n, dev = self.n, self.device
        outdeg = _outdeg(self.src, n)
        rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        counters = BaselineCounters()
        for _ in range(num_iters):
            agg, has, blk = self._step(rank / outdeg, active, False, "add")
            self._account(counters, blk)
            rank = (1 - damping) / n + damping * agg
        return rank.cpu().numpy(), counters

    def run_sssp(self, source, max_iters=10_000):
        dist, active = _point(self.n, source, 0.0, F32_MAX / 4, self.device)
        counters = BaselineCounters()
        it = 0
        while it < max_iters:
            agg, has, blk = self._step(dist, active, True, "min")
            self._account(counters, blk)
            improved = has & (agg < dist)
            dist = torch.minimum(dist, agg)
            active = improved
            it += 1
            if not bool(improved.any()):
                break
        return dist.cpu().numpy(), counters, it
