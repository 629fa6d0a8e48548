"""The paper's four evaluation algorithms (§5.1) on the signal/slot API,
mirroring Fig. 2b: one ProcessEdges per iteration plus ProcessVertices for
unconditional updates — the port of ``repro.core.algorithms`` with the
callbacks written in torch.  Each returns (final global vertex values as a
numpy array, iteration stats).  The multi-query algorithms (multi-source
BFS, personalized PageRank, pairwise reachability) serve Q queries per
pass on ``Engine.process_edges_multi`` (DESIGN.md §11).

On a mesh engine every rank runs the same loop on its own rows: the
frontier goes on the rank's row as the reference puts it on the sharding
(``engine.shard``), loops stop on the mesh-summed ``updated`` (so every
rank stops together), and every rank returns the same full result,
gathered once at the end (``engine.gather``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import ADD, MIN, Engine, accumulate_counters
from repro_torch.core.formats import _np
from repro_torch.core.partition import gather_vertex_values

F32_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class RunStats:
    iterations: int
    counters: dict
    per_iter_return: list


def _finish(engine: Engine, values) -> np.ndarray:
    if engine._distributed:
        values = engine.gather(values)
    return gather_vertex_values(engine.graph.spec, values)


# ---------------------------------------------------------------------------
# PageRank
# ---------------------------------------------------------------------------

def pagerank(engine: Engine, num_iters: int = 5, damping: float = 0.85):
    """Five power iterations by default, as in the paper's PR runs.

    signal: rank / out_degree;  slot: sum;  ProcessVertices applies the
    damping update to *every* vertex (vertices with no in-messages get the
    teleport term)."""
    g = engine.graph
    n = g.spec.num_vertices
    outdeg = torch.clamp(g.out_degree, min=1).to(torch.float32)
    state = engine.init_state(
        rank=torch.full_like(g.out_degree, 1.0 / n, dtype=torch.float32),
        acc=torch.zeros_like(g.out_degree, dtype=torch.float32),
        outdeg=outdeg,
    )
    counters, rets = {}, []
    for _ in range(num_iters):
        state, _, _, c = engine.process_edges(
            state,
            signal_fn=lambda s, gid: s["rank"] / s["outdeg"],
            slot_fn=lambda msg, data: msg,
            monoid=ADD,
            apply_fn=lambda s, agg, has, gid: ({"acc": agg}, has & False, agg),
        )
        counters = accumulate_counters(counters, c)
        state, tot, c2 = engine.process_vertices(
            state,
            work_fn=lambda s, gid: (
                {"rank": (1.0 - damping) / n + damping * s["acc"],
                 "acc": torch.zeros_like(s["acc"])},
                torch.abs(s["rank"])),
        )
        counters = accumulate_counters(counters, c2)
        rets.append(float(tot))
    return _finish(engine, state["rank"]), RunStats(num_iters, counters, rets)


# ---------------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------------

def bfs_callbacks():
    """The BFS step of :func:`bfs`, shared by :func:`multi_bfs` and the
    serving session."""
    return dict(
        signal_fn=lambda s, gid: s["level"] + 1.0,
        slot_fn=lambda msg, data: msg,
        monoid=MIN,
        apply_fn=lambda s, agg, has, gid: (
            {"level": torch.minimum(s["level"], agg)},
            has & (agg < s["level"]),
            (agg < s["level"]).to(torch.float32)))


def bfs(engine: Engine, source: int, max_iters: int = 10_000):
    """Level-synchronous BFS: parents push level+1; MIN monoid."""
    g = engine.graph
    gid = engine.global_id
    state = engine.init_state(
        level=torch.where(gid == source, 0.0, F32_MAX).to(torch.float32),
    )
    active = (gid == source) & g.vertex_valid
    if engine._distributed:
        active = engine.shard(active)
    counters, rets = {}, []
    it = 0
    while it < max_iters:
        state, active, updated, c = engine.process_edges(
            state, active=active, **bfs_callbacks())
        counters = accumulate_counters(counters, c)
        rets.append(float(updated))
        it += 1
        if float(updated) == 0.0:
            break
    return _finish(engine, state["level"]), RunStats(it, counters, rets)


# ---------------------------------------------------------------------------
# WCC (weakly connected components via label propagation on both directions)
# ---------------------------------------------------------------------------

def wcc(engine: Engine, engine_rev: Engine | None = None,
        max_iters: int = 10_000):
    """Minimum-label propagation.  For *weak* connectivity labels must flow
    both ways; the paper runs ProcessEdges on the reversed graph for that
    (footnote 4).  Pass ``engine_rev`` built on ``graph.reversed()``; vertex
    state is shared between the two engines (same spec, same device)."""
    gid = engine.global_id
    state = engine.init_state(label=gid.to(torch.float32))
    active = None  # all vertices start active
    counters, rets = {}, []
    it = 0
    engines = [engine] if engine_rev is None else [engine, engine_rev]
    while it < max_iters:
        updated_total = 0.0
        new_actives = []
        for eng in engines:
            state, act, updated, c = eng.process_edges(
                state,
                signal_fn=lambda s, gid: s["label"],
                slot_fn=lambda msg, data: msg,
                monoid=MIN,
                apply_fn=lambda s, agg, has, gid: (
                    {"label": torch.minimum(s["label"], agg)},
                    has & (agg < s["label"]),
                    (agg < s["label"]).to(torch.float32)),
                active=active,
            )
            counters = accumulate_counters(counters, c)
            updated_total += float(updated)
            new_actives.append(act)
        active = new_actives[0]
        for a in new_actives[1:]:
            active = active | a
        rets.append(updated_total)
        it += 1
        if updated_total == 0.0:
            break
    return _finish(engine, state["label"]), RunStats(it, counters, rets)


# ---------------------------------------------------------------------------
# SSSP
# ---------------------------------------------------------------------------

def sssp(engine: Engine, source: int, max_iters: int = 10_000):
    """Bellman-Ford-style push (Fig. 2b): signal dist, slot msg + weight,
    MIN monoid."""
    g = engine.graph
    gid = engine.global_id
    state = engine.init_state(
        dist=torch.where(gid == source, 0.0, F32_MAX / 4).to(torch.float32),
    )
    active = (gid == source) & g.vertex_valid
    if engine._distributed:
        active = engine.shard(active)
    counters, rets = {}, []
    it = 0
    while it < max_iters:
        state, active, updated, c = engine.process_edges(
            state,
            signal_fn=lambda s, gid: s["dist"],
            slot_fn=lambda msg, data: msg + data,
            monoid=MIN,
            apply_fn=lambda s, agg, has, gid: (
                {"dist": torch.minimum(s["dist"], agg)},
                has & (agg < s["dist"]),
                (agg < s["dist"]).to(torch.float32)),
            active=active,
        )
        counters = accumulate_counters(counters, c)
        rets.append(float(updated))
        it += 1
        if float(updated) == 0.0:
            break
    return _finish(engine, state["dist"]), RunStats(it, counters, rets)


# ---------------------------------------------------------------------------
# Multi-query algorithms (DESIGN.md §11): Q concurrent queries, one pass
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MultiRunStats:
    iterations: list          # per-query ProcessEdges calls while alive
    counters: dict
    per_iter_return: list     # [Q] return vector per batched iteration


def _gather_panel(engine: Engine, panel) -> np.ndarray:
    """[P, V, Q] panel (tensor or array; on a mesh, this rank's row,
    gathered here) -> [n, Q] global values."""
    arr = engine.gather(panel) if engine._distributed else _np(panel)
    return np.stack([gather_vertex_values(engine.graph.spec, arr[:, :, j])
                     for j in range(arr.shape[-1])], axis=1)


def multi_bfs(engine: Engine, sources, max_iters: int = 10_000):
    """Q simultaneous BFS queries through one selective pass per level.

    ``sources`` lists one source per query (len == num_queries).  Each
    query's level column and iteration count are bit-identical to the
    solo :func:`bfs` from that source; a query whose frontier dies stops
    being counted (and, on OOC, stops costing bytes) while the batch keeps
    iterating for the others."""
    g = engine.graph
    nq = engine.config.num_queries
    if len(sources) != nq:
        raise ValueError(f"multi_bfs needs one source per query: got "
                         f"{len(sources)} sources for num_queries={nq}")
    gid = engine.global_id
    srcs = torch.as_tensor(np.asarray(sources, np.int32), device=gid.device)
    hit = gid[..., None] == srcs                                 # [P, V, Q]
    state = engine.init_state(
        level=torch.where(hit, 0.0, F32_MAX).to(torch.float32))
    active = hit & g.vertex_valid[..., None]
    if engine._distributed:
        active = engine.shard(active)
    counters, rets = {}, []
    iters = [0] * nq
    alive = [True] * nq
    it = 0
    while any(alive) and it < max_iters:
        state, active, updated, c = engine.process_edges_multi(
            state, active=active, **bfs_callbacks())
        counters = accumulate_counters(counters, c)
        updated = _np(updated).astype(np.float64)
        rets.append(updated)
        for j in range(nq):
            if alive[j]:
                iters[j] += 1
                if float(updated[j]) == 0.0:
                    alive[j] = False
        it += 1
    return (_gather_panel(engine, state["level"]),
            MultiRunStats(iters, counters, rets))


def personalized_pagerank(engine: Engine, sources, num_iters: int = 5,
                          damping: float = 0.85):
    """Q personalized PageRank queries (teleport to each query's source)
    in one batched power iteration: rank_0 = e_s and
    rank <- (1 - d) * e_s + d * A^T D^{-1} rank per query column.  The
    teleport indicator rides in the state panel (``tele``), so the
    unchanged single-query callbacks stay per query."""
    g = engine.graph
    nq = engine.config.num_queries
    if len(sources) != nq:
        raise ValueError(f"personalized_pagerank needs one source per "
                         f"query: got {len(sources)} sources for "
                         f"num_queries={nq}")
    gid = engine.global_id
    srcs = torch.as_tensor(np.asarray(sources, np.int32), device=gid.device)
    tele = (gid[..., None] == srcs).to(torch.float32)            # [P, V, Q]
    outdeg = torch.clamp(g.out_degree, min=1).to(torch.float32)
    state = engine.init_state(
        rank=tele, acc=torch.zeros_like(tele), tele=tele,
        outdeg=outdeg[..., None].expand(tele.shape).contiguous())
    counters, rets = {}, []
    for _ in range(num_iters):
        state, _, _, c = engine.process_edges_multi(
            state,
            signal_fn=lambda s, gid: s["rank"] / s["outdeg"],
            slot_fn=lambda msg, data: msg,
            monoid=ADD,
            apply_fn=lambda s, agg, has, gid: ({"acc": agg}, has & False,
                                               agg),
        )
        counters = accumulate_counters(counters, c)
        state, tot, c2 = engine.process_vertices_multi(
            state,
            work_fn=lambda s, gid: (
                {"rank": (1.0 - damping) * s["tele"] + damping * s["acc"],
                 "acc": torch.zeros_like(s["acc"])},
                torch.abs(s["rank"])),
        )
        counters = accumulate_counters(counters, c2)
        rets.append(_np(tot).astype(np.float64))
    return (_gather_panel(engine, state["rank"]),
            MultiRunStats([num_iters] * nq, counters, rets))


def pairwise_reachability(engine: Engine, pairs):
    """Q reachability queries (src_j -> dst_j?) as one multi-source BFS
    batch; returns (bool [Q], the batch's stats)."""
    levels, stats = multi_bfs(engine, [s for s, _ in pairs])
    reachable = np.array([levels[d, j] < np.float32(F32_MAX)
                          for j, (_, d) in enumerate(pairs)])
    return reachable, stats


# ---------------------------------------------------------------------------
# Pure-numpy oracles (for tests and validation), copied from the reference
# ---------------------------------------------------------------------------

def ref_pagerank(n, src, dst, num_iters=5, damping=0.85):
    rank = np.full(n, 1.0 / n, np.float64)
    outdeg = np.maximum(np.bincount(src, minlength=n), 1)
    for _ in range(num_iters):
        contrib = rank[src] / outdeg[src]
        acc = np.zeros(n, np.float64)
        np.add.at(acc, dst, contrib)
        rank = (1 - damping) / n + damping * acc
    return rank


def ref_ppr(n, src, dst, source, num_iters=5, damping=0.85):
    tele = np.zeros(n, np.float64)
    tele[source] = 1.0
    rank = tele.copy()
    outdeg = np.maximum(np.bincount(src, minlength=n), 1)
    for _ in range(num_iters):
        contrib = rank[src] / outdeg[src]
        acc = np.zeros(n, np.float64)
        np.add.at(acc, dst, contrib)
        rank = (1 - damping) * tele + damping * acc
    return rank


def ref_bfs(n, src, dst, source):
    inf = np.float32(np.finfo(np.float32).max)
    level = np.full(n, inf, np.float32)
    level[source] = 0
    frontier = np.array([source])
    d = 0
    # CSR for speed
    order = np.argsort(src, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    starts = np.searchsorted(s_sorted, np.arange(n + 1))
    while frontier.size:
        d += 1
        nxt = []
        for v in frontier:
            nbrs = d_sorted[starts[v]:starts[v + 1]]
            new = nbrs[level[nbrs] > d]
            level[new] = d
            nxt.append(np.unique(new))
        frontier = np.unique(np.concatenate(nxt)) if nxt else np.array([], np.int64)
    return level


def ref_sssp(n, src, dst, w, source):
    inf = np.float64(np.finfo(np.float32).max / 4)
    dist = np.full(n, inf, np.float64)
    dist[source] = 0.0
    for _ in range(n):
        nd = dist.copy()
        relax = dist[src] + w
        np.minimum.at(nd, dst, relax)
        if np.allclose(nd, dist):
            break
        dist = nd
    return dist


def ref_wcc(n, src, dst):
    label = np.arange(n, dtype=np.int64)
    changed = True
    while changed:
        changed = False
        for s, d in ((src, dst), (dst, src)):
            nl = label.copy()
            np.minimum.at(nl, d, label[s])
            if not np.array_equal(nl, label):
                label = nl
                changed = True
    return label
