"""The paper's four evaluation algorithms (§5.1) on the signal/slot API,
mirroring Fig. 2b: one ProcessEdges per iteration plus ProcessVertices for
unconditional updates — the port of ``repro.core.algorithms`` with the
callbacks written in torch.  Each returns (final global vertex values as a
numpy array, iteration stats).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import ADD, MIN, Engine, accumulate_counters
from repro_torch.core.partition import gather_vertex_values

F32_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class RunStats:
    iterations: int
    counters: dict
    per_iter_return: list


def _finish(engine: Engine, values) -> np.ndarray:
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

def bfs(engine: Engine, source: int, max_iters: int = 10_000):
    """Level-synchronous BFS: parents push level+1; MIN monoid."""
    g = engine.graph
    gid = engine.global_id
    state = engine.init_state(
        level=torch.where(gid == source, 0.0, F32_MAX).to(torch.float32),
    )
    active = (gid == source) & g.vertex_valid
    counters, rets = {}, []
    it = 0
    while it < max_iters:
        state, active, updated, c = engine.process_edges(
            state,
            signal_fn=lambda s, gid: s["level"] + 1.0,
            slot_fn=lambda msg, data: msg,
            monoid=MIN,
            apply_fn=lambda s, agg, has, gid: (
                {"level": torch.minimum(s["level"], agg)},
                has & (agg < s["level"]),
                (agg < s["level"]).to(torch.float32)),
            active=active,
        )
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
