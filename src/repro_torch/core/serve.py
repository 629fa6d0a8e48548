"""Continuous multi-query serving on the Q-panel engine (DESIGN.md §11) —
the port of ``repro.core.serve``.

A fixed number of in-flight slots (= ``EngineConfig.num_queries``), an
admission queue, and ONE batched step that advances every in-flight query
at once.  Queries submitted while a batch is streaming join at the next
iteration boundary (a free slot is required — convergence frees slots);
each query's result streams out the iteration its own frontier dies,
while the batch keeps iterating for the rest.

The served workload is multi-source BFS (the paper's traversal kernel);
the amortization is the engine's: every step pays one union-frontier
chunk stream for however many queries are in flight.

Slot admission writes new columns into the state panel, which breaks the
engine's returned-state identity — on the ooc executor the next step
re-loads the spill as an unmeasured preprocessing sync (the same contract
as handing any caller-constructed state to the engine).

On a mesh engine every rank runs the same session (the same submits, in
the same order): the panels are the rank's [1, V, Q] rows, every rank
sees the same mesh-summed ``updated`` and so retires the same queries,
and a step that retires any gathers the level panel once.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.algorithms import F32_MAX, bfs_callbacks
from repro_torch.core.engine import Engine, accumulate_counters
from repro_torch.core.formats import _np
from repro_torch.core.partition import gather_vertex_values


@dataclasses.dataclass
class QueryResult:
    """One served query: BFS levels plus its latency decomposition."""
    qid: int
    source: int
    levels: np.ndarray        # [n] global levels (float32 max = unreached)
    wait_iters: int           # batched iterations spent in the queue
    run_iters: int            # ProcessEdges calls while occupying a slot
    wall_s: float             # submit -> convergence wall clock


class GraphServeSession:
    """Q-slot concurrent BFS server over one :class:`Engine`.

    ``submit`` enqueues a source vertex and returns a query id; ``step``
    admits queued queries into free slots, runs one batched ProcessEdges
    over the union frontier, and returns the :class:`QueryResult` records
    of every query that converged this iteration.  ``drain`` steps until
    nothing is in flight."""

    def __init__(self, engine: Engine, max_iters: int = 10_000):
        self.engine = engine
        self.slots = engine.config.num_queries
        self.max_iters = max_iters
        spec = engine.graph.spec
        self._spec = spec
        self._gid = _np(engine.global_id)
        self._valid = _np(engine.graph.vertex_valid)
        if engine._distributed:              # this rank's rows only
            r = engine.mesh.rank
            self._gid, self._valid = self._gid[r:r + 1], self._valid[r:r + 1]
        shape = self._gid.shape + (self.slots,)
        self._state = {"level": np.full(shape, F32_MAX, np.float32)}
        self._active = np.zeros(shape, bool)
        self._slot_qid: list = [None] * self.slots
        self._pending: deque = deque()
        self._meta: dict = {}
        self._next_qid = 0
        self.counters: dict = {}
        self.steps = 0

    # -- admission ----------------------------------------------------------
    def submit(self, source: int) -> int:
        qid = self._next_qid
        self._next_qid += 1
        self._pending.append(qid)
        self._meta[qid] = dict(source=int(source), t0=time.perf_counter(),
                               wait=0, run=0)
        return qid

    @property
    def in_flight(self) -> int:
        return (sum(q is not None for q in self._slot_qid)
                + len(self._pending))

    def _admit(self) -> None:
        free = [j for j in range(self.slots) if self._slot_qid[j] is None]
        if not free or not self._pending:
            return
        # Copy-on-admit: the engine recognizes its own returned panels by
        # identity, so slot writes go to fresh arrays.
        level = np.array(_np(self._state["level"]), np.float32)
        active = np.array(_np(self._active), bool)
        for j in free:
            if not self._pending:
                break
            qid = self._pending.popleft()
            hit = (self._gid == self._meta[qid]["source"]) & self._valid
            level[:, :, j] = np.where(hit, 0.0, F32_MAX)
            active[:, :, j] = hit
            self._slot_qid[j] = qid
        self._state = {"level": level}
        self._active = active

    # -- batched iteration --------------------------------------------------
    def step(self) -> list:
        self._admit()
        if all(q is None for q in self._slot_qid):
            return []
        state, active, updated, c = self.engine.process_edges_multi(
            self._state, active=self._active, **bfs_callbacks())
        self._state, self._active = state, active
        self.counters = accumulate_counters(self.counters, c)
        self.steps += 1
        updated = _np(updated).astype(np.float64)

        done = []
        levels_panel = None
        for j in range(self.slots):
            qid = self._slot_qid[j]
            if qid is None:
                continue
            meta = self._meta[qid]
            meta["run"] += 1
            if float(updated[j]) == 0.0 or meta["run"] >= self.max_iters:
                if levels_panel is None:
                    levels_panel = (self.engine.gather(state["level"])
                                    if self.engine._distributed
                                    else _np(state["level"]))
                done.append(QueryResult(
                    qid=qid, source=meta["source"],
                    levels=gather_vertex_values(self._spec,
                                                levels_panel[:, :, j]),
                    wait_iters=meta["wait"], run_iters=meta["run"],
                    wall_s=time.perf_counter() - meta["t0"]))
                self._slot_qid[j] = None
                del self._meta[qid]
        for qid in self._pending:
            self._meta[qid]["wait"] += 1
        return done

    def drain(self) -> list:
        out = []
        while self.in_flight:
            out.extend(self.step())
        return out
