"""Elastic re-planning — the numpy half of ``repro.runtime.elastic``.

:func:`plan_worker_recovery` re-plans process-mode dist_ooc's logical
workers onto the live ranks after a failure; :func:`plan_elastic_mesh`
plans the largest mesh with the model axis intact.  Placing a restored
training state on a device mesh (the reference's ``make_mesh_from_plan``
and ``elastic_restart``) belongs with the LM stack and is not here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axis_names: tuple
    used_devices: int
    idle_devices: int
    notes: tuple


def plan_elastic_mesh(available: int, *, model: int = 16,
                      pods: Optional[int] = None) -> MeshPlan:
    """Largest ('data', 'model') (or ('pod', 'data', 'model')) mesh with the
    model axis intact that fits in ``available`` devices."""
    if available < model:
        raise ValueError(
            f"cannot keep a {model}-wide model axis with only {available} "
            f"devices")
    notes = []
    if pods and pods > 1:
        data = available // (model * pods)
        if data < 1:
            notes.append(f"pod axis collapsed: {available} devices cannot "
                         f"fill {pods} pods")
            pods = 1
            data = available // model
        shape = (pods, data, model)
        names = ("pod", "data", "model")
    else:
        data = available // model
        shape = (data, model)
        names = ("data", "model")
    used = int(np.prod(shape))
    if used < available:
        notes.append(f"{available - used} devices idle (partial DP group)")
    return MeshPlan(shape, names, used, available - used, tuple(notes))


def plan_worker_recovery(live_ranks: Sequence[int], num_workers: int,
                         prev: Sequence[int]) -> list:
    """Deterministic logical-worker -> physical-rank re-plan after a
    failure.

    ``prev[w]`` is the rank that owned logical worker ``w`` before the
    failure; ``live_ranks`` is the agreed post-consensus live set.  Workers
    whose rank survived keep their assignment; each orphaned worker
    (ascending w) is adopted by the live rank owning the fewest workers,
    ties to the lowest rank.  Every survivor derives the same plan from the
    agreed live set alone, so they agree on who re-opens the dead rank's
    shards and spills without a coordinator (DESIGN.md §13).  W never
    changes: it keys the wire pricing and the spill layout, so recovery
    moves ownership, not shape."""
    live = sorted({int(r) for r in live_ranks})
    if not live:
        raise ValueError("no live ranks to plan recovery onto")
    assign = [int(prev[w]) for w in range(num_workers)]
    loads = {r: 0 for r in live}
    for r in assign:
        if r in loads:
            loads[r] += 1
    for w in range(num_workers):
        if assign[w] not in loads:
            r = min(live, key=lambda x: (loads[x], x))
            assign[w] = r
            loads[r] += 1
    return assign
