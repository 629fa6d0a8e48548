"""Elastic scaling: re-plan the mesh from the live ranks and reshard the
latest checkpoint onto it; the port's copy of ``repro.runtime.elastic``.

Design for 1000+ nodes: the TP ('model') axis is sacred — losing a rank
inside a model-parallel group invalidates the whole group — so elasticity
shrinks the DP/FSDP ('data' x 'pod') product and idles the remainder of a
partial group.  Checkpoints are stored logically unsharded (content-
addressed blocks, ``repro_torch.ckpt``), so resharding is a placement
under the new rules: no all-to-all shuffling of old shards, the block
store is the exchange medium.  This mirrors the paper's recovery
contract: progress lost is at most one step, capacity lost is only the
failed group.  :func:`plan_worker_recovery` is the process-mode dist_ooc
twin: it re-plans logical workers onto the live ranks after a failure.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.sharding.rules import place


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


def make_mesh_from_plan(plan: MeshPlan, ranks: Optional[Sequence] = None, *,
                        device=None):
    """A ``DeviceMesh`` over the first ``plan.used_devices`` of ``ranks``
    (the default group's ranks in order when None).  Every rank of the
    default group calls it; the idle ones join the group creation and
    hold nothing."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    return make_device_mesh(plan.shape, plan.axis_names,
                            ranks=ranks[:plan.used_devices], device=device)


def elastic_restart(ckpt_dir: str, template_state, *, available: int,
                    model_axis: int, rules_factory, ranks=None, device=None):
    """Restore the latest checkpoint and place it on a freshly planned mesh.

    rules_factory(mesh) -> (ShardingRules, state_shardings tree of
    ``(mesh, placements)``, as ``ShardingRules.tree_shardings`` gives).
    Every rank of the default group calls it.  Returns (step,
    state_on_new_mesh, mesh, plan); an idle rank (outside the mesh) reads
    no state and gets None for it."""
    plan = plan_elastic_mesh(available, model=model_axis)
    mesh = make_mesh_from_plan(plan, ranks, device=device)
    mgr = CheckpointManager(ckpt_dir)
    if mesh.get_coordinate() is None:
        steps = mgr.store.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        return max(steps), None, mesh, plan
    got = mgr.restore_into(template_state)
    if got is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step, state = got
    rules, state_sh = rules_factory(mesh)
    return step, place(state, state_sh), mesh, plan
