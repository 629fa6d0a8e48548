"""Fault injection on the port's process-mode DIST_OOC (DESIGN.md §13),
mirroring ``tests/test_fault_injection.py`` with port ranks on the CPU.

The invariant: **a recovered run is bit-identical to a failure-free
one** — values, iterations, per-iteration returns, every counter (the
``measured == model`` audit included) and per-worker totals all equal the
port's thread-mode run.

* **Plans** — ``FaultPlan`` JSON is the reference's text, each package
  reads the other's, and the constructors validate alike.
* **Kill matrix** — a rank exits hard at a chosen ProcessEdges call and
  phase (start / send / recv / apply); survivors agree on the death,
  re-plan ownership, restore the dead rank's spill from the per-op
  checkpoint and replay the op.
* **Drop / corrupt wire** — redelivered from the sender's ledger, no
  recovery epoch.  **Delay** — merged late through the slot monoid; only
  the fixpoint is asserted, and ADD refuses delays.
* **Corrupt disk** — a flipped spill byte kills its owner with a named
  ``IntegrityError`` and the survivor heals it through the rollback; a
  flipped chunk byte fails the job typed; a flipped checkpoint block
  fails the recovery typed.  Never a wrong result.
* **Stall** — a short mid-frame stall resolves clean; one past
  ``stall_timeout`` is detected and recovered.
"""
import json
import os

import numpy as np
import pytest

import torchprochelp as tph
from repro_torch.runtime.faults import (
    CORRUPT_TARGETS, FAULT_EXIT, KILL_PHASES, FaultAction, FaultPlan,
)


@pytest.fixture(scope="module")
def prob(tmp_path_factory):
    return tph.build_problem(str(tmp_path_factory.mktemp("tfault")),
                             workers=(2, 4))


_golden_cache = {}


def golden(prob, w, algname):
    key = (id(prob), w, algname)
    if key not in _golden_cache:
        _golden_cache[key] = tph.run_threads(prob, w, algname)
    return _golden_cache[key]


# ---------------------------------------------------------------------------
# FaultPlan surface
# ---------------------------------------------------------------------------

PLANS = [
    [FaultPlan.kill(1, 2, "send", after_frames=3),
     FaultPlan.drop(0, 1, 1, frame=2), FaultPlan.delay(2, 4)],
    [FaultPlan.corrupt_wire(0, 1, 2, frame=1),
     FaultPlan.corrupt_disk(1, 2, target="spill"),
     FaultPlan.corrupt_disk(0, 1, target="ckpt"),
     FaultPlan.stall(1, 0, 3, seconds=2.5)],
    [],
]


@pytest.mark.parametrize("actions", PLANS, ids=["kill-drop-delay",
                                                "corrupt-stall", "empty"])
def test_fault_plan_json_is_the_references(actions):
    from repro.runtime import faults as ref
    plan = FaultPlan(actions)
    assert FaultPlan.from_json(plan.to_json()).actions == plan.actions
    twin = ref.FaultPlan([ref.FaultAction(**json.loads(json.dumps(
        a.__dict__))) for a in actions])
    assert plan.to_json() == twin.to_json()
    assert FaultPlan.from_json(twin.to_json()).actions == plan.actions
    assert [a.__dict__ for a in ref.FaultPlan.from_json(
        plan.to_json()).actions] == [a.__dict__ for a in plan.actions]
    assert (FAULT_EXIT, KILL_PHASES, CORRUPT_TARGETS) == (
        ref.FAULT_EXIT, ref.KILL_PHASES, ref.CORRUPT_TARGETS)


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultPlan([FaultAction("melt", 1, worker=0)])
    with pytest.raises(ValueError, match="pe"):
        FaultPlan([FaultAction("kill", 0, worker=0)])
    with pytest.raises(ValueError, match="phase"):
        FaultPlan([FaultAction("kill", 1, worker=0, phase="later")])
    with pytest.raises(ValueError, match="worker"):
        FaultPlan([FaultAction("kill", 1)])
    with pytest.raises(ValueError, match="src and dst"):
        FaultPlan([FaultAction("drop", 1, src=0)])


def test_fault_plan_validation_new_kinds():
    with pytest.raises(ValueError, match="target"):
        FaultPlan([FaultAction("corrupt", 1, worker=0, target="ram")])
    with pytest.raises(ValueError, match="src and dst"):
        FaultPlan([FaultAction("corrupt", 1, target="wire")])
    with pytest.raises(ValueError, match="worker"):
        FaultPlan([FaultAction("corrupt", 1, target="spill")])
    with pytest.raises(ValueError, match="src and dst"):
        FaultPlan([FaultAction("stall", 1, seconds=1.0)])
    with pytest.raises(ValueError, match="seconds"):
        FaultPlan([FaultAction("stall", 1, src=0, dst=1)])


def test_delay_monoid_gate():
    plan = FaultPlan([FaultPlan.delay(0, 1)])
    plan.validate_for_monoid("min")
    plan.validate_for_monoid("max")
    with pytest.raises(ValueError, match="idempotent"):
        plan.validate_for_monoid("add")
    FaultPlan([FaultPlan.kill(0, 1)]).validate_for_monoid("add")


# ---------------------------------------------------------------------------
# Kill matrix
# ---------------------------------------------------------------------------

def check_kill(prob, run_dir, algname, w, worker, pe, phase,
               after_frames=0, world=None):
    world = w if world is None else world
    plan = FaultPlan([FaultPlan.kill(worker, pe, phase,
                                     after_frames=after_frames)])
    spec, codes, results = tph.run_procs(prob, w, algname, run_dir,
                                         world=world, plan=plan)
    dead = worker % world
    want = golden(prob, w, algname)
    if phase == "send" and codes[dead] == 0:
        # a kill@send fires only if the victim sends a cross-rank frame
        # in that round; when it does not, the run is failure-free
        assert codes == [0] * world, codes
        for res in results.values():
            tph.assert_result_equal(res, want)
            assert int(res["recoveries"]) == 0
        return
    assert codes == [FAULT_EXIT if r == dead else 0
                     for r in range(world)], (codes, [
                         tph.rank_log(spec, r) for r in range(world)])
    assert results, "no survivor wrote a result"
    for res in results.values():
        tph.assert_result_equal(res, want)
        assert int(res["recoveries"]) >= 1
        assert int(res["epoch"]) >= 1
        assert int(res["assign"][worker]) != dead   # adopted


KILL_CASES = [
    # (alg, W, worker, pe, phase, after_frames, world)
    ("pagerank", 2, 1, 2, "start", 0, None),
    ("bfs", 2, 0, 1, "recv", 0, None),       # rank 0 (rendezvous) dies
    ("sssp", 2, 1, 2, "apply", 0, None),
    ("wcc", 2, 1, 3, "start", 0, None),      # pe 3 = iteration 2, engine A
    ("pagerank", 4, 2, 1, "send", 1, None),  # dies mid-send, world = 4
    ("bfs", 4, 3, 2, "apply", 0, None),
    ("sssp", 4, 1, 1, "start", 0, 2),        # two workers per rank
]


@pytest.mark.parametrize("algname,w,worker,pe,phase,after,world",
                         KILL_CASES)
def test_kill_recovery(prob, tmp_path, algname, w, worker, pe, phase,
                       after, world):
    check_kill(prob, str(tmp_path / "run"), algname, w, worker, pe, phase,
               after_frames=after, world=world)


# ---------------------------------------------------------------------------
# Drop, delay, wire corruption
# ---------------------------------------------------------------------------

def test_drop_batch_redelivered(prob, tmp_path):
    plan = FaultPlan([FaultPlan.drop(src=0, dst=1, pe=2, frame=0)])
    _, codes, results = tph.run_procs(prob, 2, "pagerank",
                                      str(tmp_path / "run"), plan=plan)
    assert codes == [0, 0]
    want = golden(prob, 2, "pagerank")
    for res in results.values():
        tph.assert_result_equal(res, want)
        assert int(res["recoveries"]) == 0
        assert int(res["epoch"]) == 0
    # the drop is charged on the sender, the redelivery on the receiver
    assert results[0]["dropped"][0, 1] == 1
    assert results[1]["redelivered"][0, 1] == 1
    np.testing.assert_array_equal(results[1]["dropped"], 0)
    np.testing.assert_array_equal(results[0]["redelivered"], 0)


def test_delay_deferred_merge_fixpoint(prob, tmp_path):
    plan = FaultPlan([FaultPlan.delay(worker=0, pe=2)])
    _, codes, results = tph.run_procs(prob, 2, "bfs", str(tmp_path / "run"),
                                      plan=plan)
    assert codes == [0, 0]
    want = golden(prob, 2, "bfs")
    for res in results.values():
        np.testing.assert_array_equal(res["values"], want["values"])
        assert int(res["recoveries"]) == 0
        assert int(res["iterations"]) >= int(want["iterations"])
    assert results[0]["held"][0].sum() > 0
    assert results[0]["late_delivered"][0].sum() > 0


def test_delay_rejected_for_add_monoid(prob, tmp_path):
    plan = FaultPlan([FaultPlan.delay(worker=0, pe=1)])
    spec, codes, results = tph.run_procs(prob, 2, "pagerank",
                                         str(tmp_path / "run"), plan=plan)
    assert all(c not in (0, FAULT_EXIT) for c in codes), codes
    assert not results
    assert "idempotent" in tph.rank_log(spec, 0)


def test_corrupt_wire_frame_redelivered(prob, tmp_path):
    plan = FaultPlan([FaultPlan.corrupt_wire(src=0, dst=1, pe=2, frame=0)])
    _, codes, results = tph.run_procs(prob, 2, "pagerank",
                                      str(tmp_path / "run"), plan=plan)
    assert codes == [0, 0], codes
    want = golden(prob, 2, "pagerank")
    for res in results.values():
        tph.assert_result_equal(res, want)
        assert int(res["recoveries"]) == 0
        assert int(res["epoch"]) == 0
    assert results[0]["corrupted"][0, 1] == 1
    assert results[1]["corrupt_frames"][0, 1] == 1
    assert results[1]["redelivered"][0, 1] == 1
    np.testing.assert_array_equal(results[1]["corrupted"], 0)
    np.testing.assert_array_equal(results[0]["corrupt_frames"], 0)


def test_corrupt_wire_both_directions(prob, tmp_path):
    plan = FaultPlan([FaultPlan.corrupt_wire(0, 1, 1),
                      FaultPlan.corrupt_wire(1, 0, 2)])
    _, codes, results = tph.run_procs(prob, 2, "pagerank",
                                      str(tmp_path / "run"), plan=plan)
    assert codes == [0, 0], codes
    want = golden(prob, 2, "pagerank")
    for res in results.values():
        tph.assert_result_equal(res, want)
    assert results[0]["corrupted"][0, 1] == 1
    assert results[1]["corrupted"][1, 0] == 1
    assert results[0]["redelivered"][1, 0] == 1
    assert results[1]["redelivered"][0, 1] == 1


# ---------------------------------------------------------------------------
# Disk corruption: typed IntegrityError, recovery or typed job failure
# ---------------------------------------------------------------------------

def test_corrupt_spill_victim_dies_survivor_recovers(prob, tmp_path):
    plan = FaultPlan([FaultPlan.corrupt_disk(worker=1, pe=2,
                                             target="spill")])
    spec, codes, results = tph.run_procs(prob, 2, "pagerank",
                                         str(tmp_path / "run"), plan=plan)
    assert codes[1] not in (0, FAULT_EXIT), codes    # typed crash
    assert codes[0] == 0, codes
    log = tph.rank_log(spec, 1)
    assert "IntegrityError" in log and "vertex_" in log
    res = results[0]
    tph.assert_result_equal(res, golden(prob, 2, "pagerank"))
    assert int(res["recoveries"]) >= 1
    assert int(res["assign"][1]) == 0               # worker adopted


def test_corrupt_chunk_is_typed_fatal_never_wrong(prob, tmp_path):
    """Chunk shards are immutable, so rollback cannot heal them: the
    victim and the adopter both hit the named IntegrityError.  (The store
    is the module's, so the damaged bytes are put back afterwards.)"""
    shard = prob["stores"][2].shards[1]
    victim = os.path.join(shard.root, f"edges_q{shard.partitions[0]}.bin")
    with open(victim, "rb") as f:
        pristine = f.read()
    try:
        plan = FaultPlan([FaultPlan.corrupt_disk(worker=1, pe=2,
                                                 target="chunk")])
        spec, codes, results = tph.run_procs(
            prob, 2, "pagerank", str(tmp_path / "run"), plan=plan)
        assert all(c not in (0, FAULT_EXIT) for c in codes), codes
        assert not results, "a rank produced a result on damaged chunks"
        named = [r for r in range(2)
                 if "IntegrityError" in tph.rank_log(spec, r)
                 and os.path.basename(victim) in tph.rank_log(spec, r)]
        assert named, "no rank named the damaged chunk file"
    finally:
        with open(victim, "wb") as f:
            f.write(pristine)


def test_corrupt_ckpt_poisons_recovery_typed(prob, tmp_path):
    plan = FaultPlan([FaultPlan.corrupt_disk(worker=1, pe=2,
                                             target="ckpt"),
                      FaultPlan.kill(1, 2, "start")])
    spec, codes, results = tph.run_procs(prob, 2, "pagerank",
                                         str(tmp_path / "run"), plan=plan)
    assert codes[1] == FAULT_EXIT, codes
    assert codes[0] not in (0, FAULT_EXIT), codes
    assert not results
    assert "IntegrityError" in tph.rank_log(spec, 0)


# ---------------------------------------------------------------------------
# Stall: short resolves clean, long trips detection and recovery
# ---------------------------------------------------------------------------

def test_stall_short_resolves_clean(prob, tmp_path):
    plan = FaultPlan([FaultPlan.stall(src=0, dst=1, pe=2, seconds=0.5)])
    _, codes, results = tph.run_procs(prob, 2, "pagerank",
                                      str(tmp_path / "run"), plan=plan)
    assert codes == [0, 0], codes
    want = golden(prob, 2, "pagerank")
    for res in results.values():
        tph.assert_result_equal(res, want)
        assert int(res["recoveries"]) == 0
        assert int(res["epoch"]) == 0


def test_stall_long_detected_and_recovered(prob, tmp_path):
    plan = FaultPlan([FaultPlan.stall(src=0, dst=1, pe=2, seconds=6.0)])
    _, codes, results = tph.run_procs(prob, 2, "pagerank",
                                      str(tmp_path / "run"), plan=plan,
                                      stall_timeout=1.5)
    assert codes[0] not in (0, FAULT_EXIT), codes
    assert codes[1] == 0, codes
    res = results[1]
    tph.assert_result_equal(res, golden(prob, 2, "pagerank"))
    assert int(res["recoveries"]) >= 1
    assert int(res["epoch"]) >= 1
    assert int(res["assign"][0]) == 1               # worker 0 adopted
