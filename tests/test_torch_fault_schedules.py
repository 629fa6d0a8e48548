"""Random fault schedules on the port's process mode, and the invariant
the reference breaks under one of them.

``_random_plan`` is the reference test's generator (kills, drops and
delays over the first two ProcessEdges calls, W = 4 on two ranks, BFS);
the seeds are pinned, so every run counts the same cases, and include
835, the seed under which the reference's recovery ends with wrong BFS
levels.  Without a delay the whole run is bit-identical to the
failure-free one; with one, the fixpoint is.

The port's departure: deferred frames a sender flushed to a rank that
then died are delivered again to the worker's new owner during recovery
(``ProcContext._recover``).  The reference loses them with the dead
rank's inbox, so the adopter replays the op without them."""
import numpy as np
import pytest

import torchprochelp as tph
from repro_torch.runtime.faults import FAULT_EXIT, KILL_PHASES, FaultPlan

SEEDS = [0, 1, 2, 3, 835]


@pytest.fixture(scope="module")
def prob(tmp_path_factory):
    return tph.build_problem(str(tmp_path_factory.mktemp("tsched")),
                             workers=(4,))


@pytest.fixture(scope="module")
def want(prob):
    return tph.run_threads(prob, 4, "bfs")


def _random_plan(seed, w, world, max_pe):
    """The reference test's schedule generator, draw for draw."""
    rng = np.random.default_rng(seed)
    actions, killed = [], set()
    for _ in range(int(rng.integers(1, 4))):
        kind = ("kill", "drop", "delay")[int(rng.integers(0, 3))]
        pe = int(rng.integers(1, max_pe + 1))
        if kind == "kill":
            worker = int(rng.integers(0, w))
            rank = worker % world
            if len(killed | {rank}) >= world:
                continue                      # keep one survivor alive
            killed.add(rank)
            actions.append(FaultPlan.kill(
                worker, pe, KILL_PHASES[int(rng.integers(0, 4))]))
        elif kind == "drop":
            actions.append(FaultPlan.drop(
                int(rng.integers(0, w)), int(rng.integers(0, w)), pe,
                frame=int(rng.integers(0, 2))))
        else:
            actions.append(FaultPlan.delay(int(rng.integers(0, w)), pe))
    if not actions:
        actions.append(FaultPlan.drop(0, w - 1, 1))
    return FaultPlan(actions), killed


def test_plan_generator_is_the_references():
    from test_fault_injection import _random_plan as ref_plan
    for seed in SEEDS:
        plan, killed = _random_plan(seed, 4, 2, 2)
        rplan, rkilled = ref_plan(seed, 4, 2, 2)
        assert plan.to_json() == rplan.to_json() and killed == rkilled


@pytest.mark.parametrize("seed", SEEDS)
def test_random_fault_schedules(prob, want, tmp_path, seed):
    plan, killed = _random_plan(seed, 4, 2, 2)
    _, codes, results = tph.run_procs(prob, 4, "bfs", str(tmp_path / "run"),
                                      world=2, plan=plan)
    for r, c in enumerate(codes):
        # a kill@send fires only if that worker sends a cross-rank frame
        assert c in ((0, FAULT_EXIT) if r in killed else (0,)), (codes, seed)
    assert results
    for res in results.values():
        np.testing.assert_array_equal(res["values"], want["values"])
        if not plan.has_delay():
            tph.assert_result_equal(res, want)


def test_deferred_frames_flushed_to_a_rank_that_dies_reach_its_adopter(
        prob, want, tmp_path):
    """Seed 835's schedule: rank 0's workers (0 and 2) hold every frame of
    ProcessEdges call 1; call 2 flushes them to rank 1, whose workers (1
    and 3) die at its start.  Rank 0 adopts them and must merge the frames
    it flushed into the dead rank's lost inbox — the levels equal the
    failure-free run's."""
    plan = FaultPlan([FaultPlan.delay(2, 1), FaultPlan.delay(0, 1),
                      FaultPlan.kill(1, 2, "start")])
    spec, codes, results = tph.run_procs(prob, 4, "bfs",
                                         str(tmp_path / "run"), world=2,
                                         plan=plan)
    assert codes == [0, FAULT_EXIT], (codes, tph.rank_log(spec, 0))
    res = results[0]
    assert int(res["recoveries"]) == 1
    assert list(res["assign"]) == [0, 0, 0, 0]
    assert res["held"][[0, 2]][:, [1, 3]].sum() > 0
    np.testing.assert_array_equal(res["values"].view(np.int32),
                                  want["values"].view(np.int32))
