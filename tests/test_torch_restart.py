"""Whole-job durable restart on port ranks (DESIGN.md §14), mirroring
``tests/test_restart.py``, plus one job that crashes under the reference's
ranks and resumes under the port's.

The gate: kill every rank mid-run, relaunch with ``resume=True``, and the
finished job is bit-identical to a failure-free run — values, iterations,
per-iteration returns, every counter and per-worker totals.  Each
committed op appends its record to the rank's self-checksummed
``runlog_r{rank}.json``; the resume point is ``min(last_committed)`` over
the ranks; each engine restores its spills from the checkpoint of the
crashed op and the drivers fast-forward through the committed prefix.
"""
import json
import os

import numpy as np
import pytest

import torchprochelp as tph
from repro_torch.runtime.faults import FAULT_EXIT, FaultPlan
from repro_torch.utils import json_crc


@pytest.fixture(scope="module")
def prob(tmp_path_factory):
    return tph.build_problem(str(tmp_path_factory.mktemp("trestart")),
                             workers=(2, 4))


_golden_cache = {}


def golden(prob, w, algname):
    key = (w, algname)
    if key not in _golden_cache:
        _golden_cache[key] = tph.run_threads(prob, w, algname)
    return _golden_cache[key]


def crash_plan(world: int, pe: int) -> FaultPlan:
    """Kill every rank at ProcessEdges call ``pe`` (worker r starts on
    rank r): the crashed op was checkpointed but never committed."""
    return FaultPlan([FaultPlan.kill(r, pe, "start") for r in range(world)])


def check_restart(prob, run_dir, algname, w, pe, world=None):
    world = w if world is None else world
    spec, codes, results = tph.run_procs(prob, w, algname, run_dir,
                                         world=world,
                                         plan=crash_plan(world, pe))
    assert codes == [FAULT_EXIT] * world, codes
    assert not results, "a rank wrote a result despite the whole-job kill"
    codes, results = tph.resume_procs(spec)
    assert codes == [0] * world, codes
    want = golden(prob, w, algname)
    for res in results.values():
        tph.assert_result_equal(res, want)
        assert int(res["recoveries"]) == 0
        assert int(res["epoch"]) == 0
    return spec


RESTART_CASES = [
    ("pagerank", 2, 2), ("pagerank", 4, 2),
    ("bfs", 2, 2), ("bfs", 4, 2),
    ("sssp", 2, 2), ("sssp", 4, 2),
    ("wcc", 2, 2), ("wcc", 4, 3),
]


@pytest.mark.parametrize("algname,w,pe", RESTART_CASES)
def test_whole_job_crash_restart(prob, tmp_path, algname, w, pe):
    check_restart(prob, str(tmp_path / "run"), algname, w, pe)


def test_restart_first_op_no_committed_prefix(prob, tmp_path):
    check_restart(prob, str(tmp_path / "run"), "pagerank", 2, 1)


def test_restart_multi_worker_ranks(prob, tmp_path):
    check_restart(prob, str(tmp_path / "run"), "bfs", 4, 2, world=2)


def test_resume_of_completed_run_is_pure_fast_forward(prob, tmp_path):
    spec, codes, _ = tph.run_procs(prob, 2, "pagerank",
                                   str(tmp_path / "run"))
    assert codes == [0, 0]
    codes, results = tph.resume_procs(spec)
    assert codes == [0, 0], codes
    for res in results.values():
        tph.assert_result_equal(res, golden(prob, 2, "pagerank"))
        np.testing.assert_array_equal(res["wire_frames"], 0)


def test_resume_with_corrupt_runlog_is_typed_fatal(prob, tmp_path):
    spec, codes, _ = tph.run_procs(prob, 2, "pagerank",
                                   str(tmp_path / "run"),
                                   plan=crash_plan(2, 2))
    assert codes == [FAULT_EXIT, FAULT_EXIT]
    log_path = os.path.join(spec["result_dir"], "runlog_r1.json")
    with open(log_path) as f:
        doc = json.load(f)
    doc["last_committed"] = 999        # tamper without fixing the crc
    with open(log_path, "w") as f:
        json.dump(doc, f)
    codes, results = tph.resume_procs(spec)
    assert all(c not in (0, FAULT_EXIT) for c in codes), codes
    assert not results
    assert any("IntegrityError" in tph.rank_log(spec, r)
               and "runlog_r1.json" in tph.rank_log(spec, r)
               for r in range(2)), "no rank named the damaged runlog"
    # repaired (its self-crc recomputed), the same job resumes right
    doc["last_committed"] = 2
    doc.pop("crc", None)
    doc["crc"] = json_crc(doc)
    with open(log_path, "w") as f:
        json.dump(doc, f)
    codes, results = tph.resume_procs(spec)
    assert codes == [0, 0], codes
    for res in results.values():
        tph.assert_result_equal(res, golden(prob, 2, "pagerank"))


def test_resume_under_wrong_run_id_is_typed_fatal(prob, tmp_path):
    spec, codes, _ = tph.run_procs(prob, 2, "pagerank",
                                   str(tmp_path / "run"),
                                   plan=crash_plan(2, 2))
    assert codes == [FAULT_EXIT, FAULT_EXIT]
    codes, results = tph.resume_procs(dict(spec,
                                           run_id=spec["run_id"] + "-x"))
    assert all(c not in (0, FAULT_EXIT) for c in codes), codes
    assert not results
