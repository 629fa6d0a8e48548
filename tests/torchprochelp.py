"""Shared helpers for the port's process-mode tests — the twin of
``tests/prochelp.py``.

Builds the same small weighted R-MAT problem (scale 7, edge factor 16,
seed 5; P = 4, batch 16) with the port, with its sharded chunk stores
(forward and reversed, for WCC), runs a thread-mode port DIST_OOC baseline
shaped like a ``result_r{rank}.npz``, and launches port ranks
(``repro_torch.runtime.procworker.launch``) on the CPU, one thread each.
Nothing here imports jax: the tests that compare with the reference use
``tests/prochelp.py`` beside this module.
"""
import contextlib
import itertools
import os

import numpy as np
import pytest

from repro_torch.core import (
    ChunkStore, Engine, EngineConfig, build_dist_graph, build_formats,
    make_spec,
)
from repro_torch.core import algorithms as alg
from repro_torch.data.graphs import rmat_graph
from repro_torch.runtime.procworker import launch, load_result

GRAPH = dict(scale=7, edge_factor=16, seed=5, weighted=True)
SPEC = dict(num_partitions=4, batch_size=16)
SOURCE = 3

ALG_SPECS = {
    "pagerank": {"name": "pagerank", "args": {"num_iters": 3}},
    "bfs": {"name": "bfs", "args": {"source": SOURCE}},
    "sssp": {"name": "sssp", "args": {"source": SOURCE}},
    "wcc": {"name": "wcc", "args": {}},
}

# Result fields that must be bit-equal between a failure-free run, a
# recovered run and the thread-mode baseline.
RESULT_KEYS = ("values", "iterations", "rets", "counter_names",
               "counter_vals", "wt_disk", "wt_net", "wt_edges")


_uid = itertools.count()


def build_problem(root: str, workers=(2, 4)) -> dict:
    g = rmat_graph(GRAPH["scale"], GRAPH["edge_factor"],
                   seed=GRAPH["seed"], weighted=GRAPH["weighted"])
    spec = make_spec(g, **SPEC)
    dg = build_dist_graph(g, spec)
    fm = build_formats(dg)
    dg_r = build_dist_graph(g.reversed(), spec)
    fm_r = build_formats(dg_r)
    stores = {w: ChunkStore.build_sharded(
        dg, fm, os.path.join(root, f"W{w}"), w) for w in workers}
    stores_r = {w: ChunkStore.build_sharded(
        dg_r, fm_r, os.path.join(root, f"Wr{w}"), w) for w in workers}
    return dict(g=g, spec=spec, dg=dg, fm=fm, dg_r=dg_r, fm_r=fm_r,
                stores=stores, stores_r=stores_r)


def result_of(values, stats, worker_totals) -> dict:
    """A run shaped like the ``RESULT_KEYS`` of a rank's result."""
    names = sorted(stats.counters)
    wt = worker_totals
    return dict(
        values=np.asarray(values),
        iterations=np.int64(stats.iterations),
        rets=np.asarray(stats.per_iter_return, np.float64),
        counter_names=np.asarray(names),
        counter_vals=np.asarray([stats.counters[k] for k in names],
                                np.float64),
        wt_disk=np.asarray([t["disk_bytes"] for t in wt], np.float64),
        wt_net=np.asarray([t["net_bytes"] for t in wt], np.float64),
        wt_edges=np.asarray([t["edges_touched"] for t in wt], np.float64),
    )


def run_algorithm(algname, eng, eng_r=None):
    if algname == "wcc":
        return alg.wcc(eng, eng_r)
    if algname == "pagerank":
        return alg.pagerank(eng, ALG_SPECS["pagerank"]["args"]["num_iters"])
    if algname == "bfs":
        return alg.bfs(eng, SOURCE)
    if algname == "sssp":
        return alg.sssp(eng, SOURCE)
    raise ValueError(algname)


def run_threads(prob: dict, w: int, algname: str) -> dict:
    """The port's thread-mode DIST_OOC run on the CPU, shaped like a
    rank's result."""
    cfg = EngineConfig(executor="dist_ooc", num_workers=w)
    eng = Engine(prob["dg"], prob["fm"], cfg, store=prob["stores"][w],
                 device="cpu")
    eng_r = None
    if algname == "wcc":
        eng_r = Engine(prob["dg_r"], prob["fm_r"], cfg,
                       store=prob["stores_r"][w], device="cpu")
    values, stats = run_algorithm(algname, eng, eng_r)
    return result_of(values, stats, eng.worker_totals)


def proc_spec(prob: dict, w: int, algname: str, run_dir: str, *,
              world=None, plan=None, io_timeout: float = 120.0,
              **extra) -> dict:
    spec = {
        # unique per launch, so no run restores another's checkpoints
        "run_id": f"t{next(_uid)}-{os.getpid()}",
        "world": w if world is None else world,
        "num_workers": w,
        "rendezvous": os.path.join(run_dir, "rdv"),
        "result_dir": os.path.join(run_dir, "out"),
        "graph": GRAPH,
        "spec": SPEC,
        "store_root": prob["stores"][w].root,
        "algorithm": ALG_SPECS[algname],
        "fault_plan": plan.to_json() if plan is not None else None,
        "io_timeout": io_timeout,
        "device": "cpu",
    }
    if algname == "wcc":
        spec["store_root_rev"] = prob["stores_r"][w].root
    spec.update(extra)
    return spec


@contextlib.contextmanager
def one_thread_ranks():
    """Ranks launched inside run on one thread each (they inherit the
    environment), which keeps the suite steady when pytest runs it on
    several workers at once."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


def results_of(spec: dict, codes: list) -> dict:
    return {r: load_result(spec["result_dir"], r)
            for r, c in enumerate(codes) if c == 0}


def run_procs(prob: dict, w: int, algname: str, run_dir: str, *,
              world=None, plan=None, timeout: float = 240.0, **extra):
    """Launch port ranks; returns (spec, exit codes, {rank: result} of the
    ranks that exited cleanly)."""
    spec = proc_spec(prob, w, algname, run_dir, world=world, plan=plan,
                     **extra)
    with one_thread_ranks():
        codes = launch(spec, timeout=timeout)
    return spec, codes, results_of(spec, codes)


def resume_procs(spec: dict, timeout: float = 240.0):
    """Restart a crashed job under port ranks from its run logs: same
    spec, run id and directories.  Returns (exit codes, results)."""
    spec = dict(spec, device="cpu")
    with one_thread_ranks():
        codes = launch(spec, timeout=timeout, resume=True)
    return codes, results_of(spec, codes)


def rank_log(spec: dict, r: int) -> str:
    with open(os.path.join(spec["result_dir"], f"log_r{r}.txt")) as f:
        return f.read()


def assert_result_equal(got: dict, want: dict, keys=RESULT_KEYS) -> None:
    for k in keys:
        np.testing.assert_array_equal(
            np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def assert_matches_jax(got: dict, want: dict, algname: str) -> None:
    """A port result against the reference's (thread or process mode) on
    the same graph: MIN folds bit-equal, PageRank within 1e-5; iterations,
    every counter (``seek_cost``, a float32 sum, within rel 1e-5) and the
    per-worker totals equal."""
    if algname == "pagerank":
        np.testing.assert_allclose(got["values"], want["values"],
                                   rtol=1e-5, atol=1e-5)
    else:
        assert got["values"].dtype == want["values"].dtype
        np.testing.assert_array_equal(got["values"].view(np.int32),
                                      want["values"].view(np.int32))
    assert int(got["iterations"]) == int(want["iterations"])
    np.testing.assert_allclose(got["rets"], want["rets"], rtol=1e-5,
                               atol=1e-7)
    names = [str(n) for n in got["counter_names"]]
    assert names == [str(n) for n in want["counter_names"]]
    for k, a, b in zip(names, got["counter_vals"], want["counter_vals"]):
        if k == "seek_cost":
            assert a == pytest.approx(b, rel=1e-5), k
        else:
            assert a == b, (k, a, b)
    for k in ("wt_disk", "wt_net", "wt_edges"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

