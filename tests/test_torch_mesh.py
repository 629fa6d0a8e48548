"""The port's SHARD_MAP executor: ``Engine(..., mesh=ProcessMesh(...))`` on
P = 4 gloo ranks of one spawned job (``repro_torch.core.mesh.run_mesh``),
on the R-MAT problem of ``torchhelp`` (scale 7, edge factor 8, seed 3,
weighted; P = 4, batch 16).

* Values: BFS / SSSP / WCC (MIN folds) bit-equal to the port's LOCAL and
  to JAX LOCAL on both backends; PageRank and PPR (ADD) within
  rtol/atol 1e-5; iterations equal.  Every rank returns the same result.
* Counters: the segment runs equal JAX SHARD_MAP's on every key (abs
  1e-3, as ``tests/test_distributed_engine.py``; JAX SHARD_MAP runs in one
  subprocess on 4 forced host devices), and every key but the SHARD_MAP
  wire's equal LOCAL's (``seek_cost`` rel 1e-5).  JAX's SHARD_MAP x
  block_csr fails on jax 0.9, so block_csr is held against LOCAL.
* The physical exchange: on and off bit-identical, the priced wire model
  unchanged, ``measured_net_payload_elems == net_payload_elems``,
  compacted iterations on selective frontiers, PageRank dense.
* Compression on and off bit-identical, the raw twins unchanged.
* Multi-query: ``multi_bfs`` (Q = 3) and ``personalized_pagerank`` equal
  LOCAL, a serving session equals solo BFS.
* Guards: the out-of-core executors and a mesh of the wrong size raise;
  the launcher re-raises a rank's exception and enforces its deadline,
  killing every rank.

The JAX package is imported inside the fixtures and tests that compare
with it, so ``pytest -m cuda`` loads this module on a machine without
jax."""
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import meshhelp
from repro_torch.core import Engine, EngineConfig, MeshError, run_mesh
from repro_torch.core import algorithms as alg
from repro_torch.core.engine import COUNTER_KEYS

from torchhelp import GRAPH, SPEC, jax_fields

WORLD = SPEC["num_partitions"]
NQ = 3
BACKENDS = ["segment", "block_csr"]
WIRE_KEYS = ("net_payload_elems", "net_payload_elems_dense",
             "measured_net_payload_elems", "exchange_compacted_iters",
             "exchange_dense_iters")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_SHARD_MAP = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.core import (Engine, EngineConfig, build_dist_graph,
                        build_formats, make_spec)
from repro.core import algorithms as alg
from repro.data.graphs import rmat_graph

graph, spec_kw, src, sources, pr_iters, ppr_iters, out = json.loads(
    sys.argv[1])
g = rmat_graph(**graph)
spec = make_spec(g, **spec_kw)
dg, dgr = build_dist_graph(g, spec), build_dist_graph(g.reversed(), spec)
fm, fmr = build_formats(dg), build_formats(dgr)
mesh = jax.make_mesh((4,), ("part",))
eng = Engine(dg, fm, mesh=mesh, axis="part")
rev = Engine(dgr, fmr, mesh=mesh, axis="part")
mq = Engine(dg, fm, EngineConfig(num_queries=len(sources)), mesh=mesh,
            axis="part")
runs = {"pagerank": alg.pagerank(eng, pr_iters), "bfs": alg.bfs(eng, src),
        "sssp": alg.sssp(eng, src), "wcc": alg.wcc(eng, rev),
        "multi_bfs": alg.multi_bfs(mq, sources),
        "ppr": alg.personalized_pagerank(mq, sources, ppr_iters)}
arrays = {}
for name, (vals, st) in runs.items():
    arrays[name + "/values"] = np.asarray(vals)
    arrays[name + "/iterations"] = np.asarray(st.iterations)
    for k, v in st.counters.items():
        arrays[name + "/c/" + k] = np.asarray(v, np.float64)
np.savez(out, **arrays)
print("JAX_SHARD_MAP_OK")
"""


# ---------------------------------------------------------------------------
# Fixtures: one mesh job, one JAX SHARD_MAP subprocess, run side by side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    from repro.core import build_dist_graph, build_formats, make_spec
    from repro.data.graphs import rmat_graph
    g = rmat_graph(GRAPH["scale"], GRAPH["edge_factor"], seed=GRAPH["seed"],
                   weighted=GRAPH["weighted"])
    spec = make_spec(g, **SPEC)
    out = {"g": g, "src": int(np.argmax(g.out_degrees())),
           "sources": [int(x) for x in np.argsort(-g.out_degrees(),
                                                  kind="stable")[:NQ]]}
    for name, graph, sp in (
            ("fwd", g, spec), ("rev", g.reversed(), spec),
            ("mismatch", g, make_spec(g, num_partitions=2, batch_size=16))):
        jdg = build_dist_graph(graph, sp)
        jfm = build_formats(jdg)
        out[name] = {"dg": jax_fields(jdg), "fm": jax_fields(jfm),
                     "jax": (jdg, jfm)}
    return out


def _fields(p):
    return {"dg": p["dg"], "fm": p["fm"]}


@pytest.fixture(scope="module")
def runs(problem, tmp_path_factory):
    """(rank results of the mesh suite, the JAX SHARD_MAP npz)."""
    out = str(tmp_path_factory.mktemp("jax_shard_map") / "runs.npz")
    arg = json.dumps([GRAPH, SPEC, problem["src"], problem["sources"],
                      meshhelp.PR_ITERS, meshhelp.PPR_ITERS, out])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SHARD_MAP, arg], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_mesh(
            meshhelp.suite, WORLD, device="cpu", timeout_s=600,
            args=(_fields(problem["fwd"]), _fields(problem["rev"]),
                  _fields(problem["mismatch"]), problem["src"],
                  problem["sources"]))
        stdout, stderr = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert "JAX_SHARD_MAP_OK" in stdout, stderr[-3000:]
    with np.load(out) as z:
        jax_runs = {k: z[k] for k in z.files}
    return ranks, jax_runs


@pytest.fixture(scope="module")
def local(problem):
    """The port's LOCAL and JAX LOCAL runs of every mesh case."""
    from repro.core import Engine as JEngine
    from repro.core import EngineConfig as JConfig
    from repro.core import algorithms as jalg
    from repro_torch import interop
    p = {name: (interop.dist_graph_from_arrays(problem[name]["dg"],
                                               device="cpu"),
                interop.formats_from_arrays(problem[name]["fm"],
                                            device="cpu"))
         for name in ("fwd", "rev")}
    src, sources = problem["src"], problem["sources"]
    out = {}
    for backend in BACKENDS:
        cfg = EngineConfig(compute_backend=backend)
        eng, rev = (Engine(*p["fwd"], cfg, device="cpu"),
                    Engine(*p["rev"], cfg, device="cpu"))
        jcfg = JConfig(compute_backend=backend)
        jeng, jrev = (JEngine(*problem["fwd"]["jax"], jcfg),
                      JEngine(*problem["rev"]["jax"], jcfg))
        for algo in meshhelp.ALGOS:
            out[("port", algo, backend)] = meshhelp.run_algo(algo, eng, rev,
                                                             src)
            out[("jax", algo, backend)] = meshhelp.run_algo(
                algo, jeng, jrev, src, algorithms=jalg)
    mq = Engine(*p["fwd"], EngineConfig(num_queries=NQ), device="cpu")
    out[("port", "multi_bfs", "segment")] = alg.multi_bfs(mq, sources)
    out[("port", "ppr", "segment")] = alg.personalized_pagerank(
        mq, sources, meshhelp.PPR_ITERS)
    seg = Engine(*p["fwd"], EngineConfig(), device="cpu")
    out["solo"] = {s: alg.bfs(seg, s) for s in sources}
    return out


def mesh_run(runs, key):
    """Rank 0's (values, stats) of one case, after checking that every
    rank returned the same values and counters."""
    ranks, _ = runs
    vals, st = ranks[0]["runs"][key]
    for r in ranks[1:]:
        v, s = r["runs"][key]
        assert np.array_equal(np.asarray(v).view(np.int32),
                              np.asarray(vals).view(np.int32)), (key, r["rank"])
        assert s["counters"] == st["counters"], (key, r["rank"])
        assert s["iterations"] == st["iterations"], (key, r["rank"])
    return vals, st


def assert_same_values(algo, v, ref):
    if algo in ("pagerank", "ppr"):
        np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-5)
    else:
        v, ref = np.asarray(v), np.asarray(ref)
        assert v.dtype == ref.dtype
        np.testing.assert_array_equal(v.view(np.int32), ref.view(np.int32))


# ---------------------------------------------------------------------------
# Values and counters against LOCAL and JAX SHARD_MAP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo", meshhelp.ALGOS)
def test_mesh_matches_local(runs, local, algo, backend):
    """Values equal the port's LOCAL and JAX LOCAL, iterations and
    per-iteration returns equal, every counter but the mesh wire's equal
    LOCAL's."""
    v, st = mesh_run(runs, (algo, backend, None))
    for who in ("port", "jax"):
        lv, lst = local[(who, algo, backend)]
        assert_same_values(algo, v, lv)
        assert st["iterations"] == lst.iterations
        np.testing.assert_allclose(st["per_iter_return"],
                                   lst.per_iter_return, rtol=1e-5, atol=1e-7)
    lst = local[("port", algo, backend)][1]
    for k, ref in lst.counters.items():
        if k in WIRE_KEYS:
            continue
        if k == "seek_cost":
            assert st["counters"][k] == pytest.approx(ref, rel=1e-5), k
        else:
            assert st["counters"][k] == ref, (k, st["counters"][k], ref)


@pytest.mark.parametrize("algo", meshhelp.ALGOS + ("multi_bfs", "ppr"))
def test_segment_counters_match_jax_shard_map(runs, algo):
    """Segment: values, iterations and every counter — the wire audit and
    the exchange choices included — equal JAX SHARD_MAP's (abs 1e-3)."""
    _, jax_runs = runs
    v, st = mesh_run(runs, (algo, "segment", None))
    assert_same_values(algo, v, jax_runs[algo + "/values"])
    assert np.array_equal(np.asarray(st["iterations"]),
                          jax_runs[algo + "/iterations"])
    assert st["counters"].keys() == set(COUNTER_KEYS)
    for k in COUNTER_KEYS:
        ref = float(jax_runs[f"{algo}/c/{k}"])
        assert abs(st["counters"][k] - ref) < 1e-3, (algo, k,
                                                     st["counters"][k], ref)


# ---------------------------------------------------------------------------
# The physical exchange (DESIGN.md §12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo", meshhelp.ALGOS)
def test_physical_exchange_is_bit_identical(runs, algo, backend):
    """Exchange on (auto) and off give the same values bit for bit and the
    same priced wire model; the audit holds; PageRank's all-active
    frontier stays dense, the selective ones go compacted and ship fewer
    elements than the dense slab."""
    v_on, on = mesh_run(runs, (algo, backend, None))
    v_off, off = mesh_run(runs, (algo, backend, False))
    np.testing.assert_array_equal(np.asarray(v_on).view(np.int32),
                                  np.asarray(v_off).view(np.int32))
    c_on, c_off = on["counters"], off["counters"]
    for k in COUNTER_KEYS:
        if k not in WIRE_KEYS:
            assert c_on[k] == c_off[k], k
    for c in (c_on, c_off):
        assert c["measured_net_payload_elems"] == c["net_payload_elems"]
        assert (c["exchange_compacted_iters"] + c["exchange_dense_iters"]
                == on["iterations"] * (2 if algo == "wcc" else 1))
    assert c_off["exchange_compacted_iters"] == 0
    assert c_off["net_payload_elems"] == c_off["net_payload_elems_dense"]
    if algo == "pagerank":
        assert c_on["exchange_compacted_iters"] == 0
        assert c_on["net_payload_elems"] == c_on["net_payload_elems_dense"]
    else:
        assert c_on["exchange_compacted_iters"] >= 1
        assert c_on["net_payload_elems"] < c_on["net_payload_elems_dense"]


def test_exchange_log_records_every_call(runs):
    """``engine.mesh_log`` holds one record per mesh ProcessEdges: the
    exchange's seconds inside the step's, and the payload it shipped."""
    ranks, _ = runs
    _, st = mesh_run(runs, ("pagerank", "block_csr", None))
    for r in ranks:
        log = r["log"]
        n_pe = sum(r["runs"][(a, "block_csr", None)][1]["iterations"]
                   for a in meshhelp.ALGOS)
        assert len(log) == n_pe
        for rec in log:
            assert 0 <= rec["exchange_s"] <= rec["step_s"]
            assert 0 <= rec["wire_s"] <= rec["step_s"]
            assert rec["compacted"] == (rec["capacity"] is not None)
        pr = log[:st["iterations"]]
        assert not any(rec["compacted"] for rec in pr)


@pytest.mark.parametrize("algo", ["pagerank", "bfs"])
def test_compression_knob_is_bit_identical(runs, algo):
    """Compression off: the same values bit for bit, the raw twins
    unchanged, the compressed columns no larger."""
    v_on, on = mesh_run(runs, (algo, "segment", None))
    v_off, off = mesh_run(runs, (algo, "nocomp", None))
    np.testing.assert_array_equal(np.asarray(v_on).view(np.int32),
                                  np.asarray(v_off).view(np.int32))
    c_on, c_off = on["counters"], off["counters"]
    assert c_off["net_bytes"] == c_off["net_bytes_raw"]
    assert c_on["net_bytes_raw"] == c_off["net_bytes_raw"]
    assert c_on["edge_read_bytes_raw"] == c_off["edge_read_bytes_raw"]
    assert c_on["net_bytes"] <= c_off["net_bytes"]
    assert c_on["edge_read_bytes"] <= c_off["edge_read_bytes"]


# ---------------------------------------------------------------------------
# Multi-query on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["multi_bfs", "ppr"])
def test_multiquery_matches_local(runs, local, algo):
    v, st = mesh_run(runs, (algo, "segment", None))
    lv, lst = local[("port", algo, "segment")]
    assert_same_values(algo, v, lv)
    assert st["iterations"] == lst.iterations
    for k, ref in lst.counters.items():
        if k in WIRE_KEYS:
            continue
        if k == "seek_cost":
            assert st["counters"][k] == pytest.approx(ref, rel=1e-5), k
        else:
            assert abs(st["counters"][k] - ref) < 0.5, (k, st["counters"][k],
                                                       ref)


def test_multi_bfs_panel_exchange_is_bit_identical(runs, local, problem):
    """The panel exchange on and off: each column bit-equal to the solo
    BFS, the compacted panel taken on a selective iteration."""
    v_on, on = mesh_run(runs, ("multi_bfs", "segment", None))
    v_off, off = mesh_run(runs, ("multi_bfs", "segment", False))
    np.testing.assert_array_equal(v_on.view(np.int32), v_off.view(np.int32))
    for j, s in enumerate(problem["sources"]):
        lv, lst = local["solo"][s]
        np.testing.assert_array_equal(v_on[:, j].view(np.int32),
                                      lv.view(np.int32))
        assert on["iterations"][j] == lst.iterations
    c = on["counters"]
    assert c["measured_net_payload_elems"] == c["net_payload_elems"]
    assert c["exchange_compacted_iters"] >= 1
    assert off["counters"]["exchange_compacted_iters"] == 0


def test_serve_session_matches_solo_bfs(runs, local):
    """A 2-slot session over 3 sources (the third waits for a free slot):
    every result equals the solo BFS with its iteration count, on every
    rank."""
    ranks, _ = runs
    sess = ranks[0]["session"]
    assert len(sess["results"]) == NQ
    assert sess["steps"] >= 2
    assert any(wait > 0 for _, _, _, wait in sess["results"])
    for source, levels, run_iters, _ in sess["results"]:
        lv, lst = local["solo"][source]
        np.testing.assert_array_equal(levels.view(np.int32),
                                      lv.view(np.int32))
        assert run_iters == lst.iterations
    for r in ranks[1:]:
        assert r["session"]["counters"] == sess["counters"]
        for a, b in zip(r["session"]["results"], sess["results"]):
            assert a[0] == b[0] and np.array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# Residency and guards
# ---------------------------------------------------------------------------

def test_each_rank_holds_only_its_row(runs, problem):
    """The executor's arrays, block tiles and value tiles are this rank's
    row ([1, ...]) on the rank's device; the host graph stays whole."""
    ranks, _ = runs
    for r in ranks:
        rows = r["rows"]
        assert rows["garrs_device"] == ["cpu"]
        assert all(shape[0] == 1 for shape in rows["garrs"].values())
        assert rows["garrs"]["need"][1:] == (WORLD, problem["fwd"]["dg"][
            "need"].shape[2])
        assert rows["tiles"][0] == 1
        assert rows["values"] and all(s[0] == 1
                                      for s in rows["values"].values())
        assert rows["graph_rows"] == WORLD


@pytest.mark.parametrize("case,match", [
    ("ooc", "single-process"),
    ("dist_ooc", "single-process"),
    ("size", "2 partitions"),
    ("mq_block", "compute_backend='segment'"),
])
def test_mesh_guards_raise(runs, case, match):
    """On a mesh the out-of-core executors raise, as the reference's do; a
    graph whose partition count differs from the mesh size raises; mesh
    multi-query runs the segment backend only."""
    ranks, _ = runs
    for r in ranks:
        kind, msg = r["errors"][case]
        assert kind == "ValueError" and match in msg, (case, kind, msg)


def test_launcher_reraises_a_rank_exception():
    """A rank that raises fails the job: the other rank (waiting in a
    collective) is killed and the rank's own exception is raised here."""
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="on purpose") as info:
        run_mesh(meshhelp.fails, 2, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60
    assert any("mesh rank 1" in n for n in info.value.__notes__)
    assert not multiprocessing.active_children()


def test_launcher_kills_every_rank_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(MeshError, match="deadline"):
        run_mesh(meshhelp.overruns, 2, device="cpu", timeout_s=10)
    assert time.monotonic() - t0 < 40
    assert not multiprocessing.active_children()


def test_engine_without_a_mesh_rejects_the_physical_exchange(problem):
    from repro_torch import interop
    dg = interop.dist_graph_from_arrays(problem["fwd"]["dg"], device="cpu")
    fm = interop.formats_from_arrays(problem["fwd"]["fm"], device="cpu")
    with pytest.raises(ValueError, match="requires the SHARD_MAP"):
        Engine(dg, fm, EngineConfig(physical_sparse_exchange=True),
               device="cpu")
    eng = Engine(dg, fm, EngineConfig(physical_sparse_exchange=False),
                 device="cpu")
    assert not eng.physical_sparse_exchange and not eng._distributed


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_on_the_card(cuda_device):
    """2 ranks sharing the card, R-MAT scale 8, block_csr: BFS and
    PageRank equal the same job on the CPU (BFS bit for bit, PageRank
    within 1e-5, every counter equal but ``seek_cost``), with one
    ``block_csr_combine`` launch per rank per ProcessEdges."""
    from repro_torch.core import build_dist_graph, build_formats, make_spec
    from repro_torch.data.graphs import rmat_graph
    from torchhelp import port_fields
    g = rmat_graph(8, 8, seed=1, weighted=True)
    dg = build_dist_graph(g, make_spec(g, num_partitions=2, batch_size=16))
    fields = {"dg": port_fields(dg), "fm": port_fields(build_formats(dg))}
    src = int(np.argmax(g.out_degrees()))
    card = run_mesh(meshhelp.on_card, 2, args=(fields, src), timeout_s=600)
    cpu = run_mesh(meshhelp.on_card, 2, args=(fields, src), device="cpu",
                   timeout_s=600)
    assert [r["device"] for r in card] == ["cuda", "cuda"]
    for algo in ("pagerank", "bfs"):
        v, st, _ = card[0][algo]
        cv, cst, _ = cpu[0][algo]
        assert_same_values(algo, v, cv)
        assert st["iterations"] == cst["iterations"]
        for k, ref in cst["counters"].items():
            if k == "seek_cost":
                assert st["counters"][k] == pytest.approx(ref, rel=1e-5)
            else:
                assert st["counters"][k] == ref, k
        for r in card:
            assert r[algo][2] == st["iterations"], (algo, r[algo][2])
