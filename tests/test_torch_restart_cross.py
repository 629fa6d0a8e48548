"""Whole-job restart across graph sources and across the packages: run
specs that name a serialized edge list (mirroring the edge-file cases of
``tests/test_restart.py``), and a job that crashes under the reference's
ranks and resumes under the port's, from the reference's run logs, spills
and block-store checkpoints."""
import pytest

import torchprochelp as tph
from repro_torch.data.graphs import save_edge_list
from repro_torch.runtime.faults import FAULT_EXIT
from test_torch_restart import crash_plan


@pytest.fixture(scope="module")
def prob(tmp_path_factory):
    return tph.build_problem(str(tmp_path_factory.mktemp("trestart2")),
                             workers=(2,))


_golden_cache = {}


def golden(prob, w, algname):
    key = (w, algname)
    if key not in _golden_cache:
        _golden_cache[key] = tph.run_threads(prob, w, algname)
    return _golden_cache[key]


# ---------------------------------------------------------------------------
# Edge-file run specs
# ---------------------------------------------------------------------------

def _edge_file_graph(prob, tmp_path):
    path = str(tmp_path / "edges.npz")
    return {"edge_file": path, "crc32": save_edge_list(prob["g"], path)}


def test_edge_file_spec_runs_bit_identical(prob, tmp_path):
    _, codes, results = tph.run_procs(
        prob, 2, "pagerank", str(tmp_path / "run"),
        graph=_edge_file_graph(prob, tmp_path))
    assert codes == [0, 0], codes
    for res in results.values():
        tph.assert_result_equal(res, golden(prob, 2, "pagerank"))


def test_edge_file_spec_crash_restart(prob, tmp_path):
    spec, codes, _ = tph.run_procs(
        prob, 2, "bfs", str(tmp_path / "run"), plan=crash_plan(2, 2),
        graph=_edge_file_graph(prob, tmp_path))
    assert codes == [FAULT_EXIT, FAULT_EXIT], codes
    codes, results = tph.resume_procs(spec)
    assert codes == [0, 0], codes
    for res in results.values():
        tph.assert_result_equal(res, golden(prob, 2, "bfs"))
        assert int(res["recoveries"]) == 0


def test_edge_file_corruption_is_typed_fatal(prob, tmp_path):
    gsec = _edge_file_graph(prob, tmp_path)
    with open(gsec["edge_file"], "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    spec, codes, results = tph.run_procs(prob, 2, "pagerank",
                                         str(tmp_path / "run"), graph=gsec)
    assert all(c not in (0, FAULT_EXIT) for c in codes), codes
    assert not results
    text = tph.rank_log(spec, 0)
    assert "IntegrityError" in text and "edges.npz" in text


# ---------------------------------------------------------------------------
# Across the packages: the reference's ranks crash, the port's resume
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jprob(tmp_path_factory):
    import prochelp
    return prochelp.build_problem(str(tmp_path_factory.mktemp("jrestart")),
                                  workers=(2,))


@pytest.mark.parametrize("algname", ["bfs", "pagerank"])
def test_jax_crash_resumes_under_port_ranks(jprob, prob, tmp_path, algname):
    """Every JAX rank dies at ProcessEdges call 2; port ranks resume the
    job from the JAX run logs, spills and block-store checkpoints (and the
    JAX-built sharded store), fast-forward through the committed prefix
    and run the rest: the result equals the failure-free run of either
    package (BFS levels bit for bit, PageRank within 1e-5 of JAX and, with
    the committed prefix's counters from JAX's log, every counter equal to
    JAX's failure-free run)."""
    import prochelp
    spec, codes, results = prochelp.run_procs(
        jprob, 2, algname, str(tmp_path / "run"), plan=crash_plan(2, 2))
    assert codes == [FAULT_EXIT, FAULT_EXIT], codes
    assert not results
    codes, results = tph.resume_procs(spec)
    assert codes == [0, 0], [tph.rank_log(spec, r) for r in range(2)]
    jwant = prochelp.run_threads(jprob, 2, algname)
    for res in results.values():
        assert int(res["recoveries"]) == 0
        tph.assert_matches_jax(res, jwant, algname)
        if algname == "bfs":
            tph.assert_result_equal(res, golden(prob, 2, "bfs"))
