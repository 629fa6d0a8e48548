"""Port process-mode DIST_OOC at W = 2 and 4 workers for the paper's four
algorithms, against the port's thread mode (bit for bit: values,
iterations, per-iteration returns, every counter, per-worker totals) and
against the reference's thread and process modes (MIN folds bit-equal,
PageRank within 1e-5, iterations, every counter and per-worker totals
equal).  ``measured == model`` for disk and wire holds inside every call
of every rank (``verify_io``).

W = 4 runs on four ranks (one worker each) for PageRank and BFS, and on
two ranks (two workers each, so same-rank batches stay off the sockets)
for SSSP and WCC."""
import pytest

import torchprochelp as tph

CASES = [(a, w) for w in (2, 4) for a in ("pagerank", "bfs", "sssp", "wcc")]
WORLD = {("sssp", 4): 2, ("wcc", 4): 2}
# the reference's own ranks too, where they are not already run by
# tests/test_torch_transport.py
JAX_PROCS = {("sssp", 4), ("wcc", 4), ("wcc", 2)}


@pytest.fixture(scope="module")
def prob(tmp_path_factory):
    return tph.build_problem(str(tmp_path_factory.mktemp("pproc")))


@pytest.fixture(scope="module")
def jprob(tmp_path_factory):
    import prochelp
    return prochelp.build_problem(str(tmp_path_factory.mktemp("jpproc")))


@pytest.mark.parametrize("algname,w", CASES)
def test_process_mode_matches_threads_and_jax(prob, jprob, tmp_path,
                                              algname, w):
    import prochelp
    world = WORLD.get((algname, w), w)
    spec, codes, results = tph.run_procs(prob, w, algname,
                                         str(tmp_path / "port"), world=world)
    assert codes == [0] * world, [tph.rank_log(spec, r)
                                  for r in range(world)]
    base = tph.run_threads(prob, w, algname)
    for res in results.values():
        tph.assert_result_equal(res, base)
        assert int(res["recoveries"]) == 0
        assert res["wire_frames"].sum() > 0
    tph.assert_matches_jax(results[0], prochelp.run_threads(jprob, w,
                                                            algname),
                           algname)
    if (algname, w) in JAX_PROCS:
        _, jcodes, jres = prochelp.run_procs(jprob, w, algname,
                                             str(tmp_path / "jax"),
                                             world=world)
        assert jcodes == [0] * world
        tph.assert_matches_jax(results[0], jres[0], algname)
