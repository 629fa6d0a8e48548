"""The port's distributed out-of-core executor (``executor="dist_ooc"``)
against JAX DIST_OOC on the same graph (R-MAT scale 7, edge factor 16,
seed 5, weighted; P = 4, batch 16) and W = 1, 2, 4 worker shards.

* Sharded stores: the port builds byte-identical ``shards.json`` and
  shards, and each package opens the other's.
* Results: values (BFS/SSSP/WCC are MIN folds, bit-equal; PageRank sums in
  another order, rtol/atol 1e-5), iteration counts, per-iteration returns
  (1e-5), every counter — the measured wire bytes and the per-format batch
  counts included — and ``worker_totals`` equal to the reference's, except
  ``seek_cost`` (a float32 sum, rel 1e-5) and
  ``measured_chunks_device_decoded`` (the reference decodes on the host);
  ``measured == model`` for disk and network holds inside every call
  (``verify_io``).
* Parallel workers: bit-identical to the sequential run — values,
  per-iteration returns, every counter and ``worker_totals``.

The JAX package is imported inside the fixtures and tests that compare
with it, so ``pytest -m cuda`` loads this module on a machine without
jax."""
import os
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import (
    ChunkStore, ChunkStoreError, Engine, EngineConfig, ShardedChunkStore,
)
from repro_torch.core import algorithms as alg
from repro_torch.core import phases
from repro_torch.core.chunkstore import MANIFEST_VERSION, REP_DCSR
from repro_torch.core.engine import DIST_MEASURED_PAIRS
from repro_torch.data.graphs import rmat_graph

from torchhelp import jax_fields

WORKERS = [1, 2, 4]
ALGOS = ["pagerank", "bfs", "sssp", "wcc"]


def _ref():
    from repro import core
    from repro.core import algorithms
    return types.SimpleNamespace(core=core, alg=algorithms)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """Both packages' structures and W-worker sharded stores of the
    forward and the reversed graph: ``jax`` built by the reference,
    ``port`` by the port."""
    ref = _ref().core
    g = rmat_graph(7, 16, seed=5, weighted=True)
    spec = ref.make_spec(g, num_partitions=4, batch_size=16)
    out = {"g": g, "src": int(np.argmax(g.out_degrees()))}
    for name, graph in (("fwd", g), ("rev", g.reversed())):
        root = tmp_path_factory.mktemp(f"dist_{name}")
        jdg = ref.build_dist_graph(graph, spec)
        jfm = ref.build_formats(jdg)
        dg = interop.dist_graph_from_arrays(jax_fields(jdg), device="cpu")
        fm = interop.formats_from_arrays(jax_fields(jfm), device="cpu")
        stores = {}
        for w in WORKERS:
            stores["jax", w] = ref.ChunkStore.build_sharded(
                jdg, jfm, str(root / f"jax{w}"), w)
            stores["port", w] = ChunkStore.build_sharded(
                dg, fm, str(root / f"port{w}"), w)
        out[name] = types.SimpleNamespace(jdg=jdg, jfm=jfm, dg=dg, fm=fm,
                                          stores=stores)
    return out


def port_engine(problem, name, w, **kw):
    p = problem[name]
    cfg = EngineConfig(executor="dist_ooc", num_workers=w, **kw)
    return Engine(p.dg, p.fm, cfg, store=p.stores["port", w], device="cpu")


def run(problem, algo, make, mod=alg):
    """One algorithm through ``mod`` on engines from ``make(name)``;
    returns (values, stats, engines)."""
    src = problem["src"]
    engines = [make("fwd")]
    if algo == "pagerank":
        out = mod.pagerank(engines[0], 4)
    elif algo in ("bfs", "sssp"):
        out = getattr(mod, algo)(engines[0], src)
    else:
        engines.append(make("rev"))
        out = mod.wcc(*engines)
    return (*out, engines)


@pytest.fixture(scope="module")
def jax_runs(problem):
    """JAX DIST_OOC results, computed once per (algorithm, W, backend)."""
    ref = _ref()
    cache = {}

    def get(algo, w, backend):
        if (algo, w, backend) not in cache:
            def make(name):
                p = problem[name]
                return ref.core.Engine(
                    p.jdg, p.jfm, ref.core.EngineConfig(
                        executor="dist_ooc", num_workers=w,
                        compute_backend=backend),
                    store=p.stores["jax", w])
            cache[algo, w, backend] = run(problem, algo, make, ref.alg)
        return cache[algo, w, backend]
    return get


@pytest.fixture(scope="module")
def port_runs(problem):
    """Port DIST_OOC results, computed once per (algorithm, W, backend,
    parallel_workers, device_decode)."""
    cache = {}

    def get(algo, w, backend="segment", parallel=False,
            device_decode=False):
        key = (algo, w, backend, parallel, device_decode)
        if key not in cache:
            cache[key] = run(problem, algo, lambda name: port_engine(
                problem, name, w, compute_backend=backend,
                parallel_workers=parallel, device_decode=device_decode))
        return cache[key]
    return get


# ---------------------------------------------------------------------------
# Sharded stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORKERS)
def test_sharded_store_is_byte_identical(problem, w):
    for name in ("fwd", "rev"):
        jroot = problem[name].stores["jax", w].root
        proot = problem[name].stores["port", w].root
        assert _files(jroot) == _files(proot)
        assert "shards.json" in _files(proot)
        for f in _files(jroot):
            with open(os.path.join(jroot, f), "rb") as a, \
                    open(os.path.join(proot, f), "rb") as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("w", WORKERS)
def test_sharded_store_cross_open(problem, w):
    """Each package opens the other's sharded store; the shards own the
    same partitions and serve the same chunk bytes."""
    ref = _ref().core
    p = problem["fwd"]
    mine = ShardedChunkStore.open(p.stores["jax", w].root)
    theirs = ref.ShardedChunkStore.open(p.stores["port", w].root)
    assert mine.num_workers == theirs.num_workers == w
    np.testing.assert_array_equal(mine.worker_of, theirs.worker_of)
    for a, b in zip(mine.shards, theirs.shards):
        assert tuple(a.partitions) == tuple(b.partitions)
        for q, pp, k in a.nonempty_chunks():
            assert a.read_chunk_bytes(q, pp, k, REP_DCSR) == \
                b.read_chunk_bytes(q, pp, k, REP_DCSR)
    assert mine.verify() == []


def test_shard_refuses_unowned_reads(problem):
    store = ShardedChunkStore.open(problem["fwd"].stores["port", 2].root)
    assert [tuple(s.partitions) for s in store.shards] == [(0, 1), (2, 3)]
    with pytest.raises(ChunkStoreError, match="not owned"):
        store.shards[0].read_chunk(3, 0, 0, REP_DCSR)
    fresh = store.reopen_shard(1)
    assert store.shards[1] is fresh and fresh.partitions == (2, 3)
    with pytest.raises(ChunkStoreError, match="out of range"):
        store.reopen_shard(2)


def test_sharded_manifest_robust_open(tmp_path):
    root = tmp_path / "empty"
    root.mkdir()
    with pytest.raises(ChunkStoreError, match="shard manifest"):
        ShardedChunkStore.open(str(root))
    (root / "shards.json").write_text("{}")
    with pytest.raises(ChunkStoreError, match="missing keys"):
        ShardedChunkStore.open(str(root))
    (root / "shards.json").write_text(
        '{"version": 99, "num_workers": 1, "num_partitions": 2}')
    with pytest.raises(ChunkStoreError, match="found version 99"):
        ShardedChunkStore.open(str(root))
    (root / "shards.json").write_text(
        '{"version": %d, "num_workers": 0, "num_partitions": 2}'
        % MANIFEST_VERSION)
    with pytest.raises(ChunkStoreError, match="positive integer"):
        ShardedChunkStore.open(str(root))


# ---------------------------------------------------------------------------
# Parity with JAX DIST_OOC
# ---------------------------------------------------------------------------

def _assert_matches_jax(port, jax, algo, device_decode):
    (v, s, engs), (jv, js, jengs) = port, jax
    if algo == "pagerank":
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    else:
        assert v.dtype == jv.dtype
        np.testing.assert_array_equal(v.view(np.int32), jv.view(np.int32))
    assert s.iterations == js.iterations
    np.testing.assert_allclose(s.per_iter_return, js.per_iter_return,
                               rtol=1e-5, atol=1e-7)
    assert s.counters.keys() == js.counters.keys()
    for k, want in js.counters.items():
        if k == "seek_cost":
            assert s.counters[k] == pytest.approx(want, rel=1e-5), k
        elif k == "measured_chunks_device_decoded":
            assert want == 0
            assert s.counters[k] == (s.counters["measured_chunks_read"]
                                     if device_decode else 0)
        else:
            assert s.counters[k] == want, (k, s.counters[k], want)
    for mk, ak in DIST_MEASURED_PAIRS:
        assert s.counters[mk] == s.counters[ak], mk
    for e, je in zip(engs, jengs):
        assert e.worker_totals == je.worker_totals


@pytest.mark.parametrize("w", WORKERS)
@pytest.mark.parametrize("algo", ALGOS)
def test_matches_jax_dist_ooc(problem, jax_runs, port_runs, algo, w):
    _assert_matches_jax(port_runs(algo, w), jax_runs(algo, w, "segment"),
                        algo, False)


@pytest.mark.parametrize("algo", ALGOS)
def test_block_csr_and_device_decode_match_jax(problem, jax_runs, port_runs,
                                               algo):
    """The block_csr combine (its plain version here) with every chunk and
    every wire gap stream decoded through the device path."""
    _assert_matches_jax(port_runs(algo, 2, "block_csr", device_decode=True),
                        jax_runs(algo, 2, "block_csr"), algo, True)


def test_wire_carries_every_compressed_format(port_runs):
    """Across the runs, the wire moved dense and sparse batches, uniform
    BFS frontiers as uval, and W = 1 nothing at all."""
    c = {a: port_runs(a, 2)[1].counters for a in ("pagerank", "bfs")}
    assert c["pagerank"]["net_slab_batches"] + \
        c["pagerank"]["net_vpair_batches"] > 0
    assert c["bfs"]["net_uval_batches"] > 0
    assert c["bfs"]["measured_net_bytes"] > 0
    solo = port_runs("pagerank", 1)[1].counters
    assert solo["net_bytes"] == solo["measured_net_bytes"] == 0


def test_pagerank_matches_oracle(problem, port_runs):
    g = problem["g"]
    pr = port_runs("pagerank", 4)[0]
    np.testing.assert_allclose(
        pr, alg.ref_pagerank(g.num_vertices, g.src, g.dst, 4),
        rtol=1e-4, atol=1e-7)


def test_worker_totals_cover_all_traffic(port_runs):
    _, st, (eng,) = port_runs("pagerank", 2)
    assert len(eng.worker_totals) == 2
    c = st.counters
    assert sum(wt["net_bytes"] for wt in eng.worker_totals) == \
        c["measured_net_bytes"]
    assert sum(wt["edges_touched"] for wt in eng.worker_totals) == \
        c["edges_touched"]
    assert sum(wt["disk_bytes"] for wt in eng.worker_totals) == (
        c["measured_edge_read_bytes"] + c["measured_vertex_read_bytes"]
        + c["measured_vertex_write_bytes"])
    for t in eng.worker_times:
        assert t["send_s"] > 0 and t["recv_s"] > 0 and t["pv_s"] > 0
        assert t["recv_s"] >= t["apply_s"] > 0


# ---------------------------------------------------------------------------
# Parallel workers: bit-identical to sequential
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_parallel_is_bit_identical(port_runs, algo, w):
    (v1, s1, e1), (v2, s2, e2) = (port_runs(algo, w),
                                  port_runs(algo, w, parallel=True))
    np.testing.assert_array_equal(v1.view(np.int32), v2.view(np.int32))
    assert s1.iterations == s2.iterations
    assert s1.per_iter_return == s2.per_iter_return
    assert s1.counters == s2.counters
    for a, b in zip(e1, e2):
        assert a.worker_totals == b.worker_totals
    assert all(t["recv_s"] > 0 for e in e2 for t in e.worker_times)


def test_parallel_device_paths_repeat_bit_identical(problem, port_runs):
    """The raciest shape (W = 4, BFS's sparse frontiers, block_csr, every
    chunk and gap stream through the device path) twice on fresh parallel
    engines against one sequential run."""
    v1, s1, (e1,) = port_runs("bfs", 4, "block_csr", device_decode=True)
    for _ in range(2):
        v2, s2, (e2,) = run(problem, "bfs", lambda name: port_engine(
            problem, name, 4, compute_backend="block_csr",
            parallel_workers=True, device_decode=True))
        np.testing.assert_array_equal(v1.view(np.int32), v2.view(np.int32))
        assert s1.counters == s2.counters
        assert s1.per_iter_return == s2.per_iter_return
        assert e1.worker_totals == e2.worker_totals


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "plain store", "worker count", "msg_bytes", "spec", "compression",
    "adaptive", "account_io"])
def test_dist_config_validation(problem, tmp_path, case):
    p = problem["fwd"]
    store2 = p.stores["port", 2]
    kw, store, match = {
        "plain store": (dict(num_workers=1), ChunkStore.open(
            p.stores["port", 1].shards[0].root), "ShardedChunkStore"),
        "worker count": (dict(num_workers=4), store2, "does not match"),
        "msg_bytes": (dict(num_workers=2, msg_bytes=8), store2, "msg_bytes"),
        "spec": (dict(num_workers=2), None, "different partitioning"),
        "compression": (dict(num_workers=2, compression=False), store2,
                        "compression"),
        "adaptive": (dict(num_workers=2, enable_adaptive_formats=False),
                     store2, "adaptive"),
        "account_io": (dict(num_workers=2, account_io=False), store2,
                       "account_io"),
    }[case]
    if case == "spec":
        from repro_torch.core import build_dist_graph, build_formats, make_spec
        g = problem["g"]
        dg8 = build_dist_graph(g, make_spec(g, num_partitions=8,
                                            batch_size=16))
        store = ChunkStore.build_sharded(dg8, build_formats(dg8),
                                         str(tmp_path / "p8"), 2)
    with pytest.raises(ValueError, match=match):
        Engine(p.dg, p.fm, EngineConfig(executor="dist_ooc", **kw),
               store=store, device="cpu")


def test_build_sharded_needs_a_divisor(problem, tmp_path):
    p = problem["fwd"]
    with pytest.raises(ValueError, match="divide"):
        ChunkStore.build_sharded(p.dg, p.fm, str(tmp_path / "never"), 3)
    assert not (tmp_path / "never").exists()


@pytest.mark.parametrize("threshold", [1.5, 0.5000000000000001])
@pytest.mark.parametrize("algo", ["pagerank", "bfs"])
def test_filter_threshold_counters_match_jax(problem, monkeypatch, algo,
                                             threshold):
    """At a filter threshold other than the default 2.0 the DIST_OOC
    filter decides as the reference's does: every counter, ``msgs_sent``
    and the measured wire bytes included, equals JAX's.  The callers pass
    the active count m as a Python number, which the compare keeps weak
    (float32), as the reference does; every call the port makes is also
    held against the reference's ``filter_sendmask`` on the same inputs,
    and the run must see an odd m."""
    from repro.core import phases as jphases
    ref = _ref()
    seen = []
    port_filter = phases.filter_sendmask

    def recorded(amask, need, need_counts, m, cfg, xp=torch):
        out = port_filter(amask, need, need_counts, m, cfg, xp=xp)
        if xp is np:
            np.testing.assert_array_equal(out, jphases.filter_sendmask(
                amask, need, need_counts, m, cfg, xp=np))
            seen.append(m)
        return out

    monkeypatch.setattr(phases, "filter_sendmask", recorded)

    def make_jax(name):
        p = problem[name]
        return ref.core.Engine(p.jdg, p.jfm, ref.core.EngineConfig(
            executor="dist_ooc", num_workers=2,
            filter_skip_threshold=threshold), store=p.stores["jax", 2])
    port = run(problem, algo, lambda name: port_engine(
        problem, name, 2, filter_skip_threshold=threshold))
    jax = run(problem, algo, make_jax, ref.alg)
    _assert_matches_jax(port, jax, algo, False)
    assert port[1].counters["msgs_sent"] == jax[1].counters["msgs_sent"]
    assert port[1].counters["measured_net_bytes"] == \
        jax[1].counters["measured_net_bytes"]
    assert all(type(m) is float for m in seen)
    assert any(int(m) % 2 == 1 for m in seen)


def test_filter_compare_follows_the_references_promotion():
    """The numpy path's skip test: a Python-number m compares in float32
    (weak, as in the reference), a numpy scalar or array m in its own
    precision.  Need count 1 against m = 2 at a threshold just above 1/2:
    1 >= float32(1.0000000000000002) holds, the float64 compare does not."""
    from repro.core import phases as jphases
    cfg = EngineConfig(enable_filtering=True,
                       filter_skip_threshold=0.5000000000000001)
    amask = np.array([True, True, False, False])
    need = np.array([[False, True, False, False], [True, True, True, True]])
    need_counts = np.array([1, 4], np.int32)
    for m, skips in ((2.0, True), (2, True), (np.float64(2.0), False),
                     (np.asarray(2.0), False)):
        got = phases.filter_sendmask(amask, need, need_counts, m, cfg, xp=np)
        want = jphases.filter_sendmask(amask, need, need_counts, m, cfg,
                                       xp=np)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0], amask if skips
                                      else amask & need[0])


def test_later_slices_raise_on_dist(problem, tmp_path):
    """Process mode takes only what the reference takes; the multi-query
    half of DIST_OOC runs: a Q = 2 engine builds on a fresh sharded store,
    and a one-query ``multi_bfs`` equals the solo BFS.

    Until process mode was ported this test asserted the
    ``NotImplementedError`` that refused any ``proc_ctx``.  The port now
    runs it (tests/test_torch_transport.py), so the same cases hold the
    reference's checks instead: a ``ValueError`` for a ``proc_ctx`` off
    ``executor="dist_ooc"``, for a worker count the context does not
    share, and for more than one query."""
    p = problem["fwd"]
    mq_store = ChunkStore.build_sharded(p.dg, p.fm, str(tmp_path / "mq"), 2)
    mq = Engine(p.dg, p.fm, EngineConfig(executor="dist_ooc", num_workers=2,
                                         num_queries=2),
                store=mq_store, device="cpu")
    assert [sp.num_queries for sp in mq.spills] == [2, 2]
    with pytest.raises(ValueError, match="only to executor='dist_ooc'"):
        Engine(p.dg, p.fm, EngineConfig(executor="ooc"),
               store=ChunkStore.build(p.dg, p.fm, str(tmp_path / "ooc")),
               proc_ctx=types.SimpleNamespace(num_workers=2), device="cpu")
    with pytest.raises(ValueError, match="num_workers"):
        Engine(p.dg, p.fm, EngineConfig(executor="dist_ooc", num_workers=2),
               store=p.stores["port", 2],
               proc_ctx=types.SimpleNamespace(num_workers=4), device="cpu")
    with pytest.raises(ValueError, match="num_queries=1"):
        Engine(p.dg, p.fm, EngineConfig(executor="dist_ooc", num_workers=2,
                                        num_queries=2),
               store=mq_store, proc_ctx=types.SimpleNamespace(num_workers=2),
               device="cpu")
    eng = Engine(p.dg, p.fm, EngineConfig(executor="dist_ooc",
                                          num_workers=2),
                 store=ChunkStore.build_sharded(p.dg, p.fm,
                                                str(tmp_path / "one"), 2),
                 device="cpu")
    levels, stats = alg.multi_bfs(eng, [problem["src"]])
    solo, solo_stats = alg.bfs(port_engine(problem, "fwd", 2),
                               problem["src"])
    np.testing.assert_array_equal(levels[:, 0].view(np.int32),
                                  solo.view(np.int32))
    assert stats.iterations == [solo_stats.iterations]
    for executor in ("auto", "ooc"):
        with pytest.raises(ValueError, match="parallel_workers"):
            Engine(p.dg, p.fm, EngineConfig(executor=executor,
                                            parallel_workers=True),
                   device="cpu")


# ---------------------------------------------------------------------------
# The DIST_OOC path on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [False, True])
def test_dist_bfs_on_cuda(cuda_device, parallel, tmp_path, monkeypatch):
    """W = 2 BFS on the card: device decode on by default, every chunk
    through the fused decode, every wire gap stream through one stencil
    and one add scan launch, the combine launched, levels equal to the
    numpy oracle and to the sequential host-decode run."""
    from repro_torch.core import build_dist_graph, build_formats, make_spec
    from repro_torch.core import exchange
    from repro_torch.kernels import chunk_decode, csr_spmv, varint
    g = rmat_graph(9, 8, seed=1, weighted=True)
    spec = make_spec(g, num_partitions=4, batch_size=16)
    n, src = g.num_vertices, int(np.argmax(g.out_degrees()))
    dg = build_dist_graph(g, spec)
    fm = build_formats(dg)
    store = ChunkStore.build_sharded(dg, fm, str(tmp_path / "s"), 2)
    streams = []
    decode = exchange._gap_decode

    def counted(stream, count, device=None):
        if device is not None and count:
            streams.append(len(stream))
        return decode(stream, count, device)

    monkeypatch.setattr(exchange, "_gap_decode", counted)
    eng = Engine(dg, fm, EngineConfig(
        executor="dist_ooc", num_workers=2, compute_backend="block_csr",
        parallel_workers=parallel), store=store)
    assert eng.device.type == "cuda" and eng.device_decode
    varint.reset_launches()
    chunk_decode.reset_launches()
    before = csr_spmv.block_csr_combine.launches
    lv, st = alg.bfs(eng, src)
    assert streams and st.counters["net_uval_batches"] > 0
    assert varint.byte_stencil.launches == len(streams)
    assert varint.blocked_scan.launches_by_mode == {"add": len(streams),
                                                    "max": 0}
    assert 0 < chunk_decode.decode_item.launches <= \
        2 * chunk_decode.decode_item.calls
    assert csr_spmv.block_csr_combine.launches > before
    assert st.counters["measured_chunks_device_decoded"] == \
        st.counters["measured_chunks_read"] > 0
    np.testing.assert_array_equal(lv, alg.ref_bfs(n, g.src, g.dst, src))
    host = Engine(dg, fm, EngineConfig(
        executor="dist_ooc", num_workers=2, compute_backend="block_csr",
        device_decode=False), store=store)
    hv, hs = alg.bfs(host, src)
    np.testing.assert_array_equal(hv.view(np.int32), lv.view(np.int32))
    for k, v in hs.counters.items():
        if k != "measured_chunks_device_decoded":
            assert st.counters[k] == v, k
