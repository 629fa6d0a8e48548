"""The port's DIST_OOC multi-query path against JAX DIST_OOC multi-query on
the same graph (R-MAT scale 7, edge factor 16, seed 5, weighted; P = 4,
batch 16; Q = 3, the top-3 out-degree sources; W = 2 and 4 worker shards).

* The multi-query wire: :meth:`Exchange.post_mq` payloads, tallies and
  ``bytes_sent`` byte-identical to the reference's in the panel, legacy
  and ``local_mq`` cases, with compression on and off, and equal to
  ``phases.mq_wire_bytes``; :meth:`Exchange.take_dest_mq` and
  ``DecodeAhead(num_queries=Q)`` views equal to the reference's, with the
  gap streams through the host codec and through the stencil + add scan
  path (their plain versions on the CPU).
* The executor: ``multi_bfs`` (MIN, bit-equal), ``personalized_pagerank``
  (ADD, rtol/atol 1e-5) and ``pairwise_reachability`` on both backends —
  values, iterations, per-iteration returns (1e-5), every counter and
  ``worker_totals`` equal to the reference's (``seek_cost`` rel 1e-5;
  ``measured_chunks_device_decoded`` is the port's decode path), the
  measured disk and wire bytes equal to the model, MIN results bit-equal
  to the port's LOCAL multi-query run; a dead query costs nothing; the
  spills after a run are byte-identical and open in both packages.
* Parallel workers: bit-identical to sequential ones — values,
  per-iteration returns, every counter and ``worker_totals``.

The JAX package is imported inside the fixtures and tests that compare
with it, so ``pytest -m cuda`` loads this module on a machine without
jax."""
import os
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import (
    ChunkStore, Engine, EngineConfig, GraphServeSession, VertexSpill,
    accumulate_counters, codec, phases,
)
from repro_torch.core import algorithms as alg
from repro_torch.core import exchange as ex
from repro_torch.core.engine import DIST_MEASURED_PAIRS
from repro_torch.data.graphs import rmat_graph

from torchhelp import jax_fields

NQ = 3
ALGOS = ["multi_bfs", "personalized_pagerank", "pairwise_reachability"]


def _ref():
    from repro import core
    from repro.core import algorithms, exchange
    return types.SimpleNamespace(core=core, alg=algorithms, ex=exchange)


# ---------------------------------------------------------------------------
# The multi-query wire
# ---------------------------------------------------------------------------

V_MAX = 2048


def _columns(kind, seed, nq=NQ):
    """[nq, V_MAX] send masks and values of one (p, q) batch whose arms
    price as ``kind`` says: ``"shared"`` columns over mostly the same
    positions (the panel is shorter), ``"apart"`` one sparse column and
    one single far entry (the legacy items are shorter), ``"mixed"`` a
    dense, a sparse and an empty column."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((nq, V_MAX), bool)
    if kind == "shared":
        base = rng.random(V_MAX) < 0.2
        for j in range(nq):
            masks[j] = base & (rng.random(V_MAX) < 0.9)
    elif kind == "apart":
        masks[0] = rng.random(V_MAX) < 0.01
        masks[1, V_MAX - 1] = True
    else:
        masks[0] = rng.random(V_MAX) < 0.7
        masks[1] = rng.random(V_MAX) < 0.05
    values = rng.random((nq, V_MAX)).astype(np.float32)
    values[-1] = 2.5                                  # a uniform column
    return masks, values


def _price(masks, values, compression):
    """``phases.mq_wire_bytes`` of one batch (numpy, float64)."""
    counts = masks.sum(axis=1).astype(np.float64)
    union = masks.any(axis=0)
    if not compression:
        return float(phases.mq_wire_bytes(counts, float(union.sum()), V_MAX,
                                          4, xp=np))
    gap = codec.mask_gap_bytes(masks, xp=np)
    uni = phases.batch_value_uniform(masks[:, None], values[:, None],
                                     xp=np)[:, 0]
    return float(phases.mq_wire_bytes(
        counts, float(union.sum()), V_MAX, 4, gap_bytes=gap,
        union_gap=float(codec.mask_gap_bytes(union[None], xp=np)[0]),
        uniform=uni, xp=np))


@pytest.mark.parametrize("kind,compression,entry", [
    ("shared", True, "wire_mq_panel"), ("mixed", True, "wire_mq_legacy"),
    ("apart", True, "wire_mq_legacy"), ("shared", False, "wire_mq_legacy"),
    ("mixed", False, "wire_mq_legacy"), ("shared", True, "local_mq")])
def test_post_mq_matches_jax(kind, compression, entry):
    """One multi-query batch through both packages' exchanges: the same
    arm, payloads, tallies and ``bytes_sent``, which equals the model's
    price; a worker-local batch costs nothing and moves no bytes."""
    ref = _ref().ex
    masks, values = _columns(kind, seed=len(kind) + compression)
    counts = [int(c) for c in masks.sum(axis=1)]
    dst = 0 if entry == "local_mq" else 1
    port = ex.Exchange(2, V_MAX, compression=compression)
    jax = ref.Exchange(2, V_MAX, compression=compression)
    for e in (port, jax):
        e.post_mq(0, dst, 0, 2, masks, values, counts)
    a, b = port.counter_snapshot(), jax.counter_snapshot()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    (p, mine), = port._inbox[dst][2]
    (jp, theirs), = jax._inbox[dst][2]
    assert p == jp == 0 and mine[0] == theirs[0] == entry
    if entry == "local_mq":
        assert a["bytes_sent"] == 0 and a["posted"][0, 0] == 1
        assert mine[1] is masks and mine[2] is values
        return
    assert mine == theirs                  # cols, counts, payload bytes
    assert a["bytes_sent"] == _price(masks, values, compression) > 0
    assert a["mq_batches"] == (entry == "wire_mq_panel")
    if entry == "wire_mq_legacy":
        assert a["bytes_sent"] == sum(len(it[3]) for it in mine[1])
        assert [it[0] for it in mine[1]] == [j for j, c in enumerate(counts)
                                             if c]


def _mq_posts(p_cnt, seed):
    """Every (p, q) multi-query batch of a seeded round: a mix of the
    three shapes above."""
    out = []
    for p in range(p_cnt):
        for q in range(p_cnt):
            kind = ("shared", "apart", "mixed")[(p + 2 * q + seed) % 3]
            masks, values = _columns(kind, seed=seed * 100 + p * 10 + q)
            out.append((p, q, masks, values,
                        [int(c) for c in masks.sum(axis=1)]))
    return out


def _posted_pair(compression, seed, p_cnt=4, w_cnt=2):
    ref = _ref().ex
    worker_of = np.repeat(np.arange(w_cnt), p_cnt // w_cnt)
    port = ex.Exchange(w_cnt, V_MAX, compression=compression)
    jax = ref.Exchange(w_cnt, V_MAX, compression=compression)
    for p, q, masks, values, counts in _mq_posts(p_cnt, seed):
        for e in (port, jax):
            e.post_mq(int(worker_of[p]), int(worker_of[q]), p, q, masks,
                      values, counts)
    return port, jax, worker_of


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "device_path"])
@pytest.mark.parametrize("compression", [True, False])
def test_take_dest_mq_matches_jax(compression, device):
    """[Q, P, v_max] receive views equal to the reference's, every entry
    kind among them; an inbox drains once."""
    port, jax, worker_of = _posted_pair(compression, seed=int(compression))
    kinds = {e[0] for box in port._inbox for es in box.values()
             for _, e in es}
    assert kinds == ({"local_mq", "wire_mq_panel", "wire_mq_legacy"}
                     if compression else {"local_mq", "wire_mq_legacy"})
    for q in range(4):
        w = int(worker_of[q])
        mine = port.take_dest_mq(w, q, 4, NQ, device=device)
        theirs = jax.take_dest_mq(w, q, 4, NQ)
        assert mine[0].shape == (NQ, 4, V_MAX)
        for x, y in zip(mine, theirs):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert not port.take_dest_mq(0, 0, 4, NQ)[0].any()


def test_take_dest_mq_device_path_counts_streams(monkeypatch):
    """With a device, every gap stream — the panels' union streams and the
    legacy vpairs / uval items' — goes through ``_gap_decode`` on it, and
    none without one."""
    port, _, worker_of = _posted_pair(True, seed=4)
    panels = legacy = 0
    for box in port._inbox:
        for es in box.values():
            for _, e in es:
                panels += e[0] == "wire_mq_panel"
                if e[0] == "wire_mq_legacy":
                    legacy += sum(it[1] in (ex.FMT_VPAIRS, ex.FMT_UVAL)
                                  for it in e[1])
    seen = []
    real = ex._gap_decode
    monkeypatch.setattr(ex, "_gap_decode", lambda s, c, device=None: (
        seen.append(device), real(s, c, device))[1])
    for q in range(4):
        port.take_dest_mq(int(worker_of[q]), q, 4, NQ, device="cpu")
    assert panels > 0 and legacy > 0
    assert seen == ["cpu"] * (panels + legacy)


def test_post_mq_from_racing_threads():
    """Eight senders posting multi-query batches at once, the interpreter
    switching threads every microsecond: the tallies, the bytes and the
    receive views are those of one sequential sender."""
    p_cnt, w_cnt = 8, 8
    posts = _mq_posts(p_cnt, seed=6)
    seq = ex.Exchange(w_cnt, V_MAX)
    for p, q, masks, values, counts in posts:
        seq.post_mq(p, q, p, q, masks, values, counts)
    par = ex.Exchange(w_cnt, V_MAX)
    barrier = threading.Barrier(p_cnt)

    def send(p):
        barrier.wait(timeout=30)
        for pp, q, masks, values, counts in posts:
            if pp == p:
                par.post_mq(p, q, p, q, masks, values, counts)

    threads = [threading.Thread(target=send, args=(p,)) for p in range(p_cnt)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    a, b = seq.counter_snapshot(), par.counter_snapshot()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["mq_batches"] > 0
    for q in range(p_cnt):
        for x, y in zip(seq.take_dest_mq(q, q, p_cnt, NQ),
                        par.take_dest_mq(q, q, p_cnt, NQ)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("runner", [False, True], ids=["thread", "runner"])
def test_decode_ahead_yields_panels(runner):
    """``DecodeAhead(num_queries=Q)`` delivers each destination's
    [Q, P, v_max] view in order, equal to ``take_dest_mq`` on a twin
    exchange, under the compute token, and times its takes."""
    port, _, _ = _posted_pair(True, seed=2)
    twin, _, _ = _posted_pair(True, seed=2)
    lock = threading.Lock()
    with ThreadPoolExecutor(2) as pool:
        ahead = ex.DecodeAhead(port, 1, [2, 3], 4, compute_lock=lock,
                               runner=pool if runner else None, device="cpu",
                               num_queries=NQ)
        got = list(ahead)
    assert [g[0] for g in got] == [2, 3]
    for q, mask, msg in got:
        want = twin.take_dest_mq(1, q, 4, NQ)
        assert mask.shape == (NQ, 4, V_MAX)
        np.testing.assert_array_equal(mask, want[0])
        np.testing.assert_array_equal(msg, want[1])
    assert ahead.take_s > 0 and not lock.locked()


# ---------------------------------------------------------------------------
# The executor against JAX DIST_OOC multi-query
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    ref = _ref().core
    g = rmat_graph(7, 16, seed=5, weighted=True)
    spec = ref.make_spec(g, num_partitions=4, batch_size=16)
    jdg = ref.build_dist_graph(g, spec)
    jfm = ref.build_formats(jdg)
    return dict(
        g=g, jdg=jdg, jfm=jfm,
        dg=interop.dist_graph_from_arrays(jax_fields(jdg), device="cpu"),
        fm=interop.formats_from_arrays(jax_fields(jfm), device="cpu"),
        sources=[int(v) for v in
                 np.argsort(-g.out_degrees(), kind="stable")[:NQ]])


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A fresh directory per store, so every engine gets its own spills."""
    base = tmp_path_factory.mktemp("dist_mq")
    count = iter(range(10**6))
    return lambda tag: str(base / f"{tag}{next(count)}")


def jax_engine(problem, roots, w, nq=NQ, **kw):
    ref = _ref().core
    store = ref.ChunkStore.build_sharded(problem["jdg"], problem["jfm"],
                                         roots("jax"), w)
    return ref.Engine(problem["jdg"], problem["jfm"], ref.EngineConfig(
        executor="dist_ooc", num_workers=w, num_queries=nq, **kw),
        store=store)


def port_engine(problem, roots, w, nq=NQ, **kw):
    store = ChunkStore.build_sharded(problem["dg"], problem["fm"],
                                     roots("port"), w)
    return Engine(problem["dg"], problem["fm"], EngineConfig(
        executor="dist_ooc", num_workers=w, num_queries=nq, **kw),
        store=store, device="cpu")


def drive(mod, eng, algo, sources):
    if algo == "multi_bfs":
        return mod.multi_bfs(eng, sources)
    if algo == "personalized_pagerank":
        return mod.personalized_pagerank(eng, sources, num_iters=3)
    pairs = [(s, sources[(k + 1) % len(sources)])
             for k, s in enumerate(sources)]
    return mod.pairwise_reachability(eng, pairs)


@pytest.fixture(scope="module")
def jax_runs(problem, roots):
    cache = {}

    def get(algo, w, backend):
        key = (algo, w, backend)
        if key not in cache:
            eng = jax_engine(problem, roots, w, compute_backend=backend)
            cache[key] = (*drive(_ref().alg, eng, algo, problem["sources"]),
                          eng)
        return cache[key]
    return get


@pytest.fixture(scope="module")
def port_runs(problem, roots):
    cache = {}

    def get(algo, w, backend="segment", parallel=False, device_decode=False):
        key = (algo, w, backend, parallel, device_decode)
        if key not in cache:
            eng = port_engine(problem, roots, w, compute_backend=backend,
                              parallel_workers=parallel,
                              device_decode=device_decode)
            cache[key] = (*drive(alg, eng, algo, problem["sources"]), eng)
        return cache[key]
    return get


def _same_values(algo, v, jv):
    if algo == "personalized_pagerank":
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    elif algo == "pairwise_reachability":
        np.testing.assert_array_equal(v, jv)
    else:
        assert v.dtype == jv.dtype
        np.testing.assert_array_equal(v.view(np.int32), jv.view(np.int32))


def _assert_matches_jax(algo, port, jax, device_decode=False):
    (v, s, eng), (jv, js, jeng) = port, jax
    _same_values(algo, v, jv)
    assert s.iterations == js.iterations
    np.testing.assert_allclose(np.asarray(s.per_iter_return),
                               np.asarray(js.per_iter_return),
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
    assert eng.worker_totals == jeng.worker_totals


@pytest.mark.parametrize("w,backend", [(2, "segment"), (2, "block_csr"),
                                       (4, "segment")])
@pytest.mark.parametrize("algo", ALGOS)
def test_matches_jax_dist_ooc(problem, jax_runs, port_runs, algo, w,
                              backend):
    _assert_matches_jax(algo, port_runs(algo, w, backend),
                        jax_runs(algo, w, backend))


@pytest.mark.parametrize("algo", ALGOS[:2])
def test_device_decode_path_matches_jax(jax_runs, port_runs, algo):
    """block_csr with every chunk through the fused decode's path and
    every wire gap stream through the stencil + add scan path (their plain
    versions here)."""
    _assert_matches_jax(algo, port_runs(algo, 2, "block_csr",
                                        device_decode=True),
                        jax_runs(algo, 2, "block_csr"), device_decode=True)


def test_multi_bfs_matches_local(problem, port_runs):
    """Each column bit-equal to the port's LOCAL multi-query run, with the
    same iteration counts, on both backends."""
    local = Engine(problem["dg"], problem["fm"],
                   EngineConfig(num_queries=NQ), device="cpu")
    lv, ls = alg.multi_bfs(local, problem["sources"])
    for backend in ("segment", "block_csr"):
        v, s, _ = port_runs("multi_bfs", 2, backend)
        np.testing.assert_array_equal(v.view(np.int32), lv.view(np.int32))
        assert s.iterations == ls.iterations


def test_wire_carries_panels_and_legacy_batches(problem, roots, monkeypatch):
    """BFS frontiers move as panels, solo-format (legacy) batches and
    worker-local hand-offs, all three; the legacy items' formats are
    what the batch counters report."""
    kinds = []
    real = ex.Exchange._put_entry
    monkeypatch.setattr(ex.Exchange, "_put_entry", lambda self, *a: (
        kinds.append(a[-1]), real(self, *a))[1])
    eng = port_engine(problem, roots, 2)
    _, st = alg.multi_bfs(eng, problem["sources"])
    names = [e[0] for e in kinds]
    assert {"local_mq", "wire_mq_panel", "wire_mq_legacy"} <= set(names)
    fmts = [it[1] for e in kinds if e[0] == "wire_mq_legacy" for it in e[1]]
    c = st.counters
    assert c["net_uval_batches"] == fmts.count(ex.FMT_UVAL)
    assert c["net_vpair_batches"] == fmts.count(ex.FMT_VPAIRS)
    assert c["net_pair_batches"] + c["net_slab_batches"] == \
        fmts.count(ex.FMT_PAIRS) + fmts.count(ex.FMT_SLAB)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("algo", ALGOS[:2])
def test_parallel_is_bit_identical(port_runs, algo, w):
    (v1, s1, e1), (v2, s2, e2) = (port_runs(algo, w),
                                  port_runs(algo, w, parallel=True))
    np.testing.assert_array_equal(v1.view(np.int32), v2.view(np.int32))
    assert s1.iterations == s2.iterations
    assert [list(r) for r in s1.per_iter_return] == \
        [list(r) for r in s2.per_iter_return]
    assert s1.counters == s2.counters
    assert e1.worker_totals == e2.worker_totals
    assert all(t["recv_s"] > 0 and t["send_s"] > 0 for t in e2.worker_times)


def test_parallel_device_paths_repeat_bit_identical(problem, roots,
                                                    port_runs):
    """The raciest shape (W = 4, block_csr, every chunk and gap stream
    through the device path) twice on fresh parallel engines against one
    sequential run."""
    v1, s1, e1 = port_runs("multi_bfs", 4, "block_csr", device_decode=True)
    for _ in range(2):
        eng = port_engine(problem, roots, 4, compute_backend="block_csr",
                          parallel_workers=True, device_decode=True)
        v2, s2 = alg.multi_bfs(eng, problem["sources"])
        np.testing.assert_array_equal(v1.view(np.int32), v2.view(np.int32))
        assert s1.counters == s2.counters
        assert e1.worker_totals == eng.worker_totals


def test_parallel_under_a_short_switch_interval(problem, roots, port_runs):
    """W = 4 parallel PPR (every worker busy on every step) with the
    interpreter switching threads every microsecond: still bit-identical
    to the sequential run, so no update is lost to a race."""
    v1, s1, e1 = port_runs("personalized_pagerank", 4, "block_csr")
    eng = port_engine(problem, roots, 4, compute_backend="block_csr",
                      parallel_workers=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        v2, s2 = drive(alg, eng, "personalized_pagerank", problem["sources"])
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(v1.view(np.int32), v2.view(np.int32))
    assert s1.counters == s2.counters
    assert e1.worker_totals == eng.worker_totals


def test_dead_query_costs_nothing(problem, roots):
    """A query from a vertex with no out-edges dies after one iteration;
    from then on it reads and writes nothing: the batch's logical counters
    are the sum of the solo DIST_OOC runs' exactly, and every counter
    equals the reference's."""
    g = problem["g"]
    sink = int(np.nonzero(g.out_degrees() == 0)[0][0])
    sources = [problem["sources"][0], sink, problem["sources"][1]]
    jeng = jax_engine(problem, roots, 2, compute_backend="block_csr")
    peng = port_engine(problem, roots, 2, compute_backend="block_csr")
    got = (*alg.multi_bfs(peng, sources), peng)
    _assert_matches_jax("multi_bfs", got,
                        (*_ref().alg.multi_bfs(jeng, sources), jeng))
    its = got[1].iterations
    assert its[1] == 1 < min(its[0], its[2])
    solo = {}
    for s in sources:
        eng = port_engine(problem, roots, 2, nq=1)
        solo = accumulate_counters(solo, alg.bfs(eng, s)[1].counters)
    for k in ("msgs_generated", "msgs_sent", "edges_touched",
              "vertex_read_bytes", "vertex_write_bytes",
              "measured_vertex_read_bytes", "measured_vertex_write_bytes"):
        assert got[1].counters[k] == solo[k], k


def _spill_files(eng):
    out = {}
    for w, sp in enumerate(eng.spills):
        for f in sorted(os.listdir(sp.root)):
            with open(os.path.join(sp.root, f), "rb") as fh:
                out[w, f] = fh.read()
    return out


def test_spills_match_jax_and_cross_open(problem, jax_runs, port_runs):
    """After the same BFS run (a MIN fold, so the same bits), every
    worker's spill is byte-identical to the reference's, and each package
    opens the other's: the reference attaches the port's spill (its
    recovery path) and finds the port's per-query columns, and the port
    opens the reference's (``spill_meta.json``'s Q checked) and reads its
    ``active_q{j}`` bitmaps, their CRCs verified."""
    ref = _ref().core
    *_, peng = port_runs("multi_bfs", 2, "block_csr")
    *_, jeng = jax_runs("multi_bfs", 2, "block_csr")
    mine, theirs = _spill_files(peng), _spill_files(jeng)
    assert mine.keys() == theirs.keys()
    assert any(f == "active_q2.bits" for _, f in mine)
    for k in mine:
        assert mine[k] == theirs[k], k
    spec = problem["dg"].spec
    for w, (psp, jsp) in enumerate(zip(peng.spills, jeng.spills)):
        dims = (len(peng.worker_parts[w]), spec.num_batches,
                spec.batch_size, spec.v_max)
        theirs_view = ref.VertexSpill(psp.root, *dims, num_queries=NQ)
        theirs_view.attach()
        got, want = theirs_view.state_views(), psp.state_views()
        assert sorted(got) == sorted(want) and "level@q2" in got
        for name in got:
            np.testing.assert_array_equal(np.asarray(got[name]), want[name])
        mine_view = VertexSpill(jsp.root, *dims, num_queries=NQ)
        for j in range(NQ):
            np.testing.assert_array_equal(
                mine_view.read_bitmap(name=f"active_q{j}"),
                jsp.read_bitmap(name=f"active_q{j}"))


def test_session_parallel_is_bit_identical(problem, roots):
    """A two-slot session over five queries with workers in sequence and
    in parallel: the same results, wait and run iterations, counters and
    ``worker_totals``."""
    sources = [int(v) for v in np.argsort(-problem["g"].out_degrees(),
                                          kind="stable")[:5]]
    out = []
    for parallel in (False, True):
        eng = port_engine(problem, roots, 2, nq=2,
                          compute_backend="block_csr",
                          parallel_workers=parallel)
        sess = GraphServeSession(eng)
        for s in sources:
            sess.submit(s)
        res = sorted(sess.drain(), key=lambda r: r.qid)
        out.append((res, sess.counters, eng.worker_totals, sess.steps))
    (r1, c1, t1, n1), (r2, c2, t2, n2) = out
    assert [r.source for r in r1] == sources and n1 == n2
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.levels.view(np.int32),
                                      b.levels.view(np.int32))
        assert (a.wait_iters, a.run_iters) == (b.wait_iters, b.run_iters)
    assert c1 == c2 and t1 == t2


# ---------------------------------------------------------------------------
# The DIST_OOC multi-query path on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def cuda_problem(tmp_path):
    from repro_torch.core import build_dist_graph, build_formats, make_spec
    g = rmat_graph(9, 8, seed=1, weighted=True)
    dg = build_dist_graph(g, make_spec(g, num_partitions=4, batch_size=16))
    fm = build_formats(dg)
    sources = [int(v) for v in np.argsort(-g.out_degrees(),
                                          kind="stable")[:5]]

    def engine(device=None, **kw):
        store = ChunkStore.build_sharded(
            dg, fm, str(tmp_path / f"s{len(os.listdir(tmp_path))}"), 2)
        return Engine(dg, fm, EngineConfig(
            executor="dist_ooc", num_workers=2, compute_backend="block_csr",
            **kw), store=store, device=device)
    return g, sources, engine


class _Counts:
    """The path's launch counts around one run, and the wire gap streams
    decoded on the card (each one stencil and one add scan)."""

    def __init__(self, monkeypatch):
        from repro_torch.kernels import chunk_decode, csr_spmv, varint
        self.mods = chunk_decode, csr_spmv, varint
        self.streams = 0
        real = ex._gap_decode

        def counted(stream, count, device=None):
            if device is not None and count:
                self.streams += 1
            return real(stream, count, device)

        monkeypatch.setattr(ex, "_gap_decode", counted)
        varint.reset_launches()
        chunk_decode.reset_launches()
        csr_spmv.block_csr_combine_mq.launches = 0
        self.solo0 = csr_spmv.block_csr_combine.launches

    def check(self):
        chunk_decode, csr_spmv, varint = self.mods
        assert self.streams > 0
        assert varint.byte_stencil.launches == self.streams
        assert varint.blocked_scan.launches_by_mode == {"add": self.streams,
                                                        "max": 0}
        assert 0 < chunk_decode.decode_item.launches <= \
            2 * chunk_decode.decode_item.calls
        assert csr_spmv.block_csr_combine_mq.launches > 0
        assert csr_spmv.block_csr_combine.launches == self.solo0


@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [False, True])
def test_dist_multi_bfs_on_cuda(cuda_device, cuda_problem, parallel,
                                monkeypatch):
    """W = 2, Q = 3 ``multi_bfs`` on the card (device decode on by default):
    the panel combine, the fused decode, the stencil and the add scan
    launched as the path needs them, and levels, iterations and every
    counter but the device-decoded chunk count equal to the same run on
    the CPU (the plain versions)."""
    g, sources, engine = cuda_problem
    cpu = engine(device="cpu", num_queries=3)
    want, wst = alg.multi_bfs(cpu, sources[:3])
    eng = engine(num_queries=3, parallel_workers=parallel)
    assert eng.device.type == "cuda" and eng.device_decode
    counts = _Counts(monkeypatch)
    got, st = alg.multi_bfs(eng, sources[:3])
    counts.check()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert st.iterations == wst.iterations
    assert st.counters["measured_chunks_device_decoded"] == \
        st.counters["measured_chunks_read"] > 0
    for k, v in wst.counters.items():
        if k != "measured_chunks_device_decoded":
            assert st.counters[k] == v, k
    assert eng.worker_totals == cpu.worker_totals


@pytest.mark.cuda
def test_dist_session_on_cuda(cuda_device, cuda_problem, monkeypatch):
    """Two steps of a two-slot session over five queries on the card equal
    the same two steps on the CPU: results so far, the panels and every
    counter but the device-decoded chunk count."""
    g, sources, engine = cuda_problem
    runs = []
    for device in ("cpu", None):
        sess = GraphServeSession(engine(device=device, num_queries=2))
        for s in sources:
            sess.submit(s)
        if device is None:
            counts = _Counts(monkeypatch)
        done = sess.step() + sess.step()
        if device is None:
            counts.check()
        runs.append((done, sess))
    (d1, s1), (d2, s2) = runs
    assert [r.qid for r in d1] == [r.qid for r in d2]
    for a, b in zip(d1, d2):
        np.testing.assert_array_equal(a.levels.view(np.int32),
                                      b.levels.view(np.int32))
    np.testing.assert_array_equal(s1._state["level"], s2._state["level"])
    np.testing.assert_array_equal(s1._active, s2._active)
    for k, v in s1.counters.items():
        if k != "measured_chunks_device_decoded":
            assert s2.counters[k] == v, k
