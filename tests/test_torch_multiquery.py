"""Multi-query serving in the port (``process_edges_multi``, ``multi_bfs``,
``personalized_pagerank``, ``pairwise_reachability``,
``GraphServeSession``) against the JAX package, on LOCAL (segment) and OOC
(both backends), the session also on DIST_OOC (W = 2; the rest of DIST_OOC
multi-query is ``test_torch_dist_multiquery.py``), and the panel combine
``block_csr_combine_mq``.

Sizes are the reference suite's (R-MAT scale 7, P = 4, batch size 16,
Q = 3, the top-3 out-degree sources).  Tolerances: BFS levels and the
combine's min/max modes are exact in any order (bit-equal); PPR and the
add modes sum in another order (1e-5).  OOC counters are integer counts
or float64 byte sums and must be equal; LOCAL counters are float32 sums
(rtol 1e-5), as in ``test_torch_engine.py``.

The JAX package is imported inside the tests and fixtures that compare
with it, so ``pytest -m cuda`` loads this module on a machine without
jax."""
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import (
    ChunkStore, ChunkStoreError, Engine, EngineConfig, GraphServeSession,
    accumulate_counters, build_dist_graph, build_formats, make_spec,
)
from repro_torch.core import algorithms as alg
from repro_torch.core.engine import MEASURED_PAIRS
from repro_torch.data.graphs import rmat_graph
from repro_torch.kernels import csr_spmv

from torchhelp import (
    GRAPH, SPEC, combine_layout, emulate_units, jax_fields, row_lengths,
)

NQ = 3
F32_MAX = float(np.finfo(np.float32).max)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref():
    from repro import core
    from repro.core import algorithms
    return types.SimpleNamespace(core=core, alg=algorithms)


def _top_sources(g, k):
    return [int(v) for v in np.argsort(-g.out_degrees(), kind="stable")[:k]]


def _pick_sources(g, k, seed):
    """The reference suite's random sources among vertices with out-edges."""
    rng = np.random.default_rng(seed)
    candidates = np.nonzero(g.out_degrees() > 0)[0]
    return [int(x) for x in rng.choice(candidates, size=k, replace=False)]


# ---------------------------------------------------------------------------
# The panel combine
# ---------------------------------------------------------------------------

def _panel_case(mode, nq, seed=0, n_rows=4, n_cols=4, n_edges=150):
    """One combine input over ``nq`` columns, as numpy arrays: random
    edges into the first n_rows - 1 row blocks (the last row is empty),
    query 0's column dead when nq > 1, live tiles those whose source block
    any query reaches (the executors' union schedule)."""
    from repro_torch.kernels.csr_spmv import (
        build_tile_struct_np, compact_live_tiles)
    rng = np.random.default_rng(seed)
    t = 8
    m = n_cols * t
    src = rng.integers(0, m, n_edges)
    dst = rng.integers(0, (n_rows - 1) * t, n_edges)
    slot_row, slot_col, rp, eslot = build_tile_struct_np(
        dst // t, src // t, n_rows, n_cols)
    n_slots = slot_row.shape[0]
    masks = rng.random((nq, m)) < 0.5
    if nq > 1:
        masks[0] = False
    union = masks.any(axis=0)
    col_has = union.reshape(n_cols, t).any(axis=1)
    idx, col, cnt = compact_live_tiles(slot_row, slot_col, rp,
                                       col_has[slot_col], n_rows)
    cell = (eslot, dst % t, src % t)
    tc = np.zeros((n_slots, t, t), np.float32)
    np.add.at(tc, cell, 1.0)
    x = rng.standard_normal((m, nq)).astype(np.float32)
    tv = tb = None
    if mode in ("add", "add_b"):
        identity = 0.0
        tv = np.zeros((n_slots, t, t), np.float32)
        np.add.at(tv, cell, rng.random(n_edges).astype(np.float32))
        if mode == "add_b":
            tb = np.zeros((n_slots, t, t), np.float32)
            np.add.at(tb, cell, rng.random(n_edges).astype(np.float32))
    else:
        identity = F32_MAX if mode == "min" else -F32_MAX
        tb = np.full((n_slots, t, t), identity, np.float32)
        fold = np.minimum if mode == "min" else np.maximum
        fold.at(tb, cell, rng.random(n_edges).astype(np.float32))
    xv = np.ascontiguousarray(np.where(masks.T, x, np.float32(identity)),
                              np.float32)
    xc = np.ascontiguousarray(masks.T, np.float32)
    return dict(row_ptr=rp, tile_idx=idx, tile_col=col, row_cnt=cnt,
                tiles_v=tv, tiles_b=tb, tiles_cnt=tc, xv=xv, xc=xc,
                identity=identity,
                max_tpr=max(1, int((rp[1:] - rp[:-1]).max())))


def _port_args(case, device="cpu"):
    """The case as the port's arguments: a leading destination axis of 1."""
    t = lambda a: None if a is None else torch.from_numpy(a)[None].to(device)
    return tuple(t(case[k]) for k in (
        "row_ptr", "tile_idx", "tile_col", "row_cnt", "tiles_v", "tiles_b",
        "tiles_cnt", "xv", "xc"))


def _solo_column(fn, args, j, **kw):
    """A solo combine call on column ``j`` of a panel call's arguments."""
    solo = list(args)
    solo[7] = args[7][..., j].contiguous()
    solo[8] = args[8][..., j].contiguous()
    return fn(*solo, **kw)


MODES = ["add", "add_b", "min", "max"]


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_combine_mq_plain_matches_jax_and_solo(mode, nq):
    """The plain panel version against the JAX panel kernel in interpret
    mode, and each of its columns bit-equal to the solo plain version."""
    import jax.numpy as jnp
    from repro.kernels.csr_spmv import block_csr_combine_mq as jax_mq
    case = _panel_case(mode, nq, seed=nq)
    j = lambda a: None if a is None else jnp.asarray(a)
    jval, jhc = jax_mq(
        j(case["row_ptr"]), j(case["tile_idx"]), j(case["tile_col"]),
        j(case["row_cnt"]), j(case["tiles_v"]), j(case["tiles_b"]),
        j(case["tiles_cnt"]), j(case["xv"]), j(case["xc"]), mode=mode,
        tile=8, max_tiles_per_row=case["max_tpr"], num_queries=nq,
        identity=case["identity"], interpret=True)
    jval, jhc = np.asarray(jval), np.asarray(jhc)
    args = _port_args(case)
    kw = dict(mode=mode, tile=8, identity=case["identity"])
    val, hc = csr_spmv.block_csr_combine_mq(*args, **kw)
    val, hc = val[0].numpy(), hc[0].numpy()
    assert val.shape == jval.shape == (4 * 8, nq)
    np.testing.assert_array_equal(hc, jhc)
    if mode in ("min", "max"):
        np.testing.assert_array_equal(val.view(np.int32), jval.view(np.int32))
    else:
        np.testing.assert_allclose(val, jval, rtol=1e-5, atol=1e-6)
    if nq > 1:      # the dead column is the identity, with no presence
        assert (val[:, 0] == np.float32(case["identity"])).all()
        assert (hc[:, 0] == 0).all()
    assert (hc[-8:] == 0).all()     # the empty row
    for col in range(nq):
        sv, sh = _solo_column(csr_spmv.block_csr_combine_ref, args, col, **kw)
        np.testing.assert_array_equal(val[:, col].view(np.int32),
                                      sv[0].numpy().view(np.int32))
        np.testing.assert_array_equal(hc[:, col], sh[0].numpy())


@pytest.mark.parametrize("kind", ["hub", "edges"])
@pytest.mark.parametrize("mode", ["add", "min"])
def test_combine_mq_units_match_plain_and_solo(mode, kind):
    """The CUDA kernel's unit split depends on row_cnt alone, so a panel
    call runs the solo split on every column: the fold-then-fixup emulated
    over a 3-column panel equals the plain panel version (min bit-equal,
    add within rtol 1e-5) and, column by column, the emulated solo call
    bit for bit."""
    k = 4
    args, ident = combine_layout(row_lengths(kind, k, seed=11), mode, nq=3,
                                 seed=12)
    targs = tuple(None if a is None else torch.from_numpy(a) for a in args)
    kw = dict(mode=mode, tile=8, identity=ident)
    val, hc = emulate_units(targs, unit_slots=k, **kw)
    rval, rhc = csr_spmv.block_csr_combine_mq_ref(*targs, **kw)
    assert torch.equal(hc, rhc)
    if mode == "min":
        assert torch.equal(val.view(torch.int32), rval.view(torch.int32))
    else:
        torch.testing.assert_close(val, rval, rtol=1e-5, atol=1e-6)
    for col in range(3):
        sv, sh = _solo_column(lambda *a, **o: emulate_units(a, **o), targs,
                              col, unit_slots=k, **kw)
        assert torch.equal(val[..., col].view(torch.int32),
                           sv.view(torch.int32))
        assert torch.equal(hc[..., col], sh)


@pytest.mark.parametrize("nq,width,padded", [
    (1, 1, 1), (2, 2, 2), (3, 4, 4), (5, 8, 8), (8, 8, 8), (9, 16, 16),
    (16, 16, 16), (17, 16, 32), (20, 16, 32), (33, 16, 48)])
def test_mq_layout_pads_and_groups(nq, width, padded):
    assert csr_spmv.mq_layout(nq) == (width, padded)


# ---------------------------------------------------------------------------
# Serving against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def problem():
    ref = _ref().core
    g = rmat_graph(GRAPH["scale"], GRAPH["edge_factor"], seed=GRAPH["seed"],
                   weighted=True)
    spec = ref.make_spec(g, **SPEC)
    jdg = ref.build_dist_graph(g, spec)
    jfm = ref.build_formats(jdg)
    return dict(g=g, jdg=jdg, jfm=jfm, sources=_top_sources(g, NQ),
                dg=interop.dist_graph_from_arrays(jax_fields(jdg),
                                                  device="cpu"),
                fm=interop.formats_from_arrays(jax_fields(jfm),
                                               device="cpu"))


@pytest.fixture
def stores(problem, tmp_path):
    """``make(name)`` -> (JAX root, port root): one store built by the JAX
    package and a copy for the port, so each package has its own spill;
    ``make.root(name)`` is the directory for a store built otherwise."""
    def make(name):
        root = tmp_path / name
        _ref().core.ChunkStore.build(problem["jdg"], problem["jfm"],
                                     str(root / "jax"))
        shutil.copytree(root / "jax", root / "port")
        return str(root / "jax"), str(root / "port")
    make.root = lambda name: tmp_path / name
    return make


def _engines(problem, stores, executor, backend="segment", nq=NQ,
             name="store"):
    """(JAX engine, port engine) of one configuration."""
    ref = _ref().core
    kw = dict(num_queries=nq, compute_backend=backend)
    if executor == "auto":
        return (ref.Engine(problem["jdg"], problem["jfm"],
                           ref.EngineConfig(**kw)),
                Engine(problem["dg"], problem["fm"], EngineConfig(**kw),
                       device="cpu"))
    if executor == "dist_ooc":
        root = stores.root(name)
        kw.update(executor="dist_ooc", num_workers=2)
        return (ref.Engine(problem["jdg"], problem["jfm"],
                           ref.EngineConfig(**kw),
                           store=ref.ChunkStore.build_sharded(
                               problem["jdg"], problem["jfm"],
                               str(root / "jax"), 2)),
                Engine(problem["dg"], problem["fm"], EngineConfig(**kw),
                       store=ChunkStore.build_sharded(
                           problem["dg"], problem["fm"], str(root / "port"),
                           2), device="cpu"))
    jroot, proot = stores(name)
    return (ref.Engine(problem["jdg"], problem["jfm"],
                       ref.EngineConfig(executor="ooc", **kw),
                       store=ref.ChunkStore.open(jroot)),
            Engine(problem["dg"], problem["fm"],
                   EngineConfig(executor="ooc", **kw),
                   store=ChunkStore.open(proot), device="cpu"))


def _drive(mod, eng, algo, sources):
    if algo == "multi_bfs":
        return mod.multi_bfs(eng, sources)
    if algo == "personalized_pagerank":
        return mod.personalized_pagerank(eng, sources, num_iters=3)
    pairs = [(s, sources[(k + 1) % len(sources)])
             for k, s in enumerate(sources)]
    return mod.pairwise_reachability(eng, pairs)


def _same_counters(port, ref, exact):
    assert port.keys() == ref.keys()
    for k, v in ref.items():
        if exact and k != "seek_cost":
            assert port[k] == v, (k, port[k], v)
        else:
            assert port[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def _check_same(algo, got, want, exact_counters):
    (v, s), (jv, js) = got, want
    if algo == "personalized_pagerank":
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    elif algo == "pairwise_reachability":
        np.testing.assert_array_equal(v, jv)
    else:
        assert v.dtype == jv.dtype
        np.testing.assert_array_equal(v.view(np.int32), jv.view(np.int32))
    assert s.iterations == js.iterations
    _same_counters(s.counters, js.counters, exact_counters)
    np.testing.assert_allclose(np.asarray(s.per_iter_return),
                               np.asarray(js.per_iter_return),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("algo", ["multi_bfs", "personalized_pagerank",
                                  "pairwise_reachability"])
def test_local_matches_jax(problem, stores, algo):
    jeng, peng = _engines(problem, stores, "auto")
    want = _drive(_ref().alg, jeng, algo, problem["sources"])
    got = _drive(alg, peng, algo, problem["sources"])
    _check_same(algo, got, want, exact_counters=False)


@pytest.mark.parametrize("backend", ["segment", "block_csr"])
@pytest.mark.parametrize("algo", ["multi_bfs", "personalized_pagerank"])
def test_ooc_matches_jax(problem, stores, algo, backend):
    jeng, peng = _engines(problem, stores, "ooc", backend)
    want = _drive(_ref().alg, jeng, algo, problem["sources"])
    got = _drive(alg, peng, algo, problem["sources"])
    _check_same(algo, got, want, exact_counters=True)
    c = got[1].counters
    for mk, ak in MEASURED_PAIRS:
        assert c[mk] == c[ak], mk
    assert c["measured_chunks_device_decoded"] == 0     # host decode here


def test_ooc_matches_local(problem, stores):
    """OOC multi-query block_csr against LOCAL multi-query segment: values,
    iterations and every counter LOCAL reports (the smoke's check)."""
    _, local = _engines(problem, stores, "auto")
    _, ooc = _engines(problem, stores, "ooc", "block_csr")
    for algo in ("multi_bfs", "personalized_pagerank"):
        (lv, ls), (ov, os_) = (_drive(alg, e, algo, problem["sources"])
                               for e in (local, ooc))
        np.testing.assert_allclose(ov, lv, rtol=0, atol=1e-7)
        assert ls.iterations == os_.iterations
        for k, v in ls.counters.items():
            assert os_.counters[k] == pytest.approx(v, rel=1e-5, abs=1e-3), k


def _sum_solo(runs):
    tot = {}
    for _, st in runs:
        tot = accumulate_counters(tot, st.counters)
    return tot


LOGICAL = ("msgs_generated", "msgs_sent", "edges_touched",
           "vertex_read_bytes", "vertex_write_bytes",
           "measured_vertex_read_bytes", "measured_vertex_write_bytes")
SHARED = ("chunks_read", "seek_cost", "edge_read_bytes", "net_bytes")


def _solo_ooc_runs(problem, stores, sources, tag):
    """Solo OOC BFS of each source, each on a fresh store copy."""
    runs = []
    for i, s in enumerate(sources):
        _, root = stores(f"{tag}{i}")
        eng = Engine(problem["dg"], problem["fm"],
                     EngineConfig(executor="ooc"),
                     store=ChunkStore.open(root), device="cpu")
        runs.append(alg.bfs(eng, s))
    return runs


def test_ooc_dead_query_costs_nothing(problem, stores):
    """A query whose source has no out-edges dies after one iteration; the
    batch runs on for the others, and from then on the dead query reads
    and writes nothing: the batch's vertex bytes are the sum of the solo
    runs' exactly, and every counter equals the JAX package's."""
    g = problem["g"]
    sink = int(np.nonzero(g.out_degrees() == 0)[0][0])
    sources = [problem["sources"][0], sink, problem["sources"][1]]
    jeng, peng = _engines(problem, stores, "ooc", "block_csr")
    want = _ref().alg.multi_bfs(jeng, sources)
    got = alg.multi_bfs(peng, sources)
    _check_same("multi_bfs", got, want, exact_counters=True)
    assert got[1].iterations[1] == 1 < min(got[1].iterations[0],
                                           got[1].iterations[2])
    solo = _sum_solo(_solo_ooc_runs(problem, stores, sources, "dead"))
    for k in LOGICAL:
        assert got[1].counters[k] == solo[k], k


@pytest.mark.parametrize("executor", ["auto", "ooc", "dist_ooc"])
def test_serve_session_matches_jax(problem, stores, executor):
    """Two slots, five queries: every result equals the solo BFS, wait and
    run iterations and every counter equal the JAX session's, logical
    counters equal the sum of the solo runs' and shared-stream counters
    are at most that sum."""
    g = problem["g"]
    sources = _pick_sources(g, 5, seed=3)
    jeng, peng = _engines(problem, stores, executor, nq=2, name="serve")
    jsess, sess = _ref().core.GraphServeSession(jeng), GraphServeSession(peng)
    qids = [(jsess.submit(s), sess.submit(s)) for s in sources]
    assert sess.in_flight == 5
    jres = {r.qid: r for r in jsess.drain()}
    res = {r.qid: r for r in sess.drain()}
    assert sess.in_flight == 0 and sess.steps == jsess.steps
    solo_runs = []
    for (jq, q), s in zip(qids, sources):
        r, jr = res[q], jres[jq]
        lv, st = alg.bfs(Engine(problem["dg"], problem["fm"], device="cpu"),
                         s)
        solo_runs.append((lv, st))
        assert r.source == s
        np.testing.assert_array_equal(r.levels.view(np.int32),
                                      lv.view(np.int32))
        assert (r.wait_iters, r.run_iters) == (jr.wait_iters, jr.run_iters)
        assert r.run_iters == st.iterations and r.wall_s > 0
    assert res[qids[0][1]].wait_iters == 0
    assert max(r.wait_iters for r in res.values()) >= 1
    _same_counters(sess.counters, jsess.counters,
                   exact=executor != "auto")
    if executor != "auto":
        solo = _sum_solo(_solo_ooc_runs(problem, stores, sources, "solo"))
        for k in LOGICAL:
            assert sess.counters[k] == solo[k], k
        for k in SHARED:
            assert sess.counters[k] <= solo[k], k


def test_ppr_matches_oracle(problem):
    g = problem["g"]
    eng = Engine(problem["dg"], problem["fm"], EngineConfig(num_queries=NQ),
                 device="cpu")
    ranks, stats = alg.personalized_pagerank(eng, problem["sources"], 5)
    assert stats.iterations == [5] * NQ
    for j, s in enumerate(problem["sources"]):
        np.testing.assert_allclose(
            ranks[:, j], alg.ref_ppr(g.num_vertices, g.src, g.dst, s, 5),
            rtol=1e-4, atol=1e-7)


def test_serving_curve_matches_bench_json(tmp_path):
    """The fig5 serving setup on the port (R-MAT scale 11, edge factor 16,
    seed 7, P = 8, batch size 64, the 8 highest out-degree sources served
    as 8/Q batches on OOC): disk, network and per-query bytes equal
    ``BENCH_serving.json`` exactly, and batching changes no answer."""
    with open(os.path.join(REPO, "BENCH_serving.json")) as f:
        bench = {(r["config"], r["metric"]): r["value"] for r in json.load(f)}
    g = rmat_graph(11, 16, seed=7, weighted=True)
    dg = build_dist_graph(g, make_spec(g, num_partitions=8, batch_size=64))
    fm = build_formats(dg)
    sources = [int(v) for v in np.argsort(-np.asarray(g.out_degrees()))[:8]]
    levels = {}
    for q in (1, 2, 4, 8):
        store = ChunkStore.build(dg, fm, str(tmp_path / f"q{q}"))
        eng = Engine(dg, fm, EngineConfig(executor="ooc", num_queries=q),
                     store=store, device="cpu")
        counters, cols = {}, []
        for gi in range(8 // q):
            lv, st = alg.multi_bfs(eng, sources[gi * q:(gi + 1) * q])
            cols.append(lv)
            counters = accumulate_counters(counters, st.counters)
        levels[q] = np.concatenate(cols, axis=1)
        disk = (counters["measured_edge_read_bytes"]
                + counters["measured_vertex_read_bytes"]
                + counters["measured_vertex_write_bytes"])
        net = counters["net_bytes"]
        cfg = f"ooc/Q={q}/queries=8"
        assert disk == bench[cfg, "disk_bytes"]
        assert net == bench[cfg, "net_bytes"]
        assert (disk + net) / 8 == bench[cfg, "bytes_per_query"]
    for q in (2, 4, 8):
        np.testing.assert_array_equal(levels[1], levels[q])


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def _bfs_step(eng, state):
    return eng.process_edges_multi(
        state, signal_fn=lambda s, gid: s["level"],
        slot_fn=lambda m, d: m, monoid=alg.MIN,
        apply_fn=lambda s, a, h, gid: ({}, h, a))


def test_multiquery_validation(problem, tmp_path):
    dg, fm = problem["dg"], problem["fm"]
    p_cnt, v_max = dg.spec.num_partitions, dg.spec.v_max
    with pytest.raises(ValueError, match="num_queries"):
        Engine(dg, fm, EngineConfig(num_queries=0), device="cpu")
    eng = Engine(dg, fm, EngineConfig(num_queries=2), device="cpu")
    with pytest.raises(ValueError, match="panel"):
        _bfs_step(eng, {"level": torch.zeros(p_cnt, v_max)})
    with pytest.raises(ValueError, match="panel"):
        _bfs_step(eng, {"level": torch.zeros(p_cnt, v_max, 3)})
    with pytest.raises(ValueError, match="active"):
        eng.process_vertices_multi(
            {"level": torch.zeros(p_cnt, v_max, 2)},
            work_fn=lambda s, gid: ({}, s["level"]),
            active=torch.zeros(p_cnt, v_max, dtype=torch.bool))
    with pytest.raises(ValueError, match="one source per query"):
        alg.multi_bfs(eng, [0, 1, 2])
    good = {"level": torch.zeros(p_cnt, v_max, 2)}
    blk = Engine(dg, fm, EngineConfig(num_queries=2,
                                      compute_backend="block_csr"),
                 device="cpu")
    with pytest.raises(ValueError, match="block_csr"):
        _bfs_step(blk, good)
    na = Engine(dg, fm, EngineConfig(num_queries=2,
                                     enable_adaptive_formats=False),
                device="cpu")
    with pytest.raises(ValueError, match="adaptive"):
        _bfs_step(na, good)
    # dist_ooc multi-query needs its sharded store, and builds on one
    with pytest.raises(ValueError, match="ShardedChunkStore"):
        Engine(dg, fm, EngineConfig(executor="dist_ooc", num_queries=2),
               device="cpu")
    sharded = ChunkStore.build_sharded(dg, fm, str(tmp_path / "sharded"), 2)
    dist = Engine(dg, fm, EngineConfig(executor="dist_ooc", num_workers=2,
                                       num_queries=2), store=sharded,
                  device="cpu")
    assert [sp.num_queries for sp in dist.spills] == [2, 2]
    # a spill laid out for Q = 2 refuses an engine with Q = 3
    store = ChunkStore.build(dg, fm, str(tmp_path / "store"))
    Engine(dg, fm, EngineConfig(executor="ooc", num_queries=2), store=store,
           device="cpu")
    with pytest.raises(ChunkStoreError, match="num_queries"):
        Engine(dg, fm, EngineConfig(executor="ooc", num_queries=3),
               store=store, device="cpu")


# ---------------------------------------------------------------------------
# The panel kernel on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 3, 8, 20])
@pytest.mark.parametrize("mode", MODES)
def test_combine_mq_kernel_on_cuda(cuda_device, mode, nq):
    """The CUDA panel kernel against its plain version (min/max bit-equal,
    add within rtol 1e-5) and each column bit-equal to the solo CUDA
    kernel on that column; Q = 3 pads to 4 columns, Q = 20 runs as two
    launches of 16."""
    case = _panel_case(mode, nq, seed=10 + nq, n_rows=64, n_cols=48,
                       n_edges=20_000)
    args = _port_args(case, cuda_device)
    kw = dict(mode=mode, tile=8, identity=case["identity"])
    before = csr_spmv.block_csr_combine_mq.launches
    val, hc = csr_spmv.block_csr_combine_mq(*args, **kw)
    torch.cuda.synchronize()
    assert (csr_spmv.block_csr_combine_mq.launches - before
            == csr_spmv.mq_layout(nq)[1] // csr_spmv.mq_layout(nq)[0])
    rval, rhc = csr_spmv.block_csr_combine_mq_ref(*args, **kw)
    assert torch.equal(hc, rhc)
    if mode in ("min", "max"):
        assert torch.equal(val.view(torch.int32), rval.view(torch.int32))
    else:
        torch.testing.assert_close(val, rval, rtol=1e-5, atol=1e-6)
    for col in range(nq):
        sv, sh = _solo_column(csr_spmv.block_csr_combine, args, col, **kw)
        assert torch.equal(val[..., col].view(torch.int32),
                           sv.view(torch.int32)), col
        assert torch.equal(hc[..., col], sh), col


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [8, 16])
@pytest.mark.parametrize("kind", ["hub", "edges", "single", "empty"])
@pytest.mark.parametrize("mode", ["add", "min"])
def test_combine_mq_kernel_uneven_rows(cuda_device, mode, kind, nq):
    """The CUDA panel kernel on rows the split must balance (a hub row per
    destination beside empty runs; rows of K - 1, K and K + 1 tiles; one
    tile; none) against its plain version, and each column bit-equal to a
    solo CUDA launch on that column."""
    k = csr_spmv._library().block_csr_combine_unit_slots()
    cnt = row_lengths(kind, k, n_dest=3, n_rows=96, seed=13)
    args, ident = combine_layout(cnt, mode, nq=nq, seed=14)
    targs = tuple(None if a is None else torch.from_numpy(a).to(cuda_device)
                  for a in args)
    kw = dict(mode=mode, tile=8, identity=ident)
    before = csr_spmv.block_csr_combine_mq.launches
    val, hc = csr_spmv.block_csr_combine_mq(*targs, **kw)
    torch.cuda.synchronize()
    assert csr_spmv.block_csr_combine_mq.launches == before + 1
    rval, rhc = csr_spmv.block_csr_combine_mq_ref(*targs, **kw)
    assert torch.equal(hc, rhc)
    if mode == "min":
        assert torch.equal(val.view(torch.int32), rval.view(torch.int32))
    else:
        torch.testing.assert_close(val, rval, rtol=1e-5, atol=1e-6)
    for col in range(nq):
        sv, sh = _solo_column(csr_spmv.block_csr_combine, targs, col, **kw)
        assert torch.equal(val[..., col].view(torch.int32),
                           sv.view(torch.int32)), col
        assert torch.equal(hc[..., col], sh), col
