"""The port's OOC executor (``executor="ooc"``) against JAX OOC on the same
chunk store (built by the JAX package, opened by the port from a copy):
both compute backends, device decode on and off, all four algorithms —
values, iteration counts and every counter, measured ones included, with
``measured == model`` held by ``verify_io`` inside every call.

Tolerances: BFS/SSSP/WCC are MIN-monoid folds, exact in any order, so
their values are bit-equal; PageRank sums in another order (rtol/atol
1e-5).  Counters are integer counts or byte totals and must be equal,
except ``seek_cost``, a float32 sum (rel 1e-5), and
``measured_chunks_device_decoded``, which counts the decode path taken
(the reference decodes on the host on a CPU).

The JAX package is imported inside the fixtures and tests that compare
with it, so ``pytest -m cuda`` loads this module on a machine without
jax."""
import shutil
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import ChunkStore, Engine, EngineConfig
from repro_torch.core import algorithms as alg
from repro_torch.core.engine import MEASURED_PAIRS
from repro_torch.data.graphs import rmat_graph

from torchhelp import GRAPH, SPEC, jax_fields


def _ref():
    """The reference package's OOC surface."""
    from repro import core
    from repro.core import algorithms
    return types.SimpleNamespace(core=core, alg=algorithms)


BACKENDS = ["segment", "block_csr"]
ALGOS = ["pagerank", "bfs", "sssp", "wcc"]


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    ref = _ref().core
    g = rmat_graph(GRAPH["scale"], GRAPH["edge_factor"], seed=GRAPH["seed"],
                   weighted=True)
    spec = ref.make_spec(g, **SPEC)
    out = {"g": g, "src": int(np.argmax(g.out_degrees()))}
    for name, graph in (("fwd", g), ("rev", g.reversed())):
        root = tmp_path_factory.mktemp(f"ooc_{name}")
        jdg = ref.build_dist_graph(graph, spec)
        jfm = ref.build_formats(jdg)
        ref.ChunkStore.build(jdg, jfm, str(root / "jax"))
        shutil.copytree(root / "jax", root / "port")
        out[name] = (jdg, jfm, str(root / "jax"),
                     interop.dist_graph_from_arrays(jax_fields(jdg),
                                                    device="cpu"),
                     interop.formats_from_arrays(jax_fields(jfm),
                                                 device="cpu"),
                     str(root / "port"))
    return out


def port_engine(problem, name, backend, device_decode=None, **kw):
    _, _, _, dg, fm, root = problem[name]
    cfg = EngineConfig(executor="ooc", compute_backend=backend,
                       device_decode=device_decode, **kw)
    return Engine(dg, fm, cfg, store=ChunkStore.open(root), device="cpu")


def run(problem, algo, make, mod=alg):
    """One algorithm through ``mod`` (the port's or the reference's
    algorithms) on engines from ``make(name)``."""
    src = problem["src"]
    eng = make("fwd")
    if algo == "pagerank":
        return mod.pagerank(eng, 5)
    if algo in ("bfs", "sssp"):
        return getattr(mod, algo)(eng, src)
    return mod.wcc(eng, make("rev"))


@pytest.fixture(scope="module")
def jax_runs(problem):
    """JAX OOC results, computed once per (backend, algorithm)."""
    ref = _ref()
    cache = {}

    def get(backend, algo):
        if (backend, algo) not in cache:
            def make(name):
                jdg, jfm, root = problem[name][:3]
                return ref.core.Engine(
                    jdg, jfm, ref.core.EngineConfig(
                        executor="ooc", compute_backend=backend),
                    store=ref.core.ChunkStore.open(root))
            cache[backend, algo] = run(problem, algo, make, ref.alg)
        return cache[backend, algo]
    return get


@pytest.mark.parametrize("device_decode", [True, False],
                         ids=["device_decode", "host_decode"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo", ALGOS)
def test_matches_jax_ooc(problem, jax_runs, algo, backend, device_decode):
    jv, js = jax_runs(backend, algo)
    v, s = run(problem, algo,
               lambda name: port_engine(problem, name, backend,
                                        device_decode))
    if algo == "pagerank":
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    else:
        assert v.dtype == jv.dtype
        np.testing.assert_array_equal(v.view(np.int32), jv.view(np.int32))
    assert s.iterations == js.iterations
    assert s.counters.keys() == js.counters.keys()
    for k, ref in js.counters.items():
        if k == "seek_cost":
            assert s.counters[k] == pytest.approx(ref, rel=1e-5), k
        elif k == "measured_chunks_device_decoded":
            assert ref == 0
            assert s.counters[k] == (s.counters["measured_chunks_read"]
                                     if device_decode else 0)
        else:
            assert s.counters[k] == ref, (k, s.counters[k], ref)
    for mk, ak in MEASURED_PAIRS:
        assert s.counters[mk] == s.counters[ak], mk
    np.testing.assert_allclose(s.per_iter_return, js.per_iter_return,
                               rtol=1e-5, atol=1e-7)


def test_bfs_is_selective(problem):
    """BFS frontiers make iterations partially active: the OOC run reads
    fewer chunks than exist per iteration, and measured == modeled."""
    dg = problem["fwd"][3]
    lv, st = alg.bfs(port_engine(problem, "fwd", "block_csr", True),
                     problem["src"])
    total_chunks = int((dg.chunk_edges.numpy() > 0).sum())
    assert st.counters["chunks_read"] < total_chunks * st.iterations
    assert st.counters["measured_chunks_read"] == st.counters["chunks_read"]
    g = problem["g"]
    np.testing.assert_array_equal(
        lv, alg.ref_bfs(g.num_vertices, g.src, g.dst, problem["src"]))


def test_pagerank_matches_oracle(problem):
    g = problem["g"]
    pr, _ = alg.pagerank(port_engine(problem, "fwd", "segment"), 5)
    np.testing.assert_allclose(
        pr, alg.ref_pagerank(g.num_vertices, g.src, g.dst, 5),
        rtol=1e-4, atol=1e-7)


def test_device_decode_defaults_to_the_card(problem):
    """Auto means on exactly when the engine's device is CUDA (and
    compression is on): off here on the CPU, on when forced."""
    assert not port_engine(problem, "fwd", "segment").device_decode
    assert port_engine(problem, "fwd", "segment", True).device_decode


@pytest.mark.parametrize("kw,store,match", [
    (dict(), False, "ChunkStore"),
    (dict(enable_adaptive_formats=False), True, "adaptive"),
    (dict(account_io=False), True, "account_io"),
    (dict(compression=False), True, "compression"),
    (dict(compression=False, device_decode=True), True, "compression"),
    (dict(parallel_workers=True), True, "parallel_workers"),
])
def test_config_validation(problem, kw, store, match):
    _, _, _, dg, fm, root = problem["fwd"]
    with pytest.raises(ValueError, match=match):
        Engine(dg, fm, EngineConfig(executor="ooc", **kw),
               store=ChunkStore.open(root) if store else None, device="cpu")


def test_store_mismatch_rejected(problem, tmp_path):
    _, _, _, dg, fm, root = problem["fwd"]
    store = ChunkStore.open(root)
    store.manifest["values_elided"] = not store.manifest["values_elided"]
    with pytest.raises(ValueError, match="values_elided"):
        Engine(dg, fm, EngineConfig(executor="ooc"), store=store,
               device="cpu")
    g, ref = problem["g"], _ref().core
    other = ref.build_dist_graph(g, ref.make_spec(g, num_partitions=2,
                                                  batch_size=16))
    odg = interop.dist_graph_from_arrays(jax_fields(other), device="cpu")
    ofm = interop.formats_from_arrays(
        jax_fields(ref.build_formats(other)), device="cpu")
    with pytest.raises(ValueError, match="different partitioning"):
        Engine(odg, ofm, EngineConfig(executor="ooc"),
               store=ChunkStore.open(root), device="cpu")
    with pytest.raises(ValueError, match="executor"):
        Engine(dg, fm, EngineConfig(executor="bogus"), device="cpu")


# ---------------------------------------------------------------------------
# The OOC path on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_ooc_on_cuda_matches_oracles(cuda_device, backend, tmp_path):
    """The whole OOC path on the card at a small size: device decode on by
    default, every chunk decoded there by the fused decode (at most two
    launches per item; the stencil and the scans not at all), the combine
    launched, values against the numpy oracles."""
    from repro_torch.core import build_dist_graph, build_formats, make_spec
    from repro_torch.kernels import chunk_decode, csr_spmv, varint
    g = rmat_graph(8, 8, seed=1, weighted=True)
    spec = make_spec(g, num_partitions=4, batch_size=16)
    n, src = g.num_vertices, int(np.argmax(g.out_degrees()))
    engines = []
    for name, graph in (("fwd", g), ("rev", g.reversed())):
        dg = build_dist_graph(graph, spec)
        fm = build_formats(dg)
        engines.append(Engine(
            dg, fm, EngineConfig(executor="ooc", compute_backend=backend),
            store=ChunkStore.build(dg, fm, str(tmp_path / name))))
    eng = engines[0]
    assert eng.device.type == "cuda" and eng.device_decode
    varint.reset_launches()
    chunk_decode.reset_launches()
    before = csr_spmv.block_csr_combine.launches
    pr, st = alg.pagerank(eng, 5)
    assert 0 < chunk_decode.decode_item.launches <= \
        2 * chunk_decode.decode_item.calls
    assert varint.byte_stencil.launches == varint.blocked_scan.launches == 0
    assert (csr_spmv.block_csr_combine.launches > before) == (
        backend == "block_csr")
    assert st.counters["measured_chunks_device_decoded"] == \
        st.counters["measured_chunks_read"] > 0
    np.testing.assert_allclose(pr, alg.ref_pagerank(n, g.src, g.dst, 5),
                               rtol=1e-4, atol=1e-7)
    lv, _ = alg.bfs(eng, src)
    np.testing.assert_array_equal(lv, alg.ref_bfs(n, g.src, g.dst, src))
    ds, _ = alg.sssp(eng, src)
    np.testing.assert_allclose(ds, alg.ref_sssp(n, g.src, g.dst, g.data,
                                                src), rtol=1e-5, atol=1e-5)
    lb, _ = alg.wcc(*engines)
    np.testing.assert_array_equal(lb, alg.ref_wcc(n, g.src, g.dst))
