"""The port's storage tier against the JAX package's on the same graph:
chunk stores and vertex spills are byte-identical, each package opens and
decodes the other's stores, the port's device decode (its plain PyTorch
path on the CPU) equals its host decode for every chunk and
representation, and damage or a bad manifest raises as in the reference.

Tolerance: bytes and integers, so every comparison is exact."""
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from repro.core import ChunkStore as JStore
from repro.core import VertexSpill as JSpill
from repro.core import build_dist_graph as j_build_dist_graph
from repro.core import build_formats as j_build_formats
from repro.core import make_spec as j_make_spec
from repro.data.graphs import rmat_graph

from repro_torch import interop
from repro_torch.core import ChunkStore, ChunkStoreError, VertexSpill
from repro_torch.core.chunkstore import (
    MANIFEST_NAME, MANIFEST_VERSION, REP_CSR, REP_DCSR, REP_DCSR_DELTA,
    ChunkPrefetcher, DiskChunkSource, ScheduleMark,
)
from repro_torch.utils import IntegrityError

from torchhelp import GRAPH, SPEC, jax_fields


@pytest.fixture(scope="module", params=[True, False],
                ids=["weighted", "unweighted"])
def problem(request):
    g = rmat_graph(GRAPH["scale"], GRAPH["edge_factor"], seed=GRAPH["seed"],
                   weighted=request.param)
    jdg = j_build_dist_graph(g, j_make_spec(g, **SPEC))
    jfm = j_build_formats(jdg)
    return (jdg, jfm,
            interop.dist_graph_from_arrays(jax_fields(jdg), device="cpu"),
            interop.formats_from_arrays(jax_fields(jfm), device="cpu"))


def _files(root):
    return sorted(f for f in os.listdir(root)
                  if os.path.isfile(os.path.join(root, f)))


def _same_files(a, b):
    assert _files(a) == _files(b)
    for f in _files(a):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def _reps(store, q, p, k):
    lay = store._layout_of(q)
    return ([REP_DCSR] + ([REP_DCSR_DELTA] if store.compression else [])
            + ([REP_CSR] if lay.has_csr[p, k] else []))


def _chunks(store):
    return list(store.nonempty_chunks())


@pytest.mark.parametrize("compression", [True, False],
                         ids=["compressed", "raw"])
def test_stores_are_byte_identical(problem, tmp_path, compression):
    jdg, jfm, dg, fm = problem
    JStore.build(jdg, jfm, str(tmp_path / "j"), compression=compression)
    store = ChunkStore.build(dg, fm, str(tmp_path / "p"),
                             compression=compression)
    _same_files(str(tmp_path / "j"), str(tmp_path / "p"))
    assert store.values_elided == (compression and fm.values_elided)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_store(problem, tmp_path, writer):
    jdg, jfm, dg, fm = problem
    root = str(tmp_path / "s")
    if writer == "jax":
        JStore.build(jdg, jfm, root)
    else:
        ChunkStore.build(dg, fm, root)
    js, ps = JStore.open(root), ChunkStore.open(root)
    checked = 0
    for q, p, k in _chunks(ps):
        for rep in _reps(ps, q, p, k):
            a = js.read_chunk(q, p, k, rep)
            b = ps.read_chunk(q, p, k, rep)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            checked += 1
    assert checked > 0 and js.bytes_read == ps.bytes_read


def test_device_decode_equals_host_decode(problem, tmp_path):
    """Every chunk in every representation it stores; the device decode
    runs its plain PyTorch path here (CPU tensors)."""
    _, _, dg, fm = problem
    store = ChunkStore.build(dg, fm, str(tmp_path / "s"))
    checked = 0
    for q, p, k in _chunks(store):
        for rep in _reps(store, q, p, k):
            index, payload, _ = store.read_chunk_bytes(q, p, k, rep)
            host = store.decode_chunk(q, p, k, rep, index, payload)
            dev = store.decode_chunk_device(q, p, k, rep, index, payload,
                                            device="cpu")
            for h, d in zip(host, dev):
                assert isinstance(d, torch.Tensor)
                np.testing.assert_array_equal(d.numpy(), h)
                assert d.numpy().dtype == h.dtype
            checked += 1
    assert checked > 0


def test_device_decode_rejects_uncompressed_store(problem, tmp_path):
    _, _, dg, fm = problem
    store = ChunkStore.build(dg, fm, str(tmp_path / "raw"),
                             compression=False)
    q, p, k = _chunks(store)[0]
    index, payload, _ = store.read_chunk_bytes(q, p, k, REP_DCSR)
    with pytest.raises(ValueError, match="compress"):
        store.decode_chunk_device(q, p, k, REP_DCSR, index, payload,
                                  device="cpu")


class _CountingToken:
    """A compute token that counts how often it was taken."""

    def __init__(self):
        self.lock = threading.Lock()
        self.taken = 0

    def __enter__(self):
        self.lock.acquire()
        self.taken += 1

    def __exit__(self, *exc):
        self.lock.release()


@pytest.mark.parametrize("device_decode", [False, True],
                         ids=["host_decode", "device_decode"])
def test_prefetcher_order_token_and_errors(problem, tmp_path, device_decode):
    """The prefetch thread yields one decoded work item per schedule item
    and every mark in schedule order; it holds the compute token for each
    host decode and not for a device decode; a worker exception re-raises
    in the consumer; an early break closes the schedule generator."""
    _, _, dg, fm = problem
    store = ChunkStore.build(dg, fm, str(tmp_path / "s"))
    source = DiskChunkSource(store, dg, fm)
    items = [(q, k, [(p, REP_DCSR)]) for q, p, k in _chunks(store)][:6]
    mark = ScheduleMark()
    schedule = items[:3] + [mark] + items[3:]
    token = _CountingToken()
    got = list(ChunkPrefetcher(source, iter(schedule), depth=2,
                               compute_lock=token,
                               device_decode=device_decode, device="cpu"))
    assert got[3] is mark and len(got) == len(schedule)
    for (q, k, chunks), work in zip(items, got[:3] + got[4:]):
        assert (work.q, work.k, work.n_chunks) == (q, k, 1)
        assert work.n_device_chunks == (1 if device_decode else 0)
        (p, rep), = chunks
        want = store.read_chunk(q, p, k, rep)[:3]
        for w, t in zip(want, (work.src, work.dst, work.data)):
            np.testing.assert_array_equal(t.numpy(), w)
    assert token.taken == (0 if device_decode else len(items))

    def failing():
        yield items[0]
        raise RuntimeError("schedule broke")

    with pytest.raises(RuntimeError, match="schedule broke"):
        list(ChunkPrefetcher(source, failing(), compute_lock=token,
                             device_decode=device_decode, device="cpu"))
    closed = []

    def endless():
        try:
            while True:
                yield items[0]
        finally:
            closed.append(True)

    for _ in ChunkPrefetcher(source, endless(), compute_lock=token,
                             device_decode=device_decode, device="cpu"):
        break
    assert closed == [True]


def test_read_sizes_match_byte_model(problem, tmp_path):
    _, _, dg, fm = problem
    store = ChunkStore.build(dg, fm, str(tmp_path / "s"))
    model = {REP_DCSR: fm.dcsr_bytes.numpy(), REP_CSR: fm.csr_bytes.numpy(),
             REP_DCSR_DELTA: fm.dcsr_delta_bytes.numpy()}
    store.reset_io_counters()
    total = 0
    for q, p, k in _chunks(store):
        for rep in _reps(store, q, p, k):
            *_, nb = store.read_chunk(q, p, k, rep)
            assert nb == model[rep][q, p, k]
            total += nb
    assert store.bytes_read == total


def _spill_ops(cls, root):
    """One sequence of spill operations: load, read, write, merge_write,
    bitmaps."""
    p_cnt, b_cnt, bs, v_max = 2, 3, 4, 10   # ragged tail batch
    spill = cls(root, p_cnt, b_cnt, bs, v_max)
    rng = np.random.default_rng(0)
    spill.load({"x": rng.random((p_cnt, v_max)).astype(np.float32),
                "y": rng.integers(0, 9, (p_cnt, v_max)).astype(np.int32)})
    mask = np.zeros((p_cnt, b_cnt), bool)
    mask[0, 1] = mask[1, 2] = True
    got = spill.read(mask)
    got["x"][0, bs:2 * bs] = 7.0
    spill.write(got, mask)
    vm = np.zeros((p_cnt, v_max), bool)
    vm[1, 2 * bs:] = True
    spill.merge_write(spill.read(mask), {"y": np.full((p_cnt, v_max), 5,
                                                      np.int32)}, vm, mask)
    spill.write_bitmap(rng.random((p_cnt, v_max)) < 0.5)
    bits = spill.read_bitmap()
    return spill, bits


def test_spills_are_byte_identical(tmp_path):
    js, jbits = _spill_ops(JSpill, str(tmp_path / "j"))
    ps, pbits = _spill_ops(VertexSpill, str(tmp_path / "p"))
    _same_files(str(tmp_path / "j"), str(tmp_path / "p"))
    np.testing.assert_array_equal(jbits, pbits)
    assert (js.bytes_read, js.bytes_written) == (ps.bytes_read,
                                                 ps.bytes_written)
    for k, v in js.state_views().items():
        np.testing.assert_array_equal(ps.state_views()[k], v)
    assert ps.verify() == []


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


def test_flipped_bytes_raise_integrity_error(problem, tmp_path):
    _, _, dg, fm = problem
    store = ChunkStore.build(dg, fm, str(tmp_path / "s"))
    q, p, k = _chunks(store)[0]
    _flip(os.path.join(store.root, f"edges_q{q}.bin"),
          int(store._layout_of(q).offset[p, k]))
    with pytest.raises(IntegrityError, match="dcsr-pairs"):
        store.read_chunk(q, p, k, REP_DCSR)
    damage = store.verify()
    assert len(damage) == 1 and "dcsr-pairs" in damage[0]
    spill, _ = _spill_ops(VertexSpill, str(tmp_path / "v"))
    _flip(os.path.join(spill.root, "vertex_x.bin"), 0)
    with pytest.raises(IntegrityError, match="batch"):
        spill.read(np.ones((2, 3), bool))
    _flip(os.path.join(spill.root, "active.bits"), 0)
    with pytest.raises(IntegrityError, match="bitmap"):
        spill.read_bitmap()
    assert len(spill.verify()) == 2


@pytest.mark.parametrize("damage", ["missing", "truncated", "old_version",
                                    "missing_edges", "bad_crc"])
def test_open_errors(problem, tmp_path, damage):
    _, _, dg, fm = problem
    root = tmp_path / "s"
    ChunkStore.build(dg, fm, str(root))
    path = root / MANIFEST_NAME
    manifest = json.loads(path.read_text())
    err, match = ChunkStoreError, None
    if damage == "missing":
        path.unlink()
        match = "manifest"
    elif damage == "truncated":
        path.write_text('{"version": 4, "num_partitions": 2, "chu')
        match = "truncated or corrupt"
    elif damage == "old_version":
        manifest["version"] = MANIFEST_VERSION - 1
        path.write_text(json.dumps(manifest))
        match = f"found version {MANIFEST_VERSION - 1}"
    elif damage == "missing_edges":
        (root / "edges_q0.bin").unlink()
        match = "missing edge file"
    else:
        manifest["gamma"] = 1.0
        path.write_text(json.dumps(manifest))
        err, match = IntegrityError, "checksum"
    with pytest.raises(err, match=match) as ei:
        ChunkStore.open(str(root))
    if damage in ("truncated", "missing_edges"):
        assert str(root) in str(ei.value)


def test_spill_num_queries_validation(tmp_path):
    with pytest.raises(ChunkStoreError, match="num_queries"):
        VertexSpill(str(tmp_path / "bad"), 2, 3, 4, 10, num_queries=0)
    root = str(tmp_path / "q2")
    VertexSpill(root, 2, 3, 4, 10, num_queries=2)
    with pytest.raises(ChunkStoreError, match="fresh spill root"):
        VertexSpill(root, 2, 3, 4, 10, num_queries=3)
    shutil.rmtree(root)
