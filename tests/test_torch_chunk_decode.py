"""The fused OOC chunk decode (``repro_torch.kernels.chunk_decode``): its
plain version against the host codec, the port's per-chunk chain of
``repro_torch.kernels.varint`` and the JAX Pallas chain (interpret mode,
as tests/test_varint_kernels.py runs it); the kernel's segmented
look-back emulated with tiles interleaved at random; the binary-search
run lookup against the ``expand_*`` functions; the prefetcher's items;
and, on a card (``pytest -m cuda``), the kernels against the plain
version.  The module imports jax only inside the tests that compare with
it.

Tolerance: integers and copied float32 values, so every comparison is
bit-equal."""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import codec
from repro_torch.kernels import chunk_decode as cd
from repro_torch.kernels import varint as vk
from torchhelp import emulate_segmented_decode

INT32_MAX = 2**31 - 1
REPS = {"dcsr": cd.REP_DCSR, "csr": cd.REP_CSR, "delta": cd.REP_DCSR_DELTA}


def _structure(rng, n_runs, v_src, bs, base):
    """A sorted chunk of ``n_runs`` runs: strictly increasing srcs below
    ``v_src``, run lengths 1-8, dst non-decreasing within a run and inside
    [base, base + bs)."""
    srcs = np.sort(rng.choice(v_src, n_runs, replace=False)).astype(np.int64)
    runs = rng.integers(1, 9, n_runs)
    dst = np.concatenate([base + np.sort(rng.integers(0, bs, r))
                          for r in runs] + [np.zeros(0, np.int64)])
    return srcs, runs, dst.astype(np.int64)


def _big_structure(rng, n_runs):
    """One-edge runs with srcs and dsts at the top of int32 (batch base 0,
    batch size 2**31 - 1): every pair delta's first value and every
    residue take five varint groups, and the residues sum far past
    2**31."""
    srcs = np.sort(rng.choice(2**20, n_runs, replace=False)).astype(
        np.int64) + INT32_MAX - 2**20
    return (srcs, np.ones(n_runs, np.int64),
            np.full(n_runs, INT32_MAX - 1, np.int64))


def _chunk(rep, part, srcs, runs, dst, v_src, base, values, rng):
    """(ChunkBytes, expected (src, dst, data)) of one chunk as the store
    lays it out."""
    starts = (np.cumsum(runs) - runs).astype(np.int64)
    n_e = int(runs.sum())
    if rep == cd.REP_DCSR:
        index = np.stack([srcs, starts], 1).astype("<i4").tobytes()
    elif rep == cd.REP_DCSR_DELTA:
        index = codec.varint_encode(
            codec.pair_delta_values(srcs, starts)).tobytes()
    else:
        deg = np.zeros(v_src, np.int64)
        deg[srcs] = runs
        index = np.concatenate([[0], np.cumsum(deg)]).astype("<i4").tobytes()
    residues = codec.varint_encode(
        codec.dst_delta_values(dst, starts, base)).tobytes()
    data = rng.standard_normal(n_e).astype("<f4")
    chunk = cd.ChunkBytes(rep=rep, part=part, n_e=n_e, nnz=len(srcs),
                          v_src=v_src, base=base, index=index,
                          residues=residues,
                          data=data.tobytes() if values else None)
    want = (np.repeat(srcs, runs).astype(np.int32), dst.astype(np.int32),
            data if values else np.ones(n_e, np.float32))
    return chunk, want


def _item(seed, reps, *, values=True, n_runs=(9, 0, 40), v_src=2**12,
          bs=2**12, k=3, big=False):
    """An item of one chunk per entry of ``reps`` (cycling ``n_runs``, so
    an empty chunk is among them) and the expected columns; ``big`` takes
    :func:`_big_structure` (no CSR: its idx would have 2**31 rows)."""
    rng = np.random.default_rng(seed)
    chunks, want = [], []
    for i, rep in enumerate(reps):
        n = n_runs[i % len(n_runs)]
        if big:
            assert rep != cd.REP_CSR
            (s, r, d), vs, base = _big_structure(rng, n), INT32_MAX, 0
        else:
            vs, base = v_src, k * bs
            s, r, d = _structure(rng, n, v_src, bs, base)
        c, w = _chunk(rep, i, s, r, d, vs, base, values, rng)
        chunks.append(c)
        want.append((i, w))
    return chunks, want


def _expected(want):
    src = np.concatenate([w[0] for _, w in want])
    part = np.concatenate([np.full(len(w[0]), p, np.int32)
                           for p, w in want])
    dst = np.concatenate([w[1] for _, w in want])
    data = np.concatenate([w[2] for _, w in want])
    return src, part, dst, data


def _staged(chunks, device="cpu"):
    plan = cd.plan_item(chunks)
    buf = np.zeros(plan.nbytes, np.uint8)
    cd.write_item(plan, chunks, buf)
    return torch.from_numpy(buf).to(device), plan


def _assert_columns(got, want):
    for g, w in zip(got, want):
        g = g.cpu().numpy()
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


ITEMS = [("dcsr",), ("csr",), ("delta",), ("delta", "csr", "dcsr"),
         ("csr", "delta", "dcsr", "delta", "csr", "dcsr")]


# ---------------------------------------------------------------------------
# The plain version against the codec, the port's chain and JAX's chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values", [True, False], ids=["values", "elided"])
@pytest.mark.parametrize("reps", ITEMS, ids="-".join)
def test_plain_matches_the_codec(reps, values):
    """Every representation, one chunk or several (an empty one among
    them), with values and with values elided."""
    chunks, want = _item(len(reps), [REPS[r] for r in reps], values=values)
    staged, plan = _staged(chunks)
    assert plan.n_edges == sum(c.n_e for c in chunks)
    _assert_columns(cd.decode_item(staged, plan), _expected(want))


@pytest.mark.parametrize("rep", ["dcsr", "delta"])
def test_plain_on_five_byte_varints(rep):
    """srcs and dsts at the top of int32: pair deltas and residues up to
    2**31 - 1, five groups each."""
    chunks, want = _item(5, [REPS[rep]] * 2, n_runs=(300, 7), big=True)
    assert all(len(c.residues) == 5 * c.n_e for c in chunks)
    staged, plan = _staged(chunks)
    _assert_columns(cd.decode_item(staged, plan), _expected(want))


def _overflow_chunk(rep):
    """3,000 one-edge runs at the top of a 2**20 batch: the residues sum
    past 2**31, as in one chunk of R-MAT scale 21 (ROADMAP Queue 3)."""
    n_runs, bs = 3000, 2**20
    base = 5 * bs
    srcs = np.arange(n_runs, dtype=np.int64) * 3
    runs = np.ones(n_runs, np.int64)
    dst = np.full(n_runs, base + bs - 1, np.int64)
    c, w = _chunk(rep, 2, srcs, runs, dst, 3 * n_runs, base, True,
                  np.random.default_rng(0))
    assert int(codec.dst_delta_values(dst, np.arange(n_runs), base)
               .astype(np.int64).sum()) >= 2**31
    return c, w


@pytest.mark.parametrize("rep", sorted(REPS))
def test_plain_exact_when_the_residue_sum_wraps(rep):
    c, w = _overflow_chunk(REPS[rep])
    staged, plan = _staged([c])
    _assert_columns(cd.decode_item(staged, plan), _expected([(2, w)]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_the_port_chain_and_jax(seed):
    """One DCSR-delta chunk: the fused plain version against the per-chunk
    chain it replaces (varint_decode, pair_delta_restore,
    expand_dcsr_index, dst_delta_restore) and the JAX Pallas chain."""
    from repro.kernels import varint as jvk
    (c,), [(_, want)] = _item(seed, [cd.REP_DCSR_DELTA], n_runs=(25,))
    staged, plan = _staged([c])
    src, _, dst, _ = cd.decode_item(staged, plan)
    n_e, nnz = c.n_e, c.nnz
    t = lambda b: torch.from_numpy(np.frombuffer(b, np.uint8).copy())
    pv = vk.varint_decode(t(c.index), len(c.index), count=2 * nnz)
    srcs, starts = vk.pair_delta_restore(pv)
    esrc, smask = vk.expand_dcsr_index(srcs, starts, nnz, n_e, out_len=n_e)
    res = vk.varint_decode(t(c.residues), len(c.residues), count=n_e)
    d = vk.dst_delta_restore(res, smask, c.base, n_e)
    np.testing.assert_array_equal(src.numpy(), esrc.numpy())
    np.testing.assert_array_equal(dst.numpy(), d.numpy())
    jpv = jvk.varint_decode(np.frombuffer(c.index, np.uint8), len(c.index),
                            count=2 * nnz, interpret=True)
    js, ji = jvk.pair_delta_restore(jpv, interpret=True)
    je, jm = jvk.expand_dcsr_index(js, ji, nnz, n_e, out_len=n_e,
                                   interpret=True)
    jres = jvk.varint_decode(np.frombuffer(c.residues, np.uint8),
                             len(c.residues), count=n_e, interpret=True)
    jd = jvk.dst_delta_restore(jres, jm, c.base, n_e, interpret=True)
    np.testing.assert_array_equal(src.numpy(), np.asarray(je))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(dst.numpy(), want[1])


def test_plan_layout():
    """16-byte aligned regions, a zeroed status area of 36 B per tile plus
    the counter, sections in chunk order with their first tiles, and the
    tables read back from the staged bytes."""
    chunks, _ = _item(3, [cd.REP_DCSR_DELTA, cd.REP_CSR, cd.REP_DCSR],
                      n_runs=(700, 0, 900))
    plan = cd.plan_item(chunks)
    ct, st = plan.chunk_table, plan.sec_table
    fields = {n: i for i, n in enumerate(cd.CHUNK_FIELDS)}
    for row in ct:
        for f in ("index_off", "res_off"):
            assert row[fields[f]] % 16 == 0
    assert plan.sec_off % 16 == 0 and plan.status_off % 16 == 0
    assert list(st[:, 0]) == [cd.SEC_PAIRS, cd.SEC_RESIDUE, cd.SEC_RESIDUE]
    sizes = [len(chunks[0].index), len(chunks[0].residues),
             len(chunks[2].residues)]
    assert list(st[:, 2]) == sizes
    tiles = [-(-n // cd.TILE_BYTES) for n in sizes]
    assert list(st[:, 3]) == [0, tiles[0], tiles[0] + tiles[1]]
    assert plan.n_tiles == sum(tiles) and plan.n_pairs == chunks[0].nnz
    buf = np.full(plan.nbytes, 0xAB, np.uint8)
    cd.write_item(plan, chunks, buf)
    status = buf[plan.status_off:plan.status_off
                 + cd.status_nbytes(plan.n_tiles)]
    assert cd.status_nbytes(plan.n_tiles) >= 36 * plan.n_tiles + 4
    assert not status.any()
    back = buf[:ct.nbytes].view(np.int64).reshape(ct.shape)
    np.testing.assert_array_equal(back, ct)


def test_plan_rejects_chunks_beyond_int32():
    c = cd.ChunkBytes(rep=cd.REP_DCSR, part=0, n_e=2**31, nnz=1, v_src=1,
                      base=0, index=b"", residues=b"", data=None)
    with pytest.raises(ValueError, match="int32"):
        cd.plan_item([c])


def test_an_item_of_only_empty_chunks():
    chunks, _ = _item(0, [cd.REP_DCSR, cd.REP_CSR], n_runs=(0,))
    staged, plan = _staged(chunks)
    assert plan.n_edges == 0 and plan.n_tiles == 0
    for col in cd.decode_item(staged, plan):
        assert col.numel() == 0


@pytest.mark.parametrize("offset", [1, 8])
def test_decode_rejects_an_unaligned_staged_buffer(offset):
    """The kernels read the staged regions in 16-byte words: a view that
    starts off a 16-byte boundary raises a clear error."""
    chunks, _ = _item(0, [cd.REP_DCSR_DELTA], n_runs=(40,))
    staged, plan = _staged(chunks)
    wide = torch.zeros(plan.nbytes + 32, dtype=torch.uint8)
    assert wide.data_ptr() % 16 == 0
    view = wide[offset:offset + plan.nbytes]
    view.copy_(staged)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cd.decode_item(view, plan)
    assert cd.decode_item(staged, plan)[0].numel() == plan.n_edges


def test_item_format_is_the_stores():
    """The decode's representation codes are the store's, and its format
    (what the CUDA library's ``chunk_decode_format`` must report) names
    them with the tile and the table widths."""
    from repro_torch.core import chunkstore
    assert (cd.REP_DCSR, cd.REP_CSR, cd.REP_DCSR_DELTA) == (
        chunkstore.REP_DCSR, chunkstore.REP_CSR, chunkstore.REP_DCSR_DELTA)
    assert cd.FORMAT == (cd.TILE_BYTES, len(cd.CHUNK_FIELDS),
                         len(cd.SEC_FIELDS), chunkstore.REP_DCSR,
                         chunkstore.REP_CSR, chunkstore.REP_DCSR_DELTA,
                         cd.SEC_RESIDUE, cd.SEC_PAIRS)


# ---------------------------------------------------------------------------
# The kernel's pieces emulated: the segmented look-back, the run lookup
# ---------------------------------------------------------------------------

def _sections(seed):
    """Pair and residue sections of 5-byte and 1-byte varints mixed, so
    varints straddle tiles; one section shorter than a tile; an odd number
    of varints before a tile edge so the parity swap matters."""
    rng = np.random.default_rng(seed)
    out = []
    for n, pairs in ((301, True), (3, False), (517, False), (64, True)):
        vals = rng.integers(0, INT32_MAX, n) >> rng.integers(0, 31, n)
        if pairs:
            vals = vals[:n - n % 2]
        out.append((codec.varint_encode(vals.astype(np.uint64)), pairs,
                    vals))
    return out


@pytest.mark.parametrize("tile", [4, 7, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_lookback_emulation_matches_plain(seed, tile):
    """csrc/chunk_decode.cu's first launch with its tiles' progress
    interleaved at random: each section's srcs / starts or csum equal the
    wrapping cumulative sums of its varints."""
    secs = _sections(seed)
    got, windows = emulate_segmented_decode([(b, p) for b, p, _ in secs],
                                            tile=tile, seed=seed)
    for (b, pairs, vals), out in zip(secs, got):
        v = torch.from_numpy(vals.astype(np.int64).astype(np.int32))
        if pairs:
            want = (vk.blocked_scan_ref(v[0::2].contiguous()),
                    vk.blocked_scan_ref(v[1::2].contiguous()))
            for o, w in zip(out, want):
                np.testing.assert_array_equal(o, w.numpy())
        else:
            np.testing.assert_array_equal(out, vk.blocked_scan_ref(v).numpy())
    if tile == 4:
        assert windows > 1


@pytest.mark.parametrize("seed", [0, 1])
def test_run_lookup_matches_expand_dcsr_index(seed):
    rng = np.random.default_rng(seed)
    srcs, runs, _ = _structure(rng, 50, 2**16, 64, 0)
    starts = (np.cumsum(runs) - runs).astype(np.int32)
    n_e = int(runs.sum())
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    esrc, _ = vk.expand_dcsr_index(t(srcs), t(starts), len(srcs), n_e,
                                   out_len=n_e)
    r = cd.run_heads(t(starts), torch.arange(n_e))
    np.testing.assert_array_equal(t(srcs)[r].numpy(), esrc.numpy())


def test_run_lookup_skips_rows_of_degree_zero():
    rng = np.random.default_rng(1)
    v_src = 37
    deg = rng.integers(0, 4, v_src)
    deg[[0, 5, 6, 7, v_src - 1]] = 0
    idx = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    n_e = int(deg.sum())
    esrc, _ = vk.expand_csr_index(torch.from_numpy(idx), v_src, n_e,
                                  out_len=n_e)
    r = cd.run_heads(torch.from_numpy(idx[:v_src]), torch.arange(n_e))
    np.testing.assert_array_equal(r.numpy(), esrc.numpy())
    assert (deg[r.numpy()] > 0).all()


# ---------------------------------------------------------------------------
# Through the store and the prefetcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    from repro_torch.core import (ChunkStore, build_dist_graph,
                                  build_formats, make_spec)
    from repro_torch.data.graphs import rmat_graph
    from torchhelp import GRAPH, SPEC
    g = rmat_graph(GRAPH["scale"], GRAPH["edge_factor"], seed=GRAPH["seed"],
                   weighted=True)
    dg = build_dist_graph(g, make_spec(g, **SPEC))
    fm = build_formats(dg)
    root = str(tmp_path_factory.mktemp("decode") / "s")
    return ChunkStore.build(dg, fm, root), dg, fm


def _store_items(st):
    """Every (q, k) of the store as one item, its chunks' representations
    cycling through the three (CSR where stored)."""
    from repro_torch.core import REP_CSR, REP_DCSR, REP_DCSR_DELTA
    items = {}
    for n, (q, p, k) in enumerate(st.nonempty_chunks()):
        lay = st._layout_of(q)
        rep = (REP_DCSR, REP_DCSR_DELTA, REP_CSR)[n % 3]
        if rep == REP_CSR and not lay.has_csr[p, k]:
            rep = REP_DCSR_DELTA
        items.setdefault((q, k), []).append((p, rep))
    return [(q, k, chunks) for (q, k), chunks in items.items()]


def test_store_items_match_the_host_codec(store):
    """Each (q, k) of a store as one multi-chunk item through
    DeviceChunkDecoder.decode_item (the plain version here): the
    concatenated host decode, chunk after chunk."""
    from repro_torch.core import DeviceChunkDecoder
    st, _, _ = store
    dec = DeviceChunkDecoder(st, "cpu")
    multi = 0
    for q, k, chunks in _store_items(st):
        reads = [(p, rep, *st.read_chunk_bytes(q, p, k, rep)[:2])
                 for p, rep in chunks]
        src, part, dst, data, ready = dec.decode_item(q, k, reads)
        assert ready is None
        host = [st.decode_chunk(q, p, k, rep, i, pay)
                for p, rep, i, pay in reads]
        want = (np.concatenate([h[0] for h in host]),
                np.concatenate([np.full(len(h[0]), p, np.int32)
                                for (p, *_), h in zip(reads, host)]),
                np.concatenate([h[1] for h in host]),
                np.concatenate([h[2] for h in host]))
        _assert_columns((src, part, dst, data), want)
        multi += len(chunks) > 1
    assert multi > 0


def test_prefetcher_items_equal_the_host_decode(store):
    """The prefetcher's device decode (one decode_item call per item)
    against its host decode: the same columns, counters and bytes."""
    from repro_torch.core import ChunkPrefetcher, DiskChunkSource
    st, dg, fm = store
    source = DiskChunkSource(st, dg, fm)
    items = _store_items(st)
    calls = cd.decode_item.calls
    dev = list(ChunkPrefetcher(source, iter(items), device_decode=True,
                               device="cpu"))
    host = list(ChunkPrefetcher(source, iter(items), device_decode=False,
                                device="cpu"))
    assert cd.decode_item.calls - calls == len(items)
    for a, b in zip(dev, host):
        assert (a.q, a.k, a.nbytes, a.n_chunks) == (b.q, b.k, b.nbytes,
                                                     b.n_chunks)
        assert a.n_device_chunks == a.n_chunks and b.n_device_chunks == 0
        _assert_columns(a.columns(), [c.numpy() for c in b.columns()])


# ---------------------------------------------------------------------------
# The kernels on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(chunks, device):
    staged, plan = _staged(chunks)
    before = cd.decode_item.launches
    got = cd.decode_item(staged.to(device), plan)
    torch.cuda.synchronize()
    assert cd.decode_item.launches - before == (
        (plan.n_tiles > 0) + (plan.n_edges > 0))
    want = cd.decode_item_ref(staged, plan)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("values", [True, False], ids=["values", "elided"])
@pytest.mark.parametrize("reps", ITEMS, ids="-".join)
def test_cuda_kernel_matches_plain(cuda_device, reps, values):
    chunks, want = _item(len(reps), [REPS[r] for r in reps], values=values,
                         n_runs=(9, 0, 4000, 1))
    _kernel_vs_plain(chunks, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("rep", sorted(REPS))
def test_cuda_kernel_on_adversarial_chunks(cuda_device, rep):
    """Five-byte varints over many tiles (varints straddle tile edges),
    the residue sum past 2**31, and a chunk of ~1M edges."""
    if rep != "csr":
        chunks, _ = _item(7, [REPS[rep]] * 3, n_runs=(5000, 1, 3),
                          big=True)
        _kernel_vs_plain(chunks, cuda_device)
    c, _ = _overflow_chunk(REPS[rep])
    _kernel_vs_plain([c], cuda_device)
    chunks, _ = _item(9, [REPS[rep]], n_runs=(200_000,), v_src=2**20,
                      bs=2**20)
    plan = _kernel_vs_plain(chunks, cuda_device)
    assert plan.n_edges > 800_000 and plan.n_tiles > 100


@pytest.mark.cuda
def test_cuda_store_items_and_two_prefetchers_on_their_streams(cuda_device,
                                                                store):
    """Two prefetchers over the same schedule, iterated in lockstep, each
    on its own stream, with the consumer's stream busy between items: both
    yield the plain version's columns; every copy to the card comes from
    page-locked memory (the profiler's HtoD copies of the prefetch path);
    at most two launches per item."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ChunkPrefetcher, DiskChunkSource
    from repro_torch.core.chunkstore import StagingRing
    st, dg, fm = store
    source = DiskChunkSource(st, dg, fm)
    items = _store_items(st)
    cpu = list(ChunkPrefetcher(source, iter(items), device_decode=True,
                               device="cpu"))
    launches, copies = cd.decode_item.launches, StagingRing.copies
    busy = torch.randn(2048, 2048, device=cuda_device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = []
        for a, b in zip(*(ChunkPrefetcher(source, iter(items),
                                          device_decode=True,
                                          device=cuda_device)
                          for _ in range(2))):
            busy = busy @ busy / 2048        # the consumer's own work
            got.append((a.columns(), b.columns()))
        torch.cuda.synchronize()
    assert cd.decode_item.launches - launches <= 4 * len(items)
    assert StagingRing.copies - copies == 2 * len(items)
    for (ca, cb), w in zip(got, cpu):
        for x, y, z in zip(ca, cb, w.columns()):
            assert torch.equal(x.cpu(), z) and torch.equal(y.cpu(), z)
    htod = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "HtoD" in e.name]
    assert htod and all("Pinned" in n for n in htod), sorted(set(htod))


@pytest.mark.cuda
def test_cuda_library_format_and_alignment(cuda_device):
    """The built library reports the wrapper's item format, and an
    unaligned staged view on the card raises before any launch."""
    lib = cd._library()
    out = (ctypes.c_int * len(cd.FORMAT))()
    assert lib.chunk_decode_format(out, len(cd.FORMAT)) == len(cd.FORMAT)
    assert tuple(out) == cd.FORMAT
    chunks, _ = _item(0, [cd.REP_DCSR_DELTA], n_runs=(40,))
    staged, plan = _staged(chunks, cuda_device)
    wide = torch.zeros(plan.nbytes + 32, dtype=torch.uint8,
                       device=cuda_device)
    view = wide[4:4 + plan.nbytes]
    view.copy_(staged)
    before = cd.decode_item.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        cd.decode_item(view, plan)
    assert cd.decode_item.launches == before
