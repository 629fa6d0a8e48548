"""block_csr_combine: the port's plain PyTorch version against the JAX
Pallas kernel (interpret mode, as tests/test_kernels.py runs it) in all
four modes, on the reference tests' layouts and on uneven ones (a hub
row beside empty runs, rows of K - 1, K and K + 1 tiles), and the CUDA kernel against the plain version on a card
(``pytest -m cuda`` there; the module imports jax only inside the tests
that compare with it, so it loads on a machine without jax).

The CUDA kernel splits a call into units of K merge-path items
(``combine_units``); the split is held here on row lengths with hub rows,
empty runs and lengths K - 1, K and K + 1, and its fold-then-fixup,
emulated in plain torch, against the plain version.

Tolerances: min/max are exact in any order, so they are bit-equal and the
has-message counts (small integers) exact; add/add_b sum in another order
than the JAX kernel, so they agree within rtol 1e-5 / atol 1e-6."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import csr_spmv

from torchhelp import combine_layout, emulate_units, row_lengths

BIG = float(np.finfo(np.float32).max)


def _combine_setup(seed=0, T=8, R=3, C=4, e=150):
    """The inputs of tests/test_kernels.py::_combine_setup, rebuilt with the
    port's host builders (held equal to the reference's in
    :func:`test_host_builders_match_reference`)."""
    rng = np.random.default_rng(seed)
    n, m = R * T, C * T
    src = rng.integers(0, m, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    slot_row, slot_col, rp, eslot = csr_spmv.build_tile_struct_np(
        dst // T, src // T, R, C)
    mask = rng.random(m) < 0.6
    x = rng.random(m).astype(np.float32)
    col_has = np.array([mask[c * T:(c + 1) * T].any() for c in range(C)])
    live = col_has[slot_col]
    idx, col, cnt = csr_spmv.compact_live_tiles(slot_row, slot_col, rp,
                                                live, R)
    mt = max(1, int((rp[1:] - rp[:-1]).max()))
    return src, dst, w, eslot, mask, x, rp, idx, col, cnt, mt, T, live


def _mode_inputs(mode, seed):
    """(numpy args without the destination axis, identity) for one mode,
    on the setup's tiles."""
    src, dst, w, eslot, mask, x, rp, idx, col, cnt, mt, T, _ = \
        _combine_setup(seed=seed)
    S = eslot.max() + 1
    cell = (eslot, dst % T, src % T)
    tc = np.zeros((S, T, T), np.float32)
    np.add.at(tc, cell, 1.0)
    tv = tb = None
    if mode in ("add", "add_b"):
        ident = 0.0
        tv = np.zeros((S, T, T), np.float32)
        np.add.at(tv, cell, w)
        if mode == "add_b":
            tb = np.zeros((S, T, T), np.float32)
            np.add.at(tb, cell, w[::-1].copy())
        xv = np.where(mask, x, 0).astype(np.float32)
    else:
        ident = BIG if mode == "min" else -BIG
        tb = np.full((S, T, T), ident, np.float32)
        (np.minimum if mode == "min" else np.maximum).at(tb, cell, w)
        xv = np.where(mask, x, ident).astype(np.float32)
    xc = mask.astype(np.float32)
    return (rp, idx, col, cnt, tv, tb, tc, xv, xc), ident, mt, T


def _torch(args, device="cpu"):
    """Tensors with a leading destination axis of 1."""
    return [None if a is None else torch.from_numpy(a).to(device)[None]
            for a in args]


def _check(mode, val, hc, ref_val, ref_hc):
    np.testing.assert_array_equal(hc, ref_hc)
    if mode in ("min", "max"):
        np.testing.assert_array_equal(val.view(np.int32),
                                      ref_val.view(np.int32))
    else:
        np.testing.assert_allclose(val, ref_val, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_builders_match_reference(seed):
    from repro.kernels.csr_spmv import build_tile_struct, compact_live_tiles
    src, dst, *_, rp, idx, col, cnt, mt, T, live = _combine_setup(seed=seed)
    R, C = 3, 4
    ref = build_tile_struct(dst // T, src // T, R, C)
    port = csr_spmv.build_tile_struct_np(dst // T, src // T, R, C)
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    on_tensors = csr_spmv.build_tile_struct(
        torch.from_numpy(dst // T), torch.from_numpy(src // T), R, C)
    for a, b in zip(ref, on_tensors):
        assert b.dtype == torch.int32 and np.array_equal(a, b.numpy())
    for a, b in zip(compact_live_tiles(ref[0], ref[1], ref[2], live, R),
                    (idx, col, cnt)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("inputs", [0, 1, "hub", "edges"])
@pytest.mark.parametrize("mode", ["add", "add_b", "min", "max"])
def test_plain_version_matches_jax_kernel(mode, inputs):
    """``inputs``: a seed of the reference tests' setup, or a
    :func:`row_lengths` layout (a hub row beside empty runs; rows of
    K - 1, K, K + 1, 1, 0 and 3K + 2 tiles at K = 16) whose one
    destination goes through both versions."""
    import jax.numpy as jnp
    from repro.kernels.csr_spmv import block_csr_combine as jax_combine
    if isinstance(inputs, int):
        args, ident, mt, T = _mode_inputs(mode, inputs)
    else:
        cnt = row_lengths(inputs, 16, n_dest=1, n_rows=20, seed=3)
        full, ident = combine_layout(cnt, mode, seed=3)
        args = tuple(None if a is None else a[0] for a in full)
        mt, T = max(1, int(cnt.max())), 8
    jval, jhc = jax_combine(
        *[None if a is None else jnp.asarray(a) for a in args],
        mode=mode, tile=T, max_tiles_per_row=mt, identity=ident,
        interpret=True)
    val, hc = csr_spmv.block_csr_combine(*_torch(args), mode=mode, tile=T,
                                         identity=ident)
    val, hc = val[0].numpy(), hc[0].numpy()
    _check(mode, val, hc, np.asarray(jval), np.asarray(jhc))
    if mode in ("min", "max"):
        assert (np.abs(val[hc == 0]) >= 1e37).all()


@pytest.mark.parametrize("mode", ["add", "min"])
def test_destination_axis_is_one_call_per_destination(mode):
    """A leading destination axis gives exactly the per-destination calls."""
    a0, ident, _, T = _mode_inputs(mode, 0)
    a1, _, _, _ = _mode_inputs(mode, 1)

    def stack(x, y):
        if x is None:
            return None
        if x.ndim == 3:    # tiles: pad slot counts to the longer one
            s = max(x.shape[0], y.shape[0])
            fill = 0.0 if mode == "add" else ident
            pad = lambda z: np.concatenate(
                [z, np.full((s - z.shape[0],) + z.shape[1:], fill,
                            np.float32)])
            return np.stack([pad(x), pad(y)])
        if x.shape != y.shape:   # tile_idx / tile_col: pad with 0
            s = max(x.shape[0], y.shape[0])
            pad = lambda z: np.concatenate([z, np.zeros(s - z.shape[0],
                                                        z.dtype)])
            return np.stack([pad(x), pad(y)])
        return np.stack([x, y])

    both = [None if x is None else torch.from_numpy(stack(x, y))
            for x, y in zip(a0, a1)]
    val, hc = csr_spmv.block_csr_combine(*both, mode=mode, tile=T,
                                         identity=ident)
    for q, single in enumerate((a0, a1)):
        v1, h1 = csr_spmv.block_csr_combine(*_torch(single), mode=mode,
                                            tile=T, identity=ident)
        np.testing.assert_array_equal(val[q].numpy(), v1[0].numpy())
        np.testing.assert_array_equal(hc[q].numpy(), h1[0].numpy())


def test_unknown_mode_and_tile_rejected():
    args, ident, _, T = _mode_inputs("add", 0)
    with pytest.raises(ValueError):
        csr_spmv.block_csr_combine(*_torch(args), mode="mul", tile=T)
    with pytest.raises(ValueError):
        csr_spmv._launch(*_torch(args), mode="add", tile=16, identity=0.0)


LAYOUTS = ["hub", "edges", "single", "empty", "random"]


@pytest.mark.parametrize("unit_slots", [2, 5, 16])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_combine_units_split(kind, unit_slots):
    """The merge-path split: every live slot in exactly one unit, in row
    order; at most K slots a unit; every row's end consumed by exactly one
    unit; every row, empty ones too, written whole by one unit or fixed up
    once."""
    cnt = row_lengths(kind, unit_slots, seed=unit_slots)
    k = unit_slots
    n_slots = int(cnt.sum(1).max()) + cnt.shape[1]    # one dead slot a row
    row_end, unit_row, unit_slot = (x.numpy().astype(np.int64) for x in
                                    csr_spmv.combine_units(
                                        torch.from_numpy(cnt), n_slots, k))
    counts = cnt.reshape(-1).astype(np.int64)
    n_flat, n_live = counts.size, int(counts.sum())
    row_start = row_end - counts
    assert np.array_equal(row_end, np.cumsum(counts))
    path = n_flat + n_live
    n_units = unit_row.size - 1          # sized for every slot live
    assert n_units == -(-cnt.shape[0] * (cnt.shape[1] + n_slots) // k)
    assert n_units >= -(-path // k)
    diag = np.minimum(np.arange(n_units + 1) * k, path)
    assert np.array_equal(unit_row + unit_slot, diag)
    assert unit_row[0] == unit_slot[0] == 0
    assert unit_row[-1] == n_flat and unit_slot[-1] == n_live
    assert (np.diff(unit_row) >= 0).all() and (np.diff(unit_slot) >= 0).all()
    assert (np.diff(unit_slot) <= k).all()
    owner = np.repeat(np.arange(n_flat), counts)         # row of each slot
    covered = np.zeros(n_live, np.int64)
    done = np.zeros(n_flat, np.int64)
    for u in range(n_units):
        f0, f1 = unit_row[u], unit_row[u + 1]
        s0, s1 = unit_slot[u], unit_slot[u + 1]
        covered[s0:s1] += 1
        # the unit's slots belong to its rows, in row order
        rows = owner[s0:s1]
        assert (rows >= f0).all() and (rows <= f1).all()
        assert (np.diff(rows) >= 0).all()
        if f0 < n_flat:   # merge-path invariant: row f0 is in progress
            assert row_start[f0] <= s0 <= row_end[f0]
        for f in range(f0, f1):
            owned = row_start[f] >= s0
            fixed = f == f0 and row_start[f] < s0
            assert owned != fixed
            done[f] += 1
    assert (covered == 1).all()
    assert (done == 1).all()


@pytest.mark.parametrize("kind", ["hub", "edges"])
@pytest.mark.parametrize("mode", ["add", "add_b", "min", "max"])
def test_units_fold_then_fixup_matches_plain(mode, kind):
    """The kernel's fold-then-fixup, emulated in plain torch over the
    split's units, against the plain version: min/max bit-equal, counts
    exact, add within rtol 1e-5."""
    k = 4
    args, ident = combine_layout(row_lengths(kind, k, seed=3), mode, seed=5)
    targs = _torch_args(args)
    kw = dict(mode=mode, tile=8, identity=ident)
    val, hc = emulate_units(targs, unit_slots=k, **kw)
    rv, rh = csr_spmv.block_csr_combine_ref(*targs, **kw)
    _check(mode, val.numpy(), hc.numpy(), rv.numpy(), rh.numpy())


def _torch_args(args, device="cpu"):
    """Numpy arguments that already carry the destination axis."""
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in args]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["add", "add_b", "min", "max"])
def test_cuda_kernel_matches_plain_version(cuda_device, mode):
    args, ident, _, T = _mode_inputs(mode, 0)
    before = csr_spmv.block_csr_combine.launches
    val, hc = csr_spmv.block_csr_combine(*_torch(args, cuda_device),
                                         mode=mode, tile=T, identity=ident)
    torch.cuda.synchronize()
    assert csr_spmv.block_csr_combine.launches == before + 1
    rv, rh = csr_spmv.block_csr_combine_ref(*_torch(args, cuda_device),
                                            mode=mode, tile=T,
                                            identity=ident)
    _check(mode, val[0].cpu().numpy(), hc[0].cpu().numpy(),
           rv[0].cpu().numpy(), rh[0].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["segment", "block_csr"])
def test_engine_on_cuda_matches_oracles(cuda_device, backend):
    """The whole LOCAL path on the card at a small size: both backends
    against the numpy oracles, the kernel launched once per ProcessEdges."""
    from repro_torch.core import (
        Engine, EngineConfig, build_dist_graph, build_formats, make_spec,
    )
    from repro_torch.core import algorithms as alg
    from repro_torch.data.graphs import rmat_graph
    g = rmat_graph(8, 8, seed=1, weighted=True)
    spec = make_spec(g, num_partitions=4, batch_size=16)
    dg = build_dist_graph(g, spec)
    cfg = EngineConfig(compute_backend=backend)
    eng = Engine(dg, build_formats(dg), cfg)
    assert eng.device.type == "cuda"
    n, src = g.num_vertices, int(np.argmax(g.out_degrees()))
    before = csr_spmv.block_csr_combine.launches
    pr, st = alg.pagerank(eng, 5)
    launched = csr_spmv.block_csr_combine.launches - before
    assert launched == (5 if backend == "block_csr" else 0)
    np.testing.assert_allclose(pr, alg.ref_pagerank(n, g.src, g.dst, 5),
                               rtol=1e-4, atol=1e-7)
    lv, _ = alg.bfs(eng, src)
    np.testing.assert_array_equal(lv, alg.ref_bfs(n, g.src, g.dst, src))
    ds, _ = alg.sssp(eng, src)
    np.testing.assert_allclose(ds, alg.ref_sssp(n, g.src, g.dst, g.data,
                                                src), rtol=1e-5, atol=1e-5)
    dr = build_dist_graph(g.reversed(), spec)
    lb, _ = alg.wcc(eng, Engine(dr, build_formats(dr), cfg))
    np.testing.assert_array_equal(lb, alg.ref_wcc(n, g.src, g.dst))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hub", "edges", "single", "empty"])
@pytest.mark.parametrize("mode", ["add", "add_b", "min", "max"])
def test_cuda_kernel_uneven_rows(cuda_device, mode, kind):
    """The CUDA kernel on rows the split must balance — a hub row per
    destination beside runs of empty rows, rows of K - 1, K and K + 1 tiles
    (K the library's unit size), a single tile, an all-empty call — against
    the plain version, one counted call each, and the same bits on a second
    call."""
    k = csr_spmv._library().block_csr_combine_unit_slots()
    cnt = row_lengths(kind, k, n_dest=3, n_rows=96, seed=7)
    args, ident = combine_layout(cnt, mode, seed=8)
    targs = _torch_args(args, cuda_device)
    kw = dict(mode=mode, tile=8, identity=ident)
    before = csr_spmv.block_csr_combine.launches
    val, hc = csr_spmv.block_csr_combine(*targs, **kw)
    again, _ = csr_spmv.block_csr_combine(*targs, **kw)
    torch.cuda.synchronize()
    assert csr_spmv.block_csr_combine.launches == before + 2
    assert torch.equal(val.view(torch.int32), again.view(torch.int32))
    rv, rh = csr_spmv.block_csr_combine_ref(*targs, **kw)
    _check(mode, val.cpu().numpy(), hc.cpu().numpy(), rv.cpu().numpy(),
           rh.cpu().numpy())
