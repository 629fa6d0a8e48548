"""block_csr_spmv through the port's kernel entry point: ``ops.spmv`` (the
packed form's plain PyTorch version on CPU tensors) against the JAX
``ops.spmv`` (the Pallas kernel in interpret mode, as tests/test_kernels.py
runs it) on the same numpy inputs, the two packages' oracles against each
other, the packed form (``csr_spmv.pack_block_csr``) and its invariants,
the kernel's walk over it emulated lane by lane
(``torchhelp.emulate_spmv_packed``), and the CUDA kernel against both
plain versions on a card (``pytest -m cuda`` there; the module imports jax
only inside the tests that compare with it, so it loads on a machine
without jax).

Tolerances: rtol/atol 1e-5, the repo's SpMV tolerance
(tests/test_kernels.py): the JAX kernel sums in float32 in slot order, the
port in float64 rounded once.  1e-6 between the port's packed and dense
plain versions (both float64 rounded once: they differ only in the order
of the float64 sum).  Host structures are bit-equal."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import csr_spmv, ops, ref
from torchhelp import emulate_spmv_packed

SHAPES = [(32, 100, 8), (64, 600, 8), (64, 600, 16), (128, 2000, 32),
          (33, 77, 8)]


def _problem(n, e, tile, seed=None):
    """tests/test_kernels.py::test_spmv_shapes' inputs: x padded to whole
    tiles."""
    rng = np.random.default_rng(n + e if seed is None else seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    data = rng.random(e).astype(np.float32)
    x_full = np.zeros(-(-n // tile) * tile, np.float32)
    x_full[:n] = rng.random(n).astype(np.float32)
    return src, dst, data, x_full


@pytest.mark.parametrize("n,e,tile", SHAPES)
def test_spmv_matches_jax(n, e, tile):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    src, dst, data, x = _problem(n, e, tile)
    blocks = ops.build_block_csr(src, dst, data, n, tile)
    y = ops.spmv(blocks, torch.from_numpy(x), tile=tile)
    assert y.dtype == torch.float32 and y.shape == (blocks["n_rows"] * tile,)
    y_jax = np.asarray(jops.spmv(jops.build_block_csr(src, dst, data, n,
                                                      tile), x, tile=tile))
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=1e-5, atol=1e-5)
    y_edges = jref.ref_spmv_from_edges(src, dst, data, x[:n], n)
    np.testing.assert_allclose(y.numpy()[:n], y_edges, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,e,tile", SHAPES)
def test_build_block_csr_bit_equal(n, e, tile):
    from repro.kernels.csr_spmv import build_block_csr
    src, dst, data, _ = _problem(n, e, tile)
    mine = ops.build_block_csr(src, dst, data, n, tile)
    theirs = build_block_csr(src, dst, data, n, tile)
    assert mine.keys() == theirs.keys()
    for key, val in theirs.items():
        if isinstance(val, np.ndarray):
            assert mine[key].dtype == val.dtype, key
            assert np.array_equal(mine[key], val), key
        else:
            assert mine[key] == val, key


def test_block_refs_match_jax():
    """tests/test_kernels.py::test_spmv_block_ref_agrees' inputs through
    both packages' dense block references and edge oracles."""
    from repro.kernels import ref as jref
    rng = np.random.default_rng(7)
    n, e, tile = 48, 300, 8
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    data = rng.random(e).astype(np.float32)
    x = rng.random(n).astype(np.float32)
    blocks = ops.build_block_csr(src, dst, data, n, tile)
    mine = ref.ref_block_csr_spmv(blocks["tiles"], blocks["tile_col"],
                                  blocks["row_ptr"], torch.from_numpy(x),
                                  tile=tile)
    theirs = jref.ref_block_csr_spmv(blocks["tiles"], blocks["tile_col"],
                                     blocks["row_ptr"], x, tile=tile)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6,
                               atol=1e-6)
    edges = ref.ref_spmv_from_edges(src, dst, data, x, n)
    np.testing.assert_array_equal(
        edges, jref.ref_spmv_from_edges(src, dst, data, x, n))
    np.testing.assert_allclose(mine.numpy()[:n], edges, rtol=1e-5,
                               atol=1e-5)


def test_plain_version_takes_ragged_rows():
    """Rows of any length (the kernel reads [row_ptr[r], row_ptr[r+1])),
    not only build_block_csr's padded ones: against the dense block
    reference on build_tile_struct's ragged layout."""
    rng = np.random.default_rng(3)
    n, e, tile = 96, 500, 8
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    data = rng.random(e).astype(np.float32)
    nb = n // tile
    slot_row, slot_col, rp, eslot = csr_spmv.build_tile_struct_np(
        dst // tile, src // tile, nb, nb)
    tiles = np.zeros((slot_row.size, tile, tile), np.float32)
    np.add.at(tiles, (eslot, dst % tile, src % tile), data)
    args = [torch.from_numpy(a) for a in (tiles, slot_col, rp)]
    x = torch.from_numpy(rng.random(n).astype(np.float32))
    y = csr_spmv.block_csr_spmv(*args, x, tile=tile)
    np.testing.assert_allclose(
        y.numpy(), ref.ref_block_csr_spmv(*args, x, tile=tile).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        y.numpy(), ref.ref_spmv_from_edges(src, dst, data, x.numpy(), n),
        rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_cannot_take(monkeypatch):
    src, dst, data, x = _problem(32, 100, 8)
    blocks = ops.build_block_csr(src, dst, data, 32, 8)
    with pytest.raises(ValueError):     # x is not whole tiles
        ops.spmv(blocks, torch.from_numpy(x[:-3]), tile=8)
    with pytest.raises(ValueError):     # x is shorter than the columns read
        ops.spmv(blocks, torch.from_numpy(x[:-8]), tile=8)
    big = csr_spmv.pack_block_csr(torch.ones((1, 33, 33)),
                                  torch.zeros(1, dtype=torch.int32),
                                  torch.tensor([0, 1], dtype=torch.int32),
                                  tile=33)
    with pytest.raises(ValueError):     # the kernel takes tiles up to 32
        csr_spmv._launch_spmv(big, torch.zeros(33))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):   # numpy goes to the GPU by default
        ops.spmv(blocks, x, tile=8)


# ---------------------------------------------------------------------------
# The packed form
# ---------------------------------------------------------------------------

def _dense(blocks):
    return [torch.from_numpy(blocks[k]) for k in ("tiles", "tile_col",
                                                  "row_ptr")]


@pytest.mark.parametrize("n,e,tile", SHAPES)
def test_packed_plain_version_matches_jax(n, e, tile):
    from repro.kernels import ops as jops
    src, dst, data, x = _problem(n, e, tile)
    blocks = ops.build_block_csr(src, dst, data, n, tile)
    packed = csr_spmv.pack_block_csr(*_dense(blocks), tile=tile)
    xt = torch.from_numpy(x)
    y = csr_spmv.block_csr_spmv_packed_ref(packed, xt)
    assert y.dtype == torch.float32 and y.shape == (blocks["n_rows"] * tile,)
    y_jax = np.asarray(jops.spmv(jops.build_block_csr(src, dst, data, n,
                                                      tile), x, tile=tile))
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        y.numpy(), csr_spmv.block_csr_spmv_ref(*_dense(blocks), xt,
                                               tile=tile).numpy(),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        y.numpy()[:n], ref.ref_spmv_from_edges(src, dst, data, x[:n], n),
        rtol=1e-5, atol=1e-5)


def _pack_case(case):
    """(src, dst, data, n, tile) of each named pack invariant case."""
    rng = np.random.default_rng(5)
    if case == "random":
        n, e, tile = 96, 700, 8
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    elif case == "empty_rows":          # rows 1 and 3 of 6 hold no edge
        n, tile = 48, 8
        dst = np.repeat([0, 16, 32, 40], 20) + rng.integers(0, 8, 80)
        src = rng.integers(0, n, 80)
    elif case == "all_zero":            # edges, every weight 0
        n, e, tile = 40, 60, 8
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
        return src, dst, np.zeros(e, np.float32), n, tile
    elif case == "full_tile":           # every cell of tile (1, 2), bit 63
        n, tile = 32, 8
        i, j = np.divmod(np.arange(64), 8)
        dst, src = 8 + i, 16 + j
    elif case == "long_row":            # one row of 70 live tiles, T = 4
        n, tile = 300, 4
        src = np.arange(0, 280, 4)
        dst = np.full(src.size, 5)
    else:                               # ragged n = 33
        n, e, tile = 33, 77, 8
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return src, dst, rng.random(src.size).astype(np.float32) + 0.5, n, tile


PACK_CASES = ["random", "empty_rows", "all_zero", "full_tile", "long_row",
              "ragged33"]


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_invariants(case):
    """The packed form holds exactly the dense structure's nonzero cells:
    popcounts sum to the nonzero count, and per row block ``prow`` counts
    the live tiles, ``pcol`` names them in slot order, ``pvoff`` counts
    the values, and ``pval`` is the dense nonzeros in (tile, cell)
    order."""
    src, dst, data, n, tile = _pack_case(case)
    blocks = ops.build_block_csr(src, dst, data, n, tile)
    tiles, tile_col, row_ptr = _dense(blocks)
    p = csr_spmv.pack_block_csr(tiles, tile_col, row_ptr, tile=tile)
    flat = tiles.reshape(tiles.shape[0], -1)
    nz = flat != 0
    live = nz.any(1)
    words = -(-tile * tile // 64)
    assert p["pmask"].shape == (int(live.sum()), words)
    assert p["pmask"].dtype == torch.int64 and p["prow"].dtype == torch.int64
    bits = ((p["pmask"].view(torch.uint8)[..., None]
             >> torch.arange(8, dtype=torch.uint8)) & 1).reshape(
                 p["pmask"].shape[0], words * 64)
    assert int(bits.sum()) == int(nz.sum()) == p["pval"].numel()
    assert torch.equal(bits[:, :tile * tile].bool(), nz[live])
    assert not bits[:, tile * tile:].any()
    assert torch.equal(p["pcol"], tile_col[live])
    assert torch.equal(p["pval"], flat[nz])
    rows = torch.repeat_interleave(torch.arange(blocks["n_rows"]),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    per_row = torch.bincount(rows[live], minlength=blocks["n_rows"])
    assert torch.equal(p["prow"][1:] - p["prow"][:-1], per_row)
    vals_per_row = torch.bincount(rows, weights=nz.sum(1).double(),
                                  minlength=blocks["n_rows"]).long()
    assert torch.equal(p["pvoff"][1:] - p["pvoff"][:-1], vals_per_row)
    assert p["prow"][0] == 0 and p["pvoff"][0] == 0
    x = torch.from_numpy(_problem(n, 10, tile, seed=1)[3])
    y = csr_spmv.block_csr_spmv_packed_ref(p, x)
    np.testing.assert_allclose(
        y.numpy(), csr_spmv.block_csr_spmv_ref(tiles, tile_col, row_ptr, x,
                                               tile=tile).numpy(),
        rtol=1e-6, atol=1e-6)
    if case == "empty_rows":
        assert (per_row == 0).sum() >= 2
        assert not y.reshape(-1, tile)[per_row == 0].any()
    if case == "all_zero":
        assert p["pcol"].numel() == 0 and not y.any()
    if case == "full_tile":
        assert p["pmask"].tolist() == [[-1]]        # all 64 bits, bit 63
    if case == "long_row":
        assert int(per_row.max()) == 70


def test_pack_drops_zero_weight_edges():
    """A zero-weight edge in a tile of its own is no live tile: the result
    is the same for finite x; against an inf at its source the dense
    product gives NaN and the packed form 0 (the documented difference)."""
    src, dst, data, x = _problem(64, 40, 8)
    used = set(zip((dst // 8).tolist(), (src // 8).tolist()))
    rb, cb = next((r, c) for r in range(8) for c in range(8)
                  if (r, c) not in used)
    zs, zd = cb * 8 + 3, rb * 8 + 4
    assert not np.any(src == zs)
    with_zero = ops.build_block_csr(np.append(src, zs), np.append(dst, zd),
                                    np.append(data, np.float32(0)), 64, 8)
    without = ops.build_block_csr(src, dst, data, 64, 8)
    p0 = csr_spmv.pack_block_csr(*_dense(with_zero), tile=8)
    p1 = csr_spmv.pack_block_csr(*_dense(without), tile=8)
    for key in csr_spmv.PACKED_ARRAYS:
        assert torch.equal(p0[key], p1[key]), key
    xt = torch.from_numpy(x)
    assert torch.equal(csr_spmv.block_csr_spmv_packed_ref(p0, xt),
                       csr_spmv.block_csr_spmv_packed_ref(p1, xt))
    xt[zs] = float("inf")
    y_dense = csr_spmv.block_csr_spmv_ref(*_dense(with_zero), xt, tile=8)
    y_packed = csr_spmv.block_csr_spmv_packed_ref(p0, xt)
    assert torch.isnan(y_dense[zd])
    assert torch.isfinite(y_packed).all()


def test_ops_spmv_packs_once_per_structure():
    src, dst, data, x = _problem(64, 600, 8)
    blocks = ops.build_block_csr(src, dst, data, 64, 8)
    xt = torch.from_numpy(x)
    before = csr_spmv.pack_block_csr.calls
    ys = [ops.spmv(blocks, xt, tile=8) for _ in range(3)]
    assert csr_spmv.pack_block_csr.calls == before + 1
    assert ops.PACKED_KEY in blocks
    assert all(torch.equal(y, ys[0]) for y in ys)
    other = ops.build_block_csr(src, dst, data, 64, 8)
    ops.spmv(other, xt, tile=8)
    assert csr_spmv.pack_block_csr.calls == before + 2
    with pytest.raises(ValueError):     # packed for T = 8
        ops.spmv(blocks, torch.zeros(64), tile=16)
    # the dense wrapper packs on every call
    csr_spmv.block_csr_spmv(*_dense(blocks), xt, tile=8)
    assert csr_spmv.pack_block_csr.calls == before + 3


@pytest.mark.parametrize("case", PACK_CASES)
def test_kernel_walk_matches_packed_plain_version(case):
    """The CUDA kernel's offset arithmetic (32 tiles per step, values from
    ``pvoff`` plus a scan of popcounts), emulated on the CPU."""
    src, dst, data, n, tile = _pack_case(case)
    blocks = ops.build_block_csr(src, dst, data, n, tile)
    p = csr_spmv.pack_block_csr(*_dense(blocks), tile=tile)
    x = _problem(n, 10, tile, seed=2)[3]
    np.testing.assert_allclose(
        emulate_spmv_packed(p, x),
        csr_spmv.block_csr_spmv_packed_ref(p, torch.from_numpy(x)).numpy(),
        rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _on(blocks, device):
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in blocks.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,tile", SHAPES + [(300, 5000, 5),
                                               (200, 3000, 11)])
def test_cuda_kernel_matches_plain_version(cuda_device, n, e, tile):
    src, dst, data, x = _problem(n, e, tile)
    blocks = ops.build_block_csr(src, dst, data, n, tile)
    dev_blocks = _on(blocks, cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    for _ in range(2):                  # packs, then reads the packed form
        before = csr_spmv.block_csr_spmv.launches
        y = ops.spmv(dev_blocks, xd, tile=tile)
        torch.cuda.synchronize()
        assert csr_spmv.block_csr_spmv.launches == before + 1
    assert y.device.type == "cuda"
    packed = dev_blocks[ops.PACKED_KEY]
    assert packed["pval"].device.type == "cuda"
    torch.testing.assert_close(
        y, csr_spmv.block_csr_spmv_packed_ref(packed, xd), rtol=1e-5,
        atol=1e-5)
    y_plain = csr_spmv.block_csr_spmv_ref(
        dev_blocks["tiles"], dev_blocks["tile_col"], dev_blocks["row_ptr"],
        xd, tile=tile)
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        y.cpu().numpy()[:n], ref.ref_spmv_from_edges(src, dst, data, x[:n],
                                                     n),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PACK_CASES)
def test_cuda_kernel_on_the_pack_cases(cuda_device, case):
    """Rows of more than 32 live tiles, full tiles (bit 63), empty rows,
    an all-zero structure; the dense wrapper packs and launches each
    call."""
    src, dst, data, n, tile = _pack_case(case)
    blocks = _on(ops.build_block_csr(src, dst, data, n, tile), cuda_device)
    dense = [blocks[k] for k in ("tiles", "tile_col", "row_ptr")]
    x = torch.from_numpy(_problem(n, 10, tile, seed=1)[3]).to(cuda_device)
    before = csr_spmv.block_csr_spmv.launches
    y = csr_spmv.block_csr_spmv(*dense, x, tile=tile)
    torch.cuda.synchronize()
    assert csr_spmv.block_csr_spmv.launches == before + 1
    packed = csr_spmv.pack_block_csr(*dense, tile=tile)
    torch.testing.assert_close(
        y, csr_spmv.block_csr_spmv_packed_ref(packed, x), rtol=1e-5,
        atol=1e-5)
    torch.testing.assert_close(
        y, csr_spmv.block_csr_spmv_ref(*dense, x, tile=tile), rtol=1e-5,
        atol=1e-5)
