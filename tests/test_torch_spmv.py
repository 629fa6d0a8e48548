"""block_csr_spmv through the port's kernel entry point: ``ops.spmv`` (the
plain PyTorch version on CPU tensors) against the JAX ``ops.spmv`` (the
Pallas kernel in interpret mode, as tests/test_kernels.py runs it) on the
same numpy inputs, the two packages' oracles against each other, and the
CUDA kernel against its plain version on a card (``pytest -m cuda``
there; the module imports jax only inside the tests that compare with it,
so it loads on a machine without jax).

Tolerances: rtol/atol 1e-5, the repo's SpMV tolerance
(tests/test_kernels.py): the JAX kernel sums in float32 in slot order, the
port in float64 rounded once.  Host structures are bit-equal."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import csr_spmv, ops, ref

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
    big = torch.zeros((1, 33, 33))
    with pytest.raises(ValueError):     # the kernel takes tiles up to 32
        csr_spmv._launch_spmv(big, torch.zeros(1, dtype=torch.int32),
                              torch.tensor([0, 1], dtype=torch.int32),
                              torch.zeros(33), tile=33)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):   # numpy goes to the GPU by default
        ops.spmv(blocks, x, tile=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,tile", SHAPES + [(300, 5000, 5),
                                               (200, 3000, 11)])
def test_cuda_kernel_matches_plain_version(cuda_device, n, e, tile):
    src, dst, data, x = _problem(n, e, tile)
    blocks = ops.build_block_csr(src, dst, data, n, tile)
    dev_blocks = {k: torch.from_numpy(v).to(cuda_device)
                  if isinstance(v, np.ndarray) else v
                  for k, v in blocks.items()}
    xd = torch.from_numpy(x).to(cuda_device)
    before = csr_spmv.block_csr_spmv.launches
    y = ops.spmv(dev_blocks, xd, tile=tile)
    torch.cuda.synchronize()
    assert csr_spmv.block_csr_spmv.launches == before + 1
    assert y.device.type == "cuda"
    y_plain = csr_spmv.block_csr_spmv_ref(
        dev_blocks["tiles"], dev_blocks["tile_col"], dev_blocks["row_ptr"],
        xd, tile=tile)
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        y.cpu().numpy()[:n], ref.ref_spmv_from_edges(src, dst, data, x[:n],
                                                     n),
        rtol=1e-5, atol=1e-5)
