"""The port's varint/delta decode (``repro_torch.kernels.varint``) against
the JAX Pallas kernels (interpret mode, as tests/test_varint_kernels.py
runs them) and the numpy codec, and the CUDA kernels against their plain
versions on a card (``pytest -m cuda`` there; the module imports jax only
inside the tests that compare with it, so it loads on a machine without
jax).

Tolerance: everything here is integer arithmetic, so every comparison is
bit-equal."""
import numpy as np
import pytest
import torch

from repro_torch.core import codec
from repro_torch.kernels import varint as vk
from torchhelp import emulate_lookback_scan

INT32_MAX = 2**31 - 1

ADVERSARIAL = [
    [],                                     # empty chunk
    [0],                                    # single value, zero delta
    [INT32_MAX],                            # max-width: full 5-group varint
    [INT32_MAX] * 7,                        # back-to-back max-width varints
    [0] * 2048,                             # dense: all one-byte residues
    [127, 128, 2**14 - 1, 2**14, 2**21 - 1, 2**21, 2**28 - 1, 2**28,
     INT32_MAX],                            # every int32 group boundary
]


def _encoded(vals):
    return np.frombuffer(codec.varint_encode(np.asarray(vals, np.uint64))
                         .tobytes(), np.uint8)


def _port_decode(buf, nbytes, count, device="cpu"):
    out = vk.varint_decode(torch.from_numpy(buf.copy()).to(device), nbytes,
                           count=count)
    return out.cpu().numpy()


def _jax_decode(buf, nbytes, count):
    from repro.kernels import varint as jvk
    return np.asarray(jvk.varint_decode(buf, nbytes, count=count,
                                        interpret=True))


def _chunk(seed, n_runs=9, base=4096):
    """A sorted chunk: runs by strictly increasing src, dst non-decreasing
    within a run, all >= the batch base.  Returns (base, srcs, runs, dst,
    starts)."""
    rng = np.random.default_rng(seed)
    srcs = np.sort(rng.choice(2**20, n_runs, replace=False)).astype(np.int64)
    runs = rng.integers(1, 9, n_runs)
    dst = np.concatenate([base + np.sort(rng.integers(0, 2**12, r))
                          for r in runs]).astype(np.int64)
    starts = (np.cumsum(runs) - runs).astype(np.int64)
    return base, srcs, runs, dst, starts


# ---------------------------------------------------------------------------
# varint_decode and the stencil vs the JAX kernels and the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ADVERSARIAL,
                         ids=["empty", "zero", "max", "max7", "dense",
                              "groups"])
def test_varint_decode_matches_jax_and_codec(case):
    buf = _encoded(case)
    count = max(len(case), 1)
    port = _port_decode(buf, buf.size, count)
    np.testing.assert_array_equal(port, _jax_decode(buf, buf.size, count))
    np.testing.assert_array_equal(
        port[:len(case)], np.asarray(case, np.int64).astype(np.int32))


def test_varint_decode_short_stream_and_inactive_tail():
    buf = np.zeros(64, np.uint8)
    enc = _encoded([5, 300, 7])
    buf[:enc.size] = enc
    np.testing.assert_array_equal(_port_decode(buf, enc.size, 8),
                                  [5, 300, 7, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(_port_decode(np.zeros(16, np.uint8), 0, 4),
                                  np.zeros(4, np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_byte_stencil_matches_jax_every_position(seed):
    """term and val agree at every byte, terminators or not, on a stream
    padded to the reference's block (as its ``varint_decode`` pads)."""
    import jax.numpy as jnp
    from repro.kernels import varint as jvk
    rng = np.random.default_rng(seed)
    enc = _encoded(rng.integers(0, INT32_MAX, 400) >> rng.integers(0, 31,
                                                                   400))
    buf = np.zeros(-(-enc.size // 512) * 512, np.uint8)
    buf[:enc.size] = enc
    jt, jv = jvk._byte_stencil(jnp.asarray(buf.astype(np.int32)),
                               interpret=True)
    term, val = vk.byte_stencil(torch.from_numpy(buf))
    np.testing.assert_array_equal(term.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n", [1, 7, 512, 513, 3000])
@pytest.mark.parametrize("mode", ["add", "max"])
def test_blocked_scan_matches_jax(n, mode):
    """Including negative inputs (max clamps at its 0 seed) and sums that
    wrap in int32."""
    import jax.numpy as jnp
    from repro.kernels import varint as jvk
    rng = np.random.default_rng(n)
    x = rng.integers(-50, 2**30, n).astype(np.int32)
    port = vk.blocked_scan(torch.from_numpy(x), mode=mode).numpy()
    np.testing.assert_array_equal(
        port, np.asarray(jvk.blocked_scan(jnp.asarray(x), mode=mode,
                                          interpret=True)))
    if mode == "max":
        np.testing.assert_array_equal(
            port, np.maximum(np.maximum.accumulate(x), 0))


def test_blocked_scan_rejects_bad_input():
    with pytest.raises(ValueError):
        vk.blocked_scan(torch.zeros(4, dtype=torch.int32), mode="min")
    with pytest.raises(ValueError):
        vk.blocked_scan(torch.zeros(4, dtype=torch.int64))
    assert vk.blocked_scan(torch.zeros(0, dtype=torch.int32)).numel() == 0


@pytest.mark.parametrize("n,words", [(1, 0), (4096, 0), (4097, 3),
                                     (989_695, 243), (2**24 + 3, 4098)])
def test_scan_scratch_len_is_the_one_levels_status_words(n, words):
    """One 64-bit status word per tile of 4,096 elements plus the tile
    counter, and none when the input fits in one tile (the kernel then
    runs alone, without look-back)."""
    assert vk._SCAN_TILE == 4096
    assert vk.scan_scratch_len(n) == words


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["add", "max"])
def test_lookback_emulation_matches_plain_version(mode, seed):
    """The kernel's look-back (32 predecessors a window, folded up to the
    nearest inclusive prefix) with the blocks' progress interleaved at
    random, on tiles of 4 so that windows chain; sums wrap in int32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-50, 2**30, 1500).astype(np.int32)
    out, windows = emulate_lookback_scan(x, mode=mode, tile=4, seed=seed)
    np.testing.assert_array_equal(
        out, vk.blocked_scan_ref(torch.from_numpy(x), mode=mode).numpy())
    assert windows > 1


# ---------------------------------------------------------------------------
# The restores vs the JAX functions and the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_restores_match_jax_and_codec(seed):
    from repro.kernels import varint as jvk
    base, srcs, runs, dst, starts = _chunk(seed)
    nnz, n_e = srcs.size, dst.size
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    j = lambda a: np.asarray(a)
    # pair stream: decode + cumsum restore
    enc = _encoded(codec.pair_delta_values(srcs, starts))
    pv = _port_decode(enc, enc.size, 2 * nnz)
    s, i = vk.pair_delta_restore(t(pv))
    js, ji = jvk.pair_delta_restore(pv, interpret=True)
    np.testing.assert_array_equal(s.numpy(), j(js))
    np.testing.assert_array_equal(i.numpy(), j(ji))
    np.testing.assert_array_equal(s.numpy(), srcs)
    np.testing.assert_array_equal(i.numpy(), starts)
    # run expansion (out_len past n_e, so the zeroed tail is checked too)
    out_len = n_e + 5
    esrc, smask = vk.expand_dcsr_index(t(srcs), t(starts), nnz, n_e,
                                       out_len=out_len)
    je, jm = jvk.expand_dcsr_index(srcs.astype(np.int32),
                                   starts.astype(np.int32), nnz, n_e,
                                   out_len=out_len, interpret=True)
    np.testing.assert_array_equal(esrc.numpy(), j(je))
    np.testing.assert_array_equal(smask.numpy(), j(jm))
    np.testing.assert_array_equal(esrc.numpy()[:n_e], np.repeat(srcs, runs))
    # dst residues
    res = codec.dst_delta_values(dst, starts, base).astype(np.int32)
    rpad = np.zeros(out_len, np.int32)
    rpad[:n_e] = res
    d = vk.dst_delta_restore(t(rpad), smask, base, n_e)
    jd = jvk.dst_delta_restore(rpad, j(jm), base, n_e, interpret=True)
    np.testing.assert_array_equal(d.numpy(), j(jd))
    np.testing.assert_array_equal(d.numpy()[:n_e], dst)


def test_expand_csr_index_matches_jax_and_repeat():
    from repro.kernels import varint as jvk
    rng = np.random.default_rng(1)
    v_src, vpad = 37, 48
    deg = rng.integers(0, 4, v_src)
    idx = np.zeros(vpad + 1, np.int32)
    idx[1:v_src + 1] = np.cumsum(deg)
    idx[v_src + 1:] = idx[v_src]
    n_e = int(deg.sum())
    esrc, smask = vk.expand_csr_index(torch.from_numpy(idx), v_src, n_e,
                                      out_len=n_e + 5)
    je, jm = jvk.expand_csr_index(idx, v_src, n_e, out_len=n_e + 5,
                                  interpret=True)
    np.testing.assert_array_equal(esrc.numpy(), np.asarray(je))
    np.testing.assert_array_equal(smask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(esrc.numpy()[:n_e],
                                  np.repeat(np.arange(v_src), deg))


def _overflow_chunk():
    """3,000 one-edge runs whose dst sits at the top of a 2**20 batch:
    their residues sum to 3,000 * (2**20 - 1) > 2**31."""
    n_runs, bs = 3000, 2**20
    base = 5 * bs
    dst = np.full(n_runs, base + bs - 1, np.int64)
    starts = np.arange(n_runs, dtype=np.int64)
    res = codec.dst_delta_values(dst, starts, base)
    assert int(res.astype(np.int64).sum()) >= 2**31
    return base, dst, starts, res


def test_dst_delta_restore_exact_when_the_residue_sum_wraps():
    """The port equals the host codec on a chunk whose residue sum exceeds
    2**31.  The reference's device restore does not: it forward-fills
    ``csum - res`` with a max-scan, which fails once the int32 ``csum``
    wraps (ROADMAP Queue 3; two chunks of R-MAT scale 21, seed 0, P = 8
    are such chunks)."""
    from repro.kernels import varint as jvk
    base, dst, starts, res = _overflow_chunk()
    n_e = dst.size
    host = codec.dst_delta_restore(res, starts, np.ones(n_e, np.int64), base)
    smask = np.ones(n_e, np.int32)
    r32 = res.astype(np.int64).astype(np.int32)
    port = vk.dst_delta_restore(torch.from_numpy(r32),
                                torch.from_numpy(smask), base, n_e)
    np.testing.assert_array_equal(port.numpy(), host)
    np.testing.assert_array_equal(host, dst)
    ref = np.asarray(jvk.dst_delta_restore(r32, smask, base, n_e,
                                           interpret=True))
    assert not np.array_equal(ref, host)       # the reference's fault


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions, on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


SCAN_SIZES = [1, 31, 2047, 2048, 2049, 4095, 4096, 4097, 989_695,
              5_000_000, 2**24 + 3]


@pytest.mark.cuda
@pytest.mark.parametrize("n", SCAN_SIZES)
@pytest.mark.parametrize("mode", ["add", "max"])
def test_cuda_scan_matches_plain_version(cuda_device, n, mode):
    """Sizes across the tile edge and up to 4,097 tiles of look-back;
    values that wrap the int32 sum.  Add mode also equals torch.cumsum."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-50, 2**30, n).astype(np.int32))
    before = vk.blocked_scan.launches
    out = vk.blocked_scan(x.to(cuda_device), mode=mode)
    torch.cuda.synchronize()
    assert vk.blocked_scan.launches == before + 1
    assert torch.equal(out.cpu(), vk.blocked_scan_ref(x, mode=mode))
    if mode == "add":
        assert torch.equal(out, torch.cumsum(x.to(cuda_device), 0,
                                             dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("start", [1, 3])
@pytest.mark.parametrize("mode", ["add", "max"])
def test_cuda_scan_on_unaligned_views(cuda_device, start, mode):
    """Views that start 4 or 12 bytes into their storage take the kernel's
    element-wise path instead of its 16-byte staged one."""
    rng = np.random.default_rng(start)
    x = torch.from_numpy(rng.integers(-50, 2**30, 2**20 + 5).astype(np.int32))
    view = x.to(cuda_device)[start:]
    assert view.data_ptr() % 16
    out = vk.blocked_scan(view, mode=mode)
    assert torch.equal(out.cpu(), vk.blocked_scan_ref(x[start:], mode=mode))


@pytest.mark.cuda
def test_cuda_scan_scratch_matches_the_library(cuda_device):
    lib = vk._library()
    for n in SCAN_SIZES + [4096, 4097, 2**31]:
        assert lib.scan_scratch_words(n) == vk.scan_scratch_len(n), n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["add", "max"])
def test_cuda_scan_back_to_back_on_two_streams(cuda_device, mode):
    """Calls queued back to back, without a sync between them, on the
    default stream and on a side stream: each call zeroes its own status
    words, so nothing of the call before leaks into the next (the inputs
    differ in sign and size, so a stale prefix would show)."""
    rng = np.random.default_rng(11)
    xs = [torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32))
          for lo, hi, n in ((0, 2**30, 989_695), (-2**30, 0, 989_695),
                            (-50, 2**30, 70_000), (0, 9, 2**21 + 5))]
    side = torch.cuda.Stream(cuda_device)
    for stream in (torch.cuda.current_stream(cuda_device), side):
        with torch.cuda.stream(stream):
            dev = [x.to(cuda_device) for x in xs]
            outs = [vk.blocked_scan(d, mode=mode) for d in dev for _ in
                    range(2)]
        stream.synchronize()
        for i, out in enumerate(outs):
            assert torch.equal(out.cpu(),
                               vk.blocked_scan_ref(xs[i // 2], mode=mode))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 989_695])
def test_cuda_scan_is_one_kernel_and_one_memset(cuda_device, n):
    """The profiler's device events of one call: one scan kernel, and one
    memset exactly when the input spans more than one tile."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(n, dtype=torch.int32, device=cuda_device)
    vk.blocked_scan(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vk.blocked_scan(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [m for m in names if "scan_kernel" in m]
    memsets = [m for m in names if "emset" in m]
    assert len(kernels) == 1, names
    assert len(memsets) == (0 if n <= vk._SCAN_TILE else 1), names


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 4099, 3_000_001])
def test_cuda_stencil_matches_plain_version(cuda_device, n):
    rng = np.random.default_rng(n)
    buf = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
    before = vk.byte_stencil.launches
    term, val = vk.byte_stencil(buf.to(cuda_device))
    torch.cuda.synchronize()
    assert vk.byte_stencil.launches == before + 1
    rt, rv = vk.byte_stencil_ref(buf)
    assert torch.equal(term.cpu(), rt) and torch.equal(val.cpu(), rv)


@pytest.mark.cuda
def test_cuda_decode_chain_matches_codec(cuda_device):
    rng = np.random.default_rng(7)
    vals = rng.integers(0, INT32_MAX, 100_000) >> rng.integers(0, 31,
                                                               100_000)
    buf = _encoded(vals)
    out = _port_decode(buf, buf.size, vals.size, device=cuda_device)
    np.testing.assert_array_equal(out, vals.astype(np.int32))
    base, dst, starts, res = _overflow_chunk()
    d = vk.dst_delta_restore(
        torch.from_numpy(res.astype(np.int64).astype(np.int32)).to(
            cuda_device),
        torch.ones(dst.size, dtype=torch.int32, device=cuda_device), base,
        dst.size)
    np.testing.assert_array_equal(d.cpu().numpy(), dst)
