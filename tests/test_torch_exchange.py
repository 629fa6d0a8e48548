"""The port's wire (``repro_torch.core.exchange``) against the JAX package's
``repro.core.exchange`` on the same seeded inputs: every batch format and
the multi-query panel encode to the reference's bytes, each package
decodes the other's payloads, the gap-stream decode through the varint
kernels' path (their plain versions on the CPU) equals the host codec, and
:class:`Exchange` / :class:`DecodeAhead` assemble the same receive views
and tallies as the reference's.

Tolerance: bytes, integers and copied float32 values, so every comparison
is exact.  The JAX package is imported inside the tests that compare with
it, so ``pytest -m cuda`` loads this module on a machine without jax."""
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

from repro_torch.core import (
    EngineConfig, build_dist_graph, codec, make_spec,
)
from repro_torch.core import exchange as ex
from repro_torch.core.phases import batch_value_uniform, filter_sendmask
from repro_torch.data.graphs import GraphData


def _ref():
    from repro.core import exchange
    return exchange


V_MAX = 4096
# (density, uniform values, compression): together they reach all four
# formats under the three-way choice and both of the legacy two-way one
CASES = [
    (0.0005, False, True), (0.002, True, True), (0.02, False, True),
    (0.3, False, True), (0.3, True, True), (0.999, False, True),
    (0.02, False, False), (0.999, False, False), (0.6, True, False),
]


def _batch(density, uniform, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(V_MAX) < density
    mask[rng.integers(V_MAX)] = True           # never empty
    values = (np.full(V_MAX, 3.5, np.float32) if uniform
              else rng.random(V_MAX).astype(np.float32))
    # entries off the mask are garbage by contract: never read
    values[~mask] = rng.standard_normal((~mask).sum()).astype(np.float32)
    return mask, values


@pytest.mark.parametrize("density,uniform,compression", CASES)
def test_encode_matches_reference(density, uniform, compression):
    ref = _ref()
    mask, values = _batch(density, uniform, seed=int(density * 1e4))
    count = int(mask.sum())
    fmt, payload = ex.encode_batch(mask, values, count,
                                   compression=compression)
    assert (fmt, payload) == ref.encode_batch(mask, values, count,
                                              compression=compression)
    gb = uni = None
    if compression:
        gb = float(codec.mask_gap_bytes(mask[None])[0])
        uni = batch_value_uniform(mask[None], values[None], xp=np)[0]
    assert len(payload) == float(ex.batch_wire_bytes(
        count, V_MAX, 4, gap_bytes=gb, uniform=uni))
    # cross-decode both ways, host codec and the device path on the CPU
    want = (mask, np.where(mask, values, 0.0).astype(np.float32))
    for decode in (lambda *a: ex.decode_batch(*a),
                   lambda *a: ex.decode_batch(*a, device="cpu"),
                   lambda *a: ref.decode_batch(*a)):
        m2, v2 = decode(fmt, payload, count, V_MAX)
        np.testing.assert_array_equal(m2, want[0])
        np.testing.assert_array_equal(np.where(m2, v2, 0.0), want[1])


def test_every_format_is_exercised():
    seen = {ex.encode_batch(*_batch(d, u, seed=int(d * 1e4)),
                            compression=c)[0] for d, u, c in CASES}
    assert seen == {ex.FMT_PAIRS, ex.FMT_SLAB, ex.FMT_VPAIRS, ex.FMT_UVAL}


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="unknown wire format"):
        ex.decode_batch(9, b"", 0, 8)


@pytest.mark.parametrize("nq", [2, 5])
def test_panel_matches_reference(nq):
    ref = _ref()
    rng = np.random.default_rng(nq)
    masks = rng.random((nq, V_MAX)) < 0.05
    masks[-1] = False                          # an empty column
    values = rng.random((nq, V_MAX)).astype(np.float32)
    values[0] = 2.0                            # a uniform column
    union = masks.any(axis=0)
    counts = [int(m.sum()) for m in masks]
    cols, payload = ex.mq_encode_panel(masks, values, union, counts)
    assert (cols, payload) == ref.mq_encode_panel(masks, values, union,
                                                  counts)
    u = int(union.sum())
    for decode in (lambda: ex.mq_decode_panel(cols, payload, u, V_MAX, nq),
                   lambda: ex.mq_decode_panel(cols, payload, u, V_MAX, nq,
                                              device="cpu"),
                   lambda: ref.mq_decode_panel(cols, payload, u, V_MAX, nq)):
        m2, v2 = decode()
        np.testing.assert_array_equal(m2, masks)
        np.testing.assert_array_equal(v2, np.where(masks, values, 0.0))


def _gap_stream(seed, n, big):
    """The gap stream of ``n`` sorted indices; ``big`` makes every
    seventh gap a 4- or 5-byte varint (below 2**31, the kernels' int32
    domain)."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(1, 300, n).astype(np.uint64)
    if big:
        gaps[::7] = rng.integers(2**21, 2**31, gaps[::7].size)
    return codec.varint_encode(gaps).tobytes(), n


@pytest.mark.parametrize("n,big", [(1, False), (37, False), (5000, False),
                                   (40, True), (3000, True)])
def test_gap_decode_equals_codec(n, big):
    stream, count = _gap_stream(n, n, big)
    want = np.cumsum(codec.varint_decode(stream, count).astype(np.int64)) - 1
    host = ex._gap_decode(stream, count)
    dev = ex._gap_decode(stream, count, device="cpu")
    assert host.dtype == dev.dtype == np.int64
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev, want)
    np.testing.assert_array_equal(
        _ref()._gap_decode(stream, count, False), want)


def _posts(v_max, p_cnt, seed):
    """Send lists of every (p, q) pair of a 4-partition, 2-worker run."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(p_cnt):
        vals = rng.random(v_max).astype(np.float32)
        if p == 1:
            vals[:] = 7.0                      # a uniform source: uval
        for q in range(p_cnt):
            mask = rng.random(v_max) < (0.9 if (p + q) % 3 == 0 else 0.01)
            if mask.any():
                out.append((p, q, mask, vals))
    return out


@pytest.mark.parametrize("compression", [True, False])
def test_exchange_matches_reference(compression):
    ref = _ref()
    p_cnt, w_cnt, v_max = 4, 2, 700
    worker_of = np.repeat(np.arange(w_cnt), p_cnt // w_cnt)
    port = ex.Exchange(w_cnt, v_max, compression=compression)
    jax = ref.Exchange(w_cnt, v_max, compression=compression)
    for p, q, mask, vals in _posts(v_max, p_cnt, seed=int(compression)):
        for e in (port, jax):
            e.post(int(worker_of[p]), int(worker_of[q]), p, q, mask, vals,
                   count=int(mask.sum()))
    a, b = port.counter_snapshot(), jax.counter_snapshot()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert a["bytes_sent"] > 0 and a["posted"].trace() > 0
    for q in range(p_cnt):
        w = int(worker_of[q])
        mine = port.take_dest(w, q, p_cnt, device="cpu")
        theirs = jax.take_dest(w, q, p_cnt)
        for x, y in zip(mine, theirs):
            np.testing.assert_array_equal(x, y)
    # an inbox is drained once
    assert not port.take_dest(0, 0, p_cnt)[0].any()


def test_exchange_posts_from_threads():
    """W senders posting at once: the tallies and the receive views are
    those of one sequential sender."""
    p_cnt, w_cnt, v_max = 4, 4, 700
    posts = _posts(v_max, p_cnt, seed=3)
    seq = ex.Exchange(w_cnt, v_max)
    for p, q, mask, vals in posts:
        seq.post(p, q, p, q, mask, vals)
    par = ex.Exchange(w_cnt, v_max)
    barrier = threading.Barrier(p_cnt)

    def send(p):
        barrier.wait()
        for pp, q, mask, vals in posts:
            if pp == p:
                par.post(p, q, p, q, mask, vals)

    threads = [threading.Thread(target=send, args=(p,)) for p in range(p_cnt)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    a, b = seq.counter_snapshot(), par.counter_snapshot()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for q in range(p_cnt):
        for x, y in zip(seq.take_dest(q, q, p_cnt), par.take_dest(q, q, p_cnt)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("runner", [False, True], ids=["thread", "runner"])
def test_decode_ahead_delivers_in_order(runner):
    p_cnt, v_max = 4, 300
    e = ex.Exchange(2, v_max)
    want = {}
    for p, q, mask, vals in _posts(v_max, p_cnt, seed=5):
        e.post(p // 2, 1, p, q, mask, vals)
    ref = ex.Exchange(2, v_max)
    for p, q, mask, vals in _posts(v_max, p_cnt, seed=5):
        ref.post(p // 2, 1, p, q, mask, vals)
    for q in (2, 3):
        want[q] = ref.take_dest(1, q, p_cnt)
    lock = threading.Lock()
    with ThreadPoolExecutor(2) as pool:
        got = list(ex.DecodeAhead(e, 1, [2, 3], p_cnt, compute_lock=lock,
                                  runner=pool if runner else None,
                                  device="cpu"))
    assert [g[0] for g in got] == [2, 3]
    for q, mask, msg in got:
        np.testing.assert_array_equal(mask, want[q][0])
        np.testing.assert_array_equal(msg, want[q][1])
    assert not lock.locked()


def test_decode_ahead_reraises_and_rejects_panels():
    class Broken(ex.Exchange):
        def take_dest(self, *a, **k):
            raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(ex.DecodeAhead(Broken(1, 8), 0, [0], 1))
    # num_queries > 1 yields [Q, P, v_max] panels (an empty inbox: nothing
    # present)
    (q, mask, msg), = ex.DecodeAhead(ex.Exchange(1, 8), 0, [0], 1,
                                     num_queries=2)
    assert q == 0 and mask.shape == msg.shape == (2, 1, 8)
    assert not mask.any() and not msg.any()


# ---------------------------------------------------------------------------
# The filter + wire never drop an active-relevant message (the port's twin
# of tests/test_filter_property.py), and the receive views equal JAX's
# ---------------------------------------------------------------------------

@st.composite
def graphs(draw, max_n=48, max_e=200):
    n = draw(st.integers(4, max_n))
    e = draw(st.integers(1, max_e))
    rng = np.random.default_rng(draw(st.integers(0, 2**16)))
    return GraphData(n, rng.integers(0, n, e), rng.integers(0, n, e),
                     rng.random(e).astype(np.float32))


@settings(max_examples=15, deadline=None)
@given(graphs(), st.integers(2, 4), st.integers(0, 2**16),
       st.floats(0.5, 4.0), st.booleans(), st.sampled_from(["one", "P"]))
# A threshold just above 1/2 against m = 2 active vertices: 1 >= 2t holds
# in float32 (the reference's compare, a Python-float m kept weak) and not
# in float64.
@example(GraphData(4, np.array([3]), np.array([1]),
                   np.array([0.5], np.float32)),
         2, 0, 0.5000000000000001, True, "one")
def test_filter_and_wire_deliver_every_active_message(
        g, p, seed, threshold, filtering, workers):
    """Every edge with an active source is delivered to the partition
    owning its destination, its value bit-intact, through the port's
    phase-2 filter and its wire (serialized and decoded, gap streams
    through the device path, whenever the workers differ); nothing from
    an inactive source arrives; and the receive views equal those of the
    reference's filter and exchange on the same inputs."""
    ref = _ref()
    from repro.core import phases as jphases
    p = min(p, g.num_vertices)
    spec = make_spec(g, num_partitions=p, batch_size=8)
    dg = build_dist_graph(g, spec)
    v_max = spec.v_max
    cfg = EngineConfig(enable_filtering=filtering,
                       filter_skip_threshold=threshold)
    rng = np.random.default_rng(seed)
    vertex_valid = dg.vertex_valid.numpy()
    amask = (rng.random(vertex_valid.shape) < 0.5) & vertex_valid
    values = rng.random((p, v_max)).astype(np.float32)
    need, need_counts = dg.need.numpy(), dg.need_counts.numpy()
    n_workers = 1 if workers == "one" else p
    worker_of = np.repeat(np.arange(n_workers), p // n_workers)
    port = ex.Exchange(n_workers, v_max)
    jax = ref.Exchange(n_workers, v_max)
    for src_p in range(p):
        m = float(amask[src_p].sum())
        args = (amask[src_p], need[src_p], need_counts[src_p], m, cfg)
        sm = filter_sendmask(*args, xp=np)
        np.testing.assert_array_equal(sm, jphases.filter_sendmask(*args,
                                                                  xp=np))
        for q in range(p):
            if sm[q].any():
                for e in (port, jax):
                    e.post(int(worker_of[src_p]), int(worker_of[q]), src_p,
                           q, sm[q], values[src_p])
    assert port.bytes_sent == jax.bytes_sent
    recv_mask = np.zeros((p, p, v_max), bool)
    recv_vals = np.zeros((p, p, v_max), np.float32)
    for q in range(p):
        recv_mask[q], recv_vals[q] = port.take_dest(int(worker_of[q]), q, p,
                                                    device="cpu")
        jm, jv = jax.take_dest(int(worker_of[q]), q, p)
        np.testing.assert_array_equal(recv_mask[q], jm)
        np.testing.assert_array_equal(recv_vals[q], jv)
    bounds = np.asarray(spec.boundaries)
    src_part, dst_part = spec.owner_of(g.src), spec.owner_of(g.dst)
    src_local = g.src - bounds[src_part]
    active_edge = amask[src_part, src_local]
    delivered = recv_mask[dst_part, src_part, src_local]
    assert delivered[active_edge].all()
    assert not delivered[~active_edge].any()
    np.testing.assert_array_equal(
        recv_vals[dst_part, src_part, src_local][active_edge],
        values[src_part, src_local][active_edge])


# ---------------------------------------------------------------------------
# The gap decode on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,big", [(1, False), (5000, False), (3000, True),
                                   (300_000, False)])
def test_gap_decode_on_cuda(cuda_device, n, big):
    """One stencil and one add scan launch per stream, and the indices of
    the host codec, bit for bit."""
    from repro_torch.kernels import varint
    stream, count = _gap_stream(n, n, big)
    varint.reset_launches()
    got = ex._gap_decode(stream, count, device=cuda_device)
    assert varint.byte_stencil.launches == 1
    assert varint.blocked_scan.launches_by_mode == {"add": 1, "max": 0}
    np.testing.assert_array_equal(got, ex._gap_decode(stream, count))
