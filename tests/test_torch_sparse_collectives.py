"""The port's mesh collectives (``repro_torch.core.sparse_collectives``)
against the reference's (``repro.core.sparse_collectives``).

The reference's collectives run here under ``jax.vmap`` with a named axis
of P = 4 simulated ranks, which gives their full all-to-all semantics in
process.  Each port collective is a rank-local half (``*_send``) plus the
mesh's all-to-all, so the local halves are held in process: stacked over
the source ranks, they are the reference's received buffers with the
rank axes swapped — bit for bit (values, source indices, padding).  The
receive side (``compacted_scatter_back`` and its panel twin) is held on
the reference's received buffers directly.  One spawned job of 4 gloo
ranks then runs the real collectives on the same inputs: the compacted
exchange plus scatter-back equals ``filtered_all_to_all`` bit for bit,
solo and panel, every received buffer equals the reference's, and the
``pmax``'d overflow flag trips, on every rank, one below the per-peer
maximum and not at it.

``capacity_bucket`` and ``blocked_cumsum`` equal the reference's on a
range of inputs (integer scans: exact)."""
import numpy as np
import pytest
import torch

import meshhelp
from repro_torch.core import run_mesh
from repro_torch.core import sparse_collectives as sc

P, V, D, NQ = 4, 96, 3, 3
DENSITIES = [0.15, 0.0, 0.9]


def seeded(density, seed=7, negative_zero=True):
    """Seeded inputs: per source rank [P] the solo values and [P, V] send
    masks, the panel's [V, Q] values and [P, V, Q] masks, and the
    one-destination payload [V, D] and destinations [V].  Live zeros
    ship; with ``negative_zero`` some are -0.0, which the compacted
    exchanges turn into +0.0 as the reference's do."""
    rng = np.random.default_rng(seed)
    masks = rng.random((P, P, V)) < density               # [src, dst, V]
    vals = rng.normal(size=(P, V)).astype(np.float32)
    vals[0, :4] = ([0.0, -0.0, -0.0, 0.0] if negative_zero
                   else [0.0, 1.0, 0.0, 2.0])
    masks[0, :, :4] = True
    maskq = rng.random((P, P, V, NQ)) < density
    valq = rng.normal(size=(P, V, NQ)).astype(np.float32)
    dest = rng.integers(-1, P, size=(P, V)).astype(np.int32)
    payload = rng.normal(size=(P, V, D)).astype(np.float32)
    payload[0, 0] = -0.0 if negative_zero else 0.0
    dest[0, 0] = 3
    return vals, masks, valq, maskq, payload, dest


def jax_vmap(fn, *args):
    """A reference collective run under vmap over P simulated ranks."""
    import jax
    import jax.numpy as jnp
    out = jax.vmap(fn, axis_name="part")(*(jnp.asarray(a) for a in args))
    return [np.array(o) for o in out]


def bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(bits(a), bits(b))


def stacked(fn, *args):
    """The port's local half on every source rank, stacked [src, dst, ...]
    and swapped to the received [dst, src, ...] layout."""
    outs = [fn(*(torch.from_numpy(np.ascontiguousarray(a[r]))
                 for a in args)) for r in range(P)]
    return [np.swapaxes(np.stack([o[i].numpy() for o in outs]), 0, 1)
            for i in range(len(outs[0]) - 1)], [int(o[-1]) for o in outs]


# ---------------------------------------------------------------------------
# Local halves against the reference's collectives (in process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", DENSITIES)
def test_filtered_send_is_the_reference_exchange(density):
    from repro.core import sparse_collectives as jsc
    vals, masks, *_ = seeded(density)
    recv, rmask = jax_vmap(lambda x, m: jsc.filtered_all_to_all(x, m, "part"),
                           vals, masks)
    outs = [sc.filtered_send(torch.from_numpy(vals[r]),
                             torch.from_numpy(masks[r])) for r in range(P)]
    send = np.swapaxes(np.stack([o[0].numpy() for o in outs]), 0, 1)
    mask8 = np.swapaxes(np.stack([o[1].numpy() for o in outs]), 0, 1)
    assert_bits(send, recv)
    assert mask8.dtype == np.int8
    np.testing.assert_array_equal(mask8 > 0, rmask)


@pytest.mark.parametrize("density", DENSITIES)
def test_masked_compacted_send_is_the_reference_exchange(density):
    """Values, source indices and padding (-1 with zero payload) equal the
    reference's received buffers bit for bit; -0.0 ships as +0.0, as the
    reference's add into zeros makes it."""
    from repro.core import sparse_collectives as jsc
    vals, masks, *_ = seeded(density)
    cap = sc.capacity_bucket(int(masks.sum(axis=2).max()))
    recv, ridx, ovf = jax_vmap(
        lambda x, m: jsc.masked_compacted_all_to_all(x, m, cap, "part"),
        vals, masks)
    (buf, idx), cmax = stacked(
        lambda x, m: sc.masked_compacted_send(x, m, cap), vals, masks)
    assert_bits(buf, recv)
    assert_bits(idx, ridx)
    assert np.all(buf[idx < 0].view(np.int32) == 0)       # +0.0 padding
    assert not np.any(np.signbit(buf) & (buf == 0))       # no -0.0 ships
    assert max(cmax) <= cap and not ovf.any()


@pytest.mark.parametrize("density", DENSITIES)
def test_masked_compacted_send_mq_is_the_reference_panel(density):
    from repro.core import sparse_collectives as jsc
    _, _, valq, maskq, _, _ = seeded(density)
    cap = sc.capacity_bucket(int(maskq.any(axis=3).sum(axis=2).max()))
    rv, rm, ridx, ovf = jax_vmap(
        lambda x, m: jsc.masked_compacted_all_to_all_mq(x, m, cap, "part"),
        valq, maskq)
    (bv, bm, idx), cmax = stacked(
        lambda x, m: sc.masked_compacted_send_mq(x, m, cap), valq, maskq)
    assert_bits(bv, rv)
    np.testing.assert_array_equal(bm > 0, rm)
    assert bm.dtype == np.int8
    assert_bits(idx, ridx)
    assert max(cmax) <= cap and not ovf.any()


@pytest.mark.parametrize("at", ["bucket", "at", "below"])
def test_compacted_send_padding_and_overflow(at):
    """The one-destination form at the bucketed capacity, at the true
    per-peer maximum and one below it: buffers equal the reference's, and
    the overflow predicate (the largest count over ranks above the
    capacity) equals the reference's pmax'd flag on every rank."""
    from repro.core import sparse_collectives as jsc
    *_, payload, dest = seeded(0.15)
    maxc = int(max((dest[s] == q).sum() for s in range(P) for q in range(P)))
    cap = {"bucket": sc.capacity_bucket(maxc), "at": maxc,
           "below": maxc - 1}[at]
    recv, ridx, ovf = jax_vmap(
        lambda x, d: jsc.compacted_all_to_all(x, d, cap, "part"),
        payload, dest)
    (buf, idx), cmax = stacked(
        lambda x, d: sc.compacted_send(x, d, cap, P), payload, dest)
    assert_bits(buf, recv)
    assert_bits(idx, ridx)
    assert np.all(buf[idx < 0] == 0)
    assert max(cmax) == maxc
    assert ovf.all() == (at == "below") and ovf.any() == (at == "below")


@pytest.mark.parametrize("density", DENSITIES)
def test_scatter_back_matches_the_reference(density):
    from repro.core import sparse_collectives as jsc
    import jax.numpy as jnp
    vals, masks, valq, maskq, *_ = seeded(density)
    cap = sc.capacity_bucket(int(masks.sum(axis=2).max()))
    recv, ridx, _ = jax_vmap(
        lambda x, m: jsc.masked_compacted_all_to_all(x, m, cap, "part"),
        vals, masks)
    capq = sc.capacity_bucket(int(maskq.any(axis=3).sum(axis=2).max()))
    rv, rm, rq, _ = jax_vmap(
        lambda x, m: jsc.masked_compacted_all_to_all_mq(x, m, capq, "part"),
        valq, maskq)
    for d in range(P):
        jm, jk = jsc.compacted_scatter_back(jnp.asarray(recv[d]),
                                            jnp.asarray(ridx[d]), V)
        m, k = sc.compacted_scatter_back(torch.from_numpy(recv[d]),
                                         torch.from_numpy(ridx[d]), V)
        assert_bits(m.numpy(), np.asarray(jm))
        assert_bits(k.numpy(), np.asarray(jk))
        jv, jmk = jsc.compacted_scatter_back_mq(
            jnp.asarray(rv[d]), jnp.asarray(rm[d]), jnp.asarray(rq[d]), V)
        pv, pmk = sc.compacted_scatter_back_mq(
            torch.from_numpy(rv[d]), torch.from_numpy(rm[d]),
            torch.from_numpy(rq[d]), V)
        assert_bits(pv.numpy(), np.asarray(jv))
        assert_bits(pmk.numpy(), np.asarray(jmk))


def test_negative_zero_ships_as_positive_zero_when_compacted():
    """A live -0.0 message crosses the dense slab as -0.0 and the
    compacted exchange as +0.0 — the reference's behaviour, whose scatter
    adds into zeros (its compacted == dense contract holds for every
    other value).  The paper's algorithms send no -0.0."""
    vals, masks, *_ = seeded(0.15)
    x, m = torch.from_numpy(vals[0]), torch.from_numpy(masks[0])
    send, _ = sc.filtered_send(x, m)
    buf, idx, _ = sc.masked_compacted_send(x, m, 64)
    msg, mask = sc.compacted_scatter_back(buf, idx, V)
    assert torch.equal(mask, m)
    neg = m & torch.signbit(send) & (send == 0)
    assert bool(neg.any())
    assert not bool(torch.signbit(msg[neg]).any())
    same = m & ~neg
    assert torch.equal(msg[same].view(torch.int32),
                       send[same].view(torch.int32))


def test_capacity_bucket_matches_the_reference():
    from repro.core import sparse_collectives as jsc
    for count in list(range(0, 70)) + [127, 128, 129, 1000, 2 ** 20 + 1]:
        for floor in (1, 8, 16):
            assert sc.capacity_bucket(count, floor) == \
                jsc.capacity_bucket(count, floor), (count, floor)


@pytest.mark.parametrize("shape,block", [((37,), 8), ((64, 5), 16),
                                         ((5, 3), 8), ((1000, 4), 128)])
def test_blocked_cumsum_matches_the_reference(shape, block):
    from repro.core import sparse_collectives as jsc
    import jax.numpy as jnp
    x = np.random.default_rng(3).integers(0, 3, size=shape).astype(np.int32)
    want = np.asarray(jsc.blocked_cumsum(jnp.asarray(x), block))
    got = sc.blocked_cumsum(torch.from_numpy(x), block).numpy()
    assert_bits(got, want)
    np.testing.assert_array_equal(got, np.cumsum(x, axis=0))


# ---------------------------------------------------------------------------
# The real collectives on 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_exchanges():
    inputs = seeded(0.2, negative_zero=False)
    return inputs, run_mesh(meshhelp.exchanges, P, args=inputs,
                            device="cpu", timeout_s=300)


def test_compacted_exchange_equals_the_dense_slab(mesh_exchanges):
    """On every rank: compacted + scatter-back == filtered_all_to_all, bit
    for bit, solo and panel; no overflow at the bucketed capacity."""
    _, ranks = mesh_exchanges
    for r in ranks:
        for a, b in zip(r["solo"], r["dense"]):
            assert_bits(a, b)
        for a, b in zip(r["panel"], r["dense_mq"]):
            assert_bits(a, b)
        assert r["solo_overflow"] is False and r["panel_overflow"] is False


def test_mesh_exchange_equals_the_reference(mesh_exchanges):
    """What each rank received over gloo equals the reference's received
    buffers for that rank."""
    from repro.core import sparse_collectives as jsc
    (vals, masks, valq, maskq, payload, dest), ranks = mesh_exchanges
    recv, rmask = jax_vmap(lambda x, m: jsc.filtered_all_to_all(x, m, "part"),
                           vals, masks)
    cap = sc.capacity_bucket(int(masks.sum(axis=2).max()))
    crecv, cidx, _ = jax_vmap(
        lambda x, m: jsc.masked_compacted_all_to_all(x, m, cap, "part"),
        vals, masks)
    for d, r in enumerate(ranks):
        assert_bits(r["dense"][0], recv[d])
        np.testing.assert_array_equal(r["dense"][1], rmask[d])
        assert_bits(r["recv_compacted"][0], crecv[d])
        assert_bits(r["recv_compacted"][1], cidx[d])


@pytest.mark.parametrize("at", ["bucket", "at", "below"])
def test_mesh_overflow_flag_is_pmaxed(mesh_exchanges, at):
    """The one-destination exchange over gloo: padding slots carry -1 and
    a zero payload, every live (source, destination) entry arrives once
    with its payload while the capacity holds, and the overflow flag is
    set on every rank exactly when the capacity is one below the
    per-peer maximum."""
    (_, _, _, _, payload, dest), ranks = mesh_exchanges
    flags = [r["one"][at][3] for r in ranks]
    assert flags == [at == "below"] * P
    for d, r in enumerate(ranks):
        cap, recv, ridx, _ = r["one"][at]
        assert recv.shape == (P, cap, D) and ridx.shape == (P, cap)
        assert np.all(recv[ridx < 0] == 0)
        if at == "below":
            continue
        for s in range(P):
            want = np.flatnonzero(dest[s] == d)
            got = ridx[s][ridx[s] >= 0]
            assert sorted(got.tolist()) == want.tolist()
            for v in want:
                slot = np.flatnonzero(ridx[s] == v)[0]
                np.testing.assert_array_equal(recv[s, slot],
                                              payload[s, v] + 0.0)
