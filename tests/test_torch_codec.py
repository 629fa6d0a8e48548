"""The port's byte models and codecs against the reference's: varint and
delta codecs byte-identical, the wire pricing and the mask gap-stream
sizes equal on both the host (numpy) and the tensor (torch vs jnp) paths,
and the small utilities equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as j_utils
from repro.core import codec as j_codec
from repro.core import exchange as j_exchange

from repro_torch import utils
from repro_torch.core import codec, exchange


def _values(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, 1 << 7, 50).astype(np.uint64),
        rng.integers(0, 1 << 21, 50).astype(np.uint64),
        rng.integers(0, 1 << 62, 50, dtype=np.int64).astype(np.uint64),
        np.array([0, 127, 128, (1 << 64) - 1], np.uint64)])


@pytest.mark.parametrize("seed", [0, 1])
def test_varint_byte_identical(seed):
    v = _values(seed)
    enc = codec.varint_encode(v)
    assert np.array_equal(enc, j_codec.varint_encode(v))
    assert np.array_equal(codec.varint_sizes(v), j_codec.varint_sizes(v))
    assert np.array_equal(codec.varint_decode(enc, v.size), v)
    with pytest.raises(ValueError):
        codec.varint_decode(enc[:-1], v.size)


def test_delta_codecs_match_reference():
    src = np.array([0, 3, 4, 9, 20])
    idx = np.array([0, 2, 5, 6, 11])
    pv = codec.pair_delta_values(src, idx)
    assert np.array_equal(pv, j_codec.pair_delta_values(src, idx))
    for a, b in zip(codec.pair_delta_restore(pv),
                    j_codec.pair_delta_restore(pv)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    dst = np.array([40, 41, 45, 40, 44, 47, 43])
    starts, runs = np.array([0, 3, 5]), np.array([3, 2, 2])
    dv = codec.dst_delta_values(dst, starts, 40)
    assert np.array_equal(dv, j_codec.dst_delta_values(dst, starts, 40))
    assert np.array_equal(codec.dst_delta_restore(dv, starts, runs, 40), dst)


@pytest.mark.parametrize("density", [0.02, 0.5, 1.0])
def test_mask_gap_bytes_both_paths(density):
    rng = np.random.default_rng(7)
    mask = rng.random((3, 4, 700)) < density
    np.testing.assert_array_equal(codec.mask_gap_bytes(mask),
                                  j_codec.mask_gap_bytes(mask))
    got = codec.mask_gap_bytes(torch.from_numpy(mask), xp=torch)
    want = j_codec.mask_gap_bytes(jnp.asarray(mask), xp=jnp)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gaps = rng.integers(0, 1 << 30, 200).astype(np.int32)
    np.testing.assert_array_equal(
        codec.varint_sizes(torch.from_numpy(gaps), xp=torch).numpy(),
        np.asarray(j_codec.varint_sizes(jnp.asarray(gaps), xp=jnp)))


def test_wire_pricing_matches_reference():
    rng = np.random.default_rng(3)
    count = rng.integers(0, 400, (4, 4)).astype(np.float32)
    count[0, 1] = 0
    gap = rng.integers(1, 300, (4, 4)).astype(np.float32)
    uni = rng.random((4, 4)) < 0.5
    for kw in ({}, {"gap_bytes": gap}, {"gap_bytes": gap, "uniform": uni}):
        np.testing.assert_array_equal(
            exchange.batch_wire_bytes(count, 300, 4, **kw),
            j_exchange.batch_wire_bytes(count, 300, 4, **kw))
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        np.testing.assert_array_equal(
            exchange.batch_wire_bytes(torch.from_numpy(count), 300, 4,
                                      xp=torch, **tkw).numpy(),
            np.asarray(j_exchange.batch_wire_bytes(
                jnp.asarray(count), 300, 4, xp=jnp, **jkw)))
    for c, g, u in [(1, 2, True), (300, 500, False), (50, 60, True),
                    (0, 1, False)]:
        for gb in (None, g):
            assert exchange.choose_wire_format(c, 300, 4, gb, u) == \
                j_exchange.choose_wire_format(c, 300, 4, gb, u)


def test_utils_match_reference(tmp_path):
    data = np.arange(100, dtype=np.int32)
    assert utils.crc32(data) == j_utils.crc32(data)
    assert utils.crc32(b"abc", 7) == j_utils.crc32(b"abc", 7)
    obj = {"b": [1, 2], "a": {"x": 1.5}}
    assert utils.json_crc(obj) == j_utils.json_crc(obj)
    bits = np.random.default_rng(0).random((3, 13)) < 0.5
    packed = utils.pack_bools(bits)
    assert packed == j_utils.pack_bools(bits)
    assert np.array_equal(utils.unpack_bools(packed, bits.shape), bits)
    assert utils.ceil_div(7, 2) == j_utils.ceil_div(7, 2) == 4
    path = tmp_path / "m.json"
    utils.atomic_write_json(str(path), obj)
    assert path.read_text() == '{"b": [1, 2], "a": {"x": 1.5}}'
