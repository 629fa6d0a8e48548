"""The port's host builders against the reference's: the same graph gives
bit-equal DistGraph, ChunkFormats and BlockTiles arrays, the interop path
carries them across unchanged, and an edge file saved by either package
loads in the other."""
import dataclasses

import numpy as np
import pytest

from repro.core import build_block_tiles as j_build_block_tiles
from repro.core import build_dist_graph as j_build_dist_graph
from repro.core import build_formats as j_build_formats
from repro.core import make_spec as j_make_spec
from repro.data import graphs as j_graphs

from repro_torch import interop
from repro_torch.core import (
    build_block_tiles, build_dist_graph, build_formats, make_spec,
)
from repro_torch.data import graphs

from torchhelp import (
    GRAPH, SPEC, assert_same_fields, jax_fields, port_fields,
)


@pytest.fixture(scope="module")
def both():
    jg = j_graphs.rmat_graph(GRAPH["scale"], GRAPH["edge_factor"],
                             seed=GRAPH["seed"], weighted=True)
    g = graphs.rmat_graph(GRAPH["scale"], GRAPH["edge_factor"],
                          seed=GRAPH["seed"], weighted=True)
    jspec = j_make_spec(jg, **SPEC)
    spec = make_spec(g, **SPEC)
    jdg = j_build_dist_graph(jg, jspec)
    dg = build_dist_graph(g, spec)
    return jg, g, jspec, spec, jdg, dg


@pytest.mark.parametrize("gen,args", [
    ("rmat_graph", ((7, 8), dict(seed=3, weighted=True))),
    ("rmat_graph", ((6, 4), dict(seed=1, dedup=True))),
    ("uniform_graph", ((50, 300), dict(seed=2, weighted=True))),
    ("chain_graph", ((20,), dict(weighted=True))),
    ("star_graph", ((20,), {})),
])
def test_generators_bit_equal(gen, args):
    pos, kw = args
    a = getattr(j_graphs, gen)(*pos, **kw)
    b = getattr(graphs, gen)(*pos, **kw)
    assert a.num_vertices == b.num_vertices
    for f in ("src", "dst", "data"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_spec_equal(both):
    _, _, jspec, spec, _, _ = both
    assert dataclasses.asdict(jspec) == dataclasses.asdict(spec)


def test_dist_graph_equal(both):
    *_, jdg, dg = both
    assert_same_fields(jax_fields(jdg), port_fields(dg))


def test_formats_equal(both):
    *_, jdg, dg = both
    assert_same_fields(jax_fields(j_build_formats(jdg)),
                       port_fields(build_formats(dg)))


@pytest.mark.parametrize("tile", [8, 16])
def test_block_tiles_equal(both, tile):
    *_, jdg, dg = both
    jbt, jhost = j_build_block_tiles(jdg, tile=tile)
    bt, host = build_block_tiles(dg, tile=tile)
    assert_same_fields(jax_fields(jbt), port_fields(bt))
    assert_same_fields(dataclasses.asdict(jhost), dataclasses.asdict(host))


def test_interop_round_trip(both):
    """Structures carried across through interop equal the port's own."""
    *_, jdg, dg = both
    jfm = j_build_formats(jdg)
    jbt, _ = j_build_block_tiles(jdg, tile=8)
    dg2 = interop.dist_graph_from_arrays(jax_fields(jdg), device="cpu")
    fm2 = interop.formats_from_arrays(jax_fields(jfm), device="cpu")
    bt2 = interop.block_tiles_from_arrays(jax_fields(jbt), device="cpu")
    assert_same_fields(port_fields(dg), port_fields(dg2))
    assert_same_fields(port_fields(build_formats(dg)), port_fields(fm2))
    assert_same_fields(port_fields(build_block_tiles(dg)[0]),
                       port_fields(bt2))
    st = interop.state_from_arrays(
        {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}, device="cpu")
    assert st["x"].dtype.is_floating_point and st["x"].shape == (2, 3)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_edge_file_cross_load(tmp_path, both, writer):
    jg, g, *_ = both
    path = str(tmp_path / "g.npz")
    save, load = ((j_graphs.save_edge_list, graphs.load_edge_list)
                  if writer == "jax" else
                  (graphs.save_edge_list, j_graphs.load_edge_list))
    crc = save(jg if writer == "jax" else g, path)
    back = load(path, expect_crc=crc)
    assert back.num_vertices == g.num_vertices
    for f in ("src", "dst", "data"):
        assert np.array_equal(getattr(back, f), getattr(g, f)), f
    with open(path, "r+b") as fh:
        fh.seek(40)
        byte = fh.read(1)
        fh.seek(40)
        fh.write(bytes([byte[0] ^ 0xFF]))
    err = (graphs.IntegrityError if writer == "jax"
           else j_graphs.IntegrityError)
    with pytest.raises(err):
        load(path, expect_crc=crc)
