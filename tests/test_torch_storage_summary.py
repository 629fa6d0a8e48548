"""``storage_summary`` (the Fig. 5 storage totals) against the reference's
on the same graphs: the port's builders and the reference's, and the
reference's structures carried across through ``repro_torch.interop``,
give the same dict key for key (same keys, same values, same types)."""
import numpy as np
import pytest

from repro.core import build_dist_graph as j_build_dist_graph
from repro.core import build_formats as j_build_formats
from repro.core import make_spec as j_make_spec
from repro.core import storage_summary as j_storage_summary
from repro.data import graphs as j_graphs

from repro_torch import interop
from repro_torch.core import (
    build_dist_graph, build_formats, make_spec, storage_summary,
)
from repro_torch.data import graphs

from torchhelp import jax_fields

CASES = [
    ("rmat_graph", (7, 8), dict(seed=3, weighted=True), dict(
        num_partitions=4, batch_size=16)),
    ("rmat_graph", (9, 16), dict(seed=42, weighted=True), dict(
        num_partitions=4, batch_size=64)),
    ("rmat_graph", (8, 4), dict(seed=1, weighted=False), dict(
        num_partitions=2, batch_size=32)),
    ("uniform_graph", (300, 2000), dict(seed=2, weighted=True), dict(
        num_partitions=3, batch_size=20)),
]


def assert_same_summary(ref: dict, port: dict):
    assert list(port) == list(ref)
    for k, v in ref.items():
        assert type(port[k]) is type(v), (k, type(port[k]), type(v))
        assert port[k] == v, (k, port[k], v)


@pytest.mark.parametrize("gen,pos,kw,spec", CASES)
def test_storage_summary_matches_reference(gen, pos, kw, spec):
    jg = getattr(j_graphs, gen)(*pos, **kw)
    jdg = j_build_dist_graph(jg, j_make_spec(jg, **spec))
    jfm = j_build_formats(jdg)
    ref = j_storage_summary(jfm, jdg)

    g = getattr(graphs, gen)(*pos, **kw)
    dg = build_dist_graph(g, make_spec(g, **spec))
    assert_same_summary(ref, storage_summary(build_formats(dg), dg))

    carried = storage_summary(
        interop.formats_from_arrays(jax_fields(jfm), device="cpu"),
        interop.dist_graph_from_arrays(jax_fields(jdg), device="cpu"))
    assert_same_summary(ref, carried)


def test_adaptive_store_smaller_than_raw():
    """The reference test's claim (tests/test_system.py) on the port."""
    g = graphs.rmat_graph(9, 16, seed=42, weighted=True)
    dg = build_dist_graph(g, make_spec(g, num_partitions=4, batch_size=64))
    s = storage_summary(build_formats(dg), dg)
    assert s["adaptive_best_read_bytes"] < s["raw_pair_bytes"]
    assert s["compressed_over_raw"] < 1.0
    assert 0.0 <= s["csr_chunk_fraction"] <= 1.0
    assert np.isfinite(s["adaptive_over_csr_all"])
