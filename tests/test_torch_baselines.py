"""The Chaos- and GridGraph-like baseline engines (``repro_torch.core.
baselines``) against the reference's (``repro.core.baselines``) on the same
R-MAT graphs: BFS and SSSP values bit-equal (MIN folds are order-free),
PageRank within 1e-5, iteration counts and every counter equal; Grid's edge
order and block pointers equal to the reference's lexsort.  The ``cuda``
case holds the engines on the card against the CPU (``pytest -m cuda``
there; the module imports jax only inside the tests that compare with it).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import baselines as bl
from repro_torch.data.graphs import rmat_graph

GRAPHS = {"s8": (8, 8, 3), "s10": (10, 8, 5)}
PR_TOL = 1e-5


def graph(name):
    scale, ef, seed = GRAPHS[name]
    return rmat_graph(scale, ef, seed=seed, weighted=True)


def same_counters(ref, port):
    assert dataclasses.asdict(ref) == port.as_dict()


def source_of(g):
    return int(np.argmax(g.out_degrees()))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("num_nodes", [1, 4])
def test_chaos_matches_reference(name, num_nodes):
    from repro.core.baselines import ChaosLikeEngine
    g = graph(name)
    src = source_of(g)
    ref = ChaosLikeEngine(g, num_nodes)
    port = bl.ChaosLikeEngine(g, num_nodes, device="cpu")
    r_ref, c_ref = ref.run_pagerank(5)
    r_port, c_port = port.run_pagerank(5)
    np.testing.assert_allclose(r_port, r_ref, rtol=0, atol=PR_TOL)
    same_counters(c_ref, c_port)
    for run in ("run_bfs", "run_sssp"):
        v_ref, c_ref, it_ref = getattr(ref, run)(src)
        v_port, c_port, it_port = getattr(port, run)(src)
        np.testing.assert_array_equal(v_port, v_ref)
        assert it_port == it_ref, run
        same_counters(c_ref, c_port)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("grid", [4, 8])
@pytest.mark.parametrize("budget", ["unbounded", "thrash"])
def test_grid_matches_reference(name, grid, budget):
    from repro.core.baselines import GridLikeEngine
    g = graph(name)
    n = g.num_vertices
    # below two vertex windows: every active block re-reads both
    mem = (float("inf") if budget == "unbounded"
           else 2 * (-(-n // grid)) * 4 - 1)
    ref = GridLikeEngine(g, grid, memory_budget=mem)
    port = bl.GridLikeEngine(g, grid, memory_budget=mem, device="cpu")
    np.testing.assert_array_equal(port.src.numpy(), np.asarray(ref.src))
    np.testing.assert_array_equal(port.dst.numpy(), np.asarray(ref.dst))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(port.block_ptr, ref.block_ptr)
    r_ref, c_ref = ref.run_pagerank(5)
    r_port, c_port = port.run_pagerank(5)
    np.testing.assert_allclose(r_port, r_ref, rtol=0, atol=PR_TOL)
    same_counters(c_ref, c_port)
    v_ref, c_ref, it_ref = ref.run_sssp(source_of(g))
    v_port, c_port, it_port = port.run_sssp(source_of(g))
    np.testing.assert_array_equal(v_port, v_ref)
    assert it_port == it_ref
    same_counters(c_ref, c_port)


def test_min_fold_keeps_inf_for_a_vertex_without_in_edges():
    """A destination with no in-edge keeps the fold's identity +inf (the
    reference's empty segment_min); one whose in-edges are all inactive
    gets finfo.max; has is False for both."""
    msg = torch.tensor([5.0, 7.0, 3.0])
    act = torch.tensor([True, False, False])
    dst = torch.tensor([0, 1, 1])
    agg, has = bl._fold(msg, act, dst, 3, "min")
    assert agg.tolist() == [5.0, bl.F32_MAX, float("inf")]
    assert has.tolist() == [True, False, False]


def test_chaos_counts_are_exact_integers():
    """Counts add as exact integers (the reference sums float32 per step,
    exact at these sizes): messages = active out-edges summed over steps."""
    g = graph("s8")
    port = bl.ChaosLikeEngine(g, 4, device="cpu")
    _, c = port.run_pagerank(3)
    assert c.messages_sent == 3 * g.num_edges
    assert c.edge_read_bytes == 3 * g.num_edges * bl.EDGE_BYTES
    cross = (np.arange(g.num_edges) * 4 // g.num_edges
             != np.asarray(g.dst) % 4)
    assert c.net_bytes == 3 * int(cross.sum()) * bl.UPDATE_BYTES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card run of the baselines")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_engines_match_cpu(cuda_device):
    g = graph("s10")
    src = source_of(g)
    for make in (lambda d: bl.ChaosLikeEngine(g, 4, device=d),
                 lambda d: bl.GridLikeEngine(g, 8, device=d)):
        cpu, card = make("cpu"), make(cuda_device)
        r_cpu, c_cpu = cpu.run_pagerank(5)
        r_card, c_card = card.run_pagerank(5)
        np.testing.assert_allclose(r_card, r_cpu, rtol=0, atol=PR_TOL)
        assert c_card.as_dict() == c_cpu.as_dict()
        v_cpu, c_cpu, it_cpu = cpu.run_sssp(src)
        v_card, c_card, it_card = card.run_sssp(src)
        np.testing.assert_array_equal(v_card, v_cpu)
        assert (it_card, c_card.as_dict()) == (it_cpu, c_cpu.as_dict())


def test_reference_float32_counts_round_past_2_24():
    """The reference's Chaos counts (``jnp.sum(act_e, dtype=float32)`` in
    its jitted step, ``baselines.py:102``) round once a step has more than
    2^24 active edges; the port's integer count does not.  Masks of 2^24 +
    1 and 2^24 + 3 set edges stand in for one step at R-MAT scale 21
    (33,554,432 edges)."""
    import jax
    import jax.numpy as jnp
    count32 = jax.jit(lambda a: jnp.sum(a, dtype=jnp.float32))
    for n, rounded in ((2 ** 24 + 1, 2 ** 24), (2 ** 24 + 3, 2 ** 24 + 4)):
        mask = np.ones(n, bool)
        assert int(count32(jnp.asarray(mask))) == rounded
        assert int(torch.count_nonzero(torch.from_numpy(mask))) == n
