"""The port's runtime layer — elastic re-planning and straggler deferral —
mirroring ``tests/test_runtime.py``, with ``deferred_merge`` and
``merge_deferred_entry`` held to the reference's, and the deferral
fixpoint shown on the port's LOCAL engine."""
import numpy as np
import pytest
import torch

from repro_torch.runtime.elastic import (
    plan_elastic_mesh, plan_worker_recovery,
)
from repro_torch.runtime.straggler import (
    DeferralPolicy, deferred_merge, merge_deferred_entry,
    plan_backup_shards, simulate_round, simulate_training_with_stragglers,
)


def test_elastic_plan_shrinks_data_axis():
    p = plan_elastic_mesh(512, model=16, pods=2)
    assert p.shape == (2, 16, 16) and p.idle_devices == 0
    p = plan_elastic_mesh(448, model=16, pods=2)
    assert p.shape == (2, 14, 16) and p.idle_devices == 0
    p = plan_elastic_mesh(447, model=16, pods=2)
    assert p.shape == (2, 13, 16)
    assert p.idle_devices == 447 - 2 * 13 * 16
    assert any("idle" in n for n in p.notes)


def test_elastic_plan_never_breaks_model_axis():
    assert plan_elastic_mesh(100, model=16).shape == (6, 16)
    with pytest.raises(ValueError):
        plan_elastic_mesh(10, model=16)


def test_elastic_plan_pod_collapse():
    p = plan_elastic_mesh(40, model=16, pods=4)
    assert p.shape == (1, 2, 16)
    assert any("collapsed" in n for n in p.notes)


@pytest.mark.parametrize("available,model,pods",
                         [(512, 16, 2), (447, 16, 2), (100, 16, None),
                          (40, 16, 4), (64, 8, None)])
def test_elastic_plan_is_the_references(available, model, pods):
    from repro.runtime.elastic import plan_elastic_mesh as ref
    assert plan_elastic_mesh(available, model=model, pods=pods).__dict__ \
        == ref(available, model=model, pods=pods).__dict__


def test_plan_worker_recovery_adopts_orphans():
    prev = [0, 1, 2, 0, 1, 2]
    got = plan_worker_recovery([0, 2], 6, prev)
    assert got == [0, 0, 2, 0, 2, 2]
    for w in range(6):
        if prev[w] != 1:
            assert got[w] == prev[w]


def test_plan_worker_recovery_balances_and_tiebreaks():
    assert plan_worker_recovery([3, 1], 4, [0, 0, 0, 0]) == [1, 3, 1, 3]
    assert (plan_worker_recovery([3, 1], 4, [0, 0, 0, 0])
            == plan_worker_recovery([1, 3], 4, [0, 0, 0, 0]))


def test_plan_worker_recovery_empty_live_set():
    with pytest.raises(ValueError, match="live"):
        plan_worker_recovery([], 2, [0, 1])


def test_plan_worker_recovery_is_the_references():
    from repro.runtime.elastic import plan_worker_recovery as ref
    rng = np.random.default_rng(4)
    for _ in range(50):
        world = int(rng.integers(2, 6))
        w = int(rng.integers(world, 10))
        prev = [int(x) for x in rng.integers(0, world, w)]
        live = sorted(set(int(x) for x in rng.integers(0, world, world)))
        assert plan_worker_recovery(live, w, prev) == ref(live, w, prev)


def test_simulate_round_deadline():
    lat = np.array([1.0, 1.1, 0.9, 1.0, 10.0])
    _, arrived, m_def, m_all = simulate_round(lat, DeferralPolicy())
    assert not arrived[-1] and arrived[:4].all()
    assert m_def < m_all


def test_simulate_round_min_peers_floor():
    lat = np.array([1.0, 5.0, 5.0, 5.0])
    pol = DeferralPolicy(deadline_factor=0.1, min_peers=0.75)
    _, arrived, _, _ = simulate_round(lat, pol)
    assert arrived.sum() >= int(np.ceil(0.75 * 4))


def test_simulate_round_all_on_time():
    _, arrived, m_def, m_all = simulate_round(np.full(6, 2.0),
                                              DeferralPolicy())
    assert arrived.all() and m_def >= m_all * 0.5


def test_backup_shards_pick_slowest():
    assert set(plan_backup_shards(np.array([1.0, 9.0, 2.0, 8.0]), 2)) \
        == {1, 3}


def test_straggler_simulation_shows_speedup():
    out = simulate_training_with_stragglers(np.ones(16), DeferralPolicy(),
                                            rounds=200)
    assert out["mean_speedup"] > 1.0
    assert 0.0 < out["deferral_rate"] < 0.5


def test_deferred_merge_splits_by_peer_like_the_reference():
    from repro.runtime.straggler import deferred_merge as ref
    rng = np.random.default_rng(0)
    recv_mask = rng.random((4, 8)) < 0.5
    recv_msg = rng.random((4, 8)).astype(np.float32)
    arrived = np.array([True, False, True, False])
    out = deferred_merge(torch.from_numpy(recv_msg),
                         torch.from_numpy(recv_mask),
                         torch.from_numpy(arrived))
    now_msg, now_mask, def_msg, def_mask = (o.numpy() for o in out)
    np.testing.assert_array_equal(now_mask[~arrived], False)
    np.testing.assert_array_equal(def_mask[arrived], False)
    np.testing.assert_array_equal(now_mask | def_mask, recv_mask)
    assert not np.any(now_mask & def_mask)
    np.testing.assert_array_equal(now_msg[~now_mask], 0)
    np.testing.assert_array_equal(def_msg[~def_mask], 0)
    for mine, theirs in zip((now_msg, now_mask, def_msg, def_mask),
                            ref(recv_msg, recv_mask, arrived)):
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    # numpy inputs are taken too
    for a, b in zip(deferred_merge(recv_msg, recv_mask, arrived), out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("op", [np.minimum, np.maximum])
def test_deferred_merge_monoid_fixpoint(op):
    rng = np.random.default_rng(1)
    recv_mask = rng.random((4, 8)) < 0.6
    recv_msg = rng.random((4, 8)).astype(np.float32)
    arrived = np.array([True, True, False, False])
    now_msg, now_mask, def_msg, def_mask = (
        o.numpy() for o in deferred_merge(recv_msg, recv_mask, arrived))
    ident = np.float32(np.inf) if op is np.minimum else np.float32(-np.inf)
    all_at_once = op.reduce(np.where(recv_mask, recv_msg, ident), axis=0)
    two_rounds = op(op.reduce(np.where(now_mask, now_msg, ident), axis=0),
                    op.reduce(np.where(def_mask, def_msg, ident), axis=0))
    np.testing.assert_array_equal(all_at_once, two_rounds)


@pytest.mark.parametrize("op", [np.minimum, np.maximum])
def test_merge_deferred_entry_monoid(op):
    from repro.runtime.straggler import merge_deferred_entry as ref
    mask_now = np.array([True, True, False, False])
    vals_now = np.array([2.0, 5.0, 99.0, 99.0], np.float32)  # 99 = garbage
    mask_late = np.array([True, False, True, False])
    vals_late = np.array([3.0, 88.0, 7.0, 88.0], np.float32)
    mask, vals = merge_deferred_entry(op, mask_now, vals_now, mask_late,
                                      vals_late)
    np.testing.assert_array_equal(mask, [True, True, True, False])
    both = float(op(np.float32(2.0), np.float32(3.0)))
    np.testing.assert_array_equal(vals, [both, 5.0, 7.0, 0.0])
    assert vals.dtype == np.float32
    rmask, rvals = ref(op, mask_now, vals_now, mask_late, vals_late)
    np.testing.assert_array_equal(mask, rmask)
    np.testing.assert_array_equal(vals, rvals)
    mask2, vals2 = merge_deferred_entry(op, mask, vals, mask_late,
                                        vals_late)
    np.testing.assert_array_equal(mask2, mask)
    np.testing.assert_array_equal(vals2, vals)


def test_merge_deferred_entry_one_sided():
    empty = np.zeros(4, bool)
    garbage = np.full(4, 13.0, np.float32)
    mask_late = np.array([False, True, False, True])
    vals_late = np.array([0.0, 4.0, 0.0, 6.0], np.float32)
    for args in ((empty, garbage, mask_late, vals_late),
                 (mask_late, vals_late, empty, garbage)):
        mask, vals = merge_deferred_entry(np.minimum, *args)
        np.testing.assert_array_equal(mask, mask_late)
        np.testing.assert_array_equal(vals, [0.0, 4.0, 0.0, 6.0])


def test_deferral_preserves_monoid_fixpoint():
    """Deferring one partition's newly active vertices by a round does not
    change BFS on the port's LOCAL engine (MIN is idempotent): the levels
    equal those of BFS without deferral."""
    from repro_torch.core import Engine, build_dist_graph, build_formats
    from repro_torch.core import make_spec
    from repro_torch.core import algorithms as alg
    from repro_torch.core.partition import gather_vertex_values
    from repro_torch.data.graphs import rmat_graph
    g = rmat_graph(7, 8, seed=2, weighted=True)
    spec = make_spec(g, num_partitions=4, batch_size=8)
    dg = build_dist_graph(g, spec)
    eng = Engine(dg, build_formats(dg), device="cpu")
    lv_ref, _ = alg.bfs(eng, 0)
    gid = eng.global_id
    inf = float(np.finfo(np.float32).max)
    state = eng.init_state(level=torch.where(gid == 0, 0.0, inf))
    active = (gid == 0) & eng.graph.vertex_valid
    deferred = None
    for _ in range(200):
        state, active, upd, _ = eng.process_edges(
            state, active=active, **alg.bfs_callbacks())
        held = torch.zeros_like(active)
        held[2] = active[2]
        active = active & ~held
        if deferred is not None:
            active = active | deferred
        deferred = held
        if float(upd) == 0 and not bool(active.any()):
            break
    lv = gather_vertex_values(spec, state["level"])
    np.testing.assert_array_equal(lv, lv_ref)
