"""Rank jobs for the mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_sparse_collectives.py``): module-level functions that
:func:`repro_torch.core.mesh.run_mesh` runs on every rank.  They import
only the port (a spawned rank need not load jax), build the port's
structures from the numpy fields the test process took from the JAX
package, and return plain Python / numpy results."""
import time

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import (
    Engine, EngineConfig, GraphServeSession, sparse_collectives as sc,
)
from repro_torch.core import algorithms as alg

ALGOS = ("pagerank", "bfs", "sssp", "wcc")
PR_ITERS = 5
PPR_ITERS = 3


def structures(fields, device="cpu"):
    return (interop.dist_graph_from_arrays(fields["dg"], device=device),
            interop.formats_from_arrays(fields["fm"], device=device))


def _stats(stats):
    return dict(iterations=stats.iterations, counters=dict(stats.counters),
                per_iter_return=[np.asarray(r, np.float64)
                                 for r in stats.per_iter_return])


def run_algo(algo, eng, rev, src, algorithms=alg):
    """One of the four algorithms, from the port's ``algorithms`` module
    or the reference's."""
    if algo == "pagerank":
        return algorithms.pagerank(eng, PR_ITERS)
    if algo == "bfs":
        return algorithms.bfs(eng, src)
    if algo == "sssp":
        return algorithms.sssp(eng, src)
    return algorithms.wcc(eng, rev)


def _error(fn):
    try:
        fn()
    except Exception as exc:                  # noqa: BLE001 — reported
        return type(exc).__name__, str(exc)
    return None


def suite(mesh, fwd, rev, mismatch, src, sources):
    """Every mesh case of ``test_torch_mesh.py`` in one job: the four
    algorithms on both backends with the physical exchange auto (on) and
    off, compression off, multi-query (BFS, PPR, a serving session), the
    guards, and where this rank's arrays live."""
    dg, fm = structures(fwd)
    dgr, fmr = structures(rev)
    out = {"rank": mesh.rank, "runs": {}}

    def engines(**kw):
        cfg = EngineConfig(**kw)
        return (Engine(dg, fm, cfg, mesh=mesh),
                Engine(dgr, fmr, cfg, mesh=mesh))

    for backend in ("segment", "block_csr"):
        for physical in (None, False):
            eng, eng_rev = engines(compute_backend=backend,
                                   physical_sparse_exchange=physical)
            for algo in ALGOS:
                vals, stats = run_algo(algo, eng, eng_rev, src)
                out["runs"][(algo, backend, physical)] = (vals,
                                                          _stats(stats))
            if backend == "block_csr" and physical is None:
                out["rows"] = {
                    "garrs": {k: tuple(v.shape)
                              for k, v in eng._garrs.items()},
                    "garrs_device": sorted({v.device.type
                                            for v in eng._garrs.values()}),
                    "tiles": tuple(eng._block.tiles_cnt.shape),
                    "values": {k: tuple(v.shape) for vals in
                               eng._block_vals_cache.values()
                               for k, v in vals.items()},
                    "graph_rows": int(eng.graph.edge_data.shape[0])}
                out["log"] = list(eng.mesh_log)
    for algo in ("pagerank", "bfs"):
        eng, eng_rev = engines(compression=False)
        vals, stats = run_algo(algo, eng, eng_rev, src)
        out["runs"][(algo, "nocomp", None)] = (vals, _stats(stats))

    nq = len(sources)
    for physical in (None, False):
        eng = Engine(dg, fm, EngineConfig(num_queries=nq,
                                          physical_sparse_exchange=physical),
                     mesh=mesh)
        lv, st = alg.multi_bfs(eng, sources)
        out["runs"][("multi_bfs", "segment", physical)] = (lv, _stats(st))
    eng = Engine(dg, fm, EngineConfig(num_queries=nq), mesh=mesh)
    pr, st = alg.personalized_pagerank(eng, sources, PPR_ITERS)
    out["runs"][("ppr", "segment", None)] = (pr, _stats(st))

    # a session of 2 slots over the 3 sources (the third joins once a slot
    # frees)
    eng = Engine(dg, fm, EngineConfig(num_queries=2), mesh=mesh)
    sess = GraphServeSession(eng)
    for s in sources:
        sess.submit(s)
    done = sess.drain()
    out["session"] = dict(
        steps=sess.steps, counters=dict(sess.counters),
        results=[(r.source, r.levels, r.run_iters, r.wait_iters)
                 for r in done])

    out["errors"] = {
        "ooc": _error(lambda: Engine(dg, fm, EngineConfig(executor="ooc"),
                                     mesh=mesh)),
        "dist_ooc": _error(lambda: Engine(
            dg, fm, EngineConfig(executor="dist_ooc"), mesh=mesh)),
        "size": _error(lambda: Engine(*structures(mismatch), mesh=mesh)),
        "mq_block": _error(lambda: alg.multi_bfs(Engine(
            dg, fm, EngineConfig(num_queries=nq, compute_backend="block_csr"),
            mesh=mesh), sources)),
    }
    return out


def exchanges(mesh, vals, masks, valq, maskq, payload, dest):
    """The collectives on this rank's slice of seeded inputs: the dense
    slab, the compacted exchange plus scatter-back (solo and panel), and
    the one-destination compacted exchange at its bucketed capacity, at
    the true maximum and one below it."""
    r = mesh.rank
    v = vals.shape[1]
    x, m = torch.from_numpy(vals[r]), torch.from_numpy(masks[r])
    rd, md = sc.filtered_all_to_all(x, m, mesh)
    cap = sc.capacity_bucket(int(masks.sum(axis=2).max()))
    rc, ri, ovf = sc.masked_compacted_all_to_all(x, m, cap, mesh)
    rs, ms = sc.compacted_scatter_back(rc, ri, v)
    xq, mq = torch.from_numpy(valq[r]), torch.from_numpy(maskq[r])
    rdq = mesh.all_to_all(torch.where(mq, xq[None], 0.0))
    mdq = mesh.all_to_all(mq.to(torch.int8)) > 0
    capq = sc.capacity_bucket(int(maskq.any(axis=3).sum(axis=2).max()))
    rv, rm, rix, ovfq = sc.masked_compacted_all_to_all_mq(xq, mq, capq, mesh)
    rsq, msq = sc.compacted_scatter_back_mq(rv, rm, rix, v)
    p = mesh.size
    pay, dst = torch.from_numpy(payload[r]), torch.from_numpy(dest[r])
    maxc = int(max((dest[s] == q).sum() for s in range(p) for q in range(p)))
    one = {}
    for name, c in (("bucket", sc.capacity_bucket(maxc)), ("at", maxc),
                    ("below", maxc - 1)):
        recv, ridx, ov = sc.compacted_all_to_all(pay, dst, c, mesh)
        one[name] = (c, recv.numpy(), ridx.numpy(), ov)
    return dict(dense=(rd.numpy(), md.numpy()), solo=(rs.numpy(), ms.numpy()),
                solo_overflow=ovf, recv_compacted=(rc.numpy(), ri.numpy()),
                dense_mq=(rdq.numpy(), mdq.numpy()),
                panel=(rsq.numpy(), msq.numpy()), panel_overflow=ovfq,
                one=one)


def fails(mesh):
    """Rank 1 raises; the others wait in a collective that never
    completes."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()
    return mesh.rank


def overruns(mesh):
    """Rank 0 returns at once; rank 1 outlives any deadline."""
    if mesh.rank == 1:
        time.sleep(3600)
    return mesh.rank


def on_card(mesh, fields, src):
    """BFS and PageRank under block_csr on this rank's device, with the
    combine's launches per algorithm."""
    from repro_torch.kernels import csr_spmv
    dg, fm = structures(fields)
    eng = Engine(dg, fm, EngineConfig(compute_backend="block_csr"),
                 mesh=mesh)
    out = {"device": eng.device.type}
    for algo in ("pagerank", "bfs"):
        csr_spmv.block_csr_combine.launches = 0
        vals, stats = run_algo(algo, eng, None, src)
        out[algo] = (vals, _stats(stats),
                     csr_spmv.block_csr_combine.launches)
    return out
