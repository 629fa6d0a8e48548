"""Concurrent graph-query serving on the PyTorch port: Poisson arrivals through a Q-slot
multi-source BFS server (DESIGN.md §11), the graph analogue of the batched
LM serving example (examples/serve_lm_torch.py).

Queries arrive continuously (seeded exponential inter-arrival gaps,
measured in batched iterations), join the in-flight panel at the next
iteration boundary when a slot frees up, and stream their result out the
iteration their own frontier dies — the batch keeps iterating for the
rest.  Every iteration pays ONE union-frontier chunk stream for however
many queries are in flight, so per-query disk traffic collapses as load
rises.

    PYTHONPATH=src python examples/serve_graph_torch.py [--device cpu]

The PyTorch port's twin of ``examples/serve_graph.py``; runs on the CUDA
card unless ``--device`` names another torch device.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (  # noqa: E402
    ChunkStore, Engine, EngineConfig, GraphServeSession, build_dist_graph,
    build_formats, make_spec,
)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.data.graphs import rmat_graph  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    print("== build graph (R-MAT scale 10, edge factor 16) ==")
    g = rmat_graph(10, 16, seed=42, weighted=True)
    print(f"|V|={g.num_vertices}  |E|={g.num_edges}")

    slots, num_queries, mean_gap = 4, 10, 0.5
    print(f"== disk-backed engine, Q={slots} serving slots ==")
    spec = make_spec(g, num_partitions=4, batch_size=64)
    dg = build_dist_graph(g, spec)
    fm = build_formats(dg)
    rng = np.random.default_rng(7)
    order = np.argsort(-np.asarray(g.out_degrees()))
    sources = [int(v) for v in order[:num_queries]]

    with tempfile.TemporaryDirectory() as root:
        store = ChunkStore.build(dg, fm, os.path.join(root, "store"))
        engine = Engine(dg, fm,
                        EngineConfig(executor="ooc", num_queries=slots),
                        store=store, device=args.device)
        session = GraphServeSession(engine)

        # Poisson process: exponential inter-arrival gaps, in units of
        # batched iterations; a query submitted mid-flight waits in the
        # queue until a slot frees, then joins the next iteration's batch.
        arrive_at = np.cumsum(rng.exponential(mean_gap, num_queries))
        print(f"== serve {num_queries} BFS queries, Poisson arrivals "
              f"(mean gap {mean_gap} iterations) ==")
        results, submitted = [], 0
        while submitted < num_queries or session.in_flight:
            while (submitted < num_queries
                   and arrive_at[submitted] <= session.steps):
                qid = session.submit(sources[submitted])
                print(f"  iter {session.steps:3d}: query {qid} arrives "
                      f"(source={sources[submitted]})")
                submitted += 1
            if session.in_flight:
                done = session.step()
            else:
                session.steps += 1      # idle iteration, nothing in flight
                done = []
            for r in done:
                reached = int((r.levels < np.finfo(np.float32).max).sum())
                print(f"  iter {session.steps:3d}: query {r.qid} done — "
                      f"wait={r.wait_iters} run={r.run_iters} "
                      f"wall={r.wall_s * 1e3:.0f}ms reached={reached}")
                results.append(r)

        for r in results:
            ref = alg.ref_bfs(g.num_vertices, g.src, g.dst, r.source)
            np.testing.assert_array_equal(r.levels, ref)
        c = session.counters
        disk = (c["measured_edge_read_bytes"]
                + c["measured_vertex_read_bytes"]
                + c["measured_vertex_write_bytes"])
        print(f"served {len(results)} queries in {session.steps} batched "
              f"iterations; measured disk bytes: {disk:.0f} "
              f"({disk / len(results):.0f}/query)  net bytes: "
              f"{c['net_bytes']:.0f}")
    print("serve_graph OK")


if __name__ == "__main__":
    main()
