"""Quickstart on the PyTorch port: the DFOGraph engine on an R-MAT graph —
the paper's PageRank + SSSP with the signal/slot API, filtering counters,
and a checkpoint/restart through ``repro_torch.ckpt.BlockStore``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the CUDA card unless ``--device`` names another torch device.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.ckpt import BlockStore  # noqa: E402
from repro_torch.core import (  # noqa: E402
    Engine, build_dist_graph, build_formats, make_spec,
)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.partition import gather_vertex_values  # noqa: E402
from repro_torch.data.graphs import rmat_graph  # noqa: E402

F32_MAX = float(np.finfo(np.float32).max)


def sssp_pass(engine, state, active):
    """One SSSP ProcessEdges call: push dist + weight, MIN, keep improved."""
    return engine.process_edges(
        state,
        signal_fn=lambda s, gid: s["dist"],
        slot_fn=lambda m, d_: m + d_,
        monoid=alg.MIN,
        apply_fn=lambda s, agg, has, gid: (
            {"dist": torch.minimum(s["dist"], agg)},
            has & (agg < s["dist"]),
            (agg < s["dist"]).to(torch.float32)),
        active=active)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    print("== build graph (R-MAT scale 10, edge factor 16) ==")
    g = rmat_graph(10, 16, seed=42, weighted=True)
    print(f"|V|={g.num_vertices}  |E|={g.num_edges}")

    print("== two-level column-oriented partition (P=4, batch=64) ==")
    spec = make_spec(g, num_partitions=4, batch_size=64)
    dg = build_dist_graph(g, spec)
    fm = build_formats(dg)
    print(f"boundaries={spec.boundaries}  batches/partition={spec.num_batches}")
    engine = Engine(dg, fm, device=args.device)
    print(f"device: {engine.device}")

    print("== PageRank (5 iterations) ==")
    pr, stats = alg.pagerank(engine, num_iters=5)
    ref = alg.ref_pagerank(g.num_vertices, g.src, g.dst, 5)
    print(f"max |err| vs oracle: {np.abs(pr - ref).max():.2e}")
    c = stats.counters
    print(f"messages sent: {c['msgs_sent']:.0f} "
          f"(unfiltered would be {c['msgs_sent_nofilter']:.0f} — "
          f"filtering saved "
          f"{100 * (1 - c['msgs_sent'] / c['msgs_sent_nofilter']):.1f}%)")
    print(f"net bytes: {c['net_bytes']:.0f}  edge bytes read: "
          f"{c['edge_read_bytes']:.0f}")

    print("== SSSP with checkpoint/restart (paper §3.2) ==")
    source = int(np.argmax(g.out_degrees()))
    gid = engine.global_id
    with tempfile.TemporaryDirectory() as d:
        store = BlockStore(d, keep=2)
        # run 3 iterations, checkpoint, 'crash', restore, finish
        state = engine.init_state(
            dist=torch.where(gid == source, 0.0, F32_MAX / 4).to(
                torch.float32))
        active = (gid == source) & engine.graph.vertex_valid
        for _ in range(3):
            state, active, upd, _ = sssp_pass(engine, state, active)
        store.save({"dist": state["dist"].cpu().numpy(),
                    "active": active.cpu().numpy()}, step=3)
        print("checkpointed at iteration 3; simulating crash + restore...")
        step, restored = store.restore_latest()
        state = engine.init_state(dist=torch.as_tensor(restored["dist"]))
        active = torch.as_tensor(restored["active"], device=engine.device)
        it = step
        while True:
            state, active, upd, _ = sssp_pass(engine, state, active)
            it += 1
            if float(upd) == 0:
                break
        dist = gather_vertex_values(spec, state["dist"].cpu().numpy())
        ref_d = alg.ref_sssp(g.num_vertices, g.src, g.dst, g.data, source)
        print(f"resumed at iter 3, converged at iter {it}; "
              f"max |err| vs oracle: {np.abs(dist - ref_d).max():.2e}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
