"""Multi-process dist_ooc: the per-rank entry point and the parent-side
launcher (DESIGN.md §13) — the port of ``repro.runtime.procworker``.

Each rank is a full SPMD engine replica: it rebuilds the graph, the
two-level spec and the chunk formats from the run spec, opens the shared
:class:`~repro_torch.core.chunkstore.ShardedChunkStore`, builds an Engine
carrying a :class:`~repro_torch.core.transport.ProcContext`, and runs the
same algorithm driver as a single-process run — the engine executes only
the logical workers its rank owns, the transport carries the rest.  Every
rank writes ``result_r{rank}.npz`` with the reference's fields: the
assembled global values, per-iteration returns, counters, per-worker
totals and the transport's fault and recovery statistics.

Run one rank:  ``python -m repro_torch.runtime.procworker <spec.json> <rank>``
Run a fleet:   :func:`launch`.

The run spec is the reference's JSON object::

    {"run_id": str, "world": int, "num_workers": int,
     "rendezvous": dir, "result_dir": dir,
     "graph": {"scale": 7, "edge_factor": 16, "seed": 5, "weighted": true}
              or {"edge_file": path, "crc32": int},
     "spec": {"num_partitions": 4, "batch_size": 16},
     "store_root": sharded-store dir,
     "store_root_rev": optional reversed-graph store dir (wcc),
     "engine": {optional EngineConfig overrides},
     "algorithm": {"name": "pagerank" | "bfs" | "sssp" | "wcc",
                   "args": {...}},
     "fault_plan": FaultPlan.to_json() string or null,
     "io_timeout": seconds, "stall_timeout": seconds,
     "resume": bool}

plus one key of the port's: ``"device"``, the ranks' torch device.  Absent
(or null), every rank runs on the GPU and raises when there is none;
``"cpu"`` runs them on the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

FAULT_EXIT = 42     # mirrors repro_torch.runtime.faults.FAULT_EXIT


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


def _build_problem(spec: dict):
    """The graph, two-level spec, partitioned graph and formats, rebuilt
    from the run spec the same way on every rank (so the replicas agree on
    specs, need lists and byte models without shipping arrays)."""
    from repro_torch.core import build_dist_graph, build_formats, make_spec
    gsp = spec["graph"]
    if gsp.get("edge_file"):
        # an arbitrary graph: the parent serialized and checksummed its
        # edge list once, and every rank loads the same bytes
        from repro_torch.data.graphs import load_edge_list
        g = load_edge_list(gsp["edge_file"], expect_crc=gsp.get("crc32"))
    else:
        from repro_torch.data.graphs import rmat_graph
        g = rmat_graph(int(gsp["scale"]), int(gsp.get("edge_factor", 16)),
                       seed=int(gsp.get("seed", 0)),
                       weighted=bool(gsp.get("weighted", False)))
    two = make_spec(g, num_partitions=int(spec["spec"]["num_partitions"]),
                    batch_size=int(spec["spec"]["batch_size"]))
    dg = build_dist_graph(g, two)
    fm = build_formats(dg)
    return g, two, dg, fm


def _run_algorithm(spec: dict, engine, engine_rev):
    from repro_torch.core import algorithms as alg
    name = spec["algorithm"]["name"]
    args = spec["algorithm"].get("args", {})
    if name == "pagerank":
        return alg.pagerank(engine, int(args.get("num_iters", 3)))
    if name == "bfs":
        return alg.bfs(engine, int(args["source"]))
    if name == "sssp":
        return alg.sssp(engine, int(args["source"]))
    if name == "wcc":
        if engine_rev is None:
            raise ValueError("wcc needs store_root_rev in the run spec")
        return alg.wcc(engine, engine_rev)
    raise ValueError(f"unknown algorithm {name!r}")


def _assemble_values(ctx, two, worker_of, values) -> np.ndarray:
    """A rank's values are authoritative only on its own partitions (the
    process-mode state is zeros elsewhere): take each partition from its
    owner's vector."""
    mine = np.asarray(values)
    vecs = ctx.allgather(mine)
    bounds = np.asarray(two.boundaries)
    full = np.zeros_like(mine)
    for p in range(two.num_partitions):
        r = ctx.assign[int(worker_of[p])]
        full[bounds[p]:bounds[p + 1]] = vecs[r][bounds[p]:bounds[p + 1]]
    return full


def run_rank(spec: dict, rank: int, two, dg, fm, rev=None) -> dict:
    """One rank's job on a problem already built: open the store, join the
    mesh, run the algorithm and assemble the values.  ``rev`` is the
    reversed graph's (dg, fm) when the spec names a reversed store (WCC).
    Returns the ``result_r{rank}.npz`` fields under ``"out"`` beside the
    live ``ctx`` and ``engine`` (the caller writes the result and calls
    ``ctx.finalize()``)."""
    from repro_torch.core import Engine, EngineConfig
    from repro_torch.core.chunkstore import ShardedChunkStore
    from repro_torch.core.transport import ProcContext
    from repro_torch.runtime.faults import FaultInjector, FaultPlan

    store = ShardedChunkStore.open(spec["store_root"])
    injector = None
    if spec.get("fault_plan"):
        injector = FaultInjector(FaultPlan.from_json(spec["fault_plan"]),
                                 rank)
    ctx = ProcContext(rank, int(spec["world"]), int(spec["num_workers"]),
                      spec["rendezvous"], run_id=spec.get("run_id", "run"),
                      injector=injector,
                      io_timeout=float(spec.get("io_timeout", 120.0)),
                      stall_timeout=float(spec.get("stall_timeout", 30.0)),
                      log_dir=spec["result_dir"],
                      resume=bool(spec.get("resume", False)))
    cfg = EngineConfig(executor="dist_ooc",
                       num_workers=int(spec["num_workers"]),
                       **spec.get("engine", {}))
    device = spec.get("device")
    engine = Engine(dg, fm, cfg, store=store, proc_ctx=ctx, device=device)
    engine_rev = None
    if spec.get("store_root_rev"):
        store_r = ShardedChunkStore.open(spec["store_root_rev"])
        engine_rev = Engine(rev[0], rev[1], cfg, store=store_r,
                            proc_ctx=ctx, device=device)
    # Whole-job restart: with every engine registered, compute the resume
    # point from the durable run logs and restore the spills to it; the
    # driver then fast-forwards through the committed ops.
    ctx.prepare_resume()

    values, stats = _run_algorithm(spec, engine, engine_rev)
    full = _assemble_values(ctx, two, store.worker_of, values)

    names = sorted(stats.counters)
    wt = engine.worker_totals
    out = dict(
        values=full,
        iterations=np.int64(stats.iterations),
        rets=np.asarray(stats.per_iter_return, np.float64),
        counter_names=np.asarray(names),
        counter_vals=np.asarray([stats.counters[k] for k in names],
                                np.float64),
        wt_disk=np.asarray([t["disk_bytes"] for t in wt], np.float64),
        wt_net=np.asarray([t["net_bytes"] for t in wt], np.float64),
        wt_edges=np.asarray([t["edges_touched"] for t in wt], np.float64),
        assign=np.asarray(ctx.assign, np.int64),
        epoch=np.int64(ctx.epoch),
        recoveries=np.int64(ctx.stats["recoveries"]),
        wire_frames=ctx.stats["wire_frames"],
        dropped=ctx.stats["dropped"],
        redelivered=ctx.stats["redelivered"],
        held=ctx.stats["held"],
        late_delivered=ctx.stats["late_delivered"],
        corrupted=ctx.stats["corrupted"],
        corrupt_frames=ctx.stats["corrupt_frames"],
    )
    return dict(out=out, ctx=ctx, engine=engine, engine_rev=engine_rev)


def write_result(result_dir: str, rank: int, out: dict) -> None:
    """Write ``result_r{rank}.npz`` atomically."""
    os.makedirs(result_dir, exist_ok=True)
    tmp = os.path.join(result_dir, f".result_r{rank}.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, os.path.join(result_dir, f"result_r{rank}.npz"))


def worker_main(spec_path: str, rank: int) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    g, two, dg, fm = _build_problem(spec)
    rev = None
    if spec.get("store_root_rev"):
        from repro_torch.core import build_dist_graph, build_formats
        dg_r = build_dist_graph(g.reversed(), two)
        rev = (dg_r, build_formats(dg_r))
    job = run_rank(spec, rank, two, dg, fm, rev)
    write_result(spec["result_dir"], rank, job["out"])
    job["ctx"].finalize()


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


def launch(spec: dict, timeout: float = 300.0, resume: bool = False) -> list:
    """Spawn one OS process per rank, wait, return the exit codes.

    Writes ``spec.json`` (and per-rank ``log_r{rank}.txt``) under the
    spec's ``result_dir``.  On a hang past ``timeout`` every rank still
    running is killed and a RuntimeError names the first — a fault
    injection run must end through recovery, never through this watchdog.
    The ranks inherit this process's environment.

    ``resume=True`` restarts a crashed job from its durable run logs and
    per-op checkpoints (same spec, same directories): the fault plan is
    dropped — the op the crash interrupted was never committed, so the
    plan would fire the same kill again — and the ranks fast-forward
    through every committed op, ending bit-identical to a failure-free
    run."""
    rdir = spec["result_dir"]
    os.makedirs(rdir, exist_ok=True)
    os.makedirs(spec["rendezvous"], exist_ok=True)
    if resume:
        spec = dict(spec)
        spec["resume"] = True
        spec["fault_plan"] = None
    # a port file left by a crashed incarnation would race the fresh
    # rendezvous: a rank could dial a port long gone
    for r in range(int(spec["world"])):
        stale = os.path.join(spec["rendezvous"], f"rank{r}.port")
        if os.path.exists(stale):
            os.remove(stale)
    spec_path = os.path.join(rdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    import repro_torch
    src_dir = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    run_env = dict(os.environ)
    run_env["PYTHONPATH"] = (src_dir + os.pathsep + run_env["PYTHONPATH"]
                             if run_env.get("PYTHONPATH") else src_dir)
    procs, logs = [], []
    for r in range(int(spec["world"])):
        log = open(os.path.join(rdir, f"log_r{r}.txt"), "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.runtime.procworker",
             spec_path, str(r)],
            stdout=log, stderr=subprocess.STDOUT, env=run_env))
    codes = []
    try:
        for r, p in enumerate(procs):
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                raise RuntimeError(
                    f"rank {r} did not finish within {timeout}s "
                    f"(logs under {rdir})")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return codes


def load_result(result_dir: str, rank: int) -> dict:
    path = os.path.join(result_dir, f"result_r{rank}.npz")
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def main(argv) -> int:
    if len(argv) != 3:
        print("usage: python -m repro_torch.runtime.procworker <spec.json> "
              "<rank>", file=sys.stderr)
        return 2
    worker_main(argv[1], int(argv[2]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
