#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 21]

Builds the hand-written CUDA kernel from ``src/repro_torch/kernels/csrc``,
then drives the port's main path — the LOCAL signal/slot engine with the
``block_csr`` backend — through PageRank (5 iterations), BFS, SSSP and WCC
on a Graph500 R-MAT graph (scale 21, edge factor 16, weighted, seed 0:
2,097,152 vertices, 33,554,432 edges; P = 8 partitions, 8 x 8 tiles).

For each algorithm it
  * resets the kernel's launch count, runs the algorithm through the
    public entry points, and reads the count (it must have grown);
  * holds the values against the numpy oracles (BFS and WCC exactly,
    PageRank within rtol 1e-4 / atol 1e-7, SSSP against the float64
    Bellman-Ford oracle within rtol 1e-5 / atol 1e-5 — the tolerances of
    the repo's oracle tests), and the values (BFS/SSSP/WCC bit for bit),
    every counter and the iteration count against the port's own
    ``segment`` backend on the card;
  * (PageRank: add / add_b modes, WCC: min / max modes) replays the
    kernel's first call of the run against its plain PyTorch version:
    min/max bit-equal, has-message counts exact, add/add_b within rtol
    1e-5 (the plain version sums in another order), and times the kernel,
    the plain version and one PyTorch library call computing the same
    function, beside the least time the card could take.

Every phase prints one JSON line; the line before the last holds the
kernel table, the last line is ``{"ok": true, "device": {...}}``.  Any
failed check raises and the script exits non-zero.  Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/block_csr_combine.cu"
TPU_KERNEL = "src/repro/kernels/csr_spmv.py:203"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM, float32 outside the tensor cores
PR_ITERS = 5


def emit(**obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def first_combine_call(phases):
    """Record the arguments of the first block_csr_combine call the engine
    makes inside the block (the kernel's inputs at the main path's
    shapes)."""
    real = phases.block_csr_combine
    seen = {}

    def recording(*args, **kw):
        if not seen:
            seen.update(args=args, kw=kw)
        return real(*args, **kw)

    phases.block_csr_combine = recording
    try:
        yield seen
    finally:
        phases.block_csr_combine = real


def live_slots(row_cnt):
    return int(row_cnt.sum())


def combine_bound_ms(args, mode):
    """Least time for one combine call on these inputs: every byte it must
    move (each live tile of each tile array it reads, the slot indices,
    the vector blocks the live tiles select, the row metadata, the two
    outputs) at the HBM rate, or its float32 operations at the float32
    rate, whichever is larger."""
    import torch
    row_ptr, tile_idx, tile_col, row_cnt = args[:4]
    q_cnt, n_rows = row_cnt.shape
    n_slots = tile_idx.shape[1]
    t = 8
    n_live = live_slots(row_cnt)
    n_tile_arrays = {"add": 2, "add_b": 3, "min": 2, "max": 2}[mode]
    # distinct (q, source block) pairs the live slots read
    pos = torch.arange(n_slots, device=row_cnt.device)[None, :]
    start = row_ptr[:, :-1].long()
    row_of = torch.searchsorted(row_ptr[:, 1:].contiguous(),
                                pos.expand(q_cnt, -1).contiguous(),
                                right=True).clamp(max=n_rows - 1)
    live = pos - torch.gather(start, 1, row_of) < torch.gather(
        row_cnt.long(), 1, row_of)
    cols = (torch.arange(q_cnt, device=row_cnt.device)[:, None] * 2**31
            + tile_col.long())[live]
    n_blocks = int(torch.unique(cols).numel())
    bytes_ = (n_live * (n_tile_arrays * t * t * 4 + 8)
              + q_cnt * n_rows * 8 + n_blocks * 2 * t * 4
              + 2 * q_cnt * n_rows * t * 4)
    products = {"add": 2, "add_b": 3, "min": 1, "max": 1}[mode]
    ops = n_live * t * t * 2 * (products + (1 if mode in ("min", "max")
                                            else 0))
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOPS * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops
            else "operations", bytes_)


def library_call(args, kw):
    """One PyTorch library computation of the same function, for scale:
    add/add_b — one ``torch.sparse.mm`` of the live cells (value rows over
    [xv; xc] and count rows over xc in one CSR matrix); min/max — the
    live cells' ``B + xv`` gathered and folded with ``scatter_reduce_``
    (val only).  Returns a zero-argument callable."""
    import torch
    row_ptr, tile_idx, tile_col, row_cnt, tv, tb, tc, xv, xc = args
    mode, t, ident = kw["mode"], kw["tile"], kw["identity"]
    q_cnt, n_rows = row_cnt.shape
    n_slots, n_src = tile_idx.shape[1], xv.shape[1]
    dev = row_cnt.device
    counts = row_cnt.reshape(-1).long()
    owner = torch.repeat_interleave(torch.arange(q_cnt * n_rows,
                                                 device=dev), counts)
    j = torch.arange(owner.numel(), device=dev) - (
        torch.cumsum(counts, 0) - counts)[owner]
    q = owner // n_rows
    pos = row_ptr[:, :-1].reshape(-1).long()[owner] + j
    tid = q * n_slots + tile_idx.reshape(-1)[q * n_slots + pos].long()
    col = tile_col.reshape(-1)[q * n_slots + pos].long()
    cnt_cells = tc.reshape(-1, t, t)[tid]                      # [L, T, T]
    nz = cnt_cells != 0
    li, ri, ci = nz.nonzero(as_tuple=True)
    row = owner[li] * t + ri                                   # val row
    src = q[li] * n_src + col[li] * t + ci                     # vector idx
    n_out = q_cnt * n_rows * t
    if mode in ("min", "max"):
        b = tb.reshape(-1, t, t)[tid][nz]
        del cnt_cells, nz
        xflat = xv.reshape(-1)
        red = "amin" if mode == "min" else "amax"

        def call():
            out = torch.full((n_out,), ident, device=dev)
            return out.scatter_reduce_(0, row, b + xflat[src], reduce=red)
        return call
    n_x = q_cnt * n_src
    rows = [row, n_out + row]
    cols_ = [src, n_x + src]
    vals = [tv.reshape(-1, t, t)[tid][nz], cnt_cells[nz]]
    if mode == "add_b":
        rows.append(row)
        cols_.append(n_x + src)
        vals.append(tb.reshape(-1, t, t)[tid][nz])
    del cnt_cells, nz
    a = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols_)]), torch.cat(vals),
        (2 * n_out, 2 * n_x), check_invariants=False
    ).coalesce().to_sparse_csr()
    x = torch.cat([xv.reshape(-1), xc.reshape(-1)])[:, None]
    return lambda: torch.sparse.mm(a, x)


def check_kernel(csr, args, kw, reps=10):
    """Kernel vs plain version on the same inputs; returns the table row
    fields (times in ms)."""
    import torch
    mode = kw["mode"]
    val, hc = csr.block_csr_combine(*args, **kw)
    torch.cuda.synchronize()
    rval, rhc = csr.block_csr_combine_ref(*args, **kw)
    if not torch.equal(hc, rhc):
        raise AssertionError(f"{mode}: has-message counts differ")
    err = float((val - rval).abs().max())
    if mode in ("min", "max"):
        if not torch.equal(val.view(torch.int32), rval.view(torch.int32)):
            raise AssertionError(f"{mode}: kernel is not bit-equal to the "
                                 f"plain version (max |diff| {err})")
    else:
        tol = 1e-5 * rval.abs() + 1e-30
        if not bool(((val - rval).abs() <= tol).all()):
            raise AssertionError(f"{mode}: kernel differs from the plain "
                                 f"version beyond rtol 1e-5 ({err})")
    ms = cuda_ms(lambda: csr.block_csr_combine(*args, **kw), reps)
    plain_ms = cuda_ms(lambda: csr.block_csr_combine_ref(*args, **kw), 2)
    lib = library_call(args, kw)
    library_ms = cuda_ms(lib, 5)
    del lib
    bound, bound_by, bytes_ = combine_bound_ms(args, mode)
    emit(phase="kernel_vs_plain", mode=mode, max_abs_err=err,
         kernel_ms=ms, ref_ms=plain_ms, library_ms=library_ms,
         bound_ms=bound, bound_by=bound_by, bytes=bytes_,
         live_tiles=live_slots(args[3]),
         longest_row_tiles=int(args[3].max()),
         dest_partitions=int(args[3].shape[0]),
         row_blocks=int(args[3].shape[1]))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="R-MAT scale (2**scale vertices); 21 by default")
    opts = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src_dir = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src_dir, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src_dir)
    from repro_torch.core import (
        Engine, EngineConfig, build_dist_graph, build_formats, make_spec,
        phases,
    )
    from repro_torch.core import algorithms as alg
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.kernels import build, csr_spmv

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2. kernel build ---------------------------------------------------
    t0 = time.perf_counter()
    csr_spmv._library()
    log = build.library_path("block_csr_combine.cu").with_suffix(".log")
    emit(phase="kernel_build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln])

    # -- 3. the graph ------------------------------------------------------
    t0 = time.perf_counter()
    g = rmat_graph(opts.scale, 16, seed=0, weighted=True)
    spec = make_spec(g, num_partitions=8)
    dg = build_dist_graph(g, spec)
    fm = build_formats(dg)
    n = g.num_vertices
    source = int(np.argmax(g.out_degrees()))
    emit(phase="graph", scale=opts.scale, edge_factor=16, seed=0,
         vertices=n, edges=g.num_edges, partitions=spec.num_partitions,
         batch_size=spec.batch_size, batches=spec.num_batches,
         v_max=spec.v_max, e_max=dg.e_max, source=source,
         host_seconds=time.perf_counter() - t0)

    blk_cfg = EngineConfig(compute_backend="block_csr", block_tile=8)
    seg_cfg = EngineConfig(compute_backend="segment")
    kernel_rows = {}

    def run_algorithm(name, make_engines, drive, check_values, path_mode,
                      check_modes=()):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        blk, seg = make_engines(blk_cfg), make_engines(seg_cfg)
        setup_s = time.perf_counter() - t0
        csr_spmv.block_csr_combine.launches = 0
        t0 = time.perf_counter()
        with first_combine_call(phases) as first:
            vals, stats = drive(blk)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = csr_spmv.block_csr_combine.launches
        if launches < 1:
            raise AssertionError(f"{name}: the block_csr path launched no "
                                 "kernel")
        if first["kw"]["mode"] != path_mode:
            raise AssertionError(f"{name}: ran mode {first['kw']['mode']}, "
                                 f"expected {path_mode}")
        t0 = time.perf_counter()
        drive(blk)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        svals, sstats = drive(seg)
        torch.cuda.synchronize()
        seg_s = time.perf_counter() - t0
        check_values(vals)
        check_values(svals)
        same = bool(np.array_equal(vals, svals))
        if path_mode == "min" and not same:
            raise AssertionError(f"{name}: block_csr values differ from the "
                                 "segment backend's (a MIN fold is exact)")
        if stats.iterations != sstats.iterations:
            raise AssertionError(f"{name}: {stats.iterations} iterations, "
                                 f"segment backend {sstats.iterations}")
        for k, v in sstats.counters.items():
            if abs(stats.counters[k] - v) >= 1e-3:
                raise AssertionError(f"{name}: counter {k} = "
                                     f"{stats.counters[k]}, segment {v}")
        edges = stats.counters["edges_touched"]
        emit(phase="main_path", algorithm=name, iterations=stats.iterations,
             launches=launches, engine_setup_s=setup_s, cold_s=cold_s,
             warm_s=warm_s, segment_s=seg_s, edges_touched=edges,
             edges_per_s=edges / warm_s,
             segment_edges_per_s=edges / seg_s,
             same_values_as_segment=same,
             max_memory_allocated=torch.cuda.max_memory_allocated())
        for mode in check_modes:
            args, kw = list(first["args"]), dict(first["kw"])
            if mode == "add_b":        # a second value tile array
                args[5] = args[4]
            if mode == "max":          # the min inputs, mirrored
                args[5], args[7] = -args[5], -args[7]
                kw["identity"] = -kw["identity"]
            kw["mode"] = mode
            kernel_rows[mode] = check_kernel(csr_spmv, tuple(args), kw)
            del args
        del blk, seg, first
        gc.collect()
        torch.cuda.empty_cache()
        return launches

    def fwd_engines(cfg):
        return Engine(dg, fm, cfg)

    def close(ref, rtol, atol):
        def check(v):
            np.testing.assert_allclose(v, ref, rtol=rtol, atol=atol)
        return check

    def exact(ref):
        def check(v):
            np.testing.assert_array_equal(v, ref)
        return check

    # -- 4. the main path, one algorithm at a time ---------------------------
    launches = {}
    launches["pagerank"] = run_algorithm(
        "pagerank", fwd_engines, lambda e: alg.pagerank(e, PR_ITERS),
        close(alg.ref_pagerank(n, g.src, g.dst, PR_ITERS), 1e-4, 1e-7),
        "add", ("add", "add_b"))
    launches["bfs"] = run_algorithm(
        "bfs", fwd_engines, lambda e: alg.bfs(e, source),
        exact(alg.ref_bfs(n, g.src, g.dst, source)), "min")
    launches["sssp"] = run_algorithm(
        "sssp", fwd_engines, lambda e: alg.sssp(e, source),
        close(alg.ref_sssp(n, g.src, g.dst, g.data, source), 1e-5, 1e-5),
        "min")
    dg_rev = build_dist_graph(g.reversed(), spec)
    fm_rev = build_formats(dg_rev)

    def wcc_engines(cfg):
        return Engine(dg, fm, cfg), Engine(dg_rev, fm_rev, cfg)

    launches["wcc"] = run_algorithm(
        "wcc", wcc_engines, lambda pair: alg.wcc(*pair),
        exact(alg.ref_wcc(n, g.src, g.dst).astype(np.float32)),
        "min", ("min", "max"))

    # -- 5. the kernel table: one row per mode the main path runs -----------
    table = []
    for mode, algos in (("add", ("pagerank",)),
                        ("min", ("bfs", "sssp", "wcc"))):
        row = kernel_rows[mode]
        table.append(dict(
            name=f"block_csr_combine[{mode}]", route="cuda",
            source=KERNEL_SOURCE, replaces=TPU_KERNEL,
            launches=sum(launches[a] for a in algos),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
