"""DFOGraph engine: vertex-centric push with signal/slot (paper §3) — the
LOCAL, SHARD_MAP, OOC and DIST_OOC subset of ``repro.core.engine``, single-
and multi-query.

ProcessEdges runs the paper's four phases:
  1. generating          — active vertices produce messages (``signal``),
  2. inter-node pass     — messages are *filtered* (paper §4.3) and exchanged
                           between partitions,
  3. intra-node dispatch — messages are routed to destination batches using
                           the dispatching graph (= the DCSR arrays, §4.2),
  4. processing          — ``slot`` contributions along edges are combined per
                           destination vertex and ``apply`` updates vertex state.

The phase implementations live in :mod:`repro_torch.core.phases`; the
executors of :mod:`repro_torch.core.executor` realize them:

  * ``LOCAL`` (``executor="auto"``) — one device, the partition axis a
    leading tensor axis, everything resident in device memory;
  * ``SHARD_MAP`` (``mesh=ProcessMesh(...)``) — the partition axis is the
    mesh axis: P ranks of one ``torch.distributed`` group
    (:mod:`repro_torch.core.mesh`), each holding only its own partition's
    rows on its device; phase 2 is a real all-to-all, the dense slab or
    the compacted (value, source-index) exchange the host arbitrates
    each iteration (``physical_sparse_exchange``, DESIGN.md §12), and
    every counter is summed over the mesh;
  * ``OOC`` (``executor="ooc"``) — one host, edge chunks streamed from a
    disk :class:`~repro_torch.core.chunkstore.ChunkStore` and vertex state
    in a :class:`~repro_torch.core.chunkstore.VertexSpill`; only the reads
    the selective schedule marks necessary are issued, and measured bytes
    are cross-checked against the analytic model (``verify_io``).
  * ``DIST_OOC`` (``executor="dist_ooc"``) — W workers, each with its own
    shard of a :class:`~repro_torch.core.chunkstore.ShardedChunkStore` and
    its own vertex spill, exchanging need-list-filtered message batches
    over a measured wire (:mod:`repro_torch.core.exchange`); network bytes
    are audited against the model too.  ``parallel_workers`` runs the
    workers on thread pools with bit-identical results.  With
    ``proc_ctx`` (a :class:`~repro_torch.core.transport.ProcContext`,
    DESIGN.md §13) the engine is one rank of a multi-process run: it runs
    the logical workers its rank owns, batches for other ranks cross TCP
    sockets, and every op is a recoverable one (per-op checkpoint,
    rollback and replay when a rank dies, a durable run log for whole-job
    restart).

``process_edges_multi`` / ``process_vertices_multi`` serve
``EngineConfig.num_queries`` concurrent queries through one selective pass
over [P, V, Q] state panels (DESIGN.md §11), on LOCAL and SHARD_MAP
(segment backend), OOC and DIST_OOC (both backends);
:mod:`repro_torch.core.multiquery` holds their executors.

``slot`` contributions are reduced with an associative + commutative
**monoid** (add/min/max — all four paper algorithms fit), the
data-race-free equivalent of the C++ system's serialized slot calls
(DESIGN.md §2).

Phase 4 runs on a configurable compute backend
(``EngineConfig.compute_backend``): the flat ``"segment"`` reference, or
``"block_csr"`` — the hand-written CUDA block-CSR kernel over per-(source
partition, destination batch) tiles that zero-skips chunks which received
no messages (selective computation, §4.1/§4.4, on the compute path).

LOCAL counters are float32 0-d tensors, as in the reference (SHARD_MAP's
are too, summed over the mesh on the host); OOC and DIST_OOC counters are
Python floats from the host phases, as in the reference.  Algorithm loops
accumulate both in Python floats.

On a mesh, ``graph``, ``fmts`` and ``global_id`` stay where the caller
built them (the host): the algorithms build full [P, V] arrays there,
and :meth:`Engine.init_state` / :meth:`Engine.shard` move this rank's row
to its device.  States and frontiers passed between calls are rank rows
([1, V] or [1, V, Q]); :meth:`Engine.gather` assembles the full array.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
import warnings
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import executor as _executor
from repro_torch.core import multiquery as _multiquery
from repro_torch.core.chunkstore import (
    ChunkStore, DiskChunkSource, HBMChunkSource, ShardedChunkStore,
    VertexSpill,
)
from repro_torch.core.exchange import WIRE_MSG_BYTES
from repro_torch.core.formats import ChunkFormats, _np, build_block_tiles
from repro_torch.core.partition import DistGraph
from repro_torch.core.phases import (
    batch_touched, bitmap_model_bytes, reduce_worker_counters,
)
from repro_torch.utils import (
    pack_bools, resolve_device, token_ctx, unpack_bools,
)

State = Dict[str, torch.Tensor]      # name -> [P, V] stacked vertex arrays


# ---------------------------------------------------------------------------
# Monoids
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Monoid:
    name: str
    identity: float

    def segment(self, data, segment_ids, num_segments):
        """Reduce ``data`` [..., E] into ``num_segments`` segments along
        the last axis (``segment_ids`` [..., E] int64); empty segments
        hold the identity."""
        if self.name not in ("add", "min", "max"):
            raise ValueError(self.name)
        out = torch.full(data.shape[:-1] + (num_segments,), self.identity,
                         dtype=data.dtype, device=data.device)
        if self.name == "add":
            return out.scatter_add_(-1, segment_ids, data)
        return out.scatter_reduce_(-1, segment_ids, data,
                                   reduce="a" + self.name)


ADD = Monoid("add", 0.0)
MIN = Monoid("min", float(np.finfo(np.float32).max))
MAX = Monoid("max", float(np.finfo(np.float32).min))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tunables mirroring the paper's knobs, with the reference's field
    names and defaults."""

    enable_filtering: bool = True
    """Apply the paper's §4.3 need-list message filter in phase 2."""

    filter_skip_threshold: float = 2.0
    """Skip the filter toward a destination once ``|L_pq| >= threshold *
    |M_p|`` (the paper's 2x heuristic)."""

    msg_bytes: int = 4
    """Payload bytes per message value in the I/O and network byte models."""

    enable_adaptive_formats: bool = True
    """Per-chunk runtime CSR/DCSR selection (paper §4.1).  Required by the
    ooc executor: its physical reads follow the same decision, which is
    what makes measured bytes equal the model."""

    account_io: bool = True
    """Maintain the modeled I/O counters (vertex/edge/bitmap bytes).
    Required by the ooc executor: the measured-vs-modeled cross-check
    needs both sides."""

    compression: bool = True
    """The §4.1 compression tier (DESIGN.md §9) in the byte models: the
    three-way {CSR-pruned, DCSR-raw, DCSR-delta} read choice and the
    delta-varint wire encodings.  Results are bit-identical either way.
    The ooc executor requires a store built with the same flag
    (``ChunkStore.build(..., compression=...)``, validated)."""

    compute_backend: str = "segment"
    """Phase-4 combine: ``"segment"`` (flat per-edge gather + scatter
    reduction; the reference) or ``"block_csr"`` (the CUDA block-CSR
    kernel with zero-skipping — DESIGN.md §4).  Non-affine slot functions
    fall back to segment with a warning.  The ooc executor runs phase 4 on
    the engine's device with either backend: segment as a monoid scatter
    over each streamed batch, block_csr as one kernel launch per streamed
    batch."""

    block_tile: int = 8
    """Tile edge length T for the block_csr backend (tiles are [T, T]);
    the CUDA kernel is built for T = 8."""

    executor: str = "auto"
    """``"auto"`` is LOCAL; ``"ooc"`` streams disk-resident chunks on one
    host (requires ``store=ChunkStore.build(...)``); ``"dist_ooc"`` runs
    ``num_workers`` workers over a sharded store (requires
    ``store=ChunkStore.build_sharded(...)``)."""

    verify_io: bool = True
    """For ooc / dist_ooc: raise inside every call if any measured counter
    (disk bytes, chunks; on dist_ooc also the wire's bytes) deviates from
    the analytic model.  The repo's signature invariant; leave it on."""

    ooc_prefetch_depth: int = 2
    """How many decoded dst-batch work items the chunk prefetch thread may
    run ahead of the combine (2 = classic double buffering)."""

    num_workers: int = 1
    """W for ``executor="dist_ooc"``: must equal the sharded store's
    worker count."""

    parallel_workers: bool = False
    """dist_ooc only: run the W send loops and the W receive pipelines on
    thread pools (DESIGN.md §8).  Every float a worker produces is reduced
    in worker order after each phase joins, so results and counters are
    bit-identical to the sequential run."""

    device_decode: bool | None = None
    """ooc / dist_ooc, compressed stores only: decode chunk payloads on
    the engine's device (the fused decode, ``kernels/chunk_decode.py``)
    instead of the host numpy codec (DESIGN.md §10), and on dist_ooc also
    the wire's gap streams (the LEB128 stencil and the add scan of
    ``kernels/varint.py``).  Bytes read, the byte models and the decoded
    values are bit-identical either way.  ``None`` (auto) enables it
    exactly when the engine's device is CUDA and compression is on;
    uncompressed stores always decode on the host (their payload is a
    plain memcpy, nothing to decode)."""

    physical_sparse_exchange: bool | None = None
    """SHARD_MAP only (DESIGN.md §12): realize phase 2's filtering on the
    collective itself.  Each iteration the host takes the ``pmax``'d
    per-peer live count of the send decision, buckets it to a power-of-two
    capacity and ships the compacted (value, source-index) exchange when
    that is cheaper than the dense slab (the ``choose_wire_format``
    comparison), else the slab; results are bit-identical either way and
    ``measured_net_payload_elems`` audits the elements shipped against the
    model.  ``None`` (auto) enables it exactly when there is a mesh;
    ``True`` without one raises."""

    num_queries: int = 1
    """Q for the multi-query serving surface (``process_edges_multi`` /
    ``process_vertices_multi``, DESIGN.md §11): vertex state carries a
    trailing query axis ([P, V, Q] panels) and ONE selective pass serves
    all Q frontiers — the scheduled active set is the union of the
    per-query frontiers, per-query masks keep the combines independent.
    The ooc and dist_ooc vertex spills are laid out per query
    (``{key}@q{j}`` columns, ``active_q{j}`` bitmaps), so a spill root
    must be (re)built with the same Q (``VertexSpill`` validates).  The
    single-query API is unaffected by this knob."""


COUNTER_KEYS = (
    "msgs_generated", "msgs_sent", "msgs_sent_nofilter",
    "net_bytes", "net_bytes_raw", "net_bytes_nofilter",
    "msgs_dispatched", "edges_touched", "chunks_read",
    "chunks_read_csr", "chunks_read_dcsr", "chunks_read_dcsr_delta",
    "edge_read_bytes", "edge_read_bytes_raw",
    "vertex_read_bytes", "vertex_write_bytes",
    "msg_disk_bytes", "seek_cost",
    # SHARD_MAP physical wire (zero on the LOCAL executor).
    "net_payload_elems", "net_payload_elems_dense",
    "measured_net_payload_elems",
    "exchange_compacted_iters", "exchange_dense_iters",
)

# Measured twins of the modeled I/O counters, reported by the OOC executor
# (what the storage tier actually served) and cross-checked against the
# analytic model when EngineConfig.verify_io is on.
MEASURED_KEYS = (
    "measured_chunks_read", "measured_edge_read_bytes",
    "measured_vertex_read_bytes", "measured_vertex_write_bytes",
    # how many of the measured chunk reads were decoded on the device
    # (EngineConfig.device_decode); no analytic twin — it reports the
    # decode path taken, not bytes moved
    "measured_chunks_device_decoded",
)

MEASURED_PAIRS = (
    ("measured_chunks_read", "chunks_read"),
    ("measured_edge_read_bytes", "edge_read_bytes"),
    ("measured_vertex_read_bytes", "vertex_read_bytes"),
    ("measured_vertex_write_bytes", "vertex_write_bytes"),
)

# dist_ooc additionally audits the wire: bytes serialized across workers
# against the analytic network model, plus which encoding each
# cross-worker batch chose.
DIST_MEASURED_KEYS = (
    "measured_net_bytes", "net_pair_batches", "net_vpair_batches",
    "net_slab_batches", "net_uval_batches",
)

DIST_MEASURED_PAIRS = MEASURED_PAIRS + (
    ("measured_net_bytes", "net_bytes"),
)

# The SHARD_MAP executor's wire audit (DESIGN.md §12): the payload elements
# the collective shipped must equal the model that arbitrated it, checked
# after every mesh ProcessEdges when verify_io is on.
SHARDED_MEASURED_PAIRS = (
    ("measured_net_payload_elems", "net_payload_elems"),
)


class _BlockState(Mapping):
    """Mapping view of the per-worker spill blocks as one [P, V] state.

    Each value concatenates the workers' contiguous partition rows on
    first access (cached thereafter).  Like the OOC executor's memmap
    views, the spills are authoritative: values reflect them as of first
    access, and a state is consumed before the next engine call mutates
    them (the algorithms' pattern)."""

    def __init__(self, views: list):
        self._views = views
        self._cache: dict = {}

    def __getitem__(self, key):
        if key not in self._cache:
            self._cache[key] = np.concatenate(
                [v[key] for v in self._views], axis=0)
        return self._cache[key]

    def __iter__(self):
        return iter(self._views[0])

    def __len__(self):
        return len(self._views[0])


def zero_counters(device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in COUNTER_KEYS}


def accumulate_counters(acc: dict, new: dict) -> dict:
    """Host-side accumulation across iterations (python floats); one
    device-to-host copy for all the tensor counters of a call."""
    keys = list(new)
    vals = [new[k] for k in keys]
    if vals and all(isinstance(v, torch.Tensor) for v in vals):
        vals = torch.stack([v.reshape(()) for v in vals]).tolist()
    return {k: acc.get(k, 0.0) + float(v) for k, v in zip(keys, vals)}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Engine:
    """Executes signal/slot programs over a two-level-partitioned graph on
    one device (``"cuda"`` unless the caller passes ``device``), or, with
    ``mesh``, as one rank of the SHARD_MAP executor on the mesh's device
    (``mesh.size`` must equal the number of partitions)."""

    counter_keys = COUNTER_KEYS

    def __init__(self, graph: DistGraph, fmts: ChunkFormats,
                 config: EngineConfig = EngineConfig(),
                 mesh=None, axis: str = "part", store=None, proc_ctx=None,
                 *, device=None):
        if config.executor not in ("auto", "ooc", "dist_ooc"):
            raise ValueError(f"unknown executor: {config.executor!r}")
        if proc_ctx is not None and config.executor != "dist_ooc":
            raise ValueError(
                "proc_ctx (multi-process transport, DESIGN.md §13) applies "
                f"only to executor='dist_ooc', got {config.executor!r}")
        self.proc_ctx = proc_ctx
        if config.num_queries < 1:
            raise ValueError(
                f"num_queries must be >= 1, got {config.num_queries}")
        if config.parallel_workers and config.executor != "dist_ooc":
            raise ValueError(
                "parallel_workers applies only to executor='dist_ooc' (the "
                "other executors have no per-worker loops to overlap); got "
                f"executor={config.executor!r}")
        if config.device_decode and not config.compression:
            raise ValueError(
                "device_decode=True requires compression=True: uncompressed "
                "chunk payloads are plain column memcpys with nothing to "
                "decode on device")
        self.mesh, self.axis = mesh, axis
        self._distributed = mesh is not None
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.config = config
        self._host_graph = graph
        spec = graph.spec
        gid = torch.from_numpy(
            np.asarray(spec.boundaries[:-1], np.int32)[:, None]
            + np.arange(spec.v_max, dtype=np.int32)[None, :])   # [P, V]
        if self._distributed:
            self._init_mesh(graph, fmts, gid)
        else:
            self.graph = graph.to(self.device)
            self.fmts = fmts.to(self.device)
            self.global_id = gid.to(self.device)
        self._ooc = config.executor == "ooc"
        self._dist_ooc = config.executor == "dist_ooc"
        # Resolve the physical_sparse_exchange knob (docstring on
        # EngineConfig): auto means "on exactly when there is a mesh for
        # the collective to run over".
        if config.physical_sparse_exchange and not self._distributed:
            raise ValueError(
                "physical_sparse_exchange=True requires the SHARD_MAP "
                "executor (pass mesh=...): the other executors have no "
                "in-mesh collective to realize")
        if config.physical_sparse_exchange is None:
            self.physical_sparse_exchange = self._distributed
        else:
            self.physical_sparse_exchange = bool(
                config.physical_sparse_exchange)
        if (self._ooc or self._dist_ooc) and self._distributed:
            raise ValueError(f"executor={config.executor!r} is "
                             "single-process; the SHARD_MAP executor is "
                             "selected by `mesh`")
        if config.device_decode is None:
            self.device_decode = (config.compression
                                  and (self._ooc or self._dist_ooc)
                                  and self.device.type == "cuda")
        else:
            self.device_decode = bool(config.device_decode)
        self._measured_pairs = (DIST_MEASURED_PAIRS if self._dist_ooc
                                else MEASURED_PAIRS)
        if self._ooc:
            self._init_ooc(store, fmts)
        if self._dist_ooc:
            self._init_dist_ooc(store, fmts)
        # block_csr backend state (built lazily on first use)
        self._block = None
        self._block_host = None
        self._block_vals_cache: dict = {}
        self._probe_cache: dict = {}
        self._pe_cache: dict = {}
        self._warned_slot_fallback = False

    def _init_mesh(self, graph, fmts, gid):
        """SHARD_MAP state of this rank: the host structures kept whole
        (the algorithms build their initial arrays from them), and only
        this rank's row of every array the executor reads — the reference's
        sharded ``garrs`` — on the device."""
        spec = graph.spec
        if self.mesh.size != spec.num_partitions:
            raise ValueError(
                f"the mesh has {self.mesh.size} ranks but the graph has "
                f"{spec.num_partitions} partitions: SHARD_MAP runs one "
                "partition per rank")
        self.graph, self.fmts, self.global_id = graph, fmts, gid
        row = slice(self.mesh.rank, self.mesh.rank + 1)
        put = lambda x: x[row].to(self.device)
        self._garrs = dict(
            vertex_valid=put(graph.vertex_valid), need=put(graph.need),
            need_counts=put(graph.need_counts), global_id=put(gid),
            **{k: put(v) for k, v in
               HBMChunkSource.dest_arrays(fmts).items()},
            **{k: put(v) for k, v in
               HBMChunkSource.edge_arrays(graph).items()})
        # per ProcessEdges: seconds, payload and wire choice
        # (executor.log_mesh_call)
        self.mesh_log: list = []

    def _init_out_of_core(self):
        """What both out-of-core executors share: the validations of the
        reference and the slots that recognize returned states."""
        config = self.config
        name = config.executor
        if not config.enable_adaptive_formats:
            raise ValueError(
                f"executor={name!r} requires enable_adaptive_formats: the "
                "non-adaptive model prices DCSR-only chunks at 0 bytes, "
                "which no physical read can match")
        if not config.account_io:
            raise ValueError(f"executor={name!r} requires account_io (the "
                             "measured/modeled cross-check needs both)")
        self._ooc_last_state = None
        self._mq_last_state = None

    def _init_ooc(self, store, fmts):
        """OOC executor state (DESIGN.md §6): the validations of the
        reference, the disk chunk source and the vertex spill."""
        config, spec = self.config, self._host_graph.spec
        self._init_out_of_core()
        if not isinstance(store, ChunkStore):
            raise ValueError("executor='ooc' requires a ChunkStore "
                             "(ChunkStore.build(graph, fmts, root))")
        self.check_store_spec(store.manifest, store.root, fmts)
        self.counter_keys = COUNTER_KEYS + MEASURED_KEYS
        self.ooc_source = DiskChunkSource(store, self._host_graph, fmts)
        self.spill = VertexSpill(
            os.path.join(store.root, "vertex"), spec.num_partitions,
            spec.num_batches, spec.batch_size, spec.v_max,
            num_queries=config.num_queries)
        # host wall seconds per OOC stage (executor.OOC_WALL_KEYS)
        self.ooc_wall = dict.fromkeys(_executor.OOC_WALL_KEYS, 0.0)

    def _init_dist_ooc(self, store, fmts):
        """DIST_OOC executor state (DESIGN.md §7, §8): the validations of
        the reference, one disk chunk source and one vertex spill per
        worker shard, and (``parallel_workers``) the two long-lived thread
        pools."""
        config, spec = self.config, self._host_graph.spec
        self._init_out_of_core()
        if not isinstance(store, ShardedChunkStore):
            raise ValueError(
                "executor='dist_ooc' requires a ShardedChunkStore "
                "(ChunkStore.build_sharded(graph, fmts, root, W))")
        if store.num_workers != config.num_workers:
            raise ValueError(
                f"num_workers={config.num_workers} does not match the "
                f"sharded store's {store.num_workers} worker shards")
        if config.msg_bytes != WIRE_MSG_BYTES:
            raise ValueError(
                f"executor='dist_ooc' serializes float32 message values "
                f"on the wire; msg_bytes must be {WIRE_MSG_BYTES} so "
                "measured network bytes can equal the model")
        for s in store.shards:
            self.check_store_spec(s.manifest, s.root, fmts)
        self.counter_keys = COUNTER_KEYS + MEASURED_KEYS + DIST_MEASURED_KEYS
        self.store = store
        self.worker_parts = [tuple(s.partitions) for s in store.shards]
        self.worker_of = store.worker_of
        self.dist_sources = [DiskChunkSource(s, self._host_graph, fmts)
                             for s in store.shards]
        self.spills = [VertexSpill(
            os.path.join(s.root, "vertex"), len(parts), spec.num_batches,
            spec.batch_size, spec.v_max, num_queries=config.num_queries)
            for s, parts in zip(store.shards, self.worker_parts)]
        self.reset_worker_totals()
        ctx = self.proc_ctx
        if ctx is not None:
            # Process mode: this engine runs only the logical workers ctx
            # assigns to this rank, the transport carries the other ranks'
            # batches, and ctx.recoverable() wraps every op with a per-op
            # block-store checkpoint, so a peer's crash rolls the op back
            # bit for bit (DESIGN.md §13).
            if ctx.num_workers != config.num_workers:
                raise ValueError(
                    f"proc_ctx has num_workers={ctx.num_workers} but "
                    f"EngineConfig.num_workers={config.num_workers}")
            if config.num_queries != 1:
                raise ValueError(
                    "process-mode dist_ooc supports num_queries=1 only "
                    "(the recovery checkpoint covers the single-query "
                    "spill layout)")
            self._ckpt_stores = {}
            self._proc_wt_snap = None
            # per-op checkpoint cost on this rank (save_s, bytes and blocks
            # written, blocks reused) and the restores' seconds
            self.proc_ckpt = dict.fromkeys(
                ("saves", "save_s", "bytes_written", "blocks_written",
                 "blocks_reused", "restores", "restore_s"), 0)
            ctx.register_engine(self)
        # Long-lived pools (parallel_workers): one thread per worker for
        # the phase barriers, and two per worker for the pipelines (one
        # prefetcher + one decode-ahead each); idle threads exit when the
        # engine is collected.
        self.worker_pool = (
            ThreadPoolExecutor(max_workers=config.num_workers,
                               thread_name_prefix="dist-worker")
            if config.parallel_workers else None)
        self.pipeline_pool = (
            ThreadPoolExecutor(max_workers=2 * config.num_workers,
                               thread_name_prefix="dist-pipeline")
            if config.parallel_workers else None)

    def reset_worker_totals(self) -> None:
        """Per-worker measured traffic accumulated across calls
        (``worker_totals``: disk bytes, wire bytes sent, edges touched),
        and per-worker host wall seconds per phase and stage
        (``worker_times``, ``executor.DIST_WALL_KEYS``).  The timings live
        beside the traffic totals so that those stay bit-identical between
        sequential and parallel runs."""
        self.worker_totals = [
            dict(disk_bytes=0.0, net_bytes=0.0, edges_touched=0.0)
            for _ in range(self.config.num_workers)]
        self.worker_times = [
            dict.fromkeys(_executor.DIST_WALL_KEYS, 0.0)
            for _ in range(self.config.num_workers)]

    def check_store_spec(self, manifest, root, fmts):
        """A store built for a different partitioning or layout must fail
        here with a clear error, not via oblique slicing downstream."""
        config, spec = self.config, self._host_graph.spec
        got = tuple(manifest.get(k) for k in
                    ("num_partitions", "num_batches", "batch_size", "v_max"))
        want = (spec.num_partitions, spec.num_batches, spec.batch_size,
                spec.v_max)
        if got != want:
            raise ValueError(
                f"chunk store at {root} was built for a different "
                f"partitioning (P, B, batch_size, v_max) = {got}; this "
                f"graph's spec has {want}")
        stored = bool(manifest.get("compression", False))
        if stored != config.compression:
            raise ValueError(
                f"chunk store at {root} was built with compression={stored}"
                f", but EngineConfig.compression={config.compression}; the "
                "physical layout must match the byte model (rebuild the "
                "store or flip the knob)")
        elided = bool(manifest.get("values_elided", False))
        want_elided = config.compression and bool(
            getattr(fmts, "values_elided", False))
        if elided != want_elided:
            raise ValueError(
                f"chunk store at {root} has values_elided={elided}, but "
                f"this graph's formats price values_elided={want_elided}; "
                "the physical layout must match the byte model (rebuild "
                "the store from these formats)")

    def init_state(self, **arrays) -> State:
        """Vertex state on the engine's device (on a mesh: this rank's row
        of each full [P, V, ...] array)."""
        if self._distributed:
            return {k: self.shard(v) for k, v in arrays.items()}
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in arrays.items()}

    def shard(self, x) -> torch.Tensor:
        """This rank's [1, ...] row of a full [P, ...] array (tensor or
        numpy), on the engine's device — where the reference puts an array
        on the mesh sharding."""
        r = self.mesh.rank
        return torch.as_tensor(x)[r:r + 1].to(self.device)

    def gather(self, rows) -> np.ndarray:
        """The full [P, ...] host array from every rank's [1, ...] rows:
        one ``all_gather``, so every rank must call it (an algorithm calls
        it once, at its end)."""
        return self.mesh.all_gather(torch.as_tensor(rows).cpu()).numpy()

    # -- OOC state residency and audit ---------------------------------------
    def _sync_ooc_state(self, state: State) -> None:
        """Make the spill authoritative for ``state``.

        States returned by OOC calls are recognized by identity and skipped
        (the spill already holds them); anything else — the initial
        ``init_state`` dict or caller-constructed arrays — is loaded as an
        unmeasured preprocessing sync."""
        if state is self._ooc_last_state:
            return
        self._mq_last_state = None
        arrs = {k: _np(v) for k, v in state.items()}
        valid = _np(self._host_graph.vertex_valid)
        if self._dist_ooc:
            # process mode: only this rank's workers' spills (the others
            # live on their owners' disks)
            for w in self._local_workers():
                parts = self.worker_parts[w]
                lo, hi = parts[0], parts[-1] + 1
                self.spills[w].load({k: v[lo:hi] for k, v in arrs.items()})
                self.spills[w].write_bitmap(valid[lo:hi])
                self.spills[w].reset_io_counters()
            return
        self.spill.load(arrs)
        self.spill.write_bitmap(valid)
        self.spill.reset_io_counters()

    def _local_workers(self) -> list:
        """The logical workers this engine runs: all of them, or in
        process mode those its rank owns now."""
        if self.proc_ctx is not None:
            return self.proc_ctx.my_workers()
        return list(range(self.config.num_workers))

    def _dist_state_views(self) -> State:
        """Lazy [P, V] state over the per-worker spills (contiguous
        partition blocks, in order): the per-key concatenation waits for a
        caller that reads it, so intermediate iterations, which only pass
        the state back by identity, never materialize it.

        Process mode returns a padded dict instead: only this rank's
        workers' rows are filled, the rest are zeros that no one reads
        (drivers pass the state back by identity, and the final values are
        assembled from each partition's owner)."""
        if self.proc_ctx is None:
            return _BlockState([sp.state_views() for sp in self.spills])
        spec = self._host_graph.spec
        mine = self.proc_ctx.my_workers()
        out: dict = {}
        for name, arr0 in self.spills[mine[0]].state_views().items():
            out[name] = np.zeros((spec.num_partitions, spec.v_max),
                                 arr0.dtype)
        for w in mine:
            parts = self.worker_parts[w]
            lo, hi = parts[0], parts[-1] + 1
            for name, arr in self.spills[w].state_views().items():
                out[name][lo:hi] = arr
        return out

    # -- process-mode recovery hooks (DESIGN.md §13) -------------------------
    def _proc_ckpt_store(self, w: int):
        """Worker ``w``'s block store under its shard root (shared disk),
        so an adopting rank reads the checkpoints the dead rank wrote;
        keyed by the run id, so runs over one store never mix manifests."""
        store = self._ckpt_stores.get(w)
        if store is None:
            from repro_torch.ckpt.blockstore import BlockStore
            root = os.path.join(self.store.shards[w].root,
                                f"ckpt-{self.proc_ctx.run_id}")
            store = self._ckpt_stores[w] = BlockStore(root, keep=2)
        return store

    def _proc_ckpt_save(self, op: int) -> None:
        """Checkpoint this rank's spills at the start of op ``op`` (called
        by ``ProcContext.recoverable`` before the ready barrier, so every
        injected kill point, all after it, leaves ckpt(op) on shared disk
        for the adopter).  Content-addressed blocks make unchanged arrays
        free (paper §3.2).  Also snapshots ``worker_totals``: a failed
        attempt's partial accumulation must not leak into the replay."""
        t0 = time.perf_counter()
        self._proc_wt_snap = [dict(d) for d in self.worker_totals]
        for w in self.proc_ctx.my_workers():
            spill = self.spills[w]
            tree = {"s:" + name: np.array(arr)
                    for name, arr in spill.state_views().items()}
            bm = spill.read_bitmap(measured=False)
            if bm is not None:
                tree["active"] = bm
            got = self._proc_ckpt_store(w).save(tree, step=op)
            for k in ("bytes_written", "blocks_written", "blocks_reused"):
                self.proc_ckpt[k] += got[k]
        self.proc_ckpt["saves"] += 1
        self.proc_ckpt["save_s"] += time.perf_counter() - t0

    def _proc_restore_spill(self, w: int, step: int) -> None:
        """Load worker ``w``'s spill (arrays and active bitmap) from its
        checkpoint ``step``, unmeasured."""
        t0 = time.perf_counter()
        spill = self.spills[w]
        tree = self._proc_ckpt_store(w).restore(step)
        spill.load({k[len("s:"):]: v for k, v in tree.items()
                    if k.startswith("s:")})
        if "active" in tree:
            spill.write_bitmap(tree["active"].astype(bool), measured=False)
        else:
            bits = os.path.join(spill.root, "active.bits")
            if os.path.exists(bits):
                os.remove(bits)
        self.proc_ckpt["restores"] += 1
        self.proc_ckpt["restore_s"] += time.perf_counter() - t0

    def _proc_rollback(self, op: int) -> None:
        """Restore every owned spill (and ``worker_totals``) to the pre-op
        checkpoint, so the op replays bit for bit on the re-planned
        ownership; unmeasured, so the replay issues exactly the measured
        I/O a failure-free run does.

        The aborted op's device work is drained first: its prefetchers and
        combines have joined by the time a collective raises, but copies
        and kernels may still be queued on the card's streams, and none of
        them may land after the restore."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._proc_wt_snap is not None:
            self.worker_totals = [dict(d) for d in self._proc_wt_snap]
        for w in self.proc_ctx.my_workers():
            if op in self._proc_ckpt_store(w).steps():
                self._proc_restore_spill(w, op)
            else:
                # an adopted worker whose owner died before saving ckpt(op)
                # (no injected kill point can) keeps its files as left
                self.spills[w].attach()

    def _proc_resume_restore(self, resume_op: int) -> None:
        """Whole-job resume: put this rank's spills in the exact
        post-``resume_op`` state (``ProcContext.prepare_resume`` calls it
        before any op replays).

        Per worker, in order of preference: the checkpoint of op
        ``resume_op + 1`` (its pre-op content is the post-``resume_op``
        state; the files may hold that op's partial writes); the latest
        checkpoint of any other uncommitted op; else the spill files as
        the crashed incarnation last committed them.  A committed op's
        checkpoint is never restored: it would roll that op back.  A spill
        never loaded (a crash before the first op) has nothing to
        restore."""
        for w in self.proc_ctx.my_workers():
            spill = self.spills[w]
            steps = self._proc_ckpt_store(w).steps()
            target = None
            if resume_op + 1 in steps:
                target = resume_op + 1
            elif steps and max(steps) > resume_op:
                target = max(steps)
            if target is not None:
                self._proc_restore_spill(w, target)
            elif spill.on_disk():
                spill.attach()
            else:
                continue
            spill.reset_io_counters()

    def _proc_adopt_workers(self, adopted, in_op: bool) -> None:
        """Take over the listed workers after recovery re-planned them onto
        this rank: re-open their chunk shards (immutable files, fresh
        manifest validation) and rebuild their disk sources.  The engine
        whose op is being recovered restores the spill in the
        :meth:`_proc_rollback` that follows; any other registered engine
        (WCC runs two over one context) attaches the dead rank's spill
        files, consistent as of its last committed op."""
        for w in adopted:
            self.store.reopen_shard(w)
            self.dist_sources[w] = DiskChunkSource(
                self.store.shards[w], self._host_graph, self.fmts)
            if not in_op:
                self.spills[w].attach()

    def _proc_committed(self, rec: dict):
        """Whole-job resume: an op already committed by the crashed
        incarnation, rebuilt from its run-log record without running it
        (the spills were restored to the resume point, so the state views
        are exact; ``_sync_ooc_state`` must not run, it would overwrite
        them with the driver's initial arrays).  Returns (state, total,
        counters)."""
        self.worker_totals = [dict(d) for d in rec["wt"]]
        new_state = self._dist_state_views()
        self._ooc_last_state = new_state
        counters = {k: float(v) for k, v in rec["counters"].items()}
        return new_state, float(rec["total"]), counters

    def _proc_fast_forward_pe(self, rec: dict):
        """:meth:`_proc_committed` for a ProcessEdges record, whose
        post-op frontier it unpacks."""
        new_state, total, counters = self._proc_committed(rec)
        spec = self._host_graph.spec
        new_active = unpack_bools(rec["post_active"],
                                  (spec.num_partitions, spec.v_max))
        return new_state, new_active, total, counters

    def _sync_mq_state(self, state: State) -> None:
        """Multi-query twin of :meth:`_sync_ooc_state`: make the spill(s)
        authoritative for a [P, V, Q] state panel, flattened to the
        per-query ``{key}@q{j}`` columns with one ``active_q{j}`` bitmap
        each (on DIST_OOC each worker's spill takes its own rows).  Panels
        returned by multi-query OOC / DIST_OOC calls are recognized by
        identity and skipped; anything else loads as an unmeasured
        preprocessing sync."""
        if state is self._mq_last_state:
            return
        self._ooc_last_state = None
        nq = self.config.num_queries
        arrs = {k: _np(v) for k, v in state.items()}
        valid = _np(self._host_graph.vertex_valid)

        def load_one(spill, lo, hi):
            spill.load({f"{k}@q{j}": np.ascontiguousarray(v[lo:hi, :, j])
                        for k, v in arrs.items() for j in range(nq)})
            for j in range(nq):
                spill.write_bitmap(valid[lo:hi], name=f"active_q{j}")
            spill.reset_io_counters()

        if self._dist_ooc:
            for spill, parts in zip(self.spills, self.worker_parts):
                load_one(spill, parts[0], parts[-1] + 1)
            return
        load_one(self.spill, 0, self._host_graph.spec.num_partitions)

    def _check_measured(self, counters: dict, pairs=None) -> None:
        """Cross-check measured storage (and, for dist_ooc, network)
        traffic against the analytic model (the fully-out-of-core claim,
        enforced every call).  ``pairs`` overrides the executor's pair
        set: the mesh paths pass ``SHARDED_MEASURED_PAIRS`` to audit the
        collective's payload elements."""
        if not self.config.verify_io:
            return
        for mk, ak in (self._measured_pairs if pairs is None else pairs):
            if abs(float(counters[mk]) - float(counters[ak])) > 0.5:
                raise RuntimeError(
                    f"{self.config.executor} measured/model I/O mismatch: "
                    f"{mk}={counters[mk]:.1f} vs {ak}={counters[ak]:.1f}")

    # -- block_csr backend plumbing ----------------------------------------
    def _ensure_block(self):
        """Block tiles on the device (on a mesh, this rank's row only)."""
        if self._block is None:
            rows = [self.mesh.rank] if self._distributed else None
            bt, self._block_host = build_block_tiles(
                self._host_graph, tile=self.config.block_tile,
                device=self.device, rows=rows)
            self._block = bt.to(self.device)

    def free_value_tiles(self) -> None:
        """Drop the device value tiles of every slot function lowered so
        far (``block_csr``); the next ProcessEdges that needs one lowers
        it again.  The block structure stays.  Several algorithms run one
        after another on one engine keep one slot's tiles on the device
        if each frees its tiles before the next starts."""
        self._block_vals_cache.clear()

    def _probe_slot(self, slot_fn, monoid):
        """Cached affine-slot probe; warns once and returns None when the
        slot cannot be lowered to tiles (segment fallback)."""
        pkey = _executor.slot_probe_key(slot_fn, monoid)
        if pkey is not None and pkey in self._probe_cache:
            probe = self._probe_cache[pkey]
        else:
            probe = _executor.probe_slot_affine(
                slot_fn, monoid, self.graph.edge_data, self.graph.edge_valid)
            if pkey is not None:
                self._probe_cache[pkey] = probe
        if probe is None and not self._warned_slot_fallback:
            warnings.warn(
                "compute_backend='block_csr' requires slot(m, d) affine "
                "in m (constant slope for min/max); falling back to the "
                "segment backend for this slot function.")
            self._warned_slot_fallback = True
        return probe

    def _block_slot_values(self, slot_fn, monoid):
        """Probe + lower (slot_fn, monoid) to value tiles; returns
        (mode, a_const, device tensors) or None for segment fallback."""
        probe = self._probe_slot(slot_fn, monoid)
        if probe is None:
            return None
        self._ensure_block()
        key, mode, a_const, a, b = probe
        if key not in self._block_vals_cache:
            if self._distributed:        # the probe covers every row
                r = self.mesh.rank
                a, b = a[r:r + 1], b[r:r + 1]
            arrays_np = _executor.build_value_tiles(
                self._block_host, monoid, mode, a, b)
            self._block_vals_cache[key] = {
                k: torch.from_numpy(v).to(self.device)
                for k, v in arrays_np.items()}
        return mode, a_const, self._block_vals_cache[key]

    # -- ProcessVertices ----------------------------------------------------
    def process_vertices(self, state: State,
                         work_fn: Callable[[State, torch.Tensor], tuple],
                         active: torch.Tensor | None = None):
        """work_fn(state, global_id) -> (updates: State, ret per-vertex).

        Updates vertices in ``active`` (all valid, if None); returns
        (new_state, sum of ret over active vertices, counters).  Batches with
        no active vertex are skipped in the I/O model (paper §4.4)."""
        if self._ooc:
            return self._ooc_process_vertices(state, work_fn, active)
        if self._dist_ooc:
            return self._dist_process_vertices(state, work_fn, active)
        new_state, total, counters = self._pv_rows(state, work_fn, active)
        if self._distributed:
            counters, total = _executor.reduce_mesh_counters(
                self.mesh, counters, COUNTER_KEYS, total)
            total = total[0]
        return new_state, total, counters

    def _vertex_rows(self):
        """(vertex_valid, global_id) of the rows this engine computes on:
        every partition on LOCAL, this rank's row on a mesh."""
        if self._distributed:
            return self._garrs["vertex_valid"], self._garrs["global_id"]
        return self.graph.vertex_valid, self.global_id

    def _pv_rows(self, state, work_fn, active):
        """ProcessVertices on the in-memory rows (LOCAL's, or this mesh
        rank's), counters not yet summed over the mesh."""
        cfg = self.config
        vertex_valid, gid = self._vertex_rows()
        amask = vertex_valid if active is None else (active & vertex_valid)
        updates, ret = work_fn(state, gid)
        new_state = dict(state)
        for k, v in updates.items():
            new_state[k] = torch.where(amask, v, state[k])
        total = torch.sum(torch.where(amask, ret, 0).to(torch.float32))
        counters = zero_counters(self.device)
        if cfg.account_io:
            arrays_bytes = sum(v.element_size() for v in state.values())
            touched = batch_touched(amask, self.graph.spec.batch_size)
            counters["vertex_read_bytes"] = (
                touched * arrays_bytes + bitmap_model_bytes(amask))
            counters["vertex_write_bytes"] = touched * arrays_bytes
        return new_state, total, counters

    def _spill_process_vertices(self, spill, amask_rows, gid_rows, work_fn,
                                counters):
        """ProcessVertices against one spill (OOC's, or one dist_ooc
        worker's): measured bitmap and active-batch reads, ``work_fn`` on
        the device, measured write-back; accumulates the modeled and
        measured vertex-I/O counters and returns (the total of ``ret``,
        measured bytes read, measured bytes written)."""
        spec = self.graph.spec
        bs, b_cnt, v_max = spec.batch_size, spec.num_batches, spec.v_max
        sr0, sw0 = spill.bytes_read, spill.bytes_written
        spill.read_bitmap()                                     # measured
        batches = _executor._batch_any(amask_rows, bs, b_cnt)
        rstate_pad = spill.read(batches)                        # measured
        rstate = {k: v[:, :v_max] for k, v in rstate_pad.items()}
        updates, ret = work_fn(_executor._device_state(rstate, self.device),
                               gid_rows)
        spill.merge_write(rstate_pad, _executor._host_state(updates),
                          amask_rows, batches)                  # measured
        total = float(np.where(amask_rows, _np(ret).astype(np.float32),
                               0.0).sum())
        touched = float(batches.sum()) * bs
        arrays_bytes = spill.arrays_bytes()
        counters["vertex_read_bytes"] += (touched * arrays_bytes
                                          + float(spill.bitmap_nbytes()))
        counters["vertex_write_bytes"] += touched * arrays_bytes
        dr, dw = spill.bytes_read - sr0, spill.bytes_written - sw0
        counters["measured_vertex_read_bytes"] += dr
        counters["measured_vertex_write_bytes"] += dw
        return total, dr, dw

    def _ooc_process_vertices(self, state, work_fn, active):
        """ProcessVertices against the disk-resident vertex spill."""
        self._sync_ooc_state(state)
        vertex_valid = _np(self._host_graph.vertex_valid)
        amask = (vertex_valid if active is None
                 else _np(active).astype(bool) & vertex_valid)
        counters = {k: 0.0 for k in self.counter_keys}
        total, _, _ = self._spill_process_vertices(
            self.spill, amask, self.global_id, work_fn, counters)
        self._check_measured(counters)
        new_state = self.spill.state_views()
        self._ooc_last_state = new_state
        return new_state, total, counters

    def _dist_process_vertices(self, state, work_fn, active):
        """ProcessVertices with each worker serving only its own spill
        (:meth:`_dist_pv`); in process mode one recoverable op over this
        rank's workers."""
        ctx = self.proc_ctx
        if ctx is not None:
            rec = ctx.resume_take("pv")
            if rec is not None:
                return self._proc_committed(rec)
        self._sync_ooc_state(state)
        vertex_valid = _np(self._host_graph.vertex_valid)
        amask = (vertex_valid if active is None
                 else _np(active).astype(bool) & vertex_valid)

        def body(w, lo, hi, cw):
            return self._spill_process_vertices(
                self.spills[w], amask[lo:hi], self.global_id[lo:hi],
                work_fn, cw)

        if ctx is None:
            counters, total = self._dist_pv(body)
        else:
            def record(out):
                return {"kind": "pv", "total": float(out[1]),
                        "counters": {k: float(v)
                                     for k, v in out[0].items()},
                        "wt": [dict(d) for d in self.worker_totals]}

            counters, total = ctx.recoverable(
                self, lambda: self._dist_pv(body, ctx), record=record)
        new_state = self._dist_state_views()
        self._ooc_last_state = new_state
        return new_state, total, counters

    def _dist_pv(self, body, ctx=None):
        """The DIST_OOC ProcessVertices loop: ``body(w, lo, hi, cw)`` serves
        worker w's spill (partitions ``lo:hi``) under the compute token,
        accumulating into the worker's private counter dict ``cw``, and
        returns (its total or per-query totals, measured bytes read,
        measured bytes written).  The workers run on the ProcessEdges
        phase pool when ``parallel_workers`` is on; their dicts and totals
        reduce in worker order after the join (parallel == sequential, bit
        for bit).  With ``ctx`` (process mode) only this rank's workers
        run, and every worker's results are gathered from its owner before
        the same reduction.  Returns (the audited counters, the totals'
        sum)."""
        token = threading.Lock() if self.config.parallel_workers else None
        tok = token_ctx(token)

        def pv_task(w):
            t0 = time.perf_counter()
            parts = self.worker_parts[w]
            cw = dict.fromkeys(
                ("vertex_read_bytes", "vertex_write_bytes",
                 "measured_vertex_read_bytes",
                 "measured_vertex_write_bytes"), 0.0)
            with tok:
                t, dr, dw = body(w, parts[0], parts[-1] + 1, cw)
            self.worker_totals[w]["disk_bytes"] += dr + dw
            return cw, t, time.perf_counter() - t0

        workers = self._local_workers()
        out = _executor.run_worker_pool(
            [functools.partial(pv_task, w) for w in workers],
            self.config.parallel_workers, pool=self.worker_pool)
        if ctx is not None:
            rows = ctx.gather_by_worker(
                {w: o + (dict(self.worker_totals[w]),)
                 for w, o in zip(workers, out)})
            out = []
            for w, (cw, t, dt, wt) in enumerate(rows):
                self.worker_totals[w] = dict(wt)
                out.append((cw, t, dt))
        counters = reduce_worker_counters(
            {k: 0.0 for k in self.counter_keys}, [cw for cw, _, _ in out])
        total = 0.0
        for w, (_, t, dt) in enumerate(out):
            total = total + t
            self.worker_times[w]["pv_s"] += dt
        self._check_measured(counters)
        return counters, total

    # -- ProcessEdges ---------------------------------------------------------
    def process_edges(self, state: State,
                      signal_fn: Callable[[State, torch.Tensor], torch.Tensor],
                      slot_fn: Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor],
                      monoid: Monoid,
                      apply_fn: Callable,
                      active: torch.Tensor | None = None):
        """One ProcessEdges call.

        signal_fn(state, global_id) -> per-vertex message value
        slot_fn(msg, edge_data)     -> per-edge contribution
        apply_fn(state, agg, has_msg, global_id)
            -> (updates: State, new_active bool, ret per-vertex)
        ``updates``/``ret`` take effect only where a message arrived
        (has_msg); combine with ProcessVertices for unconditional updates.
        Returns (new_state, new_active, total_ret, counters)."""
        backend = self.config.compute_backend
        if backend not in ("segment", "block_csr"):
            raise ValueError(f"unknown compute_backend: {backend!r}")
        if self._ooc or self._dist_ooc:
            return self._ooc_process_edges(state, signal_fn, slot_fn,
                                           monoid, apply_fn, active, backend)
        mode_meta, vals = None, None
        if backend == "block_csr":
            lowered = self._block_slot_values(slot_fn, monoid)
            if lowered is None:
                backend = "segment"
            else:
                mode, a_const, vals = lowered
                mode_meta = (mode, a_const)
        # Cache the built step per algorithm: fresh lambdas each iteration
        # share code identity, so the step is built once per algorithm.
        keys = tuple(_executor.fn_code_key(f)
                     for f in (signal_fn, slot_fn, apply_fn))
        cache_key = None
        if all(k is not None for k in keys):
            cache_key = keys + (monoid.name, backend, mode_meta,
                                active is not None)
        fn = self._pe_cache.get(cache_key) if cache_key is not None else None
        make = (_executor.make_sharded_pe if self._distributed
                else _executor.make_local_pe)
        if fn is None:
            fn = make(self, signal_fn, slot_fn, monoid, apply_fn, backend,
                      mode_meta)
            if cache_key is not None:
                self._pe_cache[cache_key] = fn
        bt = self._block if backend == "block_csr" else None
        if not self._distributed:
            return fn(state, active, self.graph, self.fmts, self.global_id,
                      bt, vals)
        out = fn(state, active, self._garrs, bt, vals)
        self._check_measured(out[3], pairs=SHARDED_MEASURED_PAIRS)
        return out

    def _ooc_process_edges(self, state, signal_fn, slot_fn, monoid,
                           apply_fn, active, backend):
        """OOC / DIST_OOC realization of :meth:`process_edges` (DESIGN.md
        §6, §7): the step of ``executor.make_ooc_pe`` or
        ``executor.make_dist_ooc_pe`` against the spill(s), then the
        measured-vs-model audit.  The returned state is the spills'
        zero-copy host views; ``new_active`` is a host bool array."""
        mode_meta = None
        if backend == "block_csr":
            probe = self._probe_slot(slot_fn, monoid)
            if probe is None:
                backend = "segment"
            else:
                _, mode, a_const, _, _ = probe
                mode_meta = (mode, a_const)
        keys = tuple(_executor.fn_code_key(f)
                     for f in (signal_fn, slot_fn, apply_fn))
        cache_key = None
        if all(k is not None for k in keys):
            cache_key = (self.config.executor,) + keys + (
                monoid.name, backend, mode_meta)
        fn = self._pe_cache.get(cache_key) if cache_key is not None else None
        if fn is None:
            make = (_executor.make_dist_ooc_pe if self._dist_ooc
                    else _executor.make_ooc_pe)
            fn = make(self, signal_fn, slot_fn, monoid, apply_fn, backend,
                      mode_meta)
            if cache_key is not None:
                self._pe_cache[cache_key] = fn
        ctx = self.proc_ctx
        if ctx is None:
            self._sync_ooc_state(state)
            new_state, new_active, total, counters = fn(active)
        else:
            # one ProcessEdges call = one fault-plan index = one
            # recoverable op (checkpoint, run, commit or roll back)
            ctx.pe_seq += 1
            if ctx.injector is not None:
                ctx.injector.plan.validate_for_monoid(monoid.name)
            rec = ctx.resume_take("pe")
            if rec is not None:
                return self._proc_fast_forward_pe(rec)
            self._sync_ooc_state(state)

            def record(out):
                # the commit gathers left the full [W] worker_totals and
                # new_active on every rank: one rank's record rebuilds
                # the op
                return {"kind": "pe", "total": float(out[2]),
                        "counters": {k: float(v)
                                     for k, v in out[3].items()},
                        "wt": [dict(d) for d in self.worker_totals],
                        "post_active": pack_bools(out[1])}

            new_state, new_active, total, counters = ctx.recoverable(
                self, lambda: fn(active), record=record)
        self._check_measured(counters)
        self._ooc_last_state = new_state
        return new_state, new_active, total, counters

    # -- multi-query (DESIGN.md §11) -----------------------------------------
    def _check_mq_state(self, state, active) -> None:
        nq = self.config.num_queries
        for k, v in state.items():
            if v.ndim != 3 or tuple(v.shape)[-1] != nq:
                raise ValueError(
                    "multi-query state arrays must be [P, V, "
                    f"num_queries={nq}] panels; state[{k!r}] has shape "
                    f"{tuple(v.shape)}")
        if active is not None and (active.ndim != 3
                                   or tuple(active.shape)[-1] != nq):
            raise ValueError(
                f"multi-query active must be a [P, V, num_queries={nq}] "
                f"panel; got shape {tuple(active.shape)}")

    def _on_device(self, x):
        """A LOCAL panel (tensor or array) as a tensor on the engine's
        device; OOC results come back as host arrays."""
        return torch.as_tensor(x).to(self.device)

    def process_edges_multi(self, state: State, *,
                            signal_fn: Callable, slot_fn: Callable,
                            monoid: Monoid, apply_fn: Callable,
                            active=None):
        """One ProcessEdges call serving ``num_queries`` concurrent
        queries through a single selective pass (DESIGN.md §11).

        ``state`` holds [P, V, Q] panels and ``active`` (if given) a
        [P, V, Q] boolean panel; the per-vertex callbacks are the
        unchanged single-query ``signal_fn`` / ``slot_fn`` / ``apply_fn``,
        applied per query column.  Each query's column of the result is
        bit-identical to the solo ``process_edges`` run for that query;
        the chunk stream and the seeks are paid once over the union
        frontier.  Returns (new_state panels, new_active [P, V, Q],
        totals [Q], counters)."""
        cfg = self.config
        nq = cfg.num_queries
        self._check_mq_state(state, active)
        if not cfg.enable_adaptive_formats:
            raise ValueError(
                "process_edges_multi requires enable_adaptive_formats: "
                "the union-frontier chunk price is the adaptive min-bytes "
                "choice (DESIGN.md §11)")
        backend = cfg.compute_backend
        if backend not in ("segment", "block_csr"):
            raise ValueError(f"unknown compute_backend: {backend!r}")
        if self._ooc or self._dist_ooc:
            return self._mq_ooc_process_edges(state, signal_fn, slot_fn,
                                              monoid, apply_fn, active,
                                              backend)
        if backend == "block_csr":
            raise ValueError(
                "multi-query block_csr runs on the streamed executors "
                "(ooc, dist_ooc), where one decoded chunk feeds the Q-panel "
                "kernel; LOCAL / SHARD_MAP multi-query supports "
                "compute_backend='segment'")
        keys = tuple(_executor.fn_code_key(f)
                     for f in (signal_fn, slot_fn, apply_fn))
        cache_key = None
        if all(k is not None for k in keys):
            cache_key = ("mq",) + keys + (monoid.name, nq)
        fn = self._pe_cache.get(cache_key) if cache_key is not None else None
        make = (_multiquery.make_sharded_pe_mq if self._distributed
                else _multiquery.make_local_pe_mq)
        if fn is None:
            fn = make(self, signal_fn, slot_fn, monoid, apply_fn, nq)
            if cache_key is not None:
                self._pe_cache[cache_key] = fn
        state = {k: self._on_device(v) for k, v in state.items()}
        active = None if active is None else self._on_device(active)
        if not self._distributed:
            return fn(state, active, self.graph, self.fmts, self.global_id)
        out = fn(state, active, self._garrs)
        self._check_measured(out[3], pairs=SHARDED_MEASURED_PAIRS)
        return out

    def _mq_ooc_process_edges(self, state, signal_fn, slot_fn, monoid,
                              apply_fn, active, backend):
        """OOC / DIST_OOC realization of :meth:`process_edges_multi`: the
        step of ``multiquery.make_ooc_pe_mq`` or
        ``multiquery.make_dist_ooc_pe_mq`` against the spill(s), then the
        measured-vs-model audit.  Panels and ``new_active`` come back as
        host arrays."""
        mode_meta = None
        if backend == "block_csr":
            probe = self._probe_slot(slot_fn, monoid)
            if probe is None:
                backend = "segment"
            else:
                _, mode, a_const, _, _ = probe
                mode_meta = (mode, a_const)
        nq = self.config.num_queries
        keys = tuple(_executor.fn_code_key(f)
                     for f in (signal_fn, slot_fn, apply_fn))
        cache_key = None
        if all(k is not None for k in keys):
            cache_key = ("mq", self.config.executor) + keys + (
                monoid.name, backend, mode_meta, nq)
        fn = self._pe_cache.get(cache_key) if cache_key is not None else None
        if fn is None:
            make = (_multiquery.make_dist_ooc_pe_mq if self._dist_ooc
                    else _multiquery.make_ooc_pe_mq)
            fn = make(self, signal_fn, slot_fn, monoid, apply_fn, backend,
                      mode_meta, nq)
            if cache_key is not None:
                self._pe_cache[cache_key] = fn
        self._sync_mq_state(state)
        new_state, new_active, totals, counters = fn(active)
        self._check_measured(counters)
        self._mq_last_state = new_state
        return new_state, new_active, totals, counters

    def process_vertices_multi(self, state: State, work_fn: Callable,
                               active=None):
        """Multi-query ProcessVertices: ``work_fn(state, global_id)`` runs
        per query column, updating vertices in that query's ``active``
        column (all valid, if None).  A query with an empty active column
        costs zero vertex I/O (physically skipped on OOC).  Returns
        (new_state, totals [Q], counters)."""
        nq = self.config.num_queries
        self._check_mq_state(state, active)
        if self._ooc:
            return self._mq_ooc_process_vertices(state, work_fn, active)
        if self._dist_ooc:
            return self._mq_dist_process_vertices(state, work_fn, active)
        state = {k: self._on_device(v) for k, v in state.items()}
        active = None if active is None else self._on_device(active)
        vertex_valid, _ = self._vertex_rows()
        counters = zero_counters(self.device)
        new_cols, totals, per_query, alive = {k: [] for k in state}, [], [], []
        for j in range(nq):
            active_j = None if active is None else active[..., j]
            ns_j, total_j, c_j = self._pv_rows(
                {k: v[..., j] for k, v in state.items()}, work_fn, active_j)
            amask_j = (vertex_valid if active_j is None
                       else active_j & vertex_valid)
            per_query.append(c_j)
            alive.append(torch.sum(amask_j, dtype=torch.float32))
            for k in state:
                new_cols[k].append(ns_j[k])
            totals.append(total_j)
        # The bitmap term is shape-static: gate each query's I/O on its
        # aliveness (on a mesh, alive on any rank) so a converged query
        # prices zero.
        alive = torch.stack(alive)
        if self._distributed:
            alive = self.mesh.pmax(alive.cpu())
        for j, c_j in enumerate(per_query):
            alive_f = (alive[j] > 0).to(torch.float32).to(self.device)
            for k, v in c_j.items():
                counters[k] += alive_f * v
        new_state = {k: torch.stack(cols, dim=-1)
                     for k, cols in new_cols.items()}
        totals = torch.stack(totals)
        if self._distributed:
            counters, totals = _executor.reduce_mesh_counters(
                self.mesh, counters, COUNTER_KEYS, totals)
        return new_state, totals, counters

    def _mq_amasks(self, active):
        vertex_valid = _np(self._host_graph.vertex_valid)
        return [(vertex_valid if active is None
                 else _np(active[..., j]).astype(bool) & vertex_valid)
                for j in range(self.config.num_queries)]

    def _mq_spill_process_vertices(self, spill, amask_rows, gid_rows,
                                   work_fn, base, alive, counters):
        """One spill's multi-query ProcessVertices body (OOC's, or one
        dist_ooc worker's): each alive query's bitmap and active batches
        are read, computed on the device, and merged back into its own
        ``{key}@q{j}`` columns (dead queries cost zero bytes, measured and
        modeled alike).  Returns (the per-query totals, measured bytes
        read, measured bytes written)."""
        spec = self.graph.spec
        bs, b_cnt, v_max = spec.batch_size, spec.num_batches, spec.v_max
        sr0, sw0 = spill.bytes_read, spill.bytes_written
        totals = np.zeros(self.config.num_queries, np.float64)
        for j in alive:
            keys_j = _multiquery.mq_query_keys(base, j)
            spill.read_bitmap(name=f"active_q{j}")              # measured
            batches = _executor._batch_any(amask_rows[j], bs, b_cnt)
            rstate_pad = spill.read(batches, keys=keys_j)       # measured
            rstate = {bk: rstate_pad[f"{bk}@q{j}"][:, :v_max]
                      for bk in base}
            updates, ret = work_fn(
                _executor._device_state(rstate, self.device), gid_rows)
            spill.merge_write(
                rstate_pad, {f"{bk}@q{j}": v for bk, v in
                             _executor._host_state(updates).items()},
                amask_rows[j], batches)                         # measured
            totals[j] = float(np.where(amask_rows[j],
                                       _np(ret).astype(np.float32),
                                       0.0).sum())
            touched = float(batches.sum()) * bs
            ab_j = spill.arrays_bytes(keys_j)
            counters["vertex_read_bytes"] += (
                touched * ab_j + float(spill.bitmap_nbytes()))
            counters["vertex_write_bytes"] += touched * ab_j
        dr, dw = spill.bytes_read - sr0, spill.bytes_written - sw0
        counters["measured_vertex_read_bytes"] += dr
        counters["measured_vertex_write_bytes"] += dw
        return totals, dr, dw

    def _mq_ooc_process_vertices(self, state, work_fn, active):
        """:meth:`process_vertices_multi` against the disk-resident
        per-query spill columns."""
        self._sync_mq_state(state)
        nq = self.config.num_queries
        amask = self._mq_amasks(active)
        alive = [j for j in range(nq) if amask[j].any()]
        counters = {k: 0.0 for k in self.counter_keys}
        base = _multiquery.mq_base_names(self.spill)
        totals, _, _ = self._mq_spill_process_vertices(
            self.spill, amask, self.global_id, work_fn, base, alive,
            counters)
        self._check_measured(counters)
        new_state = _multiquery.mq_state_views(self.spill, base, nq)
        self._mq_last_state = new_state
        return new_state, totals, counters

    def _mq_dist_process_vertices(self, state, work_fn, active):
        """:meth:`process_vertices_multi` with each worker serving only its
        own spill's per-query columns (:meth:`_dist_pv`)."""
        self._sync_mq_state(state)
        nq = self.config.num_queries
        amask = self._mq_amasks(active)
        alive = [j for j in range(nq) if amask[j].any()]
        base = _multiquery.mq_base_names(self.spills[0])
        counters, totals = self._dist_pv(
            lambda w, lo, hi, cw: self._mq_spill_process_vertices(
                self.spills[w], [m[lo:hi] for m in amask],
                self.global_id[lo:hi], work_fn, base, alive, cw))
        new_state = _multiquery.dist_mq_state_views(self.spills, base, nq)
        self._mq_last_state = new_state
        return new_state, totals, counters
