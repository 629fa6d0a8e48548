"""Storage tier for fully-out-of-core execution (paper §4.1–§4.4) — the port
of ``repro.core.chunkstore`` for one host.

Edge chunks and vertex arrays live on disk, the executor issues only the
reads the selective schedule marks necessary, and every request is counted
in **measured** bytes that the engine cross-checks against the analytic
counters (DESIGN.md §6).  The on-disk formats are the reference's, byte for
byte: a store or spill written by either package is read by the other.

* :class:`ChunkStore` — every (src partition ``p``, dst batch ``k``) edge
  chunk of destination partition ``q`` serialized into ``edges_q{q}.bin``
  as ``[DCSR pairs | delta-varint pairs | CSR idx (when accepted) | dst
  residues | data]`` (compressed layout, DESIGN.md §9; or the legacy
  ``[pairs | idx | (dst, data) payload]`` with ``compression=False``), with
  the format decision baked into an atomically written JSON manifest
  (version 4: per-section CRC32s and a manifest self-checksum).
* :class:`DeviceChunkDecoder` — the decode of a prefetch item's
  compressed chunks on the engine's device, staged in one page-locked
  buffer (:class:`StagingRing`) and decoded by the two launches of
  :mod:`repro_torch.kernels.chunk_decode`; the columns stay there for the
  combine.
* :class:`VertexSpill` — per-batch disk residence for the vertex state
  arrays plus the active bitmap, with per-batch CRC32 sidecars.
* :class:`ChunkPrefetcher` — a thread that reads (and decodes) the chunks
  of dst-batch *i+1* while the executor combines dst-batch *i*, its
  copies and kernels on a CUDA stream of its own.

The ChunkSource contract (DESIGN.md §6): :class:`HBMChunkSource` serves the
LOCAL executor from device tensors, :class:`DiskChunkSource` the OOC
executor from a store.  Dispatch metadata and per-chunk format stats stay
memory-resident (host numpy) in both — control state, not bulk data.

* :class:`ShardedChunkStore` — W per-worker chunk stores under one root
  (``ChunkStore.build_sharded``), one contiguous block of destination
  partitions each, for the distributed out-of-core executor.

The spill's recovery hooks (:meth:`VertexSpill.attach`,
:meth:`VertexSpill.on_disk`) and :meth:`ShardedChunkStore.reopen_shard`
serve process mode: a rank that adopts a dead rank's worker re-opens its
shard and attaches its spill files in place (DESIGN.md §13).
"""
from __future__ import annotations

import dataclasses
import json
import mmap
import os
import queue
import threading
import time
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.formats import _np
from repro_torch.utils import (IntegrityError, atomic_write_json, ceil_div,
                               crc32, json_crc, resolve_device, token_ctx)

EDGE_DT = np.dtype([("dst", "<i4"), ("data", "<f4")])   # 8 B per edge
PAIR_DT = np.dtype([("src", "<i4"), ("idx", "<i4")])    # 8 B per DCSR entry
MANIFEST_NAME = "manifest.json"
SHARD_MANIFEST_NAME = "shards.json"
# v4: per-chunk section CRC32s (``chunk_crcs``, aligned row-for-row with
# ``chunks``) and a manifest self-checksum (``manifest_crc``).  Older
# versions are rejected with an error naming both versions.
MANIFEST_VERSION = 4

# Section slots of a chunk's CRC row, in chunk_crcs order.
CRC_PAIRS, CRC_DELTA, CRC_IDX, CRC_PAYLOAD = range(4)
_CRC_SECTION_NAMES = ("dcsr-pairs", "pair-delta", "csr-idx", "payload")

# Per-chunk representation codes, as they appear in read schedules.
REP_DCSR = 0        # raw (src, idx) pair section
REP_CSR = 1         # CSR idx section (pruned-dst payload when compressed)
REP_DCSR_DELTA = 2  # delta-varint pair section (compressed stores only)


def manifest_self_crc(manifest: dict) -> int:
    """CRC32 of a manifest dict, excluding its own ``manifest_crc`` field."""
    return json_crc({k: v for k, v in manifest.items()
                     if k != "manifest_crc"})


class ChunkStoreError(RuntimeError):
    """A chunk store on disk is unreadable or structurally broken (missing /
    truncated manifest, missing edge files).  Always names the path."""


def bitmap_nbytes(num_rows: int, num_cols: int) -> int:
    """Exact on-disk size of a [rows, cols] bitmap packed per row."""
    return num_rows * ceil_div(num_cols, 8)


# ---------------------------------------------------------------------------
# ChunkStore: edge chunks on disk
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _ChunkLayout:
    """Per-destination chunk directory decoded from the manifest."""
    offset: np.ndarray     # int64 [P, B], -1 for empty chunks
    nnz: np.ndarray        # int64 [P, B] DCSR pair count
    edges: np.ndarray      # int64 [P, B] payload entries
    has_csr: np.ndarray    # bool  [P, B]
    pair_nb: np.ndarray    # int64 [P, B] delta-varint pair section bytes
    dstv_nb: np.ndarray    # int64 [P, B] dst residue section bytes
    crc: np.ndarray        # uint32 [P, B, 4] per-section CRC32s


class ChunkStore:
    """Disk-resident (src partition, dst batch) edge chunks + manifest.

    File layout per destination partition q (``edges_q{q}.bin``): chunks in
    (p, k) order, each nonempty chunk one contiguous region.
    **Compressed** stores (the default)::

        [DCSR pairs: nnz * 8 B] [delta-varint pairs: pair_nb B]
        [CSR idx: (|V_p| + 1) * 4 B, if has_csr]
        [dst residues: dstv_nb B] [data: E * 4 B  (f32, CSR-by-source order)]

    so a read picks ONE index section plus the shared columnar payload:
    raw-pair DCSR = ``dcsr_bytes``, delta-varint DCSR = ``dcsr_delta_bytes``,
    pruned-dst CSR = ``csr_bytes`` of the analytic model, byte for byte.
    **Uncompressed** stores keep the legacy layout::

        [DCSR pairs: nnz * 8 B] [CSR idx, if has_csr]
        [payload: E * 8 B  ((dst, data) per edge)]

    whose reads equal the ``*_raw`` model twins.  Reads are mmap slices;
    the measured counters (``chunks_read`` / ``bytes_read``) are kept under
    a lock so the prefetch thread can read concurrently.
    """

    def __init__(self, root: str, manifest: dict):
        self.root = root
        self.manifest = manifest
        p_cnt = manifest["num_partitions"]
        b_cnt = manifest["num_batches"]
        self.num_partitions = p_cnt
        self.num_batches = b_cnt
        self.part_sizes = np.asarray(manifest["partition_sizes"], np.int64)
        self.compression = bool(manifest.get("compression", False))
        self.values_elided = bool(manifest.get("values_elided", False))
        self.batch_size = int(manifest["batch_size"])
        self.partitions = tuple(manifest.get("partitions", range(p_cnt)))
        owned = set(self.partitions)
        self._layout: list[_ChunkLayout | None] = []
        for q in range(p_cnt):
            if q not in owned:
                self._layout.append(None)
                continue
            offset = np.full((p_cnt, b_cnt), -1, np.int64)
            nnz = np.zeros((p_cnt, b_cnt), np.int64)
            edges = np.zeros((p_cnt, b_cnt), np.int64)
            has_csr = np.zeros((p_cnt, b_cnt), bool)
            pair_nb = np.zeros((p_cnt, b_cnt), np.int64)
            dstv_nb = np.zeros((p_cnt, b_cnt), np.int64)
            crc = np.zeros((p_cnt, b_cnt, 4), np.uint32)
            for row, crow in zip(manifest["chunks"][q],
                                 manifest["chunk_crcs"][q]):
                p, k, off, nz, ne, hc, pnb, vnb = row
                offset[p, k] = off
                nnz[p, k] = nz
                edges[p, k] = ne
                has_csr[p, k] = bool(hc)
                pair_nb[p, k] = pnb
                dstv_nb[p, k] = vnb
                crc[p, k] = crow
            self._layout.append(_ChunkLayout(offset, nnz, edges, has_csr,
                                             pair_nb, dstv_nb, crc))
        self._mm: dict[int, mmap.mmap] = {}
        self._device_decoders: dict = {}
        self._lock = threading.Lock()
        self.chunks_read = 0
        self.bytes_read = 0

    def _layout_of(self, q: int) -> _ChunkLayout:
        lay = self._layout[q]
        if lay is None:
            raise ChunkStoreError(
                f"destination partition {q} is not owned by the chunk store "
                f"at {self.root} (owns {list(self.partitions)})")
        return lay

    def nonempty_chunks(self):
        """Every stored chunk as (q, p, k), in file order."""
        for q in self.partitions:
            lay = self._layout_of(q)
            for p, k in zip(*np.nonzero(lay.offset >= 0)):
                yield q, int(p), int(k)

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, g, fmts, root: str,
              partitions: Sequence[int] | None = None,
              compression: bool = True) -> "ChunkStore":
        """Preprocessing: serialize every nonempty chunk; commit manifest.

        ``g`` / ``fmts`` are the port's DistGraph / ChunkFormats (tensors on
        any device).  ``partitions`` restricts the store to a subset of
        destination partitions; by default it owns all of them.
        ``compression`` selects the layout and must match the engine's
        ``EngineConfig.compression`` (validated at Engine construction).

        Encoding is batched per destination partition: runs, pair deltas
        and dst residues of every chunk of ``q`` are computed and
        varint-encoded in one whole-partition numpy pass (per-value codecs
        concatenate byte-exactly), and the per-chunk loop only slices and
        writes.  With ``fmts.values_elided`` (unweighted graph, compressed
        layout) the uniform f32 data column is dropped from every chunk
        and re-synthesized at decode (DESIGN.md §10)."""
        spec = g.spec
        p_cnt, b_cnt = spec.num_partitions, spec.num_batches
        bs = spec.batch_size
        part_sizes = spec.partition_sizes()
        owned = (list(range(p_cnt)) if partitions is None
                 else [int(q) for q in partitions])
        os.makedirs(root, exist_ok=True)
        chunk_ptr = _np(g.chunk_ptr)
        src_l = _np(g.edge_src_local)
        dst_l = _np(g.edge_dst_local)
        data = _np(g.edge_data)
        has_csr = _np(fmts.has_csr)
        elide = bool(compression) and bool(getattr(fmts, "values_elided",
                                                   False))

        chunks_meta: dict[int, list] = {}
        chunks_crc: dict[int, list] = {}
        for q in owned:
            meta_q = []
            crc_q = []
            off = 0
            n_q = int(chunk_ptr[q, -1, -1])
            # --- whole-partition pass: runs + delta streams for all chunks
            flat = np.concatenate(
                [chunk_ptr[q, :, :-1].reshape(-1),
                 chunk_ptr[q, -1, -1:]]).astype(np.int64)
            widths = np.diff(flat)                       # [P*B] chunk edges
            src_q = src_l[q, :n_q].astype(np.int64)
            dst_q = dst_l[q, :n_q].astype(np.int64)
            cid = np.repeat(np.arange(widths.shape[0]), widths)
            is_start = np.empty(n_q, bool)
            if n_q:
                is_start[0] = True
                is_start[1:] = ((src_q[1:] != src_q[:-1])
                                | (cid[1:] != cid[:-1]))
            sidx = np.flatnonzero(is_start)              # global run starts
            run_cid = cid[sidx]
            first = np.empty(sidx.size, bool)
            if sidx.size:
                first[0] = True
                first[1:] = run_cid[1:] != run_cid[:-1]
            rel = sidx - flat[run_cid]                   # chunk-relative
            pairs_all = np.empty(sidx.size, PAIR_DT)
            pairs_all["src"] = src_q[sidx]
            pairs_all["idx"] = rel
            runs_per_chunk = np.bincount(run_cid,
                                         minlength=widths.shape[0])
            run_ptr = np.concatenate([[0], np.cumsum(runs_per_chunk)])
            if compression:
                # pair deltas (per chunk: diff prepend 0 on (src, rel))
                prev_src = np.empty(sidx.size, np.int64)
                prev_rel = np.empty(sidx.size, np.int64)
                if sidx.size:
                    prev_src[0] = prev_rel[0] = 0
                    prev_src[1:] = src_q[sidx[:-1]]
                    prev_rel[1:] = rel[:-1]
                pair_vals = np.empty(2 * sidx.size, np.int64)
                pair_vals[0::2] = np.where(first, src_q[sidx],
                                           src_q[sidx] - prev_src)
                pair_vals[1::2] = np.where(first, rel, rel - prev_rel)
                pair_vals = pair_vals.astype(np.uint64)
                pair_stream = codec.varint_encode(pair_vals)
                pvnb = codec.varint_sizes(pair_vals)
                pnb_chunk = np.bincount(
                    np.repeat(run_cid, 2), weights=pvnb.astype(np.float64),
                    minlength=widths.shape[0]).astype(np.int64)
                pair_off = np.concatenate([[0], np.cumsum(pnb_chunk)])
                # dst residues (per run: delta restart against batch base)
                res = np.empty(n_q, np.int64)
                if n_q:
                    res[1:] = dst_q[1:] - dst_q[:-1]
                    res[sidx] = dst_q[sidx] - (cid[sidx] % b_cnt) * bs
                res = res.astype(np.uint64)
                dst_stream = codec.varint_encode(res)
                dnb_chunk = np.bincount(
                    cid, weights=codec.varint_sizes(res).astype(np.float64),
                    minlength=widths.shape[0]).astype(np.int64)
                dst_off = np.concatenate([[0], np.cumsum(dnb_chunk)])
            with open(os.path.join(root, f"edges_q{q}.bin"), "wb") as f:
                for p in range(p_cnt):
                    v_src = int(part_sizes[p])
                    for k in range(b_cnt):
                        c = p * b_cnt + k
                        s, e = int(flat[c]), int(flat[c + 1])
                        if e <= s:
                            continue
                        pairs = pairs_all[run_ptr[c]:run_ptr[c + 1]]
                        f.write(pairs.tobytes())
                        nbytes = pairs.nbytes
                        pnb = vnb = 0
                        crc_row = [crc32(pairs), 0, 0, 0]
                        if compression:
                            pd = pair_stream[
                                pair_off[c]:pair_off[c + 1]].tobytes()
                            f.write(pd)
                            crc_row[CRC_DELTA] = crc32(pd)
                            pnb = int(pnb_chunk[c])
                            nbytes += pnb
                        if has_csr[q, p, k]:
                            idx = np.zeros(v_src + 1, np.int32)
                            np.add.at(idx, src_l[q, s:e] + 1, 1)
                            idx = np.cumsum(idx, dtype=np.int32)
                            f.write(idx.tobytes())
                            crc_row[CRC_IDX] = crc32(idx)
                            nbytes += idx.nbytes
                        if compression:
                            # Columnar payload: dst residues (+ f32 data,
                            # unless elided).
                            dv = dst_stream[
                                dst_off[c]:dst_off[c + 1]].tobytes()
                            f.write(dv)
                            pay_crc = crc32(dv)
                            vnb = int(dnb_chunk[c])
                            nbytes += vnb
                            if not elide:
                                db = np.ascontiguousarray(
                                    data[q, s:e], "<f4").tobytes()
                                f.write(db)
                                pay_crc = crc32(db, pay_crc)
                                nbytes += (e - s) * 4
                            crc_row[CRC_PAYLOAD] = pay_crc
                        else:
                            payload = np.empty(e - s, EDGE_DT)
                            payload["dst"] = dst_l[q, s:e]
                            payload["data"] = data[q, s:e]
                            f.write(payload.tobytes())
                            crc_row[CRC_PAYLOAD] = crc32(payload)
                            nbytes += payload.nbytes
                        meta_q.append([p, k, off, int(pairs.shape[0]),
                                       int(e - s), bool(has_csr[q, p, k]),
                                       int(pnb), int(vnb)])
                        crc_q.append(crc_row)
                        off += nbytes
            chunks_meta[q] = meta_q
            chunks_crc[q] = crc_q

        manifest = dict(
            version=MANIFEST_VERSION,
            compression=bool(compression),
            values_elided=elide,
            num_partitions=p_cnt,
            num_batches=b_cnt,
            v_max=spec.v_max,
            batch_size=spec.batch_size,
            partition_sizes=[int(x) for x in part_sizes],
            inflate_ratio=fmts.inflate_ratio,
            gamma=fmts.gamma,
            partitions=owned,
            chunks=[chunks_meta.get(q, []) for q in range(p_cnt)],
            chunk_crcs=[chunks_crc.get(q, []) for q in range(p_cnt)],
        )
        manifest["manifest_crc"] = manifest_self_crc(manifest)
        atomic_write_json(os.path.join(root, MANIFEST_NAME), manifest)
        return cls(root, manifest)

    @classmethod
    def build_sharded(cls, g, fmts, root: str, num_workers: int,
                      compression: bool = True) -> "ShardedChunkStore":
        """Preprocessing for the dist_ooc executor: W worker shards, each a
        full :class:`ChunkStore` with its own root (``root/w{w}/``) holding
        the edge chunks of the contiguous block of ``P / W`` destination
        partitions it owns, plus a top-level ``shards.json`` recording the
        topology.  ``num_workers`` must divide ``num_partitions`` (raises
        ValueError otherwise).  Hand the result to ``Engine(...,
        EngineConfig(executor="dist_ooc", num_workers=W), store=...)``;
        each worker then reads only its own root, and reading an unowned
        destination raises :class:`ChunkStoreError`."""
        p_cnt = g.spec.num_partitions
        if num_workers < 1 or p_cnt % num_workers != 0:
            raise ValueError(
                f"num_workers={num_workers} must divide "
                f"num_partitions={p_cnt} (contiguous ownership blocks)")
        per = p_cnt // num_workers
        shards = [cls.build(g, fmts, os.path.join(root, f"w{w}"),
                            partitions=range(w * per, (w + 1) * per),
                            compression=compression)
                  for w in range(num_workers)]
        smani = dict(version=MANIFEST_VERSION, num_workers=num_workers,
                     num_partitions=p_cnt)
        smani["manifest_crc"] = manifest_self_crc(smani)
        atomic_write_json(os.path.join(root, SHARD_MANIFEST_NAME), smani)
        return ShardedChunkStore(root, shards)

    @classmethod
    def open(cls, root: str) -> "ChunkStore":
        path = os.path.join(root, MANIFEST_NAME)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except OSError as exc:
            raise ChunkStoreError(
                f"cannot read chunk store manifest {path}: {exc}") from exc
        except json.JSONDecodeError as exc:
            raise ChunkStoreError(
                f"chunk store manifest {path} is truncated or corrupt "
                f"(invalid JSON: {exc})") from exc
        if manifest.get("version") != MANIFEST_VERSION:
            raise ChunkStoreError(
                f"chunk store manifest {path}: found version "
                f"{manifest.get('version')!r}, expected {MANIFEST_VERSION} "
                f"(the chunk layout changed; rebuild with ChunkStore.build)")
        missing = [k for k in ("num_partitions", "num_batches",
                               "batch_size", "partition_sizes", "chunks",
                               "chunk_crcs", "manifest_crc")
                   if k not in manifest]
        if missing:
            raise ChunkStoreError(
                f"chunk store manifest {path} is truncated or corrupt "
                f"(missing keys: {missing})")
        if manifest_self_crc(manifest) != manifest["manifest_crc"]:
            raise IntegrityError(
                f"chunk store manifest {path} failed its checksum "
                f"(stored manifest_crc {manifest['manifest_crc']}, "
                f"computed {manifest_self_crc(manifest)})")
        store = cls(root, manifest)
        for q in store.partitions:
            epath = os.path.join(root, f"edges_q{q}.bin")
            if not os.path.exists(epath):
                raise ChunkStoreError(
                    f"chunk store at {root} is missing edge file {epath} "
                    f"(manifest owns destination partition {q})")
        return store

    # -- reads ---------------------------------------------------------------
    def _map(self, q: int) -> mmap.mmap:
        # Opened under the counters' lock so a prefetch thread racing the
        # consumer never double-opens or sees a half-published map.  A
        # stdlib mmap: slicing it is one C-level memcpy into fresh bytes.
        with self._lock:
            mm = self._mm.get(q)
            if mm is None:
                with open(os.path.join(self.root, f"edges_q{q}.bin"),
                          "rb") as f:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                self._mm[q] = mm
            return mm

    def chunk_stored_nbytes(self, q: int, p: int, k: int
                            ) -> tuple[int, int, int]:
        """(dcsr, csr, dcsr_delta) read bytes for a chunk; csr is 0 when no
        CSR representation is stored, dcsr_delta is 0 on uncompressed
        stores.  Mirrors the analytic byte model exactly."""
        lay = self._layout_of(q)
        if lay.offset[p, k] < 0:
            return 0, 0, 0
        if self.compression:
            pay = int(lay.dstv_nb[p, k]) + (
                0 if self.values_elided else int(lay.edges[p, k]) * 4)
        else:
            pay = int(lay.edges[p, k]) * EDGE_DT.itemsize
        dcsr = int(lay.nnz[p, k]) * PAIR_DT.itemsize + pay
        csr = ((int(self.part_sizes[p]) + 1) * 4 + pay
               if lay.has_csr[p, k] else 0)
        delta = (int(lay.pair_nb[p, k]) + pay) if self.compression else 0
        return dcsr, csr, delta

    def _sections(self, lay: _ChunkLayout, p: int, k: int):
        """Byte sizes of a chunk's sections:
        (pairs_nb, pair_delta_nb, idx_nb, payload_nb)."""
        nnz = int(lay.nnz[p, k])
        n_e = int(lay.edges[p, k])
        pairs_nb = nnz * PAIR_DT.itemsize
        idx_nb = (int(self.part_sizes[p]) + 1) * 4 if lay.has_csr[p, k] else 0
        if self.compression:
            data_nb = 0 if self.values_elided else n_e * 4
            return (pairs_nb, int(lay.pair_nb[p, k]), idx_nb,
                    int(lay.dstv_nb[p, k]) + data_nb)
        return pairs_nb, 0, idx_nb, n_e * EDGE_DT.itemsize

    def read_chunk_bytes(self, q: int, p: int, k: int, rep: int
                         ) -> tuple[bytes, bytes, int]:
        """The measured I/O half of a chunk read: the chosen index section
        (raw DCSR pairs, delta-varint pairs, or CSR idx) and the shared
        payload, each CRC-verified; returns (index bytes, payload bytes,
        nbytes read).  Asking for CSR where none is stored, or for the
        delta section of an uncompressed store, raises."""
        lay = self._layout_of(q)
        off = int(lay.offset[p, k])
        if off < 0:
            raise KeyError(f"chunk ({q}, {p}, {k}) is empty")
        mm = self._map(q)
        pairs_nb, pd_nb, idx_nb, pay_nb = self._sections(lay, p, k)
        pay_off = off + pairs_nb + pd_nb + idx_nb
        payload = mm[pay_off:pay_off + pay_nb]
        if rep == REP_CSR:
            if not lay.has_csr[p, k]:
                raise ValueError(
                    f"chunk ({q}, {p}, {k}) has no CSR representation")
            index = mm[off + pairs_nb + pd_nb:off + pairs_nb + pd_nb + idx_nb]
            sec = CRC_IDX
        elif rep == REP_DCSR_DELTA:
            if not self.compression:
                raise ValueError(
                    f"chunk store at {self.root} was built without "
                    "compression; no delta-varint pair section exists")
            index = mm[off + pairs_nb:off + pairs_nb + pd_nb]
            sec = CRC_DELTA
        elif rep == REP_DCSR:
            index = mm[off:off + pairs_nb]
            sec = CRC_PAIRS
        else:
            raise ValueError(f"unknown chunk representation {rep!r}")
        self._verify_section(lay, q, p, k, sec, index)
        self._verify_section(lay, q, p, k, CRC_PAYLOAD, payload)
        nbytes = len(index) + len(payload)
        with self._lock:
            self.chunks_read += 1
            self.bytes_read += nbytes
        return index, payload, nbytes

    def _verify_section(self, lay: _ChunkLayout, q: int, p: int, k: int,
                        sec: int, data: bytes) -> None:
        want = int(lay.crc[p, k, sec])
        got = crc32(data)
        if got != want:
            raise IntegrityError(
                f"chunk store {os.path.join(self.root, f'edges_q{q}.bin')}: "
                f"chunk (q={q}, p={p}, k={k}) section "
                f"'{_CRC_SECTION_NAMES[sec]}' failed its checksum "
                f"(stored {want}, read {got}) — disk corruption")

    def decode_chunk(self, q: int, p: int, k: int, rep: int,
                     index: bytes, payload: bytes):
        """Decode the bytes of :meth:`read_chunk_bytes` on the host back to
        the (src_local, dst_local, data) numpy triple — bit-identical
        round trip through every representation."""
        lay = self._layout_of(q)
        n_e = int(lay.edges[p, k])
        v_src = int(self.part_sizes[p])
        if rep == REP_CSR:
            idx = np.frombuffer(index, dtype="<i4")
            deg = np.diff(idx)
            nzd = deg > 0
            starts = idx[:-1][nzd]
            runs = deg[nzd]
            src = np.repeat(np.arange(v_src, dtype=np.int32), deg)
        else:
            if rep == REP_DCSR_DELTA:
                nnz = int(lay.nnz[p, k])
                srcs, starts = codec.pair_delta_restore(
                    codec.varint_decode(index, 2 * nnz))
            else:
                pairs = np.frombuffer(index, dtype=PAIR_DT)
                srcs, starts = pairs["src"], pairs["idx"]
            runs = np.append(starts[1:], np.int32(n_e)) - starts
            src = np.repeat(srcs, runs)
        if not self.compression:
            pay = np.frombuffer(payload, dtype=EDGE_DT)
            return src, pay["dst"].copy(), pay["data"].copy()
        vnb = int(lay.dstv_nb[p, k])
        dst = codec.dst_delta_restore(
            codec.varint_decode(payload[:vnb], n_e), starts, runs,
            k * self.batch_size)
        if self.values_elided:
            data = np.ones(n_e, np.float32)
        else:
            data = np.frombuffer(payload[vnb:], dtype="<f4").copy()
        return src, dst, data

    def decode_chunk_device(self, q: int, p: int, k: int, rep: int,
                            index: bytes, payload: bytes, device=None):
        """Twin of :meth:`decode_chunk` on ``device`` (CUDA unless given;
        compressed stores only): the chunk goes through the fused decode
        (:mod:`repro_torch.kernels.chunk_decode`) as an item of one, on the
        current stream, and the (src, dst, data) triple is returned as
        tensors on that device — bit-identical to the host decode."""
        dev = resolve_device(device)
        dec = self._device_decoders.get(dev)
        if dec is None:
            with self._lock:
                dec = self._device_decoders.get(dev)
                if dec is None:
                    dec = DeviceChunkDecoder(self, dev)
                    self._device_decoders[dev] = dec
        return dec.decode(q, p, k, rep, index, payload)

    def read_chunk(self, q: int, p: int, k: int, rep: int):
        """Read + host-decode one chunk; returns (src_local, dst_local,
        data, nbytes)."""
        index, payload, nbytes = self.read_chunk_bytes(q, p, k, rep)
        src, dst, data = self.decode_chunk(q, p, k, rep, index, payload)
        return src, dst, data, nbytes

    def reset_io_counters(self) -> None:
        with self._lock:
            self.chunks_read = 0
            self.bytes_read = 0

    # -- offline scrub -------------------------------------------------------
    def verify(self) -> list[str]:
        """Check every section of every stored chunk against its manifest
        CRC.  Returns damage descriptions naming file, chunk and section —
        empty when clean."""
        damage = []
        for q, p, k in self.nonempty_chunks():
            lay = self._layout_of(q)
            mm = self._map(q)
            path = os.path.join(self.root, f"edges_q{q}.bin")
            off = int(lay.offset[p, k])
            pairs_nb, pd_nb, idx_nb, pay_nb = self._sections(lay, p, k)
            spans = [(CRC_PAIRS, off, pairs_nb),
                     (CRC_DELTA, off + pairs_nb, pd_nb),
                     (CRC_IDX, off + pairs_nb + pd_nb, idx_nb),
                     (CRC_PAYLOAD, off + pairs_nb + pd_nb + idx_nb, pay_nb)]
            for sec, s_off, s_nb in spans:
                if s_nb == 0 and sec != CRC_PAYLOAD:
                    continue
                got = crc32(mm[s_off:s_off + s_nb])
                want = int(lay.crc[p, k, sec])
                if got != want:
                    damage.append(
                        f"{path}: chunk (q={q}, p={p}, k={k}) section "
                        f"'{_CRC_SECTION_NAMES[sec]}' crc mismatch "
                        f"(stored {want}, read {got})")
        return damage


class ShardedChunkStore:
    """W per-worker :class:`ChunkStore` shards under one root (dist_ooc).

    Worker ``w`` owns the contiguous block of ``P / W`` destination
    partitions ``[w * P/W, (w+1) * P/W)`` and its shard holds only those
    partitions' edge files — each worker reads only its own root, the
    distributed analogue of the paper's per-node storage."""

    def __init__(self, root: str, shards: list[ChunkStore]):
        self.root = root
        self.shards = shards
        self.num_workers = len(shards)
        self.num_partitions = shards[0].num_partitions
        self.per_worker = self.num_partitions // self.num_workers
        # THE partition -> worker ownership map (contiguous blocks)
        self.worker_of = np.repeat(np.arange(self.num_workers),
                                   self.per_worker)
        for w, s in enumerate(shards):
            expect = tuple(range(w * self.per_worker,
                                 (w + 1) * self.per_worker))
            if tuple(s.partitions) != expect:
                raise ChunkStoreError(
                    f"shard {s.root} owns partitions {list(s.partitions)}, "
                    f"expected {list(expect)} for worker {w}")

    @classmethod
    def open(cls, root: str) -> "ShardedChunkStore":
        path = os.path.join(root, SHARD_MANIFEST_NAME)
        try:
            with open(path) as f:
                meta = json.load(f)
        except OSError as exc:
            raise ChunkStoreError(
                f"cannot read shard manifest {path}: {exc}") from exc
        except json.JSONDecodeError as exc:
            raise ChunkStoreError(
                f"shard manifest {path} is truncated or corrupt "
                f"(invalid JSON: {exc})") from exc
        missing = [k for k in ("version", "num_workers", "num_partitions")
                   if k not in meta]
        if missing:
            raise ChunkStoreError(
                f"shard manifest {path} is truncated or corrupt "
                f"(missing keys: {missing})")
        # the version gate first: a manifest of another version may
        # predate the manifest_crc field
        if meta["version"] != MANIFEST_VERSION:
            raise ChunkStoreError(
                f"shard manifest {path}: found version {meta['version']!r}, "
                f"expected {MANIFEST_VERSION} (the chunk layout changed; "
                f"rebuild with ChunkStore.build_sharded)")
        if not isinstance(meta["num_workers"], int) \
                or meta["num_workers"] < 1:
            raise ChunkStoreError(
                f"shard manifest {path}: num_workers "
                f"{meta['num_workers']!r} is not a positive integer")
        if "manifest_crc" not in meta:
            raise ChunkStoreError(
                f"shard manifest {path} is truncated or corrupt "
                f"(missing keys: ['manifest_crc'])")
        if manifest_self_crc(meta) != meta["manifest_crc"]:
            raise IntegrityError(
                f"shard manifest {path} failed its checksum "
                f"(stored manifest_crc {meta['manifest_crc']}, "
                f"computed {manifest_self_crc(meta)})")
        shards = [ChunkStore.open(os.path.join(root, f"w{w}"))
                  for w in range(meta["num_workers"])]
        if shards[0].num_partitions != meta["num_partitions"]:
            raise ChunkStoreError(
                f"shard manifest {path}: num_partitions "
                f"{meta['num_partitions']} does not match the worker "
                f"shards' manifests ({shards[0].num_partitions})")
        return cls(root, shards)

    def reset_io_counters(self) -> None:
        for s in self.shards:
            s.reset_io_counters()

    def verify(self) -> list[str]:
        """Scrub every shard; damage strings name shard files."""
        damage = []
        for s in self.shards:
            damage.extend(s.verify())
        return damage

    def reopen_shard(self, w: int) -> ChunkStore:
        """Re-open worker ``w``'s shard from disk — fresh manifest
        validation and new maps — and swap it into the shard list (the
        adoption path of a process-mode recovery: shards are immutable
        files under one shared root)."""
        if not 0 <= w < self.num_workers:
            raise ChunkStoreError(
                f"reopen_shard: worker {w} out of range "
                f"[0, {self.num_workers})")
        fresh = ChunkStore.open(os.path.join(self.root, f"w{w}"))
        self.shards[w] = fresh
        return fresh


class StagingRing:
    """Reused host buffers for the copies of the prefetch path to the
    card, page-locked when the device is CUDA, so that each copy runs
    asynchronously on its stream.  A buffer is written again only after
    the copy that read it has completed (its event); it grows to the
    largest item staged.  ``copies`` counts the copies to the card, every
    one of them from page-locked memory."""

    copies = 0
    SLOTS = 2     # one item being staged while the one before is copied

    def __init__(self, device):
        self.device = torch.device(device)
        self._pinned = self.device.type == "cuda"
        self._bufs = [None] * self.SLOTS
        self._events = [None] * self.SLOTS
        self._next = 0

    def take(self, nbytes: int):
        """(slot, uint8 host tensor of at least ``nbytes``) to fill."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            size = max(nbytes, 2 * (0 if buf is None else buf.numel()),
                       1 << 20)
            buf = torch.empty(size, dtype=torch.uint8,
                              pin_memory=self._pinned)
            self._bufs[i] = buf
        return i, buf

    def to_device(self, slot: int, nbytes: int, stream) -> torch.Tensor:
        """The first ``nbytes`` of the slot's buffer on the device: one
        asynchronous copy on ``stream`` (CUDA), or the host buffer itself
        (CPU: it is read before the slot comes round again)."""
        host = self._bufs[slot][:nbytes]
        if not self._pinned:
            return host
        if not host.is_pinned():
            raise RuntimeError("the staging buffer is not page-locked")
        with torch.cuda.stream(stream):
            out = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            out.copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        self._events[slot] = ev
        StagingRing.copies += 1
        return out


class DeviceChunkDecoder:
    """The decode of one compressed store's chunks on a torch device
    (DESIGN.md §10), an item at a time through
    :mod:`repro_torch.kernels.chunk_decode`.

    :meth:`decode_item` gathers an item's chunks — index and payload bytes
    and their descriptor table — into one reused staging buffer
    (page-locked on CUDA), copies it to the device in one asynchronous copy
    on ``stream`` and launches the decode there (at most two kernels), and
    returns the (src, part, dst, data) columns with an event recorded after
    them: bit-identical to :meth:`ChunkStore.decode_chunk`, chunk after
    chunk.  ``stream`` None means the caller's current stream.  On a CPU
    device the same staged bytes go through the plain version.
    """

    def __init__(self, store: ChunkStore, device, *, stream=None):
        if not store.compression:
            raise ValueError(
                f"device decode requires a compressed store; the store at "
                f"{store.root} was built with compression=False")
        from repro_torch.kernels import chunk_decode
        self._cd = chunk_decode
        self.store = store
        self.device = torch.device(device)
        self.stream = stream
        self._ring = StagingRing(self.device)

    def chunk_bytes(self, q: int, p: int, k: int, rep: int, index: bytes,
                    payload: bytes):
        """The :class:`chunk_decode.ChunkBytes` of one chunk read."""
        store = self.store
        lay = store._layout_of(q)
        vnb = int(lay.dstv_nb[p, k])
        if rep not in (REP_CSR, REP_DCSR, REP_DCSR_DELTA):
            raise ValueError(f"unknown chunk representation {rep!r}")
        return self._cd.ChunkBytes(
            rep=rep, part=p, n_e=int(lay.edges[p, k]),
            nnz=int(lay.nnz[p, k]), v_src=int(store.part_sizes[p]),
            base=k * store.batch_size, index=index,
            residues=payload[:vnb],
            data=None if store.values_elided else payload[vnb:])

    def decode_item(self, q: int, k: int, reads):
        """``reads``: [(p, rep, index, payload), ...] of one schedule item.
        Returns (src, part, dst, data, ready): the columns on the device and
        the CUDA event after their decode (None off CUDA)."""
        cd = self._cd
        chunks = [self.chunk_bytes(q, p, k, rep, index, payload)
                  for p, rep, index, payload in reads]
        plan = cd.plan_item(chunks)
        slot, host = self._ring.take(plan.nbytes)
        cd.write_item(plan, chunks, host.numpy())
        if self.device.type != "cuda":
            staged = self._ring.to_device(slot, plan.nbytes, None)
            return (*cd.decode_item(staged, plan), None)
        stream = self.stream or torch.cuda.current_stream(self.device)
        staged = self._ring.to_device(slot, plan.nbytes, stream)
        with torch.cuda.stream(stream):
            cols = cd.decode_item(staged, plan)
            ready = torch.cuda.Event()
            ready.record(stream)
        return (*cols, ready)

    def decode(self, q: int, p: int, k: int, rep: int,
               index: bytes, payload: bytes):
        """One chunk as an item of one: (src, dst, data) on the device,
        ready on the current stream when ``stream`` is None."""
        src, _, dst, data, _ = self.decode_item(
            q, k, [(p, rep, index, payload)])
        return src, dst, data


# ---------------------------------------------------------------------------
# VertexSpill: vertex arrays on disk, batch-granular access
# ---------------------------------------------------------------------------

class VertexSpill:
    """Per-batch disk residence for the [P, V] vertex state arrays.

    Each array is one memmap of shape [P, num_batches * batch_size] (padded
    to whole batches so a touched batch is always a full-stride
    read/write), plus ``active.bits`` — the row-packed active bitmap.
    ``load`` is the unmeasured preprocessing sync; ``read``/``write``/
    ``read_bitmap``/``write_bitmap`` are the measured per-request entry
    points the OOC executor issues.  ``num_queries`` is recorded in
    ``spill_meta.json``; reopening a spill with a different Q raises
    :class:`ChunkStoreError`.
    """

    def __init__(self, root: str, num_partitions: int, num_batches: int,
                 batch_size: int, v_max: int, num_queries: int = 1):
        if num_queries < 1:
            raise ChunkStoreError(
                f"vertex spill at {root}: num_queries must be >= 1, got "
                f"{num_queries}")
        self.root = root
        self.p_cnt = num_partitions
        self.b_cnt = num_batches
        self.batch_size = batch_size
        self.v_max = v_max
        self.v_pad = num_batches * batch_size
        self.num_queries = num_queries
        os.makedirs(root, exist_ok=True)
        meta_path = self._meta_path = os.path.join(root, "spill_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            found = int(meta.get("num_queries", 1))
            if found != num_queries:
                raise ChunkStoreError(
                    f"vertex spill at {root} was built for num_queries="
                    f"{found}, but the engine requires num_queries="
                    f"{num_queries}; use a fresh spill root (or an engine "
                    f"with the matching Q) — the per-query column files "
                    f"on disk do not match the requested panel width")
        else:
            atomic_write_json(meta_path, {"num_queries": num_queries})
        self._mm: dict[str, np.memmap] = {}
        # Per-(partition, batch) CRC32 sidecars, one uint32 [P, B] memmap
        # per array (``vertex_{name}.crc``): unmeasured control metadata.
        self._crc: dict[str, np.memmap] = {}
        self.bytes_read = 0
        self.bytes_written = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.root, f"vertex_{name}.bin")

    def _crc_path(self, name: str) -> str:
        return os.path.join(self.root, f"vertex_{name}.crc")

    def _crc_update(self, name: str, runs: list) -> None:
        """Recompute the sidecar CRCs of every batch covered by ``runs``."""
        mm, cm, bs = self._mm[name], self._crc[name], self.batch_size
        for p, lo, hi in runs:
            for k in range(lo // bs, hi // bs):
                cm[p, k] = crc32(mm[p, k * bs:(k + 1) * bs])

    def _crc_verify(self, name: str, runs: list) -> None:
        """Check every covered batch against its sidecar CRC before the
        data is handed out — a flipped byte raises IntegrityError."""
        mm, cm, bs = self._mm[name], self._crc[name], self.batch_size
        for p, lo, hi in runs:
            for k in range(lo // bs, hi // bs):
                got = crc32(mm[p, k * bs:(k + 1) * bs])
                if got != int(cm[p, k]):
                    raise IntegrityError(
                        f"vertex spill {self._path(name)}: array "
                        f"{name!r} batch (p={p}, k={k}) failed its "
                        f"checksum (stored {int(cm[p, k])}, read {got}) "
                        f"— disk corruption")

    def _all_runs(self) -> list:
        return [(p, 0, self.v_pad) for p in range(self.p_cnt)]

    def load(self, state: dict[str, np.ndarray]) -> None:
        """Full (unmeasured) sync of caller state into the spill files;
        records the array names and dtypes in ``spill_meta.json``."""
        self._mm = {}
        self._crc = {}
        for name, arr in state.items():
            arr = np.asarray(arr)
            assert arr.shape == (self.p_cnt, self.v_max), (name, arr.shape)
            mm = np.memmap(self._path(name), dtype=arr.dtype, mode="w+",
                           shape=(self.p_cnt, self.v_pad))
            mm[:, :self.v_max] = arr
            mm[:, self.v_max:] = np.zeros((), arr.dtype)
            self._mm[name] = mm
            self._crc[name] = np.memmap(self._crc_path(name),
                                        dtype=np.uint32, mode="w+",
                                        shape=(self.p_cnt, self.b_cnt))
            self._crc_update(name, self._all_runs())
        atomic_write_json(self._meta_path, {
            "num_queries": self.num_queries,
            "arrays": {name: str(mm.dtype)
                       for name, mm in self._mm.items()}})

    def attach(self) -> None:
        """Re-open existing spill files in place — the recovery path.

        An adopting rank memmaps a dead worker's on-disk arrays exactly
        as the dead process last wrote them (mode ``r+``: writable, but
        nothing is written or zeroed here), with names and dtypes from the
        ``arrays`` record :meth:`load` left in ``spill_meta.json``.
        Unmeasured, like :meth:`load`: adoption moves ownership, it is not
        modeled data-plane I/O (DESIGN.md §13)."""
        with open(self._meta_path) as f:
            meta = json.load(f)
        arrays = meta.get("arrays")
        if not arrays:
            raise ChunkStoreError(
                f"vertex spill at {self.root} records no arrays to attach "
                f"(it was never load()ed)")
        mm, cm = {}, {}
        for name, dt in arrays.items():
            path = self._path(name)
            if not os.path.exists(path):
                raise ChunkStoreError(
                    f"vertex spill at {self.root}: recorded array "
                    f"{name!r} has no file {path}")
            mm[name] = np.memmap(path, dtype=np.dtype(dt), mode="r+",
                                 shape=(self.p_cnt, self.v_pad))
            cpath = self._crc_path(name)
            if not os.path.exists(cpath):
                raise ChunkStoreError(
                    f"vertex spill at {self.root}: recorded array "
                    f"{name!r} has no crc sidecar {cpath}")
            cm[name] = np.memmap(cpath, dtype=np.uint32, mode="r+",
                                 shape=(self.p_cnt, self.b_cnt))
        self._mm = mm
        self._crc = cm

    def on_disk(self) -> bool:
        """True when an earlier incarnation ``load()``ed arrays under this
        root (the whole-job resume probe: is there anything to attach?)."""
        if not os.path.exists(self._meta_path):
            return False
        with open(self._meta_path) as f:
            meta = json.load(f)
        return bool(meta.get("arrays"))

    def names(self) -> list[str]:
        return list(self._mm)

    def arrays_bytes(self, keys: Sequence[str] | None = None) -> int:
        """Per-vertex byte width across the spilled arrays (model
        constant); ``keys`` restricts it to a subset."""
        names = self._mm if keys is None else keys
        return sum(self._mm[name].dtype.itemsize for name in names)

    def state_views(self) -> dict[str, np.ndarray]:
        """Zero-copy [P, v_max] views of the authoritative on-disk state."""
        return {name: mm[:, :self.v_max] for name, mm in self._mm.items()}

    def _batch_runs(self, batch_mask: np.ndarray) -> list:
        """Coalesce touched batches into per-row contiguous column spans
        ``(p, lo, hi)`` — one slice per run instead of one per batch; the
        byte counters still see exactly the touched batches."""
        bs = self.batch_size
        runs = []
        for p in range(self.p_cnt):
            ks = np.flatnonzero(batch_mask[p])
            if not ks.size:
                continue
            splits = np.flatnonzero(np.diff(ks) > 1) + 1
            for grp in np.split(ks, splits):
                runs.append((p, int(grp[0]) * bs, (int(grp[-1]) + 1) * bs))
        return runs

    def read(self, batch_mask: np.ndarray,
             keys: Sequence[str] | None = None) -> dict[str, np.ndarray]:
        """Measured read of every batch with a set bit in ``batch_mask``
        [P, B].  Returns padded [P, v_pad] copies, zeros where unread."""
        out = {}
        touched = int(batch_mask.sum())
        runs = self._batch_runs(batch_mask)
        for name in (self._mm if keys is None else keys):
            mm = self._mm[name]
            self._crc_verify(name, runs)
            arr = np.zeros((self.p_cnt, self.v_pad), mm.dtype)
            for p, lo, hi in runs:
                arr[p, lo:hi] = mm[p, lo:hi]
            out[name] = arr
            self.bytes_read += touched * self.batch_size * mm.dtype.itemsize
        return out

    def write(self, updates: dict[str, np.ndarray], batch_mask: np.ndarray
              ) -> None:
        """Measured write-back of touched batches from padded [P, v_pad]
        (or [P, v_max]) arrays."""
        touched = int(batch_mask.sum())
        runs = self._batch_runs(batch_mask)
        for name, arr in updates.items():
            mm = self._mm[name]
            arr = np.asarray(arr, mm.dtype)
            if arr.shape[1] != self.v_pad:
                pad = np.zeros((self.p_cnt, self.v_pad), mm.dtype)
                pad[:, :arr.shape[1]] = arr
                arr = pad
            for p, lo, hi in runs:
                mm[p, lo:hi] = arr[p, lo:hi]
            self._crc_update(name, runs)
            self.bytes_written += (touched * self.batch_size
                                   * mm.dtype.itemsize)

    def merge_write(self, padded_state: dict[str, np.ndarray],
                    updates: dict[str, np.ndarray], mask: np.ndarray,
                    batch_mask: np.ndarray) -> None:
        """Masked update + measured write-back, shared by ProcessEdges
        apply and ProcessVertices: ``np.where(mask, update, old)`` into
        the padded arrays previously returned by :meth:`read`, then write
        the touched batches."""
        for name, v in updates.items():
            av = padded_state[name]
            av[:, :self.v_max] = np.where(mask, np.asarray(v, av.dtype),
                                          av[:, :self.v_max])
        self.write(padded_state, batch_mask)

    # -- active bitmap -------------------------------------------------------
    def bitmap_nbytes(self) -> int:
        return bitmap_nbytes(self.p_cnt, self.v_max)

    def write_bitmap(self, mask: np.ndarray, name: str = "active",
                     measured: bool = True) -> None:
        packed = np.packbits(np.asarray(mask, bool), axis=1)
        with open(os.path.join(self.root, f"{name}.bits"), "wb") as f:
            f.write(packed.tobytes())
        with open(os.path.join(self.root, f"{name}.bits.crc"), "w") as f:
            f.write(str(crc32(packed)))
        if measured:
            self.bytes_written += packed.nbytes

    def read_bitmap(self, name: str = "active",
                    measured: bool = True) -> np.ndarray | None:
        path = os.path.join(self.root, f"{name}.bits")
        row = ceil_div(self.v_max, 8)
        if not os.path.exists(path):
            if measured:
                self.bytes_read += self.p_cnt * row  # fresh file reads zeros
            return None
        packed = np.fromfile(path, np.uint8).reshape(self.p_cnt, row)
        self._verify_bitmap(name, path, packed)
        if measured:
            self.bytes_read += packed.nbytes
        return np.unpackbits(packed, axis=1)[:, :self.v_max].astype(bool)

    def _verify_bitmap(self, name: str, path: str,
                       packed: np.ndarray) -> None:
        cpath = path + ".crc"
        if not os.path.exists(cpath):
            raise IntegrityError(
                f"vertex spill bitmap {path} has no crc sidecar {cpath}")
        with open(cpath) as f:
            want = int(f.read())
        got = crc32(packed)
        if got != want:
            raise IntegrityError(
                f"vertex spill bitmap {path} ({name!r}) failed its "
                f"checksum (stored {want}, read {got}) — disk corruption")

    # -- offline scrub -------------------------------------------------------
    def verify(self) -> list[str]:
        """Check every batch of every array (attaching the files a spill
        opened fresh finds on disk), and every bitmap file, against its CRC
        sidecar (the fsck primitive).  Returns damage descriptions naming
        file, array and batch."""
        damage = []
        if not self._mm and self.on_disk():
            try:
                self.attach()
            except ChunkStoreError as exc:
                return [str(exc)]
        for name in self._mm:
            try:
                self._crc_verify(name, self._all_runs())
            except IntegrityError as exc:
                damage.append(str(exc))
        for fname in sorted(os.listdir(self.root)):
            if not fname.endswith(".bits"):
                continue
            path = os.path.join(self.root, fname)
            row = ceil_div(self.v_max, 8)
            packed = np.fromfile(path, np.uint8).reshape(self.p_cnt, row)
            try:
                self._verify_bitmap(fname[:-5], path, packed)
            except IntegrityError as exc:
                damage.append(str(exc))
        return damage

    def reset_io_counters(self) -> None:
        self.bytes_read = 0
        self.bytes_written = 0


# ---------------------------------------------------------------------------
# ChunkSource contract: how executors see storage (DESIGN.md §6)
# ---------------------------------------------------------------------------

class HBMChunkSource:
    """Everything-resident realization: the LOCAL executor reads edge chunks
    and dispatch metadata straight from device tensors; I/O is analytic."""

    kind = "hbm"

    def __init__(self, graph, fmts):
        self.graph = graph
        self.fmts = fmts

    DEST_KEYS = ("dcsr_src", "dcsr_part", "dcsr_batch", "dcsr_valid",
                 "dcsr_ptr", "has_csr", "csr_bytes", "dcsr_bytes",
                 "dcsr_delta_bytes", "csr_raw_bytes", "dcsr_raw_bytes")
    EDGE_KEYS = ("edge_src_part", "edge_src_local", "edge_dst_local",
                 "edge_data", "edge_valid")

    @staticmethod
    def _get(obj, key):
        return obj[key] if isinstance(obj, dict) else getattr(obj, key)

    @classmethod
    def dest_arrays(cls, fmts) -> dict:
        """Dispatch-graph + format-decision arrays for phases 3/3.5 (works
        on a ChunkFormats or a dict of the same arrays)."""
        return {k: cls._get(fmts, k) for k in cls.DEST_KEYS}

    @classmethod
    def edge_arrays(cls, g) -> dict:
        """Per-edge arrays for the segment compute backend."""
        return {k: cls._get(g, k) for k in cls.EDGE_KEYS}


class DiskChunkSource:
    """Disk realization: bulk edge data streams from a :class:`ChunkStore`;
    dispatch metadata and format stats stay memory-resident (host numpy),
    in both the compressed and the legacy ``*_raw`` pricing families."""

    kind = "disk"

    def __init__(self, store: ChunkStore, graph, fmts):
        self.store = store
        self.graph = graph
        self.fmts = fmts
        self.compression = store.compression
        self.dcsr_src = _np(fmts.dcsr_src)
        self.dcsr_part = _np(fmts.dcsr_part)
        self.dcsr_batch = _np(fmts.dcsr_batch)
        self.dcsr_valid = _np(fmts.dcsr_valid)
        self.dcsr_ptr = _np(fmts.dcsr_ptr)
        self.has_csr = _np(fmts.has_csr)
        self.csr_bytes = _np(fmts.csr_bytes, np.float64)
        self.dcsr_bytes = _np(fmts.dcsr_bytes, np.float64)
        self.dcsr_delta_bytes = _np(fmts.dcsr_delta_bytes, np.float64)
        self.csr_raw_bytes = _np(fmts.csr_raw_bytes, np.float64)
        self.dcsr_raw_bytes = _np(fmts.dcsr_raw_bytes, np.float64)

    def read_chunk_bytes(self, q: int, p: int, k: int, rep: int):
        return self.store.read_chunk_bytes(q, p, k, rep)

    def decode_chunk(self, q: int, p: int, k: int, rep: int,
                     index: bytes, payload: bytes):
        return self.store.decode_chunk(q, p, k, rep, index, payload)

    def decode_chunk_device(self, q: int, p: int, k: int, rep: int,
                            index: bytes, payload: bytes, device=None):
        return self.store.decode_chunk_device(q, p, k, rep, index, payload,
                                              device=device)


# ---------------------------------------------------------------------------
# Double-buffered prefetch pipeline
# ---------------------------------------------------------------------------

class ScheduleMark:
    """Marker base for passthrough schedule items: a
    :class:`ChunkPrefetcher` forwards them to the consumer unchanged, in
    order, without touching the store."""


@dataclasses.dataclass
class BatchWork:
    """One dst-batch work item: the chunks the selective schedule marked
    active, decoded and concatenated, as tensors on the engine's device."""
    q: int
    k: int
    src: torch.Tensor      # int32 [E] source local ids
    part: torch.Tensor     # int32 [E] source partitions
    dst: torch.Tensor      # int32 [E] destination local ids
    data: torch.Tensor     # f32  [E] edge payloads
    nbytes: int            # measured bytes read for this item
    n_chunks: int
    n_device_chunks: int = 0   # chunks decoded on the device
    read_s: float = 0.0        # host wall seconds reading the chunk bytes
    decode_s: float = 0.0      # host wall seconds staging and decoding them
    ready: object = None       # CUDA event after the columns' last write

    def columns(self):
        return self.src, self.part, self.dst, self.data


class ChunkPrefetcher:
    """Thread-based double-buffered chunk reader.

    ``schedule`` is any iterable whose items are either
    ``(q, k, [(p, rep), ...])`` — a chunk-read request: the thread reads
    and decodes those chunks and enqueues one :class:`BatchWork` — or a
    :class:`ScheduleMark`, forwarded to the consumer unchanged, in order.

    The thread keeps at most ``depth`` decoded items ahead of the consumer,
    so disk reads and decodes for batch *i+1* overlap the combine of batch
    *i*.  A generator schedule is advanced on the thread and closed when
    the pipeline shuts down, normally or early.  Worker exceptions
    re-raise in the consumer.

    On a CUDA device the thread's copies and kernels run on a stream of
    the prefetcher's own, each item staged in page-locked memory
    (:class:`StagingRing`) and copied in one asynchronous copy; before an
    item is yielded, the consumer's current stream waits on the item's
    event and the columns are marked as used there (``record_stream``), so
    the consumer's work on them orders after their decode and the caching
    allocator does not hand their memory out early.

    ``compute_lock`` is an optional shared compute token held for each
    host decode burst (never across a queue put/get).  ``runner`` is an
    optional long-lived executor that hosts the prefetch loop instead of a
    thread of its own (the parallel dist_ooc executor reuses one per
    engine).  ``device_decode``
    decodes each item on ``device`` through :class:`DeviceChunkDecoder`
    (the fused decode), outside the token; the host decode packs the
    codec's columns into the staging buffer instead.  Either way the work
    items hold tensors on ``device``.
    """

    _DONE = object()

    def __init__(self, source: DiskChunkSource, schedule, depth: int = 2,
                 compute_lock=None, device_decode: bool = False,
                 device=None, runner=None):
        self._source = source
        self._schedule = schedule
        self._device_decode = bool(device_decode)
        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        if self._device_decode:
            self._decoder = DeviceChunkDecoder(source.store, self._device,
                                               stream=self._stream)
        else:
            self._ring = StagingRing(self._device)
        self._lock_ctx = token_ctx(compute_lock)
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        if runner is None:
            thread = threading.Thread(target=self._run, daemon=True)
            thread.start()
            self._join = thread.join
        else:
            self._join = runner.submit(self._run).exception

    def _put(self, item) -> bool:
        """Blocking put that aborts when the consumer closed the pipeline
        (so an abandoned iteration never strands the worker on a full
        queue)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _load(self, q: int, k: int, chunks) -> BatchWork:
        """Read and decode one schedule item.  The bytes are fetched
        first, outside the compute token; the host decode takes the token,
        the device decode does not (it stages the bytes and launches two
        kernels, not a host-CPU burst)."""
        src = self._source
        t0 = time.perf_counter()
        raw = [(p, rep, *src.read_chunk_bytes(q, p, k, rep))
               for p, rep in chunks]
        t1 = time.perf_counter()
        nbytes = sum(r[4] for r in raw)
        if self._device_decode:
            *cols, ready = self._decoder.decode_item(
                q, k, [r[:4] for r in raw])
            n_dev = len(raw)
        else:
            with self._lock_ctx:
                decoded = [(p, src.decode_chunk(q, p, k, rep, index,
                                                payload))
                           for p, rep, index, payload, _ in raw]
                cols, ready = self._stage_host(decoded)
            n_dev = 0
        work = BatchWork(q, k, *cols, nbytes=nbytes, n_chunks=len(raw),
                         n_device_chunks=n_dev, ready=ready)
        work.read_s = t1 - t0
        work.decode_s = time.perf_counter() - t1
        return work

    def _stage_host(self, decoded):
        """The host codec's per-chunk (src, dst, data) arrays as one
        [src | part | dst | data] int32 block: staged, copied to the device
        in one copy, and split into the four columns."""
        n = sum(len(t[0]) for _, t in decoded)
        slot, host = self._ring.take(16 * n)
        block = host[:16 * n].numpy().view(np.int32).reshape(4, n)
        off = 0
        for p, (s, d, w) in decoded:
            e = off + len(s)
            block[0, off:e], block[1, off:e] = s, p
            block[2, off:e], block[3, off:e] = d, w.view(np.int32)
            off = e
        staged = self._ring.to_device(slot, 16 * n, self._stream)
        cols = staged.view(torch.int32).view(4, n)
        if self._stream is None:
            cols = cols.clone()       # the host slot is written again
            ready = None
        else:
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return (cols[0], cols[1], cols[2],
                cols[3].view(torch.float32)), ready

    def _run(self):
        try:
            try:
                for item in self._schedule:
                    if isinstance(item, ScheduleMark):
                        if not self._put(item):
                            return
                        continue
                    if not self._put(self._load(*item)):
                        return
                self._put(self._DONE)
            finally:
                close = getattr(self._schedule, "close", None)
                if close is not None:
                    close()
        except BaseException as exc:   # propagate to the consumer
            self._put(exc)

    def close(self) -> None:
        """Tear the pipeline down (idempotent; called automatically when
        iteration ends — normally, via break, or via an exception)."""
        self._stop.set()
        while True:                    # unblock a worker stuck on put()
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._join()

    def __iter__(self) -> Iterator[BatchWork]:
        try:
            while True:
                item = self._queue.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                if getattr(item, "ready", None) is not None:
                    stream = torch.cuda.current_stream(self._device)
                    stream.wait_event(item.ready)
                    for col in item.columns():
                        col.record_stream(stream)
                yield item
        finally:
            self.close()
