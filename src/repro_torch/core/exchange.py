"""Inter-worker message exchange for distributed fully-out-of-core execution
— the port of ``repro.core.exchange`` (DESIGN.md §7, §9).

Phase 2's filter emits, per (source partition p, destination partition q),
a send list; each list is one **message batch** whose byte representation
is chosen adaptively (the §4.1 CSR/DCSR idea applied to the network):

* ``pairs``  — compacted ``(src_local int32, value float32)`` entries:
  ``count * (4 + msg_bytes)`` bytes;
* ``vpairs`` — the same entries with the index column replaced by a
  delta-varint gap stream: ``gap_bytes(mask) + count * msg_bytes``
  (compression on);
* ``slab``   — a presence bitmap plus ``v_max`` dense values:
  ``ceil(v_max / 8) + v_max * msg_bytes`` bytes;
* ``uval``   — a gap stream plus ONE value when every value of the batch
  is identical: ``gap_bytes(mask) + msg_bytes`` (compression on).

:func:`batch_wire_bytes` prices every executor's ``net_bytes`` counter and
:func:`choose_wire_format` is its scalar twin for the encoder, so
``measured_net_bytes == net_bytes`` by construction.  :func:`encode_batch`
/ :func:`decode_batch` (and the multi-query panel's
:func:`mq_encode_panel` / :func:`mq_decode_panel`) write and read the
reference's payloads byte for byte.

The gap streams of ``vpairs`` / ``uval`` batches decode either with the
host codec or, given a device, through the LEB128 stencil and the add scan
of :mod:`repro_torch.kernels.varint` (one launch each per stream); the
indices are the same either way.  :class:`Exchange` routes batches between
workers, serializing those that cross workers and counting their bytes;
:class:`DecodeAhead` assembles a worker's receive views on a thread of its
own while the worker combines the partition before.

Framing metadata — (p, q, format tag, count) per batch — travels
out-of-band as Python scalars and is not priced: like the dispatching
graph and the need-bitmaps it is O(P^2) control state.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.kernels import varint
from repro_torch.utils import ceil_div, token_ctx

WIRE_MSG_BYTES = 4          # float32 payload values on the wire
_IDX_BYTES = 4              # int32 source-local index per compacted pair

FMT_PAIRS = 0
FMT_SLAB = 1
FMT_VPAIRS = 2              # delta-varint index stream + dense value column
FMT_UVAL = 3                # delta-varint index stream + ONE uniform value
FMT_MQPANEL = 4             # multi-query panel: ONE union gap stream +
                            # per-query presence bitmap + value column
                            # (DESIGN.md §11)


def pair_batch_bytes(count, msg_bytes: int):
    """Compacted (index, value) encoding: ``count`` live messages."""
    return count * float(_IDX_BYTES + msg_bytes)


def slab_batch_bytes(v_max: int, msg_bytes: int) -> float:
    """Dense batch slab: presence bitmap + one value per source vertex."""
    return float(ceil_div(v_max, 8) + v_max * msg_bytes)


def vpair_batch_bytes(count, gap_bytes, msg_bytes: int):
    """Delta-varint pairs: the gap stream plus one value per message.
    ``gap_bytes`` comes from :func:`repro_torch.core.codec.mask_gap_bytes`
    on the same send mask the encoder serializes."""
    return gap_bytes + count * float(msg_bytes)


def uval_batch_bytes(gap_bytes, msg_bytes: int):
    """Uniform-value batch: the gap stream plus ONE value for the whole
    batch.  Valid only for batches whose masked values are all
    identical."""
    return gap_bytes + float(msg_bytes)


def batch_wire_bytes(count, v_max: int, msg_bytes: int, gap_bytes=None,
                     uniform=None, xp=np):
    """Priced wire bytes of one (p -> q) message batch.

    ``count`` may be a scalar or an array (numpy, or torch via ``xp``);
    empty batches are never sent and cost 0.  With ``gap_bytes`` the
    price is the compressed-tier minimum including ``vpairs`` — and, where
    ``uniform`` is True, ``uval``.  Without ``gap_bytes``, the legacy
    two-way pairs/slab choice (``uniform`` is then ignored).  The host
    (numpy) path prices in float64 so the model stays exact against the
    integer byte sum a wire measures; the torch path keeps float32, the
    analytic counters' dtype."""
    slab = slab_batch_bytes(v_max, msg_bytes)
    if xp is np:
        pairs = pair_batch_bytes(np.asarray(count, np.float64), msg_bytes)
        best = np.minimum(pairs, slab)
        if gap_bytes is not None:
            gb = np.asarray(gap_bytes, np.float64)
            best = np.minimum(best, vpair_batch_bytes(
                np.asarray(count, np.float64), gb, msg_bytes))
            if uniform is not None:
                best = np.where(np.asarray(uniform),
                                np.minimum(best, uval_batch_bytes(
                                    gb, msg_bytes)), best)
        return np.where(np.asarray(count) > 0, best, 0.0)
    c = torch.as_tensor(count).to(torch.float32)
    best = pair_batch_bytes(c, msg_bytes).clamp(max=slab)
    if gap_bytes is not None:
        gb = torch.as_tensor(gap_bytes).to(torch.float32)
        best = torch.minimum(best, vpair_batch_bytes(c, gb, msg_bytes))
        if uniform is not None:
            best = torch.where(torch.as_tensor(uniform),
                               torch.minimum(best, uval_batch_bytes(
                                   gb, msg_bytes)), best)
    return torch.where(c > 0, best, 0.0)


def choose_wire_format(count: int, v_max: int, msg_bytes: int,
                       gap_bytes=None, uniform: bool = False) -> int:
    """The encoder's scalar realization of :func:`batch_wire_bytes`: the
    cheapest enabled encoding, ties preferring the cheaper decode
    (pairs, then vpairs, then uval, then slab).  Any tie-break yields the
    same byte count as the model's minimum — which is the invariant that
    matters."""
    best, cost = FMT_PAIRS, pair_batch_bytes(count, msg_bytes)
    if gap_bytes is not None:
        vb = vpair_batch_bytes(count, float(gap_bytes), msg_bytes)
        if vb < cost:
            best, cost = FMT_VPAIRS, vb
        if uniform:
            ub = uval_batch_bytes(float(gap_bytes), msg_bytes)
            if ub < cost:
                best, cost = FMT_UVAL, ub
    if slab_batch_bytes(v_max, msg_bytes) < cost:
        best = FMT_SLAB
    return best


def choose_physical_exchange(capacity: int, v_max: int, msg_bytes: int,
                             nq: int = 1) -> bool:
    """Arbitrate the SHARD_MAP physical wire (DESIGN.md §12): True ships
    the compacted collective this iteration, False the dense slab.

    The same cost comparison :func:`choose_wire_format` runs for the
    serialized wire, applied to the collective's per-peer volume: a
    compacted exchange is a pairs batch of ``capacity`` entries and the
    dense one a slab (the compressed encodings do not apply: the
    collective ships raw arrays).  The multi-query panel pays the shared
    index stream once, and each of its Q columns adds ``capacity`` values
    and presence flags against its own dense slab."""
    if nq <= 1:
        return choose_wire_format(capacity, v_max, msg_bytes) == FMT_PAIRS
    comp = (capacity * float(_IDX_BYTES)
            + nq * capacity * float(msg_bytes + 1))
    return comp < nq * slab_batch_bytes(v_max, msg_bytes)


# ---------------------------------------------------------------------------
# Physical encode / decode
# ---------------------------------------------------------------------------

def encode_batch(mask: np.ndarray, values: np.ndarray,
                 count: int | None = None, *,
                 compression: bool = False) -> tuple[int, bytes]:
    """Serialize one message batch; returns (format tag, payload bytes).

    mask [v_max] bool, values [v_max] float32 (entries where ``mask`` is
    False are never read).  ``count`` is the mask's popcount if the caller
    already has it.  ``compression`` enables the ``vpairs`` / ``uval``
    encodings in the choice.  The payload length equals
    :func:`batch_wire_bytes` (with ``gap_bytes`` + ``uniform`` iff
    ``compression``) exactly, and the bytes are the reference's."""
    v_max = mask.shape[0]
    if count is None:
        count = int(mask.sum())

    def slab_payload():
        bits = np.packbits(np.asarray(mask, bool))
        dense = np.where(mask, values, 0.0).astype("<f4")
        return FMT_SLAB, bits.tobytes() + dense.tobytes()

    # Batch uniformity: the masked min == max reduction the byte model runs
    # (phases.batch_value_uniform), so encoder and counters agree.
    uni = False
    if compression and count:
        vm = np.asarray(values, np.float32)
        hi = np.max(np.where(mask, vm, -np.inf))
        uni = bool(hi == np.min(np.where(mask, vm, np.inf)))
    # Dense fast path: when the slab beats the pairs AND the vpairs floor
    # (every gap varint is >= 1 byte), it is certainly the minimum — skip
    # building the index column.  A uniform batch never takes it.
    slab = slab_batch_bytes(v_max, WIRE_MSG_BYTES)
    if not uni and slab < pair_batch_bytes(count, WIRE_MSG_BYTES) and (
            not compression
            or slab < vpair_batch_bytes(count, float(count),
                                        WIRE_MSG_BYTES)):
        return slab_payload()
    idx = np.flatnonzero(mask)
    gaps = gb = None
    if compression:
        gaps = np.diff(idx, prepend=-1).astype(np.uint64)
        gb = int(codec.varint_sizes(gaps).sum())
    fmt = choose_wire_format(count, v_max, WIRE_MSG_BYTES, gb, uniform=uni)
    if fmt == FMT_SLAB:
        return slab_payload()
    if fmt == FMT_UVAL:
        return FMT_UVAL, (codec.varint_encode(gaps).tobytes()
                          + np.asarray(hi, "<f4").tobytes())
    vals = np.asarray(values, "<f4")[idx]
    if fmt == FMT_VPAIRS:
        return FMT_VPAIRS, (codec.varint_encode(gaps).tobytes()
                            + vals.tobytes())
    return FMT_PAIRS, idx.astype("<i4").tobytes() + vals.tobytes()


def mq_encode_panel(masks: np.ndarray, values: np.ndarray,
                    union_mask: np.ndarray, counts: Sequence[int]
                    ) -> tuple[list, bytes]:
    """Serialize one multi-query (p -> q) batch as a **panel**: one
    delta-varint gap stream over the union positions, then — for each query
    with a nonempty column — a presence bitmap over those union positions
    plus its value column (ONE value when the masked values are all
    identical, else ``count_j`` values).

    masks [Q, v_max] bool, values [Q, v_max] f32.  Returns ``(cols,
    payload)``: ``cols`` is the framing the decoder needs, ``[(j, count_j,
    uniform_j), ...]``.  The payload length equals the panel arm of
    :func:`repro_torch.core.phases.mq_wire_bytes` exactly."""
    idx_u = np.flatnonzero(union_mask)
    gaps = np.diff(idx_u, prepend=-1).astype(np.uint64)
    parts = [codec.varint_encode(gaps).tobytes()]
    cols = []
    for j, c in enumerate(counts):
        if not c:
            continue
        mj = np.asarray(masks[j], bool)
        vm = np.asarray(values[j], np.float32)
        hi = np.max(np.where(mj, vm, -np.inf))
        uni = bool(hi == np.min(np.where(mj, vm, np.inf)))
        parts.append(np.packbits(mj[idx_u]).tobytes())
        if uni:
            parts.append(np.asarray(hi, "<f4").tobytes())
        else:
            parts.append(vm[mj].astype("<f4").tobytes())
        cols.append((j, int(c), uni))
    return cols, b"".join(parts)


def mq_decode_panel(cols: list, payload: bytes, union_count: int,
                    v_max: int, num_queries: int, device=None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`mq_encode_panel` -> (masks [Q, v_max] bool,
    values [Q, v_max] f32); ``device`` as in :func:`decode_batch`."""
    masks = np.zeros((num_queries, v_max), bool)
    values = np.zeros((num_queries, v_max), np.float32)
    pres_nb = ceil_div(union_count, 8)
    cols_nb = sum(pres_nb + (WIRE_MSG_BYTES if uni
                             else c * WIRE_MSG_BYTES)
                  for _, c, uni in cols)
    idx_u = _gap_decode(payload[:len(payload) - cols_nb], union_count,
                        device)
    off = len(payload) - cols_nb
    for j, c, uni in cols:
        bits = np.frombuffer(payload[off:off + pres_nb], np.uint8)
        off += pres_nb
        pres = np.unpackbits(bits)[:union_count].astype(bool)
        pos = idx_u[pres]
        if uni:
            vals = np.full(c, np.frombuffer(
                payload[off:off + WIRE_MSG_BYTES], "<f4")[0], np.float32)
            off += WIRE_MSG_BYTES
        else:
            vals = np.frombuffer(payload[off:off + c * WIRE_MSG_BYTES],
                                 "<f4")
            off += c * WIRE_MSG_BYTES
        masks[j, pos] = True
        values[j, pos] = vals
    return masks, values


def _gap_decode(stream: bytes, count: int, device=None) -> np.ndarray:
    """Decode a batch's delta-varint gap stream to sorted int64 indices
    (``cumsum(gaps) - 1``).

    ``device`` None decodes with the host codec.  Otherwise the stream is
    copied to that device and unpacked there by
    :func:`repro_torch.kernels.varint.varint_decode` — the LEB128 stencil
    and one add scan (the kernels on a CUDA device, their plain versions
    on the CPU) — and the gaps come back to the host; gaps are < 2**31,
    the kernels' int32 domain, so the indices equal the host codec's bit
    for bit.  The reference padded buffer and count to power-of-two
    buckets to bound its compiled shapes; eager kernels need no buckets."""
    if device is not None and count:
        buf = torch.from_numpy(np.frombuffer(stream, np.uint8).copy())
        gaps = varint.varint_decode(buf.to(device), len(stream),
                                    count=count).cpu().numpy()
    else:
        gaps = codec.varint_decode(stream, count)
    return np.cumsum(gaps.astype(np.int64)) - 1


def decode_batch(fmt: int, payload: bytes, count: int, v_max: int,
                 device=None) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`encode_batch` -> (mask [v_max], values [v_max]).
    ``device`` (None: the host codec) decodes the ``vpairs`` / ``uval``
    gap streams there (:func:`_gap_decode`); the results are bit-identical
    either way."""
    if fmt == FMT_SLAB:
        nbits = ceil_div(v_max, 8)
        bits = np.frombuffer(payload[:nbits], np.uint8)
        mask = np.unpackbits(bits)[:v_max].astype(bool)
        values = np.frombuffer(payload[nbits:], "<f4").copy()
        return mask, values
    if fmt == FMT_VPAIRS:
        vals_nb = count * WIRE_MSG_BYTES
        idx = _gap_decode(payload[:len(payload) - vals_nb], count, device)
        vals = np.frombuffer(payload[len(payload) - vals_nb:], "<f4")
    elif fmt == FMT_UVAL:
        idx = _gap_decode(payload[:len(payload) - WIRE_MSG_BYTES], count,
                          device)
        vals = np.full(count, np.frombuffer(
            payload[len(payload) - WIRE_MSG_BYTES:], "<f4")[0], np.float32)
    elif fmt == FMT_PAIRS:
        idx = np.frombuffer(payload[:count * _IDX_BYTES], "<i4")
        vals = np.frombuffer(payload[count * _IDX_BYTES:], "<f4")
    else:
        raise ValueError(f"unknown wire format tag {fmt!r}")
    mask = np.zeros(v_max, bool)
    values = np.zeros(v_max, np.float32)
    mask[idx] = True
    values[idx] = vals
    return mask, values


# ---------------------------------------------------------------------------
# Exchange: per-worker mailboxes with measured wire traffic
# ---------------------------------------------------------------------------

class Exchange:
    """Message routing between the workers of one dist_ooc ProcessEdges
    call.

    Senders :meth:`post` one batch per nonempty (p, q) send list; a batch
    whose destination worker differs from its source worker is serialized
    (measured: ``bytes_sent`` is what crossed the wire), a worker-local
    batch hands its arrays over by reference (nothing crosses a wire).
    Receivers drain their inbox per destination partition with
    :meth:`take_dest`, decoding wire batches back to (mask, values).

    Posts and inbox pops take a lock, so W send loops may post at once:
    racing senders only permute entries with distinct source partitions,
    and :meth:`take_dest` gives each p its own row — the receive view, the
    integer batch tallies and ``bytes_sent`` (a float64 sum of integer
    byte counts) are independent of thread order.

    Multi-query passes :meth:`post_mq` one batch per nonempty (p, q) with
    the Q queries' send masks, and drain with :meth:`take_dest_mq` into
    [Q, P, v_max] views."""

    def __init__(self, num_workers: int, v_max: int,
                 compression: bool = True):
        self.num_workers = num_workers
        self.v_max = v_max
        self.compression = compression
        # inbox[w][q] -> [(p, entry)]; entry is ("local", mask, values),
        # ("wire", fmt, count, payload), ("local_mq", masks, values),
        # ("wire_mq_panel", cols, union_count, payload) or
        # ("wire_mq_legacy", [(j, fmt, count, payload), ...])
        self._inbox: list[dict[int, list]] = [
            {} for _ in range(num_workers)]
        self._lock = threading.Lock()
        self.bytes_sent = 0.0
        self.pair_batches = 0
        self.slab_batches = 0
        self.vpair_batches = 0
        self.uval_batches = 0
        self.mq_batches = 0
        self.bytes_by_sender = np.zeros(num_workers, np.float64)
        # posted[src worker, dst worker]: the diagonal counts by-reference
        # hand-offs, every off-diagonal entry a serialized wire batch
        self.posted = np.zeros((num_workers, num_workers), np.int64)

    def _put_entry(self, src_worker: int, dst_worker: int, q: int, p: int,
                   entry: tuple) -> None:
        """File one posted entry in (dst_worker, q)'s inbox.  The process
        transport (:class:`repro_torch.core.transport.ProcExchange`)
        overrides it to frame entries for another rank onto a socket;
        ``src_worker`` keys its sender ledger."""
        with self._lock:
            self._inbox[dst_worker].setdefault(q, []).append((p, entry))

    def post(self, src_worker: int, dst_worker: int, p: int, q: int,
             mask: np.ndarray, values: np.ndarray,
             count: int | None = None) -> None:
        """Post source partition p's batch for destination q.  ``count``
        is the mask's popcount when the sender already has it."""
        if src_worker == dst_worker:
            with self._lock:
                self.posted[src_worker, dst_worker] += 1
            self._put_entry(src_worker, dst_worker, q, p,
                            ("local", mask, values))
            return
        if count is None:
            count = int(mask.sum())
        fmt, payload = encode_batch(mask, values, count,
                                    compression=self.compression)
        with self._lock:
            self.bytes_sent += len(payload)
            self.bytes_by_sender[src_worker] += len(payload)
            self._tally(fmt)
            self.posted[src_worker, dst_worker] += 1
        self._put_entry(src_worker, dst_worker, q, p,
                        ("wire", fmt, count, payload))

    def _tally(self, fmt: int) -> None:
        """Count one serialized solo-format batch (caller holds the lock)."""
        if fmt == FMT_SLAB:
            self.slab_batches += 1
        elif fmt == FMT_VPAIRS:
            self.vpair_batches += 1
        elif fmt == FMT_UVAL:
            self.uval_batches += 1
        else:
            self.pair_batches += 1

    def post_mq(self, src_worker: int, dst_worker: int, p: int, q: int,
                masks: np.ndarray, values: np.ndarray,
                counts: Sequence[int]) -> None:
        """Post one multi-query (p, q) batch: ``masks`` / ``values`` are
        [Q, v_max] per-query send masks and message values, ``counts``
        their popcounts (at least one nonzero).  A batch that crosses
        workers is serialized as the cheaper of the two arms
        :func:`repro_torch.core.phases.mq_wire_bytes` prices: the Q
        solo-format batches of its nonempty columns, or (compression on)
        one shared-index panel, taken only when strictly shorter — so
        ``bytes_sent`` equals the model by construction.  A worker-local
        batch hands its arrays over by reference and costs no bytes."""
        if src_worker == dst_worker:
            with self._lock:
                self.posted[src_worker, dst_worker] += 1
            self._put_entry(src_worker, dst_worker, q, p,
                            ("local_mq", masks, values))
            return
        items = []
        legacy_sum = 0
        for j, c in enumerate(counts):
            if not c:
                continue
            fmt, payload = encode_batch(masks[j], values[j], int(c),
                                        compression=self.compression)
            legacy_sum += len(payload)
            items.append((j, fmt, int(c), payload))
        if self.compression:
            union = np.asarray(masks, bool).any(axis=0)
            cols, payload = mq_encode_panel(masks, values, union, counts)
            if len(payload) < legacy_sum:
                with self._lock:
                    self.bytes_sent += len(payload)
                    self.bytes_by_sender[src_worker] += len(payload)
                    self.mq_batches += 1
                    self.posted[src_worker, dst_worker] += 1
                self._put_entry(src_worker, dst_worker, q, p, (
                    "wire_mq_panel", cols, int(union.sum()), payload))
                return
        with self._lock:
            self.bytes_sent += legacy_sum
            self.bytes_by_sender[src_worker] += legacy_sum
            for _, fmt, _, _ in items:
                self._tally(fmt)
            self.posted[src_worker, dst_worker] += 1
        self._put_entry(src_worker, dst_worker, q, p,
                        ("wire_mq_legacy", items))

    def take_dest_mq(self, dst_worker: int, q: int, p_cnt: int,
                     num_queries: int, device=None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Assemble destination partition q's multi-query receive view:
        (recv_mask [Q, P, v_max], recv_msg [Q, P, v_max]).  ``device``
        decodes every gap stream there — the panel's union stream and the
        legacy items' (:func:`_gap_decode`)."""
        recv_mask = np.zeros((num_queries, p_cnt, self.v_max), bool)
        recv_msg = np.zeros((num_queries, p_cnt, self.v_max), np.float32)
        with self._lock:
            entries = self._inbox[dst_worker].pop(q, ())
        for p, entry in entries:
            if entry[0] == "local_mq":
                _, masks, values = entry
                m = np.asarray(masks, bool)
                recv_mask[:, p] = m
                recv_msg[:, p] = np.where(m, values, 0.0)
            elif entry[0] == "wire_mq_panel":
                _, cols, u, payload = entry
                recv_mask[:, p], recv_msg[:, p] = mq_decode_panel(
                    cols, payload, u, self.v_max, num_queries, device)
            else:
                for j, fmt, count, payload in entry[1]:
                    recv_mask[j, p], recv_msg[j, p] = decode_batch(
                        fmt, payload, count, self.v_max, device=device)
        return recv_mask, recv_msg

    def take_dest(self, dst_worker: int, q: int, p_cnt: int, device=None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Assemble destination partition q's receive-major view:
        (recv_mask [P, v_max], recv_msg [P, v_max]).  ``device`` decodes
        the gap streams there (:func:`decode_batch`)."""
        recv_mask = np.zeros((p_cnt, self.v_max), bool)
        recv_msg = np.zeros((p_cnt, self.v_max), np.float32)
        with self._lock:
            entries = self._inbox[dst_worker].pop(q, ())
        for p, entry in entries:
            if entry[0] == "local":
                _, mask, values = entry
                m = np.asarray(mask, bool)
                recv_mask[p] = m
                recv_msg[p] = np.where(m, values, 0.0)
            else:
                _, fmt, count, payload = entry
                recv_mask[p], recv_msg[p] = decode_batch(
                    fmt, payload, count, self.v_max, device=device)
        return recv_mask, recv_msg

    def counter_snapshot(self) -> dict:
        """Every measured-wire counter as plain values (integer tallies and
        float64 sums of integer byte counts, exact under reordering)."""
        with self._lock:
            return {
                "bytes_sent": self.bytes_sent,
                "pair_batches": self.pair_batches,
                "slab_batches": self.slab_batches,
                "vpair_batches": self.vpair_batches,
                "uval_batches": self.uval_batches,
                "mq_batches": self.mq_batches,
                "bytes_by_sender": self.bytes_by_sender.copy(),
                "posted": self.posted.copy(),
            }


class DecodeAhead:
    """Decode-ahead over a worker's destination partitions.

    Iterates ``(q, recv_mask [P, v_max], recv_msg [P, v_max])`` for each
    owned destination partition — given ``num_queries``, the
    [Q, P, v_max] views of :meth:`Exchange.take_dest_mq` — assembling
    partition *q+1*'s view on a thread of its own (or on ``runner``, a
    long-lived executor) while the consumer works on *q*.  In the dist_ooc
    executor the consumer is the worker's lazy schedule, advanced on the
    chunk prefetch thread, so wire decode, dispatch, disk reads and
    combine all overlap.  Each take runs holding ``compute_lock`` (the
    shared compute token, never held across a queue put or get).
    ``device`` decodes the gap streams there; ``take_s`` sums the host
    seconds spent in the takes.  Exceptions re-raise in the consumer.

    The multi-query views follow from ``num_queries`` being given, not from
    its being above 1: the reference takes solo views at Q = 1 and so fails
    on a one-query multi-query pass, whose inbox holds panel entries.
    """

    _DONE = object()

    def __init__(self, exchange: Exchange, worker: int,
                 dests: Sequence[int], p_cnt: int, depth: int = 1,
                 compute_lock=None, runner=None, device=None,
                 num_queries: int | None = None):
        self._exchange = exchange
        self._worker = worker
        self._dests = list(dests)
        self._p_cnt = p_cnt
        self._device = device
        self._num_queries = num_queries
        self.take_s = 0.0      # host seconds in the takes (wire decode)
        self._lock_ctx = token_ctx(compute_lock)
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        if runner is None:
            thread = threading.Thread(target=self._run, daemon=True)
            thread.start()
            self._join = thread.join
        else:
            future = runner.submit(self._run)
            self._join = future.exception

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for q in self._dests:
                with self._lock_ctx:       # compute token: decode burst
                    t0 = time.perf_counter()
                    if self._num_queries is not None:
                        mask, msg = self._exchange.take_dest_mq(
                            self._worker, q, self._p_cnt, self._num_queries,
                            device=self._device)
                    else:
                        mask, msg = self._exchange.take_dest(
                            self._worker, q, self._p_cnt, device=self._device)
                    self.take_s += time.perf_counter() - t0
                if not self._put((q, mask, msg)):
                    return
            self._put(self._DONE)
        except BaseException as exc:       # propagate to the consumer
            self._put(exc)

    def close(self) -> None:
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._join()

    def __iter__(self) -> Iterator[tuple]:
        try:
            while True:
                item = self._queue.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.close()
