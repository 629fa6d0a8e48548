"""Socket transport for multi-process dist_ooc (DESIGN.md §13) — the port
of ``repro.core.transport``.  Its frames, run logs and recovery protocol are
the reference's byte for byte, so ranks of either package read what the
other wrote.

Promotes the W "workers" of the dist_ooc executor from threads in one
process to W (or fewer) separate OS processes, each owning a subset of the
**logical workers** — the fixed-W roles that key the wire pricing, the
spill layout and the chunk shards.  Decoupling logical workers from
physical ranks is what makes recovery counter-preserving: a dead rank's
workers are adopted by survivors (``runtime.elastic.plan_worker_recovery``)
and every byte model still prices the same W-worker topology, so the
recovered run's counters are bit-identical to a failure-free one.

Three layers:

* **Framing** — pure functions (:func:`pack_frame` / :func:`read_frame` /
  :func:`entry_to_frame` / :func:`frame_to_entry`) that map the Exchange's
  posted entries onto length-prefixed socket frames, one frame per posted
  batch, for every wire format the Exchange speaks (pairs / slab / vpairs /
  uval / mq panel).  The *payload* crossing the socket is byte-identical to
  what :func:`repro_torch.core.exchange.encode_batch` priced, so
  ``measured_net_bytes == net_bytes`` survives the transport swap by
  construction; the fixed header is O(1) framing metadata, unpriced exactly
  like the thread Exchange's out-of-band ``(p, q, fmt, count)`` scalars.

* **Mesh** — :class:`ProcMesh`: one persistent TCP connection per rank
  pair (port-file rendezvous under a shared directory), a receiver thread
  per peer demultiplexing DATA frames into per-(op, dst worker, dest
  partition) inboxes and CONTROL frames into a tagged slot table.  Peer
  death is an EOF: the receiver marks the rank dead and every blocked
  collective wakes and raises :class:`WorkerDied`.

* **Context** — :class:`ProcContext`: epoch/sequence-tagged collectives
  (allgather / barrier), the sender ledger + receiver completeness check
  that turn dropped frames into deterministic resends and delayed frames
  into next-round deferred deliveries (merged through the slot monoid by
  :func:`repro_torch.runtime.straggler.merge_deferred_entry`), and the recovery
  state machine: FAIL consensus -> deterministic ownership re-plan ->
  checkpoint rollback -> replay (:meth:`ProcContext.recoverable`).

Why replay is safe: every op (one ProcessEdges or ProcessVertices call) is
wrapped in checkpoint-then-barrier-then-body.  A worker's spill state is
checkpointed *before* the ready barrier, and the injected failure points
all precede the dead rank's contribution to the op's final collective — so
no survivor can have committed the op when any rank is still replaying it,
and rollback + replay re-executes the op from identical state on an
identical worker topology.  TCP's per-link FIFO means a sender's data
frames always precede its allgather contribution, so once the send-phase
gather completes, every expected frame either arrived, was dropped (sender
ledger answers the resend request), or is held by the straggler delay
(counted, delivered next op, merged via the monoid).
"""
from __future__ import annotations

import io
import json
import os
import pickle
import select
import socket
import struct
import threading
import time
import zlib

import numpy as np

from repro_torch.core import exchange as exchange_mod
from repro_torch.runtime.elastic import plan_worker_recovery
from repro_torch.runtime.straggler import merge_deferred_entry
from repro_torch.utils import IntegrityError, atomic_write_json, json_crc

# --------------------------------------------------------------------------
# Errors
# --------------------------------------------------------------------------


class TransportError(RuntimeError):
    """Framing / socket / protocol failure (truncated frame, timeout,
    inconsistent resend accounting)."""


class WorkerDied(TransportError):
    """A rank this collective needs is dead (EOF) or has initiated
    recovery (FAIL frame).  Caught by :meth:`ProcContext.recoverable`."""

    def __init__(self, ranks):
        self.ranks = frozenset(int(r) for r in ranks)
        super().__init__(f"worker rank(s) {sorted(self.ranks)} died")


class FrameIntegrityError(IntegrityError, TransportError):
    """A received frame failed its header CRC.  Carries the (possibly
    damaged) parsed header so the receiver can decide: a corrupt DATA
    frame on an in-sync stream is dropped and recovered through the
    ledger redelivery path; a corrupt control frame kills the link."""

    def __init__(self, frame: "Frame", want: int, got: int):
        self.frame = frame
        super().__init__(
            f"wire frame (kind={frame.kind}, epoch={frame.epoch}, "
            f"op={frame.op}, src_w={frame.src_w}, dst_w={frame.dst_w}, "
            f"p={frame.p}, q={frame.q}) failed its checksum "
            f"(header crc {want}, computed {got}) — wire corruption")


# --------------------------------------------------------------------------
# Framing (pure; unit-testable without sockets)
# --------------------------------------------------------------------------

# kind u8 | epoch u32 | op u32 | src_w i32 | dst_w i32 | p i32 | q i32 |
# fmt i32 | count u32 | aux i32 | crc u32 | payload-length u32
# The crc is CRC32 over (header with crc field zeroed) + payload, so a
# flipped byte anywhere in the frame — metadata or data — is detected at
# receive.  The header (crc included) stays O(1) unpriced framing
# metadata: the priced payload bytes are unchanged, so
# ``measured_net_bytes == net_bytes`` is preserved by construction.
_HEADER = struct.Struct("!BIIiiiiiIiII")
HEADER_BYTES = _HEADER.size
_CRC_OFF = _HEADER.size - 8         # byte offset of the crc field

K_HELLO = 0     # src_w = sender rank (connection identification)
K_DATA = 1      # one posted Exchange batch; fmt/count/aux describe it
K_CTRL = 2      # fmt = control code below; q = sequence; payload pickled
K_FAIL = 3      # payload = pickled sorted list of dead ranks
K_HEART = 4     # liveness beacon; src_w = sender rank, no payload

C_GATHER = 0        # allgather / barrier contribution
C_RESEND_REQ = 1    # receiver -> sender: frames missing for an op
C_RESEND_ACK = 2    # sender -> receiver: {resent, held} accounting


class Frame:
    __slots__ = ("kind", "epoch", "op", "src_w", "dst_w", "p", "q",
                 "fmt", "count", "aux", "payload")

    def __init__(self, kind, epoch=0, op=0, src_w=0, dst_w=0, p=0, q=0,
                 fmt=0, count=0, aux=0, payload=b""):
        self.kind = kind
        self.epoch = epoch
        self.op = op
        self.src_w = src_w
        self.dst_w = dst_w
        self.p = p
        self.q = q
        self.fmt = fmt
        self.count = count
        self.aux = aux
        self.payload = payload


def pack_frame(kind, *, epoch=0, op=0, src_w=0, dst_w=0, p=0, q=0,
               fmt=0, count=0, aux=0, payload=b"") -> bytes:
    head = _HEADER.pack(kind, epoch, op, src_w, dst_w, p, q, fmt,
                        count, aux, 0, len(payload))
    crc = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
    return _HEADER.pack(kind, epoch, op, src_w, dst_w, p, q, fmt,
                        count, aux, crc, len(payload)) + payload


def read_exact(read, n: int) -> bytes:
    """Read exactly ``n`` bytes from ``read`` (a ``file.read``-like
    callable that may return short).  Raises :class:`TransportError` on a
    partial read — a peer that closed mid-frame — and returns ``b""``
    only for a clean EOF at ``n == 0`` boundaries (callers ask for the
    full amount)."""
    if n == 0:
        return b""
    parts = []
    got = 0
    while got < n:
        chunk = read(n - got)
        if not chunk:
            raise TransportError(
                f"truncated frame: expected {n} bytes, got {got} before "
                f"EOF")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def read_frame(read) -> Frame | None:
    """Read one frame; ``None`` on a clean EOF at a frame boundary,
    :class:`TransportError` on a partial header or short payload,
    :class:`FrameIntegrityError` when the frame's CRC does not match
    (the full frame has been consumed from the stream, so an in-sync
    payload flip leaves the link usable)."""
    first = read(1)
    if not first:
        return None
    head = first + read_exact(read, HEADER_BYTES - 1)
    (kind, epoch, op, src_w, dst_w, p, q, fmt, count, aux, crc,
     paylen) = _HEADER.unpack(head)
    payload = read_exact(read, paylen) if paylen else b""
    zeroed = head[:_CRC_OFF] + b"\x00\x00\x00\x00" + head[_CRC_OFF + 4:]
    got = zlib.crc32(payload, zlib.crc32(zeroed)) & 0xFFFFFFFF
    frame = Frame(kind, epoch, op, src_w, dst_w, p, q, fmt, count, aux,
                  payload)
    if got != crc:
        raise FrameIntegrityError(frame, crc, got)
    return frame


_COL = struct.Struct("!iiB")    # mq panel column metadata (j, count, uni)


def entry_to_frame(entry, *, epoch, op, src_w, dst_w, p, q) -> bytes:
    """Serialize one cross-worker Exchange inbox entry as a DATA frame.
    The Exchange already encoded (and priced) the payload; this adds only
    the fixed header — plus, for multi-query panels, the per-column
    framing metadata (O(Q) scalars, unpriced like the thread Exchange's
    out-of-band ``cols`` list)."""
    tag = entry[0]
    if tag == "wire":
        _, fmt, count, payload = entry
        return pack_frame(K_DATA, epoch=epoch, op=op, src_w=src_w,
                          dst_w=dst_w, p=p, q=q, fmt=fmt, count=count,
                          payload=payload)
    if tag == "wire_mq_panel":
        _, cols, u, payload = entry
        meta = b"".join(_COL.pack(j, c, int(uni)) for j, c, uni in cols)
        return pack_frame(K_DATA, epoch=epoch, op=op, src_w=src_w,
                          dst_w=dst_w, p=p, q=q,
                          fmt=exchange_mod.FMT_MQPANEL, count=u,
                          aux=len(cols), payload=meta + payload)
    raise TransportError(
        f"entry kind {tag!r} cannot cross the process transport")


def frame_to_entry(frame: Frame):
    """Inverse of :func:`entry_to_frame` -> the Exchange inbox entry."""
    if frame.fmt == exchange_mod.FMT_MQPANEL:
        nb = frame.aux * _COL.size
        cols = [(j, c, bool(uni)) for j, c, uni in
                (_COL.unpack(frame.payload[i:i + _COL.size])
                 for i in range(0, nb, _COL.size))]
        return ("wire_mq_panel", cols, frame.count, frame.payload[nb:])
    return ("wire", frame.fmt, frame.count, frame.payload)


def frame_roundtrip(entry, **kw):
    """Test helper: entry -> framed bytes -> parsed frame -> entry."""
    raw = entry_to_frame(entry, **kw)
    frame = read_frame(io.BytesIO(raw).read)
    return frame, frame_to_entry(frame)


# --------------------------------------------------------------------------
# Mesh: persistent pairwise sockets + receiver threads
# --------------------------------------------------------------------------


class _Peer:
    def __init__(self, rank: int, sock: socket.socket, rfile=None):
        self.rank = rank
        self.sock = sock
        # One buffered reader per socket for its whole life: a reader may
        # buffer past the frame it was asked for, so re-wrapping the
        # socket would silently drop bytes.
        self.rfile = rfile if rfile is not None else sock.makefile("rb")
        self.send_lock = threading.Lock()
        self.alive = True
        # Monotonic time of the last byte received FROM this peer; the
        # heartbeat protocol keeps this fresh on an idle-but-healthy
        # link, so staleness beyond the stall timeout means the peer is
        # wedged (stalled mid-frame, livelocked, paused) even though the
        # socket is still open.
        self.last_recv = time.monotonic()

    def send(self, data: bytes) -> None:
        with self.send_lock:
            self.sock.sendall(data)

    def send_stalled(self, data: bytes, prefix: int, seconds: float
                     ) -> None:
        """Fault-injection path: write ``prefix`` bytes of the frame,
        freeze for ``seconds`` while HOLDING the send lock (heartbeats to
        this peer stall with us, exactly like a wedged sender thread),
        then send the remainder.  A short stall resolves into a clean
        delivery; a long one trips the receiver's stall detector."""
        with self.send_lock:
            self.sock.sendall(data[:prefix])
            time.sleep(seconds)
            self.sock.sendall(data[prefix:])

    def readable(self) -> bool:
        """Whether bytes from this peer wait unread in the socket."""
        try:
            return bool(select.select([self.sock], [], [], 0)[0])
        except (OSError, ValueError):
            return False

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class ProcMesh:
    """All-pairs TCP mesh with port-file rendezvous.

    Rank r listens on an ephemeral loopback port published as
    ``rank{r}.port`` under the shared rendezvous directory, dials every
    rank s < r (identifying itself with a HELLO frame) and accepts from
    every rank s > r.  One receiver thread per peer demultiplexes frames;
    EOF marks the peer dead and wakes every waiter."""

    def __init__(self, rank: int, world: int, rendezvous_dir: str,
                 connect_timeout: float = 60.0,
                 stall_timeout: float = 30.0):
        self.rank = rank
        self.world = world
        self.stall_timeout = stall_timeout
        self.cv = threading.Condition()
        self.peers: dict[int, _Peer] = {}
        self.dead: set[int] = set()
        # corrupt_frames[src rank] -> count of CRC-failed DATA frames
        # dropped on receive (recovered via ledger redelivery)
        self.corrupt_frames: dict[int, int] = {}
        self.corrupt_handler = None         # set by ProcContext (stats)
        # ctrl[(epoch, code, seq, sender rank)] -> unpickled object
        self._ctrl: dict[tuple, object] = {}
        # fails[rank] -> (epoch, frozenset of dead ranks): latest report.
        # Epoch-tagged so reports from a COMPLETED recovery never abort
        # post-recovery collectives.
        self.fails: dict[int, tuple] = {}
        # data[op][(dst_w, q)] -> list of (p, entry, epoch, src_w)
        self._data: dict[int, dict] = {}
        # arrived[(op, epoch, src_w, dst_w)] -> list of (p, q)
        self._arrived: dict[tuple, list] = {}
        self.resend_handler = None          # set by ProcContext
        self._threads: list[threading.Thread] = []
        self._hb_stop = threading.Event()
        if world > 1:
            self._rendezvous(rendezvous_dir, connect_timeout)
            for peer in self.peers.values():
                t = threading.Thread(target=self._recv_loop, args=(peer,),
                                     daemon=True)
                t.start()
                self._threads.append(t)
            t = threading.Thread(target=self._heartbeat_loop, daemon=True)
            t.start()
            self._threads.append(t)

    # -- connection setup ---------------------------------------------------

    def _rendezvous(self, rdir: str, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        listener = socket.create_server(("127.0.0.1", 0))
        port = listener.getsockname()[1]
        tmp = os.path.join(rdir, f".rank{self.rank}.port.tmp")
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, os.path.join(rdir, f"rank{self.rank}.port"))

        accepted: dict[int, _Peer] = {}
        accept_err: list[BaseException] = []

        def accept_loop():
            try:
                need = self.world - 1 - self.rank
                listener.settimeout(1.0)
                while len(accepted) < need:
                    if time.monotonic() > deadline:
                        raise TransportError(
                            f"rank {self.rank}: rendezvous accept timed "
                            f"out with {len(accepted)}/{need} peers")
                    try:
                        sock, _ = listener.accept()
                    except socket.timeout:
                        continue
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                    1)
                    rfile = sock.makefile("rb")
                    hello = read_frame(rfile.read)
                    if hello is None or hello.kind != K_HELLO:
                        raise TransportError(
                            f"rank {self.rank}: bad rendezvous hello")
                    accepted[hello.src_w] = _Peer(hello.src_w, sock,
                                                  rfile=rfile)
            except BaseException as exc:   # surface in main thread
                accept_err.append(exc)

        acceptor = threading.Thread(target=accept_loop, daemon=True)
        acceptor.start()
        for s in range(self.rank):
            self.peers[s] = _Peer(s, self._dial(rdir, s, deadline))
        acceptor.join(timeout)
        if accept_err:
            raise accept_err[0]
        if acceptor.is_alive():
            raise TransportError(
                f"rank {self.rank}: rendezvous accept did not finish")
        self.peers.update(accepted)
        listener.close()

    def _dial(self, rdir: str, s: int, deadline: float) -> socket.socket:
        """Connect to rank ``s`` with bounded exponential backoff,
        re-reading the port file on every attempt — a peer that restarts
        (whole-job resume) republishes a fresh port, and a connection
        refused right after the file appears is a startup race, not a
        failure."""
        path = os.path.join(rdir, f"rank{s}.port")
        delay = 0.02
        while True:
            try:
                with open(path) as f:
                    peer_port = int(f.read().strip())
                sock = socket.create_connection(
                    ("127.0.0.1", peer_port),
                    timeout=max(0.1, min(5.0,
                                         deadline - time.monotonic())))
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.sendall(pack_frame(K_HELLO, src_w=self.rank))
                return sock
            except (OSError, ValueError):
                if time.monotonic() > deadline:
                    raise TransportError(
                        f"rank {self.rank}: rendezvous with rank {s} "
                        f"timed out (port file {path})")
                time.sleep(delay)
                delay = min(delay * 2, 1.0)

    # -- receive path -------------------------------------------------------

    def _recv_loop(self, peer: _Peer) -> None:
        while True:
            try:
                frame = read_frame(peer.rfile.read)
            except FrameIntegrityError as exc:
                peer.last_recv = time.monotonic()
                if exc.frame.kind == K_DATA:
                    # The full frame was consumed, so the stream is still
                    # in sync: drop it, count it, and let the receiver's
                    # completeness check trigger a ledger redelivery of a
                    # clean copy — never a garbage frame accepted.
                    with self.cv:
                        self.corrupt_frames[peer.rank] = (
                            self.corrupt_frames.get(peer.rank, 0) + 1)
                    handler = self.corrupt_handler
                    if handler is not None:
                        handler(peer.rank, exc.frame)
                    continue
                # A corrupt control/fail/hello frame cannot be trusted to
                # have parsed its own length correctly — kill the link
                # and let recovery own it.
                frame = None
            except (TransportError, OSError, ValueError):
                frame = None
            if frame is None:
                self._mark_dead(peer.rank)
                return
            peer.last_recv = time.monotonic()
            self._dispatch(peer, frame)

    def _mark_dead(self, rank: int) -> None:
        with self.cv:
            self.dead.add(rank)
            peer = self.peers.get(rank)
            if peer is not None:
                peer.alive = False
            self.cv.notify_all()

    def _dispatch(self, peer: _Peer, frame: Frame) -> None:
        if frame.kind == K_DATA:
            entry = frame_to_entry(frame)
            with self.cv:
                box = self._data.setdefault(frame.op, {})
                box.setdefault((frame.dst_w, frame.q), []).append(
                    (frame.p, entry, frame.epoch, frame.src_w))
                self._arrived.setdefault(
                    (frame.op, frame.epoch, frame.src_w, frame.dst_w),
                    []).append((frame.p, frame.q))
                self.cv.notify_all()
        elif frame.kind == K_CTRL:
            if frame.fmt == C_RESEND_REQ:
                handler = self.resend_handler
                if handler is not None:
                    handler(frame)          # replies on the peer's socket
                return
            obj = pickle.loads(frame.payload)
            with self.cv:
                self._ctrl[(frame.epoch, frame.fmt, frame.q,
                            frame.src_w)] = obj
                self.cv.notify_all()
        elif frame.kind == K_FAIL:
            reported = frozenset(pickle.loads(frame.payload))
            with self.cv:
                self.fails[frame.src_w] = (frame.epoch, reported)
                self.cv.notify_all()
        elif frame.kind == K_HEART:
            pass        # liveness already recorded via peer.last_recv

    # -- liveness -----------------------------------------------------------

    def _heartbeat_loop(self) -> None:
        """Periodic liveness beacon to every live peer.  The interval is
        a quarter of the stall timeout, so a healthy-but-idle peer
        refreshes ``last_recv`` several times per detection window; a
        peer wedged mid-frame blocks our sender lock and stops
        heartbeating, which is exactly the signal."""
        interval = max(0.05, self.stall_timeout / 4.0)
        beat = pack_frame(K_HEART, src_w=self.rank)
        while not self._hb_stop.wait(interval):
            for peer in list(self.peers.values()):
                if not peer.alive:
                    continue
                try:
                    peer.send(beat)
                except OSError:
                    self._mark_dead(peer.rank)

    def check_stalls(self, ranks) -> None:
        """Mark any waited-on peer silent beyond ``stall_timeout`` as
        dead.  Called from inside the collective wait loops: a stalled-
        but-open peer then raises :class:`WorkerDied` on the next loop
        iteration and flows into the normal recovery path, instead of
        blocking until ``io_timeout``."""
        with self.cv:
            self._check_stalls_locked(ranks)

    def _check_stalls_locked(self, ranks) -> None:
        """:meth:`check_stalls` body for callers already holding ``cv``
        (the Condition's lock is not re-entrant).

        A peer whose socket holds unread bytes is alive, however old its
        ``last_recv``: this rank's receiver thread has not run to read
        them (its main thread kept the interpreter, in a long call of its
        own), which says nothing about the peer.  The reference declares
        it dead; a sender wedged mid-frame still leaves nothing to read."""
        now = time.monotonic()
        hit = False
        for r in ranks:
            peer = self.peers.get(r)
            if (peer is not None and peer.alive
                    and now - peer.last_recv > self.stall_timeout):
                if peer.readable():
                    peer.last_recv = now
                    continue
                self.dead.add(r)
                peer.alive = False
                hit = True
        if hit:
            self.cv.notify_all()

    # -- send path ----------------------------------------------------------

    def send_to_rank(self, rank: int, data: bytes,
                     ignore_dead: bool = False, stall=None) -> None:
        peer = self.peers[rank]
        try:
            if stall is not None:
                peer.send_stalled(data, stall[0], stall[1])
            else:
                peer.send(data)
        except OSError:
            self._mark_dead(rank)
            if not ignore_dead:
                raise WorkerDied({rank})

    # -- waiting ------------------------------------------------------------

    def wait_ctrl(self, epoch: int, code: int, seq: int, ranks,
                  timeout: float, fail_is_fatal: bool = True) -> dict:
        """Block until a control slot (epoch, code, seq, r) is filled for
        every r in ``ranks``.  Raises :class:`WorkerDied` if a still-
        missing rank is dead, or — when ``fail_is_fatal`` — when any rank
        broadcasts a FAIL for this epoch or later (a peer initiating
        recovery must pull every survivor out of its collective)."""
        deadline = time.monotonic() + timeout
        with self.cv:
            while True:
                missing = [r for r in ranks
                           if (epoch, code, seq, r) not in self._ctrl]
                if not missing:
                    return {r: self._ctrl.pop((epoch, code, seq, r))
                            for r in ranks}
                self._check_stalls_locked(missing)
                dead = [r for r in missing if r in self.dead]
                if dead:
                    raise WorkerDied(dead)
                if fail_is_fatal:
                    for rr, (rep_epoch, reported) in list(
                            self.fails.items()):
                        if rep_epoch >= epoch and reported:
                            # a peer initiated recovery this epoch: every
                            # survivor must leave its collective and join
                            self.dead |= reported
                            raise WorkerDied(reported)
                if time.monotonic() > deadline:
                    raise TransportError(
                        f"rank {self.rank}: timed out waiting for ctrl "
                        f"(epoch={epoch}, code={code}, seq={seq}) from "
                        f"{missing}")
                self.cv.wait(0.2)

    # -- data inbox ---------------------------------------------------------

    def count_arrived(self, op: int, epoch: int, src_w: int,
                      dst_w: int) -> int:
        with self.cv:
            return len(self._arrived.get((op, epoch, src_w, dst_w), ()))

    def arrived_keys(self, op: int, epoch: int, src_w: int,
                     dst_w: int) -> list:
        with self.cv:
            return list(self._arrived.get((op, epoch, src_w, dst_w), ()))

    def drain_data(self, op: int, epoch: int, dst_w: int, q: int):
        """Pop and split this destination's socket arrivals: ``cur`` —
        current-op entries of the current epoch (stale replay leftovers
        are dropped) — and ``late`` — any entries filed under earlier
        ops, i.e. straggler-deferred deliveries, sorted by (op, p) for a
        deterministic merge order."""
        cur, late = [], []
        with self.cv:
            for o in sorted(self._data):
                if o > op:
                    continue
                entries = self._data[o].pop((dst_w, q), None)
                if not entries:
                    continue
                for (p, entry, ep, src_w) in entries:
                    if o == op:
                        if ep == epoch:
                            cur.append((p, entry))
                    else:
                        late.append((o, p, entry, ep, src_w))
        late.sort(key=lambda t: (t[0], t[1]))
        return cur, late

    def restore_late(self, items) -> None:
        """Re-file consumed deferred entries (rollback path: a replayed op
        must see the same late deliveries its failed attempt consumed)."""
        with self.cv:
            for (o, p, entry, ep, src_w, dst_w, q) in items:
                self._data.setdefault(o, {}).setdefault(
                    (dst_w, q), []).append((p, entry, ep, src_w))
            self.cv.notify_all()

    def purge_op(self, op: int, min_epoch: int) -> None:
        """Drop the replayed op's stale-epoch data and arrival tallies."""
        with self.cv:
            box = self._data.get(op)
            if box:
                for key in list(box):
                    box[key] = [e for e in box[key] if e[2] >= min_epoch]
                    if not box[key]:
                        del box[key]
            for key in [k for k in self._arrived
                        if k[0] == op and k[1] < min_epoch]:
                del self._arrived[key]

    def purge_older(self, op: int) -> None:
        """Drop fully-consumed inbox state for committed ops < op."""
        with self.cv:
            for o in [o for o in self._data if o < op]:
                del self._data[o]
            for key in [k for k in self._arrived if k[0] < op]:
                del self._arrived[key]

    def broadcast_fail(self, epoch: int, dead: frozenset) -> None:
        payload = pickle.dumps(sorted(dead))
        frame = pack_frame(K_FAIL, epoch=epoch, src_w=self.rank,
                           payload=payload)
        for r, peer in self.peers.items():
            # Reported-dead peers get the FAIL too (best-effort): a
            # genuinely dead process ignores it, but a STALLED peer that
            # wakes up learns it was declared dead and exits promptly
            # instead of hanging until io_timeout.
            self.send_to_rank(r, frame, ignore_dead=True)

    def purge_ctrl(self, min_epoch: int) -> None:
        """Drop control slots from aborted pre-recovery epochs."""
        with self.cv:
            for key in [k for k in self._ctrl if k[0] < min_epoch]:
                del self._ctrl[key]

    def close(self) -> None:
        self._hb_stop.set()
        for peer in self.peers.values():
            peer.close()


# --------------------------------------------------------------------------
# ProcContext: collectives, fault protocol, recovery state machine
# --------------------------------------------------------------------------


class ProcContext:
    """Per-process handle for one multi-process dist_ooc run.

    Owns the logical-worker -> rank assignment, the epoch (bumped on each
    recovery), the per-op sender ledger (resend source of truth), the
    straggler hold queue, and the recovery loop the engine wraps every op
    in (:meth:`recoverable`)."""

    RUNLOG_VERSION = 1

    def __init__(self, rank: int, world: int, num_workers: int,
                 rendezvous_dir: str, run_id: str = "run",
                 injector=None, io_timeout: float = 180.0,
                 stall_timeout: float = 30.0, log_dir: str | None = None,
                 resume: bool = False):
        if world > num_workers:
            raise TransportError(
                f"world size {world} exceeds num_workers {num_workers}: "
                f"every rank must own at least one logical worker")
        self.rank = rank
        self.world = world
        self.num_workers = num_workers
        self.run_id = run_id
        self.injector = injector
        self.io_timeout = io_timeout
        self.epoch = 0
        self.op_seq = 0          # recoverable-op counter (PE + PV calls)
        self.pe_seq = 0          # ProcessEdges call counter (fault keying)
        self._seq = 0            # collective sequence within the epoch
        self._p2p_seq = 0        # point-to-point (resend) sequence
        # durable run manifest (whole-job restart, DESIGN.md §14): every
        # committed op's record is appended to runlog_r{rank}.json under
        # log_dir; resume fast-forwards through ops <= resume_op.
        self.log_dir = log_dir
        self.resume = bool(resume)
        self.resume_op = 0
        self._runlog: dict[int, dict] = {}
        # initial ownership: round-robin, deterministic on every rank
        self.assign = [w % world for w in range(num_workers)]
        self.initial_assign = list(self.assign)
        self.mesh = ProcMesh(rank, world, rendezvous_dir,
                             stall_timeout=stall_timeout)
        self.mesh.resend_handler = self._on_resend_req
        self.mesh.corrupt_handler = self._on_corrupt_frame
        self._engines: list = []
        self._lock = threading.Lock()
        # ledger[op][(src_w, dst_w)][(p, q)] -> dict(state=..., fields)
        self._ledger: dict[int, dict] = {}
        # held[op] -> list of ledger records awaiting next-op flush
        self._held: dict[int, list] = {}
        # deferred frames promised for op (from resend acks), per src_w
        self._op_deferred: dict[int, int] = {}
        # late entries consumed by op's takes (restored on rollback)
        self._consumed_late: dict[int, list] = {}
        w = num_workers
        self.stats = {
            "wire_frames": np.zeros((w, w), np.int64),
            "dropped": np.zeros((w, w), np.int64),
            "redelivered": np.zeros((w, w), np.int64),
            "held": np.zeros((w, w), np.int64),
            "late_delivered": np.zeros((w, w), np.int64),
            "corrupted": np.zeros((w, w), np.int64),
            "corrupt_frames": np.zeros((w, w), np.int64),
            "recoveries": 0,
            # DATA-frame payload bytes this rank wrote to its sockets
            # (redeliveries included), and the serialized batches it
            # handed between two workers it owns (priced, never framed)
            "socket_payload_bytes": 0,
            "rank_local_wire_bytes": 0,
        }
        self.recovery_s = 0.0    # seconds spent in _recover

    def _on_corrupt_frame(self, rank: int, frame: Frame) -> None:
        """Mesh callback: a CRC-failed DATA frame was dropped on receive
        (counted under the header's worker pair when it parsed sanely)."""
        w = self.num_workers
        if 0 <= frame.src_w < w and 0 <= frame.dst_w < w:
            with self._lock:
                self.stats["corrupt_frames"][frame.src_w, frame.dst_w] += 1

    # -- topology -----------------------------------------------------------

    def my_workers(self) -> list:
        return [w for w in range(self.num_workers)
                if self.assign[w] == self.rank]

    def live_peers(self) -> list:
        with self.mesh.cv:
            return [r for r in range(self.world)
                    if r != self.rank and r not in self.mesh.dead]

    # -- collectives --------------------------------------------------------

    def allgather(self, obj) -> list:
        """Epoch/seq-tagged allgather over live ranks; dead ranks' slots
        are None.  Raises :class:`WorkerDied` if a needed rank dies or
        any peer initiates recovery."""
        seq = self._seq
        self._seq += 1
        peers = self.live_peers()
        frame = pack_frame(K_CTRL, epoch=self.epoch, op=self.op_seq,
                           src_w=self.rank, q=seq, fmt=C_GATHER,
                           payload=pickle.dumps(obj, protocol=4))
        broken = []
        for r in peers:
            try:
                self.mesh.send_to_rank(r, frame)
            except WorkerDied:
                broken.append(r)
        if broken:
            raise WorkerDied(broken)
        got = self.mesh.wait_ctrl(self.epoch, C_GATHER, seq, peers,
                                  self.io_timeout)
        out = [None] * self.world
        for r, v in got.items():
            out[r] = v
        out[self.rank] = obj
        return out

    def barrier(self) -> None:
        self.allgather(None)

    def gather_by_worker(self, mine: dict) -> list:
        """Allgather per-rank ``{worker: payload}`` dicts and assemble
        the [W] list — every logical worker's slot must be filled by
        exactly its owning rank, whatever the current assignment."""
        slots = self.allgather(mine)
        out = [None] * self.num_workers
        seen = [False] * self.num_workers
        for d in slots:
            if not d:
                continue
            for w, v in d.items():
                if seen[w]:
                    raise TransportError(
                        f"worker {w} reported by two ranks")
                out[w] = v
                seen[w] = True
        missing = [w for w in range(self.num_workers) if not seen[w]]
        if missing:
            # a rank that died before the collective started contributes
            # a silent None slot — surface its workers' absence as the
            # death itself so recoverable() re-plans ownership
            with self.mesh.cv:
                dead = ({self.assign[w] for w in missing}
                        & set(self.mesh.dead))
            if dead:
                raise WorkerDied(dead)
            raise TransportError(
                f"gather_by_worker: no owner reported workers {missing}")
        return out

    # -- data plane (called by ProcExchange) --------------------------------

    def send_data(self, src_w: int, dst_w: int, q: int, p: int,
                  entry) -> None:
        """Route one cross-rank posted batch: consult the fault injector
        (drop / hold / kill-after-k-frames), record it in the op ledger,
        and frame it onto the destination rank's socket.  Send failures
        to a dying peer are swallowed — the receiver-side completeness
        check plus the resend protocol (or recovery) own correctness."""
        op = self.op_seq
        rec = {"state": "sent", "src_w": src_w, "dst_w": dst_w,
               "p": p, "q": q, "entry": entry, "op": op}
        inj = self.injector
        if inj is not None:
            fault = inj.data_fault(self.pe_seq, src_w, dst_w)
            if fault is not None and fault[0] == "drop":
                rec["state"] = "dropped"
            elif inj.should_hold(self.pe_seq, src_w):
                rec["state"] = "held"
            elif fault is not None and fault[0] == "corrupt":
                # the frame IS sent — with one payload byte flipped; the
                # receiver's CRC rejects it and the completeness check
                # redelivers a clean copy from this ledger record
                rec["corrupt"] = True
            elif fault is not None and fault[0] == "stall":
                rec["stall"] = fault[1]
        with self._lock:
            self._ledger.setdefault(op, {}).setdefault(
                (src_w, dst_w), {})[(p, q)] = rec
            if rec["state"] == "held":
                self._held.setdefault(op, []).append(rec)
            key = {"dropped": "dropped", "held": "held",
                   "sent": "wire_frames"}[rec["state"]]
            self.stats[key][src_w, dst_w] += 1
            if rec.get("corrupt"):
                self.stats["corrupted"][src_w, dst_w] += 1
        if rec["state"] != "sent":
            return
        self._send_record(rec)
        if inj is not None:
            inj.on_frame_sent(self, self.pe_seq, src_w)

    def _send_record(self, rec) -> None:
        data = entry_to_frame(rec["entry"], epoch=self.epoch,
                              op=rec["op"], src_w=rec["src_w"],
                              dst_w=rec["dst_w"], p=rec["p"], q=rec["q"])
        # One-shot fault decorations: popped here so a ledger redelivery
        # of the same record sends a clean, unstalled frame.
        if rec.pop("corrupt", False):
            if len(data) > HEADER_BYTES:
                data = data[:-1] + bytes([data[-1] ^ 0xFF])
            else:       # empty payload: flip a crc byte, header intact
                data = (data[:_CRC_OFF]
                        + bytes([data[_CRC_OFF] ^ 0xFF])
                        + data[_CRC_OFF + 1:])
        stall = rec.pop("stall", None)
        if stall is not None:
            stall = (max(1, len(data) // 2), float(stall))
        with self._lock:
            self.stats["socket_payload_bytes"] += len(data) - HEADER_BYTES
        try:
            self.mesh.send_to_rank(self.assign[rec["dst_w"]], data,
                                   ignore_dead=True, stall=stall)
        except WorkerDied:
            pass

    def flush_held(self, op: int) -> None:
        """Deliver straggler-held frames from every committed op < ``op``
        — the deterministic 'past the deadline' point: the next op's
        send phase is structurally after the delayed op completed
        everywhere.  Frames are re-headed with the current epoch so a
        post-recovery receiver files them as valid late data."""
        with self._lock:
            todo = [rec for o, recs in self._held.items() if o < op
                    for rec in recs if rec["state"] == "held"]
            for rec in todo:
                rec["state"] = "flushed"
                self.stats["late_delivered"][rec["src_w"],
                                             rec["dst_w"]] += 1
        for rec in sorted(todo, key=lambda r: (r["op"], r["p"], r["q"])):
            self._send_record(rec)

    def resolve_arrivals(self, posted: np.ndarray) -> None:
        """Receiver-side completeness check, run after the send-phase
        allgather: ``posted`` is the summed per-(src worker, dst worker)
        posted-batch matrix, so for every cross-rank pair targeting one
        of my workers the expected frame count is known exactly.  TCP
        FIFO guarantees a sender's frames precede its allgather
        contribution, so any shortfall here is a dropped or held frame:
        ask the sender's ledger, drain the resends, and record the held
        count as this op's deferred-delivery promise."""
        op = self.op_seq
        for dst_w in self.my_workers():
            for src_w in range(self.num_workers):
                src_rank = self.assign[src_w]
                if src_rank == self.rank:
                    continue
                expect = int(posted[src_w, dst_w])
                if not expect:
                    continue
                have = self.mesh.count_arrived(op, self.epoch, src_w,
                                               dst_w)
                if have == expect:
                    continue
                got = self.mesh.arrived_keys(op, self.epoch, src_w, dst_w)
                ack = self._resend_request(src_rank, op, src_w, dst_w,
                                           got)
                deadline = time.monotonic() + self.io_timeout
                while (self.mesh.count_arrived(op, self.epoch, src_w,
                                               dst_w)
                       < have + ack["resent"]):
                    with self.mesh.cv:
                        self.mesh._check_stalls_locked([src_rank])
                        if src_rank in self.mesh.dead:
                            raise WorkerDied({src_rank})
                        for _rr, (rep_ep, rep) in list(
                                self.mesh.fails.items()):
                            if rep_ep >= self.epoch and rep:
                                self.mesh.dead |= rep
                                raise WorkerDied(rep)
                    if time.monotonic() > deadline:
                        raise TransportError(
                            f"resent frames from worker {src_w} never "
                            f"arrived")
                    time.sleep(0.002)
                with self._lock:
                    self.stats["redelivered"][src_w, dst_w] += (
                        ack["resent"])
                if have + ack["resent"] + ack["held"] != expect:
                    raise TransportError(
                        f"frame accounting for ({src_w}->{dst_w}) op "
                        f"{op}: posted {expect}, arrived {have}, resent "
                        f"{ack['resent']}, held {ack['held']}")
                self._op_deferred[op] = (self._op_deferred.get(op, 0)
                                         + ack["held"])

    def _resend_request(self, src_rank: int, op: int, src_w: int,
                        dst_w: int, got: list) -> dict:
        self._p2p_seq += 1
        seq = self._p2p_seq
        req = {"op": op, "src_w": src_w, "dst_w": dst_w, "got": got}
        frame = pack_frame(K_CTRL, epoch=self.epoch, op=op,
                           src_w=self.rank, q=seq, fmt=C_RESEND_REQ,
                           payload=pickle.dumps(req, protocol=4))
        self.mesh.send_to_rank(src_rank, frame)
        got_ack = self.mesh.wait_ctrl(self.epoch, C_RESEND_ACK, seq,
                                      [src_rank], self.io_timeout)
        return got_ack[src_rank]

    def _on_resend_req(self, frame: Frame) -> None:
        """Answer a peer's completeness shortfall from the op ledger
        (runs on the mesh receiver thread).  Dropped (and, defensively,
        sent-but-lost) frames are redelivered before the ack on the same
        FIFO link; held frames are only counted — they stay queued for
        the deferred flush."""
        req = pickle.loads(frame.payload)
        with self._lock:
            records = dict(self._ledger.get(req["op"], {}).get(
                (req["src_w"], req["dst_w"]), {}))
        got = set(map(tuple, req["got"]))
        resent = held = 0
        for key in sorted(set(records) - got):
            rec = records[key]
            if rec["state"] == "held":
                held += 1
                continue
            rec["state"] = "redelivered"
            self._send_record(rec)
            resent += 1
        ack = pack_frame(K_CTRL, epoch=frame.epoch, op=req["op"],
                         src_w=self.rank, q=frame.q, fmt=C_RESEND_ACK,
                         payload=pickle.dumps(
                             {"resent": resent, "held": held},
                             protocol=4))
        self.mesh.send_to_rank(frame.src_w, ack, ignore_dead=True)

    def take_socket_entries(self, dst_w: int, q: int):
        """Current-op socket arrivals plus deferred late deliveries for
        one destination partition (consumed late entries are journaled so
        a rollback can re-file them)."""
        cur, late = self.mesh.drain_data(self.op_seq, self.epoch, dst_w,
                                         q)
        if late:
            with self._lock:
                self._consumed_late.setdefault(self.op_seq, []).extend(
                    (o, p, entry, ep, src_w, dst_w, q)
                    for (o, p, entry, ep, src_w) in late)
        return cur, late

    def pending_deferred(self) -> int:
        """Frames promised-but-held for the current op on MY receive side
        (from resend acks).  The executor adds this to the step's update
        total so a driver cannot observe a premature fixpoint while
        deferred messages are still in flight."""
        return int(self._op_deferred.get(self.op_seq, 0))

    # -- recovery -----------------------------------------------------------

    def register_engine(self, engine) -> None:
        self._engines.append(engine)

    def recoverable(self, engine, body, record=None):
        """Run one op (ProcessEdges / ProcessVertices body) with
        checkpoint-rollback-replay recovery.  The sequence per attempt:
        flush straggler-held frames from prior ops, checkpoint my owned
        spills at this op id, ready-barrier, run the body.  On
        :class:`WorkerDied`: FAIL consensus, deterministic ownership
        re-plan, shard/spill adoption, rollback to the op checkpoint,
        epoch bump, replay.

        ``record(out)`` — when given — distills the op's outputs into a
        JSON-able commit record appended to the durable run log, making
        the whole job restartable: after a full-fleet crash,
        :meth:`prepare_resume` + :meth:`resume_take` fast-forward through
        every committed op from these records while the spills restore
        from the per-op checkpoints."""
        self.op_seq += 1
        op = self.op_seq
        for _attempt in range(self.world + 1):
            self.flush_held(op)
            engine._proc_ckpt_save(op)
            if self.injector is not None:
                self.injector.maybe_corrupt_disk(self, engine)
            try:
                self.barrier()
                out = body()
                self._commit_op(op, engine,
                                record(out) if record is not None else None)
                return out
            except WorkerDied:
                t0 = time.perf_counter()
                self._recover(engine, op)
                self.recovery_s += time.perf_counter() - t0
        raise TransportError(
            f"op {op}: recovery did not converge after "
            f"{self.world + 1} attempts")

    def _commit_op(self, op: int, engine=None, rec=None) -> None:
        with self._lock:
            for o in [o for o in self._ledger if o <= op]:
                del self._ledger[o]
            for o in [o for o in self._held
                      if o < op and all(r["state"] != "held"
                                        for r in self._held[o])]:
                del self._held[o]
            for o in [o for o in self._consumed_late if o <= op]:
                del self._consumed_late[o]
            self._op_deferred.pop(op, None)
        self.mesh.purge_older(op)
        if rec is not None and self.log_dir is not None:
            rec = dict(rec)
            rec["engine"] = (self._engines.index(engine)
                             if engine in self._engines else -1)
            self._runlog[op] = rec
            self._write_runlog(op)

    # -- durable run log / whole-job resume ---------------------------------

    def _runlog_path(self, rank: int) -> str:
        return os.path.join(self.log_dir, f"runlog_r{rank}.json")

    def _write_runlog(self, last_committed: int) -> None:
        """Atomically persist every committed op's record (self-checked:
        the document carries its own CRC, so a resume never trusts a
        damaged log)."""
        doc = {"version": self.RUNLOG_VERSION, "run_id": self.run_id,
               "rank": self.rank, "epoch": self.epoch,
               "last_committed": int(last_committed),
               "ops": {str(o): r for o, r in self._runlog.items()}}
        doc["crc"] = json_crc(doc)
        atomic_write_json(self._runlog_path(self.rank), doc)

    def _read_runlog(self, rank: int) -> dict | None:
        """Load + verify one rank's run log; ``None`` when the rank never
        committed an op (no file — resume restarts from the top)."""
        path = self._runlog_path(rank)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        want = doc.get("crc")
        got = json_crc({k: v for k, v in doc.items() if k != "crc"})
        if want is None or got != want:
            raise IntegrityError(
                f"run log {path} failed its checksum (stored {want}, "
                f"computed {got}) — cannot trust the resume point")
        if doc.get("version") != self.RUNLOG_VERSION:
            raise TransportError(
                f"run log {path} has version {doc.get('version')}, "
                f"expected {self.RUNLOG_VERSION}")
        if doc.get("run_id") != self.run_id:
            raise TransportError(
                f"run log {path} belongs to run {doc.get('run_id')!r}, "
                f"not {self.run_id!r} — refusing to resume from it")
        return doc

    def prepare_resume(self) -> None:
        """Compute the resume point after a whole-job crash (called once,
        after every engine has registered).

        Every rank reads ALL ranks' run logs from the shared log dir and
        takes ``R = min(last_committed)`` — a pure function of on-disk
        state, so the fleet agrees on R without a collective.  Records
        for ops ``1..R`` preload the replay log (any rank's record is
        authoritative: the commit gathers synchronize the full per-op
        state on every rank), and each engine restores its owned spills
        to the exact post-R state from the per-op checkpoints."""
        if not self.resume:
            return
        if self.log_dir is None:
            raise TransportError("resume=True requires a log_dir")
        docs = [self._read_runlog(r) for r in range(self.world)]
        resume_op = min((d["last_committed"] if d is not None else 0)
                        for d in docs)
        merged: dict[int, dict] = {}
        for d in docs:
            if d is None:
                continue
            for key, rec in d["ops"].items():
                op = int(key)
                if op <= resume_op and op not in merged:
                    merged[op] = rec
        missing = [op for op in range(1, resume_op + 1)
                   if op not in merged]
        if missing:
            raise TransportError(
                f"resume: run logs are missing committed op records "
                f"{missing} (last_committed={resume_op})")
        self.resume_op = resume_op
        self._runlog = merged
        for eng in self._engines:
            eng._proc_resume_restore(resume_op)

    def resume_take(self, kind: str) -> dict | None:
        """Fast-forward one op: if the next op id was already committed
        by the crashed incarnation, consume its run-log record (the
        engine reconstructs the op's outputs from it, bit-identically)
        instead of executing.  ``None`` means the op must run live."""
        if not self.resume or self.op_seq + 1 > self.resume_op:
            return None
        self.op_seq += 1
        rec = self._runlog.get(self.op_seq)
        if rec is None or rec.get("kind") != kind:
            got = "missing" if rec is None else repr(rec.get("kind"))
            raise TransportError(
                f"resume: run-log record for op {self.op_seq} is {got}, "
                f"but the replay expected {kind!r} — the resumed spec "
                f"does not match the crashed run")
        return rec

    def _recover(self, engine, op: int) -> None:
        # A peer that declared THIS rank dead (stall detection on a
        # wedged-but-alive sender) has already moved on and may have
        # adopted my workers.  A stalled-then-woken rank must exit here,
        # not recover into a split brain where both sides finish the job.
        with self.mesh.cv:
            for _rr, (rep_ep, reported) in list(self.mesh.fails.items()):
                if rep_ep >= self.epoch and self.rank in reported:
                    raise TransportError(
                        "recovery: local rank marked dead by a peer "
                        "(stall detection) — the fleet has moved on "
                        "without this rank")
        agreed = self._consensus()
        live = [r for r in range(self.world) if r not in agreed]
        if self.rank not in live:
            raise TransportError("recovery: local rank marked dead")
        new_assign = plan_worker_recovery(live, self.num_workers,
                                          self.assign)
        adopted = [w for w in range(self.num_workers)
                   if new_assign[w] == self.rank
                   and self.assign[w] != self.rank]
        # Deferred frames this rank flushed in the failed attempt to a
        # rank that then died were lost with that rank's inbox (the
        # reference drops them: its seed-835 fault).  Every such record is
        # still in the hold queue: deliver it again, after the epoch bump,
        # to the worker's new owner.
        with self._lock:
            lost = sorted((rec for recs in self._held.values()
                           for rec in recs if rec["state"] == "flushed"
                           and self.assign[rec["dst_w"]] in agreed),
                          key=lambda r: (r["op"], r["p"], r["q"]))
        self.assign = list(new_assign)
        for eng in self._engines:
            eng._proc_adopt_workers(adopted, in_op=(eng is engine))
        engine._proc_rollback(op)
        # replayed-attempt hygiene: stale in-flight data, ledger entries
        # and held frames of the failed attempt must not leak into the
        # replay (late entries its takes consumed are re-filed first)
        with self._lock:
            relate = self._consumed_late.pop(op, [])
            self._ledger.pop(op, None)
            self._held.pop(op, None)
            self._op_deferred.pop(op, None)
        if relate:
            self.mesh.restore_late(relate)
        self.epoch += 1
        self._redeliver_lost(lost)
        self.mesh.purge_op(op, self.epoch)
        self.mesh.purge_ctrl(self.epoch)
        self._seq = 0
        self.stats["recoveries"] += 1

    def _redeliver_lost(self, records) -> None:
        """Deliver flushed deferred records again under the current
        epoch: filed straight into the inbox as late entries where this
        rank now owns the destination worker, framed to its new owner
        otherwise."""
        for rec in records:
            if self.assign[rec["dst_w"]] == self.rank:
                self.mesh.restore_late([(rec["op"], rec["p"], rec["entry"],
                                         self.epoch, rec["src_w"],
                                         rec["dst_w"], rec["q"])])
            else:
                self._send_record(rec)

    def _consensus(self) -> frozenset:
        """Agree on the dead set: broadcast my view, wait until every
        live rank's latest FAIL report equals the union.  Dead sets only
        grow, so this terminates; every survivor leaves with the same
        set and therefore computes the same recovery plan."""
        deadline = time.monotonic() + self.io_timeout
        while True:
            with self.mesh.cv:
                my = frozenset(self.mesh.dead)
            self.mesh.broadcast_fail(self.epoch, my)
            with self.mesh.cv:
                while True:
                    if time.monotonic() > deadline:
                        raise TransportError(
                            "failure consensus timed out")
                    cur = frozenset(self.mesh.dead)
                    if cur != my:
                        break               # new death: rebroadcast
                    live = [r for r in range(self.world)
                            if r != self.rank and r not in cur]
                    # only reports from THIS epoch's recovery count;
                    # stale reports from a completed recovery are noise
                    reports = {}
                    for r in live:
                        got = self.mesh.fails.get(r)
                        reports[r] = (got[1] if got is not None
                                      and got[0] >= self.epoch else None)
                    if any(v is None for v in reports.values()):
                        self.mesh._check_stalls_locked(live)
                        self.mesh.cv.wait(0.2)
                        continue
                    union = set(my)
                    for v in reports.values():
                        union |= v
                    if union == set(my):
                        if all(v == union for v in reports.values()):
                            return frozenset(union)
                        self.mesh.cv.wait(0.2)  # peers catching up
                        continue
                    self.mesh.dead |= union     # adopt reported deaths
                    break

    def finalize(self) -> None:
        """Graceful end of run: drain any still-held frames, final
        barrier among live ranks, close sockets."""
        try:
            self.flush_held(self.op_seq + 1)
            self.barrier()
        except (TransportError, OSError):
            pass
        self.mesh.close()


# --------------------------------------------------------------------------
# ProcExchange: the Exchange contract over the mesh
# --------------------------------------------------------------------------


class ProcExchange(exchange_mod.Exchange):
    """Exchange whose cross-rank batches travel the socket mesh.

    Posting is unchanged from the thread Exchange — same encoder, same
    measured counters, same ``posted`` matrix — but :meth:`_put_entry`
    frames encoded entries for other ranks onto sockets instead of the
    shared inbox (same-rank cross-worker batches stay local, already
    encoded and priced, exactly as the thread Exchange holds them).
    :meth:`take_dest` additionally drains the mesh inbox: current-op
    arrivals fill their rows one-to-one, and straggler-deferred late
    arrivals merge through the slot monoid
    (:func:`repro_torch.runtime.straggler.merge_deferred_entry`)."""

    def __init__(self, num_workers: int, v_max: int, compression: bool,
                 ctx: ProcContext, merge_op=None):
        super().__init__(num_workers, v_max, compression)
        self.ctx = ctx
        self.merge_op = merge_op

    def _put_entry(self, src_worker: int, dst_worker: int, q: int,
                   p: int, entry: tuple) -> None:
        ctx = self.ctx
        if ctx.assign[dst_worker] == ctx.rank:
            if entry[0] == "wire":
                with ctx._lock:
                    ctx.stats["rank_local_wire_bytes"] += len(entry[3])
            super()._put_entry(src_worker, dst_worker, q, p, entry)
            return
        ctx.send_data(src_worker, dst_worker, q, p, entry)

    def take_dest(self, dst_worker: int, q: int, p_cnt: int, device=None):
        """The thread Exchange's receive view after filing this op's socket
        arrivals; late (deferred) entries merge through the slot monoid,
        their gap streams decoded with the same ``device``."""
        cur, late = self.ctx.take_socket_entries(dst_worker, q)
        for p, entry in cur:
            super()._put_entry(-1, dst_worker, q, p, entry)
        recv_mask, recv_msg = super().take_dest(dst_worker, q, p_cnt,
                                                device=device)
        if late:
            if self.merge_op is None:
                raise TransportError(
                    "deferred delivery needs a slot-monoid merge op")
            for (_o, p, entry, _ep, _src_w) in late:
                if entry[0] != "wire":
                    raise TransportError(
                        "deferred delivery supports solo batches only")
                m2, v2 = exchange_mod.decode_batch(
                    entry[1], entry[3], entry[2], self.v_max, device=device)
                recv_mask[p], recv_msg[p] = merge_deferred_entry(
                    self.merge_op, recv_mask[p], recv_msg[p], m2, v2)
        return recv_mask, recv_msg
