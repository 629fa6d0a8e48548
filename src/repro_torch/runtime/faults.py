"""Deterministic fault injection for process-mode dist_ooc (DESIGN.md §13)
— the port of ``repro.runtime.faults``; a plan's JSON is the reference's.

A :class:`FaultPlan` is a JSON-serializable schedule of failures keyed by
ProcessEdges call index (``pe`` — the engine's ``proc_ctx.pe_seq``, 1-based:
iteration *t* of a driver is its *t*-th ProcessEdges call).  Three kinds:

* ``kill(worker, pe, phase)`` — the rank that *initially* owns logical
  worker ``w`` exits hard (``os._exit(FAULT_EXIT)``) at a defined point of
  that op: ``start`` (before its send tasks), ``send`` (after
  ``after_frames`` socket frames), ``recv`` (before its receive tasks) or
  ``apply`` (after its apply loop, before the final collective).  All four
  points precede the dead rank's contribution to the op's final collective,
  which is what makes rollback-and-replay sufficient (no survivor can have
  committed the op).  The initial-owner guard is what makes replay safe:
  the adopting survivor re-executes the same injection point without
  re-firing it.

* ``drop(src, dst, pe, frame)`` — the ``frame``-th cross-rank frame posted
  from worker ``src`` to worker ``dst`` in that op is silently not sent.
  The receiver's completeness check (posted-matrix vs arrived counts)
  detects the shortfall and the sender's ledger redelivers — byte counters
  are charged once, at post time, so the run stays bit-identical.

* ``delay(worker, pe)`` — every cross-rank frame worker ``w`` posts in
  that op is held past the straggler deadline and delivered at the next
  op's send phase, where the receiver merges it through the slot monoid
  (``straggler.merge_deferred_entry``).  Only monoid-legal for idempotent
  slots (MIN/MAX); :meth:`FaultPlan.validate_for_monoid` rejects ADD.

* ``corrupt(...)`` — flip one byte.  ``target="wire"`` flips a payload
  byte of the ``frame``-th cross-rank frame from ``src`` to ``dst``: the
  receiver's frame CRC rejects it and the ledger redelivers a clean copy
  (byte counters charged once, at post time — bit-identical run).
  ``target="chunk" | "spill" | "ckpt"`` flips a byte of the named on-disk
  artifact of logical worker ``worker`` right before the op's ready
  barrier: the next read of that artifact raises a typed
  ``IntegrityError`` naming the damaged file — never a silently-wrong
  result.

* ``stall(src, dst, pe, frame, seconds)`` — the sender freezes mid-frame
  (half the frame written, the send lock held — heartbeats to that peer
  stall too) for ``seconds``.  A short stall resolves into a clean
  delivery; one past the transport's ``stall_timeout`` trips the
  receiver's stall detector and flows into the normal recovery path.

The injector is consulted only on the socket data path, the pre-barrier
disk hook, and the kill points the executor exposes — a run with an empty
plan is byte-for-byte the plain process-mode run.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading

FAULT_EXIT = 42         # exit code of an injected kill (asserted by tests)

KILL_PHASES = ("start", "send", "recv", "apply")

CORRUPT_TARGETS = ("wire", "chunk", "spill", "ckpt")


def flip_byte(path: str, offset: int | None = None) -> int:
    """XOR one byte of ``path`` with 0xFF (mid-file by default); returns
    the flipped offset.  Shared by the fault injector and the integrity
    tests — the canonical single-byte disk corruption."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    off = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return off


@dataclasses.dataclass(frozen=True)
class FaultAction:
    kind: str               # "kill" | "drop" | "delay" | "corrupt" | "stall"
    pe: int                 # ProcessEdges call index (1-based)
    worker: int = -1        # kill/delay/corrupt-disk: acting logical worker
    phase: str = "start"    # kill: one of KILL_PHASES
    after_frames: int = 0   # kill@send: die after this many frames
    src: int = -1           # drop/corrupt-wire/stall: source worker
    dst: int = -1           # drop/corrupt-wire/stall: destination worker
    frame: int = 0          # per-(src,dst) frame index in the op
    target: str = "wire"    # corrupt: one of CORRUPT_TARGETS
    seconds: float = 0.0    # stall: how long the sender freezes mid-frame


class FaultPlan:
    """An immutable, validated, JSON-round-trippable fault schedule."""

    def __init__(self, actions=()):
        self.actions = tuple(actions)
        for a in self.actions:
            if a.kind not in ("kill", "drop", "delay", "corrupt",
                              "stall"):
                raise ValueError(f"unknown fault kind {a.kind!r}")
            if a.pe < 1:
                raise ValueError(
                    f"fault pe index must be >= 1 (1-based ProcessEdges "
                    f"call), got {a.pe}")
            if a.kind == "kill" and a.phase not in KILL_PHASES:
                raise ValueError(
                    f"kill phase must be one of {KILL_PHASES}, got "
                    f"{a.phase!r}")
            if a.kind in ("kill", "delay") and a.worker < 0:
                raise ValueError(f"{a.kind} fault needs a worker")
            if a.kind == "corrupt":
                if a.target not in CORRUPT_TARGETS:
                    raise ValueError(
                        f"corrupt target must be one of "
                        f"{CORRUPT_TARGETS}, got {a.target!r}")
                if a.target == "wire" and (a.src < 0 or a.dst < 0):
                    raise ValueError(
                        "corrupt(target='wire') fault needs src and dst "
                        "workers")
                if a.target != "wire" and a.worker < 0:
                    raise ValueError(
                        f"corrupt(target={a.target!r}) fault needs a "
                        f"worker")
            if a.kind == "stall":
                if a.src < 0 or a.dst < 0:
                    raise ValueError("stall fault needs src and dst "
                                     "workers")
                if not a.seconds > 0:
                    raise ValueError(
                        f"stall fault needs seconds > 0, got {a.seconds}")
            if a.kind == "drop" and (a.src < 0 or a.dst < 0):
                raise ValueError("drop fault needs src and dst workers")

    # -- constructors -------------------------------------------------------

    @staticmethod
    def kill(worker: int, pe: int, phase: str = "start",
             after_frames: int = 0) -> "FaultAction":
        return FaultAction("kill", pe, worker=worker, phase=phase,
                           after_frames=after_frames)

    @staticmethod
    def drop(src: int, dst: int, pe: int, frame: int = 0) -> "FaultAction":
        return FaultAction("drop", pe, src=src, dst=dst, frame=frame)

    @staticmethod
    def delay(worker: int, pe: int) -> "FaultAction":
        return FaultAction("delay", pe, worker=worker)

    @staticmethod
    def corrupt_wire(src: int, dst: int, pe: int,
                     frame: int = 0) -> "FaultAction":
        return FaultAction("corrupt", pe, src=src, dst=dst, frame=frame,
                           target="wire")

    @staticmethod
    def corrupt_disk(worker: int, pe: int,
                     target: str = "chunk") -> "FaultAction":
        return FaultAction("corrupt", pe, worker=worker, target=target)

    @staticmethod
    def stall(src: int, dst: int, pe: int, seconds: float,
              frame: int = 0) -> "FaultAction":
        return FaultAction("stall", pe, src=src, dst=dst, frame=frame,
                           seconds=float(seconds))

    # -- validation ---------------------------------------------------------

    def has_delay(self) -> bool:
        return any(a.kind == "delay" for a in self.actions)

    def validate_for_monoid(self, monoid_name: str) -> None:
        """Deferred (delayed) delivery re-applies a message after other
        messages already combined — legal only for idempotent monoids.
        ADD would double-count the deferred contribution's interaction
        with the destination's intermediate writes."""
        if self.has_delay() and monoid_name not in ("min", "max"):
            raise ValueError(
                f"delay faults defer message delivery across rounds, "
                f"which is only fixpoint-legal for idempotent monoid "
                f"slots (min/max), not {monoid_name!r}")

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(a) for a in self.actions])

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls([FaultAction(**d) for d in json.loads(text)])


class FaultInjector:
    """Per-process realization of a :class:`FaultPlan`.

    Hook points (all no-ops under an empty plan):

    * :meth:`maybe_kill` — executor phase boundaries (start/recv/apply);
    * :meth:`on_frame_sent` — after each socket frame (kill@send);
    * :meth:`data_fault` / :meth:`should_hold` — consulted by
      ``ProcContext.send_data`` per cross-rank frame (drop /
      corrupt-wire / stall);
    * :meth:`maybe_corrupt_disk` — ``ProcContext.recoverable`` before
      each op's ready barrier (corrupt chunk / spill / ckpt).

    Kills fire only on the worker's *initial* owner rank (the replaying
    adopter must not re-die), exit via ``os._exit(FAULT_EXIT)`` — no
    cleanup, no flush: the hardest failure the transport can see short of
    a machine loss."""

    def __init__(self, plan: FaultPlan, rank: int):
        self.plan = plan
        self.rank = rank
        self._lock = threading.Lock()
        self._sent: dict = {}       # (pe, src_w) -> frames sent
        self._posted: dict = {}     # (pe, src_w, dst_w) -> frames posted
        self._disk_fired: set = set()   # corrupt-disk action indices fired

    def _my_kill(self, ctx, pe: int, phase: str):
        for a in self.plan.actions:
            if (a.kind == "kill" and a.pe == pe and a.phase == phase
                    and ctx.initial_assign[a.worker] == self.rank
                    and ctx.assign[a.worker] == self.rank):
                return a
        return None

    def maybe_kill(self, ctx, phase: str) -> None:
        if self._my_kill(ctx, ctx.pe_seq, phase) is not None:
            os._exit(FAULT_EXIT)

    def on_frame_sent(self, ctx, pe: int, src_w: int) -> None:
        with self._lock:
            n = self._sent[(pe, src_w)] = self._sent.get((pe, src_w),
                                                         0) + 1
        a = self._my_kill(ctx, pe, "send")
        if a is not None and a.worker == src_w and n > a.after_frames:
            os._exit(FAULT_EXIT)

    def data_fault(self, pe: int, src_w: int, dst_w: int
                   ) -> tuple | None:
        """Consult (and consume) the per-(pe, src, dst) frame counter:
        returns ``None`` (send normally), ``("drop",)``, ``("corrupt",)``
        or ``("stall", seconds)`` for this frame."""
        with self._lock:
            idx = self._posted.get((pe, src_w, dst_w), 0)
            self._posted[(pe, src_w, dst_w)] = idx + 1
        for a in self.plan.actions:
            if not (a.pe == pe and a.src == src_w and a.dst == dst_w
                    and a.frame == idx):
                continue
            if a.kind == "drop":
                return ("drop",)
            if a.kind == "corrupt" and a.target == "wire":
                return ("corrupt",)
            if a.kind == "stall":
                return ("stall", a.seconds)
        return None

    def should_hold(self, pe: int, src_w: int) -> bool:
        return any(a.kind == "delay" and a.pe == pe and a.worker == src_w
                   for a in self.plan.actions)

    # -- disk corruption ----------------------------------------------------

    def maybe_corrupt_disk(self, ctx, engine) -> None:
        """Flip one byte of a chosen on-disk artifact of a worker this
        rank owns (fires once per action, on the worker's initial owner,
        right before the op's ready barrier): a chunk-shard section, a
        vertex-spill batch, or a checkpoint block.  The next read of the
        artifact then raises the matching :class:`IntegrityError` naming
        the damaged file."""
        for i, a in enumerate(self.plan.actions):
            if (a.kind != "corrupt" or a.target == "wire"
                    or a.pe != ctx.pe_seq):
                continue
            with self._lock:
                if (i in self._disk_fired
                        or ctx.initial_assign[a.worker] != self.rank
                        or ctx.assign[a.worker] != self.rank):
                    continue
                self._disk_fired.add(i)
            flip_byte(self._disk_target(engine, a.worker, a.target))

    @staticmethod
    def _disk_target(engine, w: int, target: str) -> str:
        """Pick the concrete file to damage for worker ``w``."""
        if target == "chunk":
            shard = engine.store.shards[w]
            q = shard.partitions[0]
            return os.path.join(shard.root, f"edges_q{q}.bin")
        if target == "spill":
            spill = engine.spills[w]
            name = sorted(spill.names())[0]
            return spill._path(name)
        if target == "ckpt":
            # damage a block the NEWEST manifest references — the one a
            # rollback of the current (never-committed) op would restore;
            # an unreferenced block would never be read again
            store = engine._proc_ckpt_store(w)
            mdir = os.path.join(store.root, "manifests")
            with open(os.path.join(mdir,
                                   sorted(os.listdir(mdir))[-1])) as f:
                mani = json.load(f)
            arrays = mani["arrays"]
            digest = arrays[sorted(arrays)[0]]["blocks"][0]
            return os.path.join(store.root, "blocks", f"{digest}.blk")
        raise ValueError(f"unknown disk corrupt target {target!r}")
