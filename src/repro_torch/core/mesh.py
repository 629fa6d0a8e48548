"""The mesh of the SHARD_MAP executor on ``torch.distributed`` — the port's
counterpart of ``jax.make_mesh`` plus the collectives ``shard_map`` gives
the reference (DESIGN.md §12).

The reference runs one controller that drives P devices along a mesh axis
(``"part"``); here the mesh axis is P operating-system processes, one per
graph partition, joined in one ``gloo`` process group.  Each rank holds
only its own partition's rows on its device.  The ranks may share one
card: NCCL refuses two ranks on one GPU, so the collectives run over
gloo, which takes CUDA tensors and stages them through host memory
itself; those copies are part of the wire's time.

* :class:`ProcessMesh` — one rank's handle on the default process group:
  ``size``, ``rank``, ``AXIS``, and the collectives the executors use —
  :meth:`~ProcessMesh.all_to_all` (``jax.lax.all_to_all`` over dim 0),
  :meth:`~ProcessMesh.psum`, :meth:`~ProcessMesh.pmax` and
  :meth:`~ProcessMesh.all_gather`.  It counts the payload elements and
  bytes it hands its peers through ``all_to_all`` (``sent_elems``,
  ``sent_bytes``) and the wall seconds spent inside collectives
  (``wire_s``).
* :func:`run_mesh` — the launcher that stands where the reference's single
  controller stands: it spawns ``world`` ranks, initializes gloo from a
  ``FileStore`` in a fresh temporary directory (no fixed port, so several
  launchers can run at once), calls ``fn(mesh, *args)`` on every rank,
  and returns each rank's result.  A rank that raises fails the whole job:
  the others are killed and the exception is raised in the caller.  So is
  a job that overruns its deadline.  The calling process never joins a
  process group.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.utils import resolve_device


class MeshError(RuntimeError):
    """A mesh job failed: a rank died without a result, raised an
    exception that does not pickle, or the job overran its deadline."""


class ProcessMesh:
    """One rank's view of the partition mesh: the default process group,
    its size and this process's rank along the mesh axis ``AXIS``.

    Every collective must be called by every rank in the same order
    (the lockstep of the reference's ``shard_map``).  Tensors may live on
    the CPU or on a CUDA device (gloo stages CUDA tensors through host
    memory); a result lives where its input did."""

    AXIS = "part"            # the reference's mesh axis name

    def __init__(self, *, device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessMesh needs an initialized process group: run the "
                "job under repro_torch.core.mesh.run_mesh")
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.device = resolve_device(device)
        self.sent_elems = 0       # payload elements handed to peers
        self.sent_bytes = 0       # and their bytes
        self.wire_s = 0.0         # wall seconds inside collectives

    def _timed(self, fn, like):
        """Run one collective, adding its wall seconds to ``wire_s`` (on
        CUDA up to the moment its result is on the card)."""
        t0 = time.perf_counter()
        try:
            out = fn()
            if like.device.type == "cuda":
                torch.cuda.synchronize(like.device)
            return out
        finally:
            self.wire_s += time.perf_counter() - t0

    # -- collectives ----------------------------------------------------------
    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``jax.lax.all_to_all(t, axis, 0, 0)``: dim 0 (of length a
        multiple of ``size``) splits into ``size`` equal blocks, block i
        goes to rank i, and the received blocks stack along dim 0 in source
        order.  ``bool`` tensors must be sent as ``int8``."""
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: dim 0 ({t.shape[0]}) is not a "
                             f"multiple of the mesh size {self.size}")
        peers = t.numel() // self.size * (self.size - 1)
        self.sent_elems += peers
        self.sent_bytes += peers * t.element_size()
        send = t.contiguous()
        recv = torch.empty_like(send)
        self._timed(lambda: dist.all_to_all_single(recv, send), t)
        return recv

    def _all_reduce(self, t, op):
        out = t.clone()
        self._timed(lambda: dist.all_reduce(out, op=op), t)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the mesh; every rank gets the same values
        (gloo reduces each element once and broadcasts it)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the mesh."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` ([1, ...] rows) concatenated along dim 0 in
        rank order: the full [P, ...] array on every rank."""
        send = t.contiguous()
        out = torch.empty((self.size,) + tuple(send.shape), dtype=send.dtype,
                          device=send.device)
        self._timed(lambda: dist.all_gather(list(out.unbind(0)), send), t)
        return out.reshape((self.size * send.shape[0],)
                           + tuple(send.shape[1:]))

    def barrier(self) -> None:
        t0 = time.perf_counter()
        dist.barrier()
        self.wire_s += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, args, rank, world, init_method, device, timeout_s,
               results):
    """Body of one spawned rank: join the gloo group, run ``fn`` and post
    (rank, ok, payload) on ``results``.  A failure posts the exception
    (when it pickles) and its traceback, then exits non-zero without
    tearing the group down, since the other ranks may be waiting in a
    collective (the launcher kills them)."""
    try:
        dev = resolve_device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=world,
            timeout=timedelta(seconds=timeout_s))
        out = fn(ProcessMesh(device=dev), *args)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception as exc:              # noqa: BLE001 — reported upward
        tb = traceback.format_exc()
        try:
            pickle.dumps(exc)
        except Exception:                 # noqa: BLE001
            exc = None
        results.put((rank, False, (exc, tb)))
        results.close()
        results.join_thread()
        os._exit(1)


def run_mesh(fn, world: int, *, args=(), device=None,
             timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` spawned ranks of one gloo
    group and return the ranks' results in rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    ``device`` is each rank's device: ``None`` means the GPU and a rank
    without one raises; ``"cpu"`` runs every rank on one CPU thread.  The
    group is initialized from a ``FileStore`` in a fresh temporary
    directory, with ``timeout_s`` as gloo's timeout, and the whole job
    runs under the same hard deadline.  When a rank raises, every rank is
    killed and the rank's exception is raised here (with a note naming
    the rank and holding its traceback; :class:`MeshError` when the
    exception does not pickle); a rank that dies without a result, or a
    job past its deadline, kills every rank and raises
    :class:`MeshError`."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    ctx = multiprocessing.get_context("spawn")
    root = tempfile.mkdtemp(prefix="mesh-")
    init_method = "file://" + os.path.join(root, "store")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, name=f"mesh-rank-{r}", daemon=True,
        args=(fn, tuple(args), r, world, init_method, device, timeout_s,
              results)) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise MeshError(
                    f"mesh job of {world} ranks overran its {timeout_s} s "
                    f"deadline ({len(out)} ranks finished); every rank was "
                    "killed")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode not in (None, 0):
                        raise MeshError(
                            f"rank {r} died with exit code {p.exitcode} and "
                            "no result; every rank was killed")
                continue
            if not ok:
                exc, tb = payload
                note = (f"raised on mesh rank {rank} of {world}; every rank "
                        f"was killed. The rank's traceback:\n{tb}")
                if exc is None:
                    raise MeshError(note)
                exc.add_note(note)
                raise exc
            out[rank] = payload
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        results.close()
        results.cancel_join_thread()
        shutil.rmtree(root, ignore_errors=True)
    return [out[r] for r in range(world)]
