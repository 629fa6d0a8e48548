"""The wire of DTensor's collectives on a gloo device mesh.

A training mesh runs its ranks over gloo (``launch.mesh``): NCCL refuses
two ranks on one GPU.  DTensor moves data through the functional
collectives of ``torch.distributed._functional_collectives``.  On CUDA
tensors, gloo's functional all-gather
(``torch.ops._c10d_functional.all_gather_into_tensor``) ends the process
with a segmentation fault (torch 2.11 on an H100), where the c10d
``all_gather_into_tensor`` on the same group runs: gloo stages a CUDA
tensor through host memory itself.  :func:`install` routes DTensor's
all-gathers of CUDA tensors to that call, and times every collective
DTensor issues (all-gather, reduce-scatter, all-reduce, all-to-all):
:data:`WIRE` holds the calls and the bytes each rank hands over, in all
and by collective, and the wall seconds until the result is on the device
(host staging included), in all and by collective.  The context-parallel
attention's all-reduces (``ShardingRules.all_reduce``) go through the same
functional collectives and count here too.  A collective's seconds
include waiting for the slowest peer.  A collective that DTensor builds
from another (on a CPU mesh ``shard_dim_alltoall`` is an all-gather and a
chunk) counts once, under the outer name.  The dry run
(``launch/dryrun.py``) counts a step with the same wrappers: on fake
tensors the collectives move nothing and the card is not synchronized.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._C._distributed_c10d import _resolve_process_group
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import _collective_utils, placement_types


@dataclasses.dataclass
class WireStats:
    calls: dict = dataclasses.field(default_factory=dict)
    bytes: int = 0
    bytes_by: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    seconds_by: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.bytes, self.bytes_by = {}, 0, {}
        self.seconds, self.seconds_by = 0.0, {}

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": self.bytes,
                "bytes_by": dict(self.bytes_by), "seconds": self.seconds,
                "seconds_by": dict(self.seconds_by)}


WIRE = WireStats()
_DEPTH = threading.local()      # collectives running in this thread
_GATHERS = ("all_gather_tensor", "all_gather_single")
_TIMED = _GATHERS + ("reduce_scatter_tensor", "reduce_scatter_single",
                     "all_reduce", "all_to_all_single")


def _c10d_all_gather(tensor, gather_dim, group, tag=""):
    """``funcol.all_gather_tensor`` through ``dist.all_gather_into_tensor``
    on the group's process group: the result is ready on return."""
    pg = _resolve_process_group(funcol._resolve_group_name(group, tag))
    n = dist.get_world_size(pg)
    src = tensor.contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=pg)
    if gather_dim != 0:
        out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
    return out


def _timed(name, fn):
    @functools.wraps(fn)
    def run(tensor, *args, **kw):
        depth = getattr(_DEPTH, "n", 0)
        t0 = time.perf_counter()
        _DEPTH.n = depth + 1
        try:
            if name in _GATHERS and tensor.device.type == "cuda":
                out = _c10d_all_gather(tensor, *args, **kw)
            else:
                out = fn(tensor, *args, **kw)
                if isinstance(out, funcol.AsyncCollectiveTensor):
                    out = out.wait()
        finally:
            _DEPTH.n = depth
        if depth:                      # part of an outer collective
            return out
        if tensor.device.type == "cuda" and not isinstance(tensor,
                                                           FakeTensor):
            torch.cuda.synchronize(tensor.device)
        n = tensor.numel() * tensor.element_size()
        WIRE.calls[name] = WIRE.calls.get(name, 0) + 1
        WIRE.bytes += n
        WIRE.bytes_by[name] = WIRE.bytes_by.get(name, 0) + n
        dt = time.perf_counter() - t0
        WIRE.seconds += dt
        WIRE.seconds_by[name] = WIRE.seconds_by.get(name, 0.0) + dt
        return out
    run.wire_original = fn
    return run


def install() -> None:
    """Wrap DTensor's collectives (idempotent; a process-wide patch of
    ``torch.distributed._functional_collectives`` and of the
    ``shard_dim_alltoall`` DTensor imports)."""
    for name in _TIMED:
        fn = getattr(funcol, name, None)
        if fn is not None and not hasattr(fn, "wire_original"):
            setattr(funcol, name, _timed(name, fn))
    for module in (_collective_utils, placement_types):
        fn = getattr(module, "shard_dim_alltoall", None)
        if fn is not None and not hasattr(fn, "wire_original"):
            setattr(module, "shard_dim_alltoall",
                    _timed("shard_dim_alltoall", fn))
