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
:data:`WIRE` holds the calls, the bytes each rank hands over and the
wall seconds until the result is on the device (host staging included).
A collective's seconds include waiting for the slowest peer.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._C._distributed_c10d import _resolve_process_group
from torch.distributed.tensor import _collective_utils, placement_types


@dataclasses.dataclass
class WireStats:
    calls: dict = dataclasses.field(default_factory=dict)
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = {}, 0, 0.0

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": self.bytes,
                "seconds": self.seconds}


WIRE = WireStats()
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
        t0 = time.perf_counter()
        if name in _GATHERS and tensor.device.type == "cuda":
            out = _c10d_all_gather(tensor, *args, **kw)
        else:
            out = fn(tensor, *args, **kw)
            if isinstance(out, funcol.AsyncCollectiveTensor):
                out = out.wait()
        if tensor.device.type == "cuda":
            torch.cuda.synchronize(tensor.device)
        WIRE.calls[name] = WIRE.calls.get(name, 0) + 1
        WIRE.bytes += tensor.numel() * tensor.element_size()
        WIRE.seconds += time.perf_counter() - t0
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
