"""Device meshes on ``torch.distributed``, the port's copy of
``repro.launch.mesh``.

Functions, not module-level constants, so importing this module touches
no process group.  A mesh spans the ranks of the default process group,
which a launcher has started (``repro_torch.core.mesh.run_mesh``, or any
that calls ``init_process_group``): each process is one device of the
reference's mesh.  The ranks may share one card; their collectives run
over the default group's backend (gloo where they share it: NCCL refuses
two ranks on one GPU), and :mod:`repro_torch.sharding.wire` carries and
times DTensor's collectives on it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding import wire
from repro_torch.utils import resolve_device


def make_device_mesh(shape, axis_names, *, ranks=None, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over ``ranks``
    (every rank of the default group when None: then the group must hold
    exactly ``prod(shape)`` ranks, as ``jax.make_mesh`` needs that many
    devices).  Every rank of the default group must call it, those outside
    ``ranks`` too (they join the group creation and hold no shard).
    ``device``: the ranks' device, the card unless it names another; every
    rank takes the card's first device."""
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs an initialized process "
                           "group: start the ranks with a launcher such as "
                           "repro_torch.core.mesh.run_mesh")
    n = math.prod(shape)
    world = dist.get_world_size()
    if ranks is None:
        if world != n:
            raise ValueError(f"the mesh {tuple(shape)} {tuple(axis_names)} "
                             f"needs {n} ranks; the process group has "
                             f"{world}")
        ranks = range(n)
    ranks = list(ranks)
    if len(ranks) != n or max(ranks) >= world:
        raise ValueError(f"the mesh {tuple(shape)} needs {n} of the "
                         f"group's {world} ranks, got {ranks}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    wire.install()
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 16x16 = 256 ranks ('data', 'model').
    Multi-pod: 2x16x16 = 512 ranks ('pod', 'data', 'model') — the 'pod'
    axis composes with 'data' for FSDP/DP (or carries pipeline stages).
    Raises, naming both sizes, when the group holds another number."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes, device=device)


def make_graph_mesh(num_partitions: int, *, device=None):
    """1-D mesh for the graph engine's partition axis."""
    return make_device_mesh((num_partitions,), ("part",), device=device)
