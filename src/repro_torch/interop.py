"""Carrying state across from the JAX package.

Each function turns a plain mapping — numpy arrays for the array fields,
Python values for the static ones, as taken from a ``repro`` structure with
``np.asarray`` — into the port's structure on a device.  For this system
the graph, its formats and its tiles play the part weights play for a
model: the tests hand both packages identical structures through here.
Nothing in this module imports ``repro`` or ``jax``; the caller does the
taking.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.formats import BlockTiles, ChunkFormats
from repro_torch.core.partition import DistGraph, TwoLevelSpec
from repro_torch.utils import resolve_device


def _build(cls, arrays: Mapping, device, **static):
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in static:
            kw[f.name] = static[f.name]
        elif f.type == "torch.Tensor":
            kw[f.name] = torch.from_numpy(
                np.array(arrays[f.name], copy=True)).to(dev)
        else:
            kw[f.name] = arrays[f.name]
    return cls(**kw)


def dist_graph_from_arrays(arrays: Mapping, *, device=None) -> DistGraph:
    """``arrays`` holds every DistGraph field; ``spec`` may be a mapping of
    the TwoLevelSpec fields (``dataclasses.asdict`` of the reference's)."""
    spec = arrays["spec"]
    if isinstance(spec, Mapping):
        spec = TwoLevelSpec(**{**spec,
                               "boundaries": tuple(spec["boundaries"])})
    return _build(DistGraph, arrays, device, spec=spec,
                  e_max=int(arrays["e_max"]))


def formats_from_arrays(arrays: Mapping, *, device=None) -> ChunkFormats:
    """``arrays`` holds every ChunkFormats field."""
    return _build(ChunkFormats, arrays, device)


def block_tiles_from_arrays(arrays: Mapping, *, device=None) -> BlockTiles:
    """``arrays`` holds every BlockTiles field."""
    return _build(BlockTiles, arrays, device)


def state_from_arrays(arrays: Mapping, *, device=None) -> dict:
    """Vertex state: name -> [P, V] array."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in arrays.items()}
