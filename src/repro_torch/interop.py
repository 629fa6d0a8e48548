"""Carrying state across from the JAX package.

Each function turns a plain mapping — numpy arrays for the array fields,
Python values for the static ones, as taken from a ``repro`` structure with
``np.asarray`` — into the port's structure on a device.  For this system
the graph, its formats and its tiles play the part weights play for a
model: the tests hand both packages identical structures through here;
:func:`lm_params_from_jax` carries an LM parameter tree across and
:func:`train_state_from_jax` a training state.
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
from repro_torch.utils import resolve_device, tree_leaves


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


def _leaf_to(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.array(a.view(np.uint16), copy=True)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _tree_to(tree, dev, path="params"):
    if isinstance(tree, Mapping):
        return {k: _tree_to(v, dev, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, dev, f"{path}[{i}]") for i, v in enumerate(tree)]
    if not hasattr(tree, "shape"):
        raise TypeError(f"{path}: not an array leaf ({type(tree).__name__})")
    return _leaf_to(tree, dev)


def lm_params_from_jax(tree: Mapping, cfg, device=None) -> dict:
    """The reference's LM parameter pytree (``Model.init``'s, leaves taken
    with ``np.asarray``; bfloat16 leaves keep their bits) as the port's on
    ``device``.  A tree of tensors (the port's own) is moved there.

    The layouts are the same by design, so the map is one to one: every
    dict key and list position is kept, and each stage's cycle position
    stays one dict of leaves stacked ``[n, ...]`` over the stage's layers
    (the reference's ``lax.scan`` layout; the port's ``Model`` indexes
    layer ``i`` of a stage as ``leaf[i]``).  ``cfg`` fixes the expected
    stages: a tree of another architecture raises."""
    from repro_torch.models.model import make_model
    dev = resolve_device(device)
    out = _tree_to(tree, dev)
    model = make_model(cfg, device="meta")
    for key, stages in (("stages", model.stages),
                        ("enc_stages", model.encoder_stages)):
        got = out.get(key, [])
        if len(got) != len(stages) or any(
                len(p) != len(s.cycle) or any(
                    next(iter(tree_leaves(b))).shape[0] != s.n for b in p)
                for p, s in zip(got, stages)):
            raise ValueError(f"{key}: the tree does not match {cfg.name}'s "
                             f"stages {[(len(s.cycle), s.n) for s in stages]}")
    return out


def train_state_from_jax(state: Mapping, cfg, device=None) -> dict:
    """The reference's training state (``init_train_state``'s
    ``{"params", "opt": {mu, nu, master}, "step"}``, leaves taken with
    ``np.asarray``) as the port's on ``device``: each of the four trees
    through :func:`lm_params_from_jax`, the step a 0-d int32 tensor."""
    dev = resolve_device(device)
    return {"params": lm_params_from_jax(state["params"], cfg, dev),
            "opt": {k: lm_params_from_jax(state["opt"][k], cfg, dev)
                    for k in ("mu", "nu", "master")},
            "step": _leaf_to(state["step"], dev)}
