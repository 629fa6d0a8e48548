"""Logical-axis sharding rules (MaxText-style logical -> mesh mapping), the
port's copy of ``repro.sharding.rules``.

Model code annotates arrays with *logical* axis names; a ``ShardingRules``
object maps those to mesh axes.  The same model code therefore runs
unsharded on one card (``mesh=None``: the rules are a no-op) and sharded
on a ``torch.distributed`` :class:`DeviceMesh` whose dimension names are
the reference's mesh axes (``data``, ``model``, and ``pod`` where
present) — only the rules object changes.

On a mesh, JAX's ``NamedSharding`` becomes a DTensor placement list, one
entry per mesh dimension: ``Shard(d)`` where the logical axis of tensor
dimension ``d`` maps to that mesh axis, ``Replicate()`` otherwise.  A
tuple of mesh axes on one tensor dimension (``("pod", "data")``) shards
that dimension over both, the first axis major, as ``PartitionSpec`` does.
``with_sharding_constraint`` becomes a redistribute (:meth:`shard`).
A dimension that its mesh axes do not divide is left whole on them (the
one-token ``seq`` of a decode step under the ``long_decode`` plan, which
puts ``seq`` over the data axes): GSPMD pads such a dimension and
computes the same values, where DTensor would cut it as ``torch.chunk``
does and then refuse the views that merge it (a matmul's).

Logical axes used across the stack:
  batch, seq, d_model, heads, kv_heads, head_dim, d_ff, vocab, experts,
  expert_ff, state, conv, layers (scan-stacked leading axis), cache_seq
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

AxisVal = Union[None, str, Tuple[str, ...]]


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _mesh_axes(val: AxisVal) -> tuple:
    if val is None:
        return ()
    return val if isinstance(val, tuple) else (val,)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{mesh axis name: size}`` of a torch ``DeviceMesh`` (the
    reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Optional[Any]            # a torch DeviceMesh, or None
    table: Dict[str, AxisVal]

    def spec(self, *logical: Optional[str]) -> tuple:
        """Mesh axes for a tuple of logical axis names (None = unsharded):
        the reference's ``PartitionSpec`` entries."""
        return tuple(self.table.get(a) if a is not None else None
                     for a in logical)

    def placements(self, *logical: Optional[str], shape=None) -> tuple:
        """One DTensor placement per mesh dimension for an array whose
        dimensions carry ``logical``; given its ``shape``, a dimension
        that its mesh axes do not divide is left whole."""
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, val in enumerate(self.spec(*logical)):
            for a in _mesh_axes(val):
                i = names.index(a)
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {a!r} shards two dimensions "
                                     f"of {logical}")
                out[i] = Shard(dim)
        out = tuple(out)
        return out if shape is None else _fit(shape, self.mesh, out)

    def sharding(self, *logical: Optional[str]):
        """``(mesh, placements)``, or None without a mesh."""
        if self.mesh is None:
            return None
        return self.mesh, self.placements(*logical)

    def shard(self, x, *logical: Optional[str]):
        """A sharding constraint: the identity without a mesh.  On a mesh a
        DTensor is redistributed to the spec's placements; a plain tensor
        (one every rank computed alike: a global batch, or what the models
        build locally) is taken as replicated and cut to them, which moves
        no data.  As ``with_sharding_constraint``'s transpose, the
        gradient is constrained to the same placements on the way back."""
        if self.mesh is None:
            return x
        return _place(x, self.mesh, self.placements(*logical))

    def local(self, fn, in_specs, out_specs):
        """``fn`` run on each rank's shards: the identity without a mesh.
        On a mesh every tensor argument (its spec not None) is placed by
        its spec, ``fn`` sees the local shards as plain tensors, and each
        tensor result comes back as a DTensor placed by its spec.  For a
        computation independent along its sharded dimensions (attention
        per batch row and head, the GLA scan per head): the values are the
        unsharded ones, no data moves, and DTensor dispatches none of its
        operations.  A result's dimension is cut as the first argument
        that carries its logical axis is cut: evenly, or left whole where
        the mesh axes do not divide it (a dimension whose axis no argument
        carries is taken as evenly cut).  An argument left whole on a mesh
        axis that another argument is sharded on gets its gradient there
        as a partial sum (each shard's computation adds its share)."""
        if self.mesh is None:
            return fn

        def run(*args, **kw):
            placed = [None if spec is None or a is None
                      else self.shard(a, *spec)
                      for a, spec in zip(args, in_specs)]
            # an input left whole on a mesh axis that splits the
            # computation (another input is sharded on it) gets a partial
            # gradient there
            split = {i for p in placed if p is not None
                     for i, pl in enumerate(p.placements) if pl.is_shard()}
            local, lengths = [], {}
            for a, p, spec in zip(args, placed, in_specs):
                if p is None:
                    local.append(a)
                    continue
                for axis, n in zip(spec, p.shape):
                    if axis is not None:
                        lengths.setdefault(axis, n)
                local.append(p.to_local(grad_placements=[
                    Partial() if pl == Replicate() and i in split else pl
                    for i, pl in enumerate(p.placements)]))
            out = fn(*local, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            placed = tuple(
                o if spec is None or o is None
                else self._from_local(o.contiguous(), spec, lengths)
                for o, spec in zip(outs, out_specs))
            return placed if isinstance(out, tuple) else placed[0]
        return run

    def _from_local(self, o, spec, lengths):
        """A DTensor of the local shard ``o`` placed by ``spec``, each
        sharded dimension cut as its global length in ``lengths`` says
        (evenly where the axis is not there)."""
        shape = [lengths.get(axis, n * self.logical_size(axis))
                 if axis is not None else n
                 for axis, n in zip(spec, o.shape)]
        return DTensor.from_local(o, self.mesh,
                                  self.placements(*spec, shape=shape),
                                  run_check=False)

    def gather_grad(self, x, logical: str):
        """``x`` unchanged; on a mesh its gradient is gathered over the mesh
        axes ``logical`` maps to (its other placements kept, a partial sum
        still partial).  For a tensor reshaped out of a layout that cannot
        hold the gradient's cut: flat-head attention cuts its H = KV x G
        heads over 'model' (q, the repeated k and v, ``wo`` as
        ``[H * HD, D]``), which the grouped ``[KV, G]`` layout cannot hold
        when neither KV nor G divides by the axis."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        names = tuple(self.mesh.mesh_dim_names)
        dims = tuple(names.index(a)
                     for a in _mesh_axes(self.table.get(logical)))
        return _GatherGrad.apply(x, dims)

    def tree_shardings(self, logical_tree: Any):
        """Map a tree of logical-axis tuples to ``(mesh, placements)``
        pairs (to specs when mesh is None)."""
        def one(axes):
            if self.mesh is None:
                return self.spec(*axes)
            return self.sharding(*axes)
        return _map_specs(one, logical_tree)

    def tree_shard(self, tree: Any, logical_tree: Any):
        """Every leaf of ``tree`` through :meth:`shard` with its spec from
        ``logical_tree`` (same structure)."""
        if self.mesh is None:
            return tree
        return place(tree, self.tree_shardings(logical_tree))

    def axis_size(self, mesh_axis: AxisVal) -> int:
        if self.mesh is None or mesh_axis is None:
            return 1
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in _mesh_axes(mesh_axis):
            n *= sizes[a]
        return n

    def logical_size(self, logical: str) -> int:
        return self.axis_size(self.table.get(logical))

    def shard_range(self, logical: str, length: int) -> Tuple[int, int]:
        """``(offset, length)`` of this rank's shard of a dimension of
        ``length`` carrying ``logical``: ``(0, length)`` where the axis is
        not sharded or does not divide it (the dimension is left whole).
        Over two mesh axes (``('pod', 'data')``) the first is the outer
        index, as in ``PartitionSpec`` and DTensor's cut."""
        n = self.logical_size(logical)
        if n == 1 or length % n:
            return 0, length
        names = tuple(self.mesh.mesh_dim_names)
        coord = self.mesh.get_coordinate()
        index = 0
        for a in _mesh_axes(self.table.get(logical)):
            i = names.index(a)
            index = index * self.mesh.shape[i] + coord[i]
        return index * (length // n), length // n

    def all_reduce(self, x, op: str, logical: str):
        """A plain tensor reduced (``op``: ``"sum"`` or ``"max"``) over the
        ranks that hold the shards of ``logical``, one functional
        all-reduce per mesh axis it maps to (``sharding.wire`` counts
        each): the identity where the axis is not sharded."""
        if self.mesh is None:
            return x
        names = tuple(self.mesh.mesh_dim_names)
        for a in _mesh_axes(self.table.get(logical)):
            i = names.index(a)
            if self.mesh.shape[i] > 1:
                x = funcol.all_reduce(x, op, (self.mesh, i))
                if isinstance(x, funcol.AsyncCollectiveTensor):
                    x = x.wait()
        return x


def _fit(shape, mesh, placements) -> tuple:
    """``placements`` with every tensor dimension that the product of its
    mesh axes does not divide left whole (``Replicate``) on them."""
    cut = {}
    for i, p in enumerate(placements):
        if p.is_shard():
            cut[p.dim] = cut.get(p.dim, 1) * mesh.shape[i]
    return tuple(Replicate() if p.is_shard() and shape[p.dim] % cut[p.dim]
                 else p for p in placements)


def _dense(g):
    """A DTensor whose local shard is contiguous (a DTensor's contiguity is
    its global layout's: the backward of a redistribute can leave a
    strided shard, which DTensor's ``view`` refuses)."""
    if not isinstance(g, DTensor):
        return g.contiguous()
    return DTensor.from_local(g.to_local().contiguous(), g.device_mesh,
                              g.placements, run_check=False, shape=g.shape,
                              stride=g.stride())


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, its gradient too."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return _dense(g), None


class _GatherGrad(torch.autograd.Function):
    """The identity; the gradient replicated over mesh dimensions ``dims``
    where it is sharded."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        want = tuple(Replicate() if i in ctx.dims and p.is_shard() else p
                     for i, p in enumerate(g.placements))
        if want != tuple(g.placements):
            g = g.redistribute(g.device_mesh, want)
        return _dense(g), None


def _map_specs(fn, tree):
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return type(tree)(_map_specs(fn, v) for v in tree)


def _place(x, mesh, placements):
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return _Constrain.apply(x, _fit(x.shape, mesh, placements))


def place(tree: Any, shardings: Any):
    """Each leaf of ``tree`` placed by its ``(mesh, placements)`` from
    ``shardings`` (same structure, as :meth:`ShardingRules.tree_shardings`
    gives; None leaves it as it is), as :meth:`ShardingRules.shard`
    places one: the reference's ``jax.device_put`` of a tree onto
    shardings."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    return tree if shardings is None else _place(tree, *shardings)


def full(x):
    """The whole (global) value of a DTensor, on every rank; a plain tensor
    as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_replica(x):
    """A DTensor as a plain, differentiable tensor replicated on every rank
    (an all-gather of its shards, and an all-reduce of a partial sum); a
    plain tensor as it is.  For the operations DTensor has no sharding
    rule for: the caller computes on the replica and hands its result
    back through :meth:`ShardingRules.shard`."""
    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(
        x, (Replicate(),) * x.device_mesh.ndim).to_local()


def make_rules(mesh=None, **overrides: AxisVal) -> ShardingRules:
    """Default logical->mesh table for a ('data', 'model') or
    ('pod', 'data', 'model') mesh, read from ``mesh.mesh_dim_names``;
    keyword overrides adjust per-arch/shape.  ``mesh=None`` gives the
    one-card rules (a no-op) holding only the overrides."""
    if mesh is None:
        return ShardingRules(None, dict(overrides))
    axis_names = tuple(mesh.mesh_dim_names)
    dp: AxisVal = tuple(a for a in ("pod", "data") if a in axis_names)
    if len(dp) == 1:
        dp = dp[0]
    tp = "model" if "model" in axis_names else None
    table: Dict[str, AxisVal] = {
        "batch": dp,
        "seq": None,
        "d_model": dp,        # FSDP: weight d_model axis sharded over data
        "act_d_model": None,  # activation feature axis (unsharded by default)
        "heads": tp,
        "kv_heads": tp,
        "q_group": None,
        "moe_cap": None,
        "head_dim": None,
        "d_ff": tp,
        "vocab": tp,
        "experts": tp,
        "expert_ff": None,
        "state": None,
        "conv": None,
        "layers": None,
        "cache_seq": None,
        "frames": None,
    }
    table.update(overrides)
    return ShardingRules(mesh, table)

