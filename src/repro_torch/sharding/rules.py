"""Logical-axis sharding rules, the port's one-card half of
``repro.sharding.rules``.

Model code annotates arrays with *logical* axis names; a ``ShardingRules``
object maps those to mesh axes.  On one card there is no mesh: the rules
are a no-op (``shard`` returns its input), and every model signature keeps
its ``rules`` argument so the mesh half of training (slice 8b) can hand
in a mesh-backed table without touching the models.

Logical axes used across the stack:
  batch, seq, d_model, heads, kv_heads, head_dim, d_ff, vocab, experts,
  expert_ff, state, conv, layers (scan-stacked leading axis), cache_seq
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Optional[Any]
    table: Dict[str, AxisVal]

    def spec(self, *logical: Optional[str]) -> tuple:
        """Mesh axes for a tuple of logical axis names (None = unsharded)."""
        return tuple(self.table.get(a) if a is not None else None
                     for a in logical)

    def shard(self, x, *logical: Optional[str]):
        """A sharding constraint: the identity without a mesh."""
        return x

    def axis_size(self, mesh_axis: AxisVal) -> int:
        return 1

    def logical_size(self, logical: str) -> int:
        return self.axis_size(self.table.get(logical))


def make_rules(mesh=None, **overrides: AxisVal) -> ShardingRules:
    """The rules for one card (``mesh=None``); keyword overrides fill the
    table as in the reference.  A device mesh is slice 8b's."""
    if mesh is not None:
        raise NotImplementedError(
            "make_rules(mesh): mesh-backed sharding rules come with the LM "
            "training port's mesh half (slice 8b); the port serves and "
            "trains on one card with make_rules(None)")
    return ShardingRules(None, dict(overrides))
