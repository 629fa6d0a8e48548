"""Trace-time flags, the port's copy of ``repro.models.flags``.

The knobs keep the reference's names and meanings so a setting carries
across; the dry run sets them from its ``--flag NAME=VALUE`` option
(:func:`set_flag`).

COST_ACCOUNTING_UNROLL and :func:`inner_scan_unroll` keep the
reference's names only.  The reference's dry run sets the flag for its
per-stage body compiles and its models read it
(``repro/models/layers.py:215``, ``repro/models/linear_attention.py:92``)
to unroll ``lax.scan``: XLA's cost analysis counts a ``while`` body once,
whatever its trip count.  Nothing in the port sets or reads it: the
port's scans (the layer loop, chunked attention's query blocks, the GLA
chunk scan) are Python loops or batched chunks, so the dry run's counter
already sees every trip.
"""
COST_ACCOUNTING_UNROLL = False


def inner_scan_unroll():
    return True if COST_ACCOUNTING_UNROLL else 1


# --- perf-iteration knobs (EXPERIMENTS.md §Perf); defaults = paper-faithful
# baseline, variants set by the dry run's --flag option --------------------

# Two-level blocked position scan in MoE routing (exact, perf-only).
MOE_POSITION_BLOCK: int | None = None
# Per-source-group expert capacity: groups = data shards; makes the routing
# scan shard-local and the dispatch buffer data-shardable.  Changes capacity
# semantics from global-order to per-group (paper's per-pair |L_ij| bound).
MOE_GROUPS: int | None = None
# Query-chunked (flash-structure) attention threshold override.
ATTN_CHUNK_THRESHOLD: int | None = None
# Gradient-accumulation microbatches for the dry run's train step (activation
# memory divides by this).  The launcher takes its own ``--microbatches``,
# as the reference's does.
TRAIN_MICROBATCHES: int | None = None


def set_flag(name: str, value: str) -> None:
    globals()[name]                # raises KeyError for unknown flags
    globals()[name] = None if value in ("none", "None") else int(value)
