"""Trace-time flags, the port's copy of ``repro.models.flags``.

The knobs keep the reference's names and meanings so a setting carries
across.  Only the ones the serving path reads are here; the training
slice adds what it reads.
"""

# --- perf-iteration knobs (EXPERIMENTS.md §Perf); defaults = paper-faithful
# baseline ----------------------------------------------------------------

# Two-level blocked position scan in MoE routing (exact, perf-only).
MOE_POSITION_BLOCK: int | None = None
# Per-source-group expert capacity: groups = data shards; makes the routing
# scan shard-local and the dispatch buffer data-shardable.  Changes capacity
# semantics from global-order to per-group (paper's per-pair |L_ij| bound).
MOE_GROUPS: int | None = None
# Query-chunked (flash-structure) attention threshold override.
ATTN_CHUNK_THRESHOLD: int | None = None
