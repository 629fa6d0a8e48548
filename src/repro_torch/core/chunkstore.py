"""Storage tier — the ChunkSource contract executors see (DESIGN.md §6).

This slice holds the everything-resident realization, :class:`HBMChunkSource`,
copied from ``repro.core.chunkstore``; the on-disk chunk store, vertex
spill and prefetcher join it with the out-of-core executor.
"""
from __future__ import annotations


class HBMChunkSource:
    """Everything-resident realization: the LOCAL executor reads edge chunks
    and dispatch metadata straight from device tensors; I/O is analytic."""

    kind = "hbm"

    def __init__(self, graph, fmts):
        self.graph = graph
        self.fmts = fmts

    DEST_KEYS = ("dcsr_src", "dcsr_part", "dcsr_batch", "dcsr_valid",
                 "dcsr_ptr", "has_csr", "csr_bytes", "dcsr_bytes",
                 "dcsr_delta_bytes", "csr_raw_bytes", "dcsr_raw_bytes")
    EDGE_KEYS = ("edge_src_part", "edge_src_local", "edge_dst_local",
                 "edge_data", "edge_valid")

    @staticmethod
    def _get(obj, key):
        return obj[key] if isinstance(obj, dict) else getattr(obj, key)

    @classmethod
    def dest_arrays(cls, fmts) -> dict:
        """Dispatch-graph + format-decision arrays for phases 3/3.5 (works
        on a ChunkFormats or a dict of the same arrays)."""
        return {k: cls._get(fmts, k) for k in cls.DEST_KEYS}

    @classmethod
    def edge_arrays(cls, g) -> dict:
        """Per-edge arrays for the segment compute backend."""
        return {k: cls._get(g, k) for k in cls.EDGE_KEYS}
