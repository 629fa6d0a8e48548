"""DFOGraph core on PyTorch: two-level column-oriented partitioning,
adaptive CSR/DCSR, filtered push message passing, signal/slot engine.

Layering mirrors ``repro.core``: ``phases`` holds the four ProcessEdges
phases; ``chunkstore`` the storage tier (on-disk chunk store, vertex spill,
prefetcher, per-worker shards and the ChunkSource contract); ``exchange``
the inter-worker wire (adaptive encodings, measured bytes, decode-ahead);
``mesh`` the process mesh of the SHARD_MAP executor (``torch.distributed``
ranks, one per partition) and ``sparse_collectives`` its exchanges;
``executor`` composes them into the LOCAL, SHARD_MAP, OOC and DIST_OOC
executors and ``multiquery`` into their Q-query panel twins; ``engine`` is
the public signal/slot API on top, and ``serve`` the continuous-query
session.  ``transport`` carries DIST_OOC's workers across OS processes
(process mode, with ``repro_torch.runtime`` and ``repro_torch.ckpt``).
"""
from repro_torch.core.partition import (  # noqa: F401
    TwoLevelSpec, DistGraph, make_spec, build_dist_graph,
    scatter_vertex_values, gather_vertex_values, choose_batch_size,
    row_block_batch_map,
)
from repro_torch.core.formats import (  # noqa: F401
    BlockTiles, BlockTilesHost, ChunkFormats, build_block_tiles,
    build_formats,
)
from repro_torch.core import codec  # noqa: F401
from repro_torch.core.chunkstore import (  # noqa: F401
    REP_CSR, REP_DCSR, REP_DCSR_DELTA, ChunkPrefetcher, ChunkStore,
    ChunkStoreError, DeviceChunkDecoder, DiskChunkSource, HBMChunkSource,
    ShardedChunkStore, VertexSpill,
)
from repro_torch.core.exchange import (  # noqa: F401
    FMT_PAIRS, FMT_SLAB, FMT_UVAL, FMT_VPAIRS, DecodeAhead, Exchange,
    batch_wire_bytes, choose_wire_format, decode_batch, encode_batch,
)
from repro_torch.core.mesh import (  # noqa: F401
    MeshError, ProcessMesh, run_mesh,
)
from repro_torch.core.engine import (  # noqa: F401
    ADD, MIN, MAX, Engine, EngineConfig, Monoid, accumulate_counters,
    zero_counters,
)
from repro_torch.core.serve import (  # noqa: F401
    GraphServeSession, QueryResult,
)
