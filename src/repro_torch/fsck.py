"""Offline integrity scrubber for DFOGraph on-disk state — the port's
twin of ``scripts/fsck.py``, with the same verdicts and report lines.

Usage::

    python -m repro_torch.fsck <root> [<root> ...]

Each root is auto-detected and every checksum in it is re-verified
against its manifest / sidecar / content hash:

* ``shards.json``          — sharded chunk store: every shard's chunk
  sections, its ``vertex/`` spill (arrays + bitmaps), and any
  ``ckpt-*`` block stores under the shard roots;
* ``manifest.json``        — single chunk store (+ its ``vertex/`` spill);
* ``blocks/`` + ``manifests/`` — a standalone checkpoint block store.

Prints one report line per artifact group (per shard for sharded
stores), with every damaged file named, and exits nonzero when any
damage is found — the offline complement of the online verify-on-read
integrity tier.
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.ckpt.blockstore import BlockStore
from repro_torch.core.chunkstore import (
    MANIFEST_NAME, SHARD_MANIFEST_NAME, ChunkStore, ChunkStoreError,
    ShardedChunkStore, VertexSpill,
)
from repro_torch.utils import IntegrityError

Report = tuple[str, list]       # (label, damage descriptions)


def scrub_spill(vdir: str, store: ChunkStore) -> list:
    """Verify a chunk store's vertex spill (geometry from the store's
    manifest, query width from the spill's own meta)."""
    meta_path = os.path.join(vdir, "spill_meta.json")
    if not os.path.exists(meta_path):
        return []
    with open(meta_path) as f:
        nq = int(json.load(f).get("num_queries", 1))
    spill = VertexSpill(vdir, len(store.partitions), store.num_batches,
                        store.batch_size, int(store.manifest["v_max"]),
                        num_queries=nq)
    return spill.verify()


def scrub_chunk_store(root: str) -> list[Report]:
    reports: list[Report] = []
    try:
        store = ChunkStore.open(root)
    except (IntegrityError, ChunkStoreError, OSError, ValueError) as exc:
        return [(f"{root} [manifest]", [str(exc)])]
    reports.append((f"{root} [chunks]", store.verify()))
    vdir = os.path.join(root, "vertex")
    if os.path.isdir(vdir):
        reports.append((f"{vdir} [spill]", scrub_spill(vdir, store)))
    for name in sorted(os.listdir(root)):
        cdir = os.path.join(root, name)
        if name.startswith("ckpt-") and os.path.isdir(cdir):
            reports.append((f"{cdir} [ckpt]", BlockStore(cdir).verify()))
    return reports


def scrub_root(root: str) -> list[Report]:
    if os.path.exists(os.path.join(root, SHARD_MANIFEST_NAME)):
        try:
            sharded = ShardedChunkStore.open(root)
        except (IntegrityError, ChunkStoreError, OSError,
                ValueError) as exc:
            return [(f"{root} [shards manifest]", [str(exc)])]
        reports: list[Report] = []
        for shard in sharded.shards:
            reports.extend(scrub_chunk_store(shard.root))
        return reports
    if os.path.exists(os.path.join(root, MANIFEST_NAME)):
        return scrub_chunk_store(root)
    if (os.path.isdir(os.path.join(root, "blocks"))
            and os.path.isdir(os.path.join(root, "manifests"))):
        return [(f"{root} [ckpt]", BlockStore(root).verify())]
    return [(root, [f"{root}: not a chunk store, sharded store, or "
                    f"checkpoint block store"])]


def main(argv: list[str]) -> int:
    """``argv[0]`` is the program name, the rest the roots to scrub."""
    if len(argv) < 2:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    bad = 0
    for root in argv[1:]:
        for label, damage in scrub_root(root):
            if damage:
                bad += len(damage)
                print(f"DAMAGED  {label}: {len(damage)} problem(s)")
                for d in damage:
                    print(f"    {d}")
            else:
                print(f"ok       {label}")
    if bad:
        print(f"fsck: {bad} damaged artifact(s) found")
        return 1
    print("fsck: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
