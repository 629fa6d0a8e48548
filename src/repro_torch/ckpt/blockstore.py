"""Persistent copy-on-write checkpointing (paper §3.2, generalized) — the
port of ``repro.ckpt.blockstore``, on disk byte for byte the same.

DFOGraph's fault tolerance: *never overwrite a data block*; each Process
call redirects writes to new blocks, per-(VertexArray, batch) block
locations are tracked, obsolete blocks are reclaimed by reference counting,
and recovery loses at most one Process call.

* arrays are chopped into fixed-size blocks; each block is stored
  **content-addressed** (sha256) — an unchanged block between checkpoints
  is the same file, so a checkpoint writes only what changed;
* a checkpoint = a manifest JSON listing, per array, shape/dtype and the
  ordered block hashes, written atomically (tmp + rename), so a crash
  mid-write leaves the previous checkpoint intact;
* reference counting = block hash reachable from any kept manifest; GC
  removes unreachable blocks when old manifests are pruned (``keep``);
* recovery = load the latest complete manifest (``restore_latest``).

Trees are nested dicts, lists and tuples (named tuples too) of numpy
arrays, torch tensors or scalars.  Their flattened keys are the
reference's: dict keys visited in sorted order, path parts joined with
``/`` (a named-tuple field is ``.name``), so either package restores the
other's checkpoints.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.utils import IntegrityError, atomic_write_json, json_crc

DEFAULT_BLOCK_BYTES = 1 << 22       # 4 MiB


def _children(node):
    """(key string, child) pairs of an inner node in the reference's visit
    order, or None for a leaf.  ``None`` is an empty node."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _leaves_with_paths(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        yield "/".join(prefix), tree
        return
    for key, child in kids:
        yield from _leaves_with_paths(child, prefix + (key,))


def _as_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree: Any) -> dict[str, np.ndarray]:
    return {key: _as_array(leaf) for key, leaf in _leaves_with_paths(tree)}


def _rebuild(template, flat, prefix=()):
    """``template``'s structure with each leaf replaced by ``flat``'s array
    under its key, cast to the leaf's dtype and shape (a torch tensor for a
    tensor leaf, on its device)."""
    kids = _children(template)
    if kids is None:
        arr = flat["/".join(prefix)]
        if isinstance(template, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                dtype=template.dtype, device=template.device).reshape(
                template.shape)
        dtype = getattr(template, "dtype", np.asarray(template).dtype)
        shape = getattr(template, "shape", np.shape(template))
        return arr.astype(dtype).reshape(shape)
    if template is None:
        return None
    built = [(key, _rebuild(child, flat, prefix + (key,)))
             for key, child in kids]
    if isinstance(template, dict):
        by_key = dict(built)
        return {k: by_key[str(k)] for k in template}
    values = [v for _, v in built]
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*values)
    return type(template)(values)


class BlockStore:
    """Content-addressed block storage with manifest checkpoints.

    ``keep`` retention semantics (every ``save`` prunes):
      * ``keep >= 1`` — retain the ``keep`` most recent manifests; older
        manifests are deleted and blocks reachable from no retained
        manifest are garbage-collected.
      * ``keep == 0`` — retention disabled: every manifest (and so every
        block) is kept forever.  Not "keep nothing": a store that deleted
        its own latest checkpoint could never recover.
    """

    def __init__(self, root: str, keep: int = 2,
                 block_bytes: int = DEFAULT_BLOCK_BYTES):
        if keep < 0:
            raise ValueError(f"keep must be >= 0 (0 = retain all), got {keep}")
        self.root = root
        self.keep = keep
        self.block_bytes = block_bytes
        os.makedirs(os.path.join(root, "blocks"), exist_ok=True)
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)

    # -- block level --------------------------------------------------------
    def _block_path(self, digest: str) -> str:
        return os.path.join(self.root, "blocks", digest + ".blk")

    def _put_block(self, data: bytes) -> tuple[str, bool]:
        digest = hashlib.sha256(data).hexdigest()[:32]
        path = self._block_path(digest)
        if os.path.exists(path):
            return digest, False          # COW reuse — no I/O
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)             # atomic
        return digest, True

    def _get_block(self, digest: str) -> bytes:
        path = self._block_path(digest)
        with open(path, "rb") as f:
            data = f.read()
        # The stored name IS the expected digest, so re-hashing on read
        # detects a flipped byte before it can reach a restore.
        got = hashlib.sha256(data).hexdigest()[:32]
        if got != digest:
            raise IntegrityError(
                f"checkpoint block {path} failed its content hash "
                f"(stored digest {digest}, read {got}) — disk corruption")
        return data

    # -- checkpoint level ----------------------------------------------------
    def save(self, tree: Any, step: int) -> dict:
        """Write a checkpoint; returns stats (blocks written vs reused)."""
        flat = _flatten_with_paths(tree)
        manifest = {"step": step, "arrays": {}}
        written = reused = bytes_written = 0
        for key, arr in flat.items():
            raw = np.ascontiguousarray(arr).tobytes()
            hashes = []
            for off in range(0, max(len(raw), 1), self.block_bytes):
                digest, new = self._put_block(raw[off:off + self.block_bytes])
                hashes.append(digest)
                if new:
                    written += 1
                    bytes_written += min(self.block_bytes, len(raw) - off)
                else:
                    reused += 1
            manifest["arrays"][key] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "blocks": hashes,
            }
        manifest["crc"] = json_crc({k: v for k, v in manifest.items()
                                    if k != "crc"})
        mpath = os.path.join(self.root, "manifests", f"{step:012d}.json")
        atomic_write_json(mpath, manifest)   # atomic commit point
        self._gc()
        return dict(blocks_written=written, blocks_reused=reused,
                    bytes_written=bytes_written)

    def steps(self) -> list[int]:
        names = os.listdir(os.path.join(self.root, "manifests"))
        return sorted(int(n.split(".")[0]) for n in names
                      if n.endswith(".json"))

    def _load_manifest(self, step: int) -> dict:
        mpath = os.path.join(self.root, "manifests", f"{step:012d}.json")
        with open(mpath) as f:
            manifest = json.load(f)
        want = manifest.get("crc")
        if want is not None:
            got = json_crc({k: v for k, v in manifest.items()
                            if k != "crc"})
            if got != want:
                raise IntegrityError(
                    f"checkpoint manifest {mpath} failed its checksum "
                    f"(stored crc {want}, computed {got})")
        return manifest

    def restore(self, step: int) -> dict[str, np.ndarray]:
        manifest = self._load_manifest(step)
        out = {}
        for key, meta in manifest["arrays"].items():
            raw = b"".join(self._get_block(h) for h in meta["blocks"])
            out[key] = np.frombuffer(
                raw, dtype=np.dtype(meta["dtype"])).reshape(
                meta["shape"]).copy()
        return out

    def restore_latest(self) -> tuple[int, dict[str, np.ndarray]] | None:
        steps = self.steps()
        if not steps:
            return None
        return steps[-1], self.restore(steps[-1])

    # -- offline scrub --------------------------------------------------------
    def verify(self) -> list[str]:
        """Re-hash every block and re-check every manifest (the fsck
        primitive).  Returns damage descriptions naming each bad file."""
        damage = []
        bdir = os.path.join(self.root, "blocks")
        for name in sorted(os.listdir(bdir)):
            if not name.endswith(".blk"):
                continue
            try:
                self._get_block(name[:-4])
            except IntegrityError as exc:
                damage.append(str(exc))
        for step in self.steps():
            try:
                manifest = self._load_manifest(step)
            except (IntegrityError, json.JSONDecodeError) as exc:
                damage.append(str(exc))
                continue
            for key, meta in manifest["arrays"].items():
                for h in meta["blocks"]:
                    if not os.path.exists(self._block_path(h)):
                        damage.append(
                            f"checkpoint manifest step {step} at "
                            f"{self.root}: array {key!r} references "
                            f"missing block {h}.blk")
        return damage

    # -- reference-counted GC -------------------------------------------------
    def _gc(self) -> None:
        if self.keep == 0:
            return                        # unbounded retention
        steps = self.steps()
        for s in steps[:-self.keep]:
            os.remove(os.path.join(self.root, "manifests", f"{s:012d}.json"))
        live: set[str] = set()
        for s in self.steps():
            with open(os.path.join(self.root, "manifests",
                                   f"{s:012d}.json")) as f:
                manifest = json.load(f)
            for meta in manifest["arrays"].values():
                live.update(meta["blocks"])
        bdir = os.path.join(self.root, "blocks")
        for name in os.listdir(bdir):
            if name.endswith(".blk") and name[:-4] not in live:
                os.remove(os.path.join(bdir, name))


class CheckpointManager:
    """Train-loop facade: unflattens restored arrays back into a tree."""

    def __init__(self, root: str, keep: int = 2,
                 block_bytes: int = DEFAULT_BLOCK_BYTES):
        self.store = BlockStore(root, keep=keep, block_bytes=block_bytes)

    def save(self, state: Any, step: int) -> dict:
        return self.store.save(state, step)

    def restore_into(self, template: Any) -> tuple[int, Any] | None:
        """Restore the latest checkpoint shaped like ``template`` (a tree
        of arrays, tensors, or anything with ``shape`` and ``dtype``);
        returns (step, state) or None."""
        got = self.store.restore_latest()
        if got is None:
            return None
        step, flat = got
        missing = {key for key, _ in _leaves_with_paths(template)} - set(flat)
        if missing:
            raise ValueError(
                f"checkpoint missing arrays: {sorted(missing)[:5]}")
        return step, _rebuild(template, flat)
