"""The integrity tier on the port (DESIGN.md §14), mirroring
``tests/test_integrity.py``: every persistent byte is checksummed, every
read verifies, and one flipped byte anywhere — chunk section, spill batch,
bitmap, checkpoint block, manifest, serialized edge list — is detected and
named, never decoded.

``python -m repro_torch.fsck`` is the offline scrub.  On the same damaged
(or clean) roots it gives ``scripts/fsck.py``'s verdict, exit code and
report, damaged files named alike.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.ckpt import BlockStore
from repro_torch.core import ChunkStore, build_dist_graph, build_formats
from repro_torch.core import make_spec
from repro_torch.core.chunkstore import (
    MANIFEST_NAME, REP_CSR, REP_DCSR, REP_DCSR_DELTA, ChunkStoreError,
    VertexSpill, manifest_self_crc,
)
from repro_torch.data.graphs import load_edge_list, rmat_graph, save_edge_list
from repro_torch.runtime.faults import flip_byte
from repro_torch.utils import IntegrityError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FSCK = os.path.join(REPO, "scripts", "fsck.py")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A small weighted problem with a pristine single store and a
    pristine 2-worker sharded store; damaging tests copy them."""
    root = tmp_path_factory.mktemp("tintegrity")
    g = rmat_graph(6, 8, seed=3, weighted=True)
    spec = make_spec(g, num_partitions=4, batch_size=16)
    dg = build_dist_graph(g, spec)
    fm = build_formats(dg)
    store = ChunkStore.build(dg, fm, str(root / "single"))
    sharded = ChunkStore.build_sharded(dg, fm, str(root / "sharded"), 2)
    return dict(g=g, store=store, sharded=sharded)


def copy_store(built, tmp_path, name="copy") -> ChunkStore:
    dst = str(tmp_path / name)
    shutil.copytree(built["store"].root, dst)
    return ChunkStore.open(dst)


def read_every_section(store: ChunkStore) -> None:
    """Every stored section of every chunk through verify-on-read."""
    for q in store.partitions:
        lay = store._layout_of(q)
        for p in range(store.num_partitions):
            for k in range(store.num_batches):
                if int(lay.offset[p, k]) < 0:
                    continue
                store.read_chunk_bytes(q, p, k, REP_DCSR)
                if store.compression:
                    store.read_chunk_bytes(q, p, k, REP_DCSR_DELTA)
                if lay.has_csr[p, k]:
                    store.read_chunk_bytes(q, p, k, REP_CSR)


# ---------------------------------------------------------------------------
# Chunk store: sections + manifest
# ---------------------------------------------------------------------------

def test_clean_store_reads_and_scrubs_clean(built, tmp_path):
    store = copy_store(built, tmp_path)
    read_every_section(store)
    assert store.verify() == []


def test_chunk_section_corruption_detected_on_read(built, tmp_path):
    store = copy_store(built, tmp_path)
    q = store.partitions[0]
    flip_byte(os.path.join(store.root, f"edges_q{q}.bin"))
    with pytest.raises(IntegrityError, match="checksum") as exc:
        read_every_section(store)
    assert f"edges_q{q}.bin" in str(exc.value)
    damage = store.verify()
    assert damage and any(f"edges_q{q}.bin" in d for d in damage)


@pytest.mark.parametrize("where", ["start", "third", "middle", "end"])
def test_chunk_corruption_at_every_section(built, tmp_path, where):
    q = built["store"].partitions[0]
    size = os.path.getsize(os.path.join(built["store"].root,
                                        f"edges_q{q}.bin"))
    off = {"start": 0, "third": size // 3, "middle": size // 2,
           "end": size - 1}[where]
    store = copy_store(built, tmp_path)
    flip_byte(os.path.join(store.root, f"edges_q{q}.bin"), off)
    with pytest.raises(IntegrityError, match="checksum"):
        read_every_section(store)


def test_manifest_tamper_detected(built, tmp_path):
    store = copy_store(built, tmp_path)
    path = os.path.join(store.root, MANIFEST_NAME)
    with open(path) as f:
        mani = json.load(f)
    mani["inflate_ratio"] = mani["inflate_ratio"] + 1.0   # stale crc
    with open(path, "w") as f:
        json.dump(mani, f)
    with pytest.raises(IntegrityError, match="manifest"):
        ChunkStore.open(store.root)
    mani["manifest_crc"] = manifest_self_crc(mani)
    with open(path, "w") as f:
        json.dump(mani, f)
    ChunkStore.open(store.root)


# ---------------------------------------------------------------------------
# Vertex spill: batches, bitmaps, attach
# ---------------------------------------------------------------------------

def make_spill(root, geometry=(4, 4, 16, 60)):
    p_cnt, b_cnt, bs, v_max = geometry
    rng = np.random.default_rng(7)
    spill = VertexSpill(str(root), p_cnt, b_cnt, bs, v_max)
    spill.load({"rank": rng.random((p_cnt, v_max)).astype(np.float32),
                "deg": rng.integers(0, 9, (p_cnt, v_max)).astype(np.int32)})
    return spill, np.ones((p_cnt, b_cnt), bool)


def shard_geometry(shard: ChunkStore):
    return (len(shard.partitions), shard.num_batches, shard.batch_size,
            int(shard.manifest["v_max"]))


def test_spill_batch_corruption_detected(tmp_path):
    spill, full = make_spill(tmp_path / "v")
    got = spill.read(full)
    np.testing.assert_array_equal(got["rank"][:, :60],
                                  spill.state_views()["rank"])
    flip_byte(spill._path("rank"))
    with pytest.raises(IntegrityError, match="rank") as exc:
        spill.read(full)
    assert "vertex_rank.bin" in str(exc.value)
    damage = spill.verify()
    assert damage and "rank" in damage[0]
    # a fresh load() rewrites data and sidecars: the rollback's self-heal
    spill.load({k: v[:, :60].copy() for k, v in spill.state_views().items()})
    spill.read(full)
    assert spill.verify() == []


def test_spill_write_refreshes_crcs(tmp_path):
    spill, full = make_spill(tmp_path / "v")
    upd = spill.read(full)
    upd["rank"] = upd["rank"] + 1.0
    spill.write(upd, full)
    spill.read(full)
    assert spill.verify() == []


def test_spill_bitmap_corruption_detected(tmp_path):
    spill, _ = make_spill(tmp_path / "v")
    spill.write_bitmap(np.random.default_rng(11).random((4, 60)) < 0.5)
    assert spill.read_bitmap() is not None
    flip_byte(os.path.join(spill.root, "active.bits"))
    with pytest.raises(IntegrityError, match="active.bits"):
        spill.read_bitmap()
    os.remove(os.path.join(spill.root, "active.bits.crc"))
    with pytest.raises(IntegrityError, match="no crc sidecar"):
        spill.read_bitmap()


def test_spill_attach_requires_sidecars(tmp_path):
    spill, _ = make_spill(tmp_path / "v")
    os.remove(spill._crc_path("deg"))
    with pytest.raises(ChunkStoreError, match="crc sidecar"):
        VertexSpill(str(tmp_path / "v"), 4, 4, 16, 60).attach()


def test_spill_attach_reopens_in_place(tmp_path):
    """An adopter attaches the files a dead rank left — the same arrays,
    dtypes and sidecars — without writing; ``on_disk`` says whether
    there is anything to attach.  The reference attaches the port's."""
    from repro.core.chunkstore import VertexSpill as RefSpill
    fresh = VertexSpill(str(tmp_path / "none"), 4, 4, 16, 60)
    assert not fresh.on_disk()
    with pytest.raises(ChunkStoreError, match="never load"):
        fresh.attach()
    spill, full = make_spill(tmp_path / "v")
    before = {n: os.path.getmtime(spill._path(n)) for n in spill.names()}
    for cls in (VertexSpill, RefSpill):
        other = cls(str(tmp_path / "v"), 4, 4, 16, 60)
        assert other.on_disk()
        other.attach()
        assert sorted(other.names()) == ["deg", "rank"]
        for n, arr in spill.state_views().items():
            np.testing.assert_array_equal(other.state_views()[n], arr)
            assert other.state_views()[n].dtype == arr.dtype
        assert other.verify() == []
    assert before == {n: os.path.getmtime(spill._path(n))
                      for n in spill.names()}


# ---------------------------------------------------------------------------
# Checkpoint block store
# ---------------------------------------------------------------------------

def test_ckpt_block_corruption_detected(tmp_path):
    store = BlockStore(str(tmp_path / "ck"), keep=2)
    rng = np.random.default_rng(5)
    store.save({"s": rng.random((64, 64)).astype(np.float32)}, step=1)
    bdir = os.path.join(store.root, "blocks")
    victim = sorted(os.listdir(bdir))[0]
    flip_byte(os.path.join(bdir, victim))
    with pytest.raises(IntegrityError):
        store.restore(1)
    damage = store.verify()
    assert damage and any(victim[:-4] in d for d in damage)


def test_ckpt_manifest_tamper_detected(tmp_path):
    store = BlockStore(str(tmp_path / "ck"), keep=2)
    store.save({"s": np.arange(1024, dtype=np.float32)}, step=1)
    mpath = os.path.join(store.root, "manifests", f"{1:012d}.json")
    with open(mpath) as f:
        mani = json.load(f)
    mani["step"] = 7
    with open(mpath, "w") as f:
        json.dump(mani, f)
    with pytest.raises(IntegrityError, match="manifest"):
        store.restore(1)


# ---------------------------------------------------------------------------
# Serialized edge lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_edge_list_roundtrip_and_corruption(tmp_path, weighted):
    g = rmat_graph(5, 4, seed=9, weighted=weighted)
    path = str(tmp_path / "edges.npz")
    crc = save_edge_list(g, path)
    back = load_edge_list(path, expect_crc=crc)
    assert back.num_vertices == g.num_vertices
    np.testing.assert_array_equal(back.src, g.src)
    np.testing.assert_array_equal(back.dst, g.dst)
    if weighted:
        np.testing.assert_array_equal(back.data, g.data)
    else:
        assert back.data is None
    flip_byte(path)
    with pytest.raises(IntegrityError, match="edges.npz"):
        load_edge_list(path, expect_crc=crc)


# ---------------------------------------------------------------------------
# python -m repro_torch.fsck, beside scripts/fsck.py
# ---------------------------------------------------------------------------

def run_fsck(*roots, ref=False):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = ([sys.executable, REF_FSCK] if ref
           else [sys.executable, "-m", "repro_torch.fsck"])
    proc = subprocess.run([*cmd, *roots], capture_output=True, text=True,
                          env=env, timeout=300)
    return proc.returncode, proc.stdout + proc.stderr


def both_fsck(*roots):
    """The port's verdict, held to the reference's: the same exit code and
    the same report, line for line."""
    code, out = run_fsck(*roots)
    rcode, rout = run_fsck(*roots, ref=True)
    assert code == rcode, (out, rout)
    if roots:
        assert out == rout
    return code, out


def populated_shards(built, tmp_path):
    """A sharded store with a spill and a per-op checkpoint store under
    each shard, as live dist_ooc workers leave them."""
    dst = str(tmp_path / "sh")
    shutil.copytree(built["sharded"].root, dst)
    out = {}
    for w in (0, 1):
        shard = ChunkStore.open(os.path.join(dst, f"w{w}"))
        geo = shard_geometry(shard)
        spill, _ = make_spill(os.path.join(dst, f"w{w}", "vertex"), geo)
        spill.write_bitmap(np.ones((geo[0], geo[3]), bool))
        ck = BlockStore(os.path.join(dst, f"w{w}", "ckpt-test"), keep=2)
        ck.save({"s": np.arange(256, dtype=np.float32)}, step=1)
        out[w] = (shard, spill, ck)
    return dst, out


def test_fsck_clean_sharded_store(built, tmp_path):
    dst, _ = populated_shards(built, tmp_path)
    code, out = both_fsck(dst)
    assert code == 0, out
    assert "fsck: clean" in out and "[spill]" in out and "[ckpt]" in out


DAMAGE = ["chunk", "spill", "bitmap", "ckpt_block", "ckpt_manifest",
          "spill_and_ckpt"]


@pytest.mark.parametrize("what", DAMAGE)
def test_fsck_names_the_same_damage_as_the_reference(built, tmp_path, what):
    dst, shards = populated_shards(built, tmp_path)
    shard, spill, ck = shards[1]
    victims = []
    if what == "chunk":
        victims.append(os.path.join(shard.root,
                                    f"edges_q{shard.partitions[0]}.bin"))
    if what in ("spill", "spill_and_ckpt"):
        victims.append(spill._path("rank"))
    if what == "bitmap":
        victims.append(os.path.join(spill.root, "active.bits"))
    if what in ("ckpt_block", "spill_and_ckpt"):
        bdir = os.path.join(ck.root, "blocks")
        victims.append(os.path.join(bdir, sorted(os.listdir(bdir))[0]))
    for v in victims:
        flip_byte(v)
    if what == "ckpt_manifest":
        mpath = os.path.join(ck.root, "manifests", f"{1:012d}.json")
        with open(mpath) as f:
            mani = json.load(f)
        mani["step"] = 9
        with open(mpath, "w") as f:
            json.dump(mani, f)
        victims.append(mpath)
    code, out = both_fsck(dst)
    assert code == 1, out
    assert "DAMAGED" in out and "fsck: clean" not in out
    for v in victims:
        assert os.path.basename(v) in out, (v, out)


def test_fsck_single_store_and_usage(built, tmp_path):
    code, out = both_fsck(built["store"].root)
    assert code == 0 and "fsck: clean" in out
    code, out = both_fsck()
    assert code == 2
    code, out = both_fsck(str(tmp_path / "not-a-store"))
    assert code == 1
    ck = BlockStore(str(tmp_path / "ck"), keep=2)
    ck.save({"s": np.arange(64, dtype=np.int32)}, step=3)
    code, out = both_fsck(ck.root)
    assert code == 0 and "[ckpt]" in out
