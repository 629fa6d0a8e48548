"""The port's copy-on-write block store (paper §3.2), mirroring
``tests/test_checkpoint.py``, and its compatibility with the reference's:
the same flattened keys in the same order, manifests and block files
byte-identical for the same tree, and each package restores the other's
checkpoints."""
import collections
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt import BlockStore, CheckpointManager
from repro_torch.ckpt.blockstore import _flatten_with_paths


def tree(step):
    rng = np.random.default_rng(42)  # same base data each step
    return {
        "a": rng.random((64, 64)).astype(np.float32) + step,
        "nested": {"b": np.arange(100, dtype=np.int32) * (step + 1)},
        "unchanged": np.ones((32,), np.float32),
    }


def test_save_restore_roundtrip(tmp_path):
    store = BlockStore(str(tmp_path), keep=2)
    t = tree(0)
    store.save(t, step=0)
    got = store.restore(0)
    np.testing.assert_array_equal(got["a"], t["a"])
    np.testing.assert_array_equal(got["nested/b"], t["nested"]["b"])


def test_cow_reuse_unchanged_blocks(tmp_path):
    """Paper Fig. 4: a checkpoint that changes one array reuses the other
    arrays' blocks."""
    store = BlockStore(str(tmp_path), keep=5)
    t = tree(0)
    s0 = store.save(t, step=0)
    assert s0["blocks_written"] > 0 and s0["blocks_reused"] == 0
    s1 = store.save(dict(t, a=t["a"] + 1.0), step=1)
    assert s1["blocks_reused"] >= 2
    assert s1["bytes_written"] < s0["bytes_written"] + 1


def _referenced(root, step):
    with open(os.path.join(root, "manifests", f"{step:012d}.json")) as f:
        return {h for meta in json.load(f)["arrays"].values()
                for h in meta["blocks"]}


def _on_disk(root):
    return {n[:-4] for n in os.listdir(os.path.join(root, "blocks"))}


def test_gc_reference_counting(tmp_path):
    store = BlockStore(str(tmp_path), keep=1)
    store.save(tree(0), step=0)
    store.save(tree(1), step=1)           # step 0 pruned, its blocks GC'd
    assert store.steps() == [1]
    assert _on_disk(str(tmp_path)) == _referenced(str(tmp_path), 1)


def test_keep_zero_retains_everything(tmp_path):
    store = BlockStore(str(tmp_path), keep=0)
    for s in range(5):
        store.save(tree(s), step=s)
    assert store.steps() == [0, 1, 2, 3, 4]
    for s in range(5):
        np.testing.assert_array_equal(store.restore(s)["a"], tree(s)["a"])
    live = set().union(*(_referenced(str(tmp_path), s)
                         for s in store.steps()))
    assert live <= _on_disk(str(tmp_path))


def test_keep_prunes_to_newest_n(tmp_path):
    store = BlockStore(str(tmp_path), keep=2)
    for s in range(5):
        store.save(tree(s), step=s)
    assert store.steps() == [3, 4]


def test_negative_keep_rejected(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        BlockStore(str(tmp_path), keep=-1)


def test_restore_latest_after_partial_write(tmp_path):
    store = BlockStore(str(tmp_path), keep=3)
    store.save(tree(0), step=0)
    with open(os.path.join(str(tmp_path), "manifests", "garbage.tmp"),
              "w") as f:
        f.write("{")
    step, got = store.restore_latest()
    assert step == 0
    np.testing.assert_array_equal(got["a"], tree(0)["a"])


def test_manager_restores_into_tree(tmp_path):
    """A template of tensors comes back as tensors (dtype, shape and
    device kept); of arrays, as arrays."""
    mgr = CheckpointManager(str(tmp_path))
    w = np.random.default_rng(1).random((8, 8)).astype(np.float32)
    mgr.save({"params": {"w": torch.from_numpy(w)},
              "step": np.asarray(7, np.int32)}, step=7)
    step, got = mgr.restore_into({"params": {"w": torch.zeros(8, 8)},
                                  "step": np.zeros((), np.int32)})
    assert step == 7
    assert isinstance(got["params"]["w"], torch.Tensor)
    np.testing.assert_array_equal(got["params"]["w"].numpy(), w)
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7


def test_resume_loses_at_most_one_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(3):
        mgr.save({"x": np.full((16,), float(s), np.float32)}, step=s)
    step, got = mgr.restore_into({"x": np.zeros((16,), np.float32)})
    assert step == 2
    np.testing.assert_array_equal(got["x"], np.full((16,), 2.0))


def test_restore_missing_array_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"x": np.zeros((4,), np.float32)}, step=0)
    with pytest.raises(ValueError, match="missing"):
        mgr.restore_into({"x": np.zeros((4,), np.float32),
                          "y": np.zeros((4,), np.float32)})


# ---------------------------------------------------------------------------
# Compatibility with repro.ckpt
# ---------------------------------------------------------------------------

Pair = collections.namedtuple("Pair", "left right")


def mixed_tree():
    """Dict keys out of order, nested lists and tuples, a named tuple, a
    None branch, scalars and several dtypes."""
    rng = np.random.default_rng(3)
    return {
        "z": [np.arange(5, dtype=np.int64),
              (np.float32(2.5), rng.random((3, 4)).astype(np.float32))],
        "b": {"y": np.array([True, False, True]), "a": None,
              "c": Pair(np.ones(2, np.float16), np.int32(7))},
        "a": rng.integers(0, 255, (7,)).astype(np.uint8),
    }


def test_flattened_keys_are_the_references():
    from repro.ckpt.blockstore import _flatten_with_paths as ref_flatten
    t = mixed_tree()
    mine, theirs = _flatten_with_paths(t), ref_flatten(t)
    assert list(mine) == list(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
        assert mine[k].dtype == theirs[k].dtype


def _tree_files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_checkpoints_byte_identical_to_the_references(tmp_path):
    from repro.ckpt import BlockStore as RefStore
    t = mixed_tree()
    for cls, name in ((BlockStore, "port"), (RefStore, "jax")):
        store = cls(str(tmp_path / name), keep=2, block_bytes=64)
        for s in range(3):
            store.save(dict(t, a=t["a"] + s), step=s)
    assert _tree_files(str(tmp_path / "port")) == \
        _tree_files(str(tmp_path / "jax"))


def test_repeated_blocks_counted_as_the_references(tmp_path):
    """A leaf of identical blocks (a fresh state's zero moments) writes one
    block and reuses the rest, as one thread would: the counts and the
    files equal the reference's, save after save."""
    from repro.ckpt import BlockStore as RefStore
    zeros = np.zeros(64 * 16, np.float32)          # 16 blocks of 256 bytes
    trees = [{"mu": zeros, "nu": zeros.copy(),
              "w": np.tile(np.arange(64, dtype=np.float32), 16)},
             {"mu": zeros + 1, "nu": zeros.copy(),
              "w": np.arange(64 * 16, dtype=np.float32)}]
    stats = {}
    for cls, name in ((BlockStore, "port"), (RefStore, "jax")):
        store = cls(str(tmp_path / name), keep=2, block_bytes=256)
        stats[name] = [store.save(t, step=s) for s, t in enumerate(trees)]
    assert stats["port"] == stats["jax"]
    assert stats["port"][0] == dict(blocks_written=2, blocks_reused=46,
                                    bytes_written=512)
    assert _tree_files(str(tmp_path / "port")) == \
        _tree_files(str(tmp_path / "jax"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_restores_the_others(tmp_path, writer):
    from repro.ckpt import BlockStore as RefStore
    from repro.ckpt import CheckpointManager as RefManager
    t = {"s:rank": np.random.default_rng(0).random((4, 60)).astype(
        np.float32), "active": np.ones((4, 60), bool)}
    (BlockStore if writer == "port" else RefStore)(
        str(tmp_path), keep=2, block_bytes=128).save(t, step=5)
    reader = RefStore if writer == "port" else BlockStore
    got = reader(str(tmp_path), keep=2).restore(5)
    assert sorted(got) == sorted(t)
    for k in t:
        np.testing.assert_array_equal(got[k], t[k])
        assert got[k].dtype == t[k].dtype
    manager = RefManager if writer == "port" else CheckpointManager
    step, back = manager(str(tmp_path)).restore_into(
        {k: np.zeros_like(v) for k, v in t.items()})
    assert step == 5
    np.testing.assert_array_equal(back["s:rank"], t["s:rank"])
    assert reader(str(tmp_path)).verify() == []


# ---------------------------------------------------------------------------
# Training states (bfloat16 params, float32 moments and masters, the step)
# ---------------------------------------------------------------------------

def _bits(x):
    """A leaf's raw bytes (a bfloat16 tensor's or ml_dtypes array's bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape)
    a = np.asarray(x)
    return a.tobytes(), a.shape


@pytest.fixture(scope="module")
def train_states():
    """The reference's fresh reduced zamba2 state (bfloat16 params) and the
    port's copy of it."""
    import jax
    from repro.configs import get_reduced as j_get_reduced
    from repro.models.model import make_model as j_make_model
    from repro.train.loop import init_train_state as j_init
    from repro_torch.configs import get_reduced
    from repro_torch.interop import train_state_from_jax
    jstate = jax.tree_util.tree_map(
        np.asarray, j_init(j_make_model(j_get_reduced("zamba2-1.2b")),
                           jax.random.PRNGKey(0)))
    assert jstate["params"]["embed"]["table"].dtype.name == "bfloat16"
    state = train_state_from_jax(jstate, get_reduced("zamba2-1.2b"),
                                 device="cpu")
    return jstate, state


def test_train_state_checkpoints_byte_identical(tmp_path, train_states):
    from repro.ckpt import CheckpointManager as RefManager
    jstate, state = train_states
    RefManager(str(tmp_path / "jax")).save(jstate, step=3)
    CheckpointManager(str(tmp_path / "port")).save(state, step=3)
    assert _tree_files(str(tmp_path / "port")) == \
        _tree_files(str(tmp_path / "jax"))
    with open(tmp_path / "port" / "manifests" / f"{3:012d}.json") as f:
        dtypes = {m["dtype"] for m in json.load(f)["arrays"].values()}
    assert dtypes == {"bfloat16", "float32", "int32"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_state_crosses_between_packages(tmp_path, train_states,
                                              writer):
    """A training state saved by either package's ``CheckpointManager``
    restores into the other's template bit for bit (the port's template:
    tensors; the reference's: numpy arrays)."""
    from repro.ckpt import CheckpointManager as RefManager
    from repro_torch.ckpt.blockstore import _leaves_with_paths
    jstate, state = train_states
    if writer == "jax":
        RefManager(str(tmp_path)).save(jstate, step=3)
        step, got = CheckpointManager(str(tmp_path)).restore_into(
            _zeros_like(state))
    else:
        CheckpointManager(str(tmp_path)).save(state, step=3)
        step, got = RefManager(str(tmp_path)).restore_into(
            _zeros_like(jstate))
    assert step == 3
    want = dict(_leaves_with_paths(state if writer == "port" else jstate))
    have = dict(_leaves_with_paths(got))
    assert have.keys() == want.keys()
    for k in want:
        assert _bits(have[k]) == _bits(want[k]), k
        if writer == "jax":
            assert isinstance(have[k], torch.Tensor)
            assert have[k].dtype == state_leaf(state, k).dtype, k


def state_leaf(tree, key):
    for part in key.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return np.zeros_like(tree)
