"""The dry run's per-rank counter (``repro_torch.launch.costing``) and the
flags it reads, on reduced configs on the CPU.

* (b) The corrected total: for one reduced model of each family (dense
  Yi, the Mamba2 hybrid Zamba2, RWKV6, DeepSeek-MoE, the Whisper
  encoder-decoder), a train step's FLOPs at full depth equal the step with
  every stage at n = 1 plus sum_s (n_s - 1) x the stage body's FLOPs
  (``corrected_totals``), exactly: the reference's ``test_costing`` asks
  for 0.6-1.4.  Unsharded, and on a fake (2, 2) mesh for Zamba2.
* (c) The unsharded dry run's FLOPs equal ``FlopCounterMode``'s count of a
  real CPU train step of the same model (remat on) and batch.
* (d) On a fake data-only (4, 1) mesh, rank 0's FLOPs x 4 equal (c).
* (g) ``flags.set_flag`` behaves as the reference's.

A dry run on a mesh runs in a subprocess (a fake default process group
must not outlive it); unsharded ones need no group and run here."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import costing, dryrun
from repro_torch.models import flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("yi-6b", "zamba2-1.2b", "rwkv6-1.6b", "deepseek-moe-16b",
            "whisper-medium")
SHAPE = ShapeSpec("t", "train", 32, 8)


def _cfg(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _at_depth_one(make_model):
    """``make_model`` with every stage (encoder stages too) cut to n = 1."""
    def make(cfg, **kw):
        model = make_model(cfg, **kw)
        model.stages = [dataclasses.replace(s, n=1) for s in model.stages]
        model.encoder_stages = [dataclasses.replace(s, n=1)
                                for s in model.encoder_stages]
        return model
    return make


def _identity(arch, tmp_path, monkeypatch):
    """(the full-depth record, the corrected total from depth one, the
    stage bodies), unsharded."""
    full = dryrun.run_cell(arch, SHAPE, multi_pod=False,
                           out_dir=str(tmp_path), device="cpu",
                           cfg=_cfg(arch), mesh_shape=(), cost_twin=True)
    assert full["ok"], full.get("traceback")
    bodies = [costing.BodyCost(**b) for b in
              full["corrected"]["scan_correction"]["per_stage"]]
    with monkeypatch.context() as m:
        m.setattr(dryrun, "make_model", _at_depth_one(dryrun.make_model))
        one = dryrun.run_cell(arch, SHAPE, multi_pod=False,
                              out_dir=str(tmp_path / "one"), device="cpu",
                              cfg=_cfg(arch), mesh_shape=())
    assert one["ok"], one.get("traceback")
    corrected = costing.corrected_totals(one["cost_analysis"], 0.0, bodies)
    return full, corrected, bodies


@pytest.mark.parametrize("arch", FAMILIES)
def test_corrected_total_equals_full_depth(arch, tmp_path, monkeypatch):
    full, corrected, bodies = _identity(arch, tmp_path, monkeypatch)
    assert corrected["flops"] == full["cost_analysis"]["flops"]
    assert any(b.trip > 1 for b in bodies)
    assert corrected["scan_correction"]["extra_flops"] > 0
    # the dry run's own record: every trip already counted, extras 0
    rec = full["corrected"]
    assert rec["flops"] == full["cost_analysis"]["flops"]
    assert rec["scan_correction"]["extra_flops"] == 0
    assert [b["trip"] for b in rec["scan_correction"]["per_stage"]] == [
        b.trip for b in bodies]


MESH_IDENTITY = r"""
import dataclasses, json, sys
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import costing, dryrun
arch, out = sys.argv[1], sys.argv[2]
cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
shape = ShapeSpec("t", "train", 32, 8)
make = dryrun.make_model
with dryrun.fake_process_group(4):
    full = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=out,
                           device="cpu", cfg=cfg, mesh_shape=(2, 2),
                           cost_twin=True)
    def one(cfg, **kw):
        m = make(cfg, **kw)
        m.stages = [dataclasses.replace(s, n=1) for s in m.stages]
        return m
    dryrun.make_model = one
    n1 = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=out + "/one",
                         device="cpu", cfg=cfg, mesh_shape=(2, 2))
bodies = [costing.BodyCost(**b)
          for b in full["corrected"]["scan_correction"]["per_stage"]]
print("RESULT", json.dumps({
    "full": full["cost_analysis"]["flops"],
    "corrected": costing.corrected_totals(n1["cost_analysis"], 0.0,
                                          bodies)["flops"],
    "ok": [full["ok"], n1["ok"]]}))
"""


def _run(code, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=timeout)
    assert r.returncode == 0 and "RESULT" in r.stdout, r.stderr[-3000:]
    return json.loads(r.stdout.split("RESULT", 1)[1])


def test_corrected_total_on_a_mesh(tmp_path):
    """The identity per rank on a fake (2, 2) mesh: Zamba2 (its shared
    block in the body) traced through DTensor."""
    got = _run(MESH_IDENTITY, "zamba2-1.2b", tmp_path)
    assert got["ok"] == [True, True]
    assert got["corrected"] == got["full"]


def _real_step_flops(arch, batch):
    """FlopCounterMode's count of one real CPU train step (remat on)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.model import make_model
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import OptConfig
    model = make_model(_cfg(arch), remat=True, device="cpu")
    state = init_train_state(model, seed=0)
    step = make_train_step(model, OptConfig(), make_rules(None))
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    return fc.get_total_flops()


def _batch(arch):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, _cfg(arch).vocab_size,
                        (SHAPE.global_batch, SHAPE.seq_len))
    return {k: torch.from_numpy(toks.astype(np.int32))
            for k in ("tokens", "targets")}


PER_RANK = r"""
import dataclasses, json, sys
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
arch, out = sys.argv[1], sys.argv[2]
cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
rec = dryrun.run_cell(arch, ShapeSpec("t", "train", 32, 8), multi_pod=False,
                      out_dir=out, device="cpu", cfg=cfg, mesh_shape=(4, 1))
print("RESULT", json.dumps({"ok": rec["ok"], "error": rec.get("error"),
                            "flops": rec.get("cost_analysis", {}).get("flops"),
                            "chips": rec["chips"], "rank": rec["rank"]}))
"""


@pytest.mark.parametrize("arch", ("yi-6b", "rwkv6-1.6b"))
def test_dry_run_flops_equal_a_real_step_and_split_over_ranks(arch,
                                                              tmp_path):
    real = _real_step_flops(arch, _batch(arch))
    dry = dryrun.run_cell(arch, SHAPE, multi_pod=False,
                          out_dir=str(tmp_path), device="cpu",
                          cfg=_cfg(arch), mesh_shape=())
    assert dry["ok"], dry.get("traceback")
    assert dry["mesh"] == "single" and dry["chips"] == 1
    assert dry["cost_analysis"]["flops"] == real           # (c)
    per_rank = _run(PER_RANK, arch, tmp_path)              # (d)
    assert per_rank["ok"], per_rank["error"]
    assert per_rank["chips"] == 4 and per_rank["rank"] == 0
    assert per_rank["flops"] * 4 == real


def test_memory_and_aliases_by_kind(tmp_path):
    """Train writes a new state (alias 0, outputs about the arguments);
    decode advances its caches in place (alias = the caches' bytes);
    nothing is counted twice."""
    cfg = get_reduced("zamba2-1.2b")
    out = {}
    for kind in ("train", "prefill", "decode"):
        rec = dryrun.run_cell("zamba2-1.2b", ShapeSpec(kind, kind, 64, 4),
                              multi_pod=False, out_dir=str(tmp_path),
                              device="cpu", cfg=cfg, mesh_shape=())
        assert rec["ok"], rec.get("traceback")
        out[kind] = rec["memory_analysis"]
    from repro_torch.models.model import make_model
    caches = make_model(cfg, device="cpu").init_cache(4, 64, device="meta")
    cache_bytes = costing.local_bytes(caches)
    assert out["train"]["alias_size_in_bytes"] == 0
    assert out["prefill"]["alias_size_in_bytes"] == 0
    assert out["decode"]["alias_size_in_bytes"] == cache_bytes
    assert out["train"]["temp_size_in_bytes"] > out["train"][
        "output_size_in_bytes"] > 0
    for m in out.values():
        assert m["generated_code_size_in_bytes"] == 0


def test_collective_kinds_from_the_wire():
    snap = {"calls": {"all_gather_tensor": 2, "all_gather_single": 1,
                      "reduce_scatter_tensor": 3, "all_reduce": 4,
                      "all_to_all_single": 5, "shard_dim_alltoall": 6},
            "bytes_by": {"all_gather_tensor": 20, "all_gather_single": 10,
                         "reduce_scatter_tensor": 30, "all_reduce": 40,
                         "all_to_all_single": 50, "shard_dim_alltoall": 60}}
    got = dryrun.collective_bytes_from_wire(snap)
    assert got["counts"] == {"all-gather": 3, "all-reduce": 4,
                             "reduce-scatter": 3, "all-to-all": 11,
                             "collective-permute": 0}
    assert got["by_op"] == {"all-gather": 30, "all-reduce": 40,
                            "reduce-scatter": 30, "all-to-all": 110,
                            "collective-permute": 0}
    assert got["total_operand_bytes"] == 210


def test_set_flag_behaves_as_the_references():
    from repro.models import flags as ref_flags
    names = ("TRAIN_MICROBATCHES", "MOE_GROUPS", "MOE_POSITION_BLOCK",
             "ATTN_CHUNK_THRESHOLD", "COST_ACCOUNTING_UNROLL")
    saved = {n: (getattr(flags, n), getattr(ref_flags, n)) for n in names}
    try:
        for name in names:
            for value in ("4", "none", "None", "0"):
                flags.set_flag(name, value)
                ref_flags.set_flag(name, value)
                assert getattr(flags, name) == getattr(ref_flags, name)
                assert type(getattr(flags, name)) is type(
                    getattr(ref_flags, name))
        for mod in (flags, ref_flags):
            with pytest.raises(KeyError):
                mod.set_flag("NO_SUCH_FLAG", "1")
            with pytest.raises(ValueError):
                mod.set_flag("TRAIN_MICROBATCHES", "four")
        for unroll in (False, True):
            flags.COST_ACCOUNTING_UNROLL = ref_flags.COST_ACCOUNTING_UNROLL \
                = unroll
            assert flags.inner_scan_unroll() == ref_flags.inner_scan_unroll()
    finally:
        for n, (ours, theirs) in saved.items():
            setattr(flags, n, ours)
            setattr(ref_flags, n, theirs)


def test_metadata_queries_are_neither_reads_nor_bytes():
    """``prim.device`` (DTensor asks it of fake tensors) moves no bytes and
    does not make its input an argument the step reads; an operation on an
    argument does both."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.costing import CostMode
    with FakeTensorMode():
        x, unread = torch.empty(1000), torch.empty(10)
        with CostMode(inputs=[x, unread]) as mode:
            torch.ops.prim.device.default(x)
            torch.ops.prim.device.default(unread)
            x + 1
    assert mode.bytes_accessed == 2 * 1000 * 4
    assert mode.read == {x.untyped_storage()._cdata}
