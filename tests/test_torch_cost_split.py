"""Rank 0's matmul FLOPs on a ('data', 'model') = (1, 4) mesh against the
split a real one-device step implies, for the two attention plans that
cut heads the grouped layout cannot hold: Gemma2 (2 KV heads in groups
of 2: flat-head attention, q / k / v projected whole and the repeated
heads cut over 'model') and Llama3 (2 KV heads in groups of 4: q and o
over the GQA group axis, k and v whole).

The dry run's train step (remat on, 8 x 32 tokens, reduced configs in
float32) is counted once unsharded and once on rank 0 of a fake (1, 4)
group (``CostMode.matmuls``: each matmul with its local shapes).  Held:

* the two runs perform the same matmuls in the same order: rank 0 counts
  no operation twice and none the one-device step lacks;
* each of rank 0's matmuls is the one-device one whole or cut to a
  quarter, nothing else;
* the matmuls left whole are exactly those the model's structure puts
  outside the cut, FLOPs counted from the config: the projections the
  plan leaves unsharded in each of their four passes (forward, the
  remat recompute, the input and weight gradients), and for Gemma2 the
  o projection's input gradient, which DTensor computes on the gathered
  ``wo`` rather than reduce the partial gradient first;
* rank 0's total is the one-device total / 4 plus 3/4 of those.

The unsharded count equals ``FlopCounterMode`` of a real CPU step
(``test_torch_costing.py`` (c)), so this is the expected split of a real
step.  The runs go in a subprocess: a fake default group must not
outlive them."""
import json
import os
import subprocess
import sys
from fractions import Fraction

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gemma2-9b", "llama3-405b")
BATCH, SEQ = 8, 32

RUNS = r"""
import dataclasses, json, sys, tempfile
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import costing, dryrun
kept = []


class Keep(costing.CostMode):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        kept.append(self)


dryrun.CostMode = Keep
shape = ShapeSpec("t", "train", int(sys.argv[2]), int(sys.argv[1]))
out = {}
for arch in sys.argv[3:]:
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    one = dryrun.run_cell(arch, shape, multi_pod=False,
                          out_dir=tempfile.mkdtemp(), device="cpu", cfg=cfg,
                          mesh_shape=())
    one_mm = kept[-1].matmuls
    with dryrun.fake_process_group(4):
        mesh = dryrun.run_cell(arch, shape, multi_pod=False,
                               out_dir=tempfile.mkdtemp(), device="cpu",
                               cfg=cfg, mesh_shape=(1, 4))
    out[arch] = dict(
        ok=[one["ok"], mesh["ok"]], error=mesh.get("error"),
        notes=mesh.get("plan_notes"), one=one_mm, mesh=kept[-1].matmuls,
        one_flops=one["cost_analysis"]["flops"],
        mesh_flops=mesh["cost_analysis"]["flops"],
        by_op=mesh["flops_by_op"],
        cfg=dict(layers=sum(s.n * len(s.cycle)
                            for s in dryrun.make_model(cfg, device="cpu")
                            .stages),
                 d=cfg.d_model, h=cfg.num_heads, kv=cfg.num_kv_heads,
                 hd=cfg.head_dim))
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", RUNS, str(BATCH), str(SEQ),
                        *ARCHS], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=600)
    assert r.returncode == 0 and "RESULT" in r.stdout, r.stderr[-3000:]
    return json.loads(r.stdout.split("RESULT", 1)[1])


def _whole_flops(arch, c):
    """FLOPs of the one-device matmuls the (1, 4) plan leaves whole."""
    t = BATCH * SEQ
    passes = 4              # forward, remat recompute, d input, d weight
    kv_out = 2 * c["kv"] * c["hd"]            # k and v projections
    if arch == "gemma2-9b":                   # flat heads: q too, and the
        q_out = c["h"] * c["hd"]              # o projection's d input
        return c["layers"] * 2 * t * c["d"] * (
            passes * (q_out + kv_out) + q_out)
    return c["layers"] * passes * 2 * t * c["d"] * kv_out


@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_flops_are_the_expected_split(runs, arch):
    got = runs[arch]
    assert got["ok"] == [True, True], got["error"]
    assert len(got["mesh"]) == len(got["one"]) > 0
    whole = 0
    for i, ((op1, _, f1), (op4, _, f4)) in enumerate(zip(got["one"],
                                                         got["mesh"])):
        assert op1 == op4, (i, op1, op4)
        share = Fraction(int(f4), int(f1))
        assert share in (1, Fraction(1, 4)), (i, op1, share)
        whole += f1 if share == 1 else 0
    assert sum(f for _, _, f in got["mesh"]) == got["mesh_flops"]
    assert whole == _whole_flops(arch, got["cfg"])
    assert got["mesh_flops"] == got["one_flops"] / 4 + whole * 3 / 4
    assert sum(r["flops"] for r in got["by_op"]) == got["mesh_flops"]
    assert sum(r["calls"] for r in got["by_op"]) == len(got["mesh"])


def test_the_plans_are_flat_head_and_group_axis(runs):
    assert runs["gemma2-9b"]["notes"] == [
        "kv=2, group=2 indivisible by tp=4 but H=4 divides: flat-head "
        "attention w/ repeated KV"]
    assert runs["llama3-405b"]["notes"] == [
        "kv=2 not divisible by tp=4: q/o sharded over the GQA group axis "
        "(g=4), k/v replicated"]
