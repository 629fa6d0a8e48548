"""The port's train step on a ('data', 'model') = (2, 2) device mesh of 4
gloo ranks on the CPU against the reference's unsharded
``make_train_step`` (``make_rules(None)``), one case per model family:
dense GQA (yi), Gemma2 local/global with softcap, the Zamba2 hybrid,
RWKV6, DeepSeek-MoE with its experts over 'model' (EP), and Mixtral
with 3 experts, which ``plan_for`` shards within each expert on the
2-wide 'model' axis.  The reference's state (``init_train_state``,
float32 reduced configs) crosses with ``interop.train_state_from_jax``
and is placed by ``plan_for(cfg, "train", mesh)``; the batches are
``TokenPipeline``'s (8 x 16, seed 3).  After one step at lr 1e-3:

* against the port's own one-device step on the same state, the
  tolerances of ``test_torch_train_loop.py::test_grad_accumulation_equivalent``
  (a data-parallel split changes the order of the sums as accumulation
  does): loss, ce, moe_aux and grad norm at rtol 1e-5, each first-moment
  leaf at 1e-5 relative in its norm, the parameters at rtol 5e-2 / atol
  5e-3 (the first AdamW step is about lr x sign(g));
* against the reference: the metrics at rtol 1e-5, the parameters at the
  same 5e-2 / 5e-3, and each first-moment leaf (0.1 x the clipped
  gradient) at 1e-4 relative in its norm, the cross-package gradient
  tolerance of ``test_torch_train_arch.py``: the port's one-device step
  is itself 2.1e-5 from the reference in one of RWKV6's leaves;
* the second step's loss at rtol 1e-4 from the reference's.

All cases run in one 4-rank job (``trainmeshhelp.train_cases``) while the
reference compiles its steps in this process, and the dry run
(``launch.dryrun``) traces each case's step on rank 0 of a fake (2, 2)
mesh in a subprocess: its collective calls and operand bytes by kind must
equal rank 0's measured ones in step 1."""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro_torch.core import run_mesh

import trainmeshhelp

FAMILIES = [("yi-6b", None, 1, None), ("gemma2-9b", None, 1, None),
            ("zamba2-1.2b", None, 1, None), ("rwkv6-1.6b", None, 1, None),
            ("deepseek-moe-16b", None, 1, None),
            ("mixtral-8x22b", 3, 1, None)]
OPT = dict(lr=1e-3, warmup_steps=0)


def case_id(case):
    """(arch, experts, microbatches, MoE groups[, mesh shape: (2, 2) by
    default]) -> the case's name."""
    arch, experts, micro, groups = case[:4]
    return arch + (f"-e{experts}" if experts else "") + (
        f"-micro{micro}" if micro > 1 else "") + (
        f"-groups{groups}" if groups else "") + (
        "-mesh" + "x".join(map(str, case[4])) if len(case) > 4 else "")


def _reference(case):
    """The reference's initial state and batches (numpy), and a function
    computing its two steps."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced as j_get_reduced
    from repro.data.tokens import TokenPipeline
    from repro.models import flags as j_flags
    from repro.models.model import make_model as j_make_model
    from repro.sharding.rules import make_rules as j_make_rules
    from repro.train.loop import init_train_state as j_init
    from repro.train.loop import make_train_step as j_make_train_step
    from repro.train.optimizer import OptConfig as JOptConfig
    arch, experts, micro, groups = case[:4]
    cfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    if experts:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    model = j_make_model(cfg)
    state = jax.jit(lambda k: j_init(model, k))(jax.random.PRNGKey(2))
    pipe = TokenPipeline(cfg.vocab_size, 16, 8, seed=3)
    batches = []
    for i in range(2):
        toks, tgt = pipe.batch_at(i)
        batches.append({"tokens": np.asarray(toks),
                        "targets": np.asarray(tgt)})
    np_state = jax.tree_util.tree_map(np.asarray, state)

    def steps():
        j_flags.MOE_GROUPS = groups
        try:
            step = jax.jit(j_make_train_step(model, JOptConfig(**OPT),
                                             j_make_rules(None),
                                             microbatches=micro))
            s1, m1 = step(state, {k: jnp.asarray(v)
                                  for k, v in batches[0].items()})
            _, m2 = step(s1, {k: jnp.asarray(v)
                              for k, v in batches[1].items()})
        finally:
            j_flags.MOE_GROUPS = None
        leaves = jax.tree_util.tree_leaves
        return {"metrics": {k: float(v) for k, v in m1.items()},
                "mu": [np.asarray(x) for x in leaves(s1["opt"]["mu"])],
                "params": [np.asarray(x) for x in leaves(s1["params"])],
                "metrics2": {k: float(v) for k, v in m2.items()}}

    return dict(arch=arch, experts=experts, micro=micro, groups=groups,
                mesh=case[4] if len(case) > 4 else None,
                state=np_state, batches=batches, opt=OPT), steps


def run_against_reference(cases):
    """{case_id: (port's result, reference's result)}: the port's mesh job
    runs in a thread while the reference's steps compile and run here."""
    inputs, steps = zip(*(_reference(c) for c in cases))
    got = {}

    def job():
        try:
            got["port"] = run_mesh(trainmeshhelp.train_cases, 4,
                                   args=(list(inputs),), device="cpu",
                                   timeout_s=900)[0]
        except BaseException as exc:          # re-raised in the test
            got["error"] = exc

    t = threading.Thread(target=job)
    t.start()
    ref = [s() for s in steps]
    one = [one_device(x) for x in inputs]
    t.join()
    if "error" in got:
        raise got["error"]
    return {case_id(c): (p, o, r)
            for c, p, o, r in zip(cases, got["port"], one, ref)}


def one_device(case):
    """The port's step 1 on one device from the same state and batch."""
    import torch
    from repro_torch.interop import train_state_from_jax
    from repro_torch.models import flags
    from repro_torch.models.model import make_model
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import OptConfig, flatten
    cfg = trainmeshhelp.config(case["arch"], case["experts"])
    flags.MOE_GROUPS = case["groups"]
    try:
        model = make_model(cfg, device="cpu")
        state = train_state_from_jax(case["state"], cfg, device="cpu")
        s1, m1 = make_train_step(model, OptConfig(**case["opt"]),
                                 make_rules(None), microbatches=case["micro"])(
            state, trainmeshhelp.batch(case["batches"][0]))
    finally:
        flags.MOE_GROUPS = None
    with torch.no_grad():
        return {"metrics": {k: float(v) for k, v in m1.items()},
                "mu": [x.numpy() for x in flatten(s1["opt"]["mu"])],
                "params": [x.numpy() for x in flatten(s1["params"])]}


def assert_close_step(port, want, mu_rtol):
    for k in ("loss", "ce", "moe_aux", "grad_norm"):
        np.testing.assert_allclose(port["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert len(port["mu"]) == len(want["mu"])
    for i, (a, b) in enumerate(zip(want["mu"], port["mu"])):
        assert a.shape == b.shape, i
        err = np.linalg.norm((a - b).ravel())
        assert err <= mu_rtol * np.linalg.norm(a.ravel()) + 1e-9, (
            i, err, np.linalg.norm(a.ravel()))
    for a, b in zip(want["params"], port["params"]):
        np.testing.assert_allclose(b, a, rtol=5e-2, atol=5e-3)


def assert_step_matches(port, one, ref):
    assert_close_step(port, one, 1e-5)
    assert_close_step(port, ref, 1e-4)
    np.testing.assert_allclose(port["metrics2"]["loss"],
                               ref["metrics2"]["loss"], rtol=1e-4)


DRY_RUNS = r"""
import json, sys
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
import trainmeshhelp
out = {}
with dryrun.fake_process_group(4):
    for case in json.loads(sys.argv[1]):
        arch, experts, micro, groups = case
        cfg = trainmeshhelp.config(arch, experts)
        rec = dryrun.run_cell(arch, ShapeSpec("t", "train", 16, 8),
                              multi_pod=False, out_dir=sys.argv[2],
                              device="cpu", cfg=cfg, mesh_shape=(2, 2),
                              remat=False)
        out["|".join(map(str, case))] = dict(
            ok=rec["ok"], error=rec.get("error"),
            collectives=rec.get("collectives"))
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    """The dry run of every case's step, started in a subprocess before the
    rank job (each case's batch is 8 x 16, one microbatch, no remat, as
    ``train_cases`` trains)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        (os.path.join(os.path.dirname(here), "src"), here)))
    return subprocess.Popen(
        [sys.executable, "-c", DRY_RUNS, json.dumps(FAMILIES),
         str(tmp_path_factory.mktemp("dryrun"))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)


@pytest.fixture(scope="module")
def results(dry_runs):
    return run_against_reference(FAMILIES)


@pytest.mark.parametrize("case", FAMILIES, ids=case_id)
def test_mesh_train_step_matches_reference(results, case):
    assert_step_matches(*results[case_id(case)])


def test_plans_of_the_families(results):
    """EP for DeepSeek's 8 experts, TP within Mixtral's 3, SSM heads over
    'model' for Zamba2: the plans the cases trained under."""
    notes = {k: v[0]["notes"] for k, v in results.items()}
    assert notes["deepseek-moe-16b"] == ("EP: 8 experts over tp=2",)
    assert notes["mixtral-8x22b-e3"] == (
        "3 experts not divisible by tp=2: TP-within-expert (expert_ff over "
        "'model')",)
    assert notes["zamba2-1.2b"] == ("SSM heads over tp=2",)


def test_dry_run_collectives_equal_the_measured_step(results, dry_runs):
    """(e) Rank 0's collectives in the dry run of each case's step equal
    rank 0's ``sharding.wire`` count of step 1 of the real 4-rank gloo
    run: calls and operand bytes by kind."""
    from repro_torch.launch.dryrun import collective_bytes_from_wire
    out, err = dry_runs.communicate(timeout=600)
    assert dry_runs.returncode == 0 and "RESULT" in out, err[-3000:]
    dry = json.loads(out.split("RESULT", 1)[1])
    for case in FAMILIES:
        got = dry["|".join(map(str, case))]
        assert got["ok"], (case, got["error"])
        measured = collective_bytes_from_wire(
            results[case_id(case)][0]["wire1"])
        assert measured["total_operand_bytes"] > 0
        assert got["collectives"] == measured, case
