"""The mesh half of training beyond one step, in one 4-rank gloo job on
the CPU (``trainmeshhelp.elastic_and_launcher``):

* ``make_production_mesh`` refuses a group of another size, naming both
  (256 ranks wanted, 4 present), and ``make_graph_mesh(4)`` spans the
  group along ``("part",)``;
* reduced Zamba2 in float32 on the (2, 2) mesh saves step 1 logically
  unsharded (one rank writes whole leaves: the store restores on one
  device into plain tensors equal to the gathered state), and
  ``elastic_restart(available=2, model_axis=2)`` re-plans onto (1, 2)
  with ranks 2 and 3 idle (they hold no state); step 2 there equals the
  uninterrupted (2, 2) step 2 under the mesh test's tolerances (metrics
  rtol 1e-5, first moments 1e-5 relative in norm, params 5e-2 / 5e-3);
* ``launch.train --mesh``, its production mesh swapped for the (2, 2)
  one inside the rank job, prints the single-device launcher's losses
  (rtol 1e-5; float32 reduced yi), checkpoints, and resumes.
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

from repro_torch.core import run_mesh

import trainmeshhelp

ARGV = ["--arch", "yi-6b", "--reduced", "--batch", "4", "--seq", "16",
        "--device", "cpu", "--ckpt-every", "2"]


def _f32_reduced(name):
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(name), dtype="float32")


def _batches():
    from repro_torch.data.tokens import TokenPipeline
    pipe = TokenPipeline(512, 16, 8, seed=3)
    out = []
    for i in range(2):
        toks, tgt = pipe.batch_at(i)
        out.append({"tokens": toks, "targets": tgt})
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    ranks = run_mesh(_rank_job, 4, device="cpu", timeout_s=900, args=(
        str(root / "ckpt"), str(root / "launch"),
        {"argv": ARGV, "batches": _batches()}))
    return ranks, root


def _rank_job(pm, ckpt_dir, launch_dir, launch_args):
    from repro_torch.launch import train as launcher
    launcher.get_reduced = _f32_reduced
    return trainmeshhelp.elastic_and_launcher(pm, ckpt_dir, launch_dir,
                                              launch_args)


def test_production_and_graph_meshes(job):
    ranks, _ = job
    out = ranks[0]
    assert "256 ranks" in out["production_error"]
    assert "has 4" in out["production_error"]
    assert out["graph_mesh"] == (("part",), (4,))


def test_elastic_restart_onto_a_smaller_mesh(job):
    from test_torch_train_mesh import assert_close_step
    ranks, _ = job
    out = ranks[0]
    assert out["elastic"]["step"] == 1 and out["elastic"]["shape"] == (1, 2)
    assert out["elastic"]["mesh"] == (1, 2)
    assert [r["active"] for r in ranks[1:]] == [True, False, False]
    assert [r["step"] for r in ranks[1:]] == [1, 1, 1]
    assert_close_step(out["elastic2"], out["whole2"], 1e-5)


def test_checkpoint_is_logically_unsharded(job):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models.model import make_model
    from repro_torch.train.loop import init_train_state
    from repro_torch.train.optimizer import flatten
    ranks, root = job
    model = make_model(trainmeshhelp.config("zamba2-1.2b"), device="cpu")
    step, state = CheckpointManager(str(root / "ckpt")).restore_into(
        init_train_state(model, seed=0))
    assert step == 1
    for got, want in zip(flatten(state["params"]),
                         ranks[0]["step1"]["params"]):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(flatten(state["opt"]["mu"]),
                         ranks[0]["step1"]["mu"]):
        np.testing.assert_array_equal(got.numpy(), want)


def _losses(text):
    return [float(x) for x in re.findall(r"loss (\S+)", text)]


def test_launcher_on_the_mesh_prints_the_single_device_losses(job, tmp_path,
                                                             monkeypatch):
    from repro_torch.launch import train as launcher
    ranks, _ = job
    out = ranks[0]
    monkeypatch.setattr(launcher, "get_reduced", _f32_reduced)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        launcher.main(ARGV + ["--steps", "4", "--ckpt", str(tmp_path)])
    single = text.getvalue()
    assert len(_losses(single)) == 2          # step 1 and the final loss
    np.testing.assert_allclose(_losses(out["launch_whole"]),
                               _losses(single), rtol=1e-5)
    assert "checkpoint @ 2:" in out["launch_whole"]
    assert "checkpoint @ 4:" in out["launch_whole"]
    # 2 steps, then resumed for 2 more: the uninterrupted final loss
    assert out["launch_resumed"].splitlines()[0] == "resumed from step 2"
    assert _losses(out["launch_resumed"])[-1] == _losses(single)[-1]
    assert all(r.get("launch_whole") is None for r in ranks[1:])
