"""``python -m repro_torch.launch.train`` on the CPU (``--device cpu``):
it trains, checkpoints every ``--ckpt-every`` steps, resumes from the
block store, and a run interrupted after 2 steps and resumed for 2 more
ends at the loss of an uninterrupted 4-step run.  ``--mesh`` needs the
ranks of a process group."""
import os
import re
import subprocess
import sys

import numpy as np
import torch

from repro_torch.train.optimizer import OptConfig, lr_at

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "yi-6b", "--reduced", "--ckpt-every", "2", "--batch", "4",
        "--seq", "16", "--device", "cpu"]


def launch(*extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, *extra],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    return r


def final_loss(out):
    return re.search(r"done: final loss (\S+)", out).group(1)


def test_launcher_checkpoints_and_resumes(tmp_path):
    whole = launch("--steps", "4", "--ckpt", str(tmp_path / "a"))
    assert whole.returncode == 0, whole.stderr[-3000:]
    out = whole.stdout
    assert "step     1  loss" in out
    assert "checkpoint @ 2:" in out and "checkpoint @ 4:" in out
    again = launch("--steps", "4", "--ckpt", str(tmp_path / "a"), "--resume")
    assert again.returncode == 0, again.stderr[-3000:]
    assert again.stdout.splitlines()[0] == "resumed from step 4"

    # interrupted after 2 steps, resumed for 2 more.  The two schedules
    # (total 2 and total 4 steps, warmup 1) give steps 0 and 1 the same lr.
    for total in (2, 4):
        cfg = OptConfig(lr=3e-3, warmup_steps=1, total_steps=total)
        np.testing.assert_array_equal(
            lr_at(cfg, torch.arange(2)).numpy(),
            np.full(2, 3e-3, np.float32))
    first = launch("--steps", "2", "--ckpt", str(tmp_path / "b"))
    assert first.returncode == 0, first.stderr[-3000:]
    second = launch("--steps", "4", "--ckpt", str(tmp_path / "b"),
                    "--resume")
    assert second.returncode == 0, second.stderr[-3000:]
    assert second.stdout.splitlines()[0] == "resumed from step 2"
    assert "step     3  loss" in second.stdout
    assert final_loss(second.stdout) == final_loss(out)


def test_launcher_mesh_is_slice_8b():
    """``--mesh`` builds the production mesh over the ranks of a process
    group: run alone, with no launcher to start the ranks, it says so
    (``tests/test_torch_train_elastic.py`` runs it on 4 ranks)."""
    r = launch("--steps", "1", "--mesh")
    assert r.returncode != 0
    assert "NotImplementedError" not in r.stderr
    assert "needs an initialized process group" in r.stderr
    assert "run_mesh" in r.stderr
