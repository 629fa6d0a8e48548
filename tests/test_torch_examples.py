"""The port's examples run end to end on the CPU (``--device cpu``) in a
subprocess with jax made unimportable, and end with the line their
reference twins end with; the graph examples also print the reference's
figures."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import runpy, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.argv = [sys.argv[1], "--device", "cpu"]
runpy.run_path(sys.argv[0], run_name="__main__")
"""

EXAMPLES = {
    "quickstart_torch.py": ("quickstart OK", [
        "messages sent: 11125 (unfiltered would be 20480",
        "resumed at iter 3, converged at iter 8"]),
    "serve_graph_torch.py": ("serve_graph OK", [
        "served 10 queries in 13 batched iterations; measured disk bytes: "
        "1457928 (145793/query)  net bytes: 16858"]),
    "serve_lm_torch.py": ("serve_lm OK", [
        "yi-6b          generated (4, 12)",
        "zamba2-1.2b    generated (4, 12)"]),
    "train_lm_torch.py": ("train_lm OK", [
        "-- checkpoint at step 100; simulating restart --",
        "step  200 loss"]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name):
    last, lines = EXAMPLES[name]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-c", RUN, os.path.join(REPO, "examples", name)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.strip().splitlines()
    assert out[-1] == last, out[-5:]
    for line in lines:
        assert any(line in o for o in out), (line, out)
