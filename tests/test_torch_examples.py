"""The port's examples run end to end on the CPU (``--device cpu``) in a
subprocess with jax made unimportable, and end with the line their
reference twins end with; the graph examples also print the reference's
figures, and the MoE dispatch twin on the reference's inputs gives its
kept pairs and output."""
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
    "moe_dfo_dispatch_torch.py": ("moe_dfo_dispatch OK", [
        "tokens=64 experts=8 top_k=2 capacity/expert=20",
        "output shape (64, 32), finite=True"]),
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


def test_moe_dispatch_example_matches_reference():
    """The reference example's inputs (its PRNG keys) through the port's
    (2, 4) mesh of 8 CPU ranks: the kept (token, choice) pairs equal the
    reference's, the output within 1e-5 of the reference's function on
    one device (its sharding changes no value)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core.sparse_collectives import (
        dense_combine, dense_dispatch, topk_routing,
    )
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import moe_dfo_dispatch_torch as ex
    finally:
        sys.path.pop(0)
    t, d, e, k, cap = ex.T, ex.D, ex.E, ex.K, ex.CAP
    x = jax.random.normal(jax.random.PRNGKey(0), (t, d))
    router = jax.random.normal(jax.random.PRNGKey(1), (d, e)) * 0.3
    w_up = jax.random.normal(jax.random.PRNGKey(2), (e, d, 4 * d)) * d**-0.5
    w_dn = jax.random.normal(jax.random.PRNGKey(3),
                             (e, 4 * d, d)) * (4 * d)**-0.5
    dispatch, idx, pos, wts, _ = topk_routing(x @ router, k, cap)
    buf = dense_dispatch(x, dispatch, idx, pos, e, cap)
    h = jax.nn.silu(jnp.einsum("ecd,edf->ecf", buf, w_up))
    o = jnp.einsum("ecf,efd->ecd", h, w_dn)
    want = np.asarray(dense_combine(o, dispatch, idx, pos, wts, t))
    out, kept, counts = ex.run(*(np.asarray(a) for a in
                                 (x, router, w_up, w_dn)), device="cpu")
    assert kept == int(jnp.sum(dispatch))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    assert counts.get("all_gather_into_tensor", 0) >= 1
