"""The port's prefill and decode on ('data', 'model') device meshes of 4
gloo ranks on the CPU, (2, 2) and (1, 4), against its own one-device
serving and the reference's, for a dense model (yi), the Mamba2 hybrid
(zamba2, its shared attention block included), RWKV6 and the
encoder-decoder (whisper, its cross-attention caches set to seeded
values so that decode reads them).  The reference's parameters (float32
reduced configs) cross with ``interop.lm_params_from_jax`` and are placed
by ``plan_for``'s prefill and decode plans; ``ServeSession`` places its
caches by ``cache_logical_specs``.  Held:

* the prefill step's greedy tokens and ``ServeSession.generate``'s tokens
  equal the one-device port's and the reference's;
* every cache leaf afterwards, gathered whole, within 1e-5 of the
  one-device port's and 1e-4 of the reference's, relative in the leaf's
  norm, as ``test_torch_train_mesh.py`` holds the first moments (a
  sharded contraction sums in another order; 1e-4 is the cross-package
  tolerance of ``test_torch_train_arch.py``);
* each rank wrote its cache shards in place: every leaf kept its local
  storage through the whole generation;
* the dry run of the same decode step on rank 0 of a fake mesh of the
  same shape counts as aliased exactly rank 0's local cache bytes in the
  real run.

All cases run in one 4-rank job (``trainmeshhelp.serve_cases``) while the
reference and the one-device port run in this process, and the dry runs
in a subprocess."""
import dataclasses
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import run_mesh

import trainmeshhelp

ARCHS = ("yi-6b", "zamba2-1.2b", "rwkv6-1.6b", "whisper-medium")
MESHES = ((2, 2), (1, 4))
CASES = [(arch, mesh) for mesh in MESHES for arch in ARCHS]
BATCH, PROMPT, STEPS, FRAMES = 4, 6, 4, 16
CACHE_LEN = PROMPT + STEPS + 1


def case_id(case):
    arch, mesh = case
    return f"{arch}-mesh{'x'.join(map(str, mesh))}"


def _inputs(arch):
    """The reference's params (numpy), the prompts, the encoder frames and
    the cross-attention caches (numpy, per stage and block) of ``arch``."""
    import jax
    from repro.configs import get_reduced as j_get_reduced
    from repro.models.model import make_model as j_make_model
    cfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    model = j_make_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT),
                           dtype=np.int32)
    frames = cross = None
    if cfg.is_encdec:
        frames = rng.standard_normal(
            (BATCH, FRAMES, cfg.d_model)).astype(np.float32)
        shape = (BATCH, cfg.max_source_positions, cfg.num_kv_heads,
                 cfg.head_dim)
        cross = [[tuple(rng.standard_normal((stage.n,) + shape)
                        .astype(np.float32) for _ in range(2))
                  for _ in stage.cycle] for stage in model.stages]
    return dict(model=model, params=params, prompts=prompts, frames=frames,
                cross=cross)


def _reference(inp):
    """The reference's prefill tokens, generated tokens and caches."""
    import jax
    import jax.numpy as jnp
    from repro.serve.engine import ServeSession as JServeSession
    from repro.serve.engine import make_prefill_and_decode as j_prefill
    from repro.sharding.rules import make_rules as j_make_rules
    model, params = inp["model"], inp["params"]
    batch = {"tokens": jnp.asarray(inp["prompts"])}
    if inp["frames"] is not None:
        batch["frames"] = jnp.asarray(inp["frames"])
    first = np.asarray(j_prefill(model, j_make_rules(None))[0](params,
                                                               batch))
    session = JServeSession(model, params, j_make_rules(None), batch=BATCH,
                            cache_len=CACHE_LEN)
    for blocks, arrays in zip(session.cache, inp["cross"] or ()):
        for blk, (ck, cv) in zip(blocks, arrays):
            blk["ck"], blk["cv"] = jnp.asarray(ck), jnp.asarray(cv)
    tokens = session.generate(inp["prompts"], STEPS)
    return {"prefill": first, "tokens": tokens,
            "cache": [np.asarray(x)
                      for x in jax.tree_util.tree_leaves(session.cache)]}


def _one_device(arch, case):
    """The port's prefill tokens, generated tokens and caches on one
    device."""
    from repro_torch.models.model import make_model
    from repro_torch.serve.engine import (
        ServeSession, make_prefill_and_decode,
    )
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.optimizer import flatten
    from repro_torch.interop import lm_params_from_jax
    cfg = trainmeshhelp.config(arch)
    model = make_model(cfg, device="cpu")
    params = lm_params_from_jax(case["params"], cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(case["prompts"])}
    if case["frames"] is not None:
        batch["frames"] = torch.from_numpy(case["frames"])
    prefill, _ = make_prefill_and_decode(model, make_rules(None))
    with torch.no_grad():
        first = prefill(params, batch).numpy()
    session = ServeSession(model, params, make_rules(None), batch=BATCH,
                           cache_len=CACHE_LEN)
    for blocks, arrays in zip(session.cache, case["cross"] or ()):
        for blk, (ck, cv) in zip(blocks, arrays):
            blk["ck"], blk["cv"] = (torch.from_numpy(ck.copy()),
                                    torch.from_numpy(cv.copy()))
    tokens = session.generate(case["prompts"], STEPS)
    return {"prefill": first, "tokens": tokens,
            "cache": [x.numpy() for x in flatten(session.cache)]}


DRY_RUNS = r"""
import json, sys
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
import trainmeshhelp
out = {}
for arch, mesh in json.loads(sys.argv[1]):
    with dryrun.fake_process_group(4):
        rec = dryrun.run_cell(
            arch, ShapeSpec("d", "decode", int(sys.argv[3]),
                            int(sys.argv[4])), multi_pod=False,
            out_dir=sys.argv[2], device="cpu",
            cfg=trainmeshhelp.config(arch), mesh_shape=tuple(mesh))
    out[arch + "|" + "x".join(map(str, mesh))] = dict(
        ok=rec["ok"], error=rec.get("error"),
        memory=rec.get("memory_analysis"))
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{case_id: (mesh result, one-device result, reference result)} and
    the dry runs' records."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        (os.path.join(os.path.dirname(here), "src"), here)))
    dry = subprocess.Popen(
        [sys.executable, "-c", DRY_RUNS, json.dumps(CASES),
         str(tmp_path_factory.mktemp("dryrun")), str(CACHE_LEN),
         str(BATCH)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    import jax
    inputs = {arch: _inputs(arch) for arch in ARCHS}
    cases = []
    for arch, mesh in CASES:
        inp = inputs[arch]
        cases.append(dict(
            arch=arch, mesh=mesh, steps=STEPS, prompts=inp["prompts"],
            frames=inp["frames"], cross=inp["cross"],
            params=jax.tree_util.tree_map(np.asarray, inp["params"])))
    got = {}

    def job():
        try:
            got["port"] = run_mesh(trainmeshhelp.serve_cases, 4,
                                   args=(cases,), device="cpu",
                                   timeout_s=900)[0]
        except BaseException as exc:          # re-raised in the test
            got["error"] = exc

    t = threading.Thread(target=job)
    t.start()
    ref = {arch: _reference(inputs[arch]) for arch in ARCHS}
    one = {arch: _one_device(arch, c) for arch, c in zip(ARCHS, cases)}
    t.join()
    out, err = dry.communicate(timeout=600)
    if "error" in got:
        raise got["error"]
    assert dry.returncode == 0 and "RESULT" in out, err[-3000:]
    dry_runs = json.loads(out.split("RESULT", 1)[1])
    return ({case_id(c): (p, one[c[0]], ref[c[0]])
             for c, p in zip(CASES, got["port"])}, dry_runs)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_mesh_serving_matches_one_device_and_reference(results, case):
    mesh, one, ref = results[0][case_id(case)]
    np.testing.assert_array_equal(one["prefill"], ref["prefill"])
    np.testing.assert_array_equal(mesh["prefill"], one["prefill"])
    np.testing.assert_array_equal(one["tokens"], ref["tokens"])
    np.testing.assert_array_equal(mesh["tokens"], one["tokens"])
    assert len(mesh["cache"]) == len(one["cache"]) == len(ref["cache"])
    for i, (m, o, r) in enumerate(zip(mesh["cache"], one["cache"],
                                      ref["cache"])):
        assert m.shape == o.shape == r.shape, i
        for want, rtol in ((o, 1e-5), (r, 1e-4)):
            err = np.linalg.norm((m - want).ravel())
            assert err <= rtol * np.linalg.norm(want.ravel()) + 1e-9, (
                i, err, np.linalg.norm(want.ravel()))
    assert mesh["in_place"]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_dry_run_decode_aliases_the_local_caches(results, case):
    arch, shape = case
    rec = results[1][arch + "|" + "x".join(map(str, shape))]
    assert rec["ok"], rec["error"]
    got = results[0][case_id(case)][0]["local_cache_bytes"]
    assert rec["memory"]["alias_size_in_bytes"] == got > 0
