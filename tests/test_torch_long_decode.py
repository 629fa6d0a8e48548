"""Context-parallel long-context decode (the ``long_decode`` plan, the
``long_500k`` cells) on ('data', 'model') device meshes of 4 gloo ranks on
the CPU, against the port's one-device decode and the reference's.  The
plan cuts the caches' ``cache_seq`` axis over the data axes; each rank
writes the token into its own shard and attends to its own slots, and
three all-reduces per attention layer make the softmax whole.

* (a) One attention layer's decode steps (``layers.attention`` with a
  pre-filled cache) on (2, 2) and (4, 1): global and sliding-window,
  softcap on and off, a rolling window cache whose ``pos % window`` crosses
  a shard boundary, rows whose every slot on a shard is masked (no NaN),
  and the GQA group axis over 'model' — each step's output within 1e-5 of
  the one-device layer's; the token lands on the one shard that holds its
  slot, and every other slot of every shard keeps its bytes.
* (b) Reduced Mixtral-8x22B (sliding window: a rolling cache), RWKV6 and
  Zamba2 in float32 on (2, 2), (4, 1) and ('pod', 'data', 'model') =
  (2, 2, 1), where ``cache_seq`` is cut over two axes, the pod the outer
  index (the multi-pod plan): the prompt's first tokens fed
  through the one-device serve step into a cache of ``CACHE_LEN`` slots,
  the cache placed by the plan, then ``STEPS`` greedy steps of the serve
  step on the mesh.  Tokens equal the one-device port's and the
  reference's ``ServeSession``; every cache leaf afterwards within 1e-5
  of the one-device port's and 1e-4 of the reference's, relative in its
  norm (as ``test_torch_serve_mesh.py``); the logits within 1e-4 of the
  reference's step jitted under the same plan on 4 forced host devices;
  the caches written in place, each rank holding of each leaf its global
  bytes over the product of the mesh axes the leaf is cut on.
  ``ServeSession`` runs under the plan from an empty cache, as on one
  device.
* (c) A decode step's collectives (calls and bytes by kind) are the same
  at a cache of 64 slots and of 128: nothing of the cache's length
  crosses the wire.

The rank job (``longdecodehelp.long_decode_job``) runs in a thread while
the reference's one-device sessions run in this process and its mesh
steps in a subprocess."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro_torch.core import run_mesh

import longdecodehelp

ARCHS = ("mixtral-8x22b", "rwkv6-1.6b", "zamba2-1.2b")
MESHES = ((2, 2), (4, 1))
PROMPT, STEPS, CACHE_LEN = 40, 8, 64
WIRE_LENS = (64, 128)
DECODE = [(arch, mesh) for mesh in MESHES + ((2, 2, 1),) for arch in ARCHS]

# (name, kind, window, softcap, slots, positions per step [B = 2], rules)
ATTENTION = [
    ("global", "global", 0, 0.0, 64,
     [[5, 40], [6, 41], [7, 47], [8, 48]], {}),
    ("softcap", "global", 0, 30.0, 64,
     [[0, 31], [1, 32], [2, 33]], {}),
    ("window", "local", 16, 0.0, 64,
     [[20, 50], [21, 63], [30, 47]], {}),
    ("rolling", "local", 16, 0.0, 16,
     [[6, 21], [7, 22], [8, 23], [9, 40]], {}),
    ("rolling-softcap", "local", 16, 50.0, 16,
     [[3, 15], [4, 16], [11, 35], [12, 36]], {}),
    ("grouped", "global", 0, 50.0, 64,
     [[9, 33], [10, 62], [11, 63]], {"kv_heads": None, "q_group": "model"}),
]
ATTN_CASES = [(c, mesh) for mesh in MESHES for c in ATTENTION]


def case_id(case):
    name, mesh = case
    name = name if isinstance(name, str) else name[0]
    return f"{name}-mesh{'x'.join(map(str, mesh))}"


REFERENCE_MESH = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_reduced
from repro.models.model import make_model
from repro.serve.engine import greedy_sample, make_serve_step
from repro.sharding.rules import make_rules
from repro.sharding.strategy import plan_for
job = json.loads(sys.argv[1])
prompts = np.asarray(job["prompts"], np.int32)
p = prompts.shape[1]
spec = lambda x: isinstance(x, tuple) and all(
    a is None or isinstance(a, str) for a in x)
out = {}
for arch in job["archs"]:
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    model = make_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1))
    one = jax.jit(make_serve_step(model, make_rules(None)))
    cache = model.init_cache(1, job["cache_len"])
    for i in range(p - 1):
        _, cache = one(params, cache, {"tokens": prompts[:, i:i + 1],
                                       "pos": np.full((1,), i, np.int32)})
    for shape in job["meshes"]:
        axes = ("pod", "data", "model")[-len(shape):]
        mesh = jax.make_mesh(tuple(shape), axes,
                             axis_types=(AxisType.Auto,) * len(shape))
        rules = plan_for(cfg, "long_decode", mesh).rules
        named = lambda tree: jax.tree_util.tree_map(
            lambda ax: NamedSharding(mesh, rules.spec(*ax)), tree,
            is_leaf=spec)
        psh, csh = named(model.param_specs()), named(
            model.cache_logical_specs())
        bsh = {"tokens": NamedSharding(mesh, rules.spec("batch", None)),
               "pos": NamedSharding(mesh, rules.spec("batch"))}
        step = jax.jit(lambda a, c, b: model.decode_step(a, c, b, rules),
                       in_shardings=(psh, csh, bsh))
        c = jax.device_put(cache, csh)
        a = jax.device_put(params, psh)
        tok, logits = prompts[:, p - 1:p], []
        with mesh:
            for i in range(job["steps"]):
                lg, c = step(a, c, {"tokens": tok, "pos": np.full(
                    (1,), p - 1 + i, np.int32)})
                c = jax.device_put(c, csh)   # as the plan places it
                logits.append(np.asarray(lg))
                tok = np.asarray(greedy_sample(lg, cfg.vocab_size))[:, None]
        out[arch + "|" + "x".join(map(str, shape))] = np.stack(logits, 1)
np.savez(job["out"], **out)
print("RESULT")
"""


def _prompts():
    return np.random.default_rng(7).integers(0, 512, (1, PROMPT),
                                             dtype=np.int32)


def _reference(arch, prompts):
    """The reference's params (numpy) and its one-device session's tokens
    and caches."""
    import jax
    from repro.configs import get_reduced as j_get_reduced
    from repro.models.model import make_model as j_make_model
    from repro.serve.engine import ServeSession as JServeSession
    from repro.sharding.rules import make_rules as j_make_rules
    cfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    model = j_make_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1))
    session = JServeSession(model, params, j_make_rules(None), batch=1,
                            cache_len=CACHE_LEN)
    tokens = session.generate(prompts, STEPS)
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "tokens": tokens,
            "cache": [np.asarray(x)
                      for x in jax.tree_util.tree_leaves(session.cache)]}


def _one_device(arch, params, prompts, steps=STEPS, cache_len=CACHE_LEN):
    """The port's one-device session: tokens and caches."""
    from repro_torch.interop import lm_params_from_jax
    from repro_torch.models.model import make_model
    from repro_torch.serve.engine import ServeSession
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.optimizer import flatten
    cfg = longdecodehelp.config(arch)
    session = ServeSession(make_model(cfg, device="cpu"),
                           lm_params_from_jax(params, cfg, device="cpu"),
                           make_rules(None), batch=prompts.shape[0],
                           cache_len=cache_len)
    tokens = session.generate(prompts, steps)
    return {"tokens": tokens,
            "cache": [x.numpy() for x in flatten(session.cache)]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The rank job's results (every rank's), and per arch the reference's
    and the one-device port's sessions and the reference's mesh logits."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        (os.path.join(os.path.dirname(here), "src"), here)))
    prompts = _prompts()
    npz = str(tmp_path_factory.mktemp("ref") / "logits.npz")
    ref_mesh = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_MESH, json.dumps(dict(
            archs=ARCHS, meshes=sorted({m for _, m in DECODE}),
            prompts=prompts.tolist(),
            steps=STEPS, cache_len=CACHE_LEN, out=npz))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    ref = {arch: _reference(arch, prompts) for arch in ARCHS}
    attention = [dict(name=c[0], kind=c[1], window=c[2], softcap=c[3],
                      slots=c[4], positions=c[5], overrides=c[6], seed=i,
                      mesh=mesh)
                 for i, (c, mesh) in enumerate(ATTN_CASES)]
    decode = [dict(arch=arch, mesh=mesh, params=ref[arch]["params"],
                   prompts=prompts, steps=STEPS, cache_len=CACHE_LEN)
              for arch, mesh in DECODE]
    wires = [dict(arch=arch, mesh=(2, 2), params=ref[arch]["params"],
                  prompts=prompts, cache_lens=WIRE_LENS) for arch in ARCHS]
    session = dict(arch="zamba2-1.2b", mesh=(2, 2),
                   params=ref["zamba2-1.2b"]["params"],
                   prompts=prompts[:, :4], steps=3, cache_len=16)
    got = {}

    def job():
        try:
            got["ranks"] = run_mesh(longdecodehelp.long_decode_job, 4,
                                    args=(attention, decode, wires, session),
                                    device="cpu", timeout_s=900)
        except BaseException as exc:          # re-raised in the test
            got["error"] = exc

    t = threading.Thread(target=job)
    t.start()
    one = {arch: _one_device(arch, ref[arch]["params"], prompts)
           for arch in ARCHS}
    one_session = _one_device("zamba2-1.2b", ref["zamba2-1.2b"]["params"],
                              prompts[:, :4], steps=3, cache_len=16)
    t.join()
    out, err = ref_mesh.communicate(timeout=900)
    if "error" in got:
        raise got["error"]
    assert ref_mesh.returncode == 0 and "RESULT" in out, err[-3000:]
    with np.load(npz) as f:
        ref_logits = dict(f)
    return dict(ranks=got["ranks"], ref=ref, one=one, ref_logits=ref_logits,
                one_session=one_session)


@pytest.mark.parametrize("case", ATTN_CASES, ids=case_id)
def test_attention_over_cache_shards_matches_one_device(results, case):
    i = ATTN_CASES.index(case)
    ranks = [r["attention"][i] for r in results["ranks"]]
    steps = len(case[0][5])
    for r in ranks:
        assert len(r["steps"]) == steps
        for s in r["steps"]:
            assert s["finite"], (r["rank"], s)
            assert s["rel"] <= 1e-5, (r["rank"], s["rel"])
    for s in range(steps):
        for row in range(2):
            audits = [(r["data"], r["steps"][s]["rows"][row])
                      for r in ranks]
            # every other slot of every shard keeps its bytes
            assert all(a["kept"] for _, a in audits), (s, row, audits)
            # the token lands on the one data shard that holds its slot
            owners = {d for d, a in audits if a["owner"]}
            assert len(owners) == 1, (s, row, audits)
            assert all(a["err"] <= 1e-5 for _, a in audits), audits


def _rel(a, b):
    return np.linalg.norm((a - b).ravel()) / max(
        np.linalg.norm(b.ravel()), 1e-30)


@pytest.mark.parametrize("case", DECODE, ids=case_id)
def test_long_decode_matches_one_device_and_reference(results, case):
    arch, mesh = case
    got = results["ranks"][0]["decode"][DECODE.index(case)]
    one, ref = results["one"][arch], results["ref"][arch]
    assert got["cache_seq"] == math.prod(mesh[:-1])     # the data axes
    assert "long_500k: context-parallel (seq/cache over data axes)" in \
        got["notes"]
    np.testing.assert_array_equal(one["tokens"], ref["tokens"])
    np.testing.assert_array_equal(got["tokens"], one["tokens"])
    assert len(got["cache"]) == len(one["cache"]) == len(ref["cache"])
    for i, (m, o, r) in enumerate(zip(got["cache"], one["cache"],
                                      ref["cache"])):
        assert m.shape == o.shape == r.shape, i
        for want, rtol in ((o, 1e-5), (r, 1e-4)):
            err = np.linalg.norm((m - want).ravel())
            assert err <= rtol * np.linalg.norm(want.ravel()) + 1e-9, (
                i, err, np.linalg.norm(want.ravel()))
    assert got["in_place"]
    assert got["priced"] and all(got["priced"])
    ref_logits = results["ref_logits"][arch + "|" + "x".join(map(str, mesh))]
    assert got["logits"].shape == ref_logits.shape
    assert _rel(got["logits"], ref_logits) <= 1e-4
    # the attention layers' all-reduces cross the wire; no all-gather of
    # a cache-length tensor (the bytes do not grow with the cache: (c))
    if arch != "rwkv6-1.6b":
        assert got["wire"]["calls"].get("all_reduce", 0) > 0


def test_serve_session_runs_under_the_plan(results):
    got = results["ranks"][0]["session"]
    np.testing.assert_array_equal(got["tokens"],
                                  results["one_session"]["tokens"])
    for m, o in zip(got["cache"], results["one_session"]["cache"]):
        assert _rel(m, o) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_collectives_do_not_grow_with_the_cache(results, arch):
    for r in results["ranks"]:
        by_len = r["wire"][ARCHS.index(arch)]
        a, b = (by_len[n] for n in WIRE_LENS)
        assert a["calls"] == b["calls"] and a["bytes_by"] == b["bytes_by"], \
            (arch, a, b)
        assert a["bytes"] > 0
