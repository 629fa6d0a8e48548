"""Rank jobs for ``tests/test_torch_long_decode.py``: module-level functions
that :func:`repro_torch.core.mesh.run_mesh` runs on every rank of a 4-rank
gloo group on the CPU.  They import only the port (a spawned rank need not
load jax) and return plain Python and numpy results from every rank."""
import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import layers as L
from repro_torch.models.config import AttnSpec
from repro_torch.models.model import make_model
from repro_torch.serve import engine
from repro_torch.serve.engine import make_serve_step
from repro_torch.sharding import wire
from repro_torch.sharding.rules import full, make_rules
from repro_torch.sharding.strategy import plan_for
from repro_torch.train.optimizer import flatten

AXES = ("data", "model")
CACHE_AXES = ("batch", "cache_seq", "kv_heads", None)


def config(arch):
    """The reduced config in float32."""
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _mesh(meshes, shape):
    """The ('data', 'model') mesh of ``shape``, ('pod', 'data', 'model')
    for three axes."""
    if shape not in meshes:         # every rank builds each mesh, in order
        axes = ("pod",) + AXES if len(shape) == 3 else AXES
        meshes[shape] = make_device_mesh(shape, axes, device="cpu")
    return meshes[shape]


def _local(x):
    return (x.to_local() if hasattr(x, "to_local") else x).clone()


def attention_case(mesh, case):
    """One attention layer's decode steps (``layers.attention`` with a
    cache) on ``mesh`` under context-parallel rules against the same steps
    on one device, from the same seeded parameters, inputs and pre-filled
    cache.  ``case``: {kind, window, softcap, slots, positions (per step,
    [B]), overrides (rules table), seed}.  Returns, per step, the output's
    error relative to the one-device output's norm and whether it is
    finite; and the write's audit on this rank: for each row, whether this
    rank's shard holds the slot, whether every other slot of the shard
    kept its bytes, and the written slot's error against one device."""
    base = get_reduced("yi-6b")
    cfg = dataclasses.replace(
        base, dtype="float32",
        attn=AttnSpec(pattern=(case["kind"],), window=case["window"],
                      softcap=case["softcap"]))
    gen = torch.Generator().manual_seed(case["seed"])
    params = L.init_attention(L.Init(gen), cfg, torch.float32)
    specs = L.init_attention(L.Init(None), cfg, torch.float32)
    rng = np.random.default_rng(case["seed"])
    positions = np.asarray(case["positions"], np.int64)     # [steps, B]
    steps, b = positions.shape
    sc = case["slots"]
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    xs = torch.from_numpy(rng.standard_normal(
        (steps, b, 1, cfg.d_model)).astype(np.float32))
    filled = {k: torch.from_numpy(rng.standard_normal(
        (b, sc, kv, hd)).astype(np.float32)) for k in ("k", "v")}
    rolling = case["kind"] == "local" and sc == case["window"]

    one = {k: v.clone() for k, v in filled.items()}
    rules = make_rules(mesh, batch=None, seq="data", cache_seq="data",
                       **case["overrides"])
    placed = rules.tree_shard(params, specs)
    cache = rules.tree_shard({k: v.clone() for k, v in filled.items()},
                             {"k": CACHE_AXES, "v": CACHE_AXES})
    offset, n = rules.shard_range("cache_seq", sc)
    out = {"offset": offset, "slots": n, "steps": []}
    for i in range(steps):
        pos = torch.from_numpy(positions[i])
        with torch.no_grad():
            want, _ = L.attention(params, xs[i], pos[:, None],
                                  make_rules(None), cfg, kind=case["kind"],
                                  cache=one, decode_pos=pos)
        before = {k: _local(cache[k]) for k in ("k", "v")}
        with implicit_replication(), torch.no_grad():
            got, _ = L.attention(placed, xs[i], pos[:, None], rules, cfg,
                                 kind=case["kind"], cache=cache,
                                 decode_pos=pos)
        got = full(got)
        widx = positions[i] % sc if rolling else positions[i]
        rows = []
        for r in range(b):
            slot = int(widx[r]) - offset
            owner = 0 <= slot < n
            kept, err = True, 0.0
            for k in ("k", "v"):
                after = _local(cache[k])[r]
                old = before[k][r]
                others = torch.ones(n, dtype=torch.bool)
                if owner:
                    others[slot] = False
                    head = _head_slice(cache[k], kv)
                    err = max(err, float(
                        (after[slot] - one[k][r, int(widx[r]), head]).abs()
                        .max()))
                kept &= bool(torch.equal(after[others], old[others]))
            rows.append({"owner": owner, "kept": kept, "err": err})
        out["steps"].append({
            "rel": float(torch.linalg.vector_norm(got - want)
                         / torch.linalg.vector_norm(want)),
            "finite": bool(torch.isfinite(got).all()), "rows": rows})
    out["rank"] = dist.get_rank()
    out["data"] = int(mesh.get_coordinate()[0])
    return out


def _head_slice(x, kv):
    """The KV heads a cache's local shard holds (all where whole)."""
    if not hasattr(x, "placements"):
        return slice(None)
    heads = x.to_local().shape[2]
    if heads == kv:
        return slice(None)
    start = int(x.device_mesh.get_coordinate()[1]) * heads
    return slice(start, start + heads)


def decode_case(mesh, case):
    """``case``'s reduced model (``arch``, the reference's float32 params)
    under ``plan_for(cfg, "long_decode", mesh)``: the prompt's first P - 1
    tokens fed through the one-device serve step into a cache of
    ``cache_len`` slots, the cache placed by ``cache_logical_specs``,
    then ``steps`` greedy steps of the mesh's serve step from the prompt's
    last token (its logits recorded).  Returns the tokens, the logits, the
    caches whole, whether every cache leaf kept its local storage, and the
    collectives of the first mesh step."""
    cfg = config(case["arch"])
    model = make_model(cfg, device="cpu")
    params = lm_params_from_jax(case["params"], cfg, device="cpu")
    prompts = torch.from_numpy(case["prompts"])
    b, p = prompts.shape

    def batch(tok, i):
        return {"tokens": tok, "pos": torch.full((b,), i, dtype=torch.int32)}

    one_step = make_serve_step(model, make_rules(None))
    cache = model.init_cache(b, case["cache_len"])
    with torch.no_grad():
        for i in range(p - 1):
            _, cache = one_step(params, cache, batch(prompts[:, i:i + 1], i))
    plan = plan_for(cfg, "long_decode", mesh)
    rules = plan.rules
    cache = rules.tree_shard(cache, model.cache_logical_specs())
    placed = rules.tree_shard(params, model.param_specs())
    step = make_serve_step(model, rules)
    logits = []
    sample = engine.greedy_sample

    def recording(lg, vocab):
        logits.append(full(lg).numpy().copy())
        return sample(lg, vocab)

    storages = [_storage(x) for x in flatten(cache)]
    # each cache leaf's local bytes: its global bytes over the product of
    # the mesh axes its logical axes map to
    cut = [math.prod(rules.logical_size(a) for a in spec if a is not None)
           for spec in flatten_specs(model.cache_logical_specs())]
    priced = [x.to_local().nbytes * n == x.numel() * x.element_size()
              for x, n in zip(flatten(cache), cut)]
    tokens, wires = [], []
    tok = prompts[:, p - 1:p]
    engine.greedy_sample = recording
    try:
        with torch.no_grad():
            for i in range(case["steps"]):
                wire.WIRE.reset()
                nxt, cache = step(placed, cache, batch(tok, p - 1 + i))
                wires.append(wire.WIRE.snapshot())
                tokens.append(nxt.numpy().copy())
                tok = nxt[:, None]
    finally:
        engine.greedy_sample = sample
    return {"tokens": np.stack(tokens, axis=1), "logits": np.stack(logits, 1),
            "cache": [full(x).numpy() for x in flatten(cache)],
            "in_place": [_storage(x) for x in flatten(cache)] == storages,
            "priced": priced,
            "wire": wires[0], "notes": list(plan.notes),
            "cache_seq": rules.logical_size("cache_seq")}


def flatten_specs(tree):
    """The logical-axis tuples of a spec tree, in ``flatten``'s order."""
    if isinstance(tree, tuple) and all(a is None or isinstance(a, str)
                                       for a in tree):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in flatten_specs(tree[k])]
    return [s for v in tree for s in flatten_specs(v)]


def _storage(x):
    return (x.to_local() if hasattr(x, "to_local") else x) \
        .untyped_storage().data_ptr()


def wire_at(mesh, case, cache_len):
    """The collectives of one long-context decode step of ``case``'s model
    at a cache of ``cache_len`` slots (zeros), from the same token and
    position (after a first step at them, which builds what DTensor
    caches)."""
    cfg = config(case["arch"])
    model = make_model(cfg, device="cpu")
    rules = plan_for(cfg, "long_decode", mesh).rules
    params = rules.tree_shard(
        lm_params_from_jax(case["params"], cfg, device="cpu"),
        model.param_specs())
    cache = rules.tree_shard(model.init_cache(1, cache_len),
                             model.cache_logical_specs())
    step = make_serve_step(model, rules)
    batch = {"tokens": torch.from_numpy(case["prompts"][:, :1]),
             "pos": torch.full((1,), 5, dtype=torch.int32)}
    with torch.no_grad():
        step(params, cache, batch)
        wire.WIRE.reset()
        step(params, cache, batch)
    return wire.WIRE.snapshot()


def session_case(mesh, case):
    """``ServeSession`` under the ``long_decode`` plan from an empty cache:
    the tokens and the caches whole."""
    cfg = config(case["arch"])
    model = make_model(cfg, device="cpu")
    rules = plan_for(cfg, "long_decode", mesh).rules
    params = rules.tree_shard(
        lm_params_from_jax(case["params"], cfg, device="cpu"),
        model.param_specs())
    session = engine.ServeSession(model, params, rules,
                                  batch=case["prompts"].shape[0],
                                  cache_len=case["cache_len"])
    tokens = session.generate(case["prompts"], case["steps"])
    return {"tokens": tokens,
            "cache": [full(x).numpy() for x in flatten(session.cache)]}


def long_decode_job(pm, attention_cases, decode_cases, wire_cases, session):
    """Every case of each kind, in order, on every rank."""
    meshes = {}
    wire.install()
    out = {"attention": [attention_case(_mesh(meshes, tuple(c["mesh"])), c)
                         for c in attention_cases]}
    out["decode"] = [decode_case(_mesh(meshes, tuple(c["mesh"])), c)
                     for c in decode_cases]
    out["wire"] = [{n: wire_at(_mesh(meshes, tuple(c["mesh"])), c, n)
                    for n in c["cache_lens"]} for c in wire_cases]
    out["session"] = session_case(_mesh(meshes, tuple(session["mesh"])),
                                  session)
    if dist.get_rank():                 # the whole values on rank 0 only
        out["decode"] = out["session"] = None
    return out
