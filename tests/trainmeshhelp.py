"""Rank jobs for the mesh training tests (``tests/test_torch_train_mesh*.py``,
``tests/test_torch_train_elastic.py``) and the mesh serving test
(``tests/test_torch_serve_mesh.py``): module-level functions that
:func:`repro_torch.core.mesh.run_mesh` runs on every rank of a 4-rank gloo
group on the CPU.  They import only the port (a spawned rank need not load
jax), take the reference's states as numpy trees, and return plain Python
and numpy results from rank 0 (None from the others)."""
import contextlib
import dataclasses
import io

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.interop import lm_params_from_jax, train_state_from_jax
from repro_torch.launch.mesh import make_device_mesh, make_graph_mesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import flags
from repro_torch.models.model import make_model
from repro_torch.runtime.elastic import elastic_restart
from repro_torch.serve.engine import ServeSession, greedy_sample
from repro_torch.sharding import wire
from repro_torch.sharding.rules import full
from repro_torch.sharding.strategy import plan_for
from repro_torch.train.loop import (
    init_train_state, make_prefill_step, make_train_step, save_checkpoint,
    state_specs,
)
from repro_torch.train.optimizer import OptConfig, flatten

MESH = (2, 2)
AXES = ("data", "model")


def config(arch, experts=None):
    """The reduced config in float32, with ``experts`` experts if given."""
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    if experts:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg


def batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def kept(state, metrics):
    """Metrics, first moments and params of a step, whole, as numpy on
    rank 0 (every rank of the state's mesh takes part in the gathers)."""
    rank0 = dist.get_rank() == 0
    got = {"metrics": {k: float(v) for k, v in metrics.items()}}
    for name, tree in (("mu", state["opt"]["mu"]),
                       ("params", state["params"])):
        leaves = [full(x) for x in flatten(tree)]
        got[name] = [x.numpy() for x in leaves] if rank0 else None
    return got if rank0 else None


def train_cases(pm, cases):
    """Each case ({arch, experts, micro, groups, mesh, state, batches,
    opt}): the reference's state placed by the plan on its mesh (``MESH``
    when None), two steps;
    step 1's metrics, moments, params and collectives (rank 0's
    ``sharding.wire`` snapshot) and step 2's metrics."""
    meshes = {}
    out = []
    for case in cases:
        shape = tuple(case.get("mesh") or MESH)
        if shape not in meshes:     # every rank builds each mesh, in order
            meshes[shape] = make_device_mesh(shape, AXES, device="cpu")
        mesh = meshes[shape]
        flags.MOE_GROUPS = case["groups"]
        try:
            cfg = config(case["arch"], case["experts"])
            model = make_model(cfg, device="cpu")
            plan = plan_for(cfg, "train", mesh)
            state = train_state_from_jax(case["state"], cfg, device="cpu")
            state = plan.rules.tree_shard(state, state_specs(model))
            step = make_train_step(model, OptConfig(**case["opt"]),
                                   plan.rules, microbatches=case["micro"])
            wire.WIRE.reset()
            s1, m1 = step(state, batch(case["batches"][0]))
            step1_wire = wire.WIRE.snapshot()
            got = kept(s1, m1)
            _, m2 = step(s1, batch(case["batches"][1]))
            if got is not None:
                got["metrics2"] = {k: float(v) for k, v in m2.items()}
                got["notes"] = plan.notes
                got["wire1"] = step1_wire
            out.append(got)
        finally:
            flags.MOE_GROUPS = None
    return out if dist.get_rank() == 0 else None


def local_storages(tree):
    """The storage of each leaf's local shard (a plain leaf's own)."""
    return [(x.to_local() if hasattr(x, "to_local") else x)
            .untyped_storage().data_ptr() for x in flatten(tree)]


def serve_cases(pm, cases):
    """Each case ({arch, mesh, params, prompts, frames, cross, steps}):
    the reference's params placed by ``plan_for``'s prefill and decode
    plans on the case's mesh; the prefill step's greedy tokens (``frames``
    for the encoder when given), then ``ServeSession.generate``'s tokens
    (``steps`` after the prompt) with the cross-attention caches set to
    ``cross`` when given, its caches whole afterwards, whether every
    cache leaf kept its local storage (a write in place), and rank 0's
    local cache bytes."""
    meshes = {}
    out = []
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:     # every rank builds each mesh, in order
            meshes[shape] = make_device_mesh(shape, AXES, device="cpu")
        mesh = meshes[shape]
        cfg = config(case["arch"])
        model = make_model(cfg, device="cpu")
        params = lm_params_from_jax(case["params"], cfg, device="cpu")
        prompts = case["prompts"]
        batch = {"tokens": torch.from_numpy(prompts)}
        if case["frames"] is not None:
            batch["frames"] = torch.from_numpy(case["frames"])
        pre = plan_for(cfg, "prefill", mesh).rules
        logits = make_prefill_step(model, pre)(
            pre.tree_shard(params, model.param_specs()), batch)
        first = greedy_sample(full(logits), cfg.vocab_size)
        rules = plan_for(cfg, "decode", mesh).rules
        session = ServeSession(
            model, rules.tree_shard(params, model.param_specs()), rules,
            batch=prompts.shape[0],
            cache_len=prompts.shape[1] + case["steps"] + 1)
        specs = model.cache_logical_specs()
        for (blocks, bspecs), arrays in zip(
                zip(session.cache, specs), case["cross"] or ()):
            for blk, bspec, (ck, cv) in zip(blocks, bspecs, arrays):
                blk["ck"] = rules.shard(torch.from_numpy(ck), *bspec["ck"])
                blk["cv"] = rules.shard(torch.from_numpy(cv), *bspec["cv"])
        before = local_storages(session.cache)
        tokens = session.generate(prompts, case["steps"])
        got = {"prefill": first.numpy(), "tokens": tokens,
               "in_place": local_storages(session.cache) == before,
               "local_cache_bytes": sum(
                   (x.to_local() if hasattr(x, "to_local") else x).nbytes
                   for x in flatten(session.cache)),
               "cache": [full(x).numpy() for x in flatten(session.cache)]}
        out.append(got if dist.get_rank() == 0 else None)
    return out if dist.get_rank() == 0 else None


def _launch(main, argv):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        main(argv)
    return text.getvalue()


def elastic_and_launcher(pm, ckpt_dir, launch_dir, launch_args):
    """(1) ``make_production_mesh`` on 4 ranks raises naming both sizes,
    ``make_graph_mesh(4)`` spans them; (2) reduced zamba2 in float32 on the
    (2, 2) mesh: step 1, saved logically unsharded, step 2, then
    ``elastic_restart`` onto (1, 2) (ranks 2 and 3 idle) and step 2 there;
    (3) ``launch.train --mesh`` with the production mesh swapped for the
    (2, 2) one: 4 steps, then 2 steps and 2 resumed."""
    from repro_torch.launch import train as launcher
    rank = dist.get_rank()
    out = {}
    try:
        make_production_mesh(device="cpu")
    except ValueError as exc:
        out["production_error"] = str(exc)
    graph = make_graph_mesh(4, device="cpu")
    out["graph_mesh"] = (graph.mesh_dim_names, tuple(graph.shape))

    mesh = make_device_mesh(MESH, AXES, device="cpu")
    cfg = config("zamba2-1.2b")
    model = make_model(cfg, device="cpu")
    rules = plan_for(cfg, "train", mesh).rules
    opt = OptConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(model, opt, rules)
    b = [batch(x) for x in launch_args["batches"]]
    s1, m1 = step(init_train_state(model, seed=2, rules=rules), b[0])
    out["step1"] = kept(s1, m1)
    save_checkpoint(CheckpointManager(ckpt_dir), s1, 1)
    s2, m2 = step(s1, b[1])
    out["whole2"] = kept(s2, m2)

    def factory(new_mesh):
        r = plan_for(cfg, "train", new_mesh).rules
        return r, r.tree_shardings(state_specs(model))

    got_step, state, new_mesh, plan = elastic_restart(
        ckpt_dir, s1, available=2, model_axis=2, rules_factory=factory,
        device="cpu")
    out["elastic"] = dict(step=got_step, shape=plan.shape,
                          active=state is not None,
                          mesh=tuple(new_mesh.shape))
    if state is not None:
        placements = {str(tuple(x.placements)) for x in flatten(state)}
        e2, em2 = make_train_step(model, opt, factory(new_mesh)[0])(
            state, b[1])
        out["elastic2"] = kept(e2, em2)
        out["elastic"]["placements"] = sorted(placements)
    dist.barrier()

    launcher.make_production_mesh = lambda **kw: make_device_mesh(
        MESH, AXES, device="cpu")
    argv = launch_args["argv"] + ["--mesh"]
    out["launch_whole"] = _launch(launcher.main, argv + [
        "--steps", "4", "--ckpt", f"{launch_dir}/a"])
    out["launch_first"] = _launch(launcher.main, argv + [
        "--steps", "2", "--ckpt", f"{launch_dir}/b"])
    out["launch_resumed"] = _launch(launcher.main, argv + [
        "--steps", "4", "--ckpt", f"{launch_dir}/b", "--resume"])
    return out if rank == 0 else {"rank": rank, **out["elastic"]}
