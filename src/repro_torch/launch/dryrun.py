"""Multi-pod dry run, the port's twin of ``repro.launch.dryrun``: every
(architecture x input shape) cell on the production mesh runs one step
under ``FakeTensorMode``, with no allocation on any device.

The mesh is a torch ``DeviceMesh`` over a *fake* process group of 256 (or
512) ranks (``torch.testing._internal.distributed.fake_pg``): this process
is rank 0, its collectives move nothing, and DTensor computes rank 0's
local shards as a real rank would.  For each cell this writes a JSON
artifact under --out with, for rank 0 (``launch/costing.py`` says what
each figure counts):

  * memory_analysis (argument / output / temp / alias bytes)
  * cost_analysis  (matmul FLOPs, unfused bytes accessed, transcendentals)
  * flops_by_op    (the matmul FLOPs by operation and local shapes)
  * collectives    (calls and operand bytes by kind, from the
    ``sharding.wire`` counter a real mesh run reads)
  * corrected      (the full-depth totals and each stage body's cost)
  * the sharding plan notes

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--both]

``--device cpu`` traces CPU tensors on a CPU mesh (where DTensor swaps an
all-to-all for an all-gather and a chunk, so its collectives are not the
card's); the default is the card's device type, whose tensors are fake too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (
    SHAPES, all_arch_names, batch_specs, cell_applicability, get_config,
)
from repro_torch.launch.costing import (
    COUNTED, CostMode, corrected_totals, flops_by_op, local_bytes,
    local_storages, local_tensors, stage_body_costs,
)
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import flags
from repro_torch.models.layers import DTYPES
from repro_torch.models.model import make_model
from repro_torch.serve.engine import make_serve_step
from repro_torch.sharding import wire
from repro_torch.sharding.rules import ShardingRules
from repro_torch.sharding.strategy import plan_for
from repro_torch.train.loop import make_prefill_step, make_train_step
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.utils import resolve_device

DEFAULT_OUT = "artifacts/dryrun_torch"
# sharding.wire's names -> the reference's five HLO kinds
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
_WIRE_KIND = {
    "all_gather_tensor": "all-gather", "all_gather_single": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_single": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_TORCH_DTYPES = {"int32": torch.int32, **DTYPES}

# --------------------------------------------------------------------------
# Collectives and memory
# --------------------------------------------------------------------------


def collective_bytes_from_wire(snapshot: dict) -> dict:
    """Calls and operand bytes of every collective a ``sharding.wire``
    snapshot holds, by the reference's kinds (``collective_bytes_from_hlo``'s
    record; the port issues no collective-permute)."""
    out = {k: 0 for k in _KINDS}
    counts = {k: 0 for k in _KINDS}
    for name, n in snapshot["calls"].items():
        kind = _WIRE_KIND[name]
        counts[kind] += n
        out[kind] += snapshot["bytes_by"].get(name, 0)
    return {"by_op": out, "counts": counts,
            "total_operand_bytes": sum(out.values())}


def memory_analysis_dict(arg_bytes: int, out, mode: CostMode,
                         inputs) -> dict:
    """The reference's memory keys for rank 0: ``arg_bytes`` (the step's
    arguments as the reference's shardings place them), the outputs' local
    bytes, the peak of storages the step created and kept live (``mode``),
    and the output bytes that reuse an argument's storage."""
    held = {st._cdata for st in local_storages(inputs)}
    alias, seen = 0, set()
    for loc in local_tensors(out):
        key = loc.untyped_storage()._cdata
        if key in held and key not in seen:
            seen.add(key)
            alias += loc.numel() * loc.element_size()
    return {"argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(local_bytes(out)),
            "temp_size_in_bytes": int(mode.peak),
            "alias_size_in_bytes": int(alias),
            "generated_code_size_in_bytes": 0}


def cost_analysis_dict(mode: CostMode) -> dict:
    """The reference's cost keys for rank 0, from the step's count
    (``launch/costing.py`` says what each counts)."""
    return {"flops": float(mode.flops),
            "bytes_accessed": float(mode.bytes_accessed),
            "transcendentals": float(mode.transcendentals)}


# --------------------------------------------------------------------------
# Cell construction
# --------------------------------------------------------------------------

def _batch(cfg, shape, device) -> dict:
    """The step's global batch: every rank is handed the whole of it, as
    ``launch.train`` and a mesh run hand it (uninitialised; fake under the
    dry run's mode)."""
    return {k: torch.empty(shp, dtype=_TORCH_DTYPES[dt], device=device)
            for k, (shp, dt) in batch_specs(cfg, shape).items()}


def build_cell(arch: str, shape_name, mesh, *, remat: bool = True,
               cfg=None, device=None):
    """Returns ((fn, args, batch_logical, donate, ctx), None), or (None, the
    skip reason).  Call under ``FakeTensorMode``: the state, the batch and
    the caches are built uninitialised on ``device`` and placed by the
    plan.  ``shape_name`` may be a ``ShapeSpec``; ``cfg`` replaces the
    arch's config; ``mesh`` None is one device."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    skip = cell_applicability(cfg, shape)
    if skip:
        return None, skip
    plan = plan_for(cfg, shape.kind, mesh)
    rules = plan.rules
    model = make_model(cfg, remat=remat and shape.kind == "train",
                       device=device)

    batch = _batch(cfg, shape, model.device)
    decode_kind = shape.kind in ("decode", "long_decode")
    batch_logical = {
        # decode steps carry a single token: no seq axis to shard
        "tokens": ("batch", None) if decode_kind else ("batch", "seq"),
        "targets": ("batch", "seq"),
        "pos": ("batch",),
        "positions": (("batch", None, None) if decode_kind
                      else ("batch", "seq", None)),
        "patch_embeds": ("batch", None, None),
        "patch_positions": ("batch", None),
        "frames": ("batch", "seq", None),
    }
    batch_logical = {k: batch_logical[k] for k in batch}
    params = rules.tree_shard(model.empty_params(), model.param_specs())

    ctx = dict(model=model, rules=rules, cfg=cfg, shape=shape,
               batch_struct=batch, params_struct=params, cache_struct=None,
               kind=shape.kind, plan_notes=plan.notes)
    if shape.kind == "train":
        step = make_train_step(model, OptConfig(), rules,
                               microbatches=flags.TRAIN_MICROBATCHES or 1)
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=model.device)}
        return (step, (state, batch), batch_logical, (0,), ctx), None

    if shape.kind == "prefill":
        step = make_prefill_step(model, rules)
        return (step, (params, batch), batch_logical, (), ctx), None

    # decode / long_decode -> serve_step
    frames = cfg.max_source_positions if cfg.is_encdec else 0
    cache = rules.tree_shard(
        model.init_cache(shape.global_batch, shape.seq_len, frames=frames),
        model.cache_logical_specs())
    step = make_serve_step(model, rules)
    ctx["cache_struct"] = cache
    ctx["kind"] = "decode"
    return (step, (params, cache, batch), batch_logical, (1,), ctx), None


def _argument_bytes(args, logical: dict, rules: ShardingRules) -> list:
    """``(storage, rank 0's bytes)`` of each leaf of the step's arguments:
    the state and caches as placed, each batch leaf (the last argument,
    handed over whole) as the reference's shardings place it (``rules``
    cut it by its logical axes)."""
    batch = args[-1]
    leaves = [(t.untyped_storage()._cdata, local_bytes(t))
              for t in local_tensors(args[:-1])]
    for k, v in batch.items():
        n = local_bytes(v)
        if rules.mesh is not None:
            with implicit_replication():
                n = local_bytes(rules.shard(v, *logical[k]))
        leaves.append((v.untyped_storage()._cdata, n))
    return leaves


# --------------------------------------------------------------------------
# The fake process group
# --------------------------------------------------------------------------

@contextlib.contextmanager
def fake_process_group(world: int):
    """This process as rank 0 of a fake default group of ``world`` ranks;
    destroyed on exit.  A fake group of that size already in place is
    used as it is."""
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world):
            yield
            return
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks ({dist.get_backend()}) is in place; the "
                           f"dry run needs a fake one of {world}")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_geometry(multi_pod: bool, mesh_shape=None):
    """(name, shape, axis names) of the cell's mesh: the production mesh,
    or ``mesh_shape`` (``()`` is one device, no mesh)."""
    if mesh_shape is None:
        if multi_pod:
            return "pod2x16x16", (2, 16, 16), ("pod", "data", "model")
        return "pod16x16", (16, 16), ("data", "model")
    if not mesh_shape:
        return "single", (), ()
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    return "mesh" + "x".join(map(str, mesh_shape)), tuple(mesh_shape), axes


def run_cell(arch: str, shape_name, *, multi_pod: bool, out_dir: str,
             remat: bool = True, variant: str = "", cost_twin: bool = False,
             device=None, cfg=None, mesh_shape=None) -> dict:
    """One cell: build it on its mesh, run one step under ``FakeTensorMode``
    on rank 0 of a fake group, write and return the record.  ``cfg``,
    ``mesh_shape`` and a ``ShapeSpec`` for ``shape_name`` run a cell the
    production table does not hold (a reduced config, a small mesh)."""
    mesh_name, shape, axes = mesh_geometry(multi_pod, mesh_shape)
    chips = math.prod(shape)
    dev = resolve_device(device)
    spec = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    record = {
        "arch": arch, "shape": spec.name, "mesh": mesh_name,
        "chips": chips, "variant": variant, "rank": 0, "device": dev.type,
    }
    t0 = time.time()
    group = fake_process_group(chips) if shape else contextlib.nullcontext()
    try:
        with group:
            # the mesh reads its rank map: built before the fake mode
            mesh = make_device_mesh(shape, axes, device=dev) if shape \
                else None
            record.update(_trace(arch, spec, mesh, remat=remat, cfg=cfg,
                                 device=dev, multi_pod=multi_pod,
                                 cost_twin=cost_twin, t0=t0))
    except Exception as e:
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc(limit=20)
    _write(record, out_dir)
    return record


def _trace(arch, spec, mesh, *, remat, cfg, device, multi_pod, cost_twin,
           t0) -> dict:
    """The record's fields from one step of the cell under
    ``FakeTensorMode`` (and its stage bodies with ``cost_twin``)."""
    record = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        built, skip = build_cell(arch, spec, mesh, remat=remat, cfg=cfg,
                                 device=device)
        if skip:
            return {"skipped": skip}
        fn, args, batch_logical, donate, ctx = built
        record["plan_notes"] = list(ctx.get("plan_notes", ()))
        record["donate_argnums"] = list(donate)
        rules, kind = ctx["rules"], ctx["kind"]
        batch = args[-1]
        arg_leaves = _argument_bytes(args, batch_logical, rules)
        t_build = time.time() - t0
        wire.install()
        wire.WIRE.reset()
        mode = CostMode(inputs=args)
        with mode, (torch.no_grad() if kind != "train"
                    else contextlib.nullcontext()):
            out = fn(*args)
        record["build_s"] = round(t_build, 2)
        record["trace_s"] = round(time.time() - t0 - t_build, 2)
        # the arguments the step reads: jax.jit leaves the others out of
        # the program (keep_unused=False), and XLA's count with them
        arg_bytes = sum(n for key, n in arg_leaves if key in mode.read)
        record["memory_analysis"] = memory_analysis_dict(arg_bytes, out,
                                                         mode, args)
        record["cost_analysis"] = cost_analysis_dict(mode)
        record["flops_by_op"] = flops_by_op(mode)
        record["collectives"] = collective_bytes_from_wire(
            wire.WIRE.snapshot())
        record["counted"] = dict(
            COUNTED,
            batch=("argument bytes hold each batch leaf at rank 0's shard "
                   "under the reference's batch shardings; the port's step "
                   "is handed the global batch on every rank "
                   "(global_batch_bytes) and places each microbatch itself"),
            global_batch_bytes=local_bytes(batch),
            arguments=("argument bytes count only the leaves the step "
                       "reads, as jax.jit leaves unread arguments out of "
                       "the program (unread_argument_bytes: the others)"),
            unread_argument_bytes=sum(n for key, n in arg_leaves
                                      if key not in mode.read),
            microbatches=(flags.TRAIN_MICROBATCHES or 1) if kind == "train"
            else 1,
            donation={"train": "the port's train step writes a new state: "
                               "nothing is donated, alias 0",
                      "decode": "decode advances its caches in place",
                      "prefill": "none"}[kind])
        record["ok"] = True
        del out
        # every trip is already counted: the corrected totals are the
        # step's, and the stage bodies are traced only for their table
        body_costs = []
        if cost_twin and not multi_pod:
            t1 = time.time()
            body_costs = stage_body_costs(
                ctx["model"], ctx["params_struct"], rules, mesh, kind=kind,
                batch_struct=ctx["batch_struct"],
                cache_struct=ctx["cache_struct"],
                collective_fn=collective_bytes_from_wire)
            record["bodies_s"] = round(time.time() - t1, 2)
        record["corrected"] = corrected_totals(
            record["cost_analysis"],
            record["collectives"]["total_operand_bytes"], body_costs,
            trips_counted=True)
    return record


def _write(record: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{record['arch']}__{record['shape']}__{record['mesh']}"
            + (f"__{record['variant']}" if record.get("variant") else "")
            + ".json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--variant", default="",
                    help="label for perf-iteration artifacts")
    ap.add_argument("--flag", action="append", default=[],
                    help="perf knob, e.g. --flag MOE_POSITION_BLOCK=2048")
    ap.add_argument("--device", default=None,
                    help="torch device type of the fake tensors (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)

    for kv in args.flag:
        k, v = kv.split("=", 1)
        flags.set_flag(k, v)

    archs = all_arch_names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both else [args.multi_pod]

    n_ok = n_skip = n_fail = 0
    for mp in meshes:
        # one fake group per mesh: --both tears the 256-rank one down and
        # starts a 512-rank one
        with fake_process_group(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   out_dir=args.out,
                                   remat=not args.no_remat,
                                   variant=args.variant, device=args.device)
                    if rec.get("skipped"):
                        n_skip += 1
                        status = f"SKIP ({rec['skipped'][:40]}...)"
                    elif rec.get("ok"):
                        n_ok += 1
                        ca = rec.get("corrected", rec["cost_analysis"])
                        ma = rec["memory_analysis"]
                        coll = ca.get(
                            "collective_bytes",
                            rec["collectives"]["total_operand_bytes"])
                        status = (
                            f"ok trace={rec['trace_s']}s "
                            f"flops={ca.get('flops', -1):.3e} "
                            f"args={ma['argument_size_in_bytes']:.3e}B "
                            f"temp={ma['temp_size_in_bytes']:.3e}B "
                            f"coll={coll:.3e}B")
                    else:
                        n_fail += 1
                        status = f"FAIL {rec['error'][:120]}"
                    print(f"[{rec['mesh']}] {arch:18s} {rec['shape']:12s} "
                          f"{status}", flush=True)
    print(f"\ndone: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
