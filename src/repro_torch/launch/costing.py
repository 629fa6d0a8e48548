"""Per-rank cost accounting for the dry run, the port's twin of
``repro.launch.costing``.

The reference reads XLA's ``cost_analysis`` of a compiled program.  XLA
counts a ``while`` body once whatever its trip count, so the reference
corrects per stage:

    corrected = F_scanned + sum_s (n_s - 1) * body_cost_s

where body_cost_s comes from compiling stage s's body alone.  The port has
no compiled program.  The dry run (``launch/dryrun.py``) runs one step
under ``FakeTensorMode`` and :class:`CostMode` counts each operation as it
is dispatched on rank 0's local tensors.  The port runs every layer of a
stage in a Python loop, so the deployable step's count already holds every
trip: :func:`corrected_totals` with ``trips_counted=True`` (the dry run's
call) keeps the step's totals and records zero extras.  The stage bodies
(:func:`stage_body_costs`) are traced one by one only when the per-stage
table is asked for (the dry run's ``cost_twin``), and
``tests/test_torch_costing.py`` holds the identity F(full depth) =
F(every stage at n=1) + sum_s (n_s - 1) * body_s exactly.

What is counted, for one rank (:data:`COUNTED`):

* ``flops``: matmul-class operations only (``torch.utils.flop_counter``'s
  formulas: mm, addmm, bmm, baddbmm, convolution, the fused attentions),
  2 per multiply-add, on each operation's local shapes.  DTensor runs an
  operation's local computation through the dispatcher, where the mode
  sees it; the global operation DTensor replays on fake tensors to learn
  its output's shape is not counted.
* ``bytes_accessed``: the local bytes of every input plus every output of
  each operation that touches memory (views, metadata queries such as
  ``prim.device``, collectives and bare allocations excluded).  With no
  fusion this is an upper bound on the bytes a fused program would move.
* ``transcendentals``: elements through exp, log, tanh, sigmoid, rsqrt or
  softplus, also where an operation applies one per element (silu, gelu,
  softmax, log-softmax, logsumexp and the backwards that recompute one).
* memory: the bytes of each storage an operation creates, live until the
  storage is freed; :attr:`CostMode.peak` is the largest sum, above the
  storages that existed when the mode started (the step's arguments).
  :attr:`CostMode.read` holds the arguments' storages some operation
  other than a view or a metadata query (``prim.device``) took as an
  input: the arguments the step reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Model
from repro_torch.sharding import wire
from repro_torch.sharding.rules import ShardingRules
from repro_torch.train.loop import compute_specs
from repro_torch.train.optimizer import flatten

COUNTED = {
    "flops": "matmul-class operations (torch.utils.flop_counter's formulas),"
             " 2 per multiply-add, on rank 0's local shapes",
    "bytes_accessed": "local bytes of every input plus every output of each "
                      "operation (views, metadata queries, collectives and "
                      "bare allocations excluded); unfused, so an upper "
                      "bound",
    "transcendentals": "elements through exp, log, tanh, sigmoid, rsqrt or "
                       "softplus (also inside silu, gelu, softmax, "
                       "log-softmax, logsumexp and their backwards)",
    "memory": "rank 0's local bytes; temp = the peak of storages created "
              "during the step and still live (the step's outputs "
              "included), above the arguments",
}

_aten = torch.ops.aten
_TRANSCENDENTAL = {
    _aten.exp, _aten.exp_, _aten.exp2, _aten.expm1, _aten.log, _aten.log_,
    _aten.log1p, _aten.log2, _aten.tanh, _aten.tanh_, _aten.sigmoid,
    _aten.sigmoid_, _aten.rsqrt, _aten.rsqrt_, _aten.softplus, _aten.silu,
    _aten.silu_, _aten.gelu, _aten._softmax, _aten._log_softmax,
    _aten.logsumexp, _aten.silu_backward, _aten.gelu_backward,
    _aten.softplus_backward,
}
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
_SHADOW = [0]       # depth inside DTensor's output-metadata replay


def _guard_shadow_replay() -> None:
    """Mark DTensor's replay of a global operation on fake tensors (run
    only to learn its output's shape and stride) so the count skips it.
    Idempotent; a process-wide wrap of ``ShardingPropagator``."""
    fn = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(fn, "shadow_guard", False):
        return

    @functools.wraps(fn)
    def run(self, op_schema):
        _SHADOW[0] += 1
        try:
            return fn(self, op_schema)
        finally:
            _SHADOW[0] -= 1
    run.shadow_guard = True
    ShardingPropagator._propagate_tensor_meta_non_cached = run


def _tensors(tree, out=None) -> list:
    """The tensors in a tree of lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def local_tensors(tree) -> list:
    """A tree's tensors as rank 0 holds them: a DTensor's local shard, a
    plain tensor whole."""
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in _tensors(tree)]


def local_bytes(tree) -> int:
    """Rank 0's bytes of a tree's tensors."""
    return sum(map(_nbytes, local_tensors(tree)))


def local_storages(tree) -> list:
    """The storages under a tree's tensors (a DTensor's local shard's)."""
    return [x.untyped_storage() for x in local_tensors(tree)]


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes accessed, transcendentals and live bytes of the
    operations run under it, on the tensors each rank holds (module
    docstring).  ``inputs``: trees whose storages already exist (the
    step's arguments); an output written into one of them is an alias,
    not a new allocation."""

    def __init__(self, inputs=()):
        super().__init__()
        self.flops = 0
        self.matmuls = []       # (operation, local input shapes, FLOPs)
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()
        for st in local_storages(inputs):
            self._storages[st] = 0
        self._inputs = {st._cdata for st in local_storages(inputs)}
        self.read = set()       # the ``_cdata`` of the inputs' storages read

    def __enter__(self):
        _guard_shadow_replay()
        return super().__enter__()

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor dispatches its local ops here
        out = func(*args, **kwargs)
        if _SHADOW[0]:
            return out
        packet = func._overloadpacket
        outs = _tensors(out)
        for t in outs:
            st = t.untyped_storage()
            if st not in self._storages:
                n = st.nbytes()
                self._storages[st] = n
                self.live += n
                weakref.finalize(st, self._release, n)
        self.peak = max(self.peak, self.live)
        ins = _tensors((args, kwargs))
        metadata = func.namespace == "prim"          # ``prim.device``
        if not (func.is_view or metadata):
            self.read.update(k for k in (t.untyped_storage()._cdata
                                         for t in ins) if k in self._inputs)
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            self.matmuls.append((packet.__name__,
                                 [list(t.shape) for t in ins], n))
        if packet in _TRANSCENDENTAL and ins:
            self.transcendentals += ins[0].numel()
        if not (func.is_view or metadata or packet in _ALLOCATIONS
                or func.namespace in _COLLECTIVE_NAMESPACES):
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(
                map(_nbytes, outs))
        return out


def flops_by_op(mode: CostMode) -> list:
    """``mode``'s matmul FLOPs by operation and local input shapes, the
    largest first: where rank 0's FLOPs come from.  An operation on
    operands of the unsharded shapes is work every rank of its mesh axes
    repeats."""
    table = {}
    for name, shapes, n in mode.matmuls:
        row = table.setdefault((name, str(shapes)), dict(
            op=name, shapes=shapes, calls=0, flops=0))
        row["calls"] += 1
        row["flops"] += n
    return sorted(table.values(), key=lambda r: -r["flops"])


def fresh_like(tree, *, stacked: bool):
    """A new uninitialised whole (global-shaped) tree like ``tree`` on the
    same device (fake under the dry run's mode); with ``stacked`` each
    leaf ``[n, ...]`` of a stage comes at one layer, ``[1, ...]``."""
    if isinstance(tree, dict):
        return {k: fresh_like(v, stacked=stacked) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fresh_like(v, stacked=stacked) for v in tree)
    x = tree.to_local() if isinstance(tree, DTensor) else tree
    shape = tuple(tree.shape)
    if stacked:
        shape = (1,) + shape[1:]
    return torch.empty(shape, dtype=x.dtype, device=x.device)


@dataclasses.dataclass
class BodyCost:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    trip: int                 # n_s
    compile_s: float          # the body's trace seconds


def stage_body_costs(model: Model, params_struct, rules: ShardingRules,
                     mesh, *, kind: str, batch_struct, cache_struct=None,
                     collective_fn=None) -> list:
    """Trace each stage body once (``dataclasses.replace(stage, n=1)``, its
    leaves at one layer); returns [BodyCost per stage].  Call under the dry
    run's ``FakeTensorMode``.

    kind: 'train' (forward and backward, with the model's remat: the
    recompute included) | 'prefill' (forward) | 'decode' (the stage of
    ``decode_step``, its cache at one layer; zamba2's shared block
    included).  ``params_struct`` is the placed parameter tree and
    ``batch_struct`` the step's global batch (the body runs the whole
    batch, as the reference's does, so its cost is summed over
    microbatches); ``collective_fn`` maps a ``sharding.wire`` snapshot to
    ``{"total_operand_bytes": ...}``.  ``mesh`` is ``rules.mesh`` (kept for
    the reference's signature)."""
    cfg = model.cfg
    dtype = dtype_of(cfg)
    dev = model.device
    tok = batch_struct["tokens"]
    b = tok.shape[0]
    seq = 1 if kind == "decode" else tok.shape[1]
    on_mesh = rules.mesh is not None
    if kind == "train":
        specs = compute_specs(model)
    else:
        specs = model.param_specs()

    def placed(x, *axes, grad=False):
        x = rules.shard(x, *axes)
        return x.detach().requires_grad_(True) if grad else x

    def placed_tree(tree, spec_tree, grad):
        def one(x, spec):
            if isinstance(x, dict):
                return {k: one(x[k], spec[k]) for k in x}
            if isinstance(x, (list, tuple)):
                return type(x)(one(a, s) for a, s in zip(x, spec))
            return placed(x, *spec, grad=grad)
        return one(tree, spec_tree)

    train = kind == "train"
    stages = [(st, sp, ss, idx) for idx, (st, sp, ss) in enumerate(
        zip(model.stages, params_struct["stages"], specs["stages"]))]
    if cfg.is_encdec and kind in ("train", "prefill"):
        stages += [(st, sp, ss, None) for st, sp, ss in zip(
            model.encoder_stages, params_struct["enc_stages"],
            specs["enc_stages"])]
    shared = params_struct.get("shared_attn")
    out = []
    for stage, sp, sp_spec, idx in stages:
        t0 = time.time()
        stage1 = dataclasses.replace(stage, n=1)
        wire.WIRE.reset()
        with (implicit_replication() if on_mesh
              else contextlib.nullcontext()), \
                (contextlib.nullcontext() if train else torch.no_grad()):
            sp1 = placed_tree(fresh_like(sp, stacked=True), sp_spec, train)
            sh1 = None
            if shared is not None and stage.shared_attn:
                sh1 = placed_tree(fresh_like(shared, stacked=False),
                                  specs["shared_attn"], train)
            enc = stage.encoder
            s_len = batch_struct["frames"].shape[1] if enc else seq
            x = placed(torch.empty((b, s_len, cfg.d_model), dtype=dtype,
                                   device=dev),
                       "batch", "seq", "act_d_model", grad=train)
            if kind == "decode":
                pos = torch.zeros((b,), dtype=torch.int32, device=dev)
                positions = (batch_struct["positions"] if cfg.mrope
                             else pos[:, None])
            elif cfg.mrope and not enc:
                positions = batch_struct["positions"]
            else:
                positions = torch.arange(s_len, device=dev).expand(b, s_len)
            cross = None
            if cfg.is_encdec and kind != "decode" and not enc:
                f = batch_struct["frames"].shape[1]
                cross = placed(torch.empty((b, f, cfg.d_model),
                                           dtype=dtype, device=dev),
                               "batch", "seq", "act_d_model", grad=train)
            if kind == "decode":    # the stage's caches at one layer
                cache = cache_struct[idx]
                cspec = model.cache_logical_specs()[idx]
                blk, sc = cache if stage.shared_attn else (cache, None)
                bspec, sspec = (cspec if stage.shared_attn
                                else (cspec, None))
                blk1 = placed_tree(fresh_like(blk, stacked=True), bspec, False)
                sc1 = None if sc is None else placed_tree(
                    fresh_like(sc, stacked=True), sspec, False)
            with CostMode() as mode:
                if kind == "decode":
                    model._run_stage(stage1, sp1, x, rules,
                                     positions=positions, cache=blk1,
                                     decode_pos=pos, shared=sh1,
                                     shared_cache=sc1)
                else:
                    y, aux = model._run_stage(
                        stage1, sp1, x, rules, positions=positions,
                        cross_kv=cross, causal=not enc, shared=sh1)
                    if train:
                        wrt = [x] + flatten(sp1) + (
                            flatten(sh1) if sh1 is not None else []) + (
                            [cross] if cross is not None else [])
                        outs, cts = [y], [torch.ones_like(y)]
                        if aux.requires_grad:
                            outs.append(aux)
                            cts.append(torch.ones_like(aux))
                        torch.autograd.grad(outs, wrt, cts,
                                            allow_unused=True)
        coll = 0.0
        if collective_fn is not None:
            coll = collective_fn(wire.WIRE.snapshot())["total_operand_bytes"]
        out.append(BodyCost(
            flops=float(mode.flops),
            bytes_accessed=float(mode.bytes_accessed),
            collective_bytes=float(coll), trip=stage.n,
            compile_s=round(time.time() - t0, 2)))
    return out


def corrected_totals(f1: dict, coll1: float, body_costs: list, *,
                     trips_counted: bool = False) -> dict:
    """The reference's corrected = F1 + sum (n_s - 1) * body_s.  With
    ``trips_counted`` (the dry run's step, which runs every layer) F1
    already holds every trip: the totals are F1's and the extras 0."""
    def extra(key):
        if trips_counted:
            return 0.0
        return sum((bc.trip - 1) * getattr(bc, key) for bc in body_costs)
    extra_flops = extra("flops")
    extra_bytes = extra("bytes_accessed")
    extra_coll = extra("collective_bytes")
    return {
        "flops": f1.get("flops", 0) + extra_flops,
        "bytes_accessed": f1.get("bytes_accessed", 0) + extra_bytes,
        "collective_bytes": coll1 + extra_coll,
        "scan_correction": {
            "extra_flops": extra_flops, "extra_bytes": extra_bytes,
            "extra_collective_bytes": extra_coll,
            "per_stage": [dataclasses.asdict(bc) for bc in body_costs],
        },
    }
