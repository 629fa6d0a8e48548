"""Train-step factory: loss, grad, AdamW update, remat, grad accumulation.
The port's copy of ``repro.train.loop``.

``make_train_step`` returns
    step(state, batch) -> (state, metrics)
with the reference's contract: ``state`` is {"params", "opt": {mu, nu,
master}, "step"} and the new state is a new tree (the old one is not
written).  Gradients come from ``torch.autograd.grad`` over the param
leaves; with ``microbatches > 1`` the batch's leading axis is split as the
reference's ``split`` does and one microbatch's forward and backward run
at a time, so activation memory divides by the count.  The step counter
and the metrics stay tensors on the model's device: nothing syncs with
the host until the caller reads them.

On a device mesh (``rules.mesh`` set, a ``torch.distributed`` DeviceMesh)
the same functions train the sharded state: :func:`init_train_state`
places params, masters and moments by ``model.param_specs()`` (values
equal to the one-device init with the same seed), every rank passes the
same global batch and the step places each microbatch over the batch
axes, each weight is gathered over the data axes once a microbatch
(:func:`compute_specs`), and the step body runs under DTensor's
``implicit_replication``:
the tensors the models create locally (masks, positions, zero states,
``aux`` scalars, the step counter and learning rate) are the same on
every rank and enter DTensor operations as replicated.  Gradients are
redistributed to their parameters' placements; the metrics come back
as plain tensors, whole on every rank.  :func:`save_checkpoint` and
:func:`restore_checkpoint` keep a mesh state logically unsharded on disk
(the reference's elastic design, ``runtime/elastic.py``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.layers import dtype_of, padded_vocab
from repro_torch.models.model import Model
from repro_torch.sharding.rules import ShardingRules, full
from repro_torch.train.optimizer import (
    OptConfig, adamw_init, adamw_update, flatten, master_to_params,
    unflatten,
)

TrainState = dict   # {"params": ..., "opt": {mu, nu, master}, "step": i32}


def state_specs(model: Model) -> dict:
    """Logical axes of every leaf of a train state: the params', for the
    params and each optimizer tree; the step counter is replicated."""
    ps = model.param_specs()
    return {"params": ps, "opt": {"mu": ps, "nu": ps, "master": ps},
            "step": ()}


def compute_specs(model: Model) -> dict:
    """The parameters' logical axes as a step computes with them: the
    FSDP axis (``d_model``, sharded over the data axes at rest) gathered,
    the tensor-parallel axes kept.  Each weight is all-gathered over the
    data axes once a step, and the layers' contractions over d_model stay
    whole on every rank, as one device computes them; split over the
    data axes (DTensor's other choice), their partial sums round apart
    and Mamba2's decay chains amplify the difference."""
    def gathered(node):
        if isinstance(node, dict):
            return {k: gathered(v) for k, v in node.items()}
        if isinstance(node, list):
            return [gathered(v) for v in node]
        return tuple(None if a == "d_model" else a for a in node)
    return gathered(model.param_specs())


def init_train_state(model: Model, generator: torch.Generator | None = None,
                     seed: int = 0,
                     rules: ShardingRules | None = None) -> TrainState:
    """The state of step 0.  With mesh-backed ``rules`` each rank draws the
    whole parameters (the one-device values) and keeps its shards; the
    optimizer trees are made from the placed params, so they carry the
    same placements."""
    params = model.init(generator, seed=seed)
    if rules is not None and rules.mesh is not None:
        params = rules.tree_shard(params, model.param_specs())
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def checkpoint_template(state: TrainState, model: Model) -> TrainState:
    """A restore template for a state a train step wrote: ``state`` with
    its params in the model dtype, as ``master_to_params`` leaves them.
    ``init_train_state`` keeps a few leaves float32 (Mamba2's ``A_log``,
    ``D`` and ``dt_bias``); restored into the fresh state they would be
    cast back to float32, and the resumed run would compute them at
    another precision than the run that saved them."""
    return dict(state, params=master_to_params(state["opt"],
                                               dtype_of(model.cfg)))


def loss_fn(model: Model, params, batch, rules: ShardingRules,
            aux_coef: float = 0.01):
    cfg = model.cfg
    logits, aux = model.apply(params, batch, rules)       # [B, S, Vpad] f32
    targets = batch["targets"]
    pv = padded_vocab(cfg)
    # mask padded vocab rows out of the softmax
    if pv != cfg.vocab_size:
        pad_mask = torch.arange(pv, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad_mask, -1e30, logits)
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit as a one-hot select and sum over the vocabulary: the
    # reference's take_along_axis exactly (the other entries add zeros),
    # and an operation DTensor shards over a vocab-sharded axis, where a
    # gather has no sharding rule
    hot = torch.arange(pv, device=targets.device) == targets.long()[..., None]
    gold = torch.where(hot, logits, 0.0).sum(dim=-1)
    ce = torch.mean(logz - gold)
    total = ce + aux_coef * aux["moe_aux"]
    return total, {"ce": ce, "moe_aux": aux["moe_aux"]}


def make_train_step(model: Model, opt_cfg: OptConfig,
                    rules: ShardingRules, *, microbatches: int = 1,
                    aux_coef: float = 0.01):
    dtype = dtype_of(model.cfg)
    on_mesh = rules.mesh is not None
    use_specs = compute_specs(model) if on_mesh else None

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in flatten(params)]
        tree = unflatten(params, leaves)
        if on_mesh:
            tree = rules.tree_shard(tree, use_specs)
        loss, metrics = loss_fn(model, tree, batch, rules, aux_coef)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        if on_mesh:   # each gradient as its parameter is placed
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if isinstance(g, DTensor) else g
                     for g, p in zip(grads, leaves)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def place(mb):
        """A microbatch of the global batch, over the batch axes."""
        if not on_mesh:
            return mb
        return {k: rules.shard(v, "batch", *(None,) * (v.ndim - 1))
                for k, v in mb.items()}

    def step(state: TrainState, batch) -> tuple:
        params = state["params"]
        # gradient accumulation: microbatch g is rows [g*b/n, (g+1)*b/n)
        # of every batch leaf, the reference's split; sums, then / n
        n = microbatches
        parts = {k: full(v).reshape(n, v.shape[0] // n, *v.shape[1:])
                 for k, v in batch.items()}
        loss = metrics = grads = None
        with implicit_replication() if on_mesh else contextlib.nullcontext():
            for g in range(n):
                l, m, gr = grads_of(params,
                                    place({k: v[g] for k, v in parts.items()}))
                if grads is None:
                    loss, metrics, grads = l, m, gr
                else:
                    loss = loss + l
                    metrics = {k: metrics[k] + m[k] for k in metrics}
                    grads = [a + b for a, b in zip(grads, gr)]
            if n > 1:
                loss = loss / n
                metrics = {k: v / n for k, v in metrics.items()}
                grads = [g / n for g in grads]

            new_opt, opt_metrics = adamw_update(unflatten(params, grads),
                                                state["opt"], opt_cfg,
                                                state["step"])
            new_params = master_to_params(new_opt, dtype)
            metrics = {k: full(v) for k, v in
                       dict(metrics, loss=loss, **opt_metrics).items()}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return step


def save_checkpoint(mgr, state: TrainState, step: int):
    """``mgr.save(state, step)``; a mesh state (DTensor leaves) is saved
    logically unsharded: every rank gathers each leaf in turn, rank 0 keeps
    the whole leaf on the host and writes the tree, then all ranks meet at
    a barrier.  Returns the save's stats (None on the other ranks)."""
    leaves = flatten(state)
    if not any(isinstance(x, DTensor) for x in leaves):
        return mgr.save(state, step)
    rank = dist.get_rank()
    kept = []
    for x in leaves:
        whole = full(x)
        kept.append(whole.cpu() if rank == 0 else None)
        del whole
    stats = mgr.save(unflatten(state, kept), step) if rank == 0 else None
    dist.barrier()
    return stats


def restore_checkpoint(mgr, template: TrainState, rules: ShardingRules,
                       specs: dict):
    """``mgr.restore_into(template)`` re-placed by ``rules`` and the state's
    logical ``specs`` (:func:`state_specs`): every rank restores the whole
    state (its values, the template's dtypes and global shapes) and keeps
    its shards.  Returns (step, state) or None."""
    got = mgr.restore_into(template)
    if got is None or rules.mesh is None:
        return got
    step, state = got
    return step, rules.tree_shard(state, specs)


def make_eval_step(model: Model, rules: ShardingRules):
    @torch.no_grad()
    def step(params, batch):
        loss, metrics = loss_fn(model, params, batch, rules)
        return dict(metrics, loss=loss)
    return step


def make_prefill_step(model: Model, rules: ShardingRules):
    """Inference prefill: forward pass producing last-position logits.  On
    a device mesh the body runs under ``implicit_replication``, as the
    train step's does."""
    on_mesh = rules.mesh is not None

    @torch.no_grad()
    def step(params, batch):
        with implicit_replication() if on_mesh else contextlib.nullcontext():
            logits, _ = model.apply(params, batch, rules)
            return logits[:, -1]
    return step
