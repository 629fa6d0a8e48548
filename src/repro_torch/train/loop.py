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
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dtype_of, padded_vocab
from repro_torch.models.model import Model
from repro_torch.sharding.rules import ShardingRules
from repro_torch.train.optimizer import (
    OptConfig, adamw_init, adamw_update, flatten, master_to_params,
    unflatten,
)

TrainState = dict   # {"params": ..., "opt": {mu, nu, master}, "step": i32}


def init_train_state(model: Model, generator: torch.Generator | None = None,
                     seed: int = 0) -> TrainState:
    params = model.init(generator, seed=seed)
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
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    total = ce + aux_coef * aux["moe_aux"]
    return total, {"ce": ce, "moe_aux": aux["moe_aux"]}


def make_train_step(model: Model, opt_cfg: OptConfig,
                    rules: ShardingRules, *, microbatches: int = 1,
                    aux_coef: float = 0.01):
    dtype = dtype_of(model.cfg)

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in flatten(params)]
        loss, metrics = loss_fn(model, unflatten(params, leaves), batch,
                                rules, aux_coef)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def step(state: TrainState, batch) -> tuple:
        params = state["params"]
        # gradient accumulation: microbatch g is rows [g*b/n, (g+1)*b/n)
        # of every batch leaf, the reference's split; sums, then / n
        n = microbatches
        parts = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                 for k, v in batch.items()}
        loss = metrics = grads = None
        for g in range(n):
            l, m, gr = grads_of(params, {k: v[g] for k, v in parts.items()})
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
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return step


def make_eval_step(model: Model, rules: ShardingRules):
    @torch.no_grad()
    def step(params, batch):
        loss, metrics = loss_fn(model, params, batch, rules)
        return dict(metrics, loss=loss)
    return step


def make_prefill_step(model: Model, rules: ShardingRules):
    """Inference prefill: forward pass producing last-position logits."""
    @torch.no_grad()
    def step(params, batch):
        logits, _ = model.apply(params, batch, rules)
        return logits[:, -1]
    return step
