"""AdamW with fp32 master weights, the port's copy of
``repro.train.optimizer``: plain functions on parameter trees (nested
dicts and lists of tensors), the reference's math step for step.

Optimizer state mirrors the param tree: {mu, nu, master}, all float32.
Params themselves stay in the model's compute dtype (bf16).  Leaves are
visited in the reference's order (dict keys sorted), so the global norm
sums in the same order.  ``torch.optim.AdamW`` computes another function
(its decay rule, no masters), so it does not stand in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def flatten(tree: Any) -> list:
    """Leaves in the reference's order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken from ``leaves`` in
    :func:`flatten`'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(template)


def tree_map(fn, tree: Any) -> Any:
    return unflatten(tree, [fn(x) for x in flatten(tree)])


def lr_at(cfg: OptConfig, step):
    """Linear warmup + cosine decay (warmup starts at lr/warmup_steps, not
    zero, so step 0 makes progress).  ``step``: an integer tensor."""
    step = step.to(F32)
    warm = (step + 1.0) / max(cfg.warmup_steps, 1)
    prog = torch.clip((step - cfg.warmup_steps)
                      / max(cfg.total_steps - cfg.warmup_steps, 1),
                      0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any) -> dict:
    return {
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
        "master": tree_map(lambda p: p.to(F32, copy=True), params),
    }


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in flatten(tree):
        total = total + torch.sum(torch.square(leaf.to(F32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Any, opt_state: dict, cfg: OptConfig, step):
    """Returns (new_opt_state, metrics {grad_norm, lr}).  ``step`` is the
    0-based step, an integer tensor on the state's device."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    t = (step + 1).to(F32)
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    def upd(g, mu, nu, master):
        g = g.to(F32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        step_dir = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        decay = cfg.weight_decay if master.ndim >= 2 else 0.0  # no wd on norms
        master = master - lr * (step_dir + decay * master)
        return mu, nu, master

    out = [upd(g, m, n, ma) for g, m, n, ma in zip(
        flatten(grads), flatten(opt_state["mu"]), flatten(opt_state["nu"]),
        flatten(opt_state["master"]))]
    new_opt = {name: unflatten(opt_state[name], [o[i] for o in out])
               for i, name in enumerate(("mu", "nu", "master"))}
    return new_opt, dict(grad_norm=gnorm, lr=lr)


def master_to_params(opt_state: dict, dtype) -> Any:
    return tree_map(lambda m: m.to(dtype), opt_state["master"])
