"""Mixture-of-Experts FFN built on the paper's filtered-push machinery
(``repro_torch.core.sparse_collectives``); the port's copy of
``repro.models.moe``.

Mapping (DESIGN.md §3): tokens = messages, experts = vertex partitions,
router = signal, expert FFN = slot, router weights = edge data, capacity =
the need-list bound |L_ij|.  The dense capacity dispatch is the CSR-analogue
(position-addressed).

Supports deepseek-style fine-grained MoE: ``num_shared`` always-on shared
experts + ``dense_first_n`` leading dense layers.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_collectives import (
    dense_combine, dense_dispatch, topk_routing,
)
from repro_torch.models import flags
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init, _act, init_mlp, mlp
from repro_torch.sharding.rules import ShardingRules, local_replica


def moe_capacity(num_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    cap = int(m.capacity_factor * num_tokens * m.top_k / m.num_experts)
    return max(8, -(-cap // 8) * 8)


def init_moe(init: Init, cfg: ModelConfig, dtype) -> dict:
    m = cfg.moe
    d, fe = cfg.d_model, m.d_expert
    std_in, std_out = d ** -0.5, fe ** -0.5
    params = {
        "router": init.normal((d, m.num_experts), torch.float32, std_in,
                              ("d_model", None)),
        "wi_gate": init.normal((m.num_experts, d, fe), dtype, std_in,
                               ("experts", "d_model", "expert_ff")),
        "wi_up": init.normal((m.num_experts, d, fe), dtype, std_in,
                             ("experts", "d_model", "expert_ff")),
        "wo": init.normal((m.num_experts, fe, d), dtype, std_out,
                          ("experts", "expert_ff", "d_model")),
    }
    if m.num_shared:
        params["shared"] = init_mlp(init, d, m.num_shared * fe, dtype)
    return params


def moe_ffn(params, x, cfg: ModelConfig, rules: ShardingRules):
    """x: [B, S, D] -> (out [B, S, D], aux load-balance loss scalar).

    On a mesh the routing, the load-balance loss, the dispatch scatter
    and the combine gather run on plain tensors replicated on every rank
    (:func:`~repro_torch.sharding.rules.local_replica`: DTensor has no
    sharding rule for the scatters): that is an all-gather of the tokens
    and the router over the data axes before the routing, and an
    all-gather of the expert outputs over the expert axis before the
    combine — wire the plan does not ask for, where the reference's XLA
    lowers the scatter and gather into all-to-alls.  The expert FFN runs
    on the capacity buffers as the plan shards them."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    capacity = moe_capacity(t, cfg)
    xf = local_replica(x).reshape(t, d)
    groups = flags.MOE_GROUPS
    # per-group capacity only makes sense when every group has tokens
    # (decode steps route a handful of tokens: use the plain path)
    if groups and ((t * m.top_k) % groups != 0 or t < 8 * groups):
        groups = None

    router_logits = xf.float() @ local_replica(params["router"])
    dispatch, expert_idx, position, weights, group_id = topk_routing(
        router_logits, m.top_k, capacity,
        block=flags.MOE_POSITION_BLOCK, groups=groups)

    # load-balance auxiliary loss (Switch-style)
    probs = torch.softmax(router_logits, dim=-1)              # [T, E]
    assign = torch.zeros((t, m.num_experts), dtype=torch.float32,
                         device=xf.device)
    rows = torch.arange(t, device=xf.device)[:, None].expand_as(expert_idx)
    assign.index_put_((rows, expert_idx), dispatch.float(), accumulate=True)
    aux = rules.shard(m.num_experts * torch.mean(
        torch.mean(probs, dim=0) * torch.mean(assign, dim=0)))

    # DFO push: scatter tokens into per-expert capacity buffers
    buf = dense_dispatch(xf, dispatch, expert_idx, position, m.num_experts,
                         capacity, group_id=group_id,
                         groups=groups or 1)       # [E, (G,) C, D]
    lead = ("experts", "moe_cap") + ((None,) if groups else ())
    buf = rules.shard(buf, *lead, "act_d_model")
    eq = "egcd,edf->egcf" if groups else "ecd,edf->ecf"
    h = _act(torch.einsum(eq, buf, params["wi_gate"]), cfg.act) \
        * torch.einsum(eq, buf, params["wi_up"])
    h = rules.shard(h, *lead, "expert_ff")
    eq_out = "egcf,efd->egcd" if groups else "ecf,efd->ecd"
    out_buf = rules.shard(torch.einsum(eq_out, h, params["wo"]),
                          *lead, "act_d_model")
    # DFO pull/combine: gather expert outputs back to token order
    out = dense_combine(local_replica(out_buf), dispatch, expert_idx,
                        position, weights.to(out_buf.dtype), t,
                        group_id=group_id)
    out = rules.shard(out.reshape(b, s, d), "batch", "seq", "act_d_model")
    if m.num_shared:
        out = out + mlp(params["shared"], x, cfg.act, rules)
    return rules.shard(out, "batch", "seq", "act_d_model"), aux
