"""Per-(arch, shape, mesh) parallelism planning, the port's copy of
``repro.sharding.strategy``.

Chooses the logical->mesh table: TP over 'model' for heads/FFN/vocab where
divisible, EP for MoE experts (falling back to TP-within-expert when the
expert count doesn't divide the axis — mixtral's 8 experts on a 16-wide
axis), FSDP over 'data' (and 'pod'), and context/sequence-parallel layout
for the batch=1 long-context decode shape.  Axis sizes are read by name
from a torch ``DeviceMesh`` (:func:`~repro_torch.sharding.rules.axis_sizes`);
the decisions and their notes are the reference's, letter for letter.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models import flags
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import ShardingRules, axis_sizes, make_rules


@dataclasses.dataclass(frozen=True)
class Plan:
    rules: ShardingRules
    notes: tuple    # human-readable decisions for DESIGN/EXPERIMENTS


def plan_for(cfg: ModelConfig, shape_kind: str, mesh: Optional[object]) -> Plan:
    """shape_kind: 'train' | 'prefill' | 'decode' | 'long_decode'."""
    if mesh is None:
        return Plan(make_rules(None), ("unsharded (no mesh)",))
    notes = []
    tp = axis_sizes(mesh).get("model", 1)
    axis_names = tuple(mesh.mesh_dim_names)
    overrides = {}

    # --- attention head sharding (grouped wq/wo layout, see layers.py) ---
    kv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    if kv % tp == 0:
        pass                               # kv_heads -> 'model' (default)
    elif g % tp == 0:
        # kv heads replicated, q/o sharded over the GQA group axis
        overrides["kv_heads"] = None
        overrides["q_group"] = "model"
        notes.append(
            f"kv={kv} not divisible by tp={tp}: q/o sharded over the GQA "
            f"group axis (g={g}), k/v replicated")
    elif cfg.num_heads % tp == 0:
        # flat-head fallback: K/V repeated to full heads at the activation
        # level, flat head axis sharded (layers.attention 'flat' mode);
        # params FSDP-only but compute/score buffers shard 1/tp
        overrides["kv_heads"] = None
        notes.append(
            f"kv={kv}, group={g} indivisible by tp={tp} but H="
            f"{cfg.num_heads} divides: flat-head attention w/ repeated KV")
    else:
        overrides["kv_heads"] = None
        overrides["heads"] = None
        notes.append(
            f"kv={kv}, group={g}, H={cfg.num_heads} all indivisible by "
            f"tp={tp}: attention params FSDP-only (replicated over "
            f"'model'), FFN/vocab still TP")
    # --- MoE expert sharding ---
    if cfg.moe is not None:
        if flags.MOE_GROUPS:
            # per-source-group capacity: dispatch buffers [E, G, Cg, D]
            # shard the group axis over the data axes (shard-local scatter)
            overrides["moe_cap"] = tuple(
                a for a in ("pod", "data") if a in axis_names)
            if len(overrides["moe_cap"]) == 1:
                overrides["moe_cap"] = overrides["moe_cap"][0]
            notes.append(f"MoE per-group capacity (G={flags.MOE_GROUPS}) "
                         f"sharded over data axes")
        if cfg.moe.num_experts % tp == 0:
            overrides["experts"] = "model"
            overrides["expert_ff"] = None
            overrides["d_ff"] = None  # dense-layer ffn in moe archs: replicate
            notes.append(f"EP: {cfg.moe.num_experts} experts over tp={tp}")
        else:
            overrides["experts"] = None
            overrides["expert_ff"] = "model"
            notes.append(
                f"{cfg.moe.num_experts} experts not divisible by tp={tp}: "
                f"TP-within-expert (expert_ff over 'model')")
        if cfg.moe.d_ff_dense and cfg.moe.d_ff_dense % tp == 0:
            overrides["d_ff"] = "model"
    # --- ssm state sharding ---
    if cfg.ssm is not None:
        inner = cfg.ssm.expand * cfg.d_model
        if (inner // cfg.ssm.head_dim) % tp == 0:
            overrides["state_heads"] = "model"
            notes.append(f"SSM heads over tp={tp}")
        else:
            overrides["state_heads"] = None
    if cfg.rwkv is not None:
        if (cfg.d_model // cfg.rwkv.head_dim) % tp == 0:
            overrides["state_heads"] = "model"
        else:
            overrides["state_heads"] = None

    # --- shape-dependent activation layout ---
    base = make_rules(mesh)   # to read dp composition
    dp_axes = base.table["batch"]
    if shape_kind == "long_decode":
        # batch=1: shard the sequence/cache dimension over the data axes
        # (context parallelism); batch replicated.
        overrides["batch"] = None
        overrides["seq"] = dp_axes
        overrides["cache_seq"] = dp_axes
        notes.append("long_500k: context-parallel (seq/cache over data axes)")
    elif shape_kind in ("decode", "prefill", "train"):
        overrides["batch"] = dp_axes
        if shape_kind == "prefill":
            # sequence-parallel activations between blocks (SP) pairs with TP
            overrides["seq"] = None
    rules = make_rules(mesh, **overrides)
    return Plan(rules, tuple(notes))
