"""Straggler mitigation for the filtered push exchange — the port of
``repro.runtime.straggler``.

DFOGraph's monoid-slot semantics (DESIGN.md §2) make a powerful mitigation
legal: a *slow peer's messages can be deferred to the next round* without
changing the fixpoint — combine(m, defer(m')) == combine(combine(m, m')) for
associative/commutative slots, and the engine's active-set bookkeeping
re-delivers deferred messages.  This module provides:

  * ``deferred_merge`` — functional helper: merge an arrived-mask subset of
    messages now, return the deferred remainder to stage into round t+1;
  * ``DeferralPolicy`` / ``simulate_round`` — deadline-based planning: which
    peers to wait for given per-peer latencies (used by the launcher; here
    validated by simulation since the container has one host);
  * ``plan_backup_shards`` — backup-worker assignment for re-executing the
    slowest shards (classic straggler re-execution, planning only).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeferralPolicy:
    deadline_factor: float = 2.0    # wait up to factor x median peer latency
    min_peers: float = 0.75         # but never proceed below this fraction


def deferred_merge(recv_msg, recv_mask, arrived_peers):
    """Split a received message block by peer arrival.

    recv_msg/recv_mask: [P, V] (engine phase-2 output);
    arrived_peers: bool [P] (tensors or arrays).
    Returns (now_msg, now_mask, deferred_msg, deferred_mask): the engine
    processes `now` this round; `deferred` is OR-merged into the next
    round's receive buffers (sound for monoid slots)."""
    recv_msg = torch.as_tensor(recv_msg)
    recv_mask = torch.as_tensor(recv_mask, dtype=torch.bool)
    a = torch.as_tensor(arrived_peers, dtype=torch.bool,
                        device=recv_mask.device)[:, None]
    now_mask = recv_mask & a
    deferred_mask = recv_mask & ~a
    zero = torch.zeros((), dtype=recv_msg.dtype, device=recv_msg.device)
    now_msg = torch.where(now_mask, recv_msg, zero)
    deferred_msg = torch.where(deferred_mask, recv_msg, zero)
    return now_msg, now_mask, deferred_msg, deferred_mask


def merge_deferred_entry(monoid_op, mask_now, vals_now, mask_late,
                         vals_late):
    """Combine two receive rows for the same (source partition, dest
    batch): the current round's arrivals with a peer's late (deferred)
    delivery — the host-numpy twin of :func:`deferred_merge`, used by the
    process transport's exchange when a straggler's frames from round t
    are injected into round t+1 (DESIGN.md §13).

    mask_*: bool [v_max]; vals_*: f32 [v_max] (unset rows may hold
    garbage, never read).  Positions present in both merge through
    ``monoid_op`` (np.minimum / np.maximum — associative, commutative,
    idempotent, so late re-delivery cannot change the fixpoint);
    positions present in one pass through untouched.  Returns
    (mask, vals) with vals zeroed outside the mask."""
    both = mask_now & mask_late
    mask = mask_now | mask_late
    vals = np.where(mask_now, vals_now, 0.0).astype(np.float32)
    vals = np.where(mask_late & ~mask_now, vals_late, vals)
    if both.any():
        vals = np.where(both, monoid_op(
            np.asarray(vals_now, np.float32),
            np.asarray(vals_late, np.float32)), vals)
    return mask, vals.astype(np.float32, copy=False)


def simulate_round(latencies: np.ndarray, policy: DeferralPolicy):
    """Given per-peer message latencies for one round, decide the deadline
    and which peers are deferred.  Returns (deadline, arrived_mask,
    makespan_with_deferral, makespan_without)."""
    lat = np.asarray(latencies, np.float64)
    med = np.median(lat)
    deadline = policy.deadline_factor * med
    arrived = lat <= deadline
    if arrived.mean() < policy.min_peers:
        k = int(np.ceil(policy.min_peers * lat.size))
        deadline = np.partition(lat, k - 1)[k - 1]
        arrived = lat <= deadline
    makespan_wait_all = lat.max()
    makespan_deferral = deadline
    return deadline, arrived, makespan_deferral, makespan_wait_all


def plan_backup_shards(shard_times: np.ndarray, num_backups: int):
    """Assign backup workers to the slowest shards (speculative
    re-execution).  Returns indices of shards to replicate."""
    order = np.argsort(np.asarray(shard_times))[::-1]
    return order[:num_backups].copy()


def simulate_training_with_stragglers(step_times: np.ndarray,
                                      policy: DeferralPolicy,
                                      rounds: int = 100,
                                      seed: int = 0):
    """Monte-Carlo the benefit of deferral over synchronous waiting.
    step_times: [P] mean per-peer latencies; heavy-tailed noise added.
    Returns dict(mean_speedup, p99_speedup, deferral_rate)."""
    rng = np.random.default_rng(seed)
    p = step_times.shape[0]
    speedups, deferrals = [], 0
    for _ in range(rounds):
        lat = step_times * rng.lognormal(0.0, 0.5, p)
        # occasional hard straggler
        if rng.random() < 0.3:
            lat[rng.integers(p)] *= 10
        _, arrived, m_def, m_all = simulate_round(lat, policy)
        speedups.append(m_all / max(m_def, 1e-12))
        deferrals += int((~arrived).sum())
    sp = np.asarray(speedups)
    return dict(mean_speedup=float(sp.mean()),
                p99_speedup=float(np.percentile(sp, 99)),
                deferral_rate=deferrals / (rounds * p))
