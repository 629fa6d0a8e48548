"""Serving: batched one-token decode steps with KV/state caches + sampling.
The port's copy of ``repro.serve.engine``; the steps run eagerly under
``torch.inference_mode`` on the model's device.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.model import Model
from repro_torch.sharding.rules import ShardingRules, full


def _mask_padded(logits, vocab_size: int):
    """Padded vocabulary ids (>= vocab_size) can never be drawn."""
    pv = logits.shape[-1]
    if pv == vocab_size:
        return logits
    pad = torch.arange(pv, device=logits.device) >= vocab_size
    return torch.where(pad, -1e30, logits)


def greedy_sample(logits, vocab_size: int):
    return torch.argmax(_mask_padded(logits, vocab_size), dim=-1).to(
        torch.int32)


def topk_sample(logits, generator: torch.Generator, vocab_size: int,
                k: int = 40, temperature: float = 1.0):
    """Draw from the ``k`` most likely ids (softmax at ``temperature``).
    The draws come from ``generator`` and differ from the reference's
    ``jax.random.categorical``; the support is the same."""
    logits = _mask_padded(logits, vocab_size)
    vals, idx = torch.topk(logits / max(temperature, 1e-6), k, dim=-1)
    probs = torch.softmax(vals.float(), dim=-1)
    choice = torch.multinomial(probs.reshape(-1, k), 1,
                               generator=generator).reshape(probs.shape[:-1])
    return torch.gather(idx, -1, choice[..., None])[..., 0].to(torch.int32)


def make_serve_step(model: Model, rules: ShardingRules):
    """step(params, cache, batch) -> (next_token [B], cache); batch has
    tokens [B,1], pos [B] (+ positions for mrope archs).  On a device mesh
    the step runs under ``implicit_replication``: the tensors it builds
    locally (positions, masks) enter DTensor operations as replicated."""
    cfg = model.cfg
    on_mesh = rules.mesh is not None

    def step(params, cache, batch):
        with implicit_replication() if on_mesh else contextlib.nullcontext():
            logits, new_cache = model.decode_step(params, cache, batch,
                                                  rules)
            # the vocabulary whole on each rank before the argmax; the
            # tokens whole on every rank, which feeds them back
            logits = rules.shard(logits, "batch", None)
            return full(greedy_sample(logits, cfg.vocab_size)), new_cache

    return step


def make_prefill_and_decode(model: Model, rules: ShardingRules):
    """Returns (prefill, decode) closures for the serving example."""
    cfg = model.cfg

    def prefill(params, batch):
        logits, _ = model.apply(params, batch, rules)
        return greedy_sample(logits[:, -1], cfg.vocab_size)

    return prefill, make_serve_step(model, rules)


class ServeSession:
    """Tiny batched serving loop: prompt tokens fed one by one through the
    cached decode step (cache warm-up), then greedy decode."""

    def __init__(self, model: Model, params, rules: ShardingRules,
                 batch: int, cache_len: int):
        self.model, self.params, self.rules = model, params, rules
        frames = model.cfg.max_source_positions if model.cfg.is_encdec else 0
        # on a device mesh, placed as the plan says: the decode step writes
        # each token into the caches' shards in place
        self.cache = rules.tree_shard(
            model.init_cache(batch, cache_len, frames=frames),
            model.cache_logical_specs())
        self.step_fn = make_serve_step(model, rules)
        self.batch = batch

    def generate(self, prompts: np.ndarray, steps: int) -> np.ndarray:
        """prompts: [B, P] int32.  Feeds prompt tokens one by one (cache
        warm-up), then samples ``steps`` tokens greedily.  Runs under
        ``torch.inference_mode`` on one device and ``torch.no_grad`` on a
        mesh (a DTensor's views of an inference tensor fail)."""
        with torch.inference_mode(self.rules.mesh is None), torch.no_grad():
            return self._generate(prompts, steps)

    def _generate(self, prompts: np.ndarray, steps: int) -> np.ndarray:
        b, p = prompts.shape
        dev = self.model.device
        prompts_t = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
        out = []
        tok = prompts_t[:, :1]
        for i in range(p + steps - 1):
            batch = {"tokens": tok,
                     "pos": torch.full((b,), i, dtype=torch.int32,
                                       device=dev)}
            if self.model.cfg.mrope:
                batch["positions"] = torch.full((b, 1, 3), i,
                                                dtype=torch.int32, device=dev)
            nxt, self.cache = self.step_fn(self.params, self.cache, batch)
            if i + 1 < p:
                tok = prompts_t[:, i + 1:i + 2]
            else:
                tok = nxt[:, None]
                out.append(nxt)
        return torch.stack(out, dim=1).cpu().numpy()
