"""Synthetic token data pipeline for LM training/serving (numpy only: the
port's copy of ``repro.data.tokens``, the same batches for the same seed).

Deterministic, shardable, restartable: batches are a pure function of
(seed, step), so a restarted job resumes mid-epoch with no data loss and a
re-meshed (elastic) job keeps per-example determinism — each global example
index always maps to the same tokens.  This is the data-pipeline analogue of
the paper's "lose at most one Process call" recovery contract.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """Stateless token-batch source.

    Produces (tokens, targets) of shape [global_batch, seq_len] from a
    counting-based PRNG keyed by (seed, step, example).  Skew-free sharding:
    callers slice rows by data-parallel rank.
    """
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """Materialize the full global batch for ``step`` (host numpy)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        toks = rng.integers(0, self.vocab_size,
                            (self.global_batch, self.seq_len + 1),
                            dtype=np.int64)
        # Inject local structure so the loss is learnable (bigram-ish): each
        # token weakly depends on the previous one.
        toks[:, 1:] = (toks[:, 1:] // 2 + toks[:, :-1] // 2) % self.vocab_size
        toks = toks.astype(np.int32)
        return toks[:, :-1], toks[:, 1:]

    def shard_at(self, step: int, rank: int, num_ranks: int):
        """Rows owned by data-parallel ``rank`` at ``step``."""
        tokens, targets = self.batch_at(step)
        rows = self.global_batch // num_ranks
        sl = slice(rank * rows, (rank + 1) * rows)
        return tokens[sl], targets[sl]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def synthetic_token_batches(vocab_size: int, seq_len: int, global_batch: int,
                            steps: int, seed: int = 0):
    """Finite iterator of ``steps`` global batches."""
    pipe = TokenPipeline(vocab_size, seq_len, global_batch, seed)
    for s in range(steps):
        yield pipe.batch_at(s)
