"""Deterministic synthetic LM token pipeline (the port of
``repro/data/tokens.py``, the same numpy draws: batches are bit for bit
``repro``'s).

Sharded per data-parallel rank, deterministic from (seed, step) so any
step's batch can be regenerated exactly — which makes the iterator state
checkpointable as a single integer and restores bit-identical batches
after failures or elastic re-grouping (the number of data shards may
change between restarts; the *global* batch for a step is invariant
because it is generated globally and sliced per shard). Batches are numpy
int32 arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class TokenPipelineState:
    step: int = 0


class TokenPipeline:
    """Yields (tokens, targets) batches of synthetic text-like data.

    Tokens follow a Zipfian unigram distribution with short-range repeat
    structure so losses are non-trivial (the model can learn something).
    """

    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab_size = int(vocab_size)
        self.global_batch = int(global_batch)
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        self.zipf_a = float(zipf_a)
        self.state = TokenPipelineState()
        # Zipf-ish unigram distribution over the vocab (stable, O(V)).
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** self.zipf_a
        self._probs = (p / p.sum()).astype(np.float64)

    # -- deterministic batch generation --------------------------------

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """The global batch for ``step`` (same result on every rank)."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        toks = rng.choice(self.vocab_size, p=self._probs,
                          size=(self.global_batch, self.seq_len + 1))
        # short-range copy structure: repeat a window with prob 1/4.
        w = self.seq_len // 8
        if w > 1:
            repeat = rng.random(self.global_batch) < 0.25
            src = toks[:, :w]
            toks[repeat, w:2 * w] = src[repeat]
        tokens = toks[:, :-1].astype(np.int32)
        targets = toks[:, 1:].astype(np.int32)
        return tokens, targets

    def shard_at(self, step: int, shard: int, n_shards: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """The per-data-shard slice of step's global batch. Invariant to
        how many shards exist — the basis for elastic re-sharding."""
        if self.global_batch % n_shards != 0:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"{n_shards} shards")
        tokens, targets = self.batch_at(step)
        per = self.global_batch // n_shards
        sl = slice(shard * per, (shard + 1) * per)
        return tokens[sl], targets[sl]

    # -- iterator protocol with checkpointable state --------------------

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        batch = self.batch_at(self.state.step)
        self.state.step += 1
        return batch

    def checkpoint(self) -> dict:
        return {"step": self.state.step, "seed": self.seed,
                "global_batch": self.global_batch, "seq_len": self.seq_len,
                "vocab_size": self.vocab_size}

    @classmethod
    def restore(cls, ckpt: dict) -> "TokenPipeline":
        pipe = cls(vocab_size=ckpt["vocab_size"],
                   global_batch=ckpt["global_batch"],
                   seq_len=ckpt["seq_len"], seed=ckpt["seed"])
        pipe.state.step = ckpt["step"]
        return pipe
