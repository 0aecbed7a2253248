"""Deterministic synthetic LM token stream: the training farm's input.

Port of ``repro/data/pipeline.py``.  Tokens are a seeded function of
(stream position, seed), so any worker can regenerate any batch: a restart
after a failure (:mod:`repro_torch.ft.driver`) needs no data movement, and
the stream's state is one integer cursor, checkpointed with the model.
:func:`_chunk` is the reference's, copied (numpy's PCG64 from the same
seed), so :meth:`SyntheticLM.batch_at` gives the reference's tokens bit for
bit.  The reference's sharded branch (``mesh``/``pspec``: global arrays
built shard by shard) is not ported: the port trains on one card, and the
batch is made on the host and copied to ``device`` whole.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["StreamState", "SyntheticLM"]


@dataclasses.dataclass
class StreamState:
    """Checkpointable cursor into the infinite synthetic stream."""

    position: int = 0  # number of batches consumed

    def to_dict(self):
        return {"position": self.position}

    @classmethod
    def from_dict(cls, d):
        return cls(position=int(d["position"]))


def _chunk(seed: int, position: int, rows: int, seq: int,
           vocab: int) -> np.ndarray:
    """Tokens for one batch position: pure function of (seed, position)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + position))
    # structured synthetic text: random walk over vocab with bursts, so the
    # LM objective has learnable local correlations (loss decreases)
    base = rng.integers(0, vocab, size=(rows, 1), dtype=np.int64)
    steps = rng.integers(-32, 33, size=(rows, seq), dtype=np.int64)
    toks = np.abs(base + np.cumsum(steps, axis=1)) % vocab
    return toks.astype(np.int32)


@dataclasses.dataclass
class SyntheticLM:
    """Infinite deterministic (tokens, labels) stream of int32 tensors on
    ``device`` (None: the CUDA card), ``[microbatches, batch, seq_len]``
    (``[batch, seq_len]`` with one microbatch)."""

    vocab: int
    seq_len: int
    batch: int                      # rows per emitted batch
    microbatches: int = 1           # leading accumulation dim (S3 flush period)
    seed: int = 0
    device: object = None

    def batch_at(self, position: int) -> dict:
        k, b = self.microbatches, self.batch
        toks = _chunk(self.seed, position, k * b, self.seq_len + 1, self.vocab)
        toks = toks.reshape(k, b, self.seq_len + 1)
        tokens, labels = toks[..., :-1], toks[..., 1:]
        if k == 1:
            tokens, labels = tokens[0], labels[0]
        dev = resolve_device(self.device)
        return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)).to(dev),
                "labels": torch.from_numpy(np.ascontiguousarray(labels)).to(dev)}

    def stream(self, state: StreamState) -> Iterator[Tuple[StreamState, dict]]:
        while True:
            b = self.batch_at(state.position)
            state = StreamState(state.position + 1)
            yield state, b
