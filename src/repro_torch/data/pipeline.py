"""Deterministic synthetic LM token stream: the training farm's input.

Port of ``repro/data/pipeline.py``.  Tokens are a seeded function of
(stream position, seed), so any worker can regenerate any batch: a restart
after a failure (:mod:`repro_torch.ft.driver`) needs no data movement, and
the stream's state is one integer cursor, checkpointed with the model.
:func:`_chunk` is the reference's, copied (numpy's PCG64 from the same
seed), so :meth:`SyntheticLM.batch_at` gives the reference's tokens bit for
bit.  Without a mesh the batch is made on the host and copied to ``device``
whole.  The reference's sharded branch builds each batch as a global array
shard by shard (``mesh``/``pspec``); here ``mesh`` is a live mesh
(:func:`repro_torch.launch.mesh.live_mesh`) and ``pspec`` a spec of the
emitted arrays (:mod:`repro_torch.launch.sharding`, e.g. ``("data",
None)``, or ``(None, "data", None)`` with microbatches): each rank gets
its own shard of the same ``_chunk`` as a plain local tensor, the block
the reference's shard on the same device holds, and copies only that.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.sharding import shard

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
    (``[batch, seq_len]`` with one microbatch); with ``mesh`` and
    ``pspec``, this rank's shard of them."""

    vocab: int
    seq_len: int
    batch: int                      # rows per emitted batch
    microbatches: int = 1           # leading accumulation dim (S3 flush period)
    seed: int = 0
    device: object = None
    mesh: Optional[object] = None   # a live mesh (LiveMesh)
    pspec: Optional[tuple] = None   # the arrays' spec on it

    def batch_at(self, position: int) -> dict:
        k, b = self.microbatches, self.batch
        toks = _chunk(self.seed, position, k * b, self.seq_len + 1, self.vocab)
        toks = toks.reshape(k, b, self.seq_len + 1)
        tokens, labels = toks[..., :-1], toks[..., 1:]
        if k == 1:
            tokens, labels = tokens[0], labels[0]
        dev = resolve_device(self.device)
        out = {}
        for key, a in (("tokens", tokens), ("labels", labels)):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.mesh is not None and self.pspec is not None:
                # this rank's block: each dimension cut over its entry's axes
                for dim, entry in enumerate(self.pspec):
                    t = shard(t, entry, self.mesh, dim)
            out[key] = t.contiguous().to(dev)
        return out

    def stream(self, state: StreamState) -> Iterator[Tuple[StreamState, dict]]:
        while True:
            b = self.batch_at(state.position)
            state = StreamState(state.position + 1)
            yield state, b
