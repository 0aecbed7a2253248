"""The one generator of traffic: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and makes the inputs from ``--seed``.

Sizes are stratified: every block of ``strata`` consecutive requests holds
the same grid of prompt and output lengths, in an order drawn from the seed,
so two seeds give the same work in another order.  Tokens are uniform over
the vocabulary.  Request ``i`` is a function of ``(seed, i)`` alone.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


def rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *keys])


def grid(lo: int, hi: int, strata: int, j: int) -> int:
    """The middle of stratum ``j`` of ``strata`` over ``[lo, hi]``."""
    return lo + (2 * j + 1) * (hi - lo) // (2 * strata)


class Spec(NamedTuple):
    rid: int
    prompt: np.ndarray        # int32 [prompt_len]
    max_new: int


class Requests:
    """The request stream of a closed-loop mix: ``prompt_len`` and
    ``output_len`` ranges ``[lo, hi]``, ``strata`` per block."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.t, self.seed, self.vocab = traffic, seed, vocab
        self._blocks: Dict[int, tuple] = {}

    def __call__(self, i: int) -> Spec:
        n = self.t["strata"]
        block, j = divmod(i, n)
        if block not in self._blocks:
            r = rng(self.seed, 1, block)
            self._blocks[block] = (r.permutation(n), r.permutation(n))
        pp, po = self._blocks[block]
        plen = grid(*self.t["prompt_len"], n, int(pp[j]))
        new = grid(*self.t["output_len"], n, int(po[j]))
        prompt = rng(self.seed, 2, i).integers(0, self.vocab, plen,
                                               dtype=np.int32)
        return Spec(i, prompt, new)


def train_batch(traffic: dict, seed: int, step: int, vocab: int,
                device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: ``tokens`` and ``labels`` ``[k, mb, S]``,
    the labels the next token, every row new."""
    k, mb, s = (traffic["microbatches"], traffic["rows"],
                traffic["seq_len"])
    gen = torch.Generator(device=device).manual_seed(
        (seed * 7_777_777 + step * 104_729 + 3) % (2 ** 63))
    toks = torch.randint(0, vocab, (k, mb, s + 1), generator=gen,
                         device=device)
    return {"tokens": toks[..., :-1].contiguous(),
            "labels": toks[..., 1:].contiguous()}
