"""The traffic generator: deterministic per seed, the same work for every
seed in another order."""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from bench import workload
from bench.tests.tiny import ROOT

MIXES = sorted(p.stem for p in (ROOT / "bench" / "traffic").glob("*.json"))


def mix(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def _closed_loop(t, seed, n):
    reqs = workload.Requests(t, seed, 1000)
    return [reqs(i) for i in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_each_mix_is_deterministic_per_seed(name):
    t = mix(name)
    seed = 2 ** 31 + 7
    if t["driver"] == "closed_loop":
        a, b = _closed_loop(t, seed, 70), _closed_loop(t, seed, 70)
        c = _closed_loop(t, seed + 1, 70)
        assert all(x.max_new == y.max_new and np.array_equal(x.prompt,
                                                             y.prompt)
                   for x, y in zip(a, b))
        assert any(not np.array_equal(x.prompt, y.prompt)
                   for x, y in zip(a, c))
    else:
        small = dict(t, seq_len=32)
        a = workload.train_batch(small, seed, 3, 1000, "cpu")
        b = workload.train_batch(small, seed, 3, 1000, "cpu")
        c = workload.train_batch(small, seed, 4, 1000, "cpu")
        assert torch.equal(a["tokens"], b["tokens"])
        assert not torch.equal(a["tokens"], c["tokens"])
        assert a["tokens"].shape == (t["microbatches"], t["rows"], 32)
        assert torch.equal(a["tokens"][..., 1:], a["labels"][..., :-1])


def test_every_block_of_requests_holds_the_same_sizes():
    t = mix("serve-longprompt")
    n = t["strata"]

    def sizes(seed, block):
        reqs = _closed_loop(t, seed, n * (block + 1))[n * block:]
        return (Counter(len(r.prompt) for r in reqs),
                Counter(r.max_new for r in reqs))

    first = sizes(5, 0)
    assert sizes(5, 1) == first and sizes(2 ** 31 + 3, 2) == first
    lo, hi = t["prompt_len"]
    assert all(lo <= p <= hi for p in first[0])
    assert len(first[0]) == n and t["s_max"] > hi + t["output_len"][1]
