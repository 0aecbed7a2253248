"""The frozen FLOP and byte counts against hand-worked small shapes."""

import json
from types import SimpleNamespace as NS

import numpy as np
import pytest

from bench import model as bm
from bench.costs import kernels as K
from bench.costs import model as M
from bench.manifest import Manifest
from bench.tests.tiny import ROOT
from bench.trace import DeviceEvent, Trace


def test_admitted_pairs_and_decode_rows():
    assert K.admitted_pairs(4, 4, True) == 10
    assert K.admitted_pairs(4, 4, False) == 16
    assert K.admitted_pairs(4, 4, True, window=2) == 7
    assert K.decode_rows([3, 5], 0, 4) == 7
    assert K.decode_rows([3, 5], 2, 4) == 1


def test_attention_costs():
    # b 1, 2 q heads on 1 kv head, 4 positions, hd 8, bf16: 20 pairs
    assert K.flash_attention_cost(1, 2, 1, 4, 4, 8, 2) == K.Cost(
        640 + 100, 640, 2 * (2 * 2 * 4 * 8 + 2 * 1 * 4 * 8))
    back = K.flash_attention_backward_cost(1, 2, 1, 4, 4, 8, 2)
    assert back == K.Cost(1600 + 100, 1600,
                          2 * (3 * 64 + 2 * 32) + 4 * 8 + 2 * (64 + 64))
    # 2 slots, 7 admitted rows per kv head in all
    assert K.decode_attention_cost(2, 2, 1, 8, 2, 7) == K.Cost(
        448 + 70, 448, 2 * 7 * 8 * 2 + 2 * 2 * 2 * 8 * 2)
    assert K.moe_gather_cost(10, 8, 2) == K.Cost(0, 0, 360)


def test_least_time_is_the_slower_bound():
    assert K.least_s(K.Cost(989, 0, 1)) == pytest.approx(1e-12)
    assert K.least_s(K.Cost(1, 0, 3350)) == pytest.approx(1e-9)


def _cfg(**over):
    cfg = {"name": "t", "num_layers": 2, "d_model": 8, "num_heads": 2,
           "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 300,
           "prefix": [["full", "dense"]], "unit": [["full", "moe"]],
           "tie_embeddings": True, "param_dtype": "bfloat16",
           "moe": {"num_experts": 4, "top_k": 2, "num_shared": 1,
                   "d_ff_expert": 4, "capacity_factor": 1.25}}
    return {**cfg, **over}


def test_palm_count_by_hand():
    cfg = _cfg()
    attn = 8 * 8 + 8 * 4 * 2 + 8 * 8           # wq, wk + wv, wo
    dense = 3 * 8 * 16
    moe = 8 * 4 + 3 * 4 * 8 * 4 * (2 / 4) + 3 * 8 * 4   # router, experts
    head = 512 * 8                              # padded to 256s, tied
    n = 2 * attn + dense + moe + head
    assert M.product_weights(cfg) == pytest.approx(n)
    per_ctx = 2 * 2 * 4
    assert M.train_flops(cfg, 10, 32) == pytest.approx(
        10 * (6 * n + 12 * per_ctx * 32))
    assert M.forward_flops(cfg, 3, 5) == pytest.approx(
        3 * (2 * n + 4 * per_ctx * 5))


def test_the_cells_configurations_count_their_published_sizes():
    root = M.__file__.rsplit("/bench/", 1)[0]
    sizes = {}
    for name in ("minicpm-2b", "deepseek-moe-16b"):
        cfg = json.load(open(f"{root}/bench/configs/{name}.json"))
        cfg["name"] = name
        sizes[name] = sum(bm.numel(leaf.shape) for g in bm.plan(cfg)
                          for leaf in g)
    assert sizes["minicpm-2b"] == pytest.approx(2.73e9, rel=0.01)
    assert sizes["deepseek-moe-16b"] == pytest.approx(16.38e9, rel=0.01)


def test_the_gather_roofline_counts_every_moe_layer_from_the_spans():
    """One prefill of 40 tokens and one decode step over 3 slots, through
    the configuration's one MoE layer (4 experts, top 2, capacity factor
    1.25), against 1 ms of gather kernels."""
    read = Manifest(ROOT).reader("moe_gather_roofline.serve")

    def span(name, t0, t1, **args):
        return NS(name=name, t0=t0, t1=t1, args=args)

    rec = NS(cfg=_cfg(), profiled=(0.0, 10.0),
             spans=[span("prefill", 1.0, 2.0, rid=0, plen=40),
                    span("decode", 3.0, 4.0), span("prefill", 9.0, 11.0,
                                                   rid=1, plen=8)],
             decodes=[(np.array([5, 7, 9]), [0, 1])],
             trace=Trace([DeviceEvent("gather_rows<bf16>", 0.0, 1e-3)], [],
                         {}, 10.0))
    # capacity 25 -> 28 of 40 tokens, 4 of 1; rows written, tokens read
    rows = 4 * 28, 3 * 4 * 4
    nbytes = (rows[0] + 40 + rows[1] + 3) * 8 * 2 + 4 * sum(rows)
    assert read(rec) == pytest.approx(100 * nbytes / K.PEAK_BYTES_S / 1e-3)
    assert read(NS(**{**vars(rec), "trace": None})) is None
