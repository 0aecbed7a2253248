"""Model FLOPs by the PaLM count (arXiv:2204.02311, appendix B).

A token costs ``2 N`` FLOPs forward and ``6 N`` in training, plus the
attention term ``4 L H Q T`` forward (``12 L H Q T`` in training), with
``L`` attention layers, ``H`` q heads of width ``Q`` and ``T`` the
context the token attends (the sequence's length; the count takes the
whole square, as PaLM's does).  ``N`` counts every weight of a product:
the projections, the MLPs, the router, the shared experts, each routed
expert at ``top_k / num_experts`` of its size (each leaf's ``per_token``
in the plan), and the output head, whose table a tied model shares with
the embedding; the embedding's lookup is no product and is left out.  A
mixer kind's module gives its layer's ``H Q``.
"""

from __future__ import annotations

from bench import model as bm


def product_weights(cfg: dict) -> float:
    """``N``: the weights one token passes through in products."""
    n = sum(bm.numel(leaf.shape) * leaf.per_token
            for g in bm.plan(cfg)[1:] for leaf in g)
    return n + bm.padded_vocab(cfg) * cfg["d_model"]


def attention_per_context(cfg: dict) -> float:
    """``L H Q``: the attention term per token and position of context,
    before its factor, summed over the layers by their mixer kinds."""
    return sum(mixer.attention_per_context(cfg)
               for mixer, _ in bm.layer_modules(cfg))


def train_flops(cfg: dict, tokens: int, seq_len: int) -> float:
    return tokens * (6 * product_weights(cfg)
                     + 12 * attention_per_context(cfg) * seq_len)


def forward_flops(cfg: dict, tokens: int, context: float) -> float:
    """``tokens`` forward, each attending ``context`` positions."""
    return forward_counter(cfg)(tokens, context)


def forward_counter(cfg: dict):
    """:func:`forward_flops` of ``cfg`` as a function of ``(tokens,
    context)``, its weights and attention term counted once."""
    n, a = product_weights(cfg), attention_per_context(cfg)
    return lambda tokens, context: tokens * (2 * n + 4 * a * context)
