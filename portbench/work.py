"""The work a run's tokens need, from the traffic's lengths alone.

Operations and bytes are counted from the configuration's widths and the
positions of the tokens: a prompt's uncached tokens, the cached prefix they
attend over, and each delivered token with its position.  Nothing comes
from launch parameters, graph buckets, splits, padding or tokens the
scheduler computes past a request's budget, so the same work reads the
same whatever implements it.  Each byte of an input is counted once per
call that needs it, each output byte once; products are two operations a
multiply-add; bf16 elements are two bytes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

ELEM_BYTES = 2  # bf16 activations and KV

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")


def peaks(card_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card whose name holds a key of
    ``peaks.json``, or None for a card the table lacks."""
    with open(_PEAKS) as f:
        cards = json.load(f)["cards"]
    for key, p in cards.items():
        if key in card_name:
            return p
    return None


def dims(cfg) -> Dict[str, int]:
    H = cfg["num_attention_heads"]
    return {"L": cfg["num_hidden_layers"], "D": cfg["hidden_size"],
            "H": H, "Hk": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or cfg["hidden_size"] // H,
            "V": cfg["vocab_size"], "F": cfg["intermediate_size"],
            "E": cfg.get("num_local_experts", 0),
            "k": cfg.get("num_experts_per_tok", 0)}


def layer_params(cfg) -> int:
    """Weights one token multiplies by in one layer: the four attention
    projections and the FFN it is routed to (every dense FFN, or the
    router and ``k`` experts)."""
    d = dims(cfg)
    attn = d["D"] * d["hd"] * (2 * d["H"] + 2 * d["Hk"])
    if d["E"]:
        return attn + d["D"] * d["E"] + d["k"] * 3 * d["D"] * d["F"]
    return attn + 3 * d["D"] * d["F"]


def head_flops(cfg) -> int:
    """The LM head for one token's logits."""
    d = dims(cfg)
    return 2 * d["D"] * d["V"]


def attn_flops(cfg, a: int, b: int) -> int:
    """Causal attention of the tokens at positions [a, b), each over
    itself and every earlier position: QK and PV, all layers."""
    d = dims(cfg)
    keys = (b * (b + 1) - a * (a + 1)) // 2
    return 4 * d["L"] * d["H"] * d["hd"] * keys


def attn_bytes(cfg, a: int, b: int, start: int) -> int:
    """Bytes for the prompt positions [a, b) of a prefill whose first
    computed position is ``start``: q in and out for [a, b), their K and V
    written, and the K and V of the prefix [0, start) read once (counted on
    the range that begins there), all layers."""
    d = dims(cfg)
    qo = 2 * (b - a) * d["H"] * d["hd"]
    kv = 2 * (b - a) * d["Hk"] * d["hd"]
    prefix = 2 * start * d["Hk"] * d["hd"] if a == start else 0
    return d["L"] * ELEM_BYTES * (qo + kv + prefix)


def prefill_flops(cfg, a: int, b: int) -> int:
    """The model's operations for the prompt positions [a, b) (weights
    and attention; the LM head runs once per prompt, ``head_flops``)."""
    return 2 * layer_params(cfg) * dims(cfg)["L"] * (b - a) + \
        attn_flops(cfg, a, b)


def decode_ctx_bytes(cfg, ctx: int) -> int:
    """K1's bytes for one decoded token attending over ``ctx`` positions
    (itself included): every K and V of the context read once, q in and
    the output out, all layers."""
    d = dims(cfg)
    return d["L"] * ELEM_BYTES * (2 * ctx * d["Hk"] * d["hd"]
                                  + 2 * d["H"] * d["hd"])


def decode_attn_flops(cfg, ctx: int) -> int:
    d = dims(cfg)
    return 4 * d["L"] * d["H"] * d["hd"] * ctx


def decode_flops(cfg, ctx: int) -> int:
    """One decoded token: weights, attention over ``ctx`` and the LM
    head."""
    return 2 * layer_params(cfg) * dims(cfg)["L"] + \
        decode_attn_flops(cfg, ctx) + head_flops(cfg)


def bound_s(flops: float, n_bytes: float, peak: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM bandwidth."""
    return max(flops / peak["bf16_flops_per_s"],
               n_bytes / peak["hbm_bytes_per_s"])
