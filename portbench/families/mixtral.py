"""Mixtral sparse-MoE decoders (``model_type`` ``mixtral``) on the port's
MoE family: Llama attention, a float32 router, top-k of the experts (the
port computes every expert on every token and gates the rest to zero)."""

from __future__ import annotations

import torch

from .common import draw_leaves, flatten, nest


def port_config(c):
    from infinistore_tpu_torch.models.moe import MoEConfig

    if c.get("sliding_window"):
        raise ValueError("a windowed Mixtral is not this family")
    return MoEConfig(
        vocab_size=c["vocab_size"], dim=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], ffn_dim=c["intermediate_size"],
        norm_eps=c["rms_norm_eps"], rope_theta=float(c["rope_theta"]),
        n_experts=c["num_local_experts"], top_k=c["num_experts_per_tok"],
        dtype=torch.bfloat16)


def engine_kwargs():
    from infinistore_tpu_torch.models.moe import (moe_decode_forward,
                                                  moe_prefill_forward,
                                                  moe_verify_forward)

    return {"prefill_fn": moe_prefill_forward,
            "decode_fn": moe_decode_forward,
            "verify_fn": moe_verify_forward}


def shapes(c):
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    H, Hk = c["num_attention_heads"], c["num_key_value_heads"]
    hd = D // H
    F, E = c["intermediate_size"], c["num_local_experts"]
    bf = torch.bfloat16
    return {
        "embed": ((V, D), bf, "w", D),
        "lm_head": ((D, V), bf, "w", D),
        "ln_out": ((D,), bf, "norm", 0),
        "layers.wq": ((L, D, H * hd), bf, "w", D),
        "layers.wk": ((L, D, Hk * hd), bf, "w", D),
        "layers.wv": ((L, D, Hk * hd), bf, "w", D),
        "layers.wo": ((L, H * hd, D), bf, "w", H * hd),
        "layers.router": ((L, D, E), torch.float32, "w", D),
        "layers.w_gate": ((L, E, D, F), bf, "w", D),
        "layers.w_up": ((L, E, D, F), bf, "w", D),
        "layers.w_down": ((L, E, F, D), bf, "w", F),
        "layers.ln_attn": ((L, D), bf, "norm", 0),
        "layers.ln_mlp": ((L, D), bf, "norm", 0),
    }


def draw(c, seed, device, into=None):
    return nest(draw_leaves(shapes(c), seed, device,
                            None if into is None else flatten(into)))
