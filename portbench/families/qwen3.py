"""Qwen3 dense decoders (``model_type`` ``qwen3``) on the port's Llama
family: GQA, per-head RMSNorm on q and k before RoPE (``qk_norm``), SwiGLU,
untied LM head."""

from __future__ import annotations

import torch

from .common import draw_leaves, flatten, nest


def port_config(c):
    from infinistore_tpu_torch.models.llama import LlamaConfig

    if c.get("use_sliding_window") or c.get("rope_scaling"):
        raise ValueError("a windowed or rope-scaled Qwen3 is not this family")
    return LlamaConfig(
        vocab_size=c["vocab_size"], dim=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], ffn_dim=c["intermediate_size"],
        norm_eps=c["rms_norm_eps"], rope_theta=float(c["rope_theta"]),
        attn_bias=bool(c["attention_bias"]), qk_norm=True,
        head_dim_override=c["head_dim"], dtype=torch.bfloat16)


def engine_kwargs():
    return {}


def shapes(c):
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    H, Hk, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    F = c["intermediate_size"]
    bf = torch.bfloat16
    s = {
        "embed": ((V, D), bf, "w", D),
        "lm_head": ((D, V), bf, "w", D),
        "ln_out": ((D,), bf, "norm", 0),
        "layers.wq": ((L, D, H * hd), bf, "w", D),
        "layers.wk": ((L, D, Hk * hd), bf, "w", D),
        "layers.wv": ((L, D, Hk * hd), bf, "w", D),
        "layers.wo": ((L, H * hd, D), bf, "w", H * hd),
        "layers.w_gate": ((L, D, F), bf, "w", D),
        "layers.w_up": ((L, D, F), bf, "w", D),
        "layers.w_down": ((L, F, D), bf, "w", F),
        "layers.ln_attn": ((L, D), bf, "norm", 0),
        "layers.ln_mlp": ((L, D), bf, "norm", 0),
        "layers.q_norm": ((L, hd), bf, "norm", 0),
        "layers.k_norm": ((L, hd), bf, "norm", 0),
    }
    if c["attention_bias"]:
        raise ValueError("attention biases are not drawn")
    return s


def draw(c, seed, device, into=None):
    return nest(draw_leaves(shapes(c), seed, device,
                            None if into is None else flatten(into)))
