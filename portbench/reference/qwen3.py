"""Qwen3 dense decoder, plain float32 (the published Qwen3 block: pre-norm,
GQA with per-head RMSNorm on q and k before RoPE, SwiGLU, final RMSNorm,
untied LM head).  Departure: RoPE pairs interleaved channels, the layout
the port stores (``common.rope``)."""

from __future__ import annotations

from .common import attention_block, rmsnorm, run, swiglu


def logits_at(params, cfg, tokens, rows, fp8: bool = False):
    eps = cfg["rms_norm_eps"]

    def layer_fn(layer, x):
        x = attention_block(layer, x, cfg, fp8, qk_norm=True)
        h = rmsnorm(x, layer["ln_mlp"], eps)
        return x + swiglu(h, layer["w_gate"], layer["w_up"],
                          layer["w_down"], fp8)

    return run(params, cfg, tokens, rows, fp8, layer_fn)
