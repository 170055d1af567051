"""Mixtral sparse-MoE decoder, plain float32 (the published Mixtral block:
pre-norm GQA attention with RoPE, then a router over the experts whose
top-k logits are softmaxed into gates, each token's output the gated sum
of its k experts' SwiGLU).  Only the chosen experts run on a token.  Ties
among router logits go to the lower expert index.  Departure: RoPE pairs
interleaved channels, the layout the port stores (``common.rope``).  The
router stays float32 in the control too, as the configuration keeps it."""

from __future__ import annotations

import torch

from .common import attention_block, rmsnorm, run, swiglu


def moe(layer, h, top_k: int, fp8: bool) -> torch.Tensor:
    logits = h @ layer["router"].float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :top_k], dim=-1)
    idx = idx[:, :top_k]
    out = torch.zeros_like(h)
    for e in range(layer["router"].shape[-1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(h[tok], layer["w_gate"][e], layer["w_up"][e],
                   layer["w_down"][e], fp8)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def logits_at(params, cfg, tokens, rows, fp8: bool = False):
    eps, k = cfg["rms_norm_eps"], cfg["num_experts_per_tok"]

    def layer_fn(layer, x):
        x = attention_block(layer, x, cfg, fp8, qk_norm=False)
        return x + moe(layer, rmsnorm(x, layer["ln_mlp"], eps), k, fp8)

    return run(params, cfg, tokens, rows, fp8, layer_fn)
