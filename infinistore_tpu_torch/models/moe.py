"""Mixtral-style sparse-MoE Llama: shared attention, top-k routed experts.

Counterpart of the reference's ``models/moe.py``: the same config, presets
and parameter layout (``layers`` stacked ``[L, ...]``, experts stacked on a
second ``[E]`` axis: ``w_gate``/``w_up`` [L, E, dim, ffn], ``w_down`` [L, E,
ffn, dim], a float32 ``router`` [L, dim, E]), and forwards with the
contracts of the port's Llama forwards (``logits_rows``, a device
``prefix_len``), so the engine pages, compiles and ships an MoE model's KV
exactly as a dense one's.  Attention runs the port's kernels (K3, K2, K1).

The expert FFN is computed DENSELY, as in the reference: every expert runs
on every token and the top-k gate zeros the rest.  Each expert product is
one batched ``torch.matmul`` over the stacked expert weights (no copy of
a weight), plain PyTorch as the reference's einsums are plain XLA.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kv.cache import write_token_kv, write_tokens_kv
from .attention import (
    causal_attention,
    paged_decode_attention,
    paged_multitoken_attention,
)
from .llama import (
    LlamaConfig,
    Params,
    _attn_qkv,
    _layer,
    _mlp,
    next_token_nll,
    rmsnorm,
    sgd_step_fn,
)


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    # DeepSeek-MoE-style SHARED experts: always-on FFN capacity added to the
    # routed output ungated (n shared experts of ffn_dim each, one fused
    # dense FFN of width n * ffn_dim).  0 = Mixtral-style pure routing.
    n_shared_experts: int = 0


MIXTRAL_8X7B = MoEConfig(
    vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, n_experts=8, top_k=2, rope_theta=1e6,
)
TINY_MOE = MoEConfig(
    vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=256, n_experts=4, top_k=2,
)


def scaled_moe(cfg: MoEConfig, **kw) -> MoEConfig:
    return replace(cfg, **kw)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device) -> Params:
    """Random weights drawn normal / sqrt(fan_in) as the reference does
    (``moe.py:56-99``), from ``generator`` (which must live on ``device``),
    one expert at a time in float32 and cast into the stacked tensors.  The
    router stays float32 (top-k ordering is precision-sensitive).  The
    reference's ``jax.random`` stream is not reproduced; tests carry
    reference weights across with ``models/convert.py``."""
    hd, L, E = cfg.head_dim, cfg.n_layers, cfg.n_experts

    def dense(shape, fan_in, dtype=cfg.dtype):
        out = torch.empty(shape, dtype=dtype, device=device)
        flat = out.view(-1, *shape[-2:])
        for i in range(flat.shape[0]):
            w = torch.randn(shape[-2:], generator=generator,
                            dtype=torch.float32, device=device)
            flat[i].copy_(w / math.sqrt(fan_in))
        return out

    layers = {
        "wq": dense((L, cfg.dim, cfg.n_heads * hd), cfg.dim),
        "wk": dense((L, cfg.dim, cfg.n_kv_heads * hd), cfg.dim),
        "wv": dense((L, cfg.dim, cfg.n_kv_heads * hd), cfg.dim),
        "wo": dense((L, cfg.n_heads * hd, cfg.dim), cfg.n_heads * hd),
        "router": dense((L, cfg.dim, E), cfg.dim, torch.float32),
        "w_gate": dense((L, E, cfg.dim, cfg.ffn_dim), cfg.dim),
        "w_up": dense((L, E, cfg.dim, cfg.ffn_dim), cfg.dim),
        "w_down": dense((L, E, cfg.ffn_dim, cfg.dim), cfg.ffn_dim),
        "ln_attn": torch.ones((L, cfg.dim), dtype=cfg.dtype, device=device),
        "ln_mlp": torch.ones((L, cfg.dim), dtype=cfg.dtype, device=device),
    }
    if cfg.n_shared_experts > 0:
        sf = cfg.n_shared_experts * cfg.ffn_dim
        layers["ws_gate"] = dense((L, cfg.dim, sf), cfg.dim)
        layers["ws_up"] = dense((L, cfg.dim, sf), cfg.dim)
        layers["ws_down"] = dense((L, sf, cfg.dim), sf)
    return {
        "embed": dense((cfg.vocab_size, cfg.dim), cfg.dim),
        "layers": layers,
        "ln_out": torch.ones((cfg.dim,), dtype=cfg.dtype, device=device),
        "lm_head": dense((cfg.dim, cfg.vocab_size), cfg.dim),
    }


def top_k_gates(router_logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """[..., E] logits -> [..., E] gate weights: softmax over the top-k
    entries, exact zeros elsewhere (Mixtral gating).  Ties go to the lower
    expert index, as ``jax.lax.top_k`` breaks them (a stable descending
    sort; ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(router_logits, dim=-1, descending=True,
                           stable=True)
    probs = torch.softmax(vals[..., :top_k], dim=-1)
    return torch.zeros_like(router_logits).scatter(-1, idx[..., :top_k],
                                                   probs)


def moe_ffn(layer: Params, x: torch.Tensor, top_k: int) -> torch.Tensor:
    """Dense-compute MoE FFN.  x: [B, S, dim] -> [B, S, dim].

    Every expert on every token: ``[E, B*S, ffn]`` intermediates from one
    batched product per weight (the stacked ``[E, in, out]`` weights are
    read in place), then the gate-weighted sum over experts.  A layer with
    shared-expert weights (``ws_*``) adds their FFN ungated."""
    B, S, D = x.shape
    gates = top_k_gates(x.float() @ layer["router"], top_k)  # [B, S, E] f32
    x2 = x.reshape(1, B * S, D)
    h = F.silu(torch.matmul(x2, layer["w_gate"]))
    h = h * torch.matmul(x2, layer["w_up"])
    out = torch.matmul(h, layer["w_down"])  # [E, B*S, dim]
    routed = torch.einsum("end,ne->nd", out,
                          gates.reshape(B * S, -1).to(x.dtype))
    routed = routed.reshape(B, S, D)
    if "ws_gate" in layer:
        routed = routed + _shared_expert_ffn(layer, x)
    return routed


def _shared_expert_ffn(layer: Params, x: torch.Tensor) -> torch.Tensor:
    """The always-on shared-expert SwiGLU (llama's ``_mlp`` over the
    ``ws_*`` leaves)."""
    return _mlp({"w_gate": layer["ws_gate"], "w_up": layer["ws_up"],
                 "w_down": layer["ws_down"]}, x)


def _norm(cfg: MoEConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, w, cfg.norm_eps)


def moe_prefill_forward(
    params: Params,
    cfg: MoEConfig,
    tokens: torch.Tensor,
    prefix_kv: Optional[torch.Tensor] = None,
    prefix_len=None,
    logits_rows: Optional[torch.Tensor] = None,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (logits [B, S, V], kv [L, 2, B, S, Hkv, D]).

    The contract of ``models.llama.prefill_forward``: a padded ``prefix_kv``
    with a host or device ``prefix_len`` (K2 on the card), ``logits_rows``
    for the LM head, ``use_kernels=False`` for the plain attention on every
    device (the training route).  Every layer takes ``cfg.sliding_window``,
    as the reference's MoE forwards do."""
    B, S = tokens.shape
    P = 0 if prefix_kv is None else prefix_kv.shape[3]
    start = P if prefix_len is None else prefix_len
    positions = (torch.arange(S, device=tokens.device) + start).expand(B, S)
    x = params["embed"][tokens.long()]
    kvs = []
    for li in range(cfg.n_layers):
        layer = _layer(params, li)
        q, k, v = _attn_qkv(layer, cfg, _norm(cfg, x, layer["ln_attn"]),
                            positions)
        kvs.append(torch.stack([k, v], dim=0))
        if prefix_kv is None:
            attn = causal_attention(q, k, v, window=cfg.sliding_window,
                                    use_kernels=use_kernels)
        else:
            k_full = torch.cat([prefix_kv[li, 0], k], dim=1)
            v_full = torch.cat([prefix_kv[li, 1], v], dim=1)
            attn = causal_attention(
                q, k_full, v_full, q_offset=P,
                prefix_pad=P if prefix_len is not None else None,
                prefix_len=prefix_len, window=cfg.sliding_window,
                use_kernels=use_kernels,
            )
        x = x + attn.reshape(B, S, -1) @ layer["wo"]
        x = x + moe_ffn(layer, _norm(cfg, x, layer["ln_mlp"]), cfg.top_k)
    if logits_rows is not None:
        x = x.index_select(1, logits_rows)
    x = _norm(cfg, x, params["ln_out"])
    return x @ params["lm_head"], torch.stack(kvs)


def moe_decode_forward(
    params: Params,
    cfg: MoEConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    slot_block_ids: torch.Tensor,
    slot_ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token paged MoE decode (K1 on the card); the contract of
    ``models.llama.decode_forward``, the cache updated in place."""
    B = tokens.shape[0]
    x = params["embed"][tokens.long()][:, None, :]
    pos = positions[:, None]
    for li in range(cfg.n_layers):
        layer = _layer(params, li)
        q, k, v = _attn_qkv(layer, cfg, _norm(cfg, x, layer["ln_attn"]), pos)
        cache = write_token_kv(cache, li, slot_block_ids, slot_ids,
                               k[:, 0], v[:, 0])
        attn = paged_decode_attention(q[:, 0], cache[li], block_table,
                                      seq_lens, window=cfg.sliding_window)
        x = x + (attn.reshape(B, -1) @ layer["wo"])[:, None, :]
        x = x + moe_ffn(layer, _norm(cfg, x, layer["ln_mlp"]), cfg.top_k)
    x = _norm(cfg, x, params["ln_out"])
    return x[:, 0] @ params["lm_head"], cache


def moe_verify_forward(
    params: Params,
    cfg: MoEConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: torch.Tensor,
    block_table: torch.Tensor,
    slot_block_ids: torch.Tensor,
    slot_ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-token paged MoE step (the speculative verify step for MoE
    engines); the contract of ``models.llama.verify_forward``."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    for li in range(cfg.n_layers):
        layer = _layer(params, li)
        q, k, v = _attn_qkv(layer, cfg, _norm(cfg, x, layer["ln_attn"]),
                            positions)
        cache = write_tokens_kv(cache, li, slot_block_ids, slot_ids, k, v)
        attn = paged_multitoken_attention(q, cache[li], block_table,
                                          positions,
                                          window=cfg.sliding_window)
        x = x + attn.reshape(B, S, -1) @ layer["wo"]
        x = x + moe_ffn(layer, _norm(cfg, x, layer["ln_mlp"]), cfg.top_k)
    x = _norm(cfg, x, params["ln_out"])
    return x @ params["lm_head"], cache


def moe_loss_fn(params: Params, cfg: MoEConfig,
                tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy of the MoE model (the reference's
    ``moe_loss_fn``, ``models/moe.py:255-261``), through the plain
    attention and the dense ``moe_ffn``."""
    logits, _ = moe_prefill_forward(params, cfg, tokens, use_kernels=False)
    return next_token_nll(logits, tokens)


def moe_train_step_fn(cfg: MoEConfig, lr: float = 1e-3):
    """The reference's ``moe_train_step_fn`` (``models/moe.py:264-270``):
    one plain-SGD step on ``moe_loss_fn``, the params updated in place
    (``models.llama.sgd_step_fn``)."""
    return sgd_step_fn(lambda p, t: moe_loss_fn(p, cfg, t), lr)
