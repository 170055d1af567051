"""Llama-3 family in PyTorch (dict-of-tensors params, bf16, GQA, RoPE, SwiGLU).

Counterpart of the reference's ``models/llama.py``: the same config, presets
and parameter layout (``embed``, ``layers`` stacked ``[L, ...]``, ``ln_out``,
``lm_head``; projections stored ``[in, out]`` and applied as ``x @ W``), and
forwards with the same signatures and return layouts.  The forwards run
eagerly (no ``jit``); the layer loop is a Python loop over kernel launches,
and ``decode_forward`` updates the paged cache in place.

Two entry points:
* ``prefill_forward``: full-sequence causal forward; returns logits and
  per-layer KV laid out for paging ([L, 2, B, S, Hkv, D]).
* ``decode_forward``: single-token step against the paged cache
  (kv/cache.py), returning logits and the (updated in place) cache.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kv.cache import write_token_kv
from .attention import apply_rope, causal_attention, paged_decode_attention

Params = Dict[str, Any]


@dataclass(frozen=True)
class LlamaConfig:
    """One dense-decoder config covering the Llama/Mistral/Qwen/Gemma-2
    families: ``attn_bias`` (Qwen2 QKV biases), ``qk_norm`` (Qwen3 per-head
    RMSNorm on Q/K before RoPE), ``sliding_window`` (Mistral/Gemma-2
    windowed attention), ``head_dim_override`` and the Gemma-2 knobs."""

    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # (factor, low_freq_factor, high_freq_factor, original_max_position_embeddings)
    rope_scaling: Tuple[float, float, float, int] | None = None
    attn_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None
    # the window applies to layers with ``li % window_pattern == 0``
    window_pattern: int = 1
    head_dim_override: int | None = None
    # --- Gemma-2 family knobs ---
    act: str = "silu"  # "gelu_tanh" (GeGLU) for Gemma
    attn_softcap: float | None = None   # tanh soft-cap on attention logits
    final_softcap: float | None = None  # tanh soft-cap on output logits
    norm_offset: bool = False           # RMSNorm scales by (1 + w)
    post_norms: bool = False            # post-attn/post-ffn norms (sandwich)
    embed_scale: bool = False           # hidden state scaled by sqrt(dim)
    # attention scale becomes 1/sqrt(query_pre_attn_scalar) when set
    query_pre_attn_scalar: float | None = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads


# -- presets (Llama-3 shapes) --
LLAMA3_8B = LlamaConfig()
LLAMA3_70B = LlamaConfig(
    dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, ffn_dim=28672
)
LLAMA3_1B = LlamaConfig(  # Llama-3.2-1B shapes
    dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, ffn_dim=8192
)
TINY = LlamaConfig(
    vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=256
)

# -- sibling dense families (same machinery, different knobs) --
MISTRAL_7B = LlamaConfig(
    vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, rope_theta=10000.0, sliding_window=4096,
)
QWEN25_7B = LlamaConfig(
    vocab_size=152064, dim=3584, n_layers=28, n_heads=28, n_kv_heads=4,
    ffn_dim=18944, rope_theta=1000000.0, norm_eps=1e-6, attn_bias=True,
)
QWEN3_8B = LlamaConfig(
    vocab_size=151936, dim=4096, n_layers=36, n_heads=32, n_kv_heads=8,
    ffn_dim=12288, rope_theta=1000000.0, norm_eps=1e-6, qk_norm=True,
    head_dim_override=128,
)
GEMMA2_9B = LlamaConfig(
    vocab_size=256000, dim=3584, n_layers=42, n_heads=16, n_kv_heads=8,
    ffn_dim=14336, rope_theta=10000.0, norm_eps=1e-6,
    head_dim_override=256, act="gelu_tanh", attn_softcap=50.0,
    final_softcap=30.0, norm_offset=True, post_norms=True, embed_scale=True,
    query_pre_attn_scalar=256.0, sliding_window=4096, window_pattern=2,
)


def scaled(cfg: LlamaConfig, **kw) -> LlamaConfig:
    return replace(cfg, **kw)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights drawn normal / sqrt(fan_in) as the reference does
    (``llama.py:126-169``), from ``generator`` (which must live on
    ``device``), straight on ``device``.  Each layer's draw is made in fp32
    and cast into the stacked tensor, so a full-width model never holds a
    whole fp32 copy.  The reference's ``jax.random`` stream is not
    reproduced; tests carry reference weights across with
    ``models/convert.py``."""
    hd = cfg.head_dim
    L = cfg.n_layers

    def dense(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for i in range(shape[0] if len(shape) == 3 else 1):
            dst = out[i] if len(shape) == 3 else out
            w = torch.randn(dst.shape, generator=generator,
                            dtype=torch.float32, device=device)
            dst.copy_(w / math.sqrt(fan_in))
        return out

    fill = 0.0 if cfg.norm_offset else 1.0  # Gemma's (1 + w): zeros
    layers = {
        "wq": dense((L, cfg.dim, cfg.n_heads * hd), cfg.dim),
        "wk": dense((L, cfg.dim, cfg.n_kv_heads * hd), cfg.dim),
        "wv": dense((L, cfg.dim, cfg.n_kv_heads * hd), cfg.dim),
        "wo": dense((L, cfg.n_heads * hd, cfg.dim), cfg.n_heads * hd),
        "w_gate": dense((L, cfg.dim, cfg.ffn_dim), cfg.dim),
        "w_up": dense((L, cfg.dim, cfg.ffn_dim), cfg.dim),
        "w_down": dense((L, cfg.ffn_dim, cfg.dim), cfg.ffn_dim),
        "ln_attn": torch.full((L, cfg.dim), fill, dtype=cfg.dtype, device=device),
        "ln_mlp": torch.full((L, cfg.dim), fill, dtype=cfg.dtype, device=device),
    }
    if cfg.post_norms:
        for name in ("ln_post_attn", "ln_post_mlp"):
            layers[name] = torch.full((L, cfg.dim), fill, dtype=cfg.dtype,
                                      device=device)
    if cfg.attn_bias:
        layers["bq"] = dense((L, 1, cfg.n_heads * hd), cfg.dim)[:, 0]
        layers["bk"] = dense((L, 1, cfg.n_kv_heads * hd), cfg.dim)[:, 0]
        layers["bv"] = dense((L, 1, cfg.n_kv_heads * hd), cfg.dim)[:, 0]
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((L, hd), dtype=cfg.dtype, device=device)
        layers["k_norm"] = torch.ones((L, hd), dtype=cfg.dtype, device=device)
    return {
        "embed": dense((cfg.vocab_size, cfg.dim), cfg.dim),
        "layers": layers,
        "ln_out": torch.full((cfg.dim,), fill, dtype=cfg.dtype, device=device),
        "lm_head": dense((cfg.dim, cfg.vocab_size), cfg.dim),
    }


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            offset: bool = False) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    if offset:
        # Gemma convention: scale by (1 + w) in f32, then cast
        return ((x32 * scale) * (1.0 + w.float())).to(x.dtype)
    return (x32 * scale).to(x.dtype) * w


def _norm(cfg: LlamaConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, w, cfg.norm_eps, offset=cfg.norm_offset)


def _window_for(cfg: LlamaConfig, li: int) -> Optional[int]:
    """Per-layer sliding window (Gemma-2 alternates local/global layers)."""
    if cfg.sliding_window is None or li % cfg.window_pattern != 0:
        return None
    return cfg.sliding_window


def _layer(params: Params, li: int) -> Params:
    return {k: v[li] for k, v in params["layers"].items()}


def _embed(params: Params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:  # Gemma: hidden scaled by sqrt(dim), in model dtype
        x = x * torch.tensor(math.sqrt(cfg.dim), dtype=x.dtype)
    return x


def _final_logits(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    logits = x @ params["lm_head"]
    if cfg.final_softcap is not None:
        capped = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap
        )
        logits = capped.to(logits.dtype)
    return logits


def _attn_qkv(layer: Params, cfg: LlamaConfig, x: torch.Tensor,
              positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ layer["wq"], x @ layer["wk"], x @ layer["wv"]
    if cfg.attn_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:  # per-head RMSNorm before RoPE (Qwen3)
        q = rmsnorm(q, layer["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, layer["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    if cfg.query_pre_attn_scalar is not None:
        # kernels divide by sqrt(head_dim); pre-scaling q makes the net
        # scale 1/sqrt(query_pre_attn_scalar) (Gemma-2)
        q = q * torch.tensor(
            math.sqrt(hd) / math.sqrt(cfg.query_pre_attn_scalar), dtype=q.dtype
        )
    return q, k, v.contiguous()


def _mlp(layer: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    gate = x @ layer["w_gate"]
    if cfg.act == "gelu_tanh":  # GeGLU (Gemma)
        act = F.gelu(gate, approximate="tanh")
    else:
        act = F.silu(gate)
    return (act * (x @ layer["w_up"])) @ layer["w_down"]


def _block_tail(layer: Params, cfg: LlamaConfig, x: torch.Tensor,
                attn: torch.Tensor) -> torch.Tensor:
    """Output projection, residuals and MLP of one layer."""
    a = attn @ layer["wo"]
    if cfg.post_norms:
        a = _norm(cfg, a, layer["ln_post_attn"])
    x = x + a
    m = _mlp(layer, _norm(cfg, x, layer["ln_mlp"]), cfg)
    if cfg.post_norms:
        m = _norm(cfg, m, layer["ln_post_mlp"])
    return x + m


def prefill_forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    prefix_kv: Optional[torch.Tensor] = None,
    prefix_len=None,
    logits_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, S] -> (logits [B, S, V], kv [L, 2, B, S, Hkv, D]).

    ``prefix_kv`` ([L, 2, B, P, Hkv, D], RoPE already applied) enables
    chunked prefill on top of a reused prefix: ``tokens`` are positions
    P..P+S-1 and attend to the prefix KV plus themselves causally (K3 with
    ``q_offset = P`` on the card).  The returned KV covers only the new
    tokens.

    ``prefix_len`` (a host int, or a 0-d int32 tensor on the tokens' device,
    as the reference's traced int32): when ``prefix_kv`` is a padded buffer,
    only its first ``prefix_len`` rows are valid; the token positions start
    there and the slack is masked out of attention (K2 on the card).  A
    tensor is never read on the host: positions are ``arange(S) +
    prefix_len`` on the device, so one CUDA graph of this forward serves
    every length of a buffer.

    ``logits_rows`` (a 1-d int64 tensor on the tokens' device): logits only
    at those rows of each sequence, [B, len(logits_rows), V]; the KV is
    unchanged.  A prefill needs one row, so the LM head skips the rest.
    """
    B, S = tokens.shape
    P = 0 if prefix_kv is None else prefix_kv.shape[3]
    start = P if prefix_len is None else prefix_len
    positions = (torch.arange(S, device=tokens.device) + start).expand(B, S)
    x = _embed(params, cfg, tokens)
    kvs = []
    for li in range(cfg.n_layers):
        layer = _layer(params, li)
        win = _window_for(cfg, li)
        q, k, v = _attn_qkv(layer, cfg, _norm(cfg, x, layer["ln_attn"]),
                            positions)
        kvs.append(torch.stack([k, v], dim=0))  # [2, B, S, Hkv, D]
        if prefix_kv is None:
            attn = causal_attention(q, k, v, window=win,
                                    softcap=cfg.attn_softcap)
        else:
            k_full = torch.cat([prefix_kv[li, 0], k], dim=1)
            v_full = torch.cat([prefix_kv[li, 1], v], dim=1)
            attn = causal_attention(
                q, k_full, v_full, q_offset=P,
                prefix_pad=P if prefix_len is not None else None,
                prefix_len=prefix_len, window=win, softcap=cfg.attn_softcap,
            )
        x = _block_tail(layer, cfg, x, attn.reshape(B, S, -1))
    if logits_rows is not None:
        x = x.index_select(1, logits_rows)
    x = _norm(cfg, x, params["ln_out"])
    return _final_logits(params, cfg, x), torch.stack(kvs)


def decode_forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    slot_block_ids: torch.Tensor,
    slot_ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token paged decode.

    tokens/positions: [B]; cache: [L, 2, Hkv, n_blocks, T, D] (kv/cache.py
    layout); block_table: [B, max_pages] int32; seq_lens: [B] int32
    (*including* this token); slot_block_ids/slot_ids: [B] where to write
    this token's K/V (pad rows carry ``n_blocks`` and write nothing).
    Returns (logits [B, V], cache).  The cache is updated IN PLACE (the
    reference donates it to the compiled step instead); the returned tensor
    is the argument.
    """
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens)[:, None, :]  # [B, 1, dim]
    pos = positions[:, None]
    for li in range(cfg.n_layers):
        layer = _layer(params, li)
        q, k, v = _attn_qkv(layer, cfg, _norm(cfg, x, layer["ln_attn"]), pos)
        cache = write_token_kv(cache, li, slot_block_ids, slot_ids,
                               k[:, 0], v[:, 0])
        attn = paged_decode_attention(
            q[:, 0], cache[li], block_table, seq_lens,
            window=_window_for(cfg, li), softcap=cfg.attn_softcap,
        )
        x = _block_tail(layer, cfg, x, attn.reshape(B, -1)[:, None, :])
    x = _norm(cfg, x, params["ln_out"])
    return _final_logits(params, cfg, x[:, 0]), cache
