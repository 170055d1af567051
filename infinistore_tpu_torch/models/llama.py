"""Llama-3 family in PyTorch (dict-of-tensors params, bf16, GQA, RoPE, SwiGLU).

Counterpart of the reference's ``models/llama.py``: the same config, presets
and parameter layout (``embed``, ``layers`` stacked ``[L, ...]``, ``ln_out``,
``lm_head``; projections stored ``[in, out]`` and applied as ``x @ W``), and
forwards with the same signatures and return layouts.  The forwards run
eagerly (no ``jit``); the layer loop is a Python loop over kernel launches,
and ``decode_forward`` updates the paged cache in place.

Three entry points:
* ``prefill_forward``: full-sequence causal forward; returns logits and
  per-layer KV laid out for paging ([L, 2, B, S, Hkv, D]).
* ``decode_forward``: single-token step against the paged cache
  (kv/cache.py), returning logits and the (updated in place) cache.
* ``verify_forward``: a short run of tokens per sequence against the paged
  cache in one forward (the speculative-decode verify step).

Each forward takes ``tp`` (a ``parallel.TPGroup``) to run on one rank's
Megatron shard of the weights (``parallel/sharding.py``): the local head
counts come from the weights' shapes, an all-reduce follows ``attn @ wo``
and ``... @ w_down`` (before any residual or post-norm, where XLA's GSPMD
puts it for the reference), the vocab-sharded logits are all-gathered
before a final soft-cap, and attention runs the tensor-parallel
compositions on the rank's head shard (``models/attention.py``).  A LoRA
bank sharded as the weights are (``parallel.sharding.shard_lora_tree``)
adds each rank's partial delta before those all-reduces.

With ``pp`` (a ``parallel.PPGroup``; ``params`` and the cache hold the
rank's stage of the layers) a forward runs its stage: stage 0 embeds, each
stage runs its layers and hands the hidden state to the next, the last
applies the final norm and the LM head, and the logits reach every stage
(``PPGroup.broadcast_last_``).  The KV a prefill returns is the stage's
layers'.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kv.cache import write_token_kv, write_tokens_kv
from . import attention as _attention
from .attention import (
    apply_rope,
    causal_attention,
    paged_decode_attention,
    paged_multitoken_attention,
)

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
                device, tp_rank: int = 0, tp: int = 1, pp_rank: int = 0,
                pp: int = 1) -> Params:
    """Random weights drawn normal / sqrt(fan_in) as the reference does
    (``llama.py:126-169``), from ``generator`` (which must live on
    ``device``), straight on ``device``.  Each layer's draw is made in fp32
    and cast into the stacked tensor, so a full-width model never holds a
    whole fp32 copy.  The reference's ``jax.random`` stream is not
    reproduced; tests carry reference weights across with
    ``models/convert.py``.

    ``tp_rank``/``tp`` and ``pp_rank``/``pp``: only the rank's shard is
    kept (``parallel.sharding.shard_tree``: its stage's layers, its
    tensor-parallel slice of each, ``embed`` on stage 0, ``ln_out`` and
    ``lm_head`` on the last stage): every layer is drawn whole, as on one
    rank, and sliced or dropped, so the shard holds exactly the whole
    model's values and the device never holds more than the shard and one
    layer's draw."""
    from ..parallel.sharding import (llama_inference_specs, shard_leaf,
                                     stage_layers)

    hd = cfg.head_dim
    L = cfg.n_layers
    lo, hi = stage_layers(L, pp_rank, pp)
    specs = llama_inference_specs(cfg=cfg)
    dims = {**specs["layers"], "embed": specs["embed"],
            "lm_head": specs["lm_head"]}

    def dense(shape, fan_in, name, keep=True):
        stacked = len(shape) == 3
        dim = dims.get(name)
        if dim is not None and stacked:
            dim -= 1  # the spec counts the stacked layer axis
        row = shape[1:] if stacked else shape
        kept = list(row)
        if dim is not None:
            kept[dim] //= tp
        out = torch.empty(((hi - lo,) if stacked else ()) + tuple(kept)
                          if keep else (0,), dtype=cfg.dtype, device=device)
        for i in range(shape[0] if stacked else 1):
            w = torch.randn(row, generator=generator, dtype=torch.float32,
                            device=device)
            if not keep or (stacked and not lo <= i < hi):
                continue  # drawn to keep the stream, held by another stage
            w = shard_leaf(w, dim, tp_rank, tp)
            (out[i - lo] if stacked else out).copy_(w / math.sqrt(fan_in))
        return out

    def const(shape, fill):
        return torch.full(shape, fill, dtype=cfg.dtype, device=device)

    fill = 0.0 if cfg.norm_offset else 1.0  # Gemma's (1 + w): zeros
    n = hi - lo
    layers = {
        "wq": dense((L, cfg.dim, cfg.n_heads * hd), cfg.dim, "wq"),
        "wk": dense((L, cfg.dim, cfg.n_kv_heads * hd), cfg.dim, "wk"),
        "wv": dense((L, cfg.dim, cfg.n_kv_heads * hd), cfg.dim, "wv"),
        "wo": dense((L, cfg.n_heads * hd, cfg.dim), cfg.n_heads * hd, "wo"),
        "w_gate": dense((L, cfg.dim, cfg.ffn_dim), cfg.dim, "w_gate"),
        "w_up": dense((L, cfg.dim, cfg.ffn_dim), cfg.dim, "w_up"),
        "w_down": dense((L, cfg.ffn_dim, cfg.dim), cfg.ffn_dim, "w_down"),
        "ln_attn": const((n, cfg.dim), fill),
        "ln_mlp": const((n, cfg.dim), fill),
    }
    if cfg.post_norms:
        for name in ("ln_post_attn", "ln_post_mlp"):
            layers[name] = const((n, cfg.dim), fill)
    if cfg.attn_bias:
        # drawn [L, 1, n] as the reference draws them: the head axis is
        # the last either way, so shard it as wq's
        layers["bq"] = dense((L, 1, cfg.n_heads * hd), cfg.dim, "wq")[:, 0]
        layers["bk"] = dense((L, 1, cfg.n_kv_heads * hd), cfg.dim, "wk")[:, 0]
        layers["bv"] = dense((L, 1, cfg.n_kv_heads * hd), cfg.dim, "wv")[:, 0]
    if cfg.qk_norm:
        layers["q_norm"] = const((n, hd), 1.0)
        layers["k_norm"] = const((n, hd), 1.0)
    last = pp_rank == pp - 1
    return {
        "embed": dense((cfg.vocab_size, cfg.dim), cfg.dim, "embed",
                       keep=pp_rank == 0),
        "layers": layers,
        "ln_out": const((cfg.dim if last else 0,), fill),
        "lm_head": dense((cfg.dim, cfg.vocab_size), cfg.dim, "lm_head",
                         keep=last),
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


def _final_logits(params: Params, cfg: LlamaConfig, x: torch.Tensor,
                  tp=None) -> torch.Tensor:
    logits = x @ params["lm_head"]
    if tp is not None:  # lm_head's columns are vocab-sharded
        logits = tp.all_gather(logits, dim=-1)
    if cfg.final_softcap is not None:
        capped = cfg.final_softcap * torch.tanh(
            logits.float() / cfg.final_softcap
        )
        logits = capped.to(logits.dtype)
    return logits


def _lora_term(x: torch.Tensor, lora, name: str, ids, scale: float):
    """Batched adapter delta for one projection (``models/lora.py``), or
    0 without a bank or without that target."""
    if lora is None or name not in lora:
        return 0
    from .lora import lora_delta

    A, B = lora[name]
    return lora_delta(x, A, B, ids, scale)


def _layer_lora(bank_tree, li: int):
    """One layer's slice of a bank's tree, or None without a bank."""
    if bank_tree is None:
        return None
    from .lora import layer_lora

    return layer_lora(bank_tree, li)


def _attn_qkv(layer: Params, cfg: LlamaConfig, x: torch.Tensor,
              positions: torch.Tensor, lora=None, adapter_ids=None,
              lora_scale: float = 1.0):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ layer["wq"], x @ layer["wk"], x @ layer["wv"]
    if lora is not None:
        q = q + _lora_term(x, lora, "wq", adapter_ids, lora_scale)
        k = k + _lora_term(x, lora, "wk", adapter_ids, lora_scale)
        v = v + _lora_term(x, lora, "wv", adapter_ids, lora_scale)
    if cfg.attn_bias:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    # head counts from the weights: a tensor-parallel rank holds H/tp and
    # H_kv/tp of them
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
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


def _mlp(layer: Params, x: torch.Tensor,
         cfg: Optional[LlamaConfig] = None, tp=None) -> torch.Tensor:
    gate = x @ layer["w_gate"]
    if cfg is not None and cfg.act == "gelu_tanh":  # GeGLU (Gemma)
        act = F.gelu(gate, approximate="tanh")
    else:
        act = F.silu(gate)
    out = (act * (x @ layer["w_up"])) @ layer["w_down"]
    # w_down's rows are ffn-sharded: each rank holds a partial sum
    return out if tp is None else tp.all_reduce(out)


def _block_tail(layer: Params, cfg: LlamaConfig, x: torch.Tensor,
                attn: torch.Tensor, lora=None, adapter_ids=None,
                lora_scale: float = 1.0, tp=None) -> torch.Tensor:
    """Output projection (with its adapter term), residuals and MLP of one
    layer; with ``tp``, each projection's partial sums all-reduced before
    the residual."""
    a = attn @ layer["wo"]
    if lora is not None:
        a = a + _lora_term(attn, lora, "wo", adapter_ids, lora_scale)
    if tp is not None:  # wo's rows are head-sharded
        a = tp.all_reduce(a)
    if cfg.post_norms:
        a = _norm(cfg, a, layer["ln_post_attn"])
    x = x + a
    m = _mlp(layer, _norm(cfg, x, layer["ln_mlp"]), cfg, tp)
    if cfg.post_norms:
        m = _norm(cfg, m, layer["ln_post_mlp"])
    return x + m


def _stage_in(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, pp,
              shape) -> torch.Tensor:
    """The hidden state a stage starts from: the embedded ``tokens`` on
    stage 0 (and without ``pp``), the previous stage's output of
    ``shape`` elsewhere."""
    if pp is None or pp.is_first:
        return _embed(params, cfg, tokens)
    return pp.recv_prev(shape, params["layers"]["wq"].dtype, tokens.device)


def _stage_layers(params: Params, pp) -> range:
    """The global indices of the layers ``params`` hold."""
    first = 0 if pp is None else pp.first_layer
    return range(first, first + params["layers"]["wq"].shape[0])


def _stage_out(params: Params, cfg: LlamaConfig, x: torch.Tensor, tp, pp,
               select=None) -> torch.Tensor:
    """The logits after a stage: a stage before the last hands ``x`` to
    the next; the last applies ``select`` (the rows that need logits),
    the final norm and the LM head; with ``pp`` every stage gets the last
    stage's logits."""
    if pp is not None and not pp.is_last:
        pp.send_next(x)
    if select is not None:
        x = select(x)
    if pp is None or pp.is_last:
        logits = _final_logits(params, cfg, _norm(cfg, x, params["ln_out"]),
                               tp)
    else:
        logits = x.new_empty(x.shape[:-1] + (cfg.vocab_size,))
    if pp is not None:
        pp.broadcast_last_(logits)
    return logits


def prefill_forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    prefix_kv: Optional[torch.Tensor] = None,
    prefix_len=None,
    logits_rows: Optional[torch.Tensor] = None,
    lora=None,
    adapter_ids: Optional[torch.Tensor] = None,
    lora_scale: float = 1.0,
    tp=None,
    pp=None,
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

    ``lora`` (a ``models.lora.LoraBank``'s tree), ``adapter_ids`` ([B]
    int32 on the tokens' device) and ``lora_scale``: each row's adapter
    delta on ``wq``/``wk``/``wv``/``wo`` (id 0 is the base model).  The
    same three keywords serve ``decode_forward`` and ``verify_forward``.

    ``tp`` (a ``parallel.TPGroup``; ``params`` the rank's shard): the KV
    and the prefix are the rank's head shard [..., Hkv/tp, D], the logits
    whole on every rank.  ``pp`` (a ``parallel.PPGroup``; ``params`` the
    rank's stage): the KV and the prefix hold the stage's layers.  The
    same keywords serve the other forwards.
    """
    B, S = tokens.shape
    P = 0 if prefix_kv is None else prefix_kv.shape[3]
    start = P if prefix_len is None else prefix_len
    positions = (torch.arange(S, device=tokens.device) + start).expand(B, S)
    x = _stage_in(params, cfg, tokens, pp, (B, S, cfg.dim))
    kvs = []
    for j, li in enumerate(_stage_layers(params, pp)):
        layer = _layer(params, j)
        lkw = dict(lora=_layer_lora(lora, j), adapter_ids=adapter_ids,
                   lora_scale=lora_scale)
        win = _window_for(cfg, li)
        q, k, v = _attn_qkv(layer, cfg, _norm(cfg, x, layer["ln_attn"]),
                            positions, **lkw)
        kvs.append(torch.stack([k, v], dim=0))  # [2, B, S, Hkv, D]
        if prefix_kv is None:
            akw = dict(window=win, softcap=cfg.attn_softcap)
        else:
            k = torch.cat([prefix_kv[j, 0], k], dim=1)
            v = torch.cat([prefix_kv[j, 1], v], dim=1)
            akw = dict(q_offset=P,
                       prefix_pad=P if prefix_len is not None else None,
                       prefix_len=prefix_len, window=win,
                       softcap=cfg.attn_softcap)
        if tp is None:
            attn = causal_attention(q, k, v, **akw)
        else:
            attn = _attention.flash_causal_attention_tp(
                q, k, v, tp.size, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, **akw)
        x = _block_tail(layer, cfg, x, attn.reshape(B, S, -1), tp=tp, **lkw)
    logits = _stage_out(params, cfg, x, tp, pp, None if logits_rows is None
                        else lambda h: h.index_select(1, logits_rows))
    return logits, torch.stack(kvs)


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
    lora=None,
    adapter_ids: Optional[torch.Tensor] = None,
    lora_scale: float = 1.0,
    tp=None,
    pp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token paged decode.

    tokens/positions: [B]; cache: [L, 2, Hkv, n_blocks, T, D] (kv/cache.py
    layout); block_table: [B, max_pages] int32; seq_lens: [B] int32
    (*including* this token); slot_block_ids/slot_ids: [B] where to write
    this token's K/V (pad rows carry ``n_blocks`` and write nothing).
    Returns (logits [B, V], cache).  The cache is updated IN PLACE (the
    reference donates it to the compiled step instead); the returned tensor
    is the argument.  With ``tp``, the cache is the rank's head shard; with
    ``pp``, it holds the stage's layers.
    """
    B = tokens.shape[0]
    x = _stage_in(params, cfg, tokens, pp, (B, cfg.dim))[:, None, :]
    pos = positions[:, None]
    for j, li in enumerate(_stage_layers(params, pp)):
        layer = _layer(params, j)
        lkw = dict(lora=_layer_lora(lora, j), adapter_ids=adapter_ids,
                   lora_scale=lora_scale)
        q, k, v = _attn_qkv(layer, cfg, _norm(cfg, x, layer["ln_attn"]), pos,
                            **lkw)
        cache = write_token_kv(cache, j, slot_block_ids, slot_ids,
                               k[:, 0], v[:, 0])
        akw = dict(window=_window_for(cfg, li), softcap=cfg.attn_softcap)
        if tp is None:
            attn = paged_decode_attention(q[:, 0], cache[j], block_table,
                                          seq_lens, **akw)
        else:
            attn = _attention.paged_decode_attention_tp(
                q[:, 0], cache[j], block_table, seq_lens, tp.size,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, **akw)
        x = _block_tail(layer, cfg, x, attn.reshape(B, -1)[:, None, :],
                        tp=tp, **lkw)
    return _stage_out(params, cfg, x[:, 0], tp, pp), cache


def verify_forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: torch.Tensor,
    block_table: torch.Tensor,
    slot_block_ids: torch.Tensor,
    slot_ids: torch.Tensor,
    lora=None,
    adapter_ids: Optional[torch.Tensor] = None,
    lora_scale: float = 1.0,
    last_only: bool = False,
    tp=None,
    pp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-token paged step: a short run of tokens per sequence against the
    paged cache in ONE forward (the speculative-decode verify step: the
    target scores every draft proposal at once).  The port of the
    reference's ``verify_forward`` (``models/llama.py:407-471``), its LoRA
    terms included.

    tokens/positions/slot_block_ids/slot_ids: [B, S]; cache: [L, 2, Hkv,
    n_blocks, T, D]; block_table: [B, max_pages].  Each layer scatters the
    tokens' K/V into their page slots first (in place; pad rows, slot block
    ``n_blocks``, write nothing), then each token attends to the paged
    history plus the run causally by absolute position
    (``paged_multitoken_attention``, plain PyTorch on every device).
    Returns (logits [B, S, V], cache).

    ``last_only=True`` projects only the final position through the LM head
    and returns logits [B, 1, V]: a resync or refresh that needs only the
    next-token distribution skips S-1 [dim, V] projections.

    ``tp``/``pp``: as ``decode_forward``'s (the attention is head-local,
    so a rank's head shard runs it as it is).
    """
    B, S = tokens.shape
    x = _stage_in(params, cfg, tokens, pp, (B, S, cfg.dim))
    for j, li in enumerate(_stage_layers(params, pp)):
        layer = _layer(params, j)
        lkw = dict(lora=_layer_lora(lora, j), adapter_ids=adapter_ids,
                   lora_scale=lora_scale)
        q, k, v = _attn_qkv(layer, cfg, _norm(cfg, x, layer["ln_attn"]),
                            positions, **lkw)
        cache = write_tokens_kv(cache, j, slot_block_ids, slot_ids, k, v)
        attn = paged_multitoken_attention(
            q, cache[j], block_table, positions,
            window=_window_for(cfg, li), softcap=cfg.attn_softcap,
        )
        x = _block_tail(layer, cfg, x, attn.reshape(B, S, -1), tp=tp, **lkw)
    return _stage_out(params, cfg, x, tp, pp,
                      (lambda h: h[:, -1:]) if last_only else None), cache
