"""HuggingFace checkpoint import: Llama, Mistral, Qwen2/2.5, Qwen3, Gemma-2
and Mixtral.

Counterpart of the reference's ``models/hf.py``.  ``params_from_hf`` maps a
``transformers`` dense-decoder state dict (LlamaForCausalLM,
MistralForCausalLM, Qwen2ForCausalLM, Qwen3ForCausalLM, Gemma2ForCausalLM)
onto the port's layout (``models/llama.py``: stacked per-layer leaves,
``x @ W``), and ``moe_params_from_hf`` a MixtralForCausalLM's onto
``models/moe.py``'s, converting two representation differences:

* weight orientation: HF stores ``[out, in]``; the port computes ``x @ W``,
  so every projection is transposed;
* RoPE convention: HF rotates half-split features, ``apply_rope`` rotates
  interleaved pairs.  The two agree under a fixed permutation of each
  head's feature rows, baked into Wq/Wk (and their biases and Q/K norms)
  once at import.

Inputs are a ``transformers`` model or a state dict of torch tensors.  The
tensors stay torch tensors on their own device: each stacked leaf is
allocated once in the model's dtype and every layer's tensor is copied
(transposed, cast) into it, so a checkpoint already on the card imports
there with no host copy.  Nothing here imports ``transformers``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, MutableMapping, Optional

import torch

from .llama import LlamaConfig, Params

# model_type -> (attn_bias default, qk_norm).  Qwen2/2.5 always bias QKV
# (their HF config carries no attention_bias field); Qwen3 replaces the
# biases with per-head Q/K RMSNorm.
_FAMILIES = {
    "llama": (False, False),
    "mistral": (False, False),
    "qwen2": (True, False),
    "qwen3": (False, True),
    "gemma2": (False, False),
}


def config_from_hf(hf_config: Any,
                   dtype: torch.dtype = torch.bfloat16) -> LlamaConfig:
    """Map a ``transformers`` dense-decoder config (Llama / Mistral / Qwen2 /
    Qwen3 / Gemma-2), or any object with its attributes, onto the port's.

    Raises on configurations this architecture cannot represent (an unknown
    ``model_type`` or ``rope_scaling`` type, a per-layer sliding window)
    rather than importing weights that would silently give wrong logits."""
    family = getattr(hf_config, "model_type", "llama")
    if family not in _FAMILIES:
        raise ValueError(f"unsupported model_type {family!r}")
    bias_default, qk_norm = _FAMILIES[family]
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    explicit_hd = getattr(hf_config, "head_dim", None)
    rs = getattr(hf_config, "rope_scaling", None)
    scaling = None
    if rs:
        rtype = rs.get("rope_type", rs.get("type", "default"))
        if rtype == "llama3":
            scaling = (
                float(rs["factor"]),
                float(rs["low_freq_factor"]),
                float(rs["high_freq_factor"]),
                int(rs["original_max_position_embeddings"]),
            )
        elif rtype != "default":
            raise ValueError(f"unsupported rope_scaling type {rtype!r}")
    extra: Dict[str, Any] = {}
    if family == "gemma2":
        # GeGLU, logit softcaps, sandwich norms, (1+w) norms, sqrt(dim)
        # embed scaling, alternating local/global attention, query scale
        extra = dict(
            act="gelu_tanh",
            attn_softcap=getattr(hf_config, "attn_logit_softcapping", None),
            final_softcap=getattr(hf_config, "final_logit_softcapping", None),
            norm_offset=True,
            post_norms=True,
            embed_scale=True,
            query_pre_attn_scalar=float(
                getattr(hf_config, "query_pre_attn_scalar", derived_hd)
            ),
            window_pattern=2,  # HF: even layers sliding, odd global
        )
    window = getattr(hf_config, "sliding_window", None)
    if window is not None and not getattr(hf_config, "use_sliding_window", True):
        window = None  # Qwen2/3 ship the field but default it off
    if window is not None and family != "gemma2":
        # HF windows the layers >= max_window_layers: mwl >= n_layers means
        # no layer, mwl == 0 every layer; anything between mixes per layer,
        # which this architecture does not represent
        mwl = getattr(hf_config, "max_window_layers", None)
        if mwl is not None:
            if mwl >= hf_config.num_hidden_layers:
                window = None
            elif mwl > 0:
                raise ValueError(
                    f"unsupported per-layer sliding window "
                    f"(0 < max_window_layers={mwl} < num_hidden_layers="
                    f"{hf_config.num_hidden_layers})"
                )
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(
            hf_config, "num_key_value_heads", hf_config.num_attention_heads
        ),
        ffn_dim=hf_config.intermediate_size,
        norm_eps=hf_config.rms_norm_eps,
        # configs old enough to lack the field predate the Llama-3 theta
        # bump; transformers defaulted them to 10000
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rope_scaling=scaling,
        attn_bias=getattr(hf_config, "attention_bias", bias_default),
        qk_norm=qk_norm,
        sliding_window=window,
        head_dim_override=(
            explicit_hd
            if explicit_hd is not None and explicit_hd != derived_hd
            else None
        ),
        dtype=dtype,
        **extra,
    )


def _rope_perm(head_dim: int) -> torch.Tensor:
    """Row permutation taking HF's half-split feature order to the
    interleaved one: ours[2i] = hf[i], ours[2i+1] = hf[d/2 + i]."""
    half = head_dim // 2
    return torch.stack([torch.arange(half), torch.arange(half) + half],
                       dim=1).reshape(-1)


def _proj_in_out(w: torch.Tensor) -> torch.Tensor:
    return w.t()  # HF [out, in] -> ours [in, out] (a view)


def _qk(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """q/k projection: the per-head RoPE-convention permutation of the
    output features, then the transpose."""
    perm = _rope_perm(head_dim).to(w.device)
    w = w.reshape(n_heads, head_dim, -1)[:, perm]
    return _proj_in_out(w.reshape(n_heads * head_dim, -1))


def _qk_vec(b: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """A q/k bias or a per-head norm weight: it applies to the projection's
    features before RoPE, so it takes the same permutation."""
    perm = _rope_perm(head_dim).to(b.device)
    return b.reshape(n_heads, head_dim)[:, perm].reshape(-1)


def _attn_tensors(get: Callable[[str], torch.Tensor], p: str,
                  cfg) -> Dict[str, torch.Tensor]:
    """Llama-convention attention mapping (RoPE row permutation included)
    shared by the dense and MoE importers."""
    hd = cfg.head_dim
    return {
        "wq": _qk(get(p + "self_attn.q_proj.weight"), cfg.n_heads, hd),
        "wk": _qk(get(p + "self_attn.k_proj.weight"), cfg.n_kv_heads, hd),
        "wv": _proj_in_out(get(p + "self_attn.v_proj.weight")),
        "wo": _proj_in_out(get(p + "self_attn.o_proj.weight")),
        "ln_attn": get(p + "input_layernorm.weight"),
    }


def _put(leaves: Dict[str, torch.Tensor], name: str, idx, lead: tuple,
         t: torch.Tensor, dtype: torch.dtype) -> None:
    """Copy (and cast) ``t`` into row ``idx`` of the stacked leaf ``name``
    of shape ``lead + t.shape``, allocated at its first row in ``dtype`` on
    ``t``'s device."""
    out = leaves.get(name)
    if out is None:
        out = leaves[name] = torch.empty((*lead, *t.shape), dtype=dtype,
                                         device=t.device)
    out[idx].copy_(t)


def _state_of(model_or_state: Any, cfg, config_fn):
    if hasattr(model_or_state, "state_dict"):
        if cfg is None:
            cfg = config_fn(model_or_state.config)
        return cfg, model_or_state.state_dict()
    if cfg is None:
        raise ValueError("cfg is required when passing a raw state dict")
    return cfg, model_or_state


def _getter(state: MutableMapping[str, Any], consume: bool):
    def get(name: str) -> torch.Tensor:
        t = state.pop(name) if consume else state[name]
        return t.detach()

    return get


def _params_tail(get, state: Mapping[str, Any], cfg,
                 layers: Dict[str, torch.Tensor], shard=None) -> Params:
    """embed / final norm / lm_head, shared by both importers.
    Tied-embedding checkpoints (no ``lm_head.weight``) reuse the embedding
    matrix, as transformers' ``tie_word_embeddings`` does.  ``shard(t,
    name)``: the tensor-parallel rank's slice of a whole leaf, on its
    device (the dense importer's ``tp``)."""
    shard = shard or (lambda t, name: t)

    def own(t: torch.Tensor, name: str) -> torch.Tensor:  # cfg.dtype copy
        t = shard(t, name)
        return torch.empty(t.shape, dtype=cfg.dtype,
                           device=t.device).copy_(t)

    head = get("lm_head.weight") if "lm_head.weight" in state else None
    embed = get("model.embed_tokens.weight")
    return {
        "embed": own(embed, "embed"),
        "layers": layers,
        "ln_out": own(get("model.norm.weight"), "ln_out"),
        "lm_head": own((embed if head is None else head).t(), "lm_head"),
    }


def params_from_hf(model_or_state: Any, cfg: Optional[LlamaConfig] = None,
                   consume: bool = False, tp_rank: int = 0,
                   tp: int = 1) -> Params:
    """An HF dense decoder (or its state dict) as the port's params, in
    ``cfg.dtype`` on the tensors' device.

    ``consume``: remove each tensor from the state dict once it is copied,
    so a state dict holding the only reference to its tensors frees them as
    the import goes (the import's peak is then the params plus one stacked
    leaf, not two models).

    ``tp_rank``/``tp``: only the rank's tensor-parallel shard
    (``parallel.sharding.llama_inference_specs``) is imported, each leaf
    sliced one layer at a time before it is stacked."""
    from ..parallel.sharding import llama_inference_specs, shard_leaf

    cfg, state = _state_of(model_or_state, cfg, config_from_hf)
    get = _getter(state, consume)
    hd = cfg.head_dim
    specs = llama_inference_specs(cfg=cfg)
    dims = {**specs["layers"], "embed": specs["embed"],
            "ln_out": specs["ln_out"], "lm_head": specs["lm_head"]}

    def shard(t: torch.Tensor, name: str, per_layer: bool = False):
        dim = dims.get(name)
        if dim is not None and per_layer:
            dim -= 1  # the spec counts the stacked layer axis
        return shard_leaf(t, dim, tp_rank, tp)

    leaves: Dict[str, torch.Tensor] = {}
    for li in range(cfg.n_layers):
        p = f"model.layers.{li}."
        layer = {
            **_attn_tensors(get, p, cfg),
            "w_gate": _proj_in_out(get(p + "mlp.gate_proj.weight")),
            "w_up": _proj_in_out(get(p + "mlp.up_proj.weight")),
            "w_down": _proj_in_out(get(p + "mlp.down_proj.weight")),
        }
        if cfg.post_norms:
            # Gemma-2 sandwich: post_attention_layernorm is genuinely
            # POST-attention; the pre-FFN norm is pre_feedforward_layernorm
            layer["ln_post_attn"] = get(p + "post_attention_layernorm.weight")
            layer["ln_mlp"] = get(p + "pre_feedforward_layernorm.weight")
            layer["ln_post_mlp"] = get(p + "post_feedforward_layernorm.weight")
        else:
            # Llama family: post_attention_layernorm IS the pre-FFN norm
            layer["ln_mlp"] = get(p + "post_attention_layernorm.weight")
        if cfg.attn_bias:
            layer["bq"] = _qk_vec(get(p + "self_attn.q_proj.bias"),
                                  cfg.n_heads, hd)
            layer["bk"] = _qk_vec(get(p + "self_attn.k_proj.bias"),
                                  cfg.n_kv_heads, hd)
            layer["bv"] = get(p + "self_attn.v_proj.bias")
        if cfg.qk_norm:
            layer["q_norm"] = _qk_vec(get(p + "self_attn.q_norm.weight"), 1, hd)
            layer["k_norm"] = _qk_vec(get(p + "self_attn.k_norm.weight"), 1, hd)
        for k, t in layer.items():
            _put(leaves, k, li, (cfg.n_layers,), shard(t, k, True),
                 cfg.dtype)
    return _params_tail(get, state, cfg, leaves, shard)


# ---- Mixtral-style sparse MoE ----


def moe_config_from_hf(hf_config: Any, dtype: torch.dtype = torch.bfloat16):
    """Map a ``transformers`` MixtralConfig onto ``models.moe.MoEConfig``,
    raising on what this architecture cannot represent."""
    from .moe import MoEConfig

    family = getattr(hf_config, "model_type", "")
    if family != "mixtral":
        raise ValueError(f"moe_config_from_hf: unsupported model_type {family!r}")
    if getattr(hf_config, "sliding_window", None) is not None:
        # the MoE forwards run full causal attention (Mixtral ships
        # sliding_window: null); a windowed variant would silently change
        # its attention pattern
        raise ValueError("moe_config_from_hf: sliding_window not supported")
    rs = getattr(hf_config, "rope_scaling", None)
    if rs and rs.get("rope_type", rs.get("type", "default")) != "default":
        # a "default" entry (what newer transformers configs carry in
        # place of none) scales nothing
        raise ValueError("moe_config_from_hf: rope_scaling not supported")
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    explicit_hd = getattr(hf_config, "head_dim", None)
    if explicit_hd is not None and explicit_hd != derived_hd:
        raise ValueError(
            f"moe_config_from_hf: decoupled head_dim {explicit_hd} != "
            f"hidden/heads {derived_hd} not supported"
        )
    return MoEConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(
            hf_config, "num_key_value_heads", hf_config.num_attention_heads
        ),
        ffn_dim=hf_config.intermediate_size,
        norm_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 1e6),
        n_experts=hf_config.num_local_experts,
        top_k=hf_config.num_experts_per_tok,
        dtype=dtype,
    )


def moe_params_from_hf(model_or_state: Any, cfg=None,
                       consume: bool = False) -> Params:
    """An HF MixtralForCausalLM (or its state dict) as the port's MoE
    params.  Attention and norms follow the Llama mapping; the expert FFNs
    stack on an ``[E]`` axis (HF per-expert ``w1`` = gate, ``w3`` = up,
    ``w2`` = down) and the router stays float32.  HF's softmax -> top-k ->
    renormalize routing equals softmax over the top-k exactly.

    The leaves are filled one weight kind at a time across the layers, so
    with ``consume`` (see ``params_from_hf``) the sources of a kind are
    freed as its stack fills: the import's peak over the state dict is one
    stacked leaf."""
    cfg, state = _state_of(model_or_state, cfg, moe_config_from_hf)
    get = _getter(state, consume)
    L, E = cfg.n_layers, cfg.n_experts
    leaves: Dict[str, torch.Tensor] = {}
    for li in range(L):
        p = f"model.layers.{li}."
        layer = {
            **_attn_tensors(get, p, cfg),
            "ln_mlp": get(p + "post_attention_layernorm.weight"),
        }
        for k, t in layer.items():
            _put(leaves, k, li, (L,), t, cfg.dtype)
        _put(leaves, "router", li, (L,), _proj_in_out(
            get(p + "block_sparse_moe.gate.weight")), torch.float32)
    for leaf, w in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
        for li in range(L):
            moe = f"model.layers.{li}.block_sparse_moe."
            for e in range(E):
                _put(leaves, leaf, (li, e), (L, E), _proj_in_out(
                    get(moe + f"experts.{e}.{w}.weight")), cfg.dtype)
    return _params_tail(get, state, cfg, leaves)
