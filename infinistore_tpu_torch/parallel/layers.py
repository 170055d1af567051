"""One decoder layer that is tensor- and sequence-parallel by hand: Megatron
tensor parallelism plus ring-attention sequence parallelism, as one rank's
share.

Counterpart of the reference's ``parallel/layers.py``.  What each rank
holds:

  x          [B, S_loc, dim]      its sequence chunk, features whole
  wq/wk/wv   [dim, (H/tp)*hd]     column parallel (output sharded)
  wo         [(H/tp)*hd, dim]     row parallel (input sharded) -> all-reduce
  w_gate/up  [dim, F/tp]          column parallel
  w_down     [F/tp, dim]          row parallel -> all-reduce
  ln_*       [dim]                replicated

Per layer exactly two tp all-reduces (attention output and MLP output) and
one sp ring inside attention (``parallel/ring.py``).  ``tp_cross_entropy``,
the reference's training loss, belongs to the training slice and is not
ported here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.attention import apply_rope
from ..models.llama import rmsnorm
from .ring import ring_attention_local


def check_manual_layer(cfg) -> None:
    """The configurations this hand-written layer would miscompute are
    refused, as the reference asserts (``layers.py:54-59``): it hardcodes
    silu, offset-free RMSNorm and the 1/sqrt(D) attention scale."""
    if cfg.act != "silu" or cfg.norm_offset:
        raise ValueError("tp_layer_forward supports silu + plain rmsnorm "
                         "only")
    if cfg.query_pre_attn_scalar is not None or cfg.attn_softcap is not None:
        raise ValueError("tp_layer_forward takes no query_pre_attn_scalar "
                         "and no attention softcap")
    if cfg.post_norms:
        raise ValueError("tp_layer_forward takes no post-norms")


def tp_layer_forward(layer, x: torch.Tensor, positions: torch.Tensor, cfg,
                     tp=None, sp=None, return_kv: bool = False):
    """One decoder layer on this rank.  x: [B, S_loc, dim], the rank's
    sequence chunk at ``positions`` [S_loc] (global positions).

    ``tp``: a ``parallel.TPGroup`` over whose ranks the layer's weights
    are Megatron-sharded (None: whole weights); ``sp``: the process group
    of the sequence ring (None: the whole sequence on this rank).

    ``return_kv=True`` also returns this layer's post-RoPE (K, V) shards
    [B, S_loc, H_kv/tp, D] each: the serving KV contract
    (``models.llama.prefill_forward`` stores K after RoPE), which
    ``sharding.make_sp_prefill`` returns for paging."""
    check_manual_layer(cfg)
    B, S, _ = x.shape
    hd = cfg.head_dim

    h = rmsnorm(x, layer["ln_attn"], cfg.norm_eps)
    q, k, v = h @ layer["wq"], h @ layer["wk"], h @ layer["wv"]
    if cfg.attn_bias:
        # the bias shards with its projection: this rank's [(H/tp)*hd]
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:  # per-head-feature weights are replicated
        q = rmsnorm(q, layer["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, layer["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    attn = ring_attention_local(q, k, v, sp)  # [B, S, H/tp, hd]
    attn_out = attn.reshape(B, S, -1) @ layer["wo"]
    x = x + (attn_out if tp is None else tp.all_reduce(attn_out))

    h = rmsnorm(x, layer["ln_mlp"], cfg.norm_eps)
    mlp = (F.silu(h @ layer["w_gate"]) * (h @ layer["w_up"])) \
        @ layer["w_down"]
    x = x + (mlp if tp is None else tp.all_reduce(mlp))
    if return_kv:
        return x, (k, v)
    return x
