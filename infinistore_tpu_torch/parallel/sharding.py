"""Sharded serving: Megatron-sharded weights (tp), layer-sharded stages
(pp), the forwards that run on them, and sequence-parallel prefill (sp).

Counterpart of the reference's ``parallel/sharding.py``.  The reference
annotates the params with ``PartitionSpec``s and lets GSPMD insert the two
all-reduces per layer; here each rank keeps its own contiguous slice of
every sharded leaf and the forwards (``models/llama.py`` with ``tp=``) run
the collectives where XLA puts them: an all-reduce after ``attn @ wo`` and
after ``... @ w_down``, an all-gather of the vocab-sharded logits.

A spec names, for each leaf, the dimension sharded over ``tp`` (an int) or
None for a replicated leaf: the ``PartitionSpec``s of the reference's
``llama_inference_specs`` (``infinistore_tpu/parallel/sharding.py:27-66``)
written as the axis that carries ``"tp"``.  Under ``pp`` a rank also keeps
only its stage's contiguous slice of every layer leaf (``shard_tree``), and
a LoRA bank is sliced as the weights it adapts (``shard_lora_tree``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .distributed import TPGroup


def llama_inference_specs(params=None, cfg=None) -> dict:
    """Tensor-parallel specs for the stacked param dict (the layer axis
    stays replicated).

    ``params`` (or ``cfg``): when given, the specs cover exactly the
    optional leaves the dict carries: QKV biases (``attn_bias``) shard
    with their head-partitioned projections; Q/K norm weights
    (``qk_norm``) are per-head-feature and replicate."""
    layer_specs = {
        "wq": 2, "wk": 2, "wv": 2, "wo": 1,
        "w_gate": 2, "w_up": 2, "w_down": 1,
        "ln_attn": None, "ln_mlp": None,
    }
    optional = {"bq": 1, "bk": 1, "bv": 1, "q_norm": None, "k_norm": None}
    present = set(params["layers"]) if params is not None else set()
    if cfg is not None:
        if cfg.attn_bias:
            present |= {"bq", "bk", "bv"}
        if cfg.qk_norm:
            present |= {"q_norm", "k_norm"}
    for key in present & set(optional):
        layer_specs[key] = optional[key]
    return {"embed": None, "layers": layer_specs, "ln_out": None,
            "lm_head": 1}


def check_tp_heads(n_heads: int, n_kv_heads: int, tp: int) -> None:
    """Tensor parallelism shards whole GQA groups: ``tp`` must divide both
    head counts (the reference asserts it, ``models/attention.py:116,
    395``)."""
    if tp < 1 or n_kv_heads % tp or n_heads % tp:
        raise ValueError(f"tp={tp} must divide n_heads={n_heads} and "
                         f"n_kv_heads={n_kv_heads}")


def shard_leaf(x, dim: Optional[int], rank: int, tp: int):
    """The ``rank``-th of ``tp`` contiguous slices of ``x`` (a tensor or a
    numpy array) along ``dim`` (a contiguous copy, so the whole leaf can be
    freed), or ``x`` itself for a replicated leaf or ``tp == 1``."""
    if dim is None or tp == 1:
        return x
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"a leaf of shape {tuple(x.shape)} does not split "
                         f"{tp} ways along dim {dim}")
    w = n // tp
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(rank * w, (rank + 1) * w)
    part = x[tuple(idx)]
    return part.contiguous() if hasattr(part, "contiguous") else \
        part.copy()


def tp_rank_size(mesh) -> tuple:
    """(this rank's index on the mesh's ``tp`` axis, the axis' size)."""
    return mesh.get_local_rank("tp"), mesh["tp"].size()


def pp_rank_size(mesh) -> tuple:
    """(this rank's stage on the mesh's ``pp`` axis, the axis' size)."""
    return mesh.get_local_rank("pp"), mesh["pp"].size()


def stage_layers(n_layers: int, pp_rank: int, pp: int) -> tuple:
    """The layer range ``[lo, hi)`` stage ``pp_rank`` of ``pp`` holds."""
    if n_layers % pp:
        raise ValueError(f"n_layers={n_layers} must divide over pp={pp}")
    n = n_layers // pp
    return pp_rank * n, (pp_rank + 1) * n


def _absent_leaf(x):
    """The empty stand-in of a leaf a stage does not hold (``embed`` past
    stage 0, ``ln_out`` and ``lm_head`` before the last): ``x``'s dtype
    and device, no element."""
    if hasattr(x, "new_empty"):
        return x.new_empty((0,))
    import numpy as np

    return np.zeros((0,), dtype=np.asarray(x).dtype)


def _layer_slice(x, lo: int, hi: int):
    """Layers ``[lo, hi)`` of a stacked leaf (a copy unless it is all of
    them, so the whole leaf can be freed)."""
    if lo == 0 and hi == x.shape[0]:
        return x
    part = x[lo:hi]
    return part.clone() if hasattr(part, "clone") else part.copy()


def shard_tree(params, specs, tp_rank: int, tp: int, pp_rank: int = 0,
               pp: int = 1, leaf=None):
    """The ``(pp_rank, tp_rank)`` shard of a stacked param dict (tensors
    or numpy arrays): each layer leaf's stage slice of the layer axis, then
    its tp slice; ``embed`` on stage 0, ``ln_out`` and ``lm_head`` on the
    last stage (``_absent_leaf`` elsewhere).  ``leaf`` maps each kept or
    absent leaf to its final form (``(x, name)`` -> tensor), identity by
    default."""
    if leaf is None:
        def leaf(x, _name):
            return x
    L = next(iter(params["layers"].values())).shape[0]
    lo, hi = stage_layers(L, pp_rank, pp)

    def top(name, keep):
        x = params[name]
        if not keep:
            return leaf(_absent_leaf(x), name)
        return leaf(shard_leaf(x, specs[name], tp_rank, tp), name)

    return {
        "embed": top("embed", pp_rank == 0),
        "layers": {k: leaf(shard_leaf(_layer_slice(v, lo, hi),
                                      specs["layers"].get(k), tp_rank, tp),
                           k)
                   for k, v in params["layers"].items()},
        "ln_out": top("ln_out", pp_rank == pp - 1),
        "lm_head": top("lm_head", pp_rank == pp - 1),
    }


def shard_params(params, mesh, specs=None):
    """The rank's shard of ``params``: each sharded leaf's contiguous
    slice over the mesh's ``tp`` axis and, with a ``pp`` axis, the rank's
    stage of the layers (``shard_tree``); replicated leaves as they are."""
    if specs is None:
        specs = llama_inference_specs(params)
    tp_rank, tp = tp_rank_size(mesh)
    pp_rank, pp = pp_rank_size(mesh)
    return shard_tree(params, specs, tp_rank, tp, pp_rank, pp)


def params_are_whole(params, cfg) -> bool:
    """Whether ``params`` hold the whole model (every layer, every head),
    as opposed to one rank's shard."""
    wq = params["layers"]["wq"]
    return (wq.shape[0] == cfg.n_layers
            and wq.shape[-1] == cfg.n_heads * cfg.head_dim)


# the tp dimension of each LoRA target's (A [L, N, in, r], B [L, N, r,
# out]): B's columns follow a column-parallel projection's, A's rows a
# row-parallel one's; the other factor stays whole
LORA_TP_DIMS = {"wq": (None, 3), "wk": (None, 3), "wv": (None, 3),
                "wo": (2, None)}


def shard_lora_tree(tree, tp_rank: int, tp: int, pp_rank: int = 0,
                    pp: int = 1, leaf=None):
    """The ``(pp_rank, tp_rank)`` shard of a LoRA bank's ``{target: (A,
    B)}``: the stage's layers, and each factor sliced as its target's base
    weight is (``LORA_TP_DIMS``).  The ``wo`` delta of a shard, ``(x_s @
    A_s) @ B``, is that rank's partial sum, added to the partial ``wo``
    output before its all-reduce: the sum over the ranks is the whole
    delta."""
    if leaf is None:
        def leaf(x):
            return x
    out = {}
    for t, (A, B) in tree.items():
        lo, hi = stage_layers(A.shape[0], pp_rank, pp)
        da, db = LORA_TP_DIMS[t]
        out[t] = (leaf(shard_leaf(_layer_slice(A, lo, hi), da, tp_rank, tp)),
                  leaf(shard_leaf(_layer_slice(B, lo, hi), db, tp_rank, tp)))
    return out


def make_tp_prefill(cfg, mesh):
    """Tensor-parallel prefill on this rank: ``(params, tokens [B, S]) ->
    (logits [B, S, V], kv [L, 2, B, S, H_kv/tp, D])`` for the rank's shard
    of the params.  The logits come back whole on every rank (gathered);
    the KV stays head-sharded on its rank, as the reference's
    ``make_tp_prefill`` leaves it sharded over ``tp``."""
    from ..models.llama import prefill_forward

    check_tp_heads(cfg.n_heads, cfg.n_kv_heads, tp_rank_size(mesh)[1])
    tp = TPGroup.from_mesh(mesh)

    def fn(params, tokens):
        return prefill_forward(params, cfg, tokens, tp=tp)

    return fn


def make_sp_prefill(cfg, mesh):
    """Sequence-parallel long-context prefill on this rank: ``(params,
    tokens [B, S]) -> (logits [B, S, V], kv [L, 2, B, S, H_kv, D])``, the
    port of the reference's ``make_sp_prefill`` (``parallel/sharding.py:
    105-183``).

    The sequence shards over the mesh's ``sp`` axis and attention runs as
    ring attention (``parallel/ring.py``): each rank holds ``S/sp``
    positions of Q/K/V and K/V blocks rotate around the ring, so a rank's
    attention memory is O((S/sp)^2) and the prompt's FLOPs spread over the
    group.  Heads shard over ``tp`` as in ``make_tp_prefill``; ``params``
    are the rank's tp shard (``shard_params``), whole over ``sp``.  Every
    rank passes the whole ``tokens`` and gets the whole outputs back
    (gathered over ``tp``, then ``sp``), in ``prefill_forward``'s contract
    (K after RoPE), so ``InferenceEngine.adopt_prefill`` pages the KV
    unchanged.  Dense Llama family only (no window, no softcap, no Gemma
    knobs), as the reference asserts; ``S % sp != 0`` raises (pad the
    prompt: causal masking keeps the pad out of earlier positions, slice
    the outputs back)."""
    from ..models.llama import rmsnorm
    from .layers import check_manual_layer, tp_layer_forward

    if cfg.sliding_window is not None:
        raise ValueError("ring attention carries no window")
    if cfg.attn_softcap is not None or cfg.final_softcap is not None:
        raise ValueError("ring attention carries no softcap")
    if cfg.post_norms or cfg.embed_scale:
        raise ValueError("sp prefill takes no post-norms and no embed "
                         "scale")
    check_manual_layer(cfg)
    tp_rank, tp_n = tp_rank_size(mesh)
    check_tp_heads(cfg.n_heads, cfg.n_kv_heads, tp_n)
    sp_group = mesh.get_group("sp")
    sp = TPGroup(sp_group)
    tp = TPGroup.from_mesh(mesh) if tp_n > 1 else None

    def fn(params, tokens):
        B, S = tokens.shape
        if S % sp.size:
            raise ValueError(
                f"sp prefill needs S % sp == 0 (S={S}, sp={sp.size}); pad "
                f"the prompt to the bucket and slice the outputs back "
                f"(causal masking makes the pad inert)")
        w = S // sp.size
        local = tokens[:, sp.rank * w:(sp.rank + 1) * w]
        positions = sp.rank * w + torch.arange(w, device=tokens.device)
        x = params["embed"][local.long()]
        ks, vs = [], []
        for li in range(params["layers"]["wq"].shape[0]):
            layer = {k: v[li] for k, v in params["layers"].items()}
            x, (k, v) = tp_layer_forward(layer, x, positions, cfg, tp=tp,
                                         sp=sp_group, return_kv=True)
            ks.append(k)
            vs.append(v)
        hs = rmsnorm(x, params["ln_out"], cfg.norm_eps)
        logits = hs @ params["lm_head"]  # a tp column shard of the vocab
        # [L, B, S_loc, H_kv/tp, D] x2 -> [L, 2, B, S_loc, H_kv/tp, D]
        kv = torch.stack([torch.stack(ks), torch.stack(vs)], dim=1)
        if tp is not None:
            logits = tp.all_gather(logits, dim=-1)
            kv = tp.all_gather(kv, dim=4)
        return sp.all_gather(logits, dim=1), sp.all_gather(kv, dim=3)

    return fn


def make_tp_decode(cfg, mesh):
    """Tensor-parallel paged decode step on this rank: ``(params, tokens,
    positions, cache, block_table, seq_lens, slot_block_ids, slot_ids) ->
    (logits [B, V], cache)``, the cache the rank's head shard
    ``[L, 2, H_kv/tp, n_blocks, T, D]`` (updated in place), the logits
    whole on every rank."""
    from ..models.llama import decode_forward

    check_tp_heads(cfg.n_heads, cfg.n_kv_heads, tp_rank_size(mesh)[1])
    tp = TPGroup.from_mesh(mesh)

    def fn(params, tokens, positions, cache, block_table, seq_lens,
           slot_block_ids, slot_ids):
        return decode_forward(params, cfg, tokens, positions, cache,
                              block_table, seq_lens, slot_block_ids,
                              slot_ids, tp=tp)

    return fn
