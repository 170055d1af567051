"""Tensor-parallel serving: Megatron-sharded weights and the forwards that
run on them.

Counterpart of the reference's ``parallel/sharding.py``.  The reference
annotates the params with ``PartitionSpec``s and lets GSPMD insert the two
all-reduces per layer; here each rank keeps its own contiguous slice of
every sharded leaf and the forwards (``models/llama.py`` with ``tp=``) run
the collectives where XLA puts them: an all-reduce after ``attn @ wo`` and
after ``... @ w_down``, an all-gather of the vocab-sharded logits.

A spec names, for each leaf, the dimension sharded over ``tp`` (an int) or
None for a replicated leaf: the ``PartitionSpec``s of the reference's
``llama_inference_specs`` (``infinistore_tpu/parallel/sharding.py:27-66``)
written as the axis that carries ``"tp"``.
"""

from __future__ import annotations

from typing import Optional

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


def shard_params(params, mesh, specs=None):
    """The rank's shard of ``params``: each sharded leaf's contiguous
    slice over the mesh's ``tp`` axis, replicated leaves as they are."""
    if specs is None:
        specs = llama_inference_specs(params)
    rank, tp = tp_rank_size(mesh)
    return {
        "embed": shard_leaf(params["embed"], specs["embed"], rank, tp),
        "layers": {k: shard_leaf(v, specs["layers"].get(k), rank, tp)
                   for k, v in params["layers"].items()},
        "ln_out": shard_leaf(params["ln_out"], specs["ln_out"], rank, tp),
        "lm_head": shard_leaf(params["lm_head"], specs["lm_head"], rank, tp),
    }


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
