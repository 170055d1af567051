"""Carry reference (JAX) weights into the port.

The reference's parameter pytree is ``embed`` [V, dim], ``layers`` (a dict of
leaves stacked ``[L, ...]``: ``wq``/``wk``/``wv``/``wo``/``w_gate``/``w_up``/
``w_down`` stored ``[in, out]``, norms, optional biases and Q/K norms),
``ln_out`` [dim] and ``lm_head`` [dim, V] (``infinistore_tpu/models/llama.py:
164-169``).  The port keeps that layout and the ``x @ W`` convention, so the
conversion is a dtype-exact copy of every leaf; it owns that choice.  The
MoE family's pytree (``infinistore_tpu/models/moe.py``: experts stacked
``[L, E, ...]``, shared-expert ``ws_*`` leaves) converts the same way, its
float32 ``router`` kept in float32; a LoRA bank's stacks carry across with
``bank_from_jax``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .llama import LlamaConfig, Params

# leaves that stay float32 whatever the model's dtype (the MoE router:
# top-k ordering is precision-sensitive, as in the reference's init)
_FLOAT32_LEAVES = ("router",)


def _leaf(x: Any, cfg: LlamaConfig, device,
          dtype: torch.dtype = None) -> torch.Tensor:
    # via a float32 copy: numpy has no bfloat16 that torch reads, and
    # bf16 -> f32 -> bf16 is exact
    arr = np.array(x, dtype=np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype or cfg.dtype)


def params_from_jax(tree: Mapping[str, Any], cfg: LlamaConfig,
                    device, tp_rank: int = 0, tp: int = 1, pp_rank: int = 0,
                    pp: int = 1) -> Params:
    """The port's parameters from the reference pytree, whose leaves are
    numpy arrays (or anything ``np.asarray`` takes).

    ``tp_rank``/``tp`` and ``pp_rank``/``pp``: the rank's shard
    (``parallel.sharding.shard_tree``: its stage's layers, each sliced
    over tp as ``llama_inference_specs`` says), each numpy leaf sliced
    before it reaches ``device``, so no rank holds the whole model
    there."""
    from ..parallel.sharding import llama_inference_specs, shard_tree

    tree = {"embed": np.asarray(tree["embed"]),
            "layers": {k: np.asarray(v) for k, v in tree["layers"].items()},
            "ln_out": np.asarray(tree["ln_out"]),
            "lm_head": np.asarray(tree["lm_head"])}

    def leaf(x, name):
        return _leaf(x, cfg, device, torch.float32
                     if name in _FLOAT32_LEAVES else None)

    return shard_tree(tree, llama_inference_specs(tree), tp_rank, tp,
                      pp_rank, pp, leaf)


def bank_from_jax(bank: Any, cfg: LlamaConfig, device, tp_rank: int = 0,
                  tp: int = 1, pp_rank: int = 0, pp: int = 1):
    """The port's ``LoraBank`` from a reference ``LoraBank`` (its ``tree``
    of (A, B) stacks, ``names`` and ``scale``), every stack carried across
    as numpy in ``cfg.dtype``.  ``tp_rank``/``tp``, ``pp_rank``/``pp``:
    only the rank's shard (``parallel.sharding.shard_lora_tree``)."""
    from ..parallel.sharding import shard_lora_tree
    from .lora import LoraBank

    tree = {t: (np.asarray(A), np.asarray(B))
            for t, (A, B) in bank.tree.items()}
    return LoraBank(shard_lora_tree(tree, tp_rank, tp, pp_rank, pp,
                                    lambda x: _leaf(x, cfg, device)),
                    bank.names, bank.scale)
