"""Multi-LoRA adapters for the dense-decoder family.

Counterpart of the reference's ``models/lora.py``.  A **bank** holds N
adapters stacked on a leading axis, per target projection ``t`` and layer
``l``: ``A [L, N, in, r]`` and ``B [L, N, r, out]``.  Application is a
per-row gather plus two thin products inside the forward, ``y += ((x @
A[ids]) @ B[ids]) * scale`` with ``ids`` the [B] adapter index vector, so
one batch mixes adapters in one forward (and, on the card, in one CUDA
graph: the bank tensors are captured by pointer and the id vector is a
static buffer).  Adapter 0 is the base model (zero delta).

Targets are the attention projections (``wq wk wv wo``), as in the
reference.  ``lora_delta`` is plain PyTorch: the reference computes it
outside any Pallas kernel.  On a serving group a bank is sliced as the
weights it adapts (``LoraBank.shard``): ``wq``/``wk``/``wv``'s B by
columns, ``wo``'s A by rows, each stage its layers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .llama import LlamaConfig, Params

TARGETS = ("wq", "wk", "wv", "wo")


def _target_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, int]]:
    hd = cfg.head_dim
    return {
        "wq": (cfg.dim, cfg.n_heads * hd),
        "wk": (cfg.dim, cfg.n_kv_heads * hd),
        "wv": (cfg.dim, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, cfg.dim),
    }


class LoraBank:
    """N stacked adapters over a base model.

    ``tree``: {target: (A [L, N, in, r], B [L, N, r, out])}.
    ``names``: adapter id -> name (id 0 is always "base").
    ``scale``: the classic alpha/r multiplier, shared by the bank.
    """

    def __init__(self, tree: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 names: Sequence[str], scale: float):
        self.tree = tree
        self.names = list(names)
        if not self.names or self.names[0] != "base":
            raise ValueError(f"adapter 0 must be 'base', got {self.names}")
        self.scale = float(scale)

    @property
    def n_adapters(self) -> int:
        return len(self.names)

    def is_whole(self, cfg: LlamaConfig) -> bool:
        """Whether every stack has the whole model's layers and widths, as
        opposed to one rank's shard (``parallel.sharding.shard_lora_tree``)."""
        shapes = _target_shapes(cfg)
        return all(A.shape[0] == cfg.n_layers and A.shape[2] == shapes[t][0]
                   and B.shape[3] == shapes[t][1]
                   for t, (A, B) in self.tree.items())

    def shard(self, tp_rank: int, tp: int, pp_rank: int = 0,
              pp: int = 1) -> "LoraBank":
        """This bank's ``(pp_rank, tp_rank)`` shard, sliced as the base
        weights are (``parallel.sharding.shard_lora_tree``)."""
        from ..parallel.sharding import shard_lora_tree

        return LoraBank(shard_lora_tree(self.tree, tp_rank, tp, pp_rank, pp),
                        self.names, self.scale)

    def adapter_id(self, name: Optional[str]) -> int:
        if name is None:
            return 0
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown adapter {name!r}; have {self.names}"
            ) from None


def init_lora_bank(
    cfg: LlamaConfig,
    adapters: Sequence[str],
    rank: int,
    generator: torch.Generator,
    device,
    alpha: Optional[float] = None,
    targets: Sequence[str] = TARGETS,
    init_scale: float = 0.01,
    tp_rank: int = 0,
    tp: int = 1,
    pp_rank: int = 0,
    pp: int = 1,
) -> LoraBank:
    """Random bank drawn from ``generator`` (which must live on ``device``)
    straight on ``device``: A ~ normal / sqrt(in), B = ``init_scale`` *
    normal (the classic init has B = 0; a nonzero B makes each adapter
    change the model).  Slot 0 is the base model (zero A).  The
    reference's ``jax.random`` stream is not reproduced; tests carry a
    reference bank across with ``models/convert.py:bank_from_jax``.

    ``tp_rank``/``tp``, ``pp_rank``/``pp``: only the rank's shard is kept
    (``parallel.sharding.shard_lora_tree``), each target's stacks drawn
    whole, as on one rank, and sliced before the next target's draw."""
    from ..parallel.sharding import shard_lora_tree

    shapes = _target_shapes(cfg)
    names = ["base"] + [str(a) for a in adapters]
    n = len(names)
    tree: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for t in targets:
        d_in, d_out = shapes[t]
        A = torch.randn((cfg.n_layers, n, d_in, rank), generator=generator,
                        dtype=torch.float32, device=device) / math.sqrt(d_in)
        B = init_scale * torch.randn((cfg.n_layers, n, rank, d_out),
                                     generator=generator,
                                     dtype=torch.float32, device=device)
        A[:, 0] = 0.0
        tree.update(shard_lora_tree({t: (A, B)}, tp_rank, tp, pp_rank, pp,
                                    lambda x: x.to(cfg.dtype)))
    return LoraBank(tree, names, (alpha or rank) / rank)


def bank_from_arrays(
    cfg: LlamaConfig,
    adapters: Dict[str, Dict[str, Tuple[Any, Any]]],
    rank: int,
    device,
    alpha: Optional[float] = None,
) -> LoraBank:
    """A bank from per-adapter arrays: ``{name: {target: (A [L, in, r], B
    [L, r, out])}}`` (e.g. a PEFT checkpoint's per-layer lora_A / lora_B
    stacked over layers; numpy arrays or tensors).  Missing targets
    contribute zero delta."""
    shapes = _target_shapes(cfg)
    names = ["base"] + list(adapters)
    tree: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for t in TARGETS:
        d_in, d_out = shapes[t]
        A = torch.zeros((cfg.n_layers, len(names), d_in, rank),
                        dtype=cfg.dtype, device=device)
        B = torch.zeros((cfg.n_layers, len(names), rank, d_out),
                        dtype=cfg.dtype, device=device)
        for i, name in enumerate(adapters, start=1):
            pair = adapters[name].get(t)
            if pair is not None:
                A[:, i].copy_(torch.as_tensor(np.asarray(pair[0], np.float32)))
                B[:, i].copy_(torch.as_tensor(np.asarray(pair[1], np.float32)))
        tree[t] = (A, B)
    return LoraBank(tree, names, (alpha or rank) / rank)


def merge_lora(params: Params, bank: LoraBank, adapter_id: int) -> Params:
    """Fold one adapter into the base weights (offline single-adapter
    deployment, and the oracle of the batched path).  Only the target
    leaves are new tensors, merged one layer at a time in float32, so a
    full-width merge holds one layer's float32 copy at a time."""
    out = dict(params)
    layers = dict(params["layers"])
    for t, (A, B) in bank.tree.items():
        W = params["layers"][t]
        merged = torch.empty_like(W)
        for li in range(W.shape[0]):
            delta = (A[li, adapter_id].float() @ B[li, adapter_id].float()
                     ) * bank.scale
            merged[li].copy_(W[li].float() + delta)
        layers[t] = merged
    out["layers"] = layers
    return out


def lora_delta(
    x: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    ids: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Batched per-row adapter delta: ``((x @ A[ids]) @ B[ids]) * scale``.

    x: [B, S, in]; A: [N, in, r]; B: [N, r, out]; ids: [B] int32 or int64
    on ``x``'s device.  The middle product stays in ``x``'s dtype, as the
    reference's does."""
    mid = torch.bmm(x, A.index_select(0, ids))  # [B, S, r]
    return torch.bmm(mid, B.index_select(0, ids)) * scale


def layer_lora(bank_tree, li: int):
    """One layer's adapter stacks: {t: (A [N, in, r], B [N, r, out])}."""
    return {t: (A[li], B[li]) for t, (A, B) in bank_tree.items()}
