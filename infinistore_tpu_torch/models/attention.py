"""Attention ops: RoPE, causal prefill attention and paged decode attention.

Counterpart of the reference's ``models/attention.py``, routed as it
routes: a sliding window or a logit soft-cap (Mistral, Gemma-2) goes to the
plain PyTorch version on every device, as the reference sends those
configurations to its XLA path on every backend (its kernels carry neither
mask); everything else goes to a hand-written kernel
(``ops/cuda_attention.py``) for a CUDA tensor and to the plain version for
a CPU tensor.  The route follows the configuration alone: no switch, no
exception caught, no fallback when a kernel fails.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.cuda_attention import (
    causal_attention_xla,
    flash_causal_attention_cuda,
    flash_prefix_attention_cuda,
    paged_decode_attention_cuda,
    paged_decode_attention_xla,
    repeat_kv,
)

__all__ = [
    "rope_freqs", "apply_rope", "repeat_kv", "causal_attention",
    "causal_attention_xla", "paged_decode_attention",
    "paged_decode_attention_xla",
]


def rope_freqs(
    head_dim: int,
    theta: float = 500000.0,
    scaling: tuple | None = None,
    device=None,
) -> torch.Tensor:
    """Base RoPE frequencies [head_dim/2] in fp32, optionally remapped by
    Llama-3.1-style context-extension scaling.

    ``scaling``: ``(factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings)``: long wavelengths (relative to the
    original context) are slowed by ``factor``, short ones are kept, and the
    band between is interpolated (transformers' ``rope_type="llama3"``).
    """
    freqs = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )
    if scaling is not None:
        factor, low_f, high_f, orig_ctx = scaling
        wavelen = 2.0 * math.pi / freqs
        low_wl = orig_ctx / low_f
        high_wl = orig_ctx / high_f
        smooth = (orig_ctx / wavelen - low_f) / (high_f - low_f)
        interp = (1.0 - smooth) * freqs / factor + smooth * freqs
        freqs = torch.where(
            wavelen > low_wl,
            freqs / factor,
            torch.where(wavelen < high_wl, freqs, interp),
        )
    return freqs


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 500000.0,
    scaling: tuple | None = None,
) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].  Rotates
    interleaved pairs (x[2i], x[2i+1]) as the reference does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, scaling, device=x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    out = torch.stack([out1, out2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int = 0,
    prefix_pad: Optional[int] = None,
    prefix_len=None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal SDPA.  q: [B, Sq, H, D]; k/v: [B, Sk, H_kv, D] -> [B, Sq, H, D].

    ``q_offset``: absolute position of q[0] minus that of k[0] (chunked
    prefill attends to the cached prefix plus itself).  Padded-prefix mode
    (``prefix_pad`` and ``prefix_len`` both given, ``prefix_len`` a host int
    or a 0-d int32 tensor on q's device, passed through as it is): the first
    ``prefix_pad`` K/V rows are a prefix buffer of which only the first
    ``prefix_len`` are valid.

    With a ``window`` or ``softcap``, and on the CPU: the plain
    ``causal_attention_xla``.  Otherwise on CUDA: K2
    (``flash_prefix_attention_cuda``) in padded-prefix mode, K3
    (``flash_causal_attention_cuda``) otherwise.
    """
    if q.device.type == "cpu" or window is not None or softcap is not None:
        return causal_attention_xla(
            q, k, v, q_offset=q_offset, prefix_pad=prefix_pad,
            prefix_len=prefix_len, window=window, softcap=softcap,
        )
    if prefix_len is not None:
        if prefix_pad is None:
            raise ValueError("padded-prefix mode needs prefix_pad")
        return flash_prefix_attention_cuda(q, k, v, prefix_pad, prefix_len)
    return flash_causal_attention_cuda(q, k, v, q_offset=q_offset)


def paged_decode_attention(
    q: torch.Tensor,
    layer_cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Paged decode attention; K1 (``paged_decode_attention_cuda``) on CUDA,
    the plain gather (``paged_decode_attention_xla``) on the CPU and, on
    every device, for a ``window`` or ``softcap``.

    q: [B, H, D] (RoPE applied); layer_cache: [2, H_kv, n_blocks, T, D];
    block_table: [B, max_pages] int32; seq_lens: [B] int32 (incl. current).
    """
    if q.device.type == "cpu" or window is not None or softcap is not None:
        return paged_decode_attention_xla(
            q, layer_cache, block_table, seq_lens, window=window,
            softcap=softcap,
        )
    return paged_decode_attention_cuda(q, layer_cache, block_table, seq_lens)
