"""Attention ops: RoPE, causal prefill attention, paged decode attention and
the speculative verify step's paged multi-token attention.

Counterpart of the reference's ``models/attention.py``, routed as it
routes: a sliding window or a logit soft-cap (Mistral, Gemma-2) goes to the
plain PyTorch version on every device, as the reference sends those
configurations to its XLA path on every backend (its kernels carry neither
mask); everything else goes to a hand-written kernel
(``ops/cuda_attention.py``) for a CUDA tensor and to the plain version for
a CPU tensor.  The route follows the configuration alone: no switch, no
exception caught, no fallback when a kernel fails.  ``use_kernels=False``
(the reference's ``use_pallas=False``, which its training forward passes)
takes the plain version on every device: the kernels have no backward,
and each refuses a call that autograd would record.  The multi-token
attention of the verify step is plain PyTorch on every device, as the
reference's is XLA on every backend (``paged_multitoken_attention_xla``
has no Pallas kernel).

The tensor-parallel compositions (``paged_decode_attention_tp``,
``flash_causal_attention_tp``) run the same kernels on one rank's head
shard: attention is head-local, so they need no collective.
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
    refuse_grad,
    repeat_kv,
)

__all__ = [
    "rope_freqs", "apply_rope", "repeat_kv", "causal_attention",
    "causal_attention_xla", "flash_causal_attention_tp",
    "paged_decode_attention", "paged_decode_attention_tp",
    "paged_decode_attention_xla", "paged_multitoken_attention",
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
    use_kernels: bool = True,
) -> torch.Tensor:
    """Causal SDPA.  q: [B, Sq, H, D]; k/v: [B, Sk, H_kv, D] -> [B, Sq, H, D].

    ``q_offset``: absolute position of q[0] minus that of k[0] (chunked
    prefill attends to the cached prefix plus itself).  Padded-prefix mode
    (``prefix_pad`` and ``prefix_len`` both given, ``prefix_len`` a host int
    or a 0-d int32 tensor on q's device, passed through as it is): the first
    ``prefix_pad`` K/V rows are a prefix buffer of which only the first
    ``prefix_len`` are valid.

    With a ``window`` or ``softcap``, with ``use_kernels=False`` (the
    training forward: autograd runs through it) and on the CPU: the plain
    ``causal_attention_xla``.  Otherwise on CUDA: K2
    (``flash_prefix_attention_cuda``) in padded-prefix mode, K3
    (``flash_causal_attention_cuda``) otherwise.
    """
    if (not use_kernels or q.device.type == "cpu" or window is not None
            or softcap is not None):
        return causal_attention_xla(
            q, k, v, q_offset=q_offset, prefix_pad=prefix_pad,
            prefix_len=prefix_len, window=window, softcap=softcap,
        )
    if prefix_len is not None:
        if prefix_pad is None:
            raise ValueError("padded-prefix mode needs prefix_pad")
        return flash_prefix_attention_cuda(q, k, v, prefix_pad, prefix_len)
    return flash_causal_attention_cuda(q, k, v, q_offset=q_offset)


def _check_shard(q_heads: int, kv_heads: int, tp: int, H: int,
                 Hkv: int) -> None:
    """A rank's head shard holds whole GQA groups: ``tp`` divides both
    global head counts ``H`` and ``Hkv`` (the reference's asserts,
    ``models/attention.py:116,395``) and the shard holds ``1/tp`` of
    each."""
    if (tp < 1 or H % tp or Hkv % tp or q_heads != H // tp
            or kv_heads != Hkv // tp or q_heads % kv_heads):
        raise ValueError(
            f"a tp={tp} head shard of H={H}, H_kv={Hkv} holds {H // tp} "
            f"query and {Hkv // tp} KV heads (whole GQA groups), got "
            f"{q_heads} and {kv_heads}")


def flash_causal_attention_tp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tp: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    q_offset: int = 0,
    prefix_pad: Optional[int] = None,
    prefix_len=None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Tensor-parallel prefill attention on one rank: K3 (or, with
    ``prefix_len``, K2) over the rank's head shard.  The port of the
    reference's ``flash_causal_attention_tp`` (``models/attention.py:
    83-145``).

    Prefill attention is head-local: with ``tp | H_kv`` each rank holds
    whole (q-head group, kv-head) families, so the kernel runs on the local
    shard with no collective.  The reference takes the global arrays and
    ``shard_map``s them over the mesh's ``tp`` axis; here each rank is its
    own process and passes its shard, q [B, Sq, H/tp, D], k/v [B, Sk,
    H_kv/tp, D] (contiguous, as the rank projected them), and gets its
    shard of the output [B, Sq, H/tp, D].  ``n_heads``/``n_kv_heads`` (the
    global counts) are checked against ``tp`` and the shard's shapes.

    The reference routes to XLA at head sizes off the TPU's 128-lane
    tiling; the port's kernels take head sizes 32, 64 and 128, so every
    head size runs the kernel, as the single-rank path does.  A window or a
    softcap takes the plain version on every device and the CPU takes it
    for every call, as ``causal_attention`` routes them; so does
    ``use_kernels=False``.  With the kernels it refuses a call that
    autograd would record, on every device."""
    _check_shard(q.shape[2], k.shape[2], tp, n_heads, n_kv_heads)
    if use_kernels:
        refuse_grad("flash_causal_attention_tp", q, k, v)
    return causal_attention(q, k, v, q_offset=q_offset,
                            prefix_pad=prefix_pad, prefix_len=prefix_len,
                            window=window, softcap=softcap,
                            use_kernels=use_kernels)


def paged_decode_attention_tp(
    q: torch.Tensor,
    layer_cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    tp: int,
    *,
    n_heads: int,
    n_kv_heads: int,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Tensor-parallel paged decode attention on one rank: K1 over the
    rank's head shard of the queries and the paged cache.  The port of the
    reference's ``paged_decode_attention_tp`` (``models/attention.py:
    367-414``).

    Paged attention is head-local (each q-head group reads only its own KV
    head's pages), so the shard needs no collective.  The reference splits
    global arrays with a ``shard_map``; here q is the rank's [B, H/tp, D]
    and ``layer_cache`` its own contiguous cache shard [2, H_kv/tp,
    n_blocks, T, D] (``kv/cache.py``), and the result is the rank's shard
    [B, H/tp, D].  The reference's ``pallas_tp`` switch exists because
    ``pallas_call`` has no partitioning rule; a CUDA kernel on a shard
    needs none, so the kernel runs on the shards either way.  Routes as
    ``paged_decode_attention`` does (the plain version on the CPU, for a
    window or a softcap), and refuses a call that autograd would record,
    on every device."""
    _check_shard(q.shape[1], layer_cache.shape[1], tp, n_heads, n_kv_heads)
    refuse_grad("paged_decode_attention_tp", q, layer_cache)
    return paged_decode_attention(q, layer_cache, block_table, seq_lens,
                                  window=window, softcap=softcap)


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


def paged_multitoken_attention(
    q: torch.Tensor,
    layer_cache: torch.Tensor,
    block_table: torch.Tensor,
    positions: torch.Tensor,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Attention for a short run of new tokens against the paged cache (the
    speculative-decode verify step: S tokens attend to the whole paged
    history plus themselves, causally by absolute position).  The plain
    PyTorch port of the reference's ``paged_multitoken_attention_xla``
    (``models/attention.py:326-362``), on every device.

    q: [B, S, H, D] (RoPE applied); layer_cache: [2, H_kv, n_blocks, T, D],
    the new tokens' K/V already scattered into their pages; block_table:
    [B, max_pages] int32; positions: [B, S] absolute positions of the new
    tokens -> [B, S, H, D].  A key in a gathered page is visible iff its
    absolute position <= the query's (which also hides stale slots past the
    sequence end), and with a ``window`` > the query's minus the window.

    The query heads are grouped by their KV head (``q`` viewed [B, S, H_kv,
    H/H_kv, D] against K/V gathered once per KV head), where the reference
    repeats K and V H/H_kv times over the whole table: the same function
    without the copies.  Table entries outside ``[0, n_blocks)`` (pad rows)
    are clamped; their rows' outputs are finite and ignored by the caller.
    """
    B, S, H, D = q.shape
    Hkv, n_blocks, T = layer_cache.shape[1:4]
    max_pages = block_table.shape[1]
    table = block_table.long().clamp(0, n_blocks - 1)
    # [H_kv, B, max_pages, T, D] -> [H_kv, B, S_max, D]
    k = layer_cache[0][:, table].reshape(Hkv, B, max_pages * T, D)
    v = layer_cache[1][:, table].reshape(Hkv, B, max_pages * T, D)
    qg = q.reshape(B, S, Hkv, H // Hkv, D)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bsgrd,gbkd->bgrsk", qg, k).float() * scale
    if softcap is not None:  # Gemma-2 logit soft-capping
        logits = softcap * torch.tanh(logits / softcap)
    k_pos = torch.arange(max_pages * T, device=q.device)
    pos = positions.long()[:, :, None]
    mask = k_pos[None, None, :] <= pos  # [B, S, S_max]
    if window is not None:
        mask &= k_pos[None, None, :] > pos - window
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrsk,gbkd->bsgrd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, D)
