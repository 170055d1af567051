"""Ring attention: causal attention with the sequence sharded over a group of
ranks (sequence/context parallelism for long prompts).

Counterpart of the reference's ``parallel/ring.py``.  Each rank holds a
contiguous sequence chunk of Q, K and V.  K/V blocks rotate around the ring
(a point-to-point send to the next rank and a receive from the previous
one) while every rank accumulates its queries' attention with an online
(flash-style) softmax: running max ``m``, denominator ``l`` and weighted
numerator ``o`` in fp32.  After ``sp`` blocks every query has seen every
key once.  The reference's body is ``jnp.einsum`` with an online softmax,
no Pallas kernel, so plain PyTorch is its faithful port on every device.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # finite: keeps exp() well-defined on fully-masked blocks


def _group_rank_size(group) -> tuple:
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """The previous rank's ``x`` (every rank sends its own to the next,
    around the ring of ``group``).  Over gloo a CUDA tensor is staged
    through host memory."""
    import torch.distributed as dist

    idx, n = _group_rank_size(group)
    staged = x.is_cuda and str(dist.get_backend(group)) == "gloo"
    y = x.contiguous()
    if staged:
        y = y.cpu()
    out = torch.empty_like(y)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, y, nxt, group),
        dist.P2POp(dist.irecv, out, prv, group)])
    for r in reqs:
        r.wait()
    return out.to(x.device) if staged else out


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group=None) -> torch.Tensor:
    """One rank's share of ring attention over ``group`` (a
    ``torch.distributed`` process group; None is a ring of one rank).

    q: [B, S_loc, H, D]; k/v: [B, S_loc, H_kv, D]: the rank's contiguous
    sequence chunk, rank ``i`` holding global positions ``[i * S_loc, (i +
    1) * S_loc)``.  GQA is handled by repeating the KV heads.  Causal
    masking is by global position, with the reference's finite ``NEG_INF``.
    Returns [B, S_loc, H, D] in q's dtype."""
    idx, n = (0, 1) if group is None else _group_rank_size(group)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    n_rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float()

    def rep(x):  # [B, S, Hkv, D] -> [B, S, H, D]
        if n_rep == 1:
            return x
        return x[:, :, :, None, :].expand(B, S, Hkv, n_rep, D).reshape(
            B, S, H, D)

    q_pos = idx * S + torch.arange(S, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for t in range(n):
        if t:
            # the last block is consumed without a (wasted) rotation
            k, v = ring_shift(k, group), ring_shift(v, group)
        ki = (idx - t) % n  # which global chunk this K/V block is
        s = torch.einsum("bqhd,bkhd->bhqk", qf, rep(k).float()) * scale
        k_pos = ki * S + torch.arange(S, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               rep(v).float())
        m = m_new
    out = o / l[..., None]  # [B, H, S, D]
    return out.transpose(1, 2).to(q.dtype)


def make_ring_attention(mesh, axis_name: str = "sp"):
    """The standalone sharded op over the mesh's ``axis_name`` group:
    ``(q, k, v) -> out``, each [B, S, H(_kv), D] whole on every rank; the
    rank attends for its contiguous chunk of S (``S % sp == 0``) and the
    chunks are all-gathered back, so every rank returns the whole output.
    Inside a forward that already holds its chunk, call
    ``ring_attention_local`` directly."""
    from .distributed import TPGroup

    group = mesh.get_group(axis_name)
    gather = TPGroup(group)

    def fn(q, k, v):
        S = q.shape[1]
        if S % gather.size:
            raise ValueError(f"ring attention needs S % {axis_name} == 0 "
                             f"(S={S}, {axis_name}={gather.size})")
        w = S // gather.size
        sl = slice(gather.rank * w, (gather.rank + 1) * w)
        out = ring_attention_local(q[:, sl].contiguous(),
                                   k[:, sl].contiguous(),
                                   v[:, sl].contiguous(), group)
        return gather.all_gather(out, dim=1)

    return fn
