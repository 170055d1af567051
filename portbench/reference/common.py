"""The layers the reference families share: RMSNorm, interleaved RoPE,
causal GQA attention and the linear map with its float8 control."""

from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3 value
HEAD_BLOCK = 16384  # vocabulary columns of the LM head per product


@contextlib.contextmanager
def exact_float32():
    """Float32 products on the tensor cores' TF32 path are rounded to a
    10-bit mantissa: switch that off for the reference."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` through float8 e4m3 and back, scaled per slice along ``dim``
    so that each slice's largest magnitude maps to the format's largest."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x [S, in] float32, w [in, out] in its stored type -> x @ w in
    float32; the control rounds x per row and w per output column."""
    w = w.float()
    if fp8:
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D]: position s rotates the pair (x[2i], x[2i+1]) by
    s * theta**(-2i/D), the port's interleaved layout (HF's rotate-half
    layout is the same map under a fixed permutation of each head's
    q and k columns)."""
    S, _, D = x.shape
    freqs = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                    device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * freqs[None]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 512) -> torch.Tensor:
    """q [S, H, D], k/v [S, Hkv, D] float32 -> [S, H, D]: each query
    attends to itself and every earlier position, softmax(q k / sqrt(D)),
    query heads grouped over the KV heads; computed in blocks of queries."""
    S, H, D = q.shape
    Hk = k.shape[1]
    G = H // Hk
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        qb = q[s0:s1].reshape(s1 - s0, Hk, G, D)
        sc = torch.einsum("bkgd,skd->kgbs", qb, k[:s1]) * scale
        pos = torch.arange(s0, s1, device=q.device)[:, None]
        sc.masked_fill_(torch.arange(s1, device=q.device)[None] > pos,
                        float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out[s0:s1] = torch.einsum("kgbs,skd->bkgd", p, v[:s1]).reshape(
            s1 - s0, H, D)
    return out


def attention_block(layer, x, cfg, fp8: bool, qk_norm: bool) -> torch.Tensor:
    """The attention half of a pre-norm decoder layer: x + attn(norm(x))."""
    S = x.shape[0]
    H, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // H
    eps = cfg["rms_norm_eps"]
    h = rmsnorm(x, layer["ln_attn"], eps)
    q = linear(h, layer["wq"], fp8).view(S, H, hd)
    k = linear(h, layer["wk"], fp8).view(S, Hk, hd)
    v = linear(h, layer["wv"], fp8).view(S, Hk, hd)
    if qk_norm:
        q = rmsnorm(q, layer["q_norm"], eps)
        k = rmsnorm(k, layer["k_norm"], eps)
    theta = float(cfg["rope_theta"])
    a = causal_attention(rope(q, theta), rope(k, theta), v)
    return x + linear(a.reshape(S, H * hd), layer["wo"], fp8)


def swiglu(h, w_gate, w_up, w_down, fp8: bool) -> torch.Tensor:
    g = linear(h, w_gate, fp8)
    return linear(torch.nn.functional.silu(g) * linear(h, w_up, fp8),
                  w_down, fp8)


def run(params, cfg, tokens, rows, fp8: bool, layer_fn) -> torch.Tensor:
    """Embed ``tokens``, apply ``layer_fn(layer, x)`` for every layer, and
    return the float32 logits at ``rows``."""
    dev = params["embed"].device
    with torch.no_grad(), exact_float32():
        ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        x = params["embed"][ids].float()
        for li in range(cfg["num_hidden_layers"]):
            layer = {k: v[li] for k, v in params["layers"].items()}
            x = layer_fn(layer, x)
        r = torch.as_tensor(rows, dtype=torch.long, device=dev)
        h = rmsnorm(x[r], params["ln_out"], cfg["rms_norm_eps"])
        w = params["lm_head"]
        # in blocks of the vocabulary, so no float32 copy of the whole head
        return torch.cat([linear(h, w[:, i:i + HEAD_BLOCK], fp8)
                          for i in range(0, w.shape[1], HEAD_BLOCK)], dim=1)
