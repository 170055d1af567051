"""The plain versions of the port's kernels against the reference: the
Pallas kernels in interpret mode (small blocks, as tests/test_ops.py runs
them) and the XLA paths they were tested against.  CPU only; the kernels
themselves are held against these on the card (tests/test_torch_cuda.py).

Tolerances: f32 atol = rtol = 1e-5; bf16 atol = rtol = 2e-2, because the
references and the plain versions round their QK and PV products to bf16
at different points (and the Pallas kernels accumulate in f32).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.models.attention import (
    causal_attention as j_causal,
    paged_decode_attention_xla as j_paged,
)
from infinistore_tpu.ops import (
    flash_causal_attention_pallas,
    flash_prefix_attention_pallas,
    paged_decode_attention_pallas,
)
from infinistore_tpu.ops.pallas_attention import (
    paged_decode_attention_pallas_alllayers,
)
from infinistore_tpu_torch.ops import cuda_attention as ca

torch.set_num_threads(2)

DT = {"f32": (jnp.float32, torch.float32, 1e-5),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, dt):
    jdt, tdt, _ = DT[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, dt, rows=slice(None)):
    tol = DT[dt][2]
    np.testing.assert_allclose(
        got.float().numpy()[rows], np.asarray(want, np.float32)[rows],
        rtol=tol, atol=tol,
    )


def _paged_case(B, n_rep, Hkv, D, T, n_blocks, max_pages, seed):
    """Mixed lengths (row 0 holds one token, others straddle page edges)
    and a last PAD row whose table entries are n_blocks."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv * n_rep, D)).astype(np.float32)
    cache = rng.standard_normal((2, Hkv, n_blocks, T, D)).astype(np.float32)
    table = np.zeros((B, max_pages), np.int32)
    lens = np.ones((B,), np.int32)
    free = list(rng.permutation(n_blocks))
    for b in range(B - 1):
        n_tok = 1 if b == 0 else int(rng.integers(2, max_pages * T))
        n_pg = -(-n_tok // T)
        table[b, :n_pg] = [free.pop() for _ in range(n_pg)]
        lens[b] = n_tok
    table[B - 1] = n_blocks
    return q, cache, table, lens


@pytest.mark.parametrize("n_rep,D,dt", [
    (1, 128, "f32"), (2, 64, "f32"), (4, 128, "f32"),
    (4, 128, "bf16"), (2, 64, "bf16"), (1, 64, "bf16"),
])
def test_plain_paged_decode_equals_pallas_and_xla(n_rep, D, dt):
    q, cache, table, lens = _paged_case(4, n_rep, 2, D, 16, 16, 4, seed=D + n_rep)
    jq, tq = _both(q, dt)
    jc, tc = _both(cache, dt)
    got = ca.paged_decode_attention_xla(tq, tc, torch.from_numpy(table),
                                        torch.from_numpy(lens))
    # the references see the real rows only (their gather clamps a pad row)
    real = slice(0, 3)
    jt, jl = jnp.asarray(table[real]), jnp.asarray(lens[real])
    _close(got, j_paged(jq[real], jc, jt, jl), dt, real)
    _close(got, paged_decode_attention_pallas(jq[real], jc, jt, jl,
                                              interpret=True), dt, real)
    assert float(got[3].abs().max()) == 0.0  # pad row: zeros, as K1


@pytest.mark.parametrize("n_rep,D,dt,Sq,q_offset", [
    (1, 128, "f32", 48, 0), (4, 128, "f32", 23, 0), (2, 64, "f32", 18, 24),
    (4, 128, "f32", 1, 0), (4, 128, "bf16", 48, 0), (2, 64, "bf16", 18, 24),
])
def test_plain_flash_causal_equals_pallas_and_xla(n_rep, D, dt, Sq, q_offset):
    rng = np.random.default_rng(Sq + q_offset)
    Hkv, Sk = 2, q_offset + Sq
    jq, tq = _both(rng.standard_normal((2, Sq, Hkv * n_rep, D)).astype(np.float32), dt)
    jk, tk = _both(rng.standard_normal((2, Sk, Hkv, D)).astype(np.float32), dt)
    jv, tv = _both(rng.standard_normal((2, Sk, Hkv, D)).astype(np.float32), dt)
    got = ca.causal_attention_xla(tq, tk, tv, q_offset=q_offset)
    _close(got, j_causal(jq, jk, jv, q_offset=q_offset), dt)
    _close(got, flash_causal_attention_pallas(
        jq, jk, jv, q_offset=q_offset, interpret=True, block_q=16,
        block_k=16), dt)


@pytest.mark.parametrize("plen,dt", [
    (0, "f32"), (5, "f32"), (16, "f32"), (32, "f32"), (9, "bf16"),
])
def test_plain_flash_prefix_equals_pallas_and_xla(plen, dt):
    rng = np.random.default_rng(plen)
    Sq, Hkv, D, pad = 18, 2, 128, 32
    jq, tq = _both(rng.standard_normal((1, Sq, 4, D)).astype(np.float32), dt)
    jk, tk = _both(rng.standard_normal((1, pad + Sq, Hkv, D)).astype(np.float32), dt)
    jv, tv = _both(rng.standard_normal((1, pad + Sq, Hkv, D)).astype(np.float32), dt)
    got = ca.causal_attention_xla(tq, tk, tv, prefix_pad=pad, prefix_len=plen)
    jl = jnp.asarray(plen, jnp.int32)
    _close(got, j_causal(jq, jk, jv, prefix_pad=pad, prefix_len=jl), dt)
    _close(got, flash_prefix_attention_pallas(
        jq, jk, jv, prefix_pad=pad, prefix_len=jl, interpret=True,
        block_q=16, block_k=16), dt)


def test_plain_alllayers_decode_equals_pallas_alllayers():
    """K4's plain version against the reference's all-layers Pallas kernel
    (interpret mode) at tests/test_ops.py's shapes, f32."""
    L, Hkv, n_rep, D, T = 3, 2, 4, 128, 16
    B, max_pages, n_blocks = 2, 4, 16
    rng = np.random.default_rng(3)
    qs = rng.standard_normal((L, B, Hkv * n_rep, D)).astype(np.float32)
    cache = rng.standard_normal((L, 2, Hkv, n_blocks, T, D)).astype(np.float32)
    table = np.stack([rng.permutation(n_blocks)[:max_pages]
                      for _ in range(B)]).astype(np.int32)
    lens = np.array([37, max_pages * T], np.int32)
    want = paged_decode_attention_pallas_alllayers(
        jnp.asarray(qs), jnp.asarray(cache), jnp.asarray(table),
        jnp.asarray(lens), interpret=True)
    got = ca.paged_decode_attention_alllayers_xla(
        torch.from_numpy(qs), torch.from_numpy(cache),
        torch.from_numpy(table), torch.from_numpy(lens))
    assert tuple(got.shape) == (L, B, Hkv * n_rep, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(0)
    q, cache, table, lens = _paged_case(3, 2, 2, 64, 4, 8, 3, seed=1)
    tq, tc = torch.from_numpy(q), torch.from_numpy(cache)
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    ca.reset_launches()
    assert torch.equal(ca.paged_decode_attention_cuda(tq, tc, tt, tl),
                       ca.paged_decode_attention_xla(tq, tc, tt, tl))
    x = torch.from_numpy(rng.standard_normal((1, 6, 4, 64)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 10, 2, 64)).astype(np.float32))
    assert torch.equal(ca.flash_causal_attention_cuda(x, kv, kv, q_offset=4),
                       ca.causal_attention_xla(x, kv, kv, q_offset=4))
    assert torch.equal(ca.flash_prefix_attention_cuda(x, kv, kv, 4, 3),
                       ca.causal_attention_xla(x, kv, kv, prefix_pad=4,
                                               prefix_len=3))
    qs, caches = torch.stack([tq, 2 * tq]), torch.stack([tc, -tc])
    assert torch.equal(
        ca.paged_decode_attention_alllayers_cuda(qs, caches, tt, tl),
        ca.paged_decode_attention_alllayers_xla(qs, caches, tt, tl))
    assert ca.LAUNCHES == {"paged_decode": 0, "flash_causal": 0,
                           "flash_prefix": 0, "paged_decode_alllayers": 0,
                           "flash_prefix_device_len": 0}


def test_repeat_kv_serves_each_kv_head_to_its_query_group():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(1, 2, 3, 4)
    y = ca.repeat_kv(x, 2)
    assert tuple(y.shape) == (1, 2, 6, 4)
    for h in range(6):
        assert torch.equal(y[:, :, h], x[:, :, h // 2])
    assert ca.repeat_kv(x, 1) is x


def _split_merge_model(q, cache, table, lens):
    """The scheme of csrc/paged_decode.cu in plain torch, fp32: each row's
    pages are cut into the splits ``ca.decode_splits`` gives; each split
    yields (m, l, acc) over its visible tokens in base 2 (an empty split:
    m = -1e30, l = 0, acc = 0); the splits are merged in split order by
    log-sum-exp.  A pad row gives zeros."""
    B, H, D = q.shape
    Hkv, n_blocks, T = cache.shape[1:4]
    R, max_pages = H // Hkv, table.shape[1]
    split_pages, n_splits = ca.decode_splits(T, max_pages)
    c = math.log2(math.e) / math.sqrt(D)
    out = torch.zeros((B, H, D), dtype=torch.float32)
    for b in range(B):
        n_pages = -(-int(lens[b]) // T)
        if lens[b] <= 0 or n_pages > max_pages or any(
                not 0 <= int(table[b, p]) < n_blocks for p in range(n_pages)):
            continue
        for hk in range(Hkv):
            qg = q[b, hk * R:(hk + 1) * R].float()  # [R, D]
            parts = []
            for s in range(n_splits):
                t0 = s * split_pages * T
                t1 = min(int(lens[b]), t0 + split_pages * T)
                if t1 <= t0:
                    parts.append((torch.full((R,), -1e30), torch.zeros(R),
                                  torch.zeros(R, D)))
                    continue
                toks = torch.arange(t0, t1)
                pages = table[b, toks // T].long()
                k = cache[0, hk, pages, toks % T].float()  # [n, D]
                v = cache[1, hk, pages, toks % T].float()
                sc = qg @ k.T  # [R, n]
                m = torch.maximum(sc.max(dim=1).values, torch.tensor(-1e30))
                p = torch.exp2((sc - m[:, None]) * c)
                parts.append((m, p.sum(dim=1), p @ v))
            mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
            den = torch.zeros(R)
            num = torch.zeros(R, D)
            for m, l, acc in parts:  # split order
                w = torch.exp2((m - mx) * c)
                den = den + w * l
                num = num + w[:, None] * acc
            out[b, hk * R:(hk + 1) * R] = num / den[:, None]
    return out


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("T,max_pages,lens,want_splits", [
    (4, 8, (1, 16, 27), 1),
    (16, 16, (1, 128, 200), 2),
    (16, 64, (1, 128, 900), 8),
])
def test_split_merge_scheme_equals_pallas_and_plain(dt, T, max_pages, lens,
                                                    want_splits):
    """K1's split-and-merge arithmetic against the Pallas kernel (interpret
    mode) and the plain version, at page sizes and table widths that give
    one, two and many splits per row.  Rows: seq_len 1, a row that ends on
    a split edge (its trailing splits are empty), a longer row, and a pad
    row.  Tolerance f32 1e-5, bf16 2e-2 (the module's)."""
    B, n_rep, Hkv, D = len(lens) + 1, 2, 2, 64
    n_blocks = 2 * max_pages
    rng = np.random.default_rng(T * max_pages)
    q = rng.standard_normal((B, Hkv * n_rep, D)).astype(np.float32)
    cache = rng.standard_normal((2, Hkv, n_blocks, T, D)).astype(np.float32)
    lens = np.array(list(lens) + [1], np.int32)
    table = np.stack([rng.permutation(n_blocks)[:max_pages]
                      for _ in range(B)]).astype(np.int32)
    table[B - 1] = n_blocks  # pad row
    assert ca.decode_splits(T, max_pages)[1] == want_splits
    jq, tq = _both(q, dt)
    jc, tc = _both(cache, dt)
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    got = _split_merge_model(tq, tc, tt, tl)
    real = slice(0, B - 1)
    want = paged_decode_attention_pallas(jq[real], jc, jnp.asarray(table[real]),
                                         jnp.asarray(lens[real]),
                                         interpret=True)
    _close(got, want, dt, real)
    _close(got, ca.paged_decode_attention_xla(tq, tc, tt, tl).float().numpy(),
           dt)
    assert float(got[B - 1].abs().max()) == 0.0


def test_decode_splits_depend_on_page_size_and_table_width_only():
    """The split rule K1 and K4 share: whole pages of about SPLIT_TOKENS
    tokens, at most MAX_SPLITS per row, enough splits to cover the table."""
    for T in (1, 4, 16, 32):
        for max_pages in (1, 8, 64, 128, 4096, 100_000):
            pages, n = ca.decode_splits(T, max_pages)
            assert pages * n >= max_pages > pages * (n - 1)
            assert n <= ca.MAX_SPLITS
            assert pages >= -(-ca.SPLIT_TOKENS // T)
    assert ca.decode_splits(16, 128) == (-(-ca.SPLIT_TOKENS // 16),
                                         -(-128 * 16 // ca.SPLIT_TOKENS))
