"""The port's CUDA kernels against their plain PyTorch versions, and the
store hop's device half (pages through the port's own store server), on the
card.

Every test here needs a CUDA device and skips without one.  This file imports
torch and the port only (no jax, no conftest helpers), so on the GPU machine
it runs as:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: bf16 atol = rtol = 2e-2 (the plain versions round the QK and PV
products to bf16, the kernels accumulate in fp32); fp32 atol = rtol = 1e-4
(the kernels sum over up to about 1500 keys in another order than cuBLAS).
"""

import numpy as np
import pytest
import torch

from infinistore_tpu_torch.ops import cuda_attention as ca

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged(B, H, Hkv, D, T, n_blocks, max_pages, dtype, dev, seed=0,
           pad_rows=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    cache = torch.from_numpy(
        rng.standard_normal((2, Hkv, n_blocks, T, D), np.float32))
    table = np.zeros((B, max_pages), np.int32)
    lens = np.zeros((B,), np.int32)
    free = list(range(n_blocks))
    rng.shuffle(free)
    for b in range(B - pad_rows):
        n_tok = 1 if b == 0 else int(rng.integers(1, (max_pages - 1) * T))
        n_pg = -(-n_tok // T)
        table[b, :n_pg] = [free.pop() for _ in range(n_pg)]
        lens[b] = n_tok
    table[B - pad_rows:] = n_blocks  # pad rows: one past the pool
    lens[B - pad_rows:] = 1
    return (q.to(dev, dtype), cache.to(dev, dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(lens).to(dev))


def _close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,n_rep,T", [
    (128, 4, 16), (128, 1, 16), (64, 2, 16), (128, 4, 4), (64, 8, 32),
])
def test_paged_decode_kernel_matches_plain(dev, dtype, D, n_rep, T):
    Hkv = 8 if D == 128 else 2
    q, cache, table, lens = _paged(8, Hkv * n_rep, Hkv, D, T, 256, 12, dtype,
                                   dev, pad_rows=1)
    ca.reset_launches()
    got = ca.paged_decode_attention_cuda(q, cache, table, lens)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["paged_decode"] == 1
    want = ca.paged_decode_attention_xla(q, cache, table, lens)
    _close(got, want, dtype)
    assert float(got[-1].abs().max()) == 0.0  # the pad row writes zeros


# head sizes and query heads per KV head of the flash cases (H_kv = 2)
_FLASH_HEADS = [(64, 1), (64, 2), (64, 4), (64, 8), (128, 1), (128, 4),
                (128, 8)]
# K3: Sq on both sides of the 64-row warpgroup and 128-row block edges, at
# q_offset 0 and 190 (not a tile multiple), and the store tail (16 rows at
# q_offset 1488)
_K3_SHAPES = [(Sq, off) for off in (0, 190)
              for Sq in (1, 16, 63, 64, 65, 127, 128, 129, 512)] + [
    (16, 1488), (300, 0), (77, 190)]
# K2: prefix_len around the 128-row tile edge and at prefix_pad, with
# prefix_pad 64 and 192 not multiples of the tile
_K2_SHAPES = [(pad, plen, (1, 65, 130, 200, 480)[i % 5])
              for i, (pad, plen) in enumerate(
                  (pad, plen) for pad in (64, 192, 512, 1024)
                  for plen in sorted({0, 1, 127, 128, 129, pad}) if plen <= pad)
              ] + [(128, 70, 100), (128, 128, 64), (256, 0, 40), (64, 63, 200),
                   (512, 512, 512), (1024, 1024, 480), (1024, 700, 512)]


def _flash_inputs(seed, B, Sq, Sk, n_rep, D, dtype, dev):
    rng = np.random.default_rng(seed)
    Hkv = 2
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev, dtype) for shape in ((B, Sq, Hkv * n_rep, D), (B, Sk, Hkv, D),
                                  (B, Sk, Hkv, D))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,n_rep", _FLASH_HEADS)
@pytest.mark.parametrize("Sq,q_offset", _K3_SHAPES)
def test_flash_causal_kernel_matches_plain(dev, dtype, D, n_rep, Sq, q_offset):
    """K3 against its plain version; two launches on the same inputs are
    bitwise equal (no atomics, no order that depends on the run)."""
    q, k, v = _flash_inputs(Sq, 2, Sq, q_offset + Sq, n_rep, D, dtype, dev)
    ca.reset_launches()
    got = ca.flash_causal_attention_cuda(q, k, v, q_offset=q_offset)
    again = ca.flash_causal_attention_cuda(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["flash_causal"] == 2
    assert torch.equal(got, again)
    _close(got, ca.causal_attention_xla(q, k, v, q_offset=q_offset), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,n_rep", _FLASH_HEADS)
@pytest.mark.parametrize("prefix_pad,plen,Sq", _K2_SHAPES)
def test_flash_prefix_kernel_matches_plain(dev, dtype, D, n_rep, prefix_pad,
                                           plen, Sq):
    """K2 against its plain version, bitwise equal across two launches."""
    q, k, v = _flash_inputs(plen, 1, Sq, prefix_pad + Sq, n_rep, D, dtype,
                            dev)
    ca.reset_launches()
    got = ca.flash_prefix_attention_cuda(q, k, v, prefix_pad, plen)
    again = ca.flash_prefix_attention_cuda(q, k, v, prefix_pad, plen)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["flash_prefix"] == 2
    assert torch.equal(got, again)
    want = ca.causal_attention_xla(q, k, v, prefix_pad=prefix_pad,
                                   prefix_len=plen)
    _close(got, want, dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 4, 4, 96), device=dev)  # head_dim 96: not built
    with pytest.raises(ValueError):
        ca.flash_causal_attention_cuda(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 4, 4, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        ca.flash_causal_attention_cuda(q, q, q)
    q = torch.zeros((1, 4, 4, 64), device=dev).transpose(1, 2)
    with pytest.raises(ValueError):
        ca.flash_causal_attention_cuda(q, q, q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("L,D,n_rep,T", [(3, 128, 4, 16), (4, 64, 2, 8)])
def test_alllayers_decode_kernel_matches_plain_and_per_layer(dev, dtype, L, D,
                                                             n_rep, T):
    """K4 against its plain version, and bitwise equal to L K1 launches on
    the same inputs (it exists to vary only the number of launches)."""
    Hkv = 2
    q, cache, table, lens = _paged(6, Hkv * n_rep, Hkv, D, T, 64, 8, dtype,
                                   dev, seed=L, pad_rows=1)
    g = torch.Generator(device=dev).manual_seed(L)
    qs = torch.randn((L,) + tuple(q.shape), generator=g, device=dev).to(dtype)
    caches = torch.randn((L,) + tuple(cache.shape), generator=g,
                         device=dev).to(dtype)
    ca.reset_launches()
    got = ca.paged_decode_attention_alllayers_cuda(qs, caches, table, lens)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["paged_decode_alllayers"] == 1
    _close(got, ca.paged_decode_attention_alllayers_xla(qs, caches, table,
                                                        lens), dtype)
    per_layer = torch.stack([ca.paged_decode_attention_cuda(
        qs[l], caches[l], table, lens) for l in range(L)])
    assert torch.equal(got, per_layer)
    assert float(got[:, -1].abs().max()) == 0.0  # the pad row writes zeros


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def store_port():
    """The port's own store server (asyncio backend) in a subprocess."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pathlib
    import signal
    import socket
    import subprocess
    import sys
    import time

    port, mport = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.server",
         "--service-port", str(port), "--manage-port", str(mport),
         "--prealloc-size", "1", "--minimal-allocate-size", "16",
         "--log-level", "warning", "--backend", "python"],
        cwd=pathlib.Path(__file__).resolve().parents[1],
    )
    deadline = time.time() + 60
    while True:
        assert proc.poll() is None, "store server exited"
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            break
        except OSError:
            assert time.time() < deadline, "store server did not come up"
            time.sleep(0.2)
    yield port
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()


@pytest.mark.parametrize("transport", ["shm", "tcp"])
@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_store_hop_on_the_card(dev, store_port, transport, quant, dtype):
    """Pages saved from a cache on the card load back into another cache on
    the card byte for byte (int8: exactly the plain quantize round trip, so
    the card quantizes to the same bytes as the CPU); on shm every
    full-precision band lands straight in the page-locked pool."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM, TYPE_TCP
    from infinistore_tpu_torch.kv import (
        KVTransferEngine, PagedCacheConfig, chunk_keys, dequantize_pages,
        init_cache, quantize_pages, read_pages, write_pages)

    pc = PagedCacheConfig(n_layers=4, n_kv_heads=8, head_dim=128,
                          n_blocks=16, block_tokens=16, dtype=dtype)
    conn = lib.InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=store_port,
        connection_type=TYPE_SHM if transport == "shm" else TYPE_TCP))
    conn.connect()
    try:
        eng = KVTransferEngine(conn, pc, quant=quant, device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        pages = torch.randn((4, 2, 8, 3, 16, 128), generator=g,
                            device=dev).to(dtype)
        cache = write_pages(init_cache(pc, dev),
                            torch.tensor([2, 7, 5], device=dev), pages)
        keys = chunk_keys(list(range(48)),
                          f"cuda-hop-{transport}-{quant}-{dtype}")
        eng.save_pages(cache, [2, 7, 5], keys)
        stages = eng.last_push_stages
        assert stages["zero_copy_bands"] + stages["staged_bands"] == 4
        if transport == "shm" and quant is None:
            # full-precision pages fill whole 16 KiB allocation units, so
            # each band is one contiguous run of the pool
            assert stages["zero_copy_bands"] == 4
        assert eng.lookup_prefix(keys) == 3
        out = eng.load_pages(init_cache(pc, dev), [9, 0, 4], keys)
        got = read_pages(out, torch.tensor([9, 0, 4], device=dev))
        want = pages
        if quant:
            t = pages.permute(0, 3, 1, 2, 4, 5).cpu()
            want = dequantize_pages(quantize_pages(t), pc).permute(
                0, 2, 3, 1, 4, 5)
        assert torch.equal(got.cpu(), want.cpu())
        eng.close()
    finally:
        conn.close()
