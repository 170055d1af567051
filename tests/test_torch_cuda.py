"""The port's CUDA kernels against their plain PyTorch versions, the store
hop's device half (pages through the port's own store server), and the
engine's CUDA-graph decode against its eager step body, on the card.

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
    (32, 2, 4), (32, 1, 16),
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


def _split_rows(lens, T, max_pages, Hkv, n_rep, D, dtype, dev, seed,
                pad_rows=0):
    """K1 inputs with the given row lengths, each row on its own pages
    (``max_pages`` per row), plus ``pad_rows`` pad rows (seq_len 1, every
    entry n_blocks)."""
    rng = np.random.default_rng(seed)
    B = len(lens) + pad_rows
    n_blocks = len(lens) * max_pages + 1
    q = rng.standard_normal((B, Hkv * n_rep, D), np.float32)
    cache = rng.standard_normal((2, Hkv, n_blocks, T, D), np.float32)
    table = np.full((B, max_pages), n_blocks, np.int32)
    perm = rng.permutation(n_blocks)
    for b in range(len(lens)):
        table[b] = perm[b * max_pages:(b + 1) * max_pages]
    seq = np.array(list(lens) + [1] * pad_rows, np.int32)
    return (torch.from_numpy(q).to(dev, dtype),
            torch.from_numpy(cache).to(dev, dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(seq).to(dev))


def _assert_counters_zero():
    """Every stream's merge counters are back at zero."""
    for key, (_ws, counters) in ca._SCRATCH.items():
        assert int(counters.abs().sum()) == 0, key


def _check_k1(q, cache, table, lens, dtype, pad_rows=0):
    """One K1 launch against the plain version; a second launch is
    torch.equal (deterministic merge, counters back at zero); pad rows are
    zero."""
    ca.reset_launches()
    got = ca.paged_decode_attention_cuda(q, cache, table, lens)
    again = ca.paged_decode_attention_cuda(q, cache, table, lens)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["paged_decode"] == 2
    assert torch.equal(got, again)
    _assert_counters_zero()
    _close(got, ca.paged_decode_attention_xla(q, cache, table, lens), dtype)
    if pad_rows:
        assert float(got[-pad_rows:].abs().max()) == 0.0
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_rep", [1, 4, 8, 16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [4, 16, 32])
def test_paged_decode_split_edges(dev, dtype, n_rep, D, T):
    """K1 with rows one token either side of a split edge, on it, and a row
    that fills the whole table (three splits)."""
    split_pages, _ = ca.decode_splits(T, 1)
    S = split_pages * T
    max_pages = 3 * split_pages
    q, cache, table, lens = _split_rows(
        [1, S - 1, S, S + 1, 2 * S + 3, max_pages * T], T, max_pages, 2,
        n_rep, D, dtype, dev, seed=T + D + n_rep, pad_rows=1)
    assert ca.decode_splits(T, max_pages) == (split_pages, 3)
    _check_k1(q, cache, table, lens, dtype, pad_rows=1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_one_long_row(dev, dtype):
    """B=1 with a 2000-token row in a 128-wide table (Llama-3-8B heads):
    the whole card works on one row through eight splits."""
    q, cache, table, lens = _split_rows([2000], 16, 128, 8, 4, 128, dtype,
                                        dev, seed=5)
    _check_k1(q, cache, table, lens, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_only_pad_rows(dev, dtype):
    """A batch of pad rows only (entries n_blocks; seq_len 1, 0 and -3):
    zeros, no cache read."""
    q, cache, table, lens = _split_rows([], 16, 64, 8, 4, 128, dtype, dev,
                                        seed=6, pad_rows=3)
    lens[1], lens[2] = 0, -3
    table[1] = 0  # seq_len <= 0 is a pad row whatever the table says
    got = _check_k1(q, cache, table, lens, dtype, pad_rows=3)
    assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_alllayers_multisplit_equals_per_layer(dev, dtype):
    """K4 with rows of up to four splits is torch.equal to L K1 launches,
    and matches its plain version."""
    L = 3
    q, cache, table, lens = _split_rows([1, 255, 256, 257, 700, 1024], 16,
                                        64, 2, 4, 128, dtype, dev, seed=7,
                                        pad_rows=1)
    g = torch.Generator(device=dev).manual_seed(7)
    qs = torch.randn((L,) + tuple(q.shape), generator=g, device=dev).to(dtype)
    caches = torch.randn((L,) + tuple(cache.shape), generator=g,
                         device=dev).to(dtype)
    got = ca.paged_decode_attention_alllayers_cuda(qs, caches, table, lens)
    per_layer = torch.stack([ca.paged_decode_attention_cuda(
        qs[l], caches[l], table, lens) for l in range(L)])
    torch.cuda.synchronize()
    assert torch.equal(got, per_layer)
    _close(got, ca.paged_decode_attention_alllayers_xla(qs, caches, table,
                                                        lens), dtype)
    assert float(got[:, -1].abs().max()) == 0.0


def test_paged_decode_is_one_kernel_per_call(dev):
    """One K1 call is one kernel on the card: no memset, no second merge
    launch (the profiler sees every kernel)."""
    from torch.profiler import ProfilerActivity, profile

    q, cache, table, lens = _split_rows([1, 300, 1500], 16, 128, 8, 4, 128,
                                        torch.bfloat16, dev, seed=8)
    ca.paged_decode_attention_cuda(q, cache, table, lens)  # sizes the counters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ca.paged_decode_attention_cuda(q, cache, table, lens)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        pytest.fail("the profiler saw no device activity")
    assert len(kernels) == 1 and "paged_decode" in kernels[0].name, \
        [e.name for e in kernels]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_graph_replay(dev, dtype):
    """K1 captured in a CUDA graph, replayed after seq_lens and the table
    change in place; each replay matches the plain version on the inputs
    it saw (the split count depends on the table width only)."""
    T, max_pages = 16, 64
    q, cache, table, lens = _split_rows([1, 40, 300, 700, 1024], T, max_pages,
                                        8, 4, 128, dtype, dev, seed=9,
                                        pad_rows=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: sizes this stream's buffers
        ca.paged_decode_attention_cuda(q, cache, table, lens)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = ca.paged_decode_attention_cuda(q, cache, table, lens)
    rng = np.random.default_rng(10)
    n_blocks = cache.shape[2]
    for step in range(4):
        new_lens = rng.integers(1, max_pages * T + 1, size=lens.shape[0])
        new_lens[-1] = 1
        new_table = np.stack([rng.permutation(n_blocks - 1)[:max_pages]
                              for _ in range(lens.shape[0])]).astype(np.int32)
        new_table[-1] = n_blocks  # the pad row stays a pad row
        lens.copy_(torch.from_numpy(new_lens.astype(np.int32)))
        table.copy_(torch.from_numpy(new_table))
        q.copy_(torch.randn(q.shape, generator=torch.Generator(
            device=dev).manual_seed(step), device=dev).to(dtype))
        graph.replay()
        torch.cuda.synchronize()
        _close(out, ca.paged_decode_attention_xla(q, cache, table, lens),
               dtype)
        assert float(out[-1].abs().max()) == 0.0


def test_paged_decode_two_streams(dev):
    """K1 on two streams at once, many launches each, one multi-split row
    per stream on one KV head (12-16 blocks a launch, so the two streams'
    launches run side by side on the card): each stream takes tickets from
    its own merge counters, so every output matches the plain version on
    its own inputs and both streams' counters end at zero."""
    dtype, n_rounds = torch.bfloat16, 40
    inputs = [_split_rows([n], 16, 128, 1, 4, 128, dtype, dev, seed=11 + i)
              for i, n in enumerate((2000, 1500))]
    g = torch.Generator(device=dev).manual_seed(13)
    qs = [[torch.randn(tuple(x[0].shape), generator=g, device=dev).to(dtype)
           for _ in range(n_rounds)] for x in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:  # both queues fill before either runs
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
    outs = [[], []]
    for r in range(n_rounds):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(ca.paged_decode_attention_cuda(
                    qs[i][r], *inputs[i][1:]))
    torch.cuda.synchronize()
    for i in range(2):
        for q, out in zip(qs[i], outs[i]):
            _close(out, ca.paged_decode_attention_xla(q, *inputs[i][1:]),
                   dtype)
    _assert_counters_zero()
    for x, s in zip(inputs, streams):
        assert (x[0].device, s.cuda_stream) in ca._SCRATCH


# head sizes and query heads per KV head of the flash cases (H_kv = 2)
_FLASH_HEADS = [(32, 2), (64, 1), (64, 2), (64, 4), (64, 8), (128, 1),
                (128, 4), (128, 8)]
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


# ---- the engine's CUDA-graph decode ----

def _engine_parts(dev, cfg=None, n_blocks=96, T=16, seed=0):
    """A scaled-down Llama (2 layers, head_dim 128, bf16) with random
    weights drawn from a seed, on ``dev``, and its cache config."""
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import TINY, init_params, scaled

    cfg = cfg or scaled(TINY, dim=512, n_heads=4, n_kv_heads=2, ffn_dim=1024,
                        dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, n_blocks=n_blocks,
                          block_tokens=T, dtype=cfg.dtype)
    return params, cfg, pc


_PROMPTS = [list(range(3, 40)), [7] * 5, list(range(100, 170)),
            [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]]


def _sampling(variant, extra):
    kw = {"greedy": dict(sample="greedy"),
          "plain": dict(sample=["categorical", "greedy", "categorical",
                                "categorical"], temperature=0.9),
          "filter": dict(sample="categorical", temperature=0.8,
                         top_k=[0, 20, 5, 0], top_p=[0.9, 1.0, 0.8, 0.95]),
          }[variant]
    if extra == "logprobs":
        kw["logprobs"] = 4
    elif extra == "penalized":
        kw.update(presence_penalty=[0.5, 0.0, 0.2, 0.0],
                  repetition_penalty=[1.3, 1.0, 1.1, 2.0],
                  frequency_penalty=0.1,
                  logit_bias=[None, {5: 2.0}, None, {9: -50.0}])
    else:
        kw["seed"] = [11, None, 2 ** 40 + 3, 7]
    return kw


@pytest.mark.parametrize("extra", ["logprobs", "penalized", "seeded"])
@pytest.mark.parametrize("variant", ["greedy", "plain", "filter"])
def test_decode_graph_replay_equals_eager_body(dev, variant, extra):
    """The captured step replayed ``decode_chunk`` times per sync gives the
    same tokens (and logprobs) as the same step body run eagerly, and
    ``torch.equal`` final logits; both batches start from equal states on
    two engines that share the weights."""
    from infinistore_tpu_torch.engine import InferenceEngine

    params, cfg, pc = _engine_parts(dev)
    outs, logits = [], []
    for eager in (True, False):
        eng = InferenceEngine(params, cfg, pc, decode_chunk=4, device=dev)
        states = [eng.prefill(p) for p in _PROMPTS]
        kw = _sampling(variant, extra)
        outs.append(eng._decode_batch(states, 10, eager=eager,
                                      rng=torch.Generator().manual_seed(5),
                                      **kw))
        logits.append(torch.stack([st.last_logits for st in states]))
        assert eng.graph_replays == (0 if eager else 10 - 1)
        assert eng.graph_captures == (0 if eager else 1)
    assert outs[0] == outs[1]
    assert torch.equal(logits[0], logits[1])


def test_decode_graph_one_capture_per_key(dev):
    """A key is captured once; a repeated call replays it; a new batch
    bucket captures its own graph."""
    from infinistore_tpu_torch.engine import InferenceEngine

    params, cfg, pc = _engine_parts(dev)
    eng = InferenceEngine(params, cfg, pc, decode_chunk=4, device=dev)
    states = [eng.prefill(p) for p in _PROMPTS]
    eng.decode_batch(states, 5)
    assert eng.graph_captures == 1 and eng.graph_replays == 4
    eng.decode_batch(states, 7)
    assert eng.graph_captures == 1 and eng.graph_replays == 11
    eng.decode_batch(states[:1], 3)  # batch bucket 1: a key of its own
    assert eng.graph_captures == 2 and len(eng._graphs) == 2
    eng.decode_batch(states[:2], 3, logprobs=2)  # logprobs: another key
    assert eng.graph_captures == 3


def test_decode_graph_counts_k1_launches_per_replay(dev):
    """K1 is counted where it runs: each eager step's layers, and each
    replay of the captured step adds the launches the capture recorded
    (one per layer); the capture itself launches nothing."""
    from infinistore_tpu_torch.engine import InferenceEngine

    params, cfg, pc = _engine_parts(dev)
    eng = InferenceEngine(params, cfg, pc, decode_chunk=8, device=dev)
    states = [eng.prefill(p) for p in _PROMPTS]
    ca.reset_launches()
    eng.decode_batch(states, 8)  # one eager step, capture, 7 replays
    torch.cuda.synchronize()
    assert ca.CAPTURED["paged_decode"] == cfg.n_layers
    assert ca.LAUNCHES["paged_decode"] == 8 * cfg.n_layers
    eng.decode_batch(states, 5)
    assert ca.LAUNCHES["paged_decode"] == 13 * cfg.n_layers
    assert ca.CAPTURED["paged_decode"] == cfg.n_layers


def test_decode_graph_capture_while_store_push_in_flight(dev, store_port):
    """An engine with a store streams a prefill's pages on its streamer
    thread (relaxed durability: prefill returns with pushes queued) and
    captures its first decode graph while they are in flight; the tokens
    equal a store-less engine's eager run, and the pushes land."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM
    from infinistore_tpu_torch.engine import InferenceEngine

    params, cfg, pc = _engine_parts(dev)
    conn = lib.InfinityConnection(ClientConfig(
        host_addr="127.0.0.1", service_port=store_port,
        connection_type=TYPE_SHM))
    conn.connect()
    try:
        eng = InferenceEngine(params, cfg, pc, conn=conn, kv_quant=None,
                              decode_chunk=4, store_durability="relaxed",
                              model_id="cuda-graph-push", device=dev)
        prompts = [list(range(200, 200 + 16 * 12 + 3)), _PROMPTS[2]]
        states = [eng.prefill(p) for p in prompts]
        got = eng.decode_batch(states, 9)
        eng.store_flush()
        assert eng.graph_captures == 1
        ref = InferenceEngine(params, cfg, pc, decode_chunk=4, device=dev)
        want = ref._decode_batch([ref.prefill(p) for p in prompts], 9,
                                 eager=True)
        assert got == want
        assert eng.transfer.lookup_prefix(states[0].chunk_keys[:12]) == 12
        eng.transfer.close()
    finally:
        conn.close()


@pytest.mark.parametrize("family", ["mistral_window", "gemma2_softcap"])
def test_window_and_softcap_configs_run_on_the_card(dev, family):
    """Sliding-window (Mistral) and soft-capped (Gemma-2) configurations,
    which route to the plain attention on every device as the reference
    routes them, serve on the card (graph-captured decode included) and
    agree with the same model on the CPU: logits cosine >= 0.999 and max
    error <= 2e-2 of max |logit| in bf16."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import TINY, scaled

    kw = dict(mistral_window=dict(sliding_window=24, window_pattern=1),
              gemma2_softcap=dict(
                  act="gelu_tanh", attn_softcap=50.0, final_softcap=30.0,
                  norm_offset=True, post_norms=True, embed_scale=True,
                  query_pre_attn_scalar=64.0, sliding_window=24,
                  window_pattern=2))[family]
    cfg = scaled(TINY, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=512,
                 head_dim_override=64, dtype=torch.bfloat16, **kw)
    cpu = torch.device("cpu")
    params, _, pc = _engine_parts(cpu, cfg=cfg)
    got = {}
    for d in (cpu, dev):
        eng = InferenceEngine({k: (v.to(d) if k != "layers" else
                                   {n: t.to(d) for n, t in v.items()})
                               for k, v in params.items()},
                              cfg, pc, decode_chunk=4, device=d)
        st = eng.prefill(_PROMPTS[2])
        first = st.last_logits.float().cpu()
        eng.decode_batch([st], 6, sample="greedy")
        got[d.type] = (first, eng, st)
    ref, card = got["cpu"][0], got["cuda"][0]
    cos = torch.nn.functional.cosine_similarity(ref, card, dim=0).item()
    err = (ref - card).abs().max().item()
    assert cos >= 0.999 and err <= 2e-2 * ref.abs().max().item(), (cos, err)
    assert got["cuda"][1].graph_replays > 0
    if family == "mistral_window":  # window-dead pages went back
        assert got["cuda"][2].reclaimed_pages == got["cpu"][2].reclaimed_pages
