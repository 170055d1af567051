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


def _store_server(backend):
    """The port's own store server (``backend``) in a subprocess: yields
    its service port."""
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
         "--log-level", "warning", "--backend", backend],
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


@pytest.fixture(scope="module")
def store_port():
    """The port's own store server (asyncio backend) in a subprocess."""
    yield from _store_server("python")


@pytest.fixture(scope="module")
def native_store_port():
    """The port's own store server on the native runtime."""
    yield from _store_server("native")


@pytest.mark.parametrize("transport", ["shm", "tcp"])
@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_store_hop_on_the_card(dev, store_port, transport, quant, dtype,
                               monkeypatch):
    """Pages saved from a cache on the card load back into another cache on
    the card byte for byte (int8: exactly the plain quantize round trip, so
    the card quantizes to the same bytes as the CPU); on shm every
    full-precision band of the Python client lands straight in the
    page-locked pool."""
    monkeypatch.setenv("ISTPU_CLIENT", "python")
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


# ---- the store cluster's device half ----

@pytest.fixture
def store_ring():
    """Three of the port's store servers (asyncio backend) in subprocesses:
    yields their endpoints and processes (a case kills one by process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pathlib
    import socket
    import subprocess
    import sys
    import time

    procs, eps = [], []
    try:
        for _ in range(3):
            port, mport = _free_port(), _free_port()
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "infinistore_tpu_torch.server",
                 "--service-port", str(port), "--manage-port", str(mport),
                 "--prealloc-size", "1", "--minimal-allocate-size", "16",
                 "--log-level", "warning", "--backend", "python"],
                cwd=pathlib.Path(__file__).resolve().parents[1]))
            eps.append(f"127.0.0.1:{port}")
        deadline = time.time() + 60
        for ep, proc in zip(eps, procs):
            while True:
                assert proc.poll() is None, "store server exited"
                try:
                    socket.create_connection(
                        ("127.0.0.1", int(ep.rsplit(":", 1)[1])),
                        timeout=0.5).close()
                    break
                except OSError:
                    assert time.time() < deadline, "store did not come up"
                    time.sleep(0.2)
        yield eps, procs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_cluster_hop_on_the_card(dev, store_ring, quant, monkeypatch):
    """``ClusterTransferEngine`` over three of the port's store nodes
    (every chunk pinned, so on two of them): pages saved from a cache on
    the card load back byte for byte, through back-to-back loads whose
    node groups differ in size, issued from a side stream with no sync
    between them (each group's uploads run on its node's load stream, so
    the scatter must wait on them and no staging slot may be rewritten
    while a copy out of it runs); then the node owning most chunks is
    killed and the replicas serve the whole prefix."""
    monkeypatch.setenv("ISTPU_CLIENT", "python")
    from infinistore_tpu_torch.cluster import (ClusterTransferEngine,
                                               RoutedStorePool)
    from infinistore_tpu_torch.kv import (
        PagedCacheConfig, chunk_keys, dequantize_pages, init_cache,
        quantize_pages, read_pages, write_pages)

    eps, procs = store_ring
    n = 24
    pc = PagedCacheConfig(n_layers=4, n_kv_heads=8, head_dim=128,
                          n_blocks=64, block_tokens=16, dtype=torch.bfloat16)
    pool = RoutedStorePool(eps, replicas=2, op_timeout_s=10.0)
    try:
        eng = ClusterTransferEngine(pool, pc, quant=quant, device=dev)
        g = torch.Generator(device=dev).manual_seed(11)
        pages = torch.randn((4, 2, 8, n, 16, 128), generator=g,
                            device=dev).to(torch.bfloat16)
        src_ids = list(range(40, 40 + n))
        cache = write_pages(init_cache(pc, dev),
                            torch.tensor(src_ids, device=dev), pages)
        want = pages
        if quant:
            t = pages.permute(0, 3, 1, 2, 4, 5).cpu()
            want = dequantize_pages(quantize_pages(t), pc).permute(
                0, 2, 3, 1, 4, 5).to(dev)
        keys = chunk_keys(list(range(n * 16)), f"cuda-ring-{quant}")
        pool.pin(keys)
        eng.save_pages(cache, src_ids, keys)
        assert eng.last_push_stages["nodes"] == 3
        assert eng.last_push_stages["failed_nodes"] == 0
        if quant is None:
            # full-precision pages fill whole allocation units: the pushes
            # land in the pools, each page-locked once
            assert eng.pinned_bytes()["pools"] > 0
        assert eng.lookup_prefix(keys) == n
        # back-to-back loads of differently sized node groups, from a side
        # stream, no host sync in between
        subsets = [list(range(n)), list(range(5)), list(range(3, 20)),
                   [0, 23], list(range(n))]
        side = torch.cuda.Stream()
        outs = []
        with torch.cuda.stream(side):
            for sub in subsets:
                dst = list(range(len(sub)))
                out = eng.load_pages(init_cache(pc, dev), dst,
                                     [keys[i] for i in sub])
                outs.append((sub, dst, out))
                assert eng.last_load_stages["nodes"] >= 1
        torch.cuda.synchronize()
        for sub, dst, out in outs:
            got = read_pages(out, torch.tensor(dst, device=dev))
            assert torch.equal(got, want[:, :, :, sub])
        # kill the node that owns the most chunks; replicas serve them all
        owners = [pool.ring.owner(k) for k in keys]
        victim = max(eps, key=owners.count)
        procs[eps.index(victim)].kill()
        procs[eps.index(victim)].wait(timeout=20)
        out, ok = eng.guarded_load(init_cache(pc, dev), list(range(n)), keys)
        assert ok
        assert torch.equal(read_pages(out, torch.tensor(
            list(range(n)), device=dev)), want)
        rep = pool.report()
        assert rep["replica_reads"]["hit"] >= 1
        by_ep = {x["endpoint"]: x for x in rep["nodes"]}
        assert by_ep[victim]["requests"]["error"] >= 1
        assert all(by_ep[ep]["requests"]["error"] == 0
                   for ep in eps if ep != victim)
        eng.close()
    finally:
        pool.close()


# ---- the engine's CUDA-graph decode ----

@pytest.mark.parametrize("quant", [None, "int8"])
def test_native_runtime_lands_the_python_runtimes_bytes(
        dev, store_port, native_store_port, quant, monkeypatch):
    """The same pages pushed from the card over shm through the native
    runtime (the port's native server and client: the pinned push ring,
    the client's striped copies) and through the Python one load back into
    caches on the card that are ``torch.equal``, untouched pages
    included."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM
    from infinistore_tpu_torch.kv import (
        KVTransferEngine, PagedCacheConfig, chunk_keys, init_cache,
        read_pages, write_pages)

    pc = PagedCacheConfig(n_layers=4, n_kv_heads=8, head_dim=128,
                          n_blocks=16, block_tokens=16, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(5)
    pages = torch.randn((4, 2, 8, 5, 16, 128), generator=g,
                        device=dev).to(torch.bfloat16)
    src = write_pages(init_cache(pc, dev),
                      torch.tensor([2, 7, 5, 11, 0], device=dev), pages)
    got = {}
    for runtime, port in (("python", store_port),
                          ("native", native_store_port)):
        monkeypatch.setenv("ISTPU_CLIENT", runtime)
        conn = lib.InfinityConnection(ClientConfig(
            host_addr="127.0.0.1", service_port=port,
            connection_type=TYPE_SHM))
        conn.connect()
        try:
            assert (type(conn.conn).__name__ == "NativeConnection") == (
                runtime == "native")
            eng = KVTransferEngine(conn, pc, quant=quant, device=dev)
            keys = chunk_keys(list(range(80)), f"cuda-rt-{runtime}-{quant}")
            eng.save_pages(src, [2, 7, 5, 11, 0], keys)
            if runtime == "native":
                assert eng.last_push_stages["staged_bands"] == 4
            assert eng.lookup_prefix(keys) == 5
            got[runtime] = eng.load_pages(init_cache(pc, dev),
                                          [9, 0, 4, 13, 1], keys)
            eng.close()
        finally:
            conn.close()
    torch.cuda.synchronize()
    assert torch.equal(got["native"], got["python"])
    if quant is None:
        assert torch.equal(read_pages(got["native"], torch.tensor(
            [9, 0, 4, 13, 1], device=dev)), pages)


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
        assert eng.graph_replays["decode"] == (0 if eager else 10 - 1)
        assert eng.graph_captures["decode"] == (0 if eager else 1)
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
    assert eng.graph_captures["decode"] == 1
    assert eng.graph_replays["decode"] == 4
    eng.decode_batch(states, 7)
    assert eng.graph_captures["decode"] == 1
    assert eng.graph_replays["decode"] == 11
    eng.decode_batch(states[:1], 3)  # batch bucket 1: a key of its own
    assert eng.graph_captures["decode"] == 2 and len(eng._graphs) == 2
    eng.decode_batch(states[:2], 3, logprobs=2)  # logprobs: another key
    assert eng.graph_captures["decode"] == 3


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
        assert eng.graph_captures["decode"] == 1
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
    assert got["cuda"][1].graph_replays["decode"] > 0
    if family == "mistral_window":  # window-dead pages went back
        assert got["cuda"][2].reclaimed_pages == got["cpu"][2].reclaimed_pages


# ---- K2's device prefix_len and the engine's CUDA-graph prefill ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,n_rep", [(32, 2), (128, 4)])
def test_k2_graph_replay_across_lengths_equals_host_int(dev, dtype, D, n_rep):
    """One K2 launch captured with a device ``prefix_len``, the length
    changed in place between replays: each replay is ``torch.equal`` to
    the host-int launch at that length and agrees with the plain
    version."""
    pad, Sq = 1024, 512
    q, k, v = _flash_inputs(3, 1, Sq, pad + Sq, n_rep, D, dtype, dev)
    plen = torch.zeros((), dtype=torch.int32, device=dev)
    ca.flash_prefix_attention_cuda(q, k, v, pad, plen)  # first call: set-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ca.flash_prefix_attention_cuda(q, k, v, pad, plen)
    for n in (0, 1, 127, 128, 129, pad):
        plen.fill_(n)
        graph.replay()
        want = ca.flash_prefix_attention_cuda(q, k, v, pad, n)
        torch.cuda.synchronize()
        assert torch.equal(out, want), n
        _close(out, ca.causal_attention_xla(q, k, v, prefix_pad=pad,
                                            prefix_len=plen), dtype)


def test_k2_device_prefix_len_is_checked(dev):
    q, k, v = _flash_inputs(0, 1, 8, 24, 2, 64, torch.bfloat16, dev)
    with pytest.raises(TypeError):
        ca.flash_prefix_attention_cuda(
            q, k, v, 16, torch.zeros((), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        ca.flash_prefix_attention_cuda(
            q, k, v, 16, torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError):
        ca.flash_prefix_attention_cuda(q, k, v, 16, 17)


def test_prefill_graph_replay_equals_eager_body(dev):
    """Two engines on the same weights prefill the same prompts (1 to 4
    chunks of 64 with ragged tails, two rounds of fresh tokens), one
    through the prefill graphs and one through the same chunk body run
    eagerly: every chunk's logits and KV are ``torch.equal``, for every key
    (K3 first chunks, K2 over 64-, 128- and 256-row buffers), and so are
    the pages and the first-token logits."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import read_pages

    params, cfg, pc = _engine_parts(dev, n_blocks=64)
    lengths = [20, 64 + 37, 128 + 60, 3 * 64 + 5]
    runs = {}
    for eager in (True, False):
        eng = InferenceEngine(params, cfg, pc, prefill_chunk=64, device=dev)
        chunks, firsts, pages = [], [], []
        body = eng._prefill_chunk

        def spy(pp, chunk, last, e, body=body, chunks=chunks):
            logits, kv = body(pp, chunk, last, e)
            chunks.append((logits.clone(), kv.clone()))
            return logits, kv

        eng._prefill_chunk = spy
        for rnd in range(2):
            for i, n in enumerate(lengths):
                p = np.random.default_rng(10 * rnd + i).integers(
                    0, cfg.vocab_size, n).tolist()
                pp = eng.prefill_start(p)
                st = None
                while st is None:
                    st = eng.prefill_step(pp, eager=eager)
                firsts.append(st.last_logits)
                pages.append(read_pages(eng.cache, torch.tensor(
                    st.block_ids, device=dev)))
                eng.release(st)
        torch.cuda.synchronize()
        runs[eager] = (eng, chunks, firsts, pages)
    eng, chunks, firsts, pages = runs[False]
    assert set(eng._prefill_graphs) == {
        ("causal", 0, 32), ("causal", 0, 64), ("prefix", 64, 64),
        ("prefix", 128, 64), ("prefix", 256, 16)}
    assert eng.graph_captures["prefill"] == 5
    assert eng.graph_replays["prefill"] == 20 - 5
    assert runs[True][0].graph_captures["prefill"] == 0
    assert runs[True][0].graph_replays["prefill"] == 0
    assert eng.graph_launches("prefill")["flash_causal"] > 0
    assert eng.graph_launches("prefill")["flash_prefix"] > 0
    for name, a, b in (("chunks", runs[True][1], chunks),
                       ("first-token logits", runs[True][2], firsts),
                       ("pages", runs[True][3], pages)):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            xs, ys = (x, y) if isinstance(x, tuple) else ((x,), (y,))
            assert all(torch.equal(s, t) for s, t in zip(xs, ys)), (name, i)


def test_prefill_graph_counts_kernels_per_replay(dev):
    """A replayed prefill graph adds the K3/K2 launches its capture
    recorded (one per layer); the capture itself launches nothing."""
    from infinistore_tpu_torch.engine import InferenceEngine

    params, cfg, pc = _engine_parts(dev)
    eng = InferenceEngine(params, cfg, pc, prefill_chunk=64, device=dev)
    rng = np.random.default_rng(0)
    eng.release(eng.prefill(rng.integers(0, 500, 100).tolist()))  # captures
    ca.reset_launches()
    eng.release(eng.prefill(rng.integers(0, 500, 100).tolist()))  # replays
    torch.cuda.synchronize()
    assert ca.LAUNCHES["flash_causal"] == cfg.n_layers
    assert ca.LAUNCHES["flash_prefix"] == cfg.n_layers
    # the graph hands K2 its length as a device tensor
    assert ca.LAUNCHES["flash_prefix_device_len"] == cfg.n_layers
    assert ca.CAPTURED == dict.fromkeys(ca.KERNELS, 0)
    assert eng.graph_replays["prefill"] == 2


def test_whole_prompt_prefill_replays_no_graph(dev):
    """``prefill_chunk`` None runs the whole prompt in one eager forward at
    its own length: no prefill-graph key, no replay, K3 launched once per
    layer, the LM head at the last row only."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import prefill_forward

    params, cfg, pc = _engine_parts(dev)
    eng = InferenceEngine(params, cfg, pc, device=dev)
    p = np.random.default_rng(3).integers(0, 500, 150).tolist()
    ca.reset_launches()
    st = eng.prefill(p)
    torch.cuda.synchronize()
    assert not eng._prefill_graphs
    assert eng.graph_captures["prefill"] == eng.graph_replays["prefill"] == 0
    assert ca.LAUNCHES["flash_causal"] == cfg.n_layers
    assert ca.LAUNCHES["flash_prefix"] == 0
    padded = p + [0] * ((-len(p)) % pc.block_tokens)
    full, _ = prefill_forward(params, cfg, torch.tensor(
        [padded], dtype=torch.int32, device=dev))
    _close(st.last_logits, full[0, len(p) - 1], torch.bfloat16)


def test_adopted_tail_replay_equals_eager_body(dev):
    """The single chunk over an exact prefix (the decode worker's tail
    after a handoff: ``prefill_chunk`` None) of 1, 16, 93 and 128 pages,
    two rounds of fresh tails: through the prefill graphs of keys
    ("prefix", 16, 16), ("prefix", 256, 16) and ("prefix", 2048, 16) and
    through the same body run eagerly, every chunk's logits and KV, the
    pages and the first-token logits are ``torch.equal``; the replays
    launch K2 with a device length."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import read_pages

    params, cfg, pc = _engine_parts(dev, n_blocks=640)
    adopted = [1, 16, 93, 128]
    runs = {}
    for eager in (True, False):
        eng = InferenceEngine(params, cfg, pc, device=dev)
        chunks, firsts, pages = [], [], []
        body = eng._prefill_chunk

        def spy(pp, chunk, last, e, body=body, chunks=chunks):
            logits, kv = body(pp, chunk, last, e)
            chunks.append((logits.clone(), kv.clone()))
            return logits, kv

        eng._prefill_chunk = spy
        rng = np.random.default_rng(7)
        bases = [rng.integers(0, cfg.vocab_size, n * 16).tolist()
                 for n in adopted]
        for b in bases:  # whole-prompt forwards: the pages to adopt
            eng.release(eng.prefill(b))
        ca.reset_launches()
        for rnd in range(2):
            for b in bases:
                p = b + rng.integers(0, cfg.vocab_size, 1 + 5 * rnd).tolist()
                pp = eng.prefill_start(p)
                assert pp.single and pp.reused == len(b) // 16
                st = None
                while st is None:
                    st = eng.prefill_step(pp, eager=eager)
                firsts.append(st.last_logits)
                pages.append(read_pages(eng.cache, torch.tensor(
                    st.block_ids, device=dev)))
                eng.release(st)
        torch.cuda.synchronize()
        runs[eager] = (eng, chunks, firsts, pages, dict(ca.LAUNCHES))
    eng, chunks, firsts, pages, launches = runs[False]
    assert set(eng._prefill_graphs) == {
        ("prefix", 16, 16), ("prefix", 256, 16), ("prefix", 2048, 16)}
    assert eng.graph_captures["prefill"] == 3
    assert eng.graph_replays["prefill"] == 8 - 3
    assert runs[True][0].graph_replays["prefill"] == 0
    assert eng.graph_launches("prefill")["flash_prefix"] == 5 * cfg.n_layers
    assert launches["flash_prefix_device_len"] == 8 * cfg.n_layers
    for name, a, b in (("chunks", runs[True][1], chunks),
                       ("first-token logits", runs[True][2], firsts),
                       ("pages", runs[True][3], pages)):
        assert len(a) == len(b) == 8
        for i, (x, y) in enumerate(zip(a, b)):
            xs, ys = (x, y) if isinstance(x, tuple) else ((x,), (y,))
            assert all(torch.equal(s, t) for s, t in zip(xs, ys)), (name, i)


# ---- speculative decoding: the round graphs on the card ----


def _spec_parts(dev, dtype=torch.bfloat16):
    """A target (the scaled-down Llama of ``_engine_parts``, head size 128)
    and a draft with head size 64 (H = 8, H_kv = 2, one layer), both from
    seeds, and their cache configs (16-token pages)."""
    from infinistore_tpu_torch.models import TINY, scaled

    params, cfg, pc = _engine_parts(dev, cfg=scaled(
        TINY, dim=512, n_heads=4, n_kv_heads=2, ffn_dim=1024, dtype=dtype))
    dparams, dcfg, dpc = _engine_parts(dev, cfg=scaled(
        TINY, dim=512, n_heads=8, n_kv_heads=2, n_layers=1, ffn_dim=512,
        dtype=dtype), seed=1)
    assert dcfg.head_dim == 64 and cfg.head_dim == 128
    return (params, cfg, pc), (dparams, dcfg, dpc)


@pytest.mark.parametrize("variant", ["greedy", "filter"])
def test_spec_round_graph_replay_equals_eager_body(dev, variant):
    """Four rows of different lengths through the draft-model round
    graphs: every key's replay is
    ``torch.equal`` to its eager round body from the same buffers and
    pages; each key captured its round once (one eager round, then
    replays), and the round graph holds K1 at the draft's head size."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.engine.speculative import SpeculativeDecoder

    (params, cfg, pc), (dparams, dcfg, dpc) = _spec_parts(dev)
    spec = SpeculativeDecoder(InferenceEngine(params, cfg, pc, device=dev),
                              InferenceEngine(dparams, dcfg, dpc, device=dev),
                              k=3)
    st_ts, st_ds = zip(*[spec.prefill(p) for p in _PROMPTS])
    kw = {} if variant == "greedy" else dict(
        sample="categorical", temperature=0.8, top_k=[0, 20, 5, 0],
        top_p=[0.9, 1.0, 0.8, 0.95], rng=torch.Generator().manual_seed(3))
    outs = spec.decode_batch(list(st_ts), list(st_ds), 24, **kw)
    torch.cuda.synchronize()
    assert all(len(o) == 24 for o in outs)
    assert spec.target.graph_captures["spec"] == 2 * len(spec._graphs)
    for key, g in spec._graphs.items():
        assert key[-1] == variant and g.round.eager == 1
        assert g.round.captured["paged_decode"] == 3 * dcfg.n_layers
        assert spec.round_replay_equals_eager(key), key


def test_ngram_round_graph_replay_equals_eager_body(dev):
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.engine.ngram import NgramSpeculator

    params, cfg, pc = _engine_parts(dev)
    spec = NgramSpeculator(InferenceEngine(params, cfg, pc, device=dev),
                           k=4, g=2)
    sts = [spec.prefill(p) for p in _PROMPTS]
    spec.decode_batch(sts, 20)
    torch.cuda.synchronize()
    assert spec._graphs
    for key, g in spec._graphs.items():
        assert g.round.eager == 1 and "paged_decode" not in g.round.captured
        assert spec.round_replay_equals_eager(key), key


@pytest.mark.parametrize("mode", ["draft", "self", "ngram", "batch4"])
def test_greedy_speculation_equals_plain_decode_on_the_card(dev, mode):
    """f32 TINY (head size 32): greedy speculation through the round
    graphs (a draft model, the target's own weights, n-gram proposals, four
    rows at once) emits exactly the plain graph decode's tokens."""
    from infinistore_tpu_torch.engine import InferenceEngine, Scheduler
    from infinistore_tpu_torch.models import TINY, scaled

    params, cfg, pc = _engine_parts(dev, cfg=scaled(TINY, dtype=torch.float32),
                                    T=4)
    dparams, dcfg, dpc = _engine_parts(dev, cfg=scaled(
        TINY, dtype=torch.float32, n_layers=1), T=4, seed=1)
    prompts = _PROMPTS if mode == "batch4" else _PROMPTS[:1]
    plain = Scheduler(InferenceEngine(params, cfg, pc, device=dev),
                      max_batch=4)
    rids = [plain.submit(p, max_new_tokens=40) for p in prompts]
    got = plain.run()
    want = [got[r] for r in rids]
    target = InferenceEngine(params, cfg, pc, device=dev)
    if mode == "ngram":
        sched = Scheduler(target, ngram_spec=True, spec_k=4, spec_g=2)
    else:
        draft = (InferenceEngine(params, cfg, pc, device=dev) if mode == "self"
                 else InferenceEngine(dparams, dcfg, dpc, device=dev))
        sched = Scheduler(target, draft_engine=draft, spec_k=3,
                          spec_batch=4 if mode == "batch4" else 1,
                          max_batch=4)
    rids = [sched.submit(p, max_new_tokens=40) for p in prompts]
    got = sched.run()
    assert [got[r] for r in rids] == want
    assert sched.spec.rounds > 0 and sched.spec._graphs
    assert target.graph_replays["spec"] > 0
    if mode == "self":
        assert sched.spec.acceptance_rate == 1.0


def test_round_graph_captured_beside_both_engines_decode_graphs(dev):
    """The target and the draft each hold a captured decode graph (each on
    its own stream and pool); a round graph captured on the target's
    stream after them, reading and writing both caches, still gives the
    plain decode's tokens, and both engines' decode graphs replay
    correctly after it."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.engine.speculative import SpeculativeDecoder

    (params, cfg, pc), (dparams, dcfg, dpc) = _spec_parts(
        dev, dtype=torch.float32)
    ref = InferenceEngine(params, cfg, pc, device=dev)
    want = ref.decode(ref.prefill(_PROMPTS[0]), 30)
    target = InferenceEngine(params, cfg, pc, device=dev)
    draft = InferenceEngine(dparams, dcfg, dpc, device=dev)
    for eng in (target, draft):
        eng.decode(eng.prefill(_PROMPTS[2]), 6)  # a captured decode graph
        assert eng.graph_captures["decode"] == 1
    spec = SpeculativeDecoder(target, draft, k=3)
    st_t, st_d = spec.prefill(_PROMPTS[0])
    got = spec.decode(st_t, st_d, 20)
    assert target.graph_captures["spec"] == 2
    got += target.decode(st_t, 10)  # the target's decode graph after it
    assert got == want
    dref = InferenceEngine(dparams, dcfg, dpc, device=dev)
    st_d2 = draft.prefill(_PROMPTS[3])
    assert draft.decode(st_d2, 6) == dref.decode(dref.prefill(_PROMPTS[3]),
                                                 6)


def test_host_round_loop_on_the_card(dev):
    """A prompt shorter than k+2 takes the host round loop: greedy, it
    gives the plain decode's tokens (f32); sampled, the draft's ``propose``
    replays the decode graph's collecting form (its distributions sum to
    1) and every token is in the vocabulary."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.engine.speculative import SpeculativeDecoder

    (params, cfg, pc), (dparams, dcfg, dpc) = _spec_parts(
        dev, dtype=torch.float32)
    ref = InferenceEngine(params, cfg, pc, device=dev)
    want = ref.decode(ref.prefill([7, 9, 11]), 12)
    spec = SpeculativeDecoder(InferenceEngine(params, cfg, pc, device=dev),
                              InferenceEngine(dparams, dcfg, dpc, device=dev),
                              k=4)
    assert spec.generate([7, 9, 11], 12) == want
    assert spec.rounds > 0 and not spec._graphs
    st = spec.draft.prefill([5, 6, 7])
    toks, q = spec.draft.propose(st, 4, temperature=0.8, top_p=0.9,
                                 rng=torch.Generator().manual_seed(2))
    torch.testing.assert_close(q.sum(-1), torch.ones(4, device=dev))
    assert any(key[-1] and g.graph is not None  # the collecting key
               for key, g in spec.draft._graphs.items())
    out = spec.generate([3, 4], 10, sample="categorical", temperature=0.8,
                        rng=torch.Generator().manual_seed(4))
    assert len(out) == 10 and all(0 <= t < cfg.vocab_size for t in out)


def test_capture_survives_a_collectable_engine_with_graphs(dev):
    """An engine that holds captured decode graphs loses its last
    reference to a fresh reference cycle while another engine captures,
    with the cyclic garbage collector made to run at every allocation:
    a collection inside the capture would free the engine and destroy its
    graphs on the capturing thread, which invalidates the capture.  The
    capture must succeed, and the engine is freed after it."""
    import gc
    import weakref

    from infinistore_tpu_torch.engine import InferenceEngine

    params, cfg, pc = _engine_parts(dev)
    old = InferenceEngine(params, cfg, pc, decode_chunk=4, device=dev)
    old.decode(old.prefill(_PROMPTS[0]), 6)
    assert old.graph_captures["decode"] == 1
    gone = weakref.ref(old)
    keep = [old]
    del old
    eng = InferenceEngine(params, cfg, pc, decode_chunk=4, device=dev)
    st = eng.prefill(_PROMPTS[1])
    step = eng._step

    def dropping_step(g):
        if torch.cuda.is_current_stream_capturing() and keep:
            box = {"engine": keep.pop()}
            box["self"] = box  # only the cyclic collector frees it
            del box
        step(g)

    eng._step = dropping_step
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        out = eng.decode(st, 6)  # one eager step, a capture, replays
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert eng.graph_captures["decode"] == 1 and len(out) == 6
    assert not keep and gc.isenabled()
    gc.collect()
    assert gone() is None


def test_capture_holds_the_cyclic_collector_off(dev):
    """A collection inside a capture that frees an unreachable engine
    destroys its CUDA graphs on the capturing thread, which invalidates
    the capture ("operation failed due to a previous error during
    capture").  So the collector is off while a decode step is captured,
    and on again after, while the graph replays."""
    import gc

    from infinistore_tpu_torch.engine import InferenceEngine

    params, cfg, pc = _engine_parts(dev)
    eng = InferenceEngine(params, cfg, pc, decode_chunk=4, device=dev)
    st = eng.prefill(_PROMPTS[1])
    step = eng._step
    seen = []

    def watching_step(g):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        step(g)

    eng._step = watching_step
    assert gc.isenabled()
    out = eng.decode(st, 6)  # one eager step, a capture, replays
    torch.cuda.synchronize()
    assert eng.graph_captures["decode"] == 1 and len(out) == 6
    assert seen == [(False, True), (True, False)]
    assert gc.isenabled()


# ---- the LoRA and MoE paths on the card ----


def _on(params, d):
    return {k: (v.to(d) if k != "layers" else
                {n: t.to(d) for n, t in v.items()})
            for k, v in params.items()}


@pytest.mark.parametrize("family", ["moe", "lora"])
def test_moe_and_lora_serve_on_the_card_through_the_kernels(dev, family):
    """TINY_MOE, and TINY with a LoRA bank (a batch mixing adapters 0-2),
    in float32: on the card the engine launches K3 (a cold first chunk), K2
    (later chunks over their prefix) and K1 (the decode graphs' replays),
    and its greedy tokens equal the same model's on the CPU, where the
    plain versions run."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import TINY, TINY_MOE, scaled
    from infinistore_tpu_torch.models.lora import LoraBank, init_lora_bank
    from infinistore_tpu_torch.models.moe import (init_moe_params,
                                                  moe_decode_forward,
                                                  moe_prefill_forward)

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    kw, aids = {}, [0] * len(_PROMPTS)
    if family == "moe":
        cfg = scaled(TINY_MOE, dtype=torch.float32)
        params = init_moe_params(cfg, gen, cpu)
        kw = dict(prefill_fn=moe_prefill_forward, decode_fn=moe_decode_forward)
    else:
        from infinistore_tpu_torch.models import init_params

        cfg = scaled(TINY, dtype=torch.float32)
        params = init_params(cfg, gen, cpu)
        bank = init_lora_bank(cfg, ["a", "b"], 4, gen, cpu, init_scale=0.5)
        aids = [1, 2, 0, 1]
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, n_blocks=96,
                          block_tokens=16, dtype=cfg.dtype)
    got = {}
    for d in (cpu, dev):
        if family == "lora":
            kw = dict(lora=LoraBank({t: (A.to(d), B.to(d)) for t, (A, B)
                                     in bank.tree.items()},
                                    bank.names, bank.scale))
        ca.reset_launches()
        eng = InferenceEngine(_on(params, d), cfg, pc, prefill_chunk=32,
                              decode_chunk=4, device=d, **kw)
        states = [eng.prefill(p, adapter_id=a)
                  for p, a in zip(_PROMPTS, aids)]
        toks = eng.decode_batch(states, 9)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert eng.graph_replays["decode"] > 0
            assert eng.graph_replays["prefill"] > 0
        got[d.type] = (toks, dict(ca.LAUNCHES))
    assert not any(got["cpu"][1].values())
    launches = got["cuda"][1]
    assert all(launches[k] > 0 for k in ("flash_causal", "flash_prefix",
                                         "paged_decode")), launches
    assert got["cuda"][0] == got["cpu"][0]
    ca.reset_launches()


def _lora_engine(dev, bank=None, **kw):
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models.lora import init_lora_bank

    params, cfg, pc = _engine_parts(dev)
    bank = bank or init_lora_bank(
        cfg, ["a", "b"], 8, torch.Generator(device=dev).manual_seed(1), dev,
        init_scale=0.5)
    return InferenceEngine(params, cfg, pc, lora=bank, device=dev, **kw), bank


def test_decode_graph_replays_follow_the_adapter_vector(dev):
    """Two decode calls on one key (B = 4, one table width) with different
    adapter vectors: the second replays the first one's graph, and each
    gives the tokens and ``torch.equal`` logits of the eager step body on
    a second engine over the same weights and bank."""
    graph, bank = _lora_engine(dev, decode_chunk=4)
    eager, _ = _lora_engine(dev, bank=bank, decode_chunk=4)
    eager.params = graph.params
    for vec in ([1, 2, 0, 1], [2, 0, 1, 2]):
        outs, logits = [], []
        for eng, is_eager in ((eager, True), (graph, False)):
            states = [eng.prefill(p, adapter_id=a)
                      for p, a in zip(_PROMPTS, vec)]
            outs.append(eng._decode_batch(states, 8, eager=is_eager))
            logits.append(torch.stack([st.last_logits for st in states]))
            for st in states:
                eng.release(st)
        assert outs[0] == outs[1], vec
        assert torch.equal(logits[0], logits[1]), vec
    assert graph.graph_captures["decode"] == 1 and len(graph._graphs) == 1
    (key,) = graph._graphs
    # the first call: an eager step, the capture, 7 replays; the second: 8
    assert key[-1] == "lora" and graph.graph_replays["decode"] == 7 + 8


def test_bank_rebuilt_after_capture_raises_at_replay(dev):
    """A graph holds the bank's tensors by address: after the engine's
    bank is rebuilt (same values, new tensors) a replay of a decode or a
    prefill graph captured before raises instead of reading freed
    memory."""
    from infinistore_tpu_torch.models.lora import LoraBank

    eng, bank = _lora_engine(dev, decode_chunk=4, prefill_chunk=32)
    st = eng.prefill(_PROMPTS[2], adapter_id=1)  # 3 chunks: captures
    eng.decode(st, 6)
    assert eng.graph_captures["decode"] == 1
    assert eng.graph_captures["prefill"] >= 2
    eng.lora = LoraBank({t: (A.clone(), B.clone())
                         for t, (A, B) in bank.tree.items()},
                        bank.names, bank.scale)
    with pytest.raises(RuntimeError, match="LoRA bank moved"):
        eng.decode(st, 4)
    with pytest.raises(RuntimeError, match="LoRA bank moved"):
        eng.prefill(_PROMPTS[0], adapter_id=2)


def _write_checkpoint(path, kind):
    """A checkpoint directory as ``save_pretrained`` lays it out (a
    ``config.json`` and one ``model.safetensors``), written without
    ``transformers``: a Llama or a Mixtral of head size 32, random bf16
    weights from a seed."""
    import json

    D, F, L, E, V = 128, 256, 2, 4, 256
    cfg = dict(model_type=kind, vocab_size=V, hidden_size=D,
               intermediate_size=F, num_hidden_layers=L,
               num_attention_heads=4, num_key_value_heads=2,
               rms_norm_eps=1e-5, rope_theta=10000.0)
    gen = torch.Generator().manual_seed(21)

    def w(*shape):
        return (torch.randn(shape, generator=gen) * 3 / shape[-1] ** 0.5
                ).to(torch.bfloat16)

    st = {"model.embed_tokens.weight": w(V, D), "lm_head.weight": w(V, D),
          "model.norm.weight": torch.ones(D, dtype=torch.bfloat16)}
    for li in range(L):
        p = f"model.layers.{li}."
        st.update({p + "self_attn.q_proj.weight": w(128, D),
                   p + "self_attn.k_proj.weight": w(64, D),
                   p + "self_attn.v_proj.weight": w(64, D),
                   p + "self_attn.o_proj.weight": w(D, 128),
                   p + "input_layernorm.weight": torch.ones(
                       D, dtype=torch.bfloat16),
                   p + "post_attention_layernorm.weight": torch.ones(
                       D, dtype=torch.bfloat16)})
        if kind == "llama":
            st.update({p + "mlp.gate_proj.weight": w(F, D),
                       p + "mlp.up_proj.weight": w(F, D),
                       p + "mlp.down_proj.weight": w(D, F)})
        else:
            st[p + "block_sparse_moe.gate.weight"] = w(E, D)
            for e in range(E):
                q = f"{p}block_sparse_moe.experts.{e}."
                st.update({q + "w1.weight": w(F, D), q + "w3.weight": w(F, D),
                           q + "w2.weight": w(D, F)})
    if kind == "mixtral":
        cfg.update(num_local_experts=E, num_experts_per_tok=2,
                   sliding_window=None)
    (path / "config.json").write_text(json.dumps(cfg))
    header, blobs, off = {}, [], 0
    for name, t in st.items():
        b = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path / "model.safetensors", "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h + b"".join(blobs))


@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_serve_model_dir_on_the_card(dev, kind, tmp_path, monkeypatch):
    """``serve --model <dir>`` on the card: ``load_model`` reads the
    directory's config and safetensors straight to the card (no
    ``transformers``; a Mixtral through the MoE forwards) into the same
    params, bit for bit, as it loads on the CPU, and the server answers a
    greedy completion through K3 and K1."""
    import http.client
    import json

    import infinistore_tpu_torch.serve as tserve

    _write_checkpoint(tmp_path, kind)
    loaded = [tserve.load_model(str(tmp_path), d)
              for d in (torch.device("cpu"), dev)]
    (cfg, ref, fns), (cfg2, card, fns2) = loaded
    assert cfg2 == cfg and fns2 == fns
    assert ("prefill_fn" in fns) == (kind == "mixtral")
    assert card["embed"].device.type == "cuda"
    for k in ("embed", "lm_head", "ln_out"):
        assert torch.equal(card[k].cpu(), ref[k]), k
    for k, v in ref["layers"].items():
        assert torch.equal(card["layers"][k].cpu(), v), k
    del loaded, ref, card

    class Started(Exception):
        pass

    built = []
    real_start = tserve.ServingServer.start

    def start(self):
        real_start(self)
        built.append(self)
        raise Started

    monkeypatch.setattr(tserve.ServingServer, "start", start)
    monkeypatch.setenv("ISTPU_ADMISSION", "0")
    with pytest.raises(Started):
        tserve.main(["--model", str(tmp_path), "--port", "0", "--n-blocks",
                     "32", "--kv-quant", "none", "--decode-chunk", "4"])
    (srv,) = built
    try:
        ca.reset_launches()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": _PROMPTS[2], "max_tokens": 8, "temperature": 0}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, body
        assert len(body["choices"][0]["token_ids"]) == 8
        assert srv.engine.device.type == "cuda"
        assert ca.LAUNCHES["flash_causal"] > 0 and ca.LAUNCHES["paged_decode"] > 0
    finally:
        srv.close()
        ca.reset_launches()


# ---- tensor parallelism: two gloo ranks sharing the card ----

def test_tp_compositions_on_one_card_build_nothing(dev, tmp_path):
    """Two gloo ranks on the card, spawned after this process built the
    kernels: each runs the three ``_tp`` compositions (K1, K3, K2) on its
    head shard; the shards, concatenated, match the plain versions over
    all heads, each rank launched each kernel once per call, and neither
    rank started ``nvcc``."""
    import tp_targets
    from infinistore_tpu_torch.ops import build
    from tp_world import run_world

    build.build_all()
    out = run_world(tp_targets.compositions_on_card, 2, tmp_path)
    x = tp_targets.card_inputs(dev)
    want = {
        "decode": ca.paged_decode_attention_xla(*x["decode"]),
        "causal": ca.causal_attention_xla(*x["causal"]),
        "prefix": ca.causal_attention_xla(*x["prefix"], prefix_pad=256,
                                          prefix_len=100),
    }
    for kind, dim in (("decode", 1), ("causal", 2), ("prefix", 2)):
        got = torch.cat([o[0][kind] for o in out], dim=dim)
        _close(got.to(dev), want[kind], torch.bfloat16)
    for _outs, launches, nvcc in out:
        assert launches["paged_decode"] == 1
        assert launches["flash_causal"] == 1
        assert launches["flash_prefix"] == 1
        assert nvcc == 0


def test_tp_push_lands_whole_pages_a_tp1_engine_loads(dev, tmp_path,
                                                      store_port):
    """A tp=2 group on the card (gloo ranks sharing it) pushes a prompt;
    a tp=1 engine on the card adopts its chunks, and its cache holds
    bitwise the pages the group gathered from its ranks."""
    import tp_targets
    from infinistore_tpu_torch import config as tconfig
    from infinistore_tpu_torch import lib as tlib
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import TINY, init_params, \
        params_from_jax
    from tp_world import run_world

    params = init_params(TINY, torch.Generator().manual_seed(3), "cpu")
    tree = {"embed": params["embed"].float().numpy(),
            "lm_head": params["lm_head"].float().numpy(),
            "ln_out": params["ln_out"].float().numpy(),
            "layers": {k: v.float().numpy()
                       for k, v in params["layers"].items()}}
    pc = PagedCacheConfig(n_layers=TINY.n_layers, n_kv_heads=TINY.n_kv_heads,
                          head_dim=TINY.head_dim, n_blocks=64,
                          block_tokens=16, dtype=TINY.dtype)
    prompt = list(range(3, 103))
    out = run_world(tp_targets.engine_world, 2, tmp_path, tree, TINY, pc,
                    tp_targets.push_and_pages, {"kv_quant": None},
                    store=(store_port, "shm", "tp-card"),
                    script_kw={"prompt": prompt}, device="cuda")[0]
    conn = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=store_port,
        connection_type=tconfig.TYPE_SHM, log_level="warning"))
    conn.connect()
    try:
        eng = InferenceEngine(params_from_jax(tree, TINY, dev), TINY, pc,
                              conn=conn, kv_quant=None, model_id="tp-card",
                              device=dev)
        st = eng.prefill(prompt)
        n = (len(prompt) - 1) // 16
        assert st.store_chunks == n
        got = eng.cache[:, :, :, torch.tensor(st.block_ids[:n], device=dev)]
        want = torch.from_numpy(out["pages"][:, :, :, :n]).to(dev,
                                                                TINY.dtype)
        assert torch.equal(got, want)
    finally:
        conn.close()


def test_serve_tp_over_nccl_needs_a_card_per_rank(dev):
    """``serve --tp N`` over nccl (the default backend) with more ranks
    than the machine has cards exits before starting any rank, naming
    gloo as the way to share a card."""
    import os
    import subprocess
    import sys

    n = torch.cuda.device_count() + 1
    r = subprocess.run(
        [sys.executable, "-m", "infinistore_tpu_torch.serve", "--tp", str(n)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "needs a card per rank" in r.stderr, r.stderr[-500:]
    assert "gloo" in r.stderr


# ---- training on the card: the plain attention under autograd ----

def _tiny(dtype, seed=0):
    from infinistore_tpu_torch.models import TINY, init_params, scaled

    cfg = scaled(TINY, dtype=dtype)
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _on(tree, dev):
    return {k: _on(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def test_train_step_on_the_card(dev):
    """One ``train_step_fn`` step on the card (float32, TINY): every
    leaf's gradient present, finite and nonzero, no kernel launched (the
    training forward takes the plain attention), and the loss and the
    updated params within float32 tolerance of the same step on the
    CPU."""
    from infinistore_tpu_torch.models import loss_fn, train_step_fn
    from infinistore_tpu_torch.models.llama import leaves

    cfg, cpu = _tiny(torch.float32)
    gpu = _on(cpu, dev)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    live = [p.detach().requires_grad_() for p in leaves(gpu)]
    it = iter(live)
    tree = {k: ({kk: next(it) for kk in v} if isinstance(v, dict)
                else next(it)) for k, v in gpu.items()}
    ca.reset_launches()
    grads = torch.autograd.grad(loss_fn(tree, cfg, tokens.to(dev)), live)
    assert all(g is not None and bool(torch.isfinite(g).all())
               and float(g.abs().max()) > 0 for g in grads)
    step = train_step_fn(cfg, lr=1e-2)
    gpu, gloss = step(gpu, tokens.to(dev))
    cpu, closs = step(cpu, tokens)
    torch.cuda.synchronize()
    assert not any(ca.LAUNCHES.values())
    assert abs(float(gloss) - float(closs)) <= 1e-4 * abs(float(closs))
    for a, b in zip(leaves(gpu), leaves(cpu)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def test_forward_with_the_kernels_refuses_autograd(dev):
    """The serving forward (kernels on) raises under autograd instead of
    cutting the attention out of the graph; ``use_kernels=False`` runs."""
    from infinistore_tpu_torch.models import prefill_forward

    cfg, cpu = _tiny(torch.bfloat16)
    params = _on(cpu, dev)
    params["layers"]["wq"].requires_grad_()
    tokens = torch.arange(16, device=dev)[None]
    with pytest.raises(RuntimeError, match="no backward"):
        prefill_forward(params, cfg, tokens)
    logits, _ = prefill_forward(params, cfg, tokens, use_kernels=False)
    (g,) = torch.autograd.grad(logits.float().sum(),
                               [params["layers"]["wq"]])
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_kernels_refuse_autograd_on_the_card(dev, kernel):
    q, cache, table, lens = _paged(2, 8, 2, 64, 16, 16, 4, torch.bfloat16,
                                   dev)
    g = torch.Generator(device=dev).manual_seed(0)
    qs = torch.randn(1, 64, 8, 64, generator=g, device=dev,
                     dtype=torch.bfloat16)
    kv = torch.randn(1, 128, 2, 64, generator=g, device=dev,
                     dtype=torch.bfloat16)
    call = {"K1": lambda q1: ca.paged_decode_attention_cuda(q1, cache, table,
                                                            lens),
            "K2": lambda q1: ca.flash_prefix_attention_cuda(q1, kv, kv, 64,
                                                            40),
            "K3": lambda q1: ca.flash_causal_attention_cuda(q1, kv[:, :64],
                                                            kv[:, :64])}
    q1 = q if kernel == "K1" else qs
    want = call[kernel](q1)
    ca.reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        call[kernel](q1.clone().requires_grad_())
    assert not any(ca.LAUNCHES.values())
    with torch.no_grad():
        assert torch.equal(call[kernel](q1.clone().requires_grad_()), want)


def test_checkpoint_restored_onto_the_card_bitwise(dev, tmp_path):
    """``CheckpointManager``: bf16 params on the card saved asynchronously,
    restored with ``like`` onto ``cuda`` bitwise equal (dtype and device
    kept)."""
    from infinistore_tpu_torch.models.llama import leaves
    from infinistore_tpu_torch.utils import CheckpointManager

    _cfg, cpu = _tiny(torch.bfloat16, seed=4)
    params = _on(cpu, dev)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=1)
    mgr.save(1, params, metadata={"model": "tiny"})
    mgr.wait()
    got = mgr.restore(like=params)
    for a, b in zip(leaves(got), leaves(params)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert mgr.restore_metadata() == {"model": "tiny"}
    mgr.close()
