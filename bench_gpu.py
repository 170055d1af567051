"""Benchmark legs of the PyTorch/CUDA port on one NVIDIA GPU.

The counterpart of ``bench_tpu.py``'s legs, ported one at a time.  Each leg
is a function ``leg_*(out)`` that writes its numbers into ``out`` under the
reference's key names where the meaning is the same.  ``chip_smoke.py`` runs
them; alone:

    python3 bench_gpu.py

prints one JSON object with every leg's keys (one CUDA device needed).

Legs:

* ``leg_invocation_overhead``: what one kernel launch costs.  The same
  decode-attention work over every layer of Llama-3-8B (L=32, B=8, H=32,
  H_kv=8, D=128, T=16, bf16, a 1024-token context on distinct pages for
  each row) issued as L K1 launches captured in one CUDA graph, as the
  same L launches issued eagerly, as ONE K4 launch, and through the plain
  PyTorch version.  Iterations are chained (``qs*0.999 + 0.001*o``) and
  timed with CUDA events.
* ``leg_paged_decode``: K1's device time at three shapes of Llama-3-8B's
  decode attention (``DECODE_SHAPES``), each with the bytes it must read
  and the split count.  Median of single calls timed with CUDA events, L2
  flushed before each, host enqueue hidden (``median_device_ms``).
"""

from __future__ import annotations

import json
import statistics
import sys
import time

# the overhead leg's shapes: Llama-3-8B's attention at decode batch 8
OVERHEAD_SHAPES = dict(L=32, B=8, H=32, Hkv=8, D=128, T=16, pages=64)


def overhead_inputs(torch, dev, dtype, seed: int = 0):
    """(qs, cache, table, lens) of the overhead leg: qs [L, B, H, D], cache
    [L, 2, H_kv, B*pages + 1, T, D] (about 1.07 GB in bf16, far above the
    50 MB L2), row b on its own pages ``1 + b*pages ..``, every row
    ``pages*T`` tokens long.  Drawn on the card from a seeded generator."""
    s = OVERHEAD_SHAPES
    L, B, H, Hkv, D, T, P = (s[k] for k in ("L", "B", "H", "Hkv", "D", "T",
                                            "pages"))
    g = torch.Generator(device=dev).manual_seed(seed)
    qs = torch.randn((L, B, H, D), generator=g, device=dev).to(dtype)
    cache = torch.randn((L, 2, Hkv, B * P + 1, T, D), generator=g,
                        device=dev, dtype=dtype)
    table = (1 + torch.arange(B * P, dtype=torch.int32, device=dev)).view(B, P)
    lens = torch.full((B,), P * T, dtype=torch.int32, device=dev)
    return qs, cache, table, lens


# K1's timed shapes (H=32, H_kv=8, D=128, T=16): the smoke's mixed batch
# (lengths 1-1500, one pad row, a 128-wide table), one long row alone, and
# the overhead leg's per-layer shape (8 rows of 1024 tokens, 64-wide table)
DECODE_SHAPES = {
    "mixed": "B=8, lengths 1..1500 and a pad row, 128-wide table",
    "long": "B=1, one 2000-token row, 128-wide table",
    "uniform": "B=8 x 1024 tokens, 64-wide table",
}


def decode_inputs(torch, np, dev, dtype, shape: str):
    """(q, cache, table, lens, real_lens) of one of ``DECODE_SHAPES``, drawn
    from seeds; ``real_lens``: the lengths of the rows that are not pad
    rows (numpy), for the bytes the call must read."""
    H, Hkv, D, T = 32, 8, 128, 16
    if shape == "uniform":
        qs, cache, table, lens = overhead_inputs(torch, dev, dtype, seed=6)
        return (qs[0].contiguous(), cache[0].contiguous(), table, lens,
                lens.cpu().numpy())
    if shape == "mixed":
        B, n_blocks, max_pages = 8, 2048, 128
        real = np.array([1, 64, 200, 812, 612, 1500, 1000], np.int32)
    elif shape == "long":
        B, n_blocks, max_pages = 1, 2048, 128
        real = np.array([2000], np.int32)
    else:
        raise ValueError(f"unknown decode shape {shape!r}")
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    cache = torch.randn((2, Hkv, n_blocks, T, D), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    lens = np.ones((B,), np.int32)
    lens[:len(real)] = real
    table = np.full((B, max_pages), n_blocks, np.int32)  # rows past real: pad
    free = rng.permutation(n_blocks).tolist()
    for b in range(len(real)):
        n = -(-int(lens[b]) // T)
        table[b, :n] = [free.pop() for _ in range(n)]
        table[b, n:] = 0
    return (q.to(dev, dtype), cache.to(dev, dtype),
            torch.from_numpy(table).to(dev), torch.from_numpy(lens).to(dev),
            real)


def decode_bytes(q, real_lens, table) -> float:
    """Bytes one K1/K4 call must move: every valid K and V row once, q read
    and out written once, the table and the lengths (bf16/f32 by q)."""
    Hkv, D = 8, q.shape[-1]
    L = q.shape[0] if q.dim() == 4 else 1
    es = q.element_size()
    return (L * float(real_lens.sum()) * Hkv * D * 2 * es + 2 * q.numel() * es
            + table.numel() * 4 + table.shape[0] * 4)


def median_device_ms(torch, fn, reps: int, flush) -> float:
    """Median over ``reps`` single calls timed with CUDA events, L2 flushed
    before each (the main path finds each layer's tensors cold).  The card
    first spins for about 100 us, so the host has enqueued the call before
    the start event is reached: the time is the device's alone, not the
    wrapper's host work."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(200_000)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def decode_record(torch, ca, q, cache, table, lens, real_lens, reps: int,
                  flush) -> dict:
    """K1's median device time on these inputs (``median_device_ms``), the
    bytes it must move, the valid tokens, GB/s and the splits per row."""
    ms = median_device_ms(torch, lambda: ca.paged_decode_attention_cuda(
        q, cache, table, lens), reps, flush)
    n_bytes = decode_bytes(q, real_lens, table)
    return dict(ms=ms, bytes=n_bytes, tokens=float(real_lens.sum()),
                gbps=n_bytes / ms / 1e6,
                splits=ca.decode_splits(cache.shape[3], table.shape[1])[1])


def leg_paged_decode(out: dict, reps: int = 30) -> None:
    """K1 (bf16) at each of ``DECODE_SHAPES``: ``k1_{shape}_{key}`` for each
    key of ``decode_record``.  Launches here are counted in ``LAUNCHES``
    like any other: reset before reading a path's counts."""
    import numpy as np
    import torch

    from infinistore_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for shape in DECODE_SHAPES:
        q, cache, table, lens, real = decode_inputs(torch, np, dev,
                                                    torch.bfloat16, shape)
        for key, v in decode_record(torch, ca, q, cache, table, lens, real,
                                    reps, flush).items():
            out[f"k1_{shape}_{key}"] = v
        del q, cache


def _chained_ms(torch, step, x, n: int) -> float:
    """Mean ms per iteration of ``x.copy_(step(x))`` over ``n`` iterations
    after three warm-up ones, timed with CUDA events."""
    for _ in range(3):
        step(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def leg_invocation_overhead(out: dict, n: int = 30) -> None:
    """The H100 counterpart of ``bench_tpu.py:leg_invocation_overhead``.

    ``invoc_{L}calls_ms``: L K1 launches captured in one CUDA graph (the
    counterpart of the reference's single jit holding L custom calls);
    ``invoc_{L}calls_eager_ms``: the same launches issued eagerly;
    ``invoc_1call_ms``: one K4 launch; ``invoc_xla_ms``: the plain version
    (reported, no yardstick).  ``invoc_per_call_overhead_ms`` is the
    reference's ``(t_L - t_1) / (L - 1)``; ``invoc_eager_per_call_overhead_ms``
    is ``(t_eager - t_graph) / L``, the part of an eager launch's cost that
    the device sees (little, while each K1 outlasts its launch);
    ``invoc_host_ms_per_launch`` is the host time to issue one K1 launch
    through its wrapper (median over 10 batches of L, host clock, device
    drained before each batch)."""
    import torch

    from infinistore_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    L = OVERHEAD_SHAPES["L"]
    qs0, cache, table, lens = overhead_inputs(torch, dev, torch.bfloat16)

    def per_layer(x):
        o = torch.stack([ca.paged_decode_attention_cuda(
            x[l], cache[l], table, lens) for l in range(L)])
        x.copy_(x * 0.999 + 0.001 * o)

    def fused(x):
        o = ca.paged_decode_attention_alllayers_cuda(x, cache, table, lens)
        x.copy_(x * 0.999 + 0.001 * o)

    def plain(x):
        o = ca.paged_decode_attention_alllayers_xla(x, cache, table, lens)
        x.copy_(x * 0.999 + 0.001 * o)

    x_graph = qs0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            per_layer(x_graph)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # K1 warmed up on this stream
        per_layer(x_graph)

    t_graph = _chained_ms(torch, lambda x: graph.replay(), x_graph, n)
    t_eager = _chained_ms(torch, per_layer, qs0.clone(), n)
    t_fused = _chained_ms(torch, fused, qs0.clone(), n)
    t_plain = _chained_ms(torch, plain, qs0.clone(), max(3, n // 6))
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for l in range(L):
            ca.paged_decode_attention_cuda(qs0[l], cache[l], table, lens)
        host.append((time.perf_counter() - t0) / L)
    torch.cuda.synchronize()
    out[f"invoc_{L}calls_ms"] = t_graph
    out[f"invoc_{L}calls_eager_ms"] = t_eager
    out["invoc_1call_ms"] = t_fused
    out["invoc_xla_ms"] = t_plain
    out["invoc_per_call_overhead_ms"] = (t_graph - t_fused) / (L - 1)
    out["invoc_eager_per_call_overhead_ms"] = (t_eager - t_graph) / L
    out["invoc_fused_speedup"] = t_graph / t_fused
    out["invoc_host_ms_per_launch"] = statistics.median(host) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_gpu: no CUDA device", file=sys.stderr)
        return 2
    out: dict = {"device": torch.cuda.get_device_name(0)}
    with torch.no_grad():
        leg_invocation_overhead(out)
        leg_paged_decode(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
