#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``infinistore_tpu_torch``) on one GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build: compile the port's CUDA kernels from ``infinistore_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source, in parallel), print the card's name
   and power limit, print the paged-decode kernels' registers, shared
   memory and spills (any local memory fails), and count each kernel's
   tensor-core instructions (``cuobjdump -sass``: HGMMA, HMMA); the bf16
   flash kernels must hold HGMMA;
2. kernels: every kernel against its plain PyTorch version on the card at
   the main path's shapes (H=32, H_kv=8, D=128, T=16; K1-K3 also at the
   four-process fleet's TINY shapes, D=32), bf16 and f32 (K1 at
   each of ``bench_gpu.DECODE_SHAPES``, timed at each beside its bound,
   with GB/s and the split count), with the kernel's, the plain version's
   and a one-call PyTorch yardstick's median device times beside the least
   time the card could take; K2 also with its length in device memory:
   one launch captured into a CUDA graph, the length changed in place
   between replays (0, 1, 127, 128, 129, 1024), each replay ``torch.equal``
   to the host-int launch and held against the plain version; K3 and K2
   also at the serving path's own chunk shapes beside SDPA, with TFLOP/s
   and share of the bound; K4 also ``torch.equal`` to 32 K1 launches on
   the same inputs;
3. model path: Llama-3-8B at full width and depth with random bf16 weights
   (seeded ``torch.Generator``) served through ``InferenceEngine`` and
   ``Scheduler`` for 8 requests (shared prefix, chunked prefill, mixed
   greedy and top-k/top-p sampling), prefilling and decoding through the
   engine's CUDA graphs (prefill replays holding K3 and K2, decode replays
   > 0; the prefill keys printed), with every kernel's launch count over
   that run (counted per replay), TTFT and TPOT, and one greedy decode step
   held against a cold prefill; then a cold 1500-token prefill through the
   prefill graphs and through the eager chunk body (wall time, device time
   and kernels per chunk under ``torch.profiler``, host time per replay,
   captures), each prefill key's replay ``torch.equal`` to its eager body,
   the prefix copy's device time, and the B=8 decode step through the
   graphs and through the eager step body: tokens and final logits equal,
   bare ms/step of each, device busy share, host time per replay, capture
   seconds and the number of graphs;
4. serve path: the port's ``ServingServer`` on the same engine (an
   ephemeral port, in-process) answers OpenAI requests: greedy, seeded
   twice (equal), ``logprobs=5``, penalties, a ``logit_bias`` that forces
   one token, and a streamed request equal to its non-streamed twin; then
   ``/metrics`` and ``/debug/engine``;
5. overhead path: ``bench_gpu.leg_invocation_overhead`` (32 K1 launches in
   a CUDA graph, the same eagerly, one K4 launch, the plain version) beside
   the eager and graph decode steps of phase 3;
6. store path: the port's own store server in a subprocess (kept for the
   fleet path); engine A prefills a fresh 1500-token prompt into it,
   engine B (same weights, its own connection and cache) adopts the 93
   stored chunks and computes only the tail; adopted pages bitwise equal
   to A's, first-token logits close, every push band straight into the
   page-locked shm pool; then the same over TCP with int8 pages; push/load
   rates and TTFT printed;
7. fleet path: the store phase's server backs a prefill worker and a decode
   worker (``InferenceEngine`` + ``ServingServer`` each, Llama-3-8B,
   lossless pages) behind the port's ``FrontDoor``, in this process; 8
   fresh prompts of 512-1500 tokens streamed through the router one at a
   time, then 8 more at once: all 200 with no router 5xx, each decode
   record adopting (prompt tokens - 1) // 16 chunks from the store, the
   sequential requests' adopted pages bitwise equal to the prefill
   worker's and their first greedy token equal to its local answer, K1/K2/
   K3 launched by the two workers' engine threads and by no other thread,
   the prefill worker replaying prefill graphs that hold K3 and K2;
   TTFT, TPOT, handoff and store_load_s printed; then the four-process
   tiny fleet (``examples.fleet_processes --smoke --device cuda``) must
   exit 0, its workers having launched K3 and K1 (head size 32);
8. the ``kernels`` line: one JSON object with every kernel's numbers, each
   kernel's launches counted over the path that runs it.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the repo beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet):
# the bounds below are stated against them.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # atol = rtol, per dtype
REPO_SOURCE = "infinistore_tpu_torch/ops/csrc/"
TPU_SOURCE = "infinistore_tpu/ops/pallas_attention.py:"
MODEL_PATH_KERNELS = ("paged_decode", "flash_causal", "flash_prefix",
                      "flash_prefix_device_len")


def _held(engine) -> str:
    """The engine's held bytes (weights, cache, graph buffers), the prefill
    graphs' share and the device memory the allocator has reserved (the
    graph pool's included), in MiB."""
    import torch

    pre = {}
    for g in engine._prefill_graphs.values():
        for t in g.buffers():
            st = t.untyped_storage()
            pre[st.data_ptr()] = st.nbytes()
    mib = 2 ** 20
    return (f"held_bytes {engine.held_bytes() / mib:.1f} MiB, prefill graph "
            f"buffers {sum(pre.values()) / mib:.1f} MiB over "
            f"{len(engine._prefill_graphs)} keys; device memory reserved "
            f"{torch.cuda.memory_reserved() / mib:.1f} MiB")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_report(log: str) -> dict:
    """Per kernel (mangled name), from the assembler's report of a build:
    ``registers``, ``smem`` (static bytes), ``stack``, ``spill_stores`` and
    ``spill_loads`` (bytes)."""
    report: dict = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([^'\s]+)'?", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[fn].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            report[fn]["smem"] = int(m.group(1)) if m else 0
    return report


def phase_build(build) -> None:
    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR}")
    for name in paths:
        if name == "paged_decode":
            continue  # per kernel below
        for line in build.build_log(name).splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "Performance")):
                print(f"[build] {name}: {line.strip()}")
    # the paged-decode kernels' registers, shared memory and spills: one
    # instantiation per type, head size (and, in f32, query-group shape);
    # any local memory fails
    report = ptxas_report(build.build_log("paged_decode"))
    check(report, "no ptxas report for the paged-decode kernels")
    for fn, r in report.items():
        m = re.search(r"(paged_decode(?:_bf16)?_kernel)I(.*?)E+vP", fn)
        short = f"{m[1]}<{m[2]}>" if m else fn
        print(f"[build] {short}: {r.get('registers')} registers, "
              f"{r.get('smem')} B static smem, stack {r.get('stack')} B, "
              f"spill stores {r.get('spill_stores')} B, spill loads "
              f"{r.get('spill_loads')} B")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
              and r.get("stack") == 0,
              f"paged_decode kernel {fn} uses local memory: {r}")
    # tensor-core instructions in the compiled kernels: HGMMA (wgmma) and
    # HMMA (mma.sync), per kernel as cuobjdump -sass lists them
    for name in paths:
        counts = build.sass_counts(name)
        for fn, c in counts.items():
            print(f"[build] {name} SASS {fn}: HGMMA {c['HGMMA']}, "
                  f"HMMA {c['HMMA']}")
        if name == "flash_attention":
            bf16 = [c for fn, c in counts.items() if "bf16_kernel" in fn]
            check(bf16 and all(c["HGMMA"] > 0 for c in bf16),
                  f"the bf16 flash kernels hold no wgmma (HGMMA): {counts}")


def phase_kernels(torch, np, ca, bench_gpu, dev) -> dict:
    """Each kernel against its plain version; returns per-kernel records."""
    import torch.nn.functional as F

    median_ms = bench_gpu.median_device_ms

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rec = {}

    def compare(name, got, want, dtype):
        tol = TOL[str(dtype).split(".")[-1]]
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        print(f"[kernels] {name} {dtype}: max_abs_err={err:.3e} "
              f"(atol=rtol={tol}) {'ok' if ok else 'MISMATCH'}")
        check(ok and math.isfinite(err), f"{name} disagrees with its plain "
              f"version ({dtype}, max_abs_err={err})")
        return err

    # ---- K1: paged decode, at each of bench_gpu.DECODE_SHAPES, timed once
    # in bf16 beside its bound (the mixed batch last, whose bf16 inputs stay
    # for the plain version's time) ----
    esize = 2
    H, Hkv, D = 32, 8, 128
    for shape in ("long", "uniform", "mixed"):
        for dtype in (torch.float32, torch.bfloat16):
            q, cache, table, lens, real = bench_gpu.decode_inputs(
                torch, np, dev, dtype, shape)
            got = ca.paged_decode_attention_cuda(q, cache, table, lens)
            torch.cuda.synchronize()
            n_pad = q.shape[0] - len(real)
            check(n_pad == 0 or got[-n_pad:].abs().max().item() == 0.0,
                  f"K1 pad rows are not zero ({shape})")
            err = compare(f"K1 paged_decode {shape} ({n_pad} pad rows)", got,
                          ca.paged_decode_attention_xla(q, cache, table,
                                                        lens), dtype)
        d = bench_gpu.decode_record(torch, ca, q, cache, table, lens, real,
                                    30, flush)
        b_ms, b_by = bound_ms(d["bytes"], 4.0 * H * D * d["tokens"])
        print(f"[decode] K1 bf16 {shape} ({bench_gpu.DECODE_SHAPES[shape]}): "
              f"{d['ms']:.4f} ms, {d['gbps']:.1f} GB/s, "
              f"{100 * b_ms / d['ms']:.1f}% of the bound ({b_ms:.4f} ms by "
              f"{b_by}, {d['bytes']:.0f} B), {d['splits']} splits per row")
    rec["paged_decode"] = dict(
        name="paged_decode_attention_cuda", source=REPO_SOURCE + "paged_decode.cu",
        replaces=TPU_SOURCE + "406", max_abs_err=err, ms=d["ms"],
        plain_ms=median_ms(torch, lambda: ca.paged_decode_attention_xla(
            q, cache, table, lens), 10, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    def qkv(dtype, B, Sq, Sk, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]

    def sdpa(q, k, v, **kw):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True, **kw).transpose(1, 2)

    def k2_mask(pad, plen, Sq):
        k_pos = torch.arange(pad + Sq, device=dev)
        i = torch.arange(Sq, device=dev)[:, None]
        return (k_pos[None] < plen) | ((k_pos[None] >= pad)
                                       & (k_pos[None] - pad <= i))

    def flash_timing(label, call, library, plain, Sq, kv_rows, pairs,
                     reps=20):
        """Median ms of the kernel and of its SDPA yardstick (and of the
        plain version when given) beside the bound; prints TFLOP/s and the
        share of the bound.  ``kv_rows``: the K/V rows the visible pairs
        need, ``pairs``: the visible (query, key) pairs per head."""
        flops = 4.0 * H * D * pairs
        b_ms, b_by = bound_ms(esize * (2 * Sq * H * D + 2 * kv_rows * Hkv * D),
                              flops)
        ms = median_ms(torch, call, reps, flush)
        lib_ms = median_ms(torch, library, reps, flush)
        print(f"[kernels] {label}: {ms:.4f} ms, {flops / ms / 1e9:.1f} "
              f"TFLOP/s, {100 * b_ms / ms:.1f}% of the bound ({b_ms:.4f} ms "
              f"by {b_by}); SDPA {lib_ms:.4f} ms, {flops / lib_ms / 1e9:.1f} "
              f"TFLOP/s; kernel/SDPA {ms / lib_ms:.2f}x")
        return dict(ms=ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    plain_ms=median_ms(torch, plain, 5, flush) if plain
                    else None)

    # ---- K3: causal flash prefill, Sq = Sk = 2048, and a ragged q_offset case
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(dtype, 1, 700, 1048, 3)
        compare("K3 flash_causal q_offset=348 Sq=700", ca.flash_causal_attention_cuda(
            q, k, v, q_offset=348), ca.causal_attention_xla(q, k, v, q_offset=348),
            dtype)
        q, k, v = qkv(dtype, 1, 2048, 2048, 4)
        got = ca.flash_causal_attention_cuda(q, k, v)
        err = compare("K3 flash_causal Sq=Sk=2048", got,
                      ca.causal_attention_xla(q, k, v), dtype)
    S = 2048
    rec["flash_causal"] = dict(
        name="flash_causal_attention_cuda",
        source=REPO_SOURCE + "flash_attention.cu",
        replaces=TPU_SOURCE + "333", max_abs_err=err,
        **flash_timing("K3 bf16 Sq=Sk=2048",
                       lambda: ca.flash_causal_attention_cuda(q, k, v),
                       lambda: sdpa(q, k, v, is_causal=True),
                       lambda: ca.causal_attention_xla(q, k, v),
                       S, S, S * (S + 1) / 2),
    )

    # ---- K2: prefix flash prefill, prefix_pad=1024, prefix_len=700, Sq=512
    pad, plen, Sq = 1024, 700, 512
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(dtype, 1, Sq, pad + Sq, 5)
        got = ca.flash_prefix_attention_cuda(q, k, v, pad, plen)
        err = compare("K2 flash_prefix", got, ca.causal_attention_xla(
            q, k, v, prefix_pad=pad, prefix_len=plen), dtype)
    mask = k2_mask(pad, plen, Sq)
    rec["flash_prefix"] = dict(
        name="flash_prefix_attention_cuda",
        source=REPO_SOURCE + "flash_attention.cu",
        replaces=TPU_SOURCE + "247", max_abs_err=err,
        **flash_timing("K2 bf16 pad=1024 len=700 Sq=512",
                       lambda: ca.flash_prefix_attention_cuda(
                           q, k, v, pad, plen),
                       lambda: sdpa(q, k, v, attn_mask=mask),
                       lambda: ca.causal_attention_xla(
                           q, k, v, prefix_pad=pad, prefix_len=plen),
                       Sq, plen + Sq, plen * Sq + Sq * (Sq + 1) / 2),
    )

    # ---- K2 reading its length from device memory, as the engine's prefill
    # graphs run it: one launch captured into a CUDA graph at the same
    # shape, the length changed in place between replays; each replay
    # torch.equal to the host-int launch at that length and held against
    # the plain version over the same device length
    dlen = torch.zeros((), dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(dtype, 1, Sq, pad + Sq, 5)
        ca.flash_prefix_attention_cuda(q, k, v, pad, dlen)  # first-call set-up
        torch.cuda.synchronize()
        k2_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(k2_graph):
            out = ca.flash_prefix_attention_cuda(q, k, v, pad, dlen)
        errs = []
        for n in (0, 1, 127, 128, 129, pad):
            dlen.fill_(n)
            k2_graph.replay()
            host = ca.flash_prefix_attention_cuda(q, k, v, pad, n)
            torch.cuda.synchronize()
            check(torch.equal(out, host), f"K2 replayed at prefix_len={n} "
                  f"differs from the host-int launch ({dtype})")
            errs.append(compare(
                f"K2 graph replay, device prefix_len={n} (== host-int launch)",
                out, ca.causal_attention_xla(q, k, v, prefix_pad=pad,
                                             prefix_len=dlen), dtype))
    dlen.fill_(plen)  # the length K2's timing above ran at
    rec["flash_prefix_device_len"] = dict(
        name="flash_prefix_attention_cuda[prefix_len on the device]",
        source=REPO_SOURCE + "flash_attention.cu",
        replaces=TPU_SOURCE + "247", max_abs_err=max(errs),
        **flash_timing(f"K2 bf16 pad={pad} device len={plen} Sq={Sq} "
                       f"(one captured launch replayed)",
                       k2_graph.replay,
                       lambda: sdpa(q, k, v, attn_mask=mask),
                       lambda: ca.causal_attention_xla(
                           q, k, v, prefix_pad=pad, prefix_len=dlen),
                       Sq, plen + Sq,
                       plen * Sq + Sq * (Sq + 1) / 2),
    )
    del k2_graph, out, host

    # ---- K3 and K2 at the serving path's own shapes: a cold 1500-token
    # prompt in 512-token chunks runs K3 at Sq = Sk = 512, then K2 over a
    # 512- and a 1024-row bucket (bf16, as the model path runs them)
    q, k, v = qkv(torch.bfloat16, 1, 512, 512, 7)
    compare("K3 flash_causal Sq=Sk=512", ca.flash_causal_attention_cuda(
        q, k, v), ca.causal_attention_xla(q, k, v), torch.bfloat16)
    flash_timing("K3 bf16 Sq=Sk=512 (serving)",
                 lambda: ca.flash_causal_attention_cuda(q, k, v),
                 lambda: sdpa(q, k, v, is_causal=True), None,
                 512, 512, 512 * 513 / 2)
    for pad, plen, Sq in ((512, 512, 512), (1024, 1024, 480)):
        q, k, v = qkv(torch.bfloat16, 1, Sq, pad + Sq, 8)
        compare(f"K2 flash_prefix pad={pad} len={plen} Sq={Sq}",
                ca.flash_prefix_attention_cuda(q, k, v, pad, plen),
                ca.causal_attention_xla(q, k, v, prefix_pad=pad,
                                        prefix_len=plen), torch.bfloat16)
        mask = k2_mask(pad, plen, Sq)
        flash_timing(f"K2 bf16 pad={pad} len={plen} Sq={Sq} (serving)",
                     lambda: ca.flash_prefix_attention_cuda(
                         q, k, v, pad, plen),
                     lambda: sdpa(q, k, v, attn_mask=mask), None,
                     Sq, plen + Sq, plen * Sq + Sq * (Sq + 1) / 2)
    del q, k, v, mask
    # ---- the TINY model's head size (32; H=4, H_kv=2) as the four-process
    # fleet of phase 7 runs it: K1 over 4-token pages, K3 on a cold
    # 16-token prompt, K2 on a 4-token tail over a 12-token prefix (bf16
    # takes the FMA path at D = 32)
    g = torch.Generator().manual_seed(11)
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=g).to(dev, dtype)
        q, cache = rnd(8, 4, 32), rnd(2, 2, 128, 4, 32)
        table = torch.randperm(128, generator=g)[:8 * 16].view(8, 16).to(
            dev, torch.int32)
        lens = torch.randint(1, 65, (8,), generator=g).to(dev, torch.int32)
        compare("K1 paged_decode D=32 T=4", ca.paged_decode_attention_cuda(
            q, cache, table, lens), ca.paged_decode_attention_xla(
            q, cache, table, lens), dtype)
        q, k, v = rnd(1, 16, 4, 32), rnd(1, 16, 2, 32), rnd(1, 16, 2, 32)
        compare("K3 flash_causal D=32 Sq=16", ca.flash_causal_attention_cuda(
            q, k, v), ca.causal_attention_xla(q, k, v), dtype)
        q, k, v = rnd(1, 4, 4, 32), rnd(1, 20, 2, 32), rnd(1, 20, 2, 32)
        compare("K2 flash_prefix D=32 pad=16 len=12 Sq=4",
                ca.flash_prefix_attention_cuda(q, k, v, 16, 12),
                ca.causal_attention_xla(q, k, v, prefix_pad=16,
                                        prefix_len=12), dtype)
    del q, k, v, cache, table, lens
    # ---- K4: K1 over all 32 layers in one launch, at the overhead leg's
    # shapes (B=8, a 1024-token context on distinct pages for each row)
    for dtype in (torch.float32, torch.bfloat16):
        qs, cache, table, lens = bench_gpu.overhead_inputs(torch, dev, dtype,
                                                           seed=6)
        got = ca.paged_decode_attention_alllayers_cuda(qs, cache, table, lens)
        err = compare("K4 paged_decode_alllayers", got,
                      ca.paged_decode_attention_alllayers_xla(
                          qs, cache, table, lens), dtype)
        per_layer = torch.stack([ca.paged_decode_attention_cuda(
            qs[l], cache[l], table, lens) for l in range(qs.shape[0])])
        same = torch.equal(got, per_layer)
        print(f"[kernels] K4 {dtype} torch.equal to {qs.shape[0]} K1 "
              f"launches: {same}")
        check(same, f"K4 differs from {qs.shape[0]} K1 launches ({dtype})")
        if dtype == torch.float32:
            del qs, cache, got, per_layer
    L, B = qs.shape[:2]
    tokens = float(lens.sum())
    n_bytes = bench_gpu.decode_bytes(qs, lens.cpu().numpy(), table)
    b_ms, b_by = bound_ms(n_bytes, 4.0 * L * H * D * tokens)
    rec["paged_decode_alllayers"] = dict(
        name="paged_decode_attention_alllayers_cuda",
        source=REPO_SOURCE + "paged_decode.cu",
        replaces=TPU_SOURCE + "486", max_abs_err=err,
        ms=median_ms(torch, lambda: ca.paged_decode_attention_alllayers_cuda(
            qs, cache, table, lens), 20, flush),
        plain_ms=median_ms(
            torch, lambda: ca.paged_decode_attention_alllayers_xla(
                qs, cache, table, lens), 5, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    del qs, cache, got, per_layer
    for key, r in rec.items():
        print(f"[kernels] {key}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']})")
    del flush
    return rec


def llama3_8b(torch, dev):
    """Llama-3-8B at full width and depth, random bf16 weights drawn on the
    card from a seed, and a 4 GiB paged cache config (2048 pages of 16)."""
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import LLAMA3_8B, init_params

    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"],
                                      params["ln_out"],
                                      *params["layers"].values()])
    print(f"[model] Llama-3-8B: {cfg.n_layers} layers, dim {cfg.dim}, "
          f"{n_params / 1e9:.2f} B params (bf16) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, n_blocks=2048,
                          block_tokens=16, dtype=cfg.dtype)
    return params, cfg, pc


def logits_agree(torch, got, want, what: str, max_err: bool = True) -> None:
    """Cosine >= 0.999 and (with ``max_err``) max error <= 2e-2 *
    max|logit|."""
    got, want = got.float(), want.float()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    bound = f"<= 2e-2 * max|logit| = {2e-2 * scale:.4f}" if max_err else \
        f"{err / scale:.4f} of max|logit|, reported"
    print(f"{what}: cosine {cos:.6f} (>= 0.999), max_abs_err {err:.4f} "
          f"({bound})")
    check(cos >= 0.999 and (not max_err or err <= 2e-2 * scale),
          f"{what}: logits disagree")


def phase_model(torch, ca, bench_gpu, dev, card: str, params, cfg, pc):
    """The serving path; returns its launch counts, the decode-step
    profile, the engine and each request's TTFT (ms) by prompt length."""
    from infinistore_tpu_torch.engine import InferenceEngine, Scheduler
    from infinistore_tpu_torch.models import prefill_forward

    engine = InferenceEngine(params, cfg, pc, prefill_chunk=512)
    sched = Scheduler(engine, max_batch=8)

    rng = torch.Generator().manual_seed(42)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    # warm-up (cuBLAS handles, allocator): one short request, not counted
    engine.release(engine.prefill(prompt(40)))
    torch.cuda.synchronize()

    shared = prompt(512)
    reqs = [  # (prompt, max_new_tokens, sampling)
        (prompt(64), 48, dict()),
        (prompt(200), 40, dict(sample="categorical", top_k=50, temperature=0.8)),
        (shared + prompt(300), 64, dict()),
        (shared + prompt(100), 36, dict(sample="categorical", top_p=0.9)),
        (prompt(1500), 56, dict()),
        (prompt(350), 32, dict(sample="categorical", top_k=20, top_p=0.95)),
        (prompt(1000), 60, dict()),
        (prompt(130), 44, dict(sample="categorical")),
    ]
    ca.reset_launches()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    ids = [sched.submit(p, n, **kw) for p, n, kw in reqs]
    finished = {}
    while sched.has_work:
        for r in sched.step():
            finished[r.req_id] = r
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(ca.LAUNCHES)
    print(f"[model] launches on the serving path: {json.dumps(launches)}")
    for (p, n, kw), rid in zip(reqs, ids):
        r = finished[rid]
        check(len(r.output) == n and all(0 <= t < cfg.vocab_size
                                        for t in r.output),
              f"request {rid} ({len(p)} prompt tokens) returned "
              f"{len(r.output)} tokens, wanted {n}")
    check(all(launches[k] > 0 for k in MODEL_PATH_KERNELS),
          f"a kernel was not launched on the serving path: {launches}")
    caps, caps_s = engine.graph_captures, engine.graph_capture_s
    replays = engine.graph_replays
    print(f"[model] decode graphs: {replays['decode']} replays of "
          f"{len(engine._graphs)} graphs, {caps['decode']} captures in "
          f"{caps_s['decode']:.3f} s")
    check(replays["decode"] > 0,
          "the serving path decoded without replaying a CUDA graph")
    pl = engine.graph_launches("prefill")
    print(f"[model] prefill graphs: {replays['prefill']} replays of "
          f"{len(engine._prefill_graphs)} keys, {caps['prefill']} captures "
          f"in {caps_s['prefill']:.3f} s; launches made by the replays "
          f"{json.dumps(pl)}; keys (route, prefix capacity, chunk bucket) "
          f"{sorted(engine._prefill_graphs)}")
    check(pl.get("flash_causal", 0) > 0 and pl.get("flash_prefix", 0) > 0,
          "the serving path replayed no prefill graph holding K3 and K2")
    print(f"[model] held: {_held(engine)}")
    reused = finished[ids[3]].state.reused_chunks
    check(reused == 512 // pc.block_tokens,
          f"the shared-prefix request reused {reused} chunks, wanted 32")

    ttft = sorted((finished[i].t_first - finished[i].t_submit) * 1e3 for i in ids)
    tpot = sorted((finished[i].t_done - finished[i].t_first) * 1e3
                  / (len(finished[i].output) - 1) for i in ids)
    n_out = sum(len(finished[i].output) for i in ids)
    decode_s = sched.metrics.histogram(
        "istpu_serve_decode_step_seconds").labels().sum
    print(f"[model] {len(ids)} requests, {n_out} tokens in {wall:.3f} s; "
          f"TTFT ms min/median/max = {ttft[0]:.1f}/{statistics.median(ttft):.1f}"
          f"/{ttft[-1]:.1f}; TPOT ms min/median/max = {tpot[0]:.2f}/"
          f"{statistics.median(tpot):.2f}/{tpot[-1]:.2f}; decode "
          f"{n_out / decode_s:.1f} tok/s aggregate over {decode_s:.3f} s of "
          f"decode chunks ({card})")

    # one greedy decode step (K1 over pages written by the prefill kernels)
    # against a cold full prefill (K3) over the same tokens
    p = reqs[6][0]
    st = engine.prefill(p)
    first = engine.decode(st, 1)[0]
    dec = st.last_logits.float()
    engine.release(st)
    with torch.no_grad():
        cold, _ = prefill_forward(params, cfg,
                                  torch.tensor([p + [first]], device=dev))
    logits_agree(torch, dec, cold[0, -1],
                 f"[model] decode-step logits vs cold prefill ({len(p) + 1} "
                 f"tokens)")
    prof = phase_profile(torch, bench_gpu, engine,
                         [p for p, _n, _kw in reqs], card)
    # each request's TTFT by its prompt length (all 8 submitted at once)
    ttft_by_len = {len(p): (finished[i].t_first - finished[i].t_submit) * 1e3
                   for (p, _n, _kw), i in zip(reqs, ids)}
    return launches, prof, engine, ttft_by_len


def _device_time_by_kind(torch, prof):
    """Device ms by kind (matmul, K1, K3, K2, other), per-kernel rows (ms,
    count, name) and the kernel count of a ``torch.profiler`` trace."""
    groups: dict = {}
    top = []
    n_kernels = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us <= 0 or getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += e.count
        name = e.key.lower()
        kind = ("K1 paged_decode" if "paged_decode" in name else
                "K3 flash_causal" if "flash_causal" in name else
                "K2 flash_prefix" if "flash_prefix" in name else
                "matmul" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                    "nvjet", "cutlass",
                                                    "splitk"))
                else "other")
        groups[kind] = groups.get(kind, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:60]))
    return groups, top, n_kernels


def phase_profile(torch, bench_gpu, engine, prompts, card: str,
                  steps: int = 16) -> dict:
    """Where a cold prefill's and a decode step's time go.  Fresh
    1500- and 1100-token prompts prefilled through the prefill graphs,
    through the eager chunk body and whole in one eager forward (the serve
    default), bare (twice each, in turns) and under ``torch.profiler``
    (device time by kind, kernels per chunk), with the memory each holds;
    then each prefill key's replay against its eager body and the prefix
    copy's device time; then a ``steps``-token ``decode_batch`` at B=8
    through the graphs and through the eager step body, each timed bare and
    under the profiler (busy share against the bare wall time).  Returns,
    per run ("graph", "eager"), ms/step bare and busy (0 when the profiler
    saw no device time), kernels/step and host us per replay."""
    from torch.profiler import ProfilerActivity, profile

    # the device's kernels only: every number read here is a kernel's, and
    # the host ops' events would double the trace's post-processing
    kernels_only = [ProfilerActivity.CUDA]

    from infinistore_tpu_torch.engine import InferenceEngine

    # cold prefills of fresh 1500- and 1100-token prompts three ways:
    # "graph", 512-token chunks through the prefill graphs (the first
    # chunk K3, the others K2); "eager", the same chunk body run eagerly;
    # "whole", the serve CLI's default (``prefill_chunk`` None), the whole
    # prompt in one eager forward on an engine of its own.  Each is warmed
    # once (captures, cuBLAS), timed bare twice in turns, then once under
    # the profiler, with the allocator's peak over its resident bytes
    whole = InferenceEngine(engine.params, engine.cfg, dataclasses.replace(
        engine.pc, n_blocks=256), device=engine.device)

    def cold(n, name, seed):
        eng = whole if name == "whole" else engine
        pp = eng.prefill_start(torch.randint(
            0, eng.cfg.vocab_size, (n,),
            generator=torch.Generator().manual_seed(seed)).tolist())
        st = None
        while st is None:
            st = eng.prefill_step(pp, eager=name == "eager")
        eng.release(st)

    t_phase = time.perf_counter()
    modes = {1500: ("graph", "eager", "whole"), 1100: ("graph", "whole")}
    seeds = iter(range(100, 1000))
    pre: dict = {}
    for n, names in modes.items():
        for name in names:
            cold(n, name, next(seeds))  # warm-up: not timed
        for name in names * 2:
            replays0 = engine.graph_replays["prefill"]
            host0 = engine.graph_replay_s["prefill"]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cold(n, name, next(seeds))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            replays = engine.graph_replays["prefill"] - replays0
            r = pre.setdefault((n, name), {"wall_ms": []})
            r["wall_ms"].append(wall)
            r["replays"] = replays
            r["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            r["host_us_per_replay"] = (
                1e6 * (engine.graph_replay_s["prefill"] - host0) / replays
                if replays else None)
        for name in names:
            with profile(activities=kernels_only) as prof:
                cold(n, name, next(seeds))
                torch.cuda.synchronize()
            groups, top, n_kernels = _device_time_by_kind(torch, prof)
            busy = sum(groups.values())
            r = pre[(n, name)]
            r.update(busy_ms=busy, kernels=n_kernels)
            chunks = 1 if name == "whole" else -(-n // engine.prefill_chunk)
            how = ("whole prompt, one eager forward" if name == "whole" else
                   f"{chunks} chunks of {engine.prefill_chunk}")
            walls = ", ".join(f"{w:.3f}" for w in r["wall_ms"])
            if busy:
                by_kind = {k: round(v, 4) for k, v in sorted(
                    groups.items(), key=lambda kv: -kv[1])}
                print(f"[profile] cold prefill of {n} tokens ({how}) {name}: "
                      f"wall {walls} ms bare; device time {busy:.3f} ms in "
                      f"{n_kernels} kernels ({n_kernels / chunks:.0f} per "
                      f"chunk); allocator peak +{r['peak_mib']:.1f} MiB; "
                      f"ms by kind {json.dumps(by_kind)}")
                for ms, k, kname in sorted(top, reverse=True)[:6]:
                    print(f"[profile]   {ms:8.4f} ms  {k:5d}  {kname}")
            else:
                print(f"[profile] cold prefill of {n} tokens ({how}) {name}: "
                      f"wall {walls} ms bare; the profiler saw no device "
                      f"time: not measured")
    for n, names in modes.items():
        chunks = -(-n // engine.prefill_chunk)
        got = {name: pre[(n, name)] for name in names}
        replayed = {m: r["replays"] for m, r in got.items()}
        check(replayed == {m: chunks if m == "graph" else 0 for m in names},
              f"the cold prefill of {n} tokens replayed {replayed} prefill "
              f"graphs, wanted {chunks} through the graphs and 0 otherwise")
        best = {m: min(r["wall_ms"]) for m, r in got.items()}
        print(f"[profile] cold prefill of {n} tokens, best of 2 bare: "
              + ", ".join(f"{m} {ms:.3f} ms" for m, ms in best.items())
              + f"; graphs {best['whole'] / best['graph']:.2f}x against "
              f"the whole prompt eagerly; host "
              f"{got['graph']['host_us_per_replay']:.1f} us per replay "
              f"({card})")
    print(f"[profile] {engine.graph_captures['prefill']} prefill captures "
          f"in {engine.graph_capture_s['prefill']:.3f} s; "
          f"{len(engine._prefill_graphs)} keys "
          f"{sorted(engine._prefill_graphs)}")
    print(f"[profile] held, 512-token chunks: {_held(engine)}")
    print(f"[profile] held, whole prompt (serve default): {_held(whole)}")
    del whole
    print(f"[profile] cold prefills: {time.perf_counter() - t_phase:.1f} s "
          f"of the smoke's wall time")

    # each key's graph against its eager body at full width: one replay
    # and one eager run over the key's static buffers, logits and KV
    # torch.equal.  The keys share the logits row and the length: each
    # check sets them in range for its key (row 0, the whole buffer valid)
    for key, pg in sorted(engine._prefill_graphs.items()):
        if pg.graph is None:  # a key only the eager body has run
            continue
        with engine._on_engine_stream():
            pg.last.fill_(0)
            if pg.plen is not None:
                pg.plen.fill_(key[1])
            pg.graph.replay()
            replayed = [pg.logits.clone(), pg.kv.clone()]
            engine._prefill_body(pg)
            body = [pg.logits, pg.kv]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(replayed, body))
        print(f"[profile] prefill graph {key}: replay torch.equal to the "
              f"eager body (logits and KV): {same}")
        check(same, f"prefill graph {key} differs from its eager body")
    # the prefix copy into a key's static buffer before each K2 replay
    # (copy design: several partial prefills share a key), at 1024 rows
    pg = engine._prefill_graphs[("prefix", 1024, engine.prefill_chunk)]
    src = torch.randn_like(pg.buf, dtype=torch.float32).to(pg.buf.dtype)
    n_bytes = 2 * pg.buf.numel() * pg.buf.element_size()
    ms = bench_gpu.median_device_ms(
        torch, lambda: pg.buf[:, :, :, :1024].copy_(src[:, :, :, :1024]), 10,
        torch.empty(64 << 20, dtype=torch.uint8, device=pg.buf.device))
    print(f"[profile] prefix copy into a key's buffer, 1024 rows "
          f"({n_bytes / 2 ** 20:.0f} MiB read + written): {ms:.4f} ms "
          f"(bound {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes)")
    del src

    # the B=8 decode step through the graphs and through the eager step
    # body.  Both bare runs start from the same point: the states are
    # rewound (tokens, last logits) between them, and each rewrites the
    # same cache slots before reading them
    states = [engine.prefill(p) for p in prompts]
    engine._decode_batch(states, 2, eager=True)
    engine.decode_batch(states, 2)  # captures this key
    torch.cuda.synchronize()
    start = [(len(st.tokens), st.last_logits) for st in states]
    runs: dict = {}
    for name in ("eager", "graph"):
        for st, (n, logits) in zip(states, start):
            del st.tokens[n:]
            st.last_logits = logits
        replays0 = engine.graph_replays["decode"]
        host0 = engine.graph_replay_s["decode"]
        t0 = time.perf_counter()
        toks = engine._decode_batch(states, steps, eager=name == "eager")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        replays = engine.graph_replays["decode"] - replays0
        host_s = engine.graph_replay_s["decode"] - host0
        runs[name] = {
            "wall_ms": wall_ms / steps, "tokens": toks,
            "logits": torch.stack([st.last_logits for st in states]),
            "host_us_per_replay": (1e6 * host_s / replays) if replays
            else None,
        }
    same_toks = runs["eager"]["tokens"] == runs["graph"]["tokens"]
    same_logits = torch.equal(runs["eager"]["logits"],
                              runs["graph"]["logits"])
    print(f"[profile] B={len(states)} greedy tokens graph == eager body: "
          f"{same_toks}; final logits torch.equal: {same_logits}")
    check(same_toks and same_logits,
          "the graph-replayed decode differs from the eager step body")
    for name, r in runs.items():
        with profile(activities=kernels_only) as prof:
            engine._decode_batch(states, steps, eager=name == "eager")
            torch.cuda.synchronize()
        groups, top, n_kernels = _device_time_by_kind(torch, prof)
        busy = sum(groups.values())
        r.update(busy_ms=busy / steps, kernels=n_kernels / steps)
        per_step = {k: round(v / steps, 4) for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])}
        if busy:
            print(f"[profile] decode B={len(states)} {name}: "
                  f"{r['wall_ms']:.3f} ms/step bare; device busy "
                  f"{busy / steps:.3f} ms/step "
                  f"({100 * busy / steps / r['wall_ms']:.1f}% of the bare "
                  f"wall time); {n_kernels / steps:.0f} kernels/step; "
                  f"ms/step by kind {json.dumps(per_step)}")
        else:
            print(f"[profile] decode B={len(states)} {name}: "
                  f"{r['wall_ms']:.3f} ms/step bare; the profiler saw no "
                  f"device time: busy share not measured")
    for st in states:
        engine.release(st)
    g = runs["graph"]
    n_cap = engine.graph_captures["decode"]
    cap_s = engine.graph_capture_s["decode"]
    print(f"[profile] decode B=8 graph {g['wall_ms']:.3f} ms/step vs eager "
          f"body {runs['eager']['wall_ms']:.3f} ms/step "
          f"({runs['eager']['wall_ms'] / g['wall_ms']:.2f}x); host "
          f"{g['host_us_per_replay']:.2f} us per replay; "
          f"{n_cap} captures in {cap_s:.3f} s ({1e3 * cap_s / n_cap:.1f} ms "
          f"each); {len(engine._graphs)} graphs ({card})")
    return runs


def phase_overhead(torch, ca, bench_gpu, prof: dict) -> dict:
    """The invocation-overhead leg (K4's path), beside the profiled B=8
    decode step, eager and through the graph.  Returns its launch
    counts."""
    out: dict = {}
    ca.reset_launches()
    torch.cuda.synchronize()
    bench_gpu.leg_invocation_overhead(out)
    torch.cuda.synchronize()
    launches = dict(ca.LAUNCHES)
    print(f"[overhead] launches on the overhead path: {json.dumps(launches)}")
    check(launches["paged_decode_alllayers"] > 0 and launches["paged_decode"] > 0,
          f"the overhead path did not launch K4 and K1: {launches}")
    print(f"[overhead] {json.dumps(out)}")
    e, g = prof["eager"], prof["graph"]
    if e["busy_ms"] and g["busy_ms"]:
        # the eager step idles the device while the host issues launches;
        # the graph replays them without the host
        print(f"[overhead] decode B=8 step, eager body: {e['wall_ms']:.3f} "
              f"ms bare, device busy {e['busy_ms']:.3f} ms (idle "
              f"{100 * (1 - e['busy_ms'] / e['wall_ms']):.1f}%), host "
              f"{1e3 * e['wall_ms'] / e['kernels']:.2f} us per launch over "
              f"{e['kernels']:.0f} launches, against "
              f"{1e3 * out['invoc_host_ms_per_launch']:.2f} us to issue one "
              f"K1 alone; graph: {g['wall_ms']:.3f} ms bare, busy "
              f"{g['busy_ms']:.3f} ms (idle "
              f"{100 * (1 - g['busy_ms'] / g['wall_ms']):.1f}%)")
    return launches


def _http(port: int, method: str, path: str, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _sse_stream(port: int, body: dict, headers=None):
    """A streamed completion up to [DONE]: its token ids and, per event
    that carried tokens, (seconds since the request was sent, tokens so
    far)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/completions",
                 json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    check(resp.status == 200, f"streamed request answered {resp.status}")
    toks, stamps, buf, done = [], [], b"", False
    while not done:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            event, buf = buf.split(b"\n\n", 1)
            if not event.startswith(b"data: "):
                continue  # an SSE comment line
            payload = event[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                break
            new = json.loads(payload)["choices"][0]["token_ids"]
            if new:
                toks.extend(new)
                stamps.append((time.perf_counter() - t0, len(toks)))
    conn.close()
    check(done, "the stream ended without [DONE]")
    return toks, stamps


def phase_serve(torch, ca, engine, cfg, card: str) -> None:
    """The port's ``ServingServer`` on the Llama-3-8B engine, in-process on
    an ephemeral port: the OpenAI surface through the graph-captured
    decode.  Twin requests use prompts shorter than a page, so neither
    adopts the other's prefix and both compute the same thing."""
    from infinistore_tpu_torch.serve import ServingServer

    # the OpenAI contract, not the overload control loop: the first
    # requests pay graph captures, which must not trip SLO shedding
    os.environ["ISTPU_ADMISSION"] = "0"
    srv = ServingServer(engine, port=0, max_batch=8,
                        model_id="llama-3-8b-random")
    srv.start()
    rng = torch.Generator().manual_seed(77)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    def complete(body):
        status, data = _http(srv.port, "POST", "/v1/completions", body)
        out = json.loads(data)
        check(status == 200, f"serve: {body} answered {status}: {out}")
        return out["choices"][0]

    try:
        ca.reset_launches()
        replays0 = engine.graph_replays["decode"]
        t0 = time.perf_counter()
        p = prompt(12)
        greedy = complete({"prompt": p, "max_tokens": 16, "temperature": 0})
        streamed, _stamps = _sse_stream(srv.port, {
            "prompt": p, "max_tokens": 16, "temperature": 0})
        print(f"[serve] greedy {len(greedy['token_ids'])} tokens; streamed "
              f"twin equal: {streamed == greedy['token_ids']}")
        check(streamed == greedy["token_ids"],
              "the streamed completion differs from its non-streamed twin")
        q = prompt(10)
        seeded = [complete({"prompt": q, "max_tokens": 16, "temperature": 0.8,
                            "top_p": 0.95, "seed": 1234})["token_ids"]
                  for _ in range(2)]
        print(f"[serve] seeded twice: equal {seeded[0] == seeded[1]}")
        check(seeded[0] == seeded[1], "a seeded request did not reproduce")
        lp = complete({"prompt": prompt(9), "max_tokens": 8,
                       "temperature": 0, "logprobs": 5})["logprobs"]
        ok_lp = (len(lp["token_logprobs"]) == 8
                 and all(len(t) == 5 for t in lp["top_logprobs"])
                 and all(abs(c - max(t.values())) < 1e-3
                         for c, t in zip(lp["token_logprobs"],
                                         lp["top_logprobs"])))
        print(f"[serve] logprobs=5: 8 records, chosen = best of top 5: {ok_lp}")
        check(ok_lp, f"logprobs records malformed: {lp}")
        pen = complete({"prompt": prompt(11), "max_tokens": 16,
                        "temperature": 0, "presence_penalty": 1.0,
                        "frequency_penalty": 0.5,
                        "repetition_penalty": 1.3})["token_ids"]
        check(len(pen) == 16 and all(0 <= t < cfg.vocab_size for t in pen),
              f"penalized completion malformed: {pen}")
        forced = 4242
        biased = complete({"prompt": prompt(8), "max_tokens": 6,
                           "temperature": 0,
                           "logit_bias": {str(forced): 100}})["token_ids"]
        print(f"[serve] penalized: {len(pen)} tokens; logit_bias +100 on "
              f"{forced}: {biased}")
        check(biased == [forced] * 6, f"logit_bias did not force: {biased}")
        wall = time.perf_counter() - t0
        status, metrics = _http(srv.port, "GET", "/metrics")
        text = metrics.decode()
        check(status == 200 and all(f in text for f in (
            "istpu_serve_requests_total", "istpu_serve_ttft_seconds",
            "istpu_engine_dispatches_total", "istpu_engine_retraces_total")),
            "serve: /metrics lacks a family")
        status, data = _http(srv.port, "GET", "/debug/engine?limit=4")
        eng = json.loads(data)
        check(status == 200 and eng["enabled"] and eng["summary"]["steps"] > 0,
              f"serve: /debug/engine: {eng}")
        launches = dict(ca.LAUNCHES)
        replays = engine.graph_replays["decode"] - replays0
        print(f"[serve] 7 requests in {wall:.3f} s; /debug/engine: "
              f"{eng['summary']['steps']} steps, {eng['summary']['compiles']} "
              f"graph captures ({eng['summary']['compile_s']:.3f} s), "
              f"dispatches {json.dumps(eng['summary']['dispatches'])}; "
              f"{replays} graph replays; launches {json.dumps(launches)} "
              f"({card})")
        check(replays > 0 and launches["paged_decode"] > 0,
              "the serve path did not decode through the graphs and K1")
    finally:
        srv.close()
        os.environ.pop("ISTPU_ADMISSION", None)


def _start_store(prealloc_gib: int, min_alloc_kib: int):
    """The port's own store server (asyncio backend) in a subprocess, from
    this checkout; returns (process, service port).  ``min_alloc_kib``: the
    pool's allocation unit, one full-precision page, so a band's pages sit
    in one contiguous run of the pool."""
    import os
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    port, mport = free_port(), free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.server",
         "--service-port", str(port), "--manage-port", str(mport),
         "--prealloc-size", str(prealloc_gib),
         "--minimal-allocate-size", str(min_alloc_kib),
         "--log-level", "warning", "--backend", "python"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    deadline = time.time() + 120
    while True:
        if proc.poll() is not None:
            raise RuntimeError(f"the store server exited ({proc.returncode})")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            return proc, port
        except OSError:
            if time.time() > deadline:
                proc.kill()
                raise RuntimeError("the store server did not come up")
            time.sleep(0.2)


def _store_case(torch, dev, params, cfg, pc, port: int, transport: str,
                quant, seed: int) -> None:
    """Engine A prefills a fresh 1500-token prompt into the store; engine B
    (same weights, own connection and cache) adopts its pages and computes
    only the tail; both decode 32 greedy tokens."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM, TYPE_TCP
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import (chunk_keys, dequantize_pages,
                                          pages_to_seq_kv, quantize_pages,
                                          read_pages)
    from infinistore_tpu_torch.models import prefill_forward

    tag = f"[store {transport} kv_quant={quant}]"
    ctype = TYPE_SHM if transport == "shm" else TYPE_TCP
    conns = []
    engines = []
    try:
        for _ in range(2):
            c = lib.InfinityConnection(ClientConfig(
                host_addr="127.0.0.1", service_port=port,
                connection_type=ctype, log_level="warning"))
            c.connect()
            conns.append(c)
            engines.append(InferenceEngine(params, cfg, pc, conn=c,
                                           kv_quant=quant, prefill_chunk=512,
                                           model_id=f"smoke-{transport}"))
        a, b = engines
        gen = torch.Generator().manual_seed(seed)
        # warm-up on a 1500-token prompt of its own: A's first push
        # page-locks the store's pool mapping, B's first load allocates
        # pinned staging, and A captures the prefill graphs of the timed
        # prompt's keys: one-time costs kept out of the timed hop
        warm = torch.randint(0, cfg.vocab_size, (1500,), generator=gen
                             ).tolist()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.release(a.prefill(warm))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b.release(b.prefill(warm))
        torch.cuda.synchronize()
        print(f"{tag} warm-up (1500 tokens): A's first prefill and push "
              f"{(t1 - t0) * 1e3:.3f} ms"
              f"{' (page-locks the pool)' if transport == 'shm' else ''}, "
              f"B's first adoption {(time.perf_counter() - t1) * 1e3:.3f} ms")
        prompt = torch.randint(0, cfg.vocab_size, (1500,), generator=gen
                               ).tolist()
        want_chunks = (len(prompt) - 1) // pc.block_tokens
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sa = a.prefill(prompt)
        torch.cuda.synchronize()
        ttft_a = (time.perf_counter() - t0) * 1e3
        push = dict(a.transfer.last_push_stages)
        t0 = time.perf_counter()
        sb = b.prefill(prompt)
        torch.cuda.synchronize()
        ttft_b = (time.perf_counter() - t0) * 1e3
        load = dict(b.transfer.last_load_stages)
        print(f"{tag} A cold prefill {ttft_a:.3f} ms ({len(prompt)} tokens, "
              f"{len(prompt) // pc.block_tokens} chunks pushed, strict "
              f"durability); B store-adopted prefill {ttft_b:.3f} ms "
              f"(reused_chunks={sb.reused_chunks}, store_chunks="
              f"{sb.store_chunks}, store hops {sb.store_load_s * 1e3:.3f} ms)")
        print(f"{tag} A's last push stages {json.dumps(push)}")
        print(f"{tag} B's load stages {json.dumps(load)}; load "
              f"{load['bytes'] / (load['fetch_s'] + load['scatter_s']) / 1e9:.3f}"
              f" GB/s")
        check(sb.reused_chunks == want_chunks,
              f"{tag} B reused {sb.reused_chunks} chunks, wanted {want_chunks}")
        if transport == "shm":
            n_bands = min(a.transfer.pipeline_groups, cfg.n_layers)
            check(push["zero_copy_bands"] == n_bands
                  and push["staged_bands"] == 0,
                  f"{tag} the push was not zero-copy: {push}")
        ids = torch.tensor(sa.block_ids[:want_chunks], device=dev)
        pages_a = read_pages(a.cache, ids)
        pages_b = read_pages(b.cache, torch.tensor(sb.block_ids[:want_chunks],
                                                   device=dev))
        if quant:  # A's pages after the plain quantize/dequantize round trip
            pages_a = dequantize_pages(quantize_pages(
                pages_a.permute(0, 3, 1, 2, 4, 5).contiguous()), pc
            ).permute(0, 2, 3, 1, 4, 5)
        same = torch.equal(pages_a, pages_b)
        print(f"{tag} B's {want_chunks} adopted chunks bitwise equal to A's"
              f"{' after the int8 round trip' if quant else ''}: {same}")
        check(same, f"{tag} adopted pages differ from A's")
        # B's first-token logits against the tail computed over the pages B
        # was meant to adopt (A's pages, after the int8 round trip when
        # quantized), then against A's own logits: with full-precision
        # pages those must agree too; int8 pages legitimately move them
        # (per-head int8 noise on every K and V), so there the max error is
        # reported and only the cosine is held
        P = want_chunks * pc.block_tokens
        tail = prompt[P:] + [0] * ((-(len(prompt) - P)) % pc.block_tokens)
        ref, _ = prefill_forward(params, cfg, torch.tensor([tail], device=dev),
                                 prefix_kv=pages_to_seq_kv(pages_a))
        logits_agree(torch, sb.last_logits, ref[0, len(prompt) - P - 1],
                     f"{tag} B's first-token logits vs the tail over the "
                     f"adopted pages")
        logits_agree(torch, sb.last_logits, sa.last_logits,
                     f"{tag} B's first-token logits vs A's",
                     max_err=quant is None)
        ta = a.decode(sa, 32)
        tb = b.decode(sb, 32)
        agree = sum(x == y for x, y in zip(ta, tb))
        print(f"{tag} greedy decode: {agree} of 32 tokens agree")
        # the push and load rates of the same 93 chunks outside the prefill
        keys = chunk_keys(prompt, f"smoke-rate-{transport}",
                          chunk_tokens=pc.block_tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_bytes = a.transfer.save_pages(a.cache, sa.block_ids[:want_chunks],
                                        keys[:want_chunks])
        push_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b.transfer.load_pages(b.cache, sb.block_ids[:want_chunks],
                              keys[:want_chunks])
        load_s = time.perf_counter() - t0
        print(f"{tag} save_pages of {want_chunks} chunks ({n_bytes} bytes): "
              f"{push_s * 1e3:.3f} ms, {n_bytes / push_s / 1e9:.3f} GB/s, "
              f"stages {json.dumps(a.transfer.last_push_stages)}; load_pages: "
              f"{load_s * 1e3:.3f} ms, {n_bytes / load_s / 1e9:.3f} GB/s, "
              f"stages {json.dumps(b.transfer.last_load_stages)}")
        for e, st in ((a, sa), (b, sb)):
            e.release(st)
    finally:
        for e in engines:
            e.transfer.close()
        for c in conns:
            c.close()


def phase_store(torch, ca, dev, params, cfg, pc, port: int) -> dict:
    """The store hop through the store server on ``port``, shm with
    full-precision pages, then TCP with int8 pages; returns the launch
    counts over both."""
    ca.reset_launches()
    torch.cuda.synchronize()
    _store_case(torch, dev, params, cfg, pc, port, "shm", None, seed=11)
    _store_case(torch, dev, params, cfg, pc, port, "tcp", "int8", seed=12)
    torch.cuda.synchronize()
    launches = dict(ca.LAUNCHES)
    print(f"[store] launches on the store path: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in MODEL_PATH_KERNELS),
          f"a kernel was not launched on the store path: {launches}")
    return launches


FLEET_LENGTHS = (512, 612, 700, 812, 900, 1000, 1200, 1500)


def _fleet_requests(port: int, prompts, tag: str, trace_ids, concurrent):
    """Stream each prompt through the router (greedy, 32 new tokens), one
    at a time or all at once; returns, per prompt, (tokens, TTFT ms, TPOT
    ms) as the client sees them, TPOT over the events after the first.
    Each request carries its own trace id, which the router propagates to
    the workers' ledgers."""
    import threading

    out = [None] * len(prompts)

    def one(i):
        toks, stamps = _sse_stream(
            port, {"prompt": prompts[i], "max_tokens": 32, "temperature": 0},
            headers={"X-Istpu-Trace": trace_ids[i]})
        check(len(toks) == 32, f"{tag} request {i} returned {len(toks)} "
              f"tokens, wanted 32")
        (t_first, n_first), (t_last, n_last) = stamps[0], stamps[-1]
        tpot = ((t_last - t_first) * 1e3 / (n_last - n_first)
                if n_last > n_first else 0.0)
        out[i] = (toks, t_first * 1e3, tpot)

    if not concurrent:
        for i in range(len(prompts)):
            one(i)
        return out
    errors = []

    def run(i):
        try:
            one(i)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not errors and all(not t.is_alive() for t in threads),
          f"{tag} concurrent requests failed: {errors}")
    return out


def phase_fleet(torch, ca, dev, params, cfg, pc, card: str,
                monolith_ttft: dict, port: int) -> dict:
    """The disaggregated fleet at full width, in one process: the port's
    store server on ``port`` backs a prefill worker and a decode worker
    (the port's ``InferenceEngine`` + ``ServingServer`` each, on the
    phase's Llama-3-8B, lossless pages) behind the port's ``FrontDoor``,
    composed as
    ``local_fleet`` composes them.  8 fresh prompts through the router one
    at a time, then 8 more at once, all streamed: every answer 200 with no
    router 5xx, each decode record adopting the chunks the adoption rule
    allows, each sequential request's adopted pages bitwise equal to the
    prefill worker's, its first token equal to the prefill worker's own
    local answer, and K1/K2/K3 launched on the path by the two workers'
    engine threads and no other thread.  Then the four-process tiny fleet
    (``examples.fleet_processes --smoke``) on the card, whose workers must
    launch K3 and K1 too.  Returns the launch counts over the routed
    traffic."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.frontdoor import compose_routers
    from infinistore_tpu_torch.kv import chunk_keys, read_pages
    from infinistore_tpu_torch.serve import ServingServer
    from infinistore_tpu_torch.utils.metrics import parse_prometheus_text

    model_id = "fleet-llama-3-8b-random"
    T = pc.block_tokens
    t_phase = time.perf_counter()
    conns, engines, servers, routers = [], [], {}, []
    # the OpenAI contract through the fleet, not the overload loop: the
    # first requests pay graph captures, which must not trip shedding
    os.environ["ISTPU_ADMISSION"] = "0"
    try:
        for role in ("prefill", "decode"):
            c = lib.InfinityConnection(ClientConfig(
                host_addr="127.0.0.1", service_port=port,
                connection_type=TYPE_SHM, op_timeout_s=60.0,
                log_level="warning"))
            c.connect()
            conns.append(c)
            # decode_chunk 8: tokens show every 8 steps, so the client
            # reads a TPOT within 32 new tokens
            eng = InferenceEngine(params, cfg, pc, conn=c, kv_quant=None,
                                  prefill_chunk=512, decode_chunk=8,
                                  model_id=model_id, device=dev)
            engines.append(eng)
            srv = ServingServer(eng, port=0, max_batch=8, model_id=model_id,
                                role=role)
            srv.start()
            servers[role] = srv
        t_workers = time.perf_counter() - t_phase
        pre, dec = servers["prefill"], servers["decode"]
        routers = compose_routers([f"http://127.0.0.1:{pre.port}"],
                                  [f"http://127.0.0.1:{dec.port}"],
                                  poll_s=0.5)
        fd = routers[0]
        rng = torch.Generator().manual_seed(91)

        def prompt(n):
            return torch.randint(0, cfg.vocab_size, (n,), generator=rng
                                 ).tolist()

        # warm-up through the router on prompts of their own, one of each
        # timed length (kernels' first launches, cuBLAS, the decode
        # worker's B=1 graph, both workers page-locking the pool, the
        # prefill worker capturing the prefill graphs of the timed
        # prompts' keys): not counted, not timed
        t_setup = time.perf_counter() - t_phase
        warm = [prompt(n) for n in (100, *FLEET_LENGTHS)]
        _fleet_requests(fd.port, warm, "[fleet] warm-up",
                        [f"fleet-warm-{i}" for i in range(len(warm))],
                        concurrent=False)
        t_warm = time.perf_counter() - t_phase - t_setup
        seq = [prompt(n) for n in FLEET_LENGTHS]
        par = [prompt(n + 5 if n < 1500 else n - 5)  # fresh, other lengths
               for n in FLEET_LENGTHS]
        seq_ids = [f"fleet-seq-{i}" for i in range(len(seq))]
        par_ids = [f"fleet-par-{i}" for i in range(len(par))]
        status, data = _http(fd.port, "GET", "/metrics")
        handoff0 = parse_prometheus_text(data.decode())

        ca.reset_launches()
        def prefill_account(e):
            return (e.graph_replays["prefill"], e.graph_captures["prefill"],
                    e.graph_capture_s["prefill"], e.graph_launches("prefill"))

        prefill0 = [prefill_account(e) for e in engines]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adopted_equal = []
        seq_out = []
        for i in range(len(seq)):
            seq_out += _fleet_requests(fd.port, seq[i:i + 1], "[fleet]",
                                       seq_ids[i:i + 1], concurrent=False)
            # the handoff is byte-exact: the decode worker's adopted pages
            # against the prefill worker's under the same chunk keys
            n = (len(seq[i]) - 1) // T
            keys = chunk_keys(seq[i], model_id, chunk_tokens=T)[:n]
            pages = []
            for eng in engines:
                ids = [eng.pages._key_to_block.get(k) for k in keys]
                check(None not in ids, f"[fleet] request {i}: a chunk is not "
                      f"resident on a worker")
                pages.append(read_pages(eng.cache, torch.tensor(ids,
                                                                device=dev)))
            adopted_equal.append(torch.equal(*pages))
        t_seq = time.perf_counter() - t0
        status, data = _http(fd.port, "GET", "/metrics")
        handoff1 = parse_prometheus_text(data.decode())
        t0 = time.perf_counter()
        par_out = _fleet_requests(fd.port, par, "[fleet]", par_ids,
                                  concurrent=True)
        t_par = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(ca.LAUNCHES)
        by_thread = {t: dict(c) for t, c in ca.BY_THREAD.items()}
        workers = {srv._engine_thread.ident: role
                   for role, srv in servers.items()}
        by_worker = {role: by_thread.get(t, dict.fromkeys(launches, 0))
                     for t, role in workers.items()}
        # the prefill graphs each worker replayed over the routed traffic,
        # the kernel launches those replays made, and the keys it captured
        # there (each a first-use eager chunk plus a capture in some
        # request's TTFT)
        replayed = {}
        for role, e, (n0, c0, s0, l0) in zip(("prefill", "decode"), engines,
                                             prefill0):
            n1, c1, s1, l1 = prefill_account(e)
            replayed[role] = {
                "replays": n1 - n0, "captures": c1 - c0,
                "capture_s": round(s1 - s0, 3),
                "launches": {k: v - l0.get(k, 0) for k, v in l1.items()}}
        print(f"[fleet] launches on the fleet path: {json.dumps(launches)}; "
              f"by worker {json.dumps(by_worker)}; prefill graph replays by "
              f"worker {json.dumps(replayed)}")
        for role, e in zip(("prefill", "decode"), engines):
            print(f"[fleet] held, {role} worker: {_held(e)}")
        pl = replayed["prefill"]["launches"]
        check(pl.get("flash_causal", 0) > 0 and pl.get("flash_prefix", 0) > 0,
              f"[fleet] the prefill worker replayed no prefill graphs holding "
              f"K3 and K2: {replayed['prefill']}")
        check(all(launches[k] > 0 for k in MODEL_PATH_KERNELS),
              f"a kernel was not launched on the fleet path: {launches}")
        others = {t: c for t, c in by_thread.items()
                  if t not in workers and any(c.values())}
        check(not others, f"[fleet] threads other than the two workers' "
              f"engine threads launched kernels: {others}")
        print(f"[fleet] adopted pages torch.equal to the prefill worker's, "
              f"per sequential request: {adopted_equal}")
        check(all(adopted_equal), "[fleet] adopted pages differ from the "
              "prefill worker's")

        # the decode worker's ledger: every request adopted the chunks
        # the adoption rule allows, (prompt tokens - 1) // T
        status, data = _http(dec.port, "GET", "/debug/requests?limit=64")
        recs = {r["trace_id"]: r for r in json.loads(data)["records"]}
        rows = []
        for p, tid, (toks, ttft, tpot) in zip(seq + par, seq_ids + par_ids,
                                              seq_out + par_out):
            rec = recs.get(tid)
            check(rec is not None, f"[fleet] no decode record for {tid}")
            st = rec["store"]
            check(st["store_chunks"] == (len(p) - 1) // T,
                  f"[fleet] {tid} ({len(p)} tokens) adopted "
                  f"{st['store_chunks']} chunks from the store, wanted "
                  f"{(len(p) - 1) // T}")
            rows.append((tid, len(p), ttft, tpot, st["store_chunks"],
                         st["load_s"]))
        status, data = _http(fd.port, "GET", "/metrics")
        prom = parse_prometheus_text(data.decode())
        fivexx = prom.get(("istpu_fd_requests_total", (("class", "5xx"),)))
        check(fivexx == 0.0, f"[fleet] the router served 5xx: {fivexx}")

        def handoffs(a, b):
            """(count, mean ms) of the prefill legs between two reads."""
            n = (b[("istpu_fd_handoff_seconds_count", ())]
                 - a[("istpu_fd_handoff_seconds_count", ())])
            return n, 1e3 * (b[("istpu_fd_handoff_seconds_sum", ())]
                             - a[("istpu_fd_handoff_seconds_sum", ())]) / n
        status, data = _http(fd.port, "GET", "/debug/fleet")
        handoff = json.loads(data)["handoff"]

        # the oracle: the prefill worker's own local answer to each
        # sequential prompt (it reuses the pages it pushed); not counted
        t_oracle = time.perf_counter()
        oracle_first = oracle_all = 0
        for p, (toks, _ttft, _tpot) in zip(seq, seq_out):
            status, data = _http(pre.port, "POST", "/v1/completions",
                                 {"prompt": p, "max_tokens": 32,
                                  "temperature": 0})
            check(status == 200, f"[fleet] oracle answered {status}")
            want = json.loads(data)["choices"][0]["token_ids"]
            oracle_first += want[0] == toks[0]
            oracle_all += want == toks
        print(f"[fleet] routed greedy tokens vs the prefill worker's local "
              f"answer: first token equal {oracle_first}/{len(seq)}, whole "
              f"32-token sequence equal {oracle_all}/{len(seq)}")
        check(oracle_first == len(seq),
              "[fleet] a routed first token differs from the local oracle")
        print(f"[fleet] phase wall: set-up {t_setup:.1f} s (workers "
              f"{t_workers:.1f} s), warm-up "
              f"{t_warm:.1f} s, routed traffic {t_seq + t_par:.1f} s, "
              f"oracle {time.perf_counter() - t_oracle:.1f} s")

        for tid, n, ttft, tpot, chunks, load_s in rows:
            mono = monolith_ttft.get(n)
            print(f"[fleet] {tid}: {n} prompt tokens, TTFT {ttft:.1f} ms, "
                  f"TPOT {tpot:.2f} ms through the router; decode worker "
                  f"store_chunks={chunks}, store_load_s={load_s}"
                  + (f"; serving-phase monolith TTFT {mono:.1f} ms"
                     if mono is not None else ""))
        for name, out, wall, (n_h, mean_h) in (
                ("one at a time", seq_out, t_seq, handoffs(handoff0, handoff1)),
                ("all 8 at once", par_out, t_par, handoffs(handoff1, prom))):
            print(f"[fleet] {name}: 8 requests in {wall:.3f} s; TTFT median "
                  f"{statistics.median(o[1] for o in out):.1f} ms, TPOT "
                  f"median {statistics.median(o[2] for o in out):.2f} ms "
                  f"through the router; istpu_fd_handoff_seconds (the "
                  f"prefill leg) mean {mean_h:.1f} ms over {n_h:.0f}")
        n_h, mean_h = handoffs(handoff0, prom)
        print(f"[fleet] istpu_fd_handoff_seconds: {n_h:.0f} handoffs, mean "
              f"{mean_h:.1f} ms; /debug/fleet p50/p99 "
              f"{handoff['p50_ms']}/{handoff['p99_ms']} ms; decode "
              f"store_load_s median "
              f"{statistics.median(r[5] for r in rows):.4f} s; 5xx "
              f"{fivexx:.0f}; in one process, so the two workers' host "
              f"threads share one interpreter ({card})")
    finally:
        for r in routers:
            r.close()
        for srv in servers.values():
            srv.close()
        for e in engines:
            e.transfer.close()
        for c in conns:
            c.close()
        os.environ.pop("ISTPU_ADMISSION", None)

    # the deployment shape: four OS processes (store, prefill worker,
    # decode worker, router) on the tiny model, the workers on the card
    t0 = time.perf_counter()
    # a session of its own, so a timeout ends the workers it started too
    run = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.examples.fleet_processes",
         "--smoke", "--device", "cuda"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = run.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(run.pid, signal.SIGKILL)
        out, _ = run.communicate()
    for line in out.splitlines():
        if line.startswith("[fleet]") and "starting" not in line:
            print(f"[fleet] four processes: {line}")
    print(f"[fleet] four-process fleet (store, prefill, decode, router) "
          f"exited {run.returncode} in {time.perf_counter() - t0:.1f} s")
    check(run.returncode == 0, f"[fleet] the four-process fleet failed: "
          f"{out[-3000:]}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import numpy as np

        import bench_gpu
        from infinistore_tpu_torch.ops import build
        from infinistore_tpu_torch.ops import cuda_attention as ca
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    phase_build(build)
    with torch.no_grad():
        rec = phase_kernels(torch, np, ca, bench_gpu, dev)
        params, cfg, pc = llama3_8b(torch, dev)
        launches, prof, engine, ttft_by_len = phase_model(
            torch, ca, bench_gpu, dev, card, params, cfg, pc)
        phase_serve(torch, ca, engine, cfg, card)
        del engine
        overhead = phase_overhead(torch, ca, bench_gpu, prof)
        # one store server (4 GiB pool in /dev/shm) for the store and
        # fleet phases; its allocation unit is one full-precision page, so
        # a band's pages sit in one contiguous run of the pool
        t_store = time.perf_counter()
        store, port = _start_store(
            prealloc_gib=4, min_alloc_kib=max(16, pc.page_bytes // 1024))
        print(f"[store] the port's store server up in "
              f"{time.perf_counter() - t_store:.1f} s")
        try:
            phase_store(torch, ca, dev, params, cfg, pc, port)
            # the earlier phases' engines are gone: the card holds the
            # weights and the fleet's two caches
            torch.cuda.empty_cache()
            phase_fleet(torch, ca, dev, params, cfg, pc, card, ttft_by_len,
                        port)
        finally:
            store.terminate()
            try:
                store.wait(timeout=30)
            except subprocess.TimeoutExpired:
                store.kill()
                store.wait()
    # each kernel's launches over the path that runs it: K1-K3 the serving
    # path (K2's device-length entry: the K2 launches whose caller passed
    # the length as a device tensor, as the prefill graphs do), K4 the
    # overhead path
    launches["paged_decode_alllayers"] = overhead["paged_decode_alllayers"]
    kernels = [{
        "name": r["name"], "route": "cuda", "source": r["source"],
        "replaces": r["replaces"], "launches": launches[key],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    } for key, r in rec.items()]
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
