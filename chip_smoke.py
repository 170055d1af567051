#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``infinistore_tpu_torch``) on one GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build: compile the port's CUDA kernels from ``infinistore_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source, in parallel) and, beside them, the
   native store runtime from ``src/`` (``g++``), print the card's name
   and power limit, print the paged-decode kernels' registers, shared
   memory and spills (any local memory fails), and count each kernel's
   tensor-core instructions (``cuobjdump -sass``: HGMMA, HMMA); the bf16
   flash kernels must hold HGMMA;
2. kernels: every kernel against its plain PyTorch version on the card at
   the main path's shapes (H=32, H_kv=8, D=128, T=16; K1-K3 also at the
   four-process fleet's TINY shapes, D=32, and at the speculation draft's,
   D=64), bf16 and f32 (K1 at
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
4b. speculation path: the Llama-3-8B target (a 256-page cache of its own)
   through ``Scheduler`` with a speculator at k = 4, 64 greedy tokens at
   B = 1 on fresh prompts: (a) a draft with Llama-3.2-1B's widths (random
   bf16 weights of its own seed), (b) the target's weights in a second
   engine (self-draft), (c) n-gram proposals (g = 2) on a prompt repeating
   a 64-token sequence; (b) also with ``spec_batch`` 4 on four requests and
   sampled twice from one generator state (equal).  Fails unless each
   timed run took the round graphs (``spec_round`` dispatches, one eager
   round per key, no lockstep decode, no host round loop), (a)'s and (b)'s
   round graphs hold K1 (D = 64 and 128) and (c)'s none, every greedy
   token is the teacher-forced argmax or within ``TOL["bfloat16"]``
   (relative) of its logit, and each key's replay is ``torch.equal`` to its
   eager round body.  Prints acceptance, tokens per round, rounds per
   dispatch, syncs per chunk, ms per token beside plain B=1 graph decode on
   the same prompt, device ms and kernels per round (``torch.profiler``),
   captures, keys and their buffers;
5. overhead path: ``bench_gpu.leg_invocation_overhead`` (32 K1 launches in
   a CUDA graph, the same eagerly, one K4 launch, the plain version) beside
   the eager and graph decode steps of phase 3;
6. store path: the port's own store servers in subprocesses, the asyncio
   one (kept for the fleet path) and the native runtime; on each, engine A
   prefills a fresh 1500-token prompt into it, engine B (same weights,
   its own connection and cache) adopts the 93 stored chunks and computes
   only the tail through a prefill graph (its K2 launches counted; none
   fails), shm with bf16 pages, then TCP with int8 pages; adopted pages
   bitwise equal to A's, first-token logits close, on the asyncio runtime
   every push band straight into the page-locked shm pool; no staging
   allocated by the timed load; per case the stage split (lookup, the
   client's desc/copy/verify, fetch, scatter, tail), B's adopted prefill
   beside B's store-free cold prefill, and the same hop with one staging
   slot cold (the allocation inside the hop), push/load rates;
6b. cluster path (after the lora and tp paths, the native server of phase 6
   stopped): three of the port's native store nodes (2 GiB /dev/shm pools),
   engines A (strict durability) and B each on a ``RoutedStorePool`` over
   them (replicas 2, native clients, lossless bf16 pages); A pins and
   prefills four fresh 1500-token prompts in 16-token chunks (each chunk
   on two nodes); B adopts P1's 93 chunks with every node up, then the
   node owning most of P2's chunks is killed by process and B adopts P2's,
   P3's and P4's 93 chunks from the survivors; each adoption's pages, its
   first-token logits and its 16 greedy tokens bitwise equal to A's (A's
   last chunk and B's tail run the same ("prefix", 2048, 16) graph key,
   which launches K2), its staging allocated only before its walk, A's
   tokens within the teacher-forced rule, a replica read counted and no
   live node's breaker open; B's adopted prefill (lookup, fetch, tail)
   printed beside phase 6's single-node native shm adoption and B's
   store-free cold prefill, the lookup and load walks node by node and
   the dead node's reconnect attempts, push GB/s and each node's byte
   share against its ring ownership, the page-locked host bytes; then
   ``python -m infinistore_tpu_torch.benchmark`` over the ring and over
   one node (``--src-device cuda``) must exit 0; K1-K3 counted from 0
   over A's and B's prefills and decodes;
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
   exit 0, its prefill worker having launched K3, its decode worker K2
   (the adopted tail in a prefill graph) and K1 (head size 32);
7b. lora path (while the native store server of phase 6 is up): a LoRA
   bank on the Llama-3-8B weights (base + 4 adapters, rank 16 on wq/wk/
   wv/wo), 8 fresh requests of 64-1500 tokens over adapters 0-4 mixed in
   one ``Scheduler(max_batch=8)`` batch (K3/K2 in prefill graphs, K1 in
   decode graphs, counted from 0 over the run); each adapter's greedy
   tokens against a teacher-forced prefill on ``merge_lora``'s weights for
   it (and differing from the base model's); each prefill key's replay and
   the B=8 decode step's graph ``torch.equal`` to their eager bodies; the
   decode step and a cold 1500-token prefill beside an engine without a
   bank; then on the native store server engine A prefills a fresh
   1500-token prompt on adapter 2 and engine B adopts all 93 chunks for
   adapter 2 and none for adapter 3 or the base (its first token equal to
   A's, every token within the teacher-forced rule);
7c. moe path, last (the Llama-3-8B weights freed): Mixtral-8x7B's widths
   at ``MOE_LAYERS`` (16) of its 32 layers, random bf16 weights drawn on
   the card as a state dict in transformers' Mixtral names and imported
   there by ``models.hf.moe_params_from_hf`` (peak memory printed), 8 fresh
   requests of 64-1500 tokens through ``Scheduler(max_batch=8)`` (K3/K2 in
   prefill graphs, K1 in decode graphs), greedy tokens against a
   teacher-forced dense ``moe_prefill_forward`` (at least 80% the argmax or
   within ``TOL["bfloat16"]`` of it, every one within its top 10: a bf16
   difference flips a top-2 expert choice near a router tie), each prefill
   key's replay and the B=8 decode graph equal to their eager bodies, the
   decode step, a cold 1500-token prefill and their device time by kind,
   held bytes;
7d. multi-device paths (after the lora path, on its native store
   server), each rank a spawned process.  Two gloo ranks share cuda:0
   (their collectives cross the host, so these times are no multi-device
   speed).  The tp=2 group: each ``_tp`` composition (K1 at the mixed
   batch, K3 at 2048 tokens, K2 at 1024/700/512) on its head shard of
   seeded bf16 inputs, gathered and held against the plain version over
   all heads, each rank's launches and median device ms beside the bound
   of its shard's work; then Llama-3-8B at full width, each rank drawing
   only its shard of the seeded weights, 8 requests through ``Scheduler``
   on rank 0 (first-token logits and every token against this process's
   tp=1 engine by the rank rule, each rank's K1/K2/K3 launches and held
   bytes, the ranks' sampled tokens equal, no rank compiling a kernel),
   the eager B=8 step, a cold and an adopted 1500-token prefill; the
   speculation leg on that target (B=1, k=4, ``SPEC_TP_NEW`` tokens: plain
   decode, n-gram (g=2) and the leader's unsharded self-draft, each by the
   rank rule against plain tp=2 decode, acceptance and ms/token, K1/K2/K3
   on every rank); the lora phase's bank (each rank drawing its shard),
   the 8 lora requests over adapters 0-4 against a tp=1 engine with the
   same bank (first-token logits per adapter, every token by the rank
   rule in the tp=1 engine's logits teacher-forced along it); the store
   hop both ways (pages bitwise equal).  The pp=2 group: the same serving
   run and store hop with each rank holding 16 of the 32 layers.  sp=2:
   one 1500-token prefill by ring attention (each rank the whole model),
   logits and KV against tp=1, the KV adopted into a tp=1 engine decoding
   ``SP_NEW`` tokens by the rank rule.  Then NCCL at world size 1 with the
   decode chunks and the speculation rounds replayed as CUDA graphs
   (tokens equal to the plain engine's; tp=2 and pp=2 over NCCL only with
   two cards), and ``serve --model tiny --tp 2 --dist-backend gloo`` as a
   subprocess (3 completions, both ranks' K1/K2/K3, nothing left after
   SIGTERM);
7e. train path (after the fleet path, on the Llama-3-8B weights, then
   after the moe path): the 8B engine generates the distillation corpus
   (``engine.distill.generate_corpus``: 32 sequences of 16 random prompt
   and 48 greedy tokens at B=8; K3 and K1 launched); ``distill`` trains a
   draft of Llama-3.2-1B's widths (its own seed) on it, 100 float32 steps
   at batch 16 (the loss must fall; losses, ms per step and the peak
   allocator memory printed); ``acceptance_probe`` at k=4 on 4 held-out
   prompts, 48 tokens each, for the random-init and the distilled draft
   (and the distilled one on 4 of the corpus's prompts);
   the distilled bf16 params through ``utils.checkpoint.CheckpointManager``
   (async save, restore with ``like`` onto the card, bitwise equal; save
   and restore seconds); an engine on the port's native shm store holding
   two live sequences (700 and 300 tokens) saves its state, a fresh engine
   resumes it (``reused_chunks > 0``, K2 launched on the tails) and its 16
   greedy tokens hold against the uninterrupted engine's by the rank rule;
   K1/K2/K3 called with an input that requires grad raise; then three
   ``train_step_fn`` steps on one B=1, 512-token batch at full width (every
   leaf's gradient present, finite and nonzero; the loss falls; no kernel
   launched: the training forward takes the plain attention), and after
   the moe path three ``moe_train_step_fn`` steps at Mixtral-8x7B's widths
   and ``MOE_TRAIN_LAYERS`` (12) of its 32 layers, the same checks;
8. the ``kernels`` line: one JSON object with every kernel's numbers, each
   kernel's launches counted over the path that runs it, and its launches
   on the speculation path's timed runs (``spec_launches``), the lora path
   (``lora_launches``), the cluster path (``cluster_launches``), the moe
   path (``moe_launches``), the train path (``train_launches``: the
   corpus, the acceptance probes and the resume) and the multi-device paths, each summed over
   its ranks (``tp_launches``, ``spec_tp_launches``, ``lora_tp_launches``,
   ``pp_launches``, ``sp_launches``: the sp path's are the adopted
   decode's, ring attention being plain PyTorch); and the two
   tensor-parallel compositions (the second also in its ``prefix_len``
   form), timed on one rank's head shard.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the repo beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import json
import math
import os
import re
import shutil
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
T_START = time.perf_counter()  # the smoke's start, for the phases' marks
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
    import threading

    from infinistore_tpu_torch import _native

    t0 = time.perf_counter()
    native = {}

    def build_native():
        try:
            native["path"] = _native.build()
        except Exception as e:  # noqa: BLE001 — re-raised below
            native["error"] = e
        native["s"] = time.perf_counter() - t0

    th = threading.Thread(target=build_native)
    th.start()
    paths = build.build_all()
    print(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
          f"into {build.BUILD_DIR}")
    th.join()
    if "error" in native:
        raise native["error"]
    print(f"[build] native store runtime {native['path']} "
          f"({native['s']:.1f} s, g++ beside nvcc)")
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
    # ---- the speculation phase's draft shapes (Llama-3.2-1B: H=32, H_kv=8,
    # D=64, 16-token pages): K1 in every proposal step (a row's 192-256
    # token context), K3 on its cold 192-token prompt, K2 on a tail over a
    # bucketed prefix
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=g).to(dev, dtype)
        q, cache = rnd(4, 32, 64), rnd(2, 8, 256, 16, 64)
        table = torch.randperm(256, generator=g)[:4 * 32].view(4, 32).to(
            dev, torch.int32)
        lens = torch.randint(1, 32 * 16 + 1, (4,), generator=g).to(
            dev, torch.int32)
        compare("K1 paged_decode D=64 H=32 H_kv=8 T=16",
                ca.paged_decode_attention_cuda(q, cache, table, lens),
                ca.paged_decode_attention_xla(q, cache, table, lens), dtype)
        q, k, v = rnd(1, 192, 32, 64), rnd(1, 192, 8, 64), rnd(1, 192, 8, 64)
        compare("K3 flash_causal D=64 Sq=192", ca.flash_causal_attention_cuda(
            q, k, v), ca.causal_attention_xla(q, k, v), dtype)
        q, k, v = rnd(1, 64, 32, 64), rnd(1, 320, 8, 64), rnd(1, 320, 8, 64)
        compare("K2 flash_prefix D=64 pad=256 len=200 Sq=64",
                ca.flash_prefix_attention_cuda(q, k, v, 256, 200),
                ca.causal_attention_xla(q, k, v, prefix_pad=256,
                                        prefix_len=200), dtype)
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


def logits_agree(torch, got, want, what: str, max_err: bool = True) -> float:
    """Cosine >= 0.999 and (with ``max_err``) max error <= 2e-2 *
    max|logit|; returns the max error."""
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
    return err


def phase_model(torch, ca, bench_gpu, dev, card: str, params, cfg, pc):
    """The serving path; returns its launch counts, the decode-step
    profile, the engine and each request's TTFT (ms) by prompt length."""
    from infinistore_tpu_torch.engine import InferenceEngine, Scheduler
    from infinistore_tpu_torch.models import prefill_forward
    from infinistore_tpu_torch.utils.metrics import MetricsRegistry

    engine = InferenceEngine(params, cfg, pc, prefill_chunk=512)
    # a registry of its own: a Scheduler's gauges in the process-wide one
    # would hold it, and the engine and its weights, for the process's life
    sched = Scheduler(engine, max_batch=8, metrics=MetricsRegistry())

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

    # each key's graph against its eager body at full width
    _prefill_keys_equal(torch, engine, "[profile]")
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


def phase_spec(torch, ca, dev, params, cfg, card: str) -> dict:
    """Speculative decoding through the ``Scheduler`` on the Llama-3-8B
    target (its own 256-page cache): (a) a draft with Llama-3.2-1B's widths
    (``LLAMA3_1B``, random bf16 weights from its own seed), (b) the target's
    own weights in a second engine (self-draft), (c) n-gram proposals on a
    prompt that repeats a 64-token sequence; k = 4, B = 1, 64 greedy tokens
    on fresh prompts, beside plain graph decode at B = 1 on the same prompt.
    Then (b) with ``spec_batch`` 4 on four requests and (b) sampled twice
    from one generator state.  Fails unless every timed run took the round
    graphs (``spec_round`` dispatches, one eager round per key and none
    after its capture, no lockstep decode, no host round loop), the draft
    round graphs hold K1 (D = 64 for (a), 128 for (b)) and the n-gram ones
    none, every greedy token is the argmax of a teacher-forced cold prefill
    or within ``TOL["bfloat16"]`` (relative) of its logit, each key's
    replay is ``torch.equal`` to its eager round body, and the sampled
    twins are equal.  Returns the timed runs' launches per kernel."""
    from torch.profiler import ProfilerActivity, profile

    from infinistore_tpu_torch.engine import InferenceEngine, Scheduler
    from infinistore_tpu_torch.engine.stepprof import StepProfiler
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import (LLAMA3_1B, init_params,
                                              prefill_forward)
    from infinistore_tpu_torch.utils.metrics import MetricsRegistry

    t_phase = time.perf_counter()
    K, N_NEW, PLEN, T = 4, 64, 192, 16

    def pcfg(c, n_blocks):
        return PagedCacheConfig(n_layers=c.n_layers, n_kv_heads=c.n_kv_heads,
                                head_dim=c.head_dim, n_blocks=n_blocks,
                                block_tokens=T, dtype=c.dtype)

    target = InferenceEngine(params, cfg, pcfg(cfg, 256))
    rng = torch.Generator().manual_seed(909)

    def prompt(n=PLEN):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    def repeating():
        return prompt(64) * (PLEN // 64)

    spec_launches: dict = {}

    def tforced(p, out, what):
        teacher_forced(torch, prefill_forward, params, cfg, dev, p, out,
                       f"[spec] {what}")

    def run(sched, prompts, n, **kw):
        """Submit, run to the end: (outputs, decode-chunk seconds, wall s,
        the step profiler's records)."""
        sched.stepprof = StepProfiler(sample=10 ** 9,
                                      metrics=MetricsRegistry())
        hist = sched.metrics.histogram("istpu_serve_decode_step_seconds")
        dec0 = hist.labels().sum
        ids = [sched.submit(p, n, **kw) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = {}
        while sched.has_work:
            for r in sched.step():
                done[r.req_id] = r
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for i, p in zip(ids, prompts):
            check(len(done[i].output) == n, f"[spec] a request returned "
                  f"{len(done[i].output)} tokens, wanted {n}")
        return ([done[i].output for i in ids], hist.labels().sum - dec0,
                wall, sched.stepprof.snapshot()["records"])

    def keys_ok(spec, what):
        for key, g in spec._graphs.items():
            check(g.round.eager == 1 and g.refresh.eager == 1,
                  f"[spec] {what}: key {key} ran {g.round.eager} eager "
                  f"rounds and {g.refresh.eager} eager refreshes (1 each: "
                  f"the capture's first)")

    # plain graph decode at B=1, the yardstick (its key captured first)
    plain = Scheduler(target, metrics=MetricsRegistry())
    run(plain, [prompt()], N_NEW)

    def speculator(name, sched, draft, make_prompt):
        spec = sched.spec
        t0 = time.perf_counter()
        cap0 = (target.graph_captures["spec"],
                target.graph_capture_s["spec"])
        run(sched, [make_prompt()], N_NEW)  # captures, cuBLAS: not counted
        p = make_prompt()
        rounds0, prop0, acc0 = spec.rounds, spec.proposed, spec.accepted
        t_dec0 = target.graph_replays["decode"]
        d_dec0 = draft.graph_replays["decode"] if draft else 0
        ca.reset_launches()
        (out,), dec_s, wall, recs = run(sched, [p], N_NEW)
        launches = dict(ca.LAUNCHES)
        for kk, n in launches.items():
            spec_launches[kk] = spec_launches.get(kk, 0) + n
        rounds = spec.rounds - rounds0
        prop, acc = spec.proposed - prop0, spec.accepted - acc0
        disp = sum(r["dispatches"].get("spec_round", 0) for r in recs)
        syncs = [r["syncs"].get("spec_tokens", 0) for r in recs
                 if r["dispatches"].get("spec_round")]
        check(disp > 0 and syncs, f"[spec] {name}: no spec_round dispatch")
        check(target.graph_replays["decode"] == t_dec0,
              f"[spec] {name}: the timed run fell back to lockstep decode")
        check(draft is None or draft.graph_replays["decode"] == d_dec0,
              f"[spec] {name}: the timed run ran the host round loop")
        keys_ok(spec, name)
        gl = spec.graph_launches()
        for key, g in spec._graphs.items():
            k1 = g.round.captured.get("paged_decode", 0)
            want = K * draft.cfg.n_layers if draft else 0
            check(k1 == want, f"[spec] {name}: key {key}'s round graph "
                  f"holds {k1} K1 launches, wanted {want}")
        print(f"[spec] {name}: launches in the timed run {json.dumps(launches)}"
              f"; launched by round-graph replays so far {json.dumps(gl)}"
              + (f"; K1 at the draft's head size D = {draft.cfg.head_dim}"
                 if draft else ""))
        tforced(p, out, f"{name}, 64 greedy tokens")
        # the yardstick on the same prompt (its prefix from the cache)
        (pout,), p_dec_s, _w, _r = run(plain, [p], N_NEW)
        same = sum(a == b for a, b in zip(out, pout))
        # device ms and kernels per round: a fresh 8-token decode under
        # the profiler (its key warmed first)
        for warm in (True, False):
            st = spec.prefill(make_prompt())
            sts = st if isinstance(st, tuple) else (st,)
            torch.cuda.synchronize()
            r0 = spec.rounds
            if warm:
                spec.decode(*sts, 8)
            else:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    spec.decode(*sts, 8)
                    torch.cuda.synchronize()
                p_rounds = spec.rounds - r0
                by_kind, _top, n_k = _device_time_by_kind(torch, prof)
            for eng, s in zip((target, draft), sts):
                eng.release(s)
        dev_ms = sum(by_kind.values())
        caps = target.graph_captures["spec"] - cap0[0]
        cap_s = target.graph_capture_s["spec"] - cap0[1]
        print(f"[spec] {name}: acceptance {acc / max(prop, 1):.4f} "
              f"({acc}/{prop}); {len(out) / max(rounds, 1):.3f} tokens per "
              f"round; {rounds / disp:.2f} rounds per dispatch; syncs per "
              f"chunk {statistics.mean(syncs):.2f} over {len(syncs)} chunks; "
              f"{1e3 * dec_s / N_NEW:.3f} ms per token (decode chunks; wall "
              f"{1e3 * wall / N_NEW:.3f}) against plain graph decode at B=1 "
              f"{1e3 * p_dec_s / N_NEW:.3f} ms per token on the same prompt "
              f"({same}/{N_NEW} tokens equal to it): "
              f"{p_dec_s / dec_s:.3f}x; device {dev_ms / p_rounds:.3f} ms and "
              f"{n_k / p_rounds:.0f} kernels per round ({p_rounds} rounds "
              f"profiled; by kind {json.dumps({k: round(v / p_rounds, 3) for k, v in by_kind.items()})} ms); "
              f"{caps} captures in {cap_s:.3f} s; {len(spec._graphs)} round "
              f"keys {sorted(spec._graphs)}, their buffers "
              f"{spec.held_bytes() / 2 ** 20:.2f} MiB; {card}")
        for key in spec._graphs:
            same = spec.round_replay_equals_eager(key)
            print(f"[spec] {name}: key {key} replay torch.equal to its eager "
                  f"round body: {same}")
            check(same, f"[spec] {name}: key {key}'s replay differs from "
                  f"its eager round body")
        print(f"[spec] {name}: phase so far {time.perf_counter() - t0:.1f} s")

    # (a) a Llama-3.2-1B-shaped draft, random weights of its own
    t0 = time.perf_counter()
    dcfg = LLAMA3_1B
    dparams = init_params(dcfg, torch.Generator(device=dev).manual_seed(1),
                          dev)
    draft = InferenceEngine(dparams, dcfg, pcfg(dcfg, 96))
    print(f"[spec] draft: Llama-3.2-1B widths ({dcfg.n_layers} layers, dim "
          f"{dcfg.dim}, head_dim {dcfg.head_dim}), random bf16 weights drawn "
          f"in {time.perf_counter() - t0:.1f} s")
    speculator("(a) draft Llama-3.2-1B", Scheduler(
        target, draft_engine=draft, spec_k=K, metrics=MetricsRegistry()),
        draft, prompt)
    del draft, dparams
    torch.cuda.empty_cache()
    print(f"[spec] after (a): {_held(target)}")

    # (b) the target's weights in a second engine with its own cache
    selfd = InferenceEngine(params, cfg, pcfg(cfg, 96))
    sched_b = Scheduler(target, draft_engine=selfd, spec_k=K,
                        metrics=MetricsRegistry())
    speculator("(b) self-draft", sched_b, selfd, prompt)
    # (b) batched: four requests in lockstep through the round graphs
    batch = Scheduler(target, draft_engine=selfd, spec_k=K, spec_batch=4,
                      max_batch=4, metrics=MetricsRegistry())
    run(batch, [prompt() for _ in range(4)], N_NEW)  # captures
    ps = [prompt() for _ in range(4)]
    ca.reset_launches()
    outs, dec_s, wall, recs = run(batch, ps, N_NEW)
    for kk, n in ca.LAUNCHES.items():
        spec_launches[kk] = spec_launches.get(kk, 0) + n
    disp = sum(r["dispatches"].get("spec_round", 0) for r in recs)
    check(disp > 0 and {k[1] for k in batch.spec._graphs} == {4},
          "[spec] (b) batched: the four requests did not share round graphs")
    keys_ok(batch.spec, "(b) batched")
    for i, (p, o) in enumerate(zip(ps, outs)):
        tforced(p, o, f"(b) batched, request {i}")
    print(f"[spec] (b) batched, spec_batch 4: {4 * N_NEW} tokens in "
          f"{disp} dispatches, {1e3 * dec_s / N_NEW:.3f} ms per step of 4 "
          f"tokens (wall {1e3 * wall:.1f} ms), acceptance "
          f"{batch.spec.acceptance_rate:.4f}")
    # (b) sampled twice from one generator state (short prompts: no
    # prefix-cache reuse, so both runs compute the same prefill)
    q = prompt(12)
    twins = []
    for _ in range(2):
        sched_b._rng = torch.Generator().manual_seed(2024)
        (o,), _d, _w, recs = run(sched_b, [q], N_NEW, sample="categorical",
                                 temperature=0.8, top_p=0.9)
        twins.append(o)
        check(sum(r["dispatches"].get("spec_round", 0) for r in recs) > 0,
              "[spec] (b) sampled: no spec_round dispatch")
    keys_ok(sched_b.spec, "(b) sampled")
    print(f"[spec] (b) sampled twice (temperature 0.8, top-p 0.9, one "
          f"generator state): equal {twins[0] == twins[1]}; filter keys "
          f"{sorted(k for k in sched_b.spec._graphs if k[-1] == 'filter')}")
    check(twins[0] == twins[1], "[spec] (b) sampled twins differ")
    del sched_b, batch, selfd
    torch.cuda.empty_cache()
    print(f"[spec] after (b): {_held(target)}")

    # (c) n-gram proposals on a prompt that repeats a 64-token sequence
    speculator("(c) n-gram g=2", Scheduler(
        target, ngram_spec=True, spec_k=K, spec_g=2,
        metrics=MetricsRegistry()), None, repeating)
    print(f"[spec] phase {time.perf_counter() - t_phase:.1f} s; launches on "
          f"the timed speculation runs {json.dumps(spec_launches)}; "
          f"{_held(target)}")
    del target
    torch.cuda.empty_cache()
    return spec_launches


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


def _start_store(prealloc_gib: int, min_alloc_kib: int,
                 backend: str = "python"):
    """The port's own store server (``backend``: the asyncio one or the
    native runtime) in a subprocess, from this checkout; returns (process,
    service port).  ``min_alloc_kib``: the pool's allocation unit, one
    full-precision page, so a band's pages sit in one contiguous run of
    the pool."""
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
         "--log-level", "warning", "--backend", backend],
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


def _store_free(engine):
    """Run a block on ``engine`` with its store detached: no lookup, no
    load, no push (a store-free cold prefill of the same engine)."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        saved = engine.transfer, engine._streamer
        engine.transfer = engine._streamer = None
        try:
            yield
        finally:
            engine.transfer, engine._streamer = saved

    return cm()


def _client_split(before: dict, after: dict) -> dict:
    """The Python client's ``read_cache`` ops between two latency
    snapshots: calls and milliseconds per op."""
    out = {}
    for op, rec in after.items():
        if op.startswith("read_cache"):
            prev = before.get(op, {"count": 0, "total_ms": 0.0})
            if rec["count"] > prev["count"]:
                out[op] = {"count": rec["count"] - prev["count"],
                           "ms": round(rec["total_ms"] - prev["total_ms"], 3)}
    return out


def _adopt(torch, a, b, prompt):
    """A prefills ``prompt`` into the store (strict pushes); B adopts it.
    Returns (A's state, B's state, A ms, B ms, B's load stages (with
    ``start_ms``: B's admission half, the store hops and the prefix
    gather, and ``tail_ms``: its chunk), the Python client's read split
    during B's prefill, the K2 launches B's prefill graphs made, staging
    allocated during B's load)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa = a.prefill(prompt)
    torch.cuda.synchronize()
    ms_a = (time.perf_counter() - t0) * 1e3
    return (sa,) + _b_adopts(torch, b, prompt, ms_a)


def _staging_slots(tx) -> list:
    """The load staging slots behind a transfer engine (each node's, for a
    cluster), as addresses (None: not allocated)."""
    pool = getattr(tx, "pool", None)
    engines = [tx] if pool is None else [
        n.engine for n in pool.nodes() if n.engine is not None]
    return [t.data_ptr() if t is not None else None
            for e in engines for t in e._staging]


def _b_adopts(torch, b, prompt, ms_a: float = 0.0):
    """B's half of ``_adopt``: B prefills a prompt whose pages are in the
    store.  Returns (B's state, ``ms_a``, B ms, load stages, client read
    split, K2 launches of B's prefill graphs, staging allocated)."""
    lat0 = b.transfer._src.latency_stats()
    k2_0 = b.graph_launches("prefill").get("flash_prefix", 0)
    slots = _staging_slots(b.transfer)
    t0 = time.perf_counter()
    pp = b.prefill_start(prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sb = None
    while sb is None:
        sb = b.prefill_step(pp)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ms_b = (t2 - t0) * 1e3
    split = _client_split(lat0, b.transfer._src.latency_stats())
    k2 = b.graph_launches("prefill").get("flash_prefix", 0) - k2_0
    allocs = sum(x != y for x, y in zip(slots, _staging_slots(b.transfer)))
    load = dict(b.transfer.last_load_stages, start_ms=round((t1 - t0) * 1e3, 3),
                tail_ms=round((t2 - t1) * 1e3, 3))
    return sb, ms_a, ms_b, load, split, k2, allocs


def _read_rates(np, tx, chunk_keys_) -> str:
    """The client's ``read_cache`` of one layer band of ``chunk_keys_``'s
    pages (the whole client path, as a load runs it per band) into the
    transfer engine's pinned staging and into a pageable array, and a host
    ``memcpy`` of as many bytes into each: GB/s, best of 3."""
    l0, l1 = tx._bands()[0]
    blocks = tx._page_blocks(chunk_keys_, l0, l1)
    pb = tx.wire_page_bytes
    nbytes = pb * len(blocks)
    pinned = tx._staging[0].numpy()[:nbytes]
    pageable = np.zeros(nbytes, np.uint8)
    src = np.ones(nbytes, np.uint8)

    def rate(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return f"{nbytes / best / 1e9:.3f}"

    return (f"read_cache of {nbytes} bytes into pinned staging "
            f"{rate(lambda: tx._call('read_cache', blocks, pb, pinned.ctypes.data))}"
            f" GB/s, into a pageable array "
            f"{rate(lambda: tx._call('read_cache', blocks, pb, pageable.ctypes.data))}"
            f" GB/s; memcpy into pinned {rate(lambda: np.copyto(pinned, src))}"
            f" GB/s, into pageable {rate(lambda: np.copyto(pageable, src))} GB/s")


def _store_case(torch, dev, params, cfg, pc, port: int, transport: str,
                quant, seed: int, runtime: str) -> dict:
    """Engine A prefills a fresh 1500-token prompt into the store; engine B
    (same weights, own connection and cache) adopts its pages and computes
    only the tail through a prefill graph; both decode 32 greedy tokens.
    ``runtime``: the store server's and both clients' ("python" or
    "native").  Returns the case's times."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM, TYPE_TCP
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import (chunk_keys, dequantize_pages,
                                          pages_to_seq_kv, quantize_pages,
                                          read_pages)
    from infinistore_tpu_torch.models import prefill_forward

    tag = f"[store {runtime} {transport} kv_quant={quant}]"
    ctype = TYPE_SHM if transport == "shm" else TYPE_TCP
    conns = []
    engines = []
    saved_env = os.environ.get("ISTPU_CLIENT")
    os.environ["ISTPU_CLIENT"] = runtime
    try:
        for _ in range(2):
            c = lib.InfinityConnection(ClientConfig(
                host_addr="127.0.0.1", service_port=port,
                connection_type=ctype, log_level="warning"))
            c.connect()
            conns.append(c)
            engines.append(InferenceEngine(params, cfg, pc, conn=c,
                                           kv_quant=quant, prefill_chunk=512,
                                           model_id=f"smoke-{runtime}-"
                                                    f"{transport}",
                                           device=dev))
        want_cls = "NativeConnection" if runtime == "native" else "Connection"
        check(all(type(c.conn).__name__ == want_cls for c in conns),
              f"{tag} the clients are {[type(c.conn) for c in conns]}")
        a, b = engines
        gen = torch.Generator().manual_seed(seed)

        def fresh():
            return torch.randint(0, cfg.vocab_size, (1500,), generator=gen
                                 ).tolist()

        # warm-up on prompts of their own: A's first push page-locks the
        # store's pool mapping (Python runtime, shm) and fills its push
        # ring, B's first load allocates both pinned staging slots, and A
        # and B capture the prefill graphs of the timed prompts' keys (B:
        # its adopted tail's, and its store-free chunks'): one-time costs
        # kept out of the timed hops
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.release(a.prefill(fresh()))
        b.release(b.prefill(fresh()))
        warm = fresh()
        a.release(a.prefill(warm))
        b.release(b.prefill(warm))
        torch.cuda.synchronize()
        print(f"{tag} warm-up: {(time.perf_counter() - t0) * 1e3:.3f} ms")
        prompt = fresh()
        want_chunks = (len(prompt) - 1) // pc.block_tokens
        sa, sb, ttft_a, ttft_b, load, split, k2, allocs = _adopt(
            torch, a, b, prompt)
        push = dict(a.transfer.last_push_stages)
        hops = sb.store_load_s * 1e3
        fetch, scatter = load["fetch_s"] * 1e3, load["scatter_s"] * 1e3
        print(f"{tag} A cold prefill {ttft_a:.3f} ms ({len(prompt)} tokens, "
              f"{len(prompt) // pc.block_tokens} chunks pushed, strict "
              f"durability); B store-adopted prefill {ttft_b:.3f} ms "
              f"(reused_chunks={sb.reused_chunks}, store_chunks="
              f"{sb.store_chunks}, store hops {hops:.3f} ms)")
        print(f"{tag} B's stage split: lookup {hops - fetch - scatter:.3f} "
              f"ms, fetch {fetch:.3f} ms (client "
              f"{json.dumps(split) if split else 'native: not split'}), "
              f"scatter {scatter:.3f} ms, the rest of the admission half "
              f"{load['start_ms'] - hops:.3f} ms, the tail chunk "
              f"{load['tail_ms']:.3f} ms; B's tail replayed a prefill graph "
              f"launching K2 {k2} times; staging allocated by the load: "
              f"{allocs}")
        if transport == "shm":
            import numpy as np

            print(f"{tag} one band: " + _read_rates(
                np, b.transfer, sb.chunk_keys[:want_chunks]))
        stats = conns[1].stats()
        print(f"{tag} the store server's stats: " + json.dumps(
            {k: v for k, v in stats.items()
             if k in ("kvmap_len", "usage", "pools", "n_pools", "evicted",
                      "contig_batches", "op_latency")})[:1500])
        print(f"{tag} A's last push stages {json.dumps(push)}")
        print(f"{tag} B's load stages {json.dumps(load)}; load "
              f"{load['bytes'] / (load['fetch_s'] + load['scatter_s']) / 1e9:.3f}"
              f" GB/s")
        print(f"{tag} B: {_held(b)}")
        check(sb.reused_chunks == want_chunks,
              f"{tag} B reused {sb.reused_chunks} chunks, wanted {want_chunks}")
        check(k2 > 0, f"{tag} B's adopted tail launched no K2 in a graph")
        check(allocs == 0, f"{tag} the timed load allocated {allocs} "
                           f"staging slots")
        if transport == "shm" and runtime == "python":
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
        # B's store-free cold prefill of a fresh prompt (512-token chunks
        # through its graphs, captured in the warm-up), beside its
        # adopted one
        cold_prompt = fresh()
        with _store_free(b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.release(b.prefill(cold_prompt))
            torch.cuda.synchronize()
            cold_b = (time.perf_counter() - t0) * 1e3
        print(f"{tag} B adopted {ttft_b:.3f} ms vs B store-free cold "
              f"{cold_b:.3f} ms: adopted/cold {ttft_b / cold_b:.3f}")
        # the same hop with one staging slot dropped (and kept alive, so the
        # pinned allocator's cache cannot hand it back), so the load
        # allocates a fresh pinned slot inside the timed hop, as a load
        # into a ring that alternated onto a slot never used did
        held = b.transfer._staging[0]
        b.transfer._staging[0] = None
        s2a, s2b, _ms, cold_slot_b, load2, _split, _k2, allocs2 = _adopt(
            torch, a, b, fresh())
        print(f"{tag} with one staging slot cold: B adopted "
              f"{cold_slot_b:.3f} ms, fetch {load2['fetch_s'] * 1e3:.3f} ms "
              f"(against {fetch:.3f} ms warm), {allocs2} slot allocated")
        b.transfer._release_mr(held)
        del held
        if transport == "shm" and dev.type == "cuda":
            # one more adoption under the profiler: B's device time by
            # kind and its longest kernels (the H2D copies included)
            from torch.profiler import ProfilerActivity, profile

            s3a = a.prefill(fresh())
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                s3b = b.prefill(s3a.tokens)
                torch.cuda.synchronize()
            kinds, top, n_k = _device_time_by_kind(torch, prof)
            top.sort(reverse=True)
            print(f"{tag} B's adoption under the profiler: {n_k} device "
                  f"events, ms by kind " + json.dumps(
                      {k: round(v, 3) for k, v in kinds.items()})
                  + "; longest: " + "; ".join(
                      f"{ms:.3f} ms x{c} {name}" for ms, c, name in top[:6]))
            for e, st in ((a, s3a), (b, s3b)):
                e.release(st)
        for e, st in ((a, s2a), (b, s2b)):
            e.release(st)
        # the push and load rates of the same 93 chunks outside the prefill
        keys = chunk_keys(prompt, f"smoke-rate-{runtime}-{transport}",
                          chunk_tokens=pc.block_tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_bytes = a.transfer.save_pages(a.cache, sa.block_ids[:want_chunks],
                                        keys[:want_chunks])
        push_s = time.perf_counter() - t0
        push_stages = dict(a.transfer.last_push_stages)
        t0 = time.perf_counter()
        b.transfer.load_pages(b.cache, sb.block_ids[:want_chunks],
                              keys[:want_chunks])
        load_s = time.perf_counter() - t0
        print(f"{tag} save_pages of {want_chunks} chunks ({n_bytes} bytes): "
              f"{push_s * 1e3:.3f} ms, {n_bytes / push_s / 1e9:.3f} GB/s, "
              f"stages {json.dumps(push_stages)}; load_pages: "
              f"{load_s * 1e3:.3f} ms, {n_bytes / load_s / 1e9:.3f} GB/s, "
              f"stages {json.dumps(b.transfer.last_load_stages)}")
        if runtime == "native" and transport == "shm":
            # the native client's push from pageable host arrays (the
            # legacy path) beside the pinned ring it takes now
            a.transfer.push_mode = "legacy"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.transfer.save_pages(a.cache, sa.block_ids[:want_chunks],
                                  keys[:want_chunks])
            legacy_s = time.perf_counter() - t0
            a.transfer.push_mode = "auto"
            print(f"{tag} save_pages from pageable arrays (legacy): "
                  f"{legacy_s * 1e3:.3f} ms, "
                  f"{n_bytes / legacy_s / 1e9:.3f} GB/s, against the "
                  f"pinned ring's {push_s * 1e3:.3f} ms")
        for e, st in ((a, sa), (b, sb)):
            e.release(st)
        return {"adopted_ms": ttft_b, "cold_ms": cold_b, "hops_ms": hops,
                "fetch_ms": fetch, "tail_ms": load["tail_ms"]}
    finally:
        if saved_env is None:
            os.environ.pop("ISTPU_CLIENT", None)
        else:
            os.environ["ISTPU_CLIENT"] = saved_env
        for e in engines:
            e.transfer.close()
        for c in conns:
            c.close()


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def phase_store(torch, ca, dev, params, cfg, pc, ports: dict) -> dict:
    """The store hop through the port's store servers (``ports``: runtime
    -> service port), shm with full-precision pages, then TCP with int8
    pages, on the Python runtime and then the native one; returns each
    case's times (B adopted, its fetch and tail, B store-free cold)."""
    ca.reset_launches()
    torch.cuda.synchronize()
    seed = 11
    times = {}
    for runtime in ("python", "native"):
        for transport, quant in (("shm", None), ("tcp", "int8")):
            times[f"{runtime} {transport}"] = _store_case(
                torch, dev, params, cfg, pc, ports[runtime], transport,
                quant, seed, runtime)
            seed += 1
    torch.cuda.synchronize()
    print(f"[store] B adopted vs B store-free cold, ms: {json.dumps(times)}")
    launches = dict(ca.LAUNCHES)
    print(f"[store] launches on the store path: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in MODEL_PATH_KERNELS),
          f"a kernel was not launched on the store path: {launches}")
    return times


CLUSTER_POOL_GIB = 2  # each node's /dev/shm pool


def _bench_cli(args, tag: str):
    """``python -m infinistore_tpu_torch.benchmark`` with ``args``: must
    exit 0 (a page that came back different prints "data mismatch" and
    fails the run).  Returns (put, get) GB/s."""
    r = subprocess.run(
        [sys.executable, "-m", "infinistore_tpu_torch.benchmark", *args],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    out = (r.stdout + r.stderr).strip()
    print(f"{tag} benchmark {' '.join(args)}: exit {r.returncode}; "
          + " | ".join(out.splitlines()[-6:]))
    check(r.returncode == 0 and "data mismatch" not in out,
          f"{tag} the benchmark CLI failed: {out[-2000:]}")
    m = re.search(r"put: ([\d.]+) GB/s\s+get: ([\d.]+) GB/s", out)
    check(m is not None, f"{tag} no put/get rates in the benchmark's output")
    return float(m.group(1)), float(m.group(2))


class _HopTimes:
    """Times each ``NativeConnection.close`` and ``connect`` while in the
    block (a reconnect of a node's public wrapper is one of each): (service
    port, op, ms, ok) in ``calls``."""

    OPS = ("close", "connect")

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from infinistore_tpu_torch._native import NativeConnection

        self._orig = {op: getattr(NativeConnection, op) for op in self.OPS}
        for op, fn in self._orig.items():
            setattr(NativeConnection, op, self._timed(op, fn))
        return self

    def _timed(self, op, fn):
        calls = self.calls

        def wrapper(conn, *args):
            t, ok = time.perf_counter(), False
            try:
                out = fn(conn, *args)
                ok = True
                return out
            finally:
                calls.append((int(conn.config.service_port), op,
                              round((time.perf_counter() - t) * 1e3, 3), ok))
        return wrapper

    def __exit__(self, *exc):
        from infinistore_tpu_torch._native import NativeConnection

        for op, fn in self._orig.items():
            setattr(NativeConnection, op, fn)


def phase_cluster(torch, ca, dev, params, cfg, pc, single: dict) -> dict:
    """The store cluster on the card: three of the port's native store
    nodes (``CLUSTER_POOL_GIB`` /dev/shm pools, one full-precision page as
    the allocation unit), engines A (strict durability) and B, each on a
    ``RoutedStorePool`` over the three (replicas 2, native clients,
    lossless bf16 pages).  A pins and prefills four fresh 1500-token
    prompts, so each chunk sits on two nodes; B adopts P1's 93 chunks with
    every node up, the node owning most of P2's chunks is killed, and B
    adopts P2's, P3's and P4's 93 chunks from the survivors (the store hop
    timed node by node: lookup walk, load walk, the dead node's reconnect
    attempts).  Each adoption's tail replays the ("prefix", 2048, 16) graph
    (K2) and B decodes 16 greedy tokens (K1), which must equal A's: A
    prefills in 16-token chunks, so its last chunk runs through the same
    graph key over the same pages as B's tail.  Then the benchmark CLI
    over the ring and over one node.  ``single``: ``phase_store``'s times,
    printed beside the ring's.  Returns the launches on the cluster path
    (counted from 0 over A's and B's prefills and decodes)."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.cluster import (ClusterTransferEngine,
                                               RoutedStorePool)
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import chunk_keys, read_pages
    from infinistore_tpu_torch.models import prefill_forward

    tag = "[cluster]"
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    min_alloc = max(16, pc.page_bytes // 1024)
    nodes, pools, engines = [], [], []
    saved_env = os.environ.get("ISTPU_CLIENT")
    os.environ["ISTPU_CLIENT"] = "native"
    try:
        # the three nodes start at once (each maps and faults in its pool)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(3) as ex:
            futs = [ex.submit(_start_store, prealloc_gib=CLUSTER_POOL_GIB,
                              min_alloc_kib=min_alloc, backend="native")
                    for _ in range(3)]
        errs = []
        for f in futs:
            try:
                nodes.append(f.result())
            except Exception as e:  # noqa: BLE001 — raised below
                errs.append(e)
        if errs:
            raise errs[0]
        eps = [f"127.0.0.1:{port}" for _, port in nodes]
        print(f"{tag} three native store nodes up in "
              f"{time.perf_counter() - t_phase:.1f} s: {eps}")

        def native_conn(ep):
            host, _, port = ep.rpartition(":")
            return lib.InfinityConnection(ClientConfig(
                host_addr=host, service_port=int(port),
                connection_type=TYPE_SHM, log_level="warning"))

        T = pc.block_tokens
        for durability, chunk in (("strict", T), ("relaxed", 512)):
            pool = RoutedStorePool(eps, replicas=2, conn_factory=native_conn)
            pools.append(pool)
            engines.append(InferenceEngine(
                params, cfg, pc, conn=pool, kv_quant=None,
                prefill_chunk=chunk, model_id="smoke-cluster",
                store_durability=durability, device=dev))
        a, b = engines
        check(all(type(e.transfer) is ClusterTransferEngine for e in engines),
              f"{tag} the engines did not build cluster transfers")
        kinds = {type(n.conn.conn).__name__ for p in pools for n in p.nodes()}
        check(kinds == {"NativeConnection"}, f"{tag} node clients {kinds}")
        own = {n["endpoint"]: n["ownership"] for n in pools[0].report()["nodes"]}
        print(f"{tag} ring ownership: " + json.dumps(
            {ep: round(v, 4) for ep, v in own.items()}))
        gen = torch.Generator().manual_seed(41)

        def fresh(n=1500):
            return torch.randint(0, cfg.vocab_size, (n,), generator=gen
                                 ).tolist()

        # warm-up on prompts of their own: the graphs of the timed keys, the
        # node engines' push rings, and B's load staging.  B's load sizes
        # each node's slots to every chunk whose candidates name it, so the
        # prompt B adopts here is longer than the timed ones: their loads
        # then fit the slots it leaves
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.release(a.prefill(fresh()))
        b.release(b.prefill(fresh()))
        warm = fresh(2000)
        a.release(a.prefill(warm))
        b.release(b.prefill(warm))
        torch.cuda.synchronize()
        print(f"{tag} warm-up: {(time.perf_counter() - t0) * 1e3:.3f} ms; B's "
              f"node engines hold page-locked "
              f"{json.dumps(b.transfer.pinned_bytes())} bytes")
        with _store_free(b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.release(b.prefill(fresh()))
            torch.cuda.synchronize()
            cold_b = (time.perf_counter() - t0) * 1e3
        prompts = {f"P{i}": fresh() for i in range(1, 5)}
        want = (len(prompts["P1"]) - 1) // T
        pinned = [a.pin_prefix(p) for p in prompts.values()]
        print(f"{tag} A pinned {pinned} chunk stems of P1-P4 (each chunk to "
              f"its owner and one ring successor)")

        # ---- the cluster path, counted from 0 ----
        ca.reset_launches()
        torch.cuda.synchronize()
        times = {}
        sas = {}
        for name, p in prompts.items():
            t0 = time.perf_counter()
            sas[name] = a.prefill(p)
            torch.cuda.synchronize()
            times[f"A {name}"] = (time.perf_counter() - t0) * 1e3
            push = dict(a.transfer.last_push_stages)
            print(f"{tag} A cold prefill of {name} in {T}-token chunks: "
                  f"{times[f'A {name}']:.3f} ms (strict: pushed to the ring "
                  f"inside it); last push nodes {push['nodes']}, "
                  f"failed_nodes {push['failed_nodes']}")
        tokens = {}

        def adopt(name):
            p, sa = prompts[name], sas[name]
            sb, _ms, ms_b, load, _split, k2, allocs = _b_adopts(torch, b, p)
            fetch = load["fetch_s"] * 1e3
            look = b.transfer.last_lookup_stages
            print(f"{tag} B adopted {name}: {ms_b:.3f} ms (reused "
                  f"{sb.reused_chunks}, from the store {sb.store_chunks}; "
                  f"store hops {sb.store_load_s * 1e3:.3f} ms: lookup "
                  f"{look['s'] * 1e3:.3f}, fetch {fetch:.3f}, scatter "
                  f"{load['scatter_s'] * 1e3:.3f}; tail {load['tail_ms']:.3f}"
                  f" ms) over {load['nodes']} nodes in {load['groups']} "
                  f"groups; tail K2 launches {k2}; staging allocated "
                  f"{allocs} ({load['staging_grown']} at the load's start); "
                  f"the lookup walk [node, depth, chunks, s, matched] "
                  f"{json.dumps(look['walk'])}; the load walk [node, depth, "
                  f"chunks, s, ok] {json.dumps(load['walk'])}")
            check(sb.reused_chunks == sb.store_chunks == want,
                  f"{tag} B adopted {sb.reused_chunks} chunks of {name} "
                  f"({sb.store_chunks} from the store), wanted {want}")
            check(k2 > 0, f"{tag} B's {name} tail launched no K2 in a graph")
            check(allocs == load["staging_grown"],
                  f"{tag} B's {name} load allocated {allocs} staging slots, "
                  f"{load['staging_grown']} of them before its walk")
            pa = read_pages(a.cache, torch.tensor(sa.block_ids[:want],
                                                  device=dev))
            pb = read_pages(b.cache, torch.tensor(sb.block_ids[:want],
                                                  device=dev))
            check(torch.equal(pa, pb),
                  f"{tag} B's adopted {name} pages differ from A's")
            check(torch.equal(sa.last_logits, sb.last_logits),
                  f"{tag} B's {name} first-token logits differ from A's")
            ta, tb = a.decode(sa, 16), b.decode(sb, 16)
            print(f"{tag} {name}: B's 16 greedy tokens equal A's: {ta == tb}")
            check(ta == tb, f"{tag} {name}: B's tokens {tb} differ from A's "
                            f"{ta}")
            tokens[name] = ta
            return sb, {"adopted_ms": ms_b, "lookup_ms": look["s"] * 1e3,
                        "fetch_ms": fetch, "tail_ms": load["tail_ms"]}

        sb1, times["B P1, all up"] = adopt("P1")

        # the push and load rates of P1's 93 chunks under keys no one
        # pinned (each chunk to its owner only: the byte shares against
        # the ring's ownership)
        keys = chunk_keys(prompts["P1"], "smoke-cluster-rate",
                          chunk_tokens=T)[:want]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_bytes = a.transfer.save_pages(a.cache, sas["P1"].block_ids[:want],
                                        keys)
        push_s = time.perf_counter() - t0
        st = dict(a.transfer.last_push_stages)
        t0 = time.perf_counter()
        b.transfer.load_pages(b.cache, sb1.block_ids[:want], keys)
        load_s = time.perf_counter() - t0
        shares = {ep: round(v / n_bytes, 4)
                  for ep, v in st["node_bytes"].items()}
        print(f"{tag} save_pages of {want} chunks ({n_bytes} bytes) over "
              f"the ring: {push_s * 1e3:.3f} ms, "
              f"{n_bytes / push_s / 1e9:.3f} GB/s, nodes {st['nodes']}, "
              f"failed_nodes {st['failed_nodes']}; byte shares "
              f"{json.dumps(shares)} against ownership "
              f"{json.dumps({ep: round(v, 4) for ep, v in own.items()})}; "
              f"load_pages {load_s * 1e3:.3f} ms, "
              f"{n_bytes / load_s / 1e9:.3f} GB/s, stages "
              f"{json.dumps(b.transfer.last_load_stages)}")
        check(st["failed_nodes"] == 0 and sum(st["node_bytes"].values())
              == n_bytes, f"{tag} the ring push lost bytes: {st}")
        for name, e in (("A", a), ("B", b)):
            print(f"{tag} {name}'s node engines hold page-locked "
                  f"{json.dumps(e.transfer.pinned_bytes())} bytes")

        # the benchmark CLI over the ring and over one node (all up)
        rates = {
            "ring": _bench_cli(["--endpoints", ",".join(eps), "--shm",
                                "--src-device", "cuda"], tag),
            "one node": _bench_cli(["--service-port", str(nodes[0][1]),
                                    "--shm", "--src-device", "cuda"], tag),
        }
        print(f"{tag} benchmark put/get GB/s: {json.dumps(rates)}")

        # kill, by process, the node that owns the most of P2's chunks
        keys2 = chunk_keys(prompts["P2"], "smoke-cluster",
                           chunk_tokens=T)[:want]
        owners = [pools[1].ring.owner(k) for k in keys2]
        victim = max(eps, key=owners.count)
        vport = int(victim.rpartition(":")[2])
        proc = nodes[eps.index(victim)][0]
        proc.kill()
        proc.wait(timeout=30)
        print(f"{tag} killed {victim}, owner of {owners.count(victim)} of "
              f"P2's {want} chunks")
        replica0 = pools[1].report()["replica_reads"]["hit"]
        vnode = pools[1].node(victim)
        for name in ("P2", "P3", "P4"):
            with _HopTimes() as hop:
                _sb, times[f"B {name}, one node dead"] = adopt(name)
            print(f"{tag} {name}: the dead node's reconnect attempts "
                  f"[op, ms, ok] {json.dumps([c[1:] for c in hop.calls if c[0] == vport])}"
                  f", other nodes' {len([c for c in hop.calls if c[0] != vport])}"
                  f"; its breaker {vnode.breaker.state}")
        rep = pools[1].report()
        hits = rep["replica_reads"]["hit"] - replica0
        states = {n["endpoint"]: n["state"] for n in rep["nodes"]}
        print(f"{tag} after the kill: replica reads {json.dumps(rep['replica_reads'])}"
              f" (+{hits} hits), B's node states {json.dumps(states)}, "
              f"requests {json.dumps({n['endpoint']: n['requests'] for n in rep['nodes']})}")
        check(hits > 0, f"{tag} no replica served the dead node's chunks")
        for p in pools:
            for n in p.nodes():
                check(n.endpoint == victim or n.breaker.state == "closed",
                      f"{tag} {n.endpoint}'s breaker is {n.breaker.state}")
        torch.cuda.synchronize()
        launches = dict(ca.LAUNCHES)
        print(f"{tag} launches on the cluster path: {json.dumps(launches)}")
        check(all(launches[k] > 0 for k in MODEL_PATH_KERNELS),
              f"{tag} a kernel was not launched on the cluster path: "
              f"{launches}")
        # A's tokens (B's are the same) against a teacher-forced cold
        # prefill, after the count
        for name in ("P1", "P2"):
            teacher_forced(torch, prefill_forward, params, cfg, dev,
                           prompts[name], tokens[name],
                           f"{tag} {name}: A's tokens")
        nat = single.get("native shm", {})
        print(f"{tag} B adopted prefill, ms: " + json.dumps(
            {k: {kk: round(vv, 3) for kk, vv in v.items()}
             if isinstance(v, dict) else round(v, 3)
             for k, v in times.items()})
              + f"; single-node native shm (store phase) "
              + json.dumps({k: round(v, 3) for k, v in nat.items()})
              + f"; B store-free cold {cold_b:.3f} ms")
        print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")
        return launches
    finally:
        if saved_env is None:
            os.environ.pop("ISTPU_CLIENT", None)
        else:
            os.environ["ISTPU_CLIENT"] = saved_env
        for e in engines:
            e.transfer.close()
        for p in pools:
            p.close()
        for proc, _port in nodes:
            if proc.poll() is None:
                _stop(proc)
            else:  # killed: its pool segments outlive it
                for f in glob.glob(f"/dev/shm/istpu_{proc.pid}_*"):
                    os.unlink(f)
        del engines
        gc.collect()
        torch.cuda.empty_cache()


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
    (``examples.fleet_processes --smoke``) on the card, whose prefill
    worker must launch K3 and decode worker K2 and K1.  Returns the launch counts over the routed
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


# the MoE rule's rank bound: a routing flip may move a token this far down
# the dense forward's ranking (vLLM's check_logprobs_close holds bf16 MoE
# outputs by the same kind of top-N rank)
MOE_MAX_RANK = 10


def teacher_forced(torch, forward, params, cfg, dev, p, out, what,
                   moe: bool = False, within_top: int = 0) -> int:
    """Each greedy token of ``out`` (after prompt ``p``) against the argmax
    of a teacher-forced cold prefill of prompt + output through
    ``forward``: fails unless every token is the argmax or within
    ``TOL["bfloat16"]`` (relative) of its logit.  Returns the count of
    tokens that are.

    ``moe``: a token may also sit lower, within the dense forward's top
    ``MOE_MAX_RANK``: bf16 noise in the residual stream, which differs
    between the engine's paths and the dense forward, flips a top-2 expert
    choice where two router logits nearly tie, and the flip moves that
    position's logits by more than rounding does (the caller bounds how
    many tokens may take this way).

    ``within_top``: the rank rule of a path whose sums run in another
    order (the tensor-parallel all-reduce): each token also within the
    teacher-forced top ``within_top``."""
    with torch.no_grad():
        logits, _ = forward(params, cfg, torch.tensor([p + out], device=dev))
    rows = logits[0, len(p) - 1:len(p) - 1 + len(out)].float()
    toks = torch.tensor(out, device=dev)
    top = rows.max(dim=-1).values
    mine = rows.gather(1, toks[:, None])[:, 0]
    exact = int((rows.argmax(dim=-1) == toks).sum())
    gaps = (top - mine) / top.abs()
    gap = gaps.max().item()
    near = int((gaps <= TOL["bfloat16"]).sum())
    rank = int((rows > mine[:, None]).sum(-1).max())
    print(f"{what}: {exact}/{len(out)} tokens the exact argmax of a "
          f"teacher-forced cold prefill, {near} within {TOL['bfloat16']} "
          f"(relative) of its logit; largest relative gap {gap:.4f}, lowest "
          f"rank {rank}")
    if moe:
        check(rank <= MOE_MAX_RANK, f"{what}: a greedy token ranks {rank} "
              f"in the teacher-forced dense forward (<= {MOE_MAX_RANK})")
    else:
        check(gap <= TOL["bfloat16"], f"{what}: a greedy token is {gap:.4f} "
              f"(relative) below the teacher-forced argmax")
        check(not within_top or rank < within_top,
              f"{what}: a greedy token ranks {rank} (0 = the argmax) in the "
              f"teacher-forced prefill, want < {within_top}")
    return near


def _serve_path(torch, ca, engine, reqs, n_new: int, tag: str) -> tuple:
    """``reqs`` (prompt, adapter id) through ``Scheduler(max_batch=8)`` on
    ``engine``, each for ``n_new`` greedy tokens, with every launch count
    set to 0 just before and read just after.  Fails unless each request
    got its tokens, K1, K2 and K3 launched, and the path replayed decode
    graphs and prefill graphs holding K3 and K2.  Returns (launches, the
    outputs in order)."""
    from infinistore_tpu_torch.engine import Scheduler
    from infinistore_tpu_torch.utils.metrics import MetricsRegistry

    sched = Scheduler(engine, max_batch=8, metrics=MetricsRegistry())
    ca.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [sched.submit(p, n_new, adapter_id=a) for p, a in reqs]
    done = {}
    while sched.has_work:
        for r in sched.step():
            done[r.req_id] = r
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ca.LAUNCHES)
    print(f"{tag} launches on the path: {json.dumps(launches)}")
    outs = [done[i].output for i in ids]
    check(all(len(o) == n_new for o in outs),
          f"{tag} a request returned {[len(o) for o in outs]} tokens")
    check(all(launches[k] > 0 for k in MODEL_PATH_KERNELS),
          f"{tag} a kernel was not launched on the path: {launches}")
    pl = engine.graph_launches("prefill")
    check(engine.graph_replays["decode"] > 0 and pl.get("flash_causal", 0)
          and pl.get("flash_prefix", 0),
          f"{tag} no decode graph replay, or no prefill graph replay "
          f"holding K3 and K2 ({json.dumps(pl)})")
    # one admission wave, then one decode chunk of ``n_new`` tokens: the
    # scheduler shows a request's tokens at the chunk's end, so TTFT is
    # the whole run and TPOT says nothing here
    print(f"{tag} {len(ids)} requests ({sorted(len(p) for p, _a in reqs)} "
          f"prompt tokens, {n_new} new each) in {wall:.3f} s; decode graphs "
          f"{engine.graph_replays['decode']} "
          f"replays, {engine.graph_captures['decode']} captures; prefill "
          f"graphs {engine.graph_replays['prefill']} replays of keys "
          f"{sorted(engine._prefill_graphs)}, launches {json.dumps(pl)}")
    return launches, outs


def _prefill_keys_equal(torch, engine, tag: str, adapter: int = 0) -> None:
    """Each captured prefill key's replay ``torch.equal`` to its eager body
    (logits and KV) over the key's static buffers: row 0, the whole prefix
    buffer valid, ``adapter`` in a bank's id buffer."""
    for key, pg in sorted(engine._prefill_graphs.items()):
        if pg.graph is None:
            continue
        with engine._on_engine_stream():
            pg.last.fill_(0)
            if pg.plen is not None:
                pg.plen.fill_(key[1])
            if pg.aid is not None:
                pg.aid.fill_(adapter)
            pg.graph.replay()
            replayed = [pg.logits.clone(), pg.kv.clone()]
            engine._prefill_body(pg)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(replayed,
                                                      [pg.logits, pg.kv]))
        print(f"{tag} prefill graph {key}: replay torch.equal to the eager "
              f"body: {same}")
        check(same, f"{tag} prefill graph {key} differs from its eager body")


def _decode_runs(torch, engines, steps: int, tag: str, card: str):
    """The B=len(states) decode step through the graphs and through the
    eager step body of each ``engines[name]`` (its own states), from the
    same start (tokens and last logits rewound): the graph's tokens and
    final logits must equal the eager body's.  Then each graph run under
    ``torch.profiler``.  Returns {name: ms per step bare}."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (eng, sts) in engines.items():
        eng._decode_batch(sts, 2, eager=True)
        eng.decode_batch(sts, 2)  # captures this key
        torch.cuda.synchronize()
        start = [(len(st.tokens), st.last_logits) for st in sts]
        got = {}
        for eager in (True, False):
            for st, (n, lg) in zip(sts, start):
                del st.tokens[n:]
                st.last_logits = lg
            t0 = time.perf_counter()
            toks = eng._decode_batch(sts, steps, eager=eager)
            torch.cuda.synchronize()
            got[eager] = ((time.perf_counter() - t0) * 1e3 / steps, toks,
                          torch.stack([st.last_logits for st in sts]))
        same = got[True][1] == got[False][1] and torch.equal(got[True][2],
                                                            got[False][2])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.decode_batch(sts, steps)
            torch.cuda.synchronize()
        kinds, _top, n_k = _device_time_by_kind(torch, prof)
        busy = sum(kinds.values()) / steps
        print(f"{tag} decode B={len(sts)} {name}: graph "
              f"{got[False][0]:.3f} ms/step, eager body {got[True][0]:.3f} "
              f"ms/step; tokens and final logits graph == eager: {same}; "
              + (f"graph device {busy:.3f} ms/step ({100 * busy / got[False][0]:.1f}"
                 f"% busy), {n_k / steps:.0f} kernels/step, ms/step by kind "
                 + json.dumps({k: round(v / steps, 4) for k, v in
                               sorted(kinds.items(), key=lambda kv: -kv[1])})
                 if busy else "the profiler saw no device time: not measured")
              + f" ({card})")
        check(same, f"{tag} {name}: the graph-replayed decode differs from "
              f"the eager step body")
        out[name] = got[False][0]
    return out


def _cold_ms(torch, engine, prompts, adapter: int = 0) -> float:
    """Best bare wall ms of cold prefills of ``prompts`` (fresh) on
    ``engine`` (its chunks through its prefill graphs)."""
    best = float("inf")
    for p in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.release(engine.prefill(p, adapter_id=adapter))
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


LORA_LENGTHS = (64, 200, 350, 512, 700, 1000, 1300, 1500)
LORA_ADAPTERS = (0, 1, 2, 3, 4, 1, 2, 3)


def phase_lora(torch, ca, dev, params, cfg, pc, card: str,
               store_port: int) -> dict:
    """Multi-LoRA serving on Llama-3-8B (full width and depth): a bank of 4
    adapters plus the base, rank 16 on wq/wk/wv/wo, ``init_scale`` 0.05.
    8 fresh requests of 64-1500 tokens on adapters {0..4} mixed in one
    ``Scheduler(max_batch=8)`` batch (K3/K2 in prefill graphs, K1 in
    decode graphs, the adapter ids in their static buffers); each
    adapter's greedy tokens against a teacher-forced prefill on
    ``merge_lora``'s weights for that adapter (one merged at a time); each
    prefill key's replay and the B=8 decode step's graph equal to their
    eager bodies; the decode step and a cold 1500-token prefill beside an
    engine without a bank; then the store's adapter namespaces on the
    native store server (``store_port``): engine A prefills a fresh prompt
    on adapter 2, engine B adopts all its chunks for adapter 2 and none for
    adapter 3 or the base.  Returns the serving path's launches."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import prefill_forward
    from infinistore_tpu_torch.models.lora import init_lora_bank, merge_lora

    tag, N_NEW = "[lora]", 32
    t_phase = time.perf_counter()
    bank = init_lora_bank(cfg, ["a1", "a2", "a3", "a4"], 16,
                          torch.Generator(device=dev).manual_seed(7), dev,
                          init_scale=0.05)
    nbytes = sum(t.numel() * t.element_size()
                 for ab in bank.tree.values() for t in ab)
    print(f"{tag} bank: {bank.n_adapters} slots (base + 4), rank 16 on "
          f"{sorted(bank.tree)}, {nbytes / 2 ** 20:.1f} MiB")
    engine = InferenceEngine(params, cfg, pc, prefill_chunk=512, lora=bank)
    rng = torch.Generator().manual_seed(4242)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    engine.release(engine.prefill(prompt(40), adapter_id=1))  # warm-up
    reqs = [(prompt(n), a) for n, a in zip(LORA_LENGTHS, LORA_ADAPTERS)]
    launches, outs = _serve_path(torch, ca, engine, reqs, N_NEW, tag)
    check(all(k[-1] == "lora" for k in [*engine._graphs,
                                         *engine._prefill_graphs]),
          f"{tag} a graph key without the bank")
    # each adapter's tokens against its merged weights, one merged copy at
    # a time; and the base model's argmax differs from each adapter's
    # tokens somewhere (the bank changes the model)
    for a in sorted(set(LORA_ADAPTERS)):
        merged = params if a == 0 else merge_lora(params, bank, a)
        for (p, aa), out in zip(reqs, outs):
            if aa != a:
                continue
            exact = teacher_forced(torch, prefill_forward, merged, cfg, dev,
                                   p, out, f"{tag} adapter {a}, {len(p)}-"
                                   f"token prompt, merged weights")
            if a:
                with torch.no_grad():
                    lg, _ = prefill_forward(params, cfg, torch.tensor(
                        [p + out], device=dev))
                base = lg[0, len(p) - 1:-1].argmax(-1).tolist()
                same = sum(x == y for x, y in zip(base, out))
                print(f"{tag} adapter {a}: {same}/{N_NEW} of its tokens the "
                      f"base model's argmax ({exact} its merged model's)")
                check(same < N_NEW, f"{tag} adapter {a} left every token "
                      f"of a {len(p)}-token prompt as the base model's")
        del merged
        torch.cuda.empty_cache()
    _prefill_keys_equal(torch, engine, tag, adapter=2)
    # the B=8 decode step with the adapters against an engine without a
    # bank, and a cold 1500-token prefill on each
    base = InferenceEngine(params, cfg, dataclasses.replace(pc, n_blocks=1024),
                           prefill_chunk=512)
    ps = [prompt(n) for n in LORA_LENGTHS]
    runs = _decode_runs(torch, {
        "adapters 0-4 mixed": (engine, [engine.prefill(p, adapter_id=a)
                                        for p, a in zip(ps, LORA_ADAPTERS)]),
        "no bank": (base, [base.prefill(p) for p in ps])}, 16, tag, card)
    for eng in (engine, base):
        eng.release(eng.prefill(prompt(1500), adapter_id=0))  # captures
    cold = {"adapter 2": _cold_ms(torch, engine, [prompt(1500)
                                                  for _ in range(2)], 2),
            "no bank": _cold_ms(torch, base, [prompt(1500) for _ in range(2)])}
    print(f"{tag} B=8 decode step: adapters {runs['adapters 0-4 mixed']:.3f} "
          f"ms against {runs['no bank']:.3f} ms without a bank; cold "
          f"1500-token prefill (512-token chunks in graphs), best of 2: "
          f"adapter 2 {cold['adapter 2']:.3f} ms against {cold['no bank']:.3f}"
          f" ms without a bank ({card})")
    print(f"{tag} held: {_held(engine)}")
    del engine, base
    torch.cuda.empty_cache()

    # the store's adapter namespaces on the native store server
    conns, engines = [], []
    saved_env = os.environ.get("ISTPU_CLIENT")
    os.environ["ISTPU_CLIENT"] = "native"
    try:
        for _ in range(2):
            c = lib.InfinityConnection(ClientConfig(
                host_addr="127.0.0.1", service_port=store_port,
                connection_type=TYPE_SHM, log_level="warning"))
            c.connect()
            conns.append(c)
            engines.append(InferenceEngine(params, cfg, pc, conn=c,
                                           kv_quant=None, prefill_chunk=512,
                                           model_id="smoke-lora", lora=bank))
        a, b = engines
        p = prompt(1500)
        want = (len(p) - 1) // pc.block_tokens
        sa = a.prefill(p, adapter_id=2)
        got = {}
        for aid in (2, 3, 0):
            st = b.prefill(p, adapter_id=aid)
            got[aid] = (st.reused_chunks, st.store_chunks)
            if aid == 2:
                sb = st
            else:
                b.release(st)
        print(f"{tag} store: A pushed a fresh {len(p)}-token prompt on "
              f"adapter 2; B adopted (reused, from the store) chunks by "
              f"adapter: {json.dumps({str(k): v for k, v in got.items()})}")
        check(got[2] == (want, want) and got[3] == (0, 0) and got[0] == (0, 0),
              f"{tag} store: B adopted {got}, wanted {want} for adapter 2 "
              f"and none for adapter 3 or the base")
        ta, tb = a.decode(sa, 16), b.decode(sb, 16)
        agree = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                     len(ta))
        print(f"{tag} store: B's 16 greedy tokens on adapter 2 equal A's "
              f"for the first {agree}")
        check(agree > 0, f"{tag} store: B's first token differs from A's")
        merged = merge_lora(params, bank, 2)
        for name, out in (("A", ta), ("B", tb)):
            teacher_forced(torch, prefill_forward, merged, cfg, dev, p, out,
                           f"{tag} store: {name}'s adapter-2 tokens")
        del merged
    finally:
        if saved_env is None:
            os.environ.pop("ISTPU_CLIENT", None)
        else:
            os.environ["ISTPU_CLIENT"] = saved_env
        for e in engines:
            e.transfer.close()
        for c in conns:
            c.close()
    del engines
    torch.cuda.empty_cache()
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


MOE_LAYERS = 16  # of Mixtral-8x7B's 32: 16 layers of bf16 experts are 47 GB


def phase_moe(torch, ca, dev, card: str) -> dict:
    """The MoE family at Mixtral-8x7B's widths (dim 4096, 32 / 8 heads,
    head_dim 128, ffn 14336, 8 experts, top-2, vocab 32000, rope theta 1e6)
    and ``MOE_LAYERS`` of its 32 layers, random bf16 weights drawn on the
    card as a state dict in transformers' Mixtral names and imported there
    by ``moe_params_from_hf`` (each source freed as it is stacked; the peak
    printed).  8 fresh requests of 64-1500 tokens through
    ``Scheduler(max_batch=8)`` with ``prefill_chunk=512`` (K3 and K2 in
    prefill graphs, K1 in decode graphs), their greedy tokens against a
    teacher-forced dense ``moe_prefill_forward`` (``teacher_forced``'s MoE
    rule: at least 80% of them the argmax or within ``TOL["bfloat16"]`` of
    it, every one within its top ``MOE_MAX_RANK``); each prefill key's replay
    and the B=8 decode step's graph equal to their eager bodies; the decode
    step, a cold 1500-token prefill and their device time by kind.  Returns
    the path's launches."""
    from torch.profiler import ProfilerActivity, profile

    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models.hf import moe_params_from_hf
    from infinistore_tpu_torch.models.moe import (MIXTRAL_8X7B,
                                                  moe_decode_forward,
                                                  moe_prefill_forward,
                                                  moe_verify_forward,
                                                  scaled_moe)

    tag, N_NEW = "[moe]", 32
    t_phase = time.perf_counter()
    cfg = scaled_moe(MIXTRAL_8X7B, n_layers=MOE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(3)
    D, F_, E, hd = cfg.dim, cfg.ffn_dim, cfg.n_experts, cfg.head_dim

    def w(shape, fan_in):
        return torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                           device=dev).div_(math.sqrt(fan_in))

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    base_mem = torch.cuda.memory_allocated()
    print(f"{tag} the card holds {base_mem / 1e9:.2f} GB of tensors before "
          f"the phase")
    state = {"model.embed_tokens.weight": w((cfg.vocab_size, D), D),
             "model.norm.weight": ones(D),
             "lm_head.weight": w((cfg.vocab_size, D), D)}
    for li in range(cfg.n_layers):
        p = f"model.layers.{li}."
        state.update({
            p + "self_attn.q_proj.weight": w((cfg.n_heads * hd, D), D),
            p + "self_attn.k_proj.weight": w((cfg.n_kv_heads * hd, D), D),
            p + "self_attn.v_proj.weight": w((cfg.n_kv_heads * hd, D), D),
            p + "self_attn.o_proj.weight": w((D, cfg.n_heads * hd),
                                             cfg.n_heads * hd),
            p + "input_layernorm.weight": ones(D),
            p + "post_attention_layernorm.weight": ones(D),
            p + "block_sparse_moe.gate.weight": w((E, D), D),
        })
        for e in range(E):
            q = f"{p}block_sparse_moe.experts.{e}."
            state.update({q + "w1.weight": w((F_, D), D),
                          q + "w3.weight": w((F_, D), D),
                          q + "w2.weight": w((D, F_), F_)})
    torch.cuda.synchronize()
    drawn = torch.cuda.memory_allocated() - base_mem
    t_draw = time.perf_counter() - t_phase
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = moe_params_from_hf(state, cfg, consume=True)
    torch.cuda.synchronize()
    t_import = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base_mem
    peak = torch.cuda.max_memory_allocated() - base_mem
    print(f"{tag} Mixtral-8x7B widths, {cfg.n_layers} of 32 layers: state "
          f"dict in transformers' names drawn on the card in {t_draw:.1f} s "
          f"({drawn / 1e9:.2f} GB bf16); moe_params_from_hf on the card in "
          f"{t_import:.2f} s, {held / 1e9:.2f} GB held after, peak "
          f"{peak / 1e9:.2f} GB ({(peak - drawn) / 1e9:.2f} GB over the "
          f"state dict)")
    check(not state, f"{tag} the import left {len(state)} source tensors")
    del state
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=hd, n_blocks=2048, block_tokens=16,
                          dtype=cfg.dtype)
    engine = InferenceEngine(params, cfg, pc, prefill_chunk=512,
                             prefill_fn=moe_prefill_forward,
                             decode_fn=moe_decode_forward,
                             verify_fn=moe_verify_forward)
    rng = torch.Generator().manual_seed(5151)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    engine.release(engine.prefill(prompt(40)))  # warm-up
    reqs = [(prompt(n), 0) for n in LORA_LENGTHS]
    launches, outs = _serve_path(torch, ca, engine, reqs, N_NEW, tag)
    near = sum(teacher_forced(torch, moe_prefill_forward, params, cfg, dev,
                              p, out, f"{tag} {len(p)}-token prompt, dense "
                              f"forward", moe=True)
               for (p, _a), out in zip(reqs, outs))
    n = N_NEW * len(reqs)
    print(f"{tag} {near}/{n} greedy tokens the argmax of the dense forward "
          f"or within {TOL['bfloat16']} of it (>= 80%), the rest within its "
          f"top {MOE_MAX_RANK}")
    check(near >= 0.8 * n, f"{tag} only {near}/{n} greedy tokens within "
          f"{TOL['bfloat16']} of the dense forward's argmax")
    _prefill_keys_equal(torch, engine, tag)
    ps = [prompt(n) for n in LORA_LENGTHS]
    step = _decode_runs(torch, {"graph": (engine, [engine.prefill(q)
                                                   for q in ps])},
                        16, tag, card)["graph"]
    engine.release(engine.prefill(prompt(1500)))  # captures
    cold = _cold_ms(torch, engine, [prompt(1500) for _ in range(2)])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.release(engine.prefill(prompt(1500)))
        torch.cuda.synchronize()
    kinds, top, n_k = _device_time_by_kind(torch, prof)
    busy = sum(kinds.values())
    print(f"{tag} B=8 decode step {step:.3f} ms (graph); cold 1500-token "
          f"prefill (512-token chunks in graphs) {cold:.3f} ms best of 2, "
          + (f"device {busy:.3f} ms in {n_k} kernels, ms by kind "
             + json.dumps({k: round(v, 3) for k, v in
                           sorted(kinds.items(), key=lambda kv: -kv[1])})
             if busy else "the profiler saw no device time: not measured")
          + f" ({card})")
    for ms, k, kname in sorted(top, reverse=True)[:4]:
        print(f"{tag}   {ms:8.4f} ms  {k:5d}  {kname}")
    print(f"{tag} held: {_held(engine)} (graph pool at the captures "
          f"{engine.graph_pool_bytes / 2 ** 20:.1f} MiB)")
    del engine, params
    torch.cuda.empty_cache()
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- the train phase: distillation, checkpoints, engine resume, train steps ----

CORPUS_SEQS = 32  # the draft's corpus: sequences of 16 prompt and 48 greedy
CORPUS_PROMPT, CORPUS_GEN, CORPUS_BATCH = 16, 48, 8  # tokens, at B=8
DISTILL_STEPS, DISTILL_BATCH = 100, 16
DISTILL_LR = 3e-3  # the reference's ``distill`` default
PROBE_PROMPTS, PROBE_GEN, PROBE_K = 4, 48, 4
TRAIN_TOKENS = 512  # one B=1 batch for the full-width train steps
TRAIN_LR = 1e-2  # plain SGD on bf16 weights: large enough not to underflow
TRAIN_STEPS = 3
RESUME_LENGTHS = (700, 300)  # the resumed engine's two live sequences
RESUME_NEW = 16
# of Mixtral-8x7B's 32 layers: each holds 2.9 GB of bf16 weights and as
# much again in gradients (5.5 GiB a layer with its activations at 512
# tokens); at 13 the step ran out of the card's 79.18 GiB after the
# earlier phases (72.90 GiB allocated, 4.66 GiB cached)
MOE_TRAIN_LAYERS = 12


def _launch_delta(ca, before: dict) -> dict:
    return {k: ca.LAUNCHES[k] - before[k] for k in ca.KERNELS}


def _kernel_counts(d: dict) -> str:
    return (f"K1 {d['paged_decode']}, K3 {d['flash_causal']}, K2 "
            f"{d['flash_prefix']}")


def _grads_checked(torch, loss, params, tokens, what: str) -> float:
    """One backward of ``loss(params, tokens)`` over every leaf (each
    layer's slice of a stacked tensor its own, as ``train_step_fn`` takes
    them: ``models.llama.trainable``): fails unless each leaf's gradient
    exists, is finite and is not all zero.  Returns the loss."""
    from infinistore_tpu_torch.models.llama import trainable

    tree, pairs = trainable(params)
    with torch.enable_grad():
        value = loss(tree, tokens)
        grads = torch.autograd.grad(value, [a for _, a in pairs],
                                    allow_unused=True)
    bad = [i for i, g in enumerate(grads)
           if g is None or not bool(torch.isfinite(g).all())
           or not bool(g.abs().max() > 0)]
    del tree, pairs, grads
    print(f"{what}: {len(bad) or 'every'} leaf gradient"
          f"{'s' if not bad else ''} {'missing, non-finite or zero' if bad
          else 'present, finite and nonzero'} (each layer's slice a leaf)")
    check(not bad, f"{what}: leaves {bad} have no usable gradient")
    return float(value)


def _train_steps(torch, step, params, tokens, what: str, card: str) -> None:
    """``TRAIN_STEPS`` steps of ``step`` on one batch: the loss must fall
    and no attention kernel may launch (the training forward runs the
    plain attention, ``use_kernels=False``); then one more step under
    ``torch.profiler``, its device time by kind printed."""
    from infinistore_tpu_torch.ops import cuda_attention as ca

    before = dict(ca.LAUNCHES)
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, tokens)
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    kern = _launch_delta(ca, before)
    # one more step under the profiler: where a step's device time goes
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(params, tokens)
        torch.cuda.synchronize()
    groups, top, n_kernels = _device_time_by_kind(torch, prof)
    top.sort(reverse=True)
    print(f"{what}: a profiled fourth step, device "
          f"{sum(groups.values()):.3f} ms in {n_kernels} kernels, ms by kind "
          f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}; "
          f"top {[(round(ms, 3), n, name) for ms, n, name in top[:4]]}")
    print(f"{what}: losses {[round(x, 5) for x in losses]}, ms per step "
          f"{[round(x, 3) for x in ms]}, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
          f" GiB), kernel "
          f"launches {_kernel_counts(kern)} ({card})")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{what}: the loss did not fall: {losses}")
    check(not any(kern.values()), f"{what}: a kernel launched in training")


def _refuses_grad(torch, ca, dev) -> None:
    """K1, K2 and K3 called on the card with an input that requires grad
    raise (no kernel has a backward); under ``no_grad`` the same calls
    launch."""
    g = torch.Generator(device=dev).manual_seed(11)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    q, k, v = r(1, 128, 32, 128), r(1, 128, 8, 128), r(1, 128, 8, 128)
    kp, vp = r(1, 256, 8, 128), r(1, 256, 8, 128)
    q1, cache = r(2, 32, 128), r(2, 8, 8, 16, 128)
    table = torch.arange(8, device=dev, dtype=torch.int32).reshape(2, 4)
    lens = torch.tensor([64, 30], device=dev, dtype=torch.int32)
    calls = {"K3": (ca.flash_causal_attention_cuda, (q, k, v)),
             "K2": (ca.flash_prefix_attention_cuda, (q, kp, vp, 128, 100)),
             "K1": (ca.paged_decode_attention_cuda, (q1, cache, table, lens))}
    for name, (fn, args) in calls.items():
        grad_args = (args[0].clone().requires_grad_(),) + args[1:]
        with torch.enable_grad():
            try:
                fn(*grad_args)
                raised = ""
            except RuntimeError as e:
                raised = str(e)
        print(f"[train] {name} on the card with q requiring grad raises: "
              f"{raised or 'NO'}")
        check("no backward" in raised, f"{name} ran under autograd")


def phase_train(torch, ca, dev, params, cfg, pc, card: str) -> dict:
    """The training and durability path on the smoke's Llama-3-8B (bf16):
    (a) ``generate_corpus``: 32 sequences of 16 random prompt and 48
    greedy tokens at B=8 (K3 in prefill, K1 in decode graphs); (b)
    ``distill`` of a Llama-3.2-1B-shaped draft (its own seed) on it, 100
    float32 steps at batch 16 (the loss must fall); (c) ``acceptance_probe``
    at k=4 on 4 held-out prompts (48 tokens each) for the random-init and
    the distilled draft, and for the distilled one on 4 corpus prompts;
    (e) the distilled draft's bf16 params through ``CheckpointManager``
    (async save, restore with ``like`` onto the card, bitwise equal); (f) an engine on a native shm store holding two live
    sequences saves its state, a fresh engine resumes it (chunks adopted,
    K2 on the tails) and decodes 16 greedy tokens by the rank rule against
    the uninterrupted engine's; then K1/K2/K3 refusing autograd and (d)
    three ``train_step_fn`` steps on a 512-token batch, IN PLACE on the
    smoke's weights (the caller drops them after).  Returns the phase's
    kernel launches, (a) to (f)."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.engine.distill import (acceptance_probe,
                                                      distill,
                                                      generate_corpus)
    from infinistore_tpu_torch.models import (LLAMA3_1B, init_params,
                                              loss_fn, scaled, train_step_fn)
    from infinistore_tpu_torch.models.llama import leaves
    from infinistore_tpu_torch.utils import CheckpointManager
    import numpy as np

    tag = "[train]"
    t_phase = time.perf_counter()
    small = dataclasses.replace(pc, n_blocks=256)
    ca.reset_launches()

    # (a) the corpus, from the target engine
    target = InferenceEngine(params, cfg, small, device=dev)
    t0 = time.perf_counter()
    corpus = generate_corpus(target, n_seqs=CORPUS_SEQS,
                             prompt_len=CORPUS_PROMPT, gen_len=CORPUS_GEN,
                             batch=CORPUS_BATCH)
    torch.cuda.synchronize()
    kern = dict(ca.LAUNCHES)
    print(f"{tag} (a) corpus {corpus.shape} from Llama-3-8B at B="
          f"{CORPUS_BATCH} in {time.perf_counter() - t0:.2f} s, "
          f"{len(np.unique(corpus[:, CORPUS_PROMPT:]))} distinct generated "
          f"tokens; launches {_kernel_counts(kern)}")
    check(kern["flash_causal"] > 0 and kern["paged_decode"] > 0,
          f"{tag} the corpus launched no K3 or no K1: {kern}")

    # (b) distillation of a Llama-3.2-1B-shaped draft, float32 masters
    dcfg = LLAMA3_1B
    p0 = init_params(scaled(dcfg, dtype=torch.float32),
                     torch.Generator(device=dev).manual_seed(1), dev)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(ca.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dparams, losses = distill(dcfg, corpus, steps=DISTILL_STEPS,
                              batch=DISTILL_BATCH, lr=DISTILL_LR,
                              params=p0, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} (b) distill Llama-3.2-1B widths ({dcfg.n_layers} layers, "
          f"dim {dcfg.dim}, vocab {dcfg.vocab_size}) in float32, "
          f"{DISTILL_STEPS} steps at batch {DISTILL_BATCH} x "
          f"{corpus.shape[1]} tokens, lr {DISTILL_LR}: losses "
          f"{[round(x, 5) for x in losses]}; "
          f"{1e3 * dt / DISTILL_STEPS:.3f} ms/step; peak allocated "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above "
          f"the resident {base / 2**30:.2f}); kernel launches "
          f"{_kernel_counts(_launch_delta(ca, before))} ({card})")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{tag} distillation did not lower the loss: {losses}")
    check(all(p.dtype == torch.bfloat16 for p in leaves(dparams)),
          f"{tag} the distilled params are not bf16")
    draft0 = {k: ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(torch.bfloat16))
              for k, v in p0.items()}
    del p0

    # (c) acceptance of the random-init and the distilled draft
    def draft_engine(p):
        return InferenceEngine(p, dcfg, dataclasses.replace(
            small, n_layers=dcfg.n_layers, n_kv_heads=dcfg.n_kv_heads,
            head_dim=dcfg.head_dim), device=dev)

    held = [[int(x) for x in np.random.RandomState(100 + i).randint(
        1, cfg.vocab_size, size=CORPUS_PROMPT)] for i in range(PROBE_PROMPTS)]
    seen = [[int(t) for t in corpus[i, :CORPUS_PROMPT]]
            for i in range(PROBE_PROMPTS)]
    for name, p, prompts in (("random-init", draft0, held),
                             ("distilled", dparams, held),
                             ("distilled", dparams, seen)):
        before = dict(ca.LAUNCHES)
        t0 = time.perf_counter()
        acc, per_round = acceptance_probe(target, draft_engine(p), prompts,
                                          gen_len=PROBE_GEN, k=PROBE_K)
        torch.cuda.synchronize()
        which = "held-out" if prompts is held else "corpus"
        print(f"{tag} (c) acceptance_probe, {name} draft, {PROBE_PROMPTS} "
              f"{which} prompts ({PROBE_GEN} tokens each): acceptance "
              f"{acc:.4f}, {per_round:.4f} tokens per round at k={PROBE_K} "
              f"({time.perf_counter() - t0:.2f} s; launches "
              f"{_kernel_counts(_launch_delta(ca, before))}) ({card})")
    del draft0, target

    # (e) the distilled draft's bf16 params through CheckpointManager
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "smoke_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(ckdir, max_to_keep=1)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(dparams))
    t0 = time.perf_counter()
    mgr.save(DISTILL_STEPS, dparams, metadata={"losses": losses})
    t_call = time.perf_counter() - t0
    mgr.wait()
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = mgr.restore(like=dparams)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    same = all(a.device == b.device and a.dtype == b.dtype
               and torch.equal(a, b)
               for a, b in zip(leaves(restored), leaves(dparams)))
    meta = mgr.restore_metadata()
    mgr.close()
    shutil.rmtree(ckdir)
    print(f"{tag} (e) checkpoint of the distilled draft ({n_bytes / 1e9:.3f} "
          f"GB bf16): save {t_call:.3f} s to return (device-to-host copy), "
          f"{t_save:.3f} s to wait() ({n_bytes / 1e9 / t_save:.3f} GB/s); "
          f"restore onto {dev} {t_restore:.3f} s "
          f"({n_bytes / 1e9 / t_restore:.3f} GB/s); bitwise equal: {same} "
          f"({card})")
    check(same and meta == {"losses": losses},
          f"{tag} the restored checkpoint differs")
    del restored, dparams

    # (f) an engine resumed from its saved state over a native shm store
    _engine_resume(torch, ca, dev, params, cfg, pc, card)

    _refuses_grad(torch, ca, dev)
    launches = dict(ca.LAUNCHES)

    # (d) full-width train steps on the smoke's weights (in place)
    tokens = torch.from_numpy(np.random.RandomState(7).randint(
        1, cfg.vocab_size, size=(1, TRAIN_TOKENS))).to(dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _grads_checked(torch, lambda p, t: loss_fn(p, cfg, t), params, tokens,
                   f"{tag} (d) Llama-3-8B bf16 B=1 S={TRAIN_TOKENS}")
    _train_steps(torch, train_step_fn(cfg, lr=TRAIN_LR), params, tokens,
                 f"{tag} (d) Llama-3-8B bf16, {TRAIN_STEPS} train_step_fn "
                 f"steps (lr {TRAIN_LR}, B=1, S={TRAIN_TOKENS})", card)
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"{_kernel_counts(launches)}")
    return launches


def _engine_resume(torch, ca, dev, params, cfg, pc, card: str) -> None:
    """(f): engine A (native shm store, lossless pages) holds two live
    sequences and saves its state; engine B, fresh, resumes them (each
    adopting its stored chunks, K2 on the tail); both decode
    ``RESUME_NEW`` greedy tokens, B's held to A's by the rank rule."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig, TYPE_SHM
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import prefill_forward
    from infinistore_tpu_torch.utils import (resume_engine_state,
                                             save_engine_state)
    import numpy as np

    tag = "[train] (f)"
    small = dataclasses.replace(pc, n_blocks=256)
    store, port = _start_store(prealloc_gib=1,
                               min_alloc_kib=max(16, pc.page_bytes // 1024),
                               backend="native")
    saved_env = os.environ.get("ISTPU_CLIENT")
    os.environ["ISTPU_CLIENT"] = "native"
    conns = []
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_engine_state.json")
    try:
        for _ in range(2):
            c = lib.InfinityConnection(ClientConfig(
                host_addr="127.0.0.1", service_port=port,
                connection_type=TYPE_SHM, log_level="warning"))
            c.connect()
            conns.append(c)
        a, b = (InferenceEngine(params, cfg, small, conn=c, kv_quant=None,
                                model_id="smoke-resume", device=dev)
                for c in conns)
        rng = np.random.RandomState(21)
        prompts = [[int(x) for x in rng.randint(1, cfg.vocab_size, size=n)]
                   for n in RESUME_LENGTHS]
        sts = [a.prefill(p) for p in prompts]
        a.decode_batch(sts, 8)
        save_engine_state(path, a)
        before = dict(ca.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = resume_engine_state(path, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        kern = _launch_delta(ca, before)
        rs = [b.seqs[st.seq_id] for st in sts]
        print(f"{tag} engine state of {len(sts)} live sequences "
              f"({[len(st.tokens) for st in sts]} tokens) saved and resumed "
              f"into a fresh engine in {1e3 * dt:.3f} ms: reused_chunks "
              f"{[r.reused_chunks for r in rs]} (store "
              f"{[r.store_chunks for r in rs]}), launches "
              f"{_kernel_counts(kern)} ({card})")
        check(n == len(sts) and all(r.tokens == st.tokens
                                    for r, st in zip(rs, sts)),
              f"{tag} the resumed sequences differ")
        check(all(r.reused_chunks > 0 for r in rs) and kern["flash_prefix"]
              > 0, f"{tag} no chunk adopted or no K2 on the tails")
        history = [list(st.tokens) for st in sts]
        want = a.decode_batch(sts, RESUME_NEW)
        got = b.decode_batch(rs, RESUME_NEW)
        for h, g, w in zip(history, got, want):
            rank_rule(torch, prefill_forward, params, cfg, dev, h, g, w,
                      f"{tag} {len(h)}-token sequence, {RESUME_NEW} tokens "
                      f"after resume", f32=False)
    finally:
        for c in conns:
            c.close()
        if saved_env is None:
            os.environ.pop("ISTPU_CLIENT", None)
        else:
            os.environ["ISTPU_CLIENT"] = saved_env
        _stop(store)
        if os.path.exists(path):
            os.remove(path)


def phase_train_moe(torch, dev, card: str) -> None:
    """(d) for the MoE family: Mixtral-8x7B's widths at
    ``MOE_TRAIN_LAYERS`` of its 32 layers (bf16 weights and their
    gradients fill the card), random weights drawn on the card from a seed;
    every leaf's gradient present and finite, then three
    ``moe_train_step_fn`` steps on one 512-token batch, the loss falling,
    no kernel launched."""
    from infinistore_tpu_torch.models import (MIXTRAL_8X7B, init_moe_params,
                                              moe_loss_fn, moe_train_step_fn,
                                              scaled_moe)
    import numpy as np

    tag = "[train] (d)"
    cfg = scaled_moe(MIXTRAL_8X7B, n_layers=MOE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_moe_params(cfg, torch.Generator(device=dev).manual_seed(3),
                             dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"],
                                      params["ln_out"],
                                      *params["layers"].values()])
    print(f"{tag} Mixtral-8x7B widths at {cfg.n_layers} of 32 layers: "
          f"{n_params / 1e9:.2f} B params (bf16, router f32) drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        1, cfg.vocab_size, size=(1, TRAIN_TOKENS))).to(dev)
    torch.cuda.reset_peak_memory_stats()
    _grads_checked(torch, lambda p, t: moe_loss_fn(p, cfg, t), params,
                   tokens, f"{tag} Mixtral widths B=1 S={TRAIN_TOKENS}")
    torch.cuda.empty_cache()  # the checked gradients' blocks, for the steps
    _train_steps(torch, moe_train_step_fn(cfg, lr=TRAIN_LR), params, tokens,
                 f"{tag} Mixtral widths ({cfg.n_layers} layers), "
                 f"{TRAIN_STEPS} moe_train_step_fn steps (lr {TRAIN_LR}, B=1, "
                 f"S={TRAIN_TOKENS})", card)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# ---- the tp phase: tensor-parallel serving (ranks in spawned processes) ----

TP_NEW = 32  # greedy new tokens per request on the tp serving path
TP_WORLD_TIMEOUT_S = 600.0


def _tp_entry(rank, world, init_file, backend, task, kw, out_dir):
    """One rank of a spawned tensor-parallel world: joins it over
    ``backend`` through a FileStore on ``cuda:(rank % cards)``, runs
    ``task(rank, world, **kw)`` without autograd and writes its result (or
    its traceback) to ``out_dir/rank<r>.pkl``."""
    import pickle
    import traceback

    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        import torch

        from infinistore_tpu_torch.parallel import initialize

        torch.cuda.set_device(rank % torch.cuda.device_count())
        initialize(init_method=f"file://{init_file}", world_size=world,
                   rank=rank, backend=backend)
        with torch.no_grad():
            res = ("ok", task(rank, world, **kw))
    except BaseException:  # noqa: BLE001 — the parent raises with it
        res = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(res, f)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _tp_world(task, world: int, backend: str, **kw) -> list:
    """Every rank's ``task(rank, world, **kw)`` in rank order, each rank a
    process of its own (start method ``spawn``); a rank that fails fails
    the call with its traceback, a world past ``TP_WORLD_TIMEOUT_S`` is
    killed.  No process outlives the call."""
    import multiprocessing as mp
    import pickle
    import tempfile

    tmp = tempfile.mkdtemp(prefix="istpu-tp-world-")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_tp_entry, args=(
        r, world, os.path.join(tmp, "store"), backend, task, kw, tmp))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TP_WORLD_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        check(not any(p.is_alive() for p in procs),
              f"a {world}-rank {backend} world outlived "
              f"{TP_WORLD_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        check(os.path.exists(path), f"tp rank {r} exited "
              f"{procs[r].exitcode} with no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        check(status == "ok", f"tp rank {r} failed:\n{value}")
        out.append(value)
    return out


def _pages_digest(t) -> str:
    """sha256 of a tensor's bytes (whole pages, compared bitwise)."""
    import hashlib

    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def _tp_compositions(torch, rank: int, world: int, dev) -> dict:
    """Each ``_tp`` composition on this rank's head shard of seeded bf16
    inputs at Llama-3-8B's attention widths; the shards gathered on rank 0
    and held against the plain version over all heads.  Each rank times
    its own shard in turn (the other waits).  Returns, on rank 0, one
    record per composition."""
    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as F

    import bench_gpu
    from infinistore_tpu_torch.models import attention as A
    from infinistore_tpu_torch.ops import cuda_attention as ca

    H, Hkv, D = 32, 8, 128
    h, hk = H // world, Hkv // world
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    tol = TOL["bfloat16"]

    def gather(x, dim):
        x = x.cpu().contiguous()
        parts = [torch.empty_like(x) for _ in range(world)] if rank == 0 \
            else None
        dist.gather(x, parts, dst=0)
        return torch.cat(parts, dim=dim).to(dev) if rank == 0 else None

    def in_turn(fn, reps):
        ms = None
        for r in range(world):
            dist.barrier()
            if r == rank:
                ms = bench_gpu.median_device_ms(torch, fn, reps, flush)
        dist.barrier()
        vals = [None] * world
        dist.all_gather_object(vals, ms)
        return vals

    def shard(x, dim, n):
        return x.narrow(dim, rank * n, n).contiguous()

    def launches(fn, kernels):
        before = dict(ca.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        counts = [ca.LAUNCHES[k] - before[k] for k in kernels]
        vals = [None] * world
        dist.all_gather_object(vals, counts)
        return out, vals

    def record(name, tpu_line, got, want, ms, plain_ms, lib_ms, n_bytes,
               flops, counts):
        if rank != 0:
            return None
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        b_ms, b_by = bound_ms(n_bytes, flops)
        print(f"[tp] {name}: gathered over {world} ranks vs the plain "
              f"version over all heads: max_abs_err={err:.3e} (atol=rtol="
              f"{tol}) {'ok' if ok else 'MISMATCH'}; per rank launches "
              f"{counts}, device ms {[round(m, 4) for m in ms]}, plain ms "
              f"{[round(m, 4) for m in plain_ms]}, library ms "
              f"{[None if m is None else round(m, 4) for m in lib_ms]}; "
              f"bound of one rank's shard {b_ms:.4f} ms by {b_by}")
        check(ok and math.isfinite(err), f"{name} disagrees with its plain "
              f"version (max_abs_err={err})")
        check(all(sum(c) > 0 for c in counts),
              f"{name}: a rank launched no kernel {counts}")
        return dict(name=name, route="cuda",
                    source="infinistore_tpu_torch/models/attention.py",
                    replaces="infinistore_tpu/models/attention.py:" + tpu_line,
                    max_abs_err=err, ms=ms[0], plain_ms=plain_ms[0],
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms[0],
                    rank_ms=ms, check_launches=counts)

    rec = {}
    # K1 at the serving path's mixed batch (B=8, lengths 1..1500, a pad row)
    q, cache, table, lens, real = bench_gpu.decode_inputs(
        torch, np, dev, torch.bfloat16, "mixed")
    qs, cs = shard(q, 1, h), shard(cache, 1, hk)

    def k1():
        return A.paged_decode_attention_tp(qs, cs, table, lens, world,
                                           n_heads=H, n_kv_heads=Hkv)

    got, counts = launches(k1, ["paged_decode"])
    got = gather(got, 1)
    want = ca.paged_decode_attention_xla(q, cache, table, lens) \
        if rank == 0 else None
    tokens = float(real.sum())
    rec["paged_decode_tp"] = record(
        "paged_decode_attention_tp", "367", got, want, in_turn(k1, 30),
        in_turn(lambda: ca.paged_decode_attention_xla(qs, cs, table, lens),
                5), [None] * world,
        tokens * hk * D * 2 * 2 + 2 * qs.numel() * 2 + table.numel() * 4
        + table.shape[0] * 4, 4.0 * h * D * tokens, counts)
    del q, cache, qs, cs

    def qkv(B, Sq, Sk, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]

    def sdpa(q, k, v, **kw):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True, **kw).transpose(1, 2)

    # K3 at 2048 tokens
    S = 2048
    q, k, v = qkv(1, S, S, 4)
    qs, ks, vs = shard(q, 2, h), shard(k, 2, hk), shard(v, 2, hk)

    def k3():
        return A.flash_causal_attention_tp(qs, ks, vs, world, n_heads=H,
                                           n_kv_heads=Hkv)

    got, counts = launches(k3, ["flash_causal", "flash_prefix"])
    got = gather(got, 2)
    want = ca.causal_attention_xla(q, k, v) if rank == 0 else None
    rec["flash_causal_tp"] = record(
        "flash_causal_attention_tp", "83", got, want, in_turn(k3, 20),
        in_turn(lambda: ca.causal_attention_xla(qs, ks, vs), 5),
        in_turn(lambda: sdpa(qs, ks, vs, is_causal=True), 20),
        2 * (2 * S * h * D + 2 * S * hk * D), 4.0 * h * D * S * (S + 1) / 2,
        counts)
    # K2 with a prefix_len: pad 1024, 700 valid, 512 new rows
    pad, plen, Sq = 1024, 700, 512
    q, k, v = qkv(1, Sq, pad + Sq, 5)
    qs, ks, vs = shard(q, 2, h), shard(k, 2, hk), shard(v, 2, hk)
    k_pos = torch.arange(pad + Sq, device=dev)
    i = torch.arange(Sq, device=dev)[:, None]
    mask = (k_pos[None] < plen) | ((k_pos[None] >= pad)
                                   & (k_pos[None] - pad <= i))

    def k2():
        return A.flash_causal_attention_tp(
            qs, ks, vs, world, q_offset=pad, prefix_pad=pad,
            prefix_len=plen, n_heads=H, n_kv_heads=Hkv)

    got, counts = launches(k2, ["flash_causal", "flash_prefix"])
    got = gather(got, 2)
    want = ca.causal_attention_xla(q, k, v, prefix_pad=pad,
                                   prefix_len=plen) if rank == 0 else None
    rec["flash_prefix_tp"] = record(
        "flash_causal_attention_tp[prefix_len]", "83", got, want,
        in_turn(k2, 20),
        in_turn(lambda: ca.causal_attention_xla(
            qs, ks, vs, prefix_pad=pad, prefix_len=plen), 5),
        in_turn(lambda: sdpa(qs, ks, vs, attn_mask=mask), 20),
        2 * (2 * Sq * h * D + 2 * (plen + Sq) * hk * D),
        4.0 * h * D * (plen * Sq + Sq * (Sq + 1) / 2), counts)
    # every composition at TINY's shard (H=2, H_kv=1 per rank at tp=2,
    # head size 32: one KV head, one query group), as serve --tp 2 runs it
    g = torch.Generator(device=dev).manual_seed(9)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    H, Hkv, D = 4, 2, 32
    h, hk = H // world, Hkv // world
    q, cache = rnd(8, H, D), rnd(2, Hkv, 128, 16, D)
    table = torch.randperm(128, device=dev, generator=g)[:64].view(
        8, 8).to(torch.int32)
    lens = torch.randint(1, 129, (8,), device=dev, generator=g).to(
        torch.int32)
    got = gather(A.paged_decode_attention_tp(
        shard(q, 1, h), shard(cache, 1, hk), table, lens, world,
        n_heads=H, n_kv_heads=Hkv), 1)
    errs = []
    if rank == 0:
        errs.append((got.float() - ca.paged_decode_attention_xla(
            q, cache, table, lens).float()).abs().max().item())
    for pad, plen, Sq in ((0, 0, 40), (32, 20, 8)):
        q, k, v = rnd(1, Sq, H, D), rnd(1, pad + Sq, Hkv, D), rnd(
            1, pad + Sq, Hkv, D)
        kw = dict(q_offset=pad, prefix_pad=pad, prefix_len=plen) if pad \
            else {}
        got = gather(A.flash_causal_attention_tp(
            shard(q, 2, h), shard(k, 2, hk), shard(v, 2, hk), world,
            n_heads=H, n_kv_heads=Hkv, **kw), 2)
        if rank == 0:
            want = ca.causal_attention_xla(
                q, k, v, **({"prefix_pad": pad, "prefix_len": plen} if pad
                            else {}))
            errs.append((got.float() - want.float()).abs().max().item())
    if rank == 0:
        print(f"[tp] K1, K3 and K2 compositions at TINY's shard (H=2, "
              f"H_kv=1, D=32 per rank), gathered vs the plain version: "
              f"max_abs_err {[f'{e:.3e}' for e in errs]} (atol={tol})")
        check(all(e <= tol for e in errs), "a composition at TINY's shard "
              "disagrees with its plain version")
    del flush
    return rec


def _group_serve_task(rank: int, world: int, mesh_kw, reqs, p_cold, p1,
                      p1_digest, p2, store_port: int, spec_prompt=None,
                      lora_reqs=None) -> dict:
    """One rank of a two-rank serving group over gloo on one card
    (``mesh_kw``: ``{"tp": 2}`` or ``{"pp": 2}``): on a tp group the
    compositions first; then Llama-3-8B (every rank drawing only its shard
    of the seeded weights: its heads, or its stage's 16 layers) serving
    ``reqs`` through ``Scheduler`` on rank 0, its first-token logits, the
    eager decode step and a cold prefill; with ``spec_prompt``, the
    speculation leg on that engine (plain, n-gram and the leader's
    unsharded self-draft, B=1, k=4); with ``lora_reqs``, the lora phase's
    bank (each rank drawing its shard) serving them; then an engine on the
    native store adopting ``p1`` (pages gathered over the ranks, their
    digest against ``p1_digest``) and pushing ``p2``.  Returns rank 0's
    numbers."""
    import torch

    from infinistore_tpu_torch import lib as ist
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import LLAMA3_8B, init_params
    from infinistore_tpu_torch.models.lora import init_lora_bank
    from infinistore_tpu_torch.ops import build
    from infinistore_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    out = {"nvcc_runs_at_start": build.NVCC_RUNS}
    if mesh_kw.get("tp", 1) > 1:
        out["compositions"] = _tp_compositions(torch, rank, world, dev)
    mesh = make_mesh(**mesh_kw)
    shard = dict(tp_rank=mesh.get_local_rank("tp"), tp=mesh["tp"].size(),
                 pp_rank=mesh.get_local_rank("pp"), pp=mesh["pp"].size())
    cfg = LLAMA3_8B
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev, **shard)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    # the draw's device peak above what the rank held before it, and the
    # shard's bytes: no rank holds the whole model on the card
    out["init_peak"] = torch.cuda.max_memory_allocated(dev) - base
    out["shard_bytes"] = sum(
        t.numel() * t.element_size() for t in [
            params["embed"], params["lm_head"], params["ln_out"],
            *params["layers"].values()])
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, n_blocks=1024,
                          block_tokens=16, dtype=cfg.dtype)

    def group_engine(run, **kw):
        """An engine of the group: rank 0 runs ``run(engine)`` into
        ``out``, the others follow."""
        engine = InferenceEngine(params, cfg, pc, mesh=mesh, device=dev,
                                 prefill_chunk=512, **kw)
        if rank != 0:
            engine.follow()
        else:
            try:
                out.update(run(engine))
            finally:
                engine.shutdown_followers()
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    def serving(engine):
        res = _tp_leader_serving(torch, engine, reqs, p_cold)
        if spec_prompt is not None:
            res["spec"] = _group_leader_spec(torch, engine, cfg, pc, dev,
                                             spec_prompt)
        return res

    group_engine(serving)
    if lora_reqs is not None:
        bank = init_lora_bank(cfg, ["a1", "a2", "a3", "a4"], 16,
                              torch.Generator(device=dev).manual_seed(7),
                              dev, init_scale=0.05, **shard)
        def lora_leg(e):
            res = _tp_leader_serving(torch, e, [p for p, _a in lora_reqs],
                                     None, [a for _p, a in lora_reqs])
            res["logits_prompt"] = lora_reqs[4][0]
            res["first_logits_by_adapter"] = []
            for a in range(e.lora.n_adapters):
                st = e.prefill(res["logits_prompt"], adapter_id=a)
                res["first_logits_by_adapter"].append(
                    st.last_logits.float().cpu())
                e.release(st)
            return {"lora": res}

        group_engine(lora_leg, lora=bank)
        del bank
    conn = None
    if rank == 0:
        conn = ist.InfinityConnection(ist.ClientConfig(
            host_addr="127.0.0.1", service_port=store_port,
            connection_type=ist.TYPE_SHM, log_level="warning"))
        conn.connect()
    b = InferenceEngine(params, cfg, dataclasses.replace(pc, n_blocks=512),
                        mesh=mesh, device=dev, prefill_chunk=512, conn=conn,
                        kv_quant=None, store_durability="strict",
                        model_id="tp-smoke")
    if rank != 0:
        b.follow()
        return out
    try:
        out.update(_tp_leader_store(torch, b, p1, p1_digest, p2))
    finally:
        b.shutdown_followers()
        conn.close()
    return out


def _rank_launches(after, before) -> list:
    """Each rank's kernel launches between two ``tp_report``s."""
    return [{k: a["kernel_launches"][k] - b["kernel_launches"][k]
             for k in a["kernel_launches"]} for a, b in zip(after, before)]


def _tp_leader_serving(torch, engine, reqs, p_cold, adapters=None) -> dict:
    """Rank 0's serving run (see ``_group_serve_task``): ``reqs`` (on
    ``adapters``, default the base) through ``Scheduler``, each rank's
    launches counted from the run's start; with ``p_cold``, then the
    first request's first-token logits, the B=8 eager decode step and a
    cold prefill of ``p_cold``."""
    from infinistore_tpu_torch.engine import Scheduler
    from infinistore_tpu_torch.utils.metrics import MetricsRegistry

    out = {}
    engine.release(engine.prefill(list(range(1, 41))))  # warm-up
    before = engine.tp_report()
    sched = Scheduler(engine, max_batch=8, metrics=MetricsRegistry())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [sched.submit(p, TP_NEW, adapter_id=a) for p, a in
           zip(reqs, adapters or [0] * len(reqs))]
    done = {}
    while sched.has_work:
        for r in sched.step():
            done[r.req_id] = r
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t0
    after = engine.tp_report()
    out["outputs"] = [done[i].output for i in ids]
    out["rank_launches"] = _rank_launches(after, before)
    out["held_bytes"] = [a["held_bytes"] for a in after]
    out["layers"] = [a["layers"] for a in after]
    out["ranks_agree"] = all(a["tokens"] == after[0]["tokens"]
                             for a in after)
    out["backend"] = after[0]["backend"]
    out["cuda_graphs"] = [a["cuda_graphs"] for a in after]
    out["nvcc_runs"] = [a["nvcc_runs"] for a in after]
    if p_cold is None:
        return out
    # the first request's first-token logits, and the B=8 eager decode step
    st = engine.prefill(reqs[0])
    out["first_logits"] = st.last_logits.float().cpu()
    states = [st] + [engine.prefill(p) for p in reqs[1:]]
    engine.decode_batch(states, 2)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_batch(states, 16)
    torch.cuda.synchronize()
    out["decode_step_ms"] = (time.perf_counter() - t0) * 1e3 / 16
    for s in states:
        engine.release(s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.release(engine.prefill(p_cold))
    torch.cuda.synchronize()
    out["cold_prefill_ms"] = (time.perf_counter() - t0) * 1e3
    return out


SPEC_TP_NEW = 64  # greedy tokens of the speculation leg under tp


def _group_leader_spec(torch, engine, cfg, pc, dev, p) -> dict:
    """Rank 0's speculation leg on the group's target (see
    ``_group_serve_task``): ``SPEC_TP_NEW`` greedy tokens after ``p`` by
    plain decode, by the n-gram speculator (k=4, g=2) and by the
    self-draft (the leader's own unsharded Llama-3-8B, drawn here from
    the same seed, k=4), each timed after its prefill; every rank's
    launches over the leg."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.engine.ngram import NgramSpeculator
    from infinistore_tpu_torch.engine.speculative import SpeculativeDecoder
    from infinistore_tpu_torch.models import init_params

    out = {}
    before = engine.tp_report()

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        out[name + "_ms_per_token"] = (
            (time.perf_counter() - t0) * 1e3 / SPEC_TP_NEW)

    st = engine.prefill(p)
    timed("plain", lambda: engine.decode(st, SPEC_TP_NEW))
    engine.release(st)
    ng = NgramSpeculator(engine, 4, 2)
    st = ng.prefill(p)
    timed("ngram", lambda: ng.decode(st, SPEC_TP_NEW))
    engine.release(st)
    out["ngram_acceptance"] = ng.acceptance_rate
    out["ngram_rounds"] = ng.rounds
    draft = InferenceEngine(
        init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev),
        cfg, dataclasses.replace(pc, n_blocks=256), device=dev,
        prefill_chunk=512)
    out["draft_launches"] = _count_own_launches(draft)
    sd = SpeculativeDecoder(engine, draft, 4)
    st_t, st_d = sd.prefill(p)
    timed("draft", lambda: sd.decode(st_t, st_d, SPEC_TP_NEW))
    out["draft_acceptance"] = sd.acceptance_rate
    out["draft_rounds"] = sd.rounds
    out["rank_launches"] = _rank_launches(engine.tp_report(), before)
    # the sharded target's own: the leader's less its draft's, the
    # followers' whole (they run no draft)
    lead = out["rank_launches"][0]
    out["target_launches"] = [
        {k: lead[k] - out["draft_launches"][k] for k in lead},
        *out["rank_launches"][1:]]
    engine.release(st_t)
    del draft, sd, st_d
    return out


def _count_own_launches(engine) -> dict:
    """Counts the kernel launches made inside ``engine``'s own calls from
    here on: each method and function attribute of the instance is
    wrapped to add the launches its outermost call makes.  The speculation
    leg's leader launches its unsharded draft's kernels and its target's
    shard's from one thread, so the per-thread counts cannot tell them
    apart."""
    import functools
    import inspect

    from infinistore_tpu_torch.ops import cuda_attention as ca

    counts = dict.fromkeys(ca.KERNELS, 0)
    depth = [0]

    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            before = dict(ca.LAUNCHES)
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                for k, v in ca.LAUNCHES.items():
                    counts[k] += v - before[k]
        return counted

    for name in dir(type(engine)):
        if not name.startswith("__") and inspect.isfunction(
                inspect.getattr_static(type(engine), name)):
            setattr(engine, name, wrap(getattr(engine, name)))
    for name, v in list(vars(engine).items()):
        if isinstance(v, functools.partial):
            setattr(engine, name, wrap(v))
    return counts


def _tp_leader_store(torch, b, p1, p1_digest, p2) -> dict:
    """Rank 0's store hop (see ``_tp_serve_task``)."""
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1 = b.prefill(p1)
    torch.cuda.synchronize()
    out["adopt_ms"] = (time.perf_counter() - t0) * 1e3
    out["p1_store_chunks"] = s1.store_chunks
    n1 = (len(p1) - 1) // b.pc.block_tokens
    out["p1_pages_equal"] = _pages_digest(
        b._op("gather_pages", s1.block_ids[:n1])) == p1_digest
    out["p1_tokens"] = b.decode(s1, 16)
    s2 = b.prefill(p2)
    b.store_flush()
    n2 = (len(p2) - 1) // b.pc.block_tokens
    out["p2_digest"] = _pages_digest(b._op("gather_pages",
                                           s2.block_ids[:n2]))
    out["p2_tokens"] = b.decode(s2, 16)
    return out


def _tp_nccl_task(rank: int, world: int, prompts) -> dict:
    """Tensor parallelism over NCCL with the decode chunks and the
    speculation rounds replayed as CUDA graphs (the collectives captured
    inside): Llama-3-8B through a mesh engine and, on rank 0, the plain
    single-rank engine on the same weights; the greedy tokens of both, and
    at world size 1 both engines' n-gram and self-draft speculation (the
    draft the plain engine's weights, unsharded; rank 0)."""
    import torch

    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.engine.ngram import NgramSpeculator
    from infinistore_tpu_torch.engine.speculative import SpeculativeDecoder
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import LLAMA3_8B, init_params
    from infinistore_tpu_torch.parallel import make_mesh, shard_params

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    cfg = LLAMA3_8B
    gen = torch.Generator(device=dev).manual_seed(0)
    mesh = make_mesh(tp=world)
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, n_blocks=512,
                          block_tokens=16, dtype=cfg.dtype)
    full = init_params(cfg, gen, dev) if rank == 0 else None
    params = shard_params(full, mesh) if rank == 0 else init_params(
        cfg, gen, dev, tp_rank=rank, tp=world)
    eng = InferenceEngine(params, cfg, pc, mesh=mesh, device=dev,
                          prefill_chunk=512)
    if rank != 0:
        eng.follow()
        return {}

    def spec_runs(target, draft):
        ng = NgramSpeculator(target, 4, 2)
        sd = SpeculativeDecoder(target, draft, 4)
        return {"ngram": ng.generate(prompts[0], TP_NEW),
                "draft": sd.generate(prompts[1], TP_NEW)}

    try:
        states = [eng.prefill(p) for p in prompts]
        got = eng.decode_batch(states, TP_NEW)
        for st in states:
            eng.release(st)
        rep = eng.tp_report()
        res = {"tp": got, "backend": rep[0]["backend"],
               "cuda_graphs": [r["cuda_graphs"] for r in rep]}
        if world == 1:
            draft = InferenceEngine(full, cfg, pc, device=dev,
                                    prefill_chunk=512)
            res["spec_tp"] = spec_runs(eng, draft)
            del draft
        res["replays"] = dict(eng.graph_replays)
        res["captures"] = dict(eng.graph_captures)
    finally:
        eng.shutdown_followers()
    del eng
    gc.collect()
    plain = InferenceEngine(full, cfg, pc, device=dev, prefill_chunk=512)
    res["plain"] = plain.decode_batch([plain.prefill(p) for p in prompts],
                                      TP_NEW)
    res["plain_replays"] = dict(plain.graph_replays)
    if world == 1:
        draft = InferenceEngine(full, cfg, pc, device=dev, prefill_chunk=512)
        res["spec_plain"] = spec_runs(plain, draft)
    return res


def _tp_serve_cli_start():
    """Start ``python -m infinistore_tpu_torch.serve --model tiny --tp 2
    --dist-backend gloo`` as a subprocess; returns (process, port, start
    time).  Its SLO targets sit far above a gloo group's eager steps, so
    the admission plane never sheds this correctness leg."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.serve", "--model",
         "tiny", "--tp", "2", "--dist-backend", "gloo", "--port", str(port),
         "--n-blocks", "256", "--prefill-chunk", "32", "--kv-quant", "none",
         "--slo-ttft", "60", "--slo-tpot", "10", "--log-level", "warning"],
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, port, t0


def _tp_serve_cli(torch, card: str, proc, port: int, t0: float) -> None:
    """The ``serve --tp 2`` subprocess ``_tp_serve_cli_start`` started:
    three greedy completions, each 200; the tokens within the rank rule
    against a tp=1 engine on the same weights; both ranks' K1, K2 and K3
    launches from ``/debug/engine``; SIGTERM leaves no rank process
    behind."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import prefill_forward
    from infinistore_tpu_torch.serve import load_model

    pids = []
    try:
        deadline = time.time() + 180
        while True:
            try:
                _http(port, "GET", "/healthz")
                break
            except OSError:
                check(proc.poll() is None, "serve --tp 2 exited early")
                check(time.time() < deadline, "serve --tp 2 never came up")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        g = torch.Generator().manual_seed(77)
        prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
                   for n in (40, 72, 100)]
        outs = []
        for p in prompts:
            status, body = _http(port, "POST", "/v1/completions", {
                "prompt": p, "max_tokens": 16, "temperature": 0})
            check(status == 200, f"serve --tp 2 answered {status}: {body}")
            outs.append(json.loads(body)["choices"][0]["token_ids"])
        status, dbg = _http(port, "GET", "/debug/engine?limit=0")
        ranks = json.loads(dbg)["tp"]["ranks"]
        pids = [r["pid"] for r in ranks]
        print(f"[tp] serve --tp 2 (gloo, tiny): up in {up_s:.1f} s, 3 "
              f"completions 200; per rank kernel launches "
              f"{[r['kernel_launches'] for r in ranks]}, cuda_graphs "
              f"{[r['cuda_graphs'] for r in ranks]}")
        for r in ranks:
            check(all(r["kernel_launches"][k] > 0 for k in
                      ("paged_decode", "flash_causal", "flash_prefix")),
                  f"serve --tp 2 rank {r['rank']} did not launch K1, K2 and "
                  f"K3: {r['kernel_launches']}")
        check(ranks[0]["tokens"] == ranks[1]["tokens"],
              "serve --tp 2: the ranks sampled different tokens")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    left = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            left.append(pid)
        except ProcessLookupError:
            pass
    print(f"[tp] serve --tp 2 exited {code} on SIGTERM; rank processes "
          f"left: {left}")
    check(not left, f"rank processes {left} outlived serve --tp 2")
    dev = torch.device("cuda")
    cfg, params, _ = load_model("tiny", dev)
    ref = InferenceEngine(params, cfg, PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_blocks=256, block_tokens=16,
        dtype=cfg.dtype), prefill_chunk=32, kv_quant=None)
    for p, o in zip(prompts, outs):
        rank_rule(torch, prefill_forward, params, cfg, dev, p, o,
                  ref.decode(ref.prefill(p), 16),
                  f"[tp] serve --tp 2 vs a tp=1 engine, {len(p)}-token "
                  f"prompt")


def rank_rule(torch, forward, params, cfg, dev, p, got, want,
              what: str, f32: bool = True) -> None:
    """The rank rule for a bf16 path whose sums run in another order than
    the reference's: each token of ``got`` that differs from ``want`` (the
    reference path's own tokens after prompt ``p``) ranks within the top 2
    of a teacher-forced cold prefill of prompt + ``got`` through
    ``forward``, its logit within ``TOL["bfloat16"]`` (relative) of the
    best there.  Ranks count the distinct bf16 logit values above the
    token's: tokens whose logits are equal in bf16 share a rank, since the
    teacher-forced prefill cannot order them (TINY's random logits tie so;
    with ``f32``, the top 4 of a float32 copy of the model are printed
    beside them: leave it off for a model whose float32 copy the card
    cannot hold beside it)."""
    with torch.no_grad():
        logits, _ = forward(params, cfg, torch.tensor([p + got], device=dev))
    rows = logits[0, len(p) - 1:len(p) - 1 + len(got)].float()
    diff = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
    ranks, gaps = [], []
    rows32 = None
    if f32 and diff:
        p32 = {k: (v.float() if torch.is_tensor(v) else
                   {kk: vv.float() for kk, vv in v.items()})
               for k, v in params.items()}
        with torch.no_grad():
            l32, _ = forward(p32, dataclasses.replace(cfg,
                                                      dtype=torch.float32),
                             torch.tensor([p + got], device=dev))
        rows32 = l32[0, len(p) - 1:len(p) - 1 + len(got)]
    for j in diff:
        row, mine = rows[j], rows[j, got[j]]
        ranks.append(int((row.unique() > mine).sum()))
        gaps.append(((row.max() - mine) / row.max().abs()).item())
        top = torch.topk(row, 4)
        line = (f"{what}: position {j}: served {got[j]}, reference path "
                f"{want[j]}; teacher-forced top 4 {top.indices.tolist()} "
                f"{[round(v, 5) for v in top.values.tolist()]}")
        if rows32 is not None:
            top32 = torch.topk(rows32[j], 4)
            line += (f"; in f32 {top32.indices.tolist()} "
                     f"{[round(v, 5) for v in top32.values.tolist()]}")
        print(line)
    print(f"{what}: {len(got) - len(diff)}/{len(got)} tokens equal; the "
          f"differing ones rank {ranks} in the teacher-forced prefill, "
          f"relative gaps {[round(g, 4) for g in gaps]}")
    check(all(r < 2 for r in ranks)
          and all(g <= TOL["bfloat16"] for g in gaps),
          f"{what}: a differing token breaks the rank rule (top 2, gap <= "
          f"{TOL['bfloat16']})")


def phase_tp(torch, ca, dev, params, cfg, pc, card: str,
             store_port: int) -> dict:
    """Multi-device serving on the card (module docstring, phase 7d): the
    tp=2 group (its compositions, serving, speculation and lora legs, the
    store hop), the pp=2 group (serving, the store hop), sp=2 prefill,
    NCCL at world size 1 and ``serve --tp 2``.  Returns the composition
    records and each path's launches summed over its ranks."""
    from infinistore_tpu_torch.engine import InferenceEngine

    t_phase = time.perf_counter()
    print(f"[tp] backend gloo: two ranks share cuda:0 and their collectives "
          f"cross the host, so the phase's times are no multi-device "
          f"speed (the smoke at {time.perf_counter() - T_START:.1f} s)")
    rng = torch.Generator().manual_seed(1212)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    shared = prompt(512)
    reqs = [prompt(64), prompt(200), shared + prompt(300),
            shared + prompt(100), prompt(1500), prompt(350), prompt(1000),
            prompt(130)]
    p_cold, p1, p2, p3 = prompt(1500), prompt(1500), prompt(1500), \
        prompt(1500)
    p_spec = prompt(600)
    lrng = torch.Generator().manual_seed(4343)
    lora_reqs = [(torch.randint(0, cfg.vocab_size, (n,),
                                generator=lrng).tolist(), a)
                 for n, a in zip(LORA_LENGTHS, LORA_ADAPTERS)]
    # engine A (tp=1, this process) pushes p1 for the groups to adopt
    from infinistore_tpu_torch import lib as ist

    conn = ist.InfinityConnection(ist.ClientConfig(
        host_addr="127.0.0.1", service_port=store_port,
        connection_type=ist.TYPE_SHM, log_level="warning"))
    conn.connect()
    a = InferenceEngine(params, cfg, dataclasses.replace(pc, n_blocks=512),
                        conn=conn, kv_quant=None, store_durability="strict",
                        model_id="tp-smoke", prefill_chunk=512)
    sa = a.prefill(p1)
    n1 = (len(p1) - 1) // pc.block_tokens
    p1_digest = _pages_digest(a.cache[:, :, :, torch.tensor(
        sa.block_ids[:n1], device=dev)])
    a_tokens = a.decode(sa, 16)
    print(f"[tp] A (tp=1) pushed p1's {n1} chunks; its tokens "
          f"{a_tokens[:6]}...")
    del a, sa
    gc.collect()
    torch.cuda.empty_cache()
    full = sum(t.numel() * t.element_size() for t in [
        params["embed"], params["lm_head"], params["ln_out"],
        *params["layers"].values()])
    common = dict(reqs=reqs, p_cold=p_cold, p1=p1, p1_digest=p1_digest,
                  store_port=store_port)
    out = {"launches": {}}
    # the tp=2 group, with the speculation and lora legs
    t_world = time.perf_counter()
    res = _tp_world(_group_serve_task, 2, "gloo", mesh_kw={"tp": 2}, p2=p2,
                    spec_prompt=p_spec, lora_reqs=lora_reqs, **common)[0]
    _check_group(torch, "tp=2", res, time.perf_counter() - t_world, full,
                 params, cfg, pc, dev, card, conn, reqs, p1, n1, p2)
    out["compositions"] = res["compositions"]
    out["launches"]["tp"] = _summed(res["rank_launches"])
    out["launches"]["spec_tp"] = _check_spec_tp(torch, res["spec"], params,
                                                cfg, dev, p_spec, card)
    # the compositions' launches on the spec path: the target's alone,
    # measured on each rank
    out["target_launches"] = {
        "spec_tp": _summed(res["spec"]["target_launches"])}
    out["launches"]["lora_tp"] = _check_lora_tp(torch, ca, res["lora"],
                                                params, cfg, pc, dev,
                                                lora_reqs)
    del res
    # the pp=2 group: each stage 16 layers, pushing a prompt of its own
    t_world = time.perf_counter()
    res = _tp_world(_group_serve_task, 2, "gloo", mesh_kw={"pp": 2}, p2=p3,
                    **common)[0]
    _check_group(torch, "pp=2", res, time.perf_counter() - t_world, full,
                 params, cfg, pc, dev, card, conn, reqs, p1, n1, p3)
    out["launches"]["pp"] = _summed(res["rank_launches"])
    conn.close()
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"]["sp"] = _sp_leg(torch, params, cfg, pc, dev, card,
                                    prompt(1500))
    # captured collectives: NCCL at world size 1 (and 2 where the machine
    # has two cards) with the decode chunks and speculation rounds
    # replayed as CUDA graphs, while the serve --tp 2 subprocess comes up
    # (both legs check results only)
    cli = _tp_serve_cli_start()
    try:
        _tp_nccl_legs(torch, params, cfg, dev, [reqs[0], reqs[1], reqs[5],
                                                reqs[4]])
    except BaseException:
        cli[0].kill()
        cli[0].wait()
        raise
    _tp_serve_cli(torch, card, *cli)
    print(f"[tp] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _summed(rank_launches) -> dict:
    """Launches summed over a path's ranks."""
    return {k: sum(r[k] for r in rank_launches) for k in rank_launches[0]}


def _check_ranks_launched(rank_launches, what: str,
                          kernels=("paged_decode", "flash_causal",
                                   "flash_prefix")) -> None:
    for r, counts in enumerate(rank_launches):
        check(all(counts[k] > 0 for k in kernels),
              f"{what}: rank {r} did not launch {kernels}: {counts}")


def _check_group(torch, label, res, world_s, full, params, cfg, pc, dev,
                 card, conn, reqs, p1, n1, p_push) -> None:
    """A serving group's results (see ``_group_serve_task``) against this
    process's tp=1 engine and weights: every rank's weight draw and
    shard, its K1/K2/K3 launches, the ranks' sampled tokens equal, the
    first-token logits, every token by the rank rule, the store hop both
    ways with pages bitwise equal."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import prefill_forward

    tag = f"[{label.split('=')[0]}]"
    gib, mib = 2 ** 30, 2 ** 20
    print(f"{tag} the two-rank {label} group ran in {world_s:.1f} s; rank 0 "
          f"drew its {res['shard_bytes'] / gib:.2f} GiB shard of the 8B "
          f"weights in {res['init_s']:.1f} s at a device peak of "
          f"{res['init_peak'] / gib:.2f} GiB (the whole model: "
          f"{full / gib:.2f} GiB); backend {res['backend']}, CUDA graphs per "
          f"rank {res['cuda_graphs']}, nvcc runs per rank {res['nvcc_runs']}")
    check(res["init_peak"] < full, f"{tag} a rank's weight draw held the "
          f"whole model on the card")
    check(res["nvcc_runs"] == [0, 0],
          f"{tag} a rank compiled kernels the leader had built: "
          f"{res['nvcc_runs']}")
    print(f"{tag} Llama-3-8B {label}: 8 requests x {TP_NEW} greedy tokens in "
          f"{res['serve_s']:.2f} s; per rank launches "
          f"{res['rank_launches']}; layers per rank {res['layers']}; "
          f"held_bytes per rank "
          f"{[round(b / mib, 1) for b in res['held_bytes']]} MiB; ranks "
          f"agree on every sampled token: {res['ranks_agree']}")
    check(res["ranks_agree"], f"{tag} the ranks sampled different tokens")
    _check_ranks_launched(res["rank_launches"], f"{tag} serving")
    ref = InferenceEngine(params, cfg, dataclasses.replace(pc, n_blocks=512),
                          prefill_chunk=512)
    st = ref.prefill(reqs[0])
    logits_agree(torch, res["first_logits"].to(dev), st.last_logits,
                 f"{tag} first-token logits, {label} vs tp=1")
    ref.release(st)
    del ref
    for p, o in zip(reqs, res["outputs"]):
        check(len(o) == TP_NEW, f"{tag} a request returned {len(o)} tokens")
        teacher_forced(torch, prefill_forward, params, cfg, dev, p, o,
                       f"{tag} {label} tokens, {len(p)}-token prompt",
                       within_top=2)
    print(f"{tag} {label} (gloo, eager, one card): B=8 decode step "
          f"{res['decode_step_ms']:.3f} ms; cold 1500-token prefill "
          f"{res['cold_prefill_ms']:.3f} ms; adopted 1500-token prefill "
          f"(93 chunks from the native store) {res['adopt_ms']:.3f} ms "
          f"({card})")
    # the store hop both ways, whole pages bitwise
    check(res["p1_store_chunks"] == n1 and res["p1_pages_equal"],
          f"{tag} adopted {res['p1_store_chunks']} chunks of p1 (want {n1}), "
          f"pages bitwise equal to A's: {res['p1_pages_equal']}")
    teacher_forced(torch, prefill_forward, params, cfg, dev, p1,
                   res["p1_tokens"], f"{tag} {label} tokens after adopting "
                   f"A's pages", within_top=2)
    c = InferenceEngine(params, cfg, dataclasses.replace(pc, n_blocks=512),
                        conn=conn, kv_quant=None, model_id="tp-smoke",
                        prefill_chunk=512)
    sc = c.prefill(p_push)
    n2 = (len(p_push) - 1) // pc.block_tokens
    check(sc.store_chunks == n2,
          f"{tag} C adopted {sc.store_chunks} of the {label} push's {n2} "
          f"chunks")
    c_same = _pages_digest(c.cache[:, :, :, torch.tensor(
        sc.block_ids[:n2], device=dev)]) == res["p2_digest"]
    print(f"{tag} store hop: the {label} group adopted A's {n1} chunks, "
          f"pages bitwise equal {res['p1_pages_equal']}; tp=1 C adopted the "
          f"group's {n2} chunks, pages bitwise equal {c_same}")
    check(c_same, f"{tag} C's adopted pages differ from the pages the "
          f"{label} group pushed")
    teacher_forced(torch, prefill_forward, params, cfg, dev, p_push,
                   res["p2_tokens"], f"{tag} {label} tokens of its pushed "
                   f"prompt", within_top=2)
    teacher_forced(torch, prefill_forward, params, cfg, dev, p_push,
                   c.decode(sc, 16), f"{tag} tp=1 C's tokens after adopting "
                   f"the {label} group's pages", within_top=2)
    del c, sc
    gc.collect()
    torch.cuda.empty_cache()


def _check_spec_tp(torch, r, params, cfg, dev, p, card: str) -> dict:
    """The tp=2 speculation leg (``_group_leader_spec``): the n-gram and
    self-draft tokens against the group's plain decode by the rank rule
    (teacher-forced on the tp=1 weights); the sharded target's launches
    on each rank (the leader's counted apart from its draft's), K1, K2 and
    K3 on every rank and the same counts on each; returns the leg's
    launches summed over the ranks, the draft's included."""
    from infinistore_tpu_torch.models import prefill_forward

    for name in ("ngram", "draft"):
        got, want = r[name], r["plain"]
        same = sum(x == y for x, y in zip(got, want))
        print(f"[tp] spec under tp=2, {name} (k=4, B=1, {SPEC_TP_NEW} "
              f"tokens): {same}/{SPEC_TP_NEW} tokens equal to plain tp=2 "
              f"decode; acceptance {r[name + '_acceptance']:.3f} over "
              f"{r[name + '_rounds']} rounds; "
              f"{r[name + '_ms_per_token']:.3f} ms/token against plain "
              f"{r['plain_ms_per_token']:.3f} ({card}, gloo, eager)")
        check(len(got) == SPEC_TP_NEW, f"[tp] spec {name} returned "
              f"{len(got)} tokens")
        if got != want:
            teacher_forced(torch, prefill_forward, params, cfg, dev, p, got,
                           f"[tp] spec under tp=2, {name} tokens",
                           within_top=2)
    check(r["draft_acceptance"] > 0.5, "[tp] the self-draft under tp=2 "
          f"accepted {r['draft_acceptance']:.3f} of its proposals")
    target = r["target_launches"]
    print(f"[tp] spec under tp=2: per rank launches {r['rank_launches']}; "
          f"the leader's unsharded draft's {r['draft_launches']}; so the "
          f"sharded target's per rank {target}")
    _check_ranks_launched(target, "[tp] spec under tp=2, the target")
    check(all(t == target[0] for t in target), "[tp] spec under tp=2: the "
          "ranks' targets launched different counts, though each runs the "
          "same ops on its shard")
    return _summed(r["rank_launches"])


def _check_lora_tp(torch, ca, r, params, cfg, pc, dev, lora_reqs) -> dict:
    """The tp=2 lora leg against a tp=1 engine with the same bank (the
    lora phase's, drawn here whole on the same seed): each adapter's
    first-token logits on one prompt (adapter 0 by ``logits_agree``, the
    others within one bf16 step of its max error E, each adapter's own
    delta from adapter 0 more than 4x that tolerance); the same 8 requests
    served, each tp=2 token at most 2E below the best of the tp=1
    engine's own logits teacher-forced along the tp=2 tokens (its paged
    ``verify`` with the bank, on the request's adapter: the bound a token
    picked as the argmax of logits within E of tp=1's can reach); the
    cold teacher-forced prefill's gaps printed beside them; K1, K2 and K3
    on every rank.  Returns the leg's launches summed over the ranks."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import prefill_forward
    from infinistore_tpu_torch.models.lora import init_lora_bank

    print(f"[tp] lora under tp=2: 8 requests over adapters "
          f"{sorted(set(LORA_ADAPTERS))} in {r['serve_s']:.2f} s; per rank "
          f"launches {r['rank_launches']}; ranks agree {r['ranks_agree']}")
    check(r["ranks_agree"], "[tp] lora under tp=2: the ranks sampled "
          "different tokens")
    _check_ranks_launched(r["rank_launches"], "[tp] lora under tp=2")
    bank = init_lora_bank(cfg, ["a1", "a2", "a3", "a4"], 16,
                          torch.Generator(device=dev).manual_seed(7), dev,
                          init_scale=0.05)
    ref = InferenceEngine(params, cfg, dataclasses.replace(pc, n_blocks=1024),
                          prefill_chunk=512, lora=bank)
    # adapter 0 (the base model through the bank engine) as the tp path's
    # first-token check; each adapter then within one bf16 step (at its
    # largest logit) of adapter 0's max error: the bank adds no error of
    # its own under tp
    base_err = None
    tp1, tp2 = [], [lg.to(dev) for lg in r["first_logits_by_adapter"]]
    for a, lg in enumerate(tp2):
        st = ref.prefill(r["logits_prompt"], adapter_id=a)
        tp1.append(st.last_logits.float())
        ref.release(st)
        what = (f"[tp] lora first-token logits, adapter {a}, tp=2 vs tp=1 "
                f"with the same bank")
        err = logits_agree(torch, lg, tp1[a], what, max_err=a == 0)
        if a == 0:
            base_err = err
            continue
        tol = base_err + tp1[a].abs().max().item() * 2 ** -8
        check(err <= tol, f"{what}: max error {err:.4f} past the base "
              f"model's {base_err:.4f} + one bf16 step = {tol:.4f}")
        # the bank's own effect, well past that tolerance: a bank sliced
        # wrong, or applied on one rank only, moves the logits by a share
        # of it (about half, for a delta dropped on one of two ranks)
        delta = (tp1[a] - tp1[0]).abs().max().item()
        delta2 = (lg - tp2[0]).abs().max().item()
        print(f"[tp] lora adapter {a}: its first-token logits differ from "
              f"adapter 0's by up to {delta:.4f} at tp=1, {delta2:.4f} at "
              f"tp=2; held to {tol:.4f} against tp=1 (must be below a "
              f"quarter of the delta, {delta / 4:.4f})")
        check(delta > 4 * tol, f"[tp] lora adapter {a}: its delta "
              f"{delta:.4f} is not 4x the tolerance {tol:.4f} it is held "
              f"to, so a fault in its slicing could pass")
    _, want = _serve_path(torch, ca, ref, lora_reqs, TP_NEW,
                          "[tp] lora, the tp=1 engine with the same bank:")
    same = sum(x == y for o, w in zip(r["outputs"], want)
               for x, y in zip(o, w))
    print(f"[tp] lora: {same}/{len(want) * TP_NEW} tp=2 tokens equal to the "
          f"tp=1 engine's with the same bank")
    # tp=2 picks the argmax of its logits, which are tp=1's within the
    # max error E measured above (adapter 0), so in tp=1's logits of the
    # same context its token is at most 2E below the best
    bound = 2 * base_err
    for (p, a), got, w in zip(lora_reqs, r["outputs"], want):
        st = ref.prefill(p, adapter_id=a)
        rows = torch.cat([st.last_logits[None],
                          ref.verify(st, got[:-1], len(p))]).float()
        ref.release(st)
        mine = rows.gather(1, torch.tensor(got, device=dev)[:, None])[:, 0]
        gap = (rows.max(dim=-1).values - mine).max().item()
        what = f"[tp] lora tp=2 vs tp=1, adapter {a}, {len(p)}-token prompt"
        # beside it, the cold teacher-forced prefill with the bank
        with torch.no_grad():
            lg, _ = prefill_forward(
                params, cfg, torch.tensor([p + got], device=dev),
                lora=bank.tree, adapter_ids=torch.tensor(
                    [a], dtype=torch.int32, device=dev),
                lora_scale=bank.scale)
        cold = lg[0, len(p) - 1:len(p) - 1 + len(got)].float()
        cmine = cold.gather(1, torch.tensor(got, device=dev)[:, None])[:, 0]
        ctop = cold.max(dim=-1).values
        print(f"{what}: {sum(x == y for x, y in zip(got, w))}/{len(got)} "
              f"tokens the tp=1 engine's; every token at most {gap:.4f} "
              f"below the best of the tp=1 engine's logits teacher-forced "
              f"along it (2E = {bound:.4f}); against a cold teacher-forced "
              f"prefill with the bank (not held): largest relative gap "
              f"{((ctop - cmine) / ctop.abs()).max().item():.4f}")
        check(gap <= bound, f"{what}: a token {gap:.4f} below the tp=1 "
              f"engine's best, past 2E = {bound:.4f}")
    del ref
    return _summed(r["rank_launches"])


SP_NEW = 32  # greedy tokens decoded from the sp prefill's adopted KV
# the sp prefill's max error against tp=1, in bf16 steps at the largest
# value: the ring's sums run in another order (Llama-3-8B, 1500 tokens,
# H100: 5.25 for the logits and 4.79 for the KV)
SP_STEPS = 6


def _sp_task(rank: int, world: int, p) -> dict:
    """One rank of the sp=2 group: Llama-3-8B whole on every rank (the
    seeded weights), ``make_sp_prefill`` over ``p`` timed; rank 0 then
    holds its logits and KV against a tp=1 ``prefill_forward`` on the same
    weights and adopts the KV into a tp=1 engine (``adopt_prefill``),
    decoding ``SP_NEW`` greedy tokens beside that engine's own prefill and
    decode of ``p``.  Returns rank 0's numbers."""
    import torch

    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import (LLAMA3_8B, init_params,
                                              prefill_forward)
    from infinistore_tpu_torch.ops import cuda_attention as ca
    from infinistore_tpu_torch.parallel import make_mesh, make_sp_prefill

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    cfg = LLAMA3_8B
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    mesh = make_mesh(sp=world)
    fn = make_sp_prefill(cfg, mesh)
    toks = torch.tensor([p], device=dev)
    fn(params, toks[:, :64])  # warm-up
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kv = fn(params, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"sp_ms": times}
    if rank != 0:
        return out
    ref_logits, ref_kv = prefill_forward(params, cfg, toks)
    for name, got, want in (("logits", logits, ref_logits),
                            ("kv", kv, ref_kv)):
        g, w = got.float().flatten(), want.float().flatten()
        out[name + "_cos"] = float(torch.nn.functional.cosine_similarity(
            g, w, dim=0))
        out[name + "_max_err"] = float((g - w).abs().max())
        out[name + "_max_abs"] = float(w.abs().max())
    del ref_logits, ref_kv
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, n_blocks=512,
                          block_tokens=16, dtype=cfg.dtype)
    eng = InferenceEngine(params, cfg, pc, prefill_chunk=512)
    T = pc.block_tokens
    pad = (-len(p)) % T
    kv_pad = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
    ca.reset_launches()
    st = eng.adopt_prefill(p, kv_pad, logits[0, -1])
    out["adopted"] = eng.decode(st, SP_NEW)
    torch.cuda.synchronize()
    out["launches"] = dict(ca.LAUNCHES)
    eng.release(st)
    out["free_pages_back"] = eng.free_pages == pc.n_blocks
    out["plain"] = eng.decode(eng.prefill(p), SP_NEW)
    return out


def _sp_leg(torch, params, cfg, pc, dev, card: str, p) -> dict:
    """Sequence-parallel prefill at sp=2 over gloo on one card (two ranks,
    each holding the whole model): logits and KV against tp=1 (cosine, max
    error within ``SP_STEPS`` of bf16's step), the adopted KV's tokens by
    the rank rule
    against the tp=1 engine's own; returns the path's launches (the
    adopted decode's: ring attention is plain PyTorch, as the
    reference's is jnp)."""
    from infinistore_tpu_torch.models import prefill_forward

    t0 = time.perf_counter()
    r = _tp_world(_sp_task, 2, "gloo", p=p)
    world_s = time.perf_counter() - t0
    r0 = r[0]
    print(f"[sp] sp=2 (gloo, one card) Llama-3-8B, one {len(p)}-token "
          f"prompt: make_sp_prefill {r0['sp_ms']} ms on rank 0, "
          f"{r[1]['sp_ms']} ms on rank 1 ({card}); the world ran in "
          f"{world_s:.1f} s")
    for name in ("logits", "kv"):
        step = r0[name + "_max_abs"] * 2 ** -8  # bf16's step at the max
        err = r0[name + "_max_err"]
        print(f"[sp] {name} against tp=1 prefill_forward: cosine "
              f"{r0[name + '_cos']:.6f}, max error {err:.5f} = "
              f"{err / step:.2f} of bf16's step at the largest value "
              f"({step:.5f}; held to {SP_STEPS})")
        check(r0[name + "_cos"] > 0.999 and err <= SP_STEPS * step,
              f"[sp] {name} against tp=1: cosine {r0[name + '_cos']:.6f}, "
              f"max error {err / step:.2f} bf16 steps")
    print(f"[sp] adopted KV -> tp=1 engine: launches {r0['launches']}; "
          f"pages back after release {r0['free_pages_back']}")
    check(r0["launches"]["paged_decode"] > 0 and r0["free_pages_back"],
          "[sp] the adopted decode launched no K1, or kept pages")
    rank_rule(torch, prefill_forward, params, cfg, dev, p, r0["adopted"],
              r0["plain"], "[sp] tokens decoded from the sp=2 prefill's KV "
              "vs the tp=1 engine's own", f32=False)
    return r0["launches"]


def _tp_nccl_legs(torch, params, cfg, dev, prompts) -> None:
    """NCCL with the decode chunks as CUDA graphs: at world size 1, tokens
    equal to the plain engine's; at 2 (with two cards), the rank rule."""
    from infinistore_tpu_torch.models import prefill_forward

    n_cards = torch.cuda.device_count()
    for world in (1, 2):
        if world > n_cards:
            print(f"[tp] tp={world} over nccl with CUDA graphs: not run, the "
                  f"machine has {n_cards} card(s)")
            continue
        t0 = time.perf_counter()
        r = _tp_world(_tp_nccl_task, world, "nccl", prompts=prompts)[0]
        same = r["tp"] == r["plain"]
        print(f"[tp] tp={world} over {r['backend']} with CUDA graphs (per "
              f"rank {r['cuda_graphs']}): decode replays {r['replays']}, "
              f"captures {r['captures']}; plain engine replays "
              f"{r['plain_replays']}; tokens equal to the plain single-rank "
              f"engine's: {same} ({time.perf_counter() - t0:.1f} s)")
        check(r["backend"] == "nccl" and all(r["cuda_graphs"])
              and r["replays"]["decode"] > 0,
              f"tp={world} over nccl replayed no decode graph: {r}")
        if world == 1:
            check(same, "world-size-1 NCCL graphs gave other tokens than the "
                  "plain engine")
            spec_same = r["spec_tp"] == r["spec_plain"]
            print(f"[tp] tp=1 over nccl: n-gram and self-draft speculation "
                  f"with the rounds' broadcasts and the verify's "
                  f"collectives in the round graphs (spec captures "
                  f"{r['captures']['spec']}, replays {r['replays']['spec']}):"
                  f" tokens equal to the plain engine's speculation: "
                  f"{spec_same}")
            check(r["captures"]["spec"] > 0 and r["replays"]["spec"] > 0,
                  "world-size-1 NCCL speculation captured no round graph")
            check(spec_same, "world-size-1 NCCL round graphs gave other "
                  "tokens than the plain engine's speculation")
        else:
            for p, o in zip(prompts, r["tp"]):
                teacher_forced(torch, prefill_forward, params, cfg, dev, p, o,
                               "[tp] tp=2 nccl tokens", within_top=2)
    print("[tp] pp=2 over nccl (the stage hand-offs and the logits' "
          "broadcast captured in the graphs): not run, one card holds one "
          "NCCL rank")


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
        torch.cuda.empty_cache()
        spec_launches = phase_spec(torch, ca, dev, params, cfg, card)
        overhead = phase_overhead(torch, ca, bench_gpu, prof)
        # one store server (4 GiB pool in /dev/shm) for the store and
        # fleet phases; its allocation unit is one full-precision page, so
        # a band's pages sit in one contiguous run of the pool
        t_store = time.perf_counter()
        min_alloc = max(16, pc.page_bytes // 1024)
        store, port = _start_store(prealloc_gib=4, min_alloc_kib=min_alloc)
        print(f"[store] the port's store server up in "
              f"{time.perf_counter() - t_store:.1f} s")
        try:
            t_store = time.perf_counter()
            nstore, nport = _start_store(prealloc_gib=4,
                                         min_alloc_kib=min_alloc,
                                         backend="native")
            print(f"[store] the port's native store server up in "
                  f"{time.perf_counter() - t_store:.1f} s")
            try:
                store_times = phase_store(torch, ca, dev, params, cfg, pc,
                                          {"python": port, "native": nport})
                lora_launches = phase_lora(torch, ca, dev, params, cfg, pc,
                                           card, nport)
                # the store and lora phases' engines hold reference cycles
                gc.collect()
                torch.cuda.empty_cache()
                tp = phase_tp(torch, ca, dev, params, cfg, pc, card, nport)
            finally:
                _stop(nstore)
            cluster_launches = phase_cluster(torch, ca, dev, params, cfg, pc,
                                             store_times)
            # the earlier phases' engines are gone: the card holds the
            # weights and the fleet's two caches
            torch.cuda.empty_cache()
            phase_fleet(torch, ca, dev, params, cfg, pc, card, ttft_by_len,
                        port)
        finally:
            _stop(store)
        # the serving phases' engines and servers hold reference cycles:
        # collected before the cache is emptied
        gc.collect()
        torch.cuda.empty_cache()
        # its last step trains the Llama-3-8B weights in place
        train_launches = phase_train(torch, ca, dev, params, cfg, pc, card)
        # last: the MoE phases need the card the Llama-3-8B weights held
        del params
        gc.collect()
        torch.cuda.empty_cache()
        moe_launches = phase_moe(torch, ca, dev, card)
        phase_train_moe(torch, dev, card)
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
        "spec_launches": spec_launches.get(key, 0),
        "lora_launches": lora_launches.get(key, 0),
        "cluster_launches": cluster_launches.get(key, 0),
        "moe_launches": moe_launches.get(key, 0),
        "train_launches": train_launches.get(key, 0),
        # the multi-device paths, each summed over its ranks
        **{f"{path}_launches": counts.get(key, 0)
           for path, counts in tp["launches"].items()},
    } for key, r in rec.items()]
    # the tensor-parallel compositions: each rank's K1 (K3, K2) on its head
    # shard; launches summed over the ranks of each tp path (the serving,
    # speculation and lora paths of the tp=2 group; on the speculation
    # path the target's alone, without its leader's unsharded draft,
    # each rank's counted on that rank)
    for key, r in tp["compositions"].items():
        per = {path: (c["paged_decode"] if key == "paged_decode_tp"
                      else c["flash_causal"] + c["flash_prefix"])
               for path, c in {**tp["launches"],
                               **tp["target_launches"]}.items()
               if path in ("tp", "spec_tp", "lora_tp")}
        kernels.append({
            k: r[k] for k in ("name", "route", "source", "replaces",
                              "max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")})
        kernels[-1].update(launches=per["tp"], rank_ms=r["rank_ms"],
                           **{f"{path}_launches": n
                              for path, n in per.items()})
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
