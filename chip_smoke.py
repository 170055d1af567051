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
   the main path's shapes (H=32, H_kv=8, D=128, T=16), bf16 and f32 (K1 at
   each of ``bench_gpu.DECODE_SHAPES``, timed at each beside its bound,
   with GB/s and the split count), with the kernel's, the plain version's
   and a one-call PyTorch yardstick's median device times beside the least
   time the card could take; K3 and K2 also at the serving path's own
   chunk shapes beside SDPA, with TFLOP/s and share of the bound; K4 also
   ``torch.equal`` to 32 K1 launches on the same inputs;
3. model path: Llama-3-8B at full width and depth with random bf16 weights
   (seeded ``torch.Generator``) served through ``InferenceEngine`` and
   ``Scheduler`` for 8 requests (shared prefix, chunked prefill, mixed
   greedy and top-k/top-p sampling), with every kernel's launch count over
   that run, and one greedy decode step held against a cold prefill; then
   a cold 1500-token prefill and a B=8 decode step split by kind of
   kernel under ``torch.profiler``;
4. overhead path: ``bench_gpu.leg_invocation_overhead`` (32 K1 launches in
   a CUDA graph, the same eagerly, one K4 launch, the plain version) and
   what a graph would win back of the decode step profiled in phase 3;
5. store path: the port's own store server in a subprocess; engine A
   prefills a fresh 1500-token prompt into it, engine B (same weights, its
   own connection and cache) adopts the 93 stored chunks and computes only
   the tail; adopted pages bitwise equal to A's, first-token logits close,
   every push band straight into the page-locked shm pool; then the same
   over TCP with int8 pages; push/load rates and TTFT printed;
6. the ``kernels`` line: one JSON object with every kernel's numbers, each
   kernel's launches counted over the path that runs it.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the repo beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import re
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
MODEL_PATH_KERNELS = ("paged_decode", "flash_causal", "flash_prefix")


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


def phase_model(torch, ca, dev, card: str, params, cfg, pc):
    """The PR-1 serving path; returns its launch counts and the decode-step
    profile."""
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
    reused = finished[ids[3]].state.reused_chunks
    check(reused == 512 // pc.block_tokens,
          f"the shared-prefix request reused {reused} chunks, wanted 32")

    ttft = sorted((finished[i].t_first - finished[i].t_submit) * 1e3 for i in ids)
    n_out = sum(len(finished[i].output) for i in ids)
    decode_s = sched.metrics.histogram(
        "istpu_serve_decode_step_seconds").labels().sum
    print(f"[model] {len(ids)} requests, {n_out} tokens in {wall:.3f} s; "
          f"TTFT ms min/median/max = {ttft[0]:.1f}/{statistics.median(ttft):.1f}"
          f"/{ttft[-1]:.1f}; decode {n_out / decode_s:.1f} tok/s aggregate over "
          f"{decode_s:.3f} s of decode chunks ({card})")

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
    prof = phase_profile(torch, engine, [p for p, _n, _kw in reqs])
    return launches, prof


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


def phase_profile(torch, engine, prompts, steps: int = 16) -> dict:
    """Where a cold prefill's and a decode step's time go.  A fresh
    1500-token prompt prefilled bare, then another under ``torch.profiler``
    (device time by kind); the same ``steps``-token ``decode_batch`` at B=8
    timed bare and under the profiler, busy share against the bare wall
    time.  Returns the decode step's ms/step bare and busy and kernels/step
    (empty when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    # a cold prefill of a fresh 1500-token prompt: 512-token chunks, the
    # first through K3, the others through K2
    def fresh(seed):
        return torch.randint(0, engine.cfg.vocab_size, (1500,),
                             generator=torch.Generator().manual_seed(seed)
                             ).tolist()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.release(engine.prefill(fresh(7)))
    torch.cuda.synchronize()
    print(f"[profile] cold prefill of 1500 tokens (3 chunks of 512): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.release(engine.prefill(fresh(9)))
        torch.cuda.synchronize()
    groups, top, n_kernels = _device_time_by_kind(torch, prof)
    busy = sum(groups.values())
    if busy:
        by_kind = {k: round(v, 4) for k, v in sorted(groups.items(),
                                                     key=lambda kv: -kv[1])}
        print(f"[profile] cold prefill of 1500 tokens, device time "
              f"{busy:.3f} ms in {n_kernels} kernels; ms by kind "
              f"{json.dumps(by_kind)}")
        for ms, n, name in sorted(top, reverse=True)[:6]:
            print(f"[profile]   {ms:8.4f} ms  {n:5d}  {name}")
    else:
        print("[profile] the profiler saw no device time in the prefill: "
              "not measured")

    states = [engine.prefill(p) for p in prompts]  # local prefix hits
    engine.decode_batch(states, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_batch(states, steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.decode_batch(states, steps)
        torch.cuda.synchronize()
    for st in states:
        engine.release(st)
    groups, top, n_kernels = _device_time_by_kind(torch, prof)
    top = [(ms / steps, n // steps, name) for ms, n, name in top]
    busy = sum(groups.values())
    if not busy:
        print("[profile] the profiler saw no device time: not measured")
        return {}
    per_step = {k: round(v / steps, 4) for k, v in sorted(
        groups.items(), key=lambda kv: -kv[1])}
    print(f"[profile] decode B={len(states)}: {wall_ms / steps:.3f} ms/step "
          f"bare; device busy {busy / steps:.3f} ms/step "
          f"({100 * busy / wall_ms:.1f}% of the bare wall time); "
          f"{n_kernels / steps:.0f} kernels/step; ms/step by kind "
          f"{json.dumps(per_step)}")
    for ms, n, name in sorted(top, reverse=True)[:8]:
        print(f"[profile]   {ms:8.4f} ms/step  {n:5d}/step  {name}")
    return {"wall_ms": wall_ms / steps, "busy_ms": busy / steps,
            "kernels": n_kernels / steps}


def phase_overhead(torch, ca, bench_gpu, prof: dict) -> dict:
    """The invocation-overhead leg (K4's path), and what a CUDA graph would
    win back of the profiled B=8 decode step.  Returns its launch counts."""
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
    if prof:
        # a graph replays the step's launches without the host: it can win
        # back at most the time the device idles in the eager step
        idle = prof["wall_ms"] - prof["busy_ms"]
        print(f"[overhead] decode B=8 step: {prof['wall_ms']:.3f} ms bare, "
              f"device busy {prof['busy_ms']:.3f} ms, idle {idle:.3f} ms "
              f"({100 * idle / prof['wall_ms']:.1f}%, the most a CUDA graph "
              f"of the step recovers); host time per launch in the step "
              f"{1e3 * prof['wall_ms'] / prof['kernels']:.2f} us over "
              f"{prof['kernels']:.0f} launches, against "
              f"{1e3 * out['invoc_host_ms_per_launch']:.2f} us to issue one "
              f"K1 alone")
    return launches


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
        # warm-up on a short prompt of its own: A's first push page-locks
        # the store's pool mapping and B's first load allocates pinned
        # staging, one-time costs kept out of the timed hop
        warm = torch.randint(0, cfg.vocab_size, (80,), generator=gen).tolist()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.release(a.prefill(warm))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        b.release(b.prefill(warm))
        torch.cuda.synchronize()
        print(f"{tag} warm-up (80 tokens): A's first prefill and push "
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


def phase_store(torch, ca, dev, params, cfg, pc) -> dict:
    """The store hop, shm with full-precision pages, then TCP with int8
    pages; returns the launch counts over both."""
    proc, port = _start_store(prealloc_gib=4,
                              min_alloc_kib=max(16, pc.page_bytes // 1024))
    try:
        ca.reset_launches()
        torch.cuda.synchronize()
        _store_case(torch, dev, params, cfg, pc, port, "shm", None, seed=11)
        _store_case(torch, dev, params, cfg, pc, port, "tcp", "int8", seed=12)
        torch.cuda.synchronize()
        launches = dict(ca.LAUNCHES)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    print(f"[store] launches on the store path: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in MODEL_PATH_KERNELS),
          f"a kernel was not launched on the store path: {launches}")
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
        launches, prof = phase_model(torch, ca, dev, card, params, cfg, pc)
        overhead = phase_overhead(torch, ca, bench_gpu, prof)
        phase_store(torch, ca, dev, params, cfg, pc)
    # each kernel's launches over the path that runs it: K1-K3 the serving
    # path, K4 the overhead path
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
