"""Long-context serving: sequence-parallel prompt ingestion, paged decode
(the port's engine).

ONE long prompt is ingested by sequence parallelism: the prompt shards
over an ``sp`` axis and attention runs as ring attention (per-rank
attention memory O((S/sp)^2), FLOPs spread over the group); the KV is then
handed to a paged engine for decode:

1. ``parallel.sharding.make_sp_prefill``: the sp x tp prefill, one
   process per rank of a ``torch.distributed`` world, returning logits and
   KV in the engine's exact cache contract;
2. ``InferenceEngine.adopt_prefill``: the public ingestion point, paging
   the external KV into the engine's cache and returning a decode-ready
   state;
3. plain paged decode, held against the engine's own prefill and decode of
   the same prompt.

This process spawns the ``sp * tp`` ranks (start method ``spawn``, a
``FileStore`` rendezvous in a temporary directory, gloo, so that ranks may
share one card or the CPU) and runs steps 2-3 on rank 0's outputs.  The
model is TINY in float32, which keeps the adopted decode token-exact.

    python -m infinistore_tpu_torch.examples.long_context --seq 512 \\
        --sp 2 --tp 2 [--device cuda|cpu]

The last line printed is one JSON object: the shape, the prefill's wall
ms on rank 0, the decoded tokens and whether they match.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

WORLD_TIMEOUT_S = 300.0
BLOCK_TOKENS = 16


def _cfg():
    import torch

    from ..models import TINY, scaled

    return scaled(TINY, dtype=torch.float32)


def _params(cfg, dev, weights=None):
    """The whole model on ``dev``: the one saved at ``weights``, else drawn
    from a generator seeded 0, so that every rank and the decode engine
    hold the same one."""
    import torch

    from ..models import init_params

    if weights is not None:
        return torch.load(weights, map_location=dev, weights_only=True)
    return init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def _prompt(args, vocab: int):
    import numpy as np

    S = args.seq - args.seq % (args.sp * BLOCK_TOKENS)  # whole pages a shard
    return [int(x) for x in
            np.random.RandomState(1).randint(1, vocab, size=S)]


def _device(torch, args, rank: int):
    if args.device == "cpu":
        return torch.device("cpu")
    torch.cuda.set_device(rank % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def _rank(rank: int, world: int, init_file: str, args, out_dir: str,
          weights) -> None:
    """One rank: join the world, prefill the prompt over the sp x tp mesh
    (this rank's tp shard of the weights) and, on rank 0, save the whole
    logits and KV with the prefill's wall time."""
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        import torch

        from ..parallel import MeshShape, initialize, make_mesh
        from ..parallel.sharding import (llama_inference_specs,
                                         make_sp_prefill, shard_params)

        if args.device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = _device(torch, args, rank)
        initialize(init_method=f"file://{init_file}", world_size=world,
                   rank=rank, backend="gloo")
        cfg = _cfg()
        params = _params(cfg, dev, weights)
        prompt = _prompt(args, cfg.vocab_size)
        mesh = make_mesh(MeshShape(sp=args.sp, tp=args.tp))
        sharded = shard_params(params, mesh,
                               specs=llama_inference_specs(cfg=cfg))
        fn = make_sp_prefill(cfg, mesh)
        toks = torch.tensor([prompt], device=dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, kv = fn(sharded, toks)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
        res = {"ms": ms}
        if rank == 0:
            res.update(logits=logits.cpu(), kv=kv.cpu())
        res = ("ok", res)
    except Exception:  # noqa: BLE001 — the parent raises with it
        res = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(res, f)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _world(args, params=None) -> list:
    """Every rank's result, in rank order; a failed rank raises with its
    traceback, and no rank outlives the call.  ``params``: the whole model
    every rank loads (else each draws it)."""
    import multiprocessing as mp

    world = args.sp * args.tp
    tmp = tempfile.mkdtemp(prefix="istpu-long-context-")
    try:
        weights = None
        if params is not None:
            import torch

            weights = os.path.join(tmp, "weights.pt")
            torch.save(params, weights)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(
            r, world, os.path.join(tmp, "store"), args, tmp, weights))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        out = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited {procs[r].exitcode} "
                                   f"with no result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            out.append(value)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(argv=None, params=None) -> dict:
    """Parse ``argv``, run the three steps and return rank 0's ``logits``
    and ``kv`` (on the CPU), the ``prompt``, the ``tokens`` decoded from
    the adopted KV, the engine's own (``want``) and ``prefill_ms``.

    ``params``: TINY's float32 weights to run (the port's tree, on
    ``--device``), in place of those drawn from seed 0."""
    ap = argparse.ArgumentParser("long_context")
    ap.add_argument("--seq", type=int, default=512,
                    help="prompt length (cut to whole pages on every shard)")
    ap.add_argument("--sp", type=int, default=2)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (rank r on card r %% cards) or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..engine import InferenceEngine
    from ..kv import PagedCacheConfig

    dev = resolve_device(args.device)
    res = _world(args, params)
    r0 = res[0]
    cfg = _cfg()
    if params is None:
        params = _params(cfg, dev)
    prompt = _prompt(args, cfg.vocab_size)
    S = len(prompt)
    print(f"sp={args.sp} x tp={args.tp} prefill of {S} tokens: "
          f"{r0['ms']:.1f} ms on rank 0 (per-rank attention window "
          f"{S // args.sp} positions)")

    def engine():
        return InferenceEngine(params, cfg, PagedCacheConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, block_tokens=BLOCK_TOKENS,
            n_blocks=S // BLOCK_TOKENS + args.new_tokens // BLOCK_TOKENS + 8,
            dtype=cfg.dtype), kv_quant=None, device=dev)

    eng = engine()
    st = eng.adopt_prefill(prompt, r0["kv"].to(dev), r0["logits"][0, -1])
    toks = eng.decode(st, args.new_tokens)
    eng.release(st)
    print(f"decoded {len(toks)} tokens from the adopted KV: {toks[:8]}...")

    # the sanity check: identical to prefilling inside the engine
    ref = engine()
    rst = ref.prefill(prompt)
    want = ref.decode(rst, args.new_tokens)
    ref.release(rst)
    matches = toks == want
    print("matches the engine's own prefill+decode exactly" if matches
          else f"DIVERGED from the engine's own prefill+decode: {want[:8]}")
    print(json.dumps({"sp": args.sp, "tp": args.tp, "seq": S,
                      "device": str(dev), "prefill_ms": round(r0["ms"], 3),
                      "tokens": toks, "matches": matches}))
    return {"prompt": prompt, "logits": r0["logits"], "kv": r0["kv"],
            "tokens": toks, "want": want, "prefill_ms": r0["ms"],
            "params": params, "cfg": cfg}


if __name__ == "__main__":
    out = run()
    sys.exit(0 if out["tokens"] == out["want"] else 1)
