"""Continuous-batching serving with store-backed prefix reuse (the port's
engine).

Boots an engine on the TINY Llama config (``serve.load_model`` reads a real
checkpoint for production shapes), submits a mix of greedy and sampled
requests to the scheduler, and, when a store server is reachable, shows a
second engine reusing the first one's prefilled KV through the store (the
prefix-reuse deployment the store exists for).

Usage (a store server on 22345, e.g. ``python -m
infinistore_tpu_torch.server --service-port 22345 --manage-port 22346``):

    python -m infinistore_tpu_torch.examples.serving [--service-port 22345]
        [--device cuda|cpu]

``--device`` picks the torch device (``cuda`` by default: the hand-written
kernels; ``cpu`` runs their plain versions).  The model is TINY in float32,
whose greedy answers are token-exact with the reference engine's on the
same weights.  The last line printed is one
JSON object: requests, tokens, seconds, and the second engine's reused
chunks (``null`` without a store).
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None, params=None) -> dict:
    """Parse ``argv`` and serve; ``params``: TINY's float32 weights (the
    port's tree, on ``--device``) in place of those drawn from seed 0."""
    ap = argparse.ArgumentParser("serving")
    ap.add_argument("--service-port", type=int, default=0,
                    help="store server data port (0 = run without a store)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines: 'cuda' or 'cpu'")
    args = ap.parse_args(argv)

    from .. import lib as ist
    from .. import resolve_device

    dev = resolve_device(args.device)
    conn = None
    if args.service_port:
        conn = ist.InfinityConnection(ist.ClientConfig(
            host_addr=args.host, service_port=args.service_port,
            connection_type=ist.TYPE_SHM))
        conn.connect()
    try:
        return _run(dev, conn, params)
    finally:
        if conn is not None:
            conn.close()


def _run(dev, conn, params) -> dict:
    import torch

    from ..engine import InferenceEngine, Scheduler
    from ..kv import PagedCacheConfig
    from ..models import TINY, init_params, scaled

    cfg = scaled(TINY, dtype=torch.float32)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    pc = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, block_tokens=16, n_blocks=256,
        dtype=cfg.dtype,
    )
    engine = InferenceEngine(params, cfg, pc, conn=conn, prefill_chunk=64,
                             device=dev)
    sched = Scheduler(engine, max_batch=4)

    prompts = {
        "a": list(range(1, 40)),
        "b": list(range(1, 12)),
        "c": [7, 99, 404, 42],
    }
    ids = {}
    for name, p in prompts.items():
        ids[name] = sched.submit(p, 32)
    ids["sampled"] = sched.submit(
        prompts["a"], 32, sample="categorical", temperature=0.8, top_k=40)
    # streamed request: tokens arrive at every decode-chunk boundary
    streamed: list = []
    ids["streamed"] = sched.submit(
        prompts["b"], 16,
        on_token=lambda toks, done: streamed.append((len(toks), done)))

    t0 = time.time()
    out = sched.run()
    dt = time.time() - t0
    n_tok = sum(len(v) for v in out.values())
    print(f"{len(out)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s aggregate)")
    for name, rid in ids.items():
        print(f"  {name:8s} -> {out[rid][:8]}...")
    print(f"  streamed deliveries (n_tokens, done): {streamed}")

    reused = None
    if conn is not None:
        engine.store_flush()
        eng2 = InferenceEngine(params, cfg, pc, conn=conn, device=dev)
        st = eng2.prefill(prompts["a"])
        reused = st.reused_chunks
        print(f"second engine reused {reused} stored chunks of prompt 'a' "
              f"from the store")
        eng2.release(st)
        for e in (engine, eng2):
            e.transfer.close()
    summary = {"requests": len(out), "tokens": n_tok,
               "seconds": round(dt, 4),
               "outputs": {name: out[rid] for name, rid in ids.items()},
               "streamed": streamed, "reused_chunks": reused}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
