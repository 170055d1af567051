"""PD-disaggregation, prefill node (the port's engine).

The deployment the store exists for: a prefill pool computes KV once, a
decode pool consumes it.  THIS process owns prompt ingestion.  It prefills
the prompt on its own engine and the paged KV streams to the store
chunk-by-chunk, flushed before exit — nothing else is handed to the decode
node; discovery happens through the store's prefix index
(``get_match_last_index``).

Run a store server first, then:

    python -m infinistore_tpu_torch.examples.disagg_prefill \\
        --service-port 22345 --prompt 11,42,7,99,5,3,17,28,64,1,2

The decode node (``disagg_decode``) may run on another host pointed at the
same store (TCP transport).  ``--device`` picks the torch device (``cuda``
by default; ``cpu`` runs the kernels' plain versions).

Prints one JSON line: {"model_id", "n_tokens", "chunks_stored"}.
"""

from __future__ import annotations

import argparse
import json


def build_engine(args, conn):
    """Both nodes must run the SAME model; the demo uses the port's
    random-init TINY config drawn from a generator seeded 0 on the device,
    as a stand-in for loading one shared checkpoint on each node."""
    import torch

    from .. import resolve_device
    from ..engine import InferenceEngine
    from ..kv import PagedCacheConfig
    from ..models import TINY, init_params, scaled

    dev = resolve_device(args.device)
    cfg = scaled(TINY, dtype=getattr(torch, args.dtype))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pc = PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, block_tokens=args.block_tokens, n_blocks=256,
        dtype=cfg.dtype,
    )
    return InferenceEngine(params, cfg, pc, conn=conn,
                           model_id=args.model_id,
                           kv_quant=(None if args.kv_quant == "none"
                                     else args.kv_quant),
                           device=dev)


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--service-port", type=int, required=True)
    ap.add_argument("--connection", choices=["tcp", "shm"], default="tcp",
                    help="tcp = the cross-host transport; shm = "
                         "zero-copy, same host only")
    ap.add_argument("--prompt", required=True,
                    help="comma-separated token ids")
    ap.add_argument("--model-id", default="disagg-demo",
                    help="store key namespace; must match on both nodes")
    ap.add_argument("--block-tokens", type=int, default=4)
    ap.add_argument("--dtype", default="float32",
                    help="float32 keeps the two nodes bit-identical")
    ap.add_argument("--kv-quant", choices=["int8", "none"], default="none",
                    help="store-hop page format.  This demo defaults to "
                         "'none' (lossless) because its verification "
                         "recipe is decode-node tokens == monolithic "
                         "decode, which int8 noise can break; the library "
                         "default is int8 (half the transfer bytes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine: 'cuda' (the "
                         "hand-written kernels) or 'cpu' (their plain "
                         "versions)")


def connect(args):
    from .. import lib as ist

    conn = ist.InfinityConnection(ist.ClientConfig(
        host_addr=args.host, service_port=args.service_port,
        connection_type=(ist.TYPE_TCP if args.connection == "tcp"
                         else ist.TYPE_SHM),
    ))
    conn.connect()
    return conn


def main() -> None:
    ap = argparse.ArgumentParser("disagg_prefill")
    add_common_args(ap)
    args = ap.parse_args()
    prompt = [int(t) for t in args.prompt.split(",")]

    conn = connect(args)
    eng = build_engine(args, conn)
    st = eng.prefill(prompt)  # KV streams to the store chunk by chunk
    # durability barrier before signaling hand-off: a no-op under the
    # default strict mode, the REQUIRED join under store_durability=
    # "relaxed" (decode nodes may only be pointed at flushed prefixes)
    eng.store_flush()
    print(json.dumps({
        "model_id": args.model_id,
        "n_tokens": len(st.tokens),
        "chunks_stored": len(prompt) // args.block_tokens,
    }))
    eng.release(st)
    eng.transfer.close()
    conn.close()


if __name__ == "__main__":
    main()
