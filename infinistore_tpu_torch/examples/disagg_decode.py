"""PD-disaggregation, decode node (the port's engine).

Counterpart of ``disagg_prefill``: THIS process never computes the
prompt's KV.  Its engine's prefill discovers the stored prefix through the
store's index (``get_match_last_index`` under
``KVTransferEngine.lookup_prefix``), pulls those pages over the transport
into its own paged cache, computes only the sub-chunk tail, and decodes.

    python -m infinistore_tpu_torch.examples.disagg_decode \\
        --service-port 22345 --prompt 11,42,7,99,5,3,17,28,64,1,2 --steps 8

Prints one JSON line: {"reused_chunks", "tokens"} — ``reused_chunks`` > 0
is the proof the prompt's KV came from the prefill node, not recompute;
``tokens`` must equal the same model's monolithic decode.
"""

from __future__ import annotations

import argparse
import json

from .disagg_prefill import add_common_args, build_engine, connect


def main() -> None:
    ap = argparse.ArgumentParser("disagg_decode")
    add_common_args(ap)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    prompt = [int(t) for t in args.prompt.split(",")]

    conn = connect(args)
    eng = build_engine(args, conn)
    st = eng.prefill(prompt)  # pulls the prefill node's pages from the store
    toks = eng.decode(st, args.steps)
    print(json.dumps({
        "reused_chunks": st.reused_chunks,
        "tokens": toks,
    }))
    eng.release(st)
    eng.transfer.close()
    conn.close()


if __name__ == "__main__":
    main()
