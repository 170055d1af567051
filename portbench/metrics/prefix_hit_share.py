"""prefix_hit_share (engine prefix cache): prompt tokens served from cached
pages (the ledger's ``reused_chunks`` x ``block_tokens``) over all prompt
tokens of the requests due in the window, in percent."""

from portbench.reduce import share


def read(run):
    rows = run.ledger_rows()
    hit = sum(r["store"]["reused_chunks"] for r in rows) * run.block_tokens
    return share(hit, sum(r["prompt_tokens"] for r in rows)) or None
