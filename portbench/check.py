"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the greedy requests that finished in the window, drawn from the seed with
the longest among them, is run through the reference
(``reference/<family>.py``, float32, TF32 off) once each over its prompt
and served tokens.  At each served token the reference's best logit minus
its logit for the served token is the gap; the widest gap over the sample
is compared with the cell's limit (``checks/<cell>.json``), or, where that
file names it, the mean gap or the share of served tokens that are not the
reference's best.  Beside it: the
answers that ended with the wrong number of tokens (limit 0) and how many
tokens the sample checked (at least the limit's minimum).

``control_gap`` reads the same sample with the reference's float8 control
in the program's place: at each position the token the control puts first,
its gap on the float32 reference.
"""

from __future__ import annotations

import importlib
import random
import sys
from typing import Any, Dict, List, Tuple

import torch


def sample(rows: List[dict], seed: int, want_tokens: int) -> List[dict]:
    """The longest finished greedy request, then others in an order drawn
    from ``seed``, until the sample holds ``want_tokens`` served tokens."""
    cands = sorted((r for r in rows if r["greedy"] and r["ok"]),
                   key=lambda r: (-(r["prompt_len"] + r["n_tokens"]),
                                  r["trace_id"]))
    if not cands:
        return []
    rest = cands[1:]
    random.Random(seed).shuffle(rest)
    out, n = [], 0
    for r in [cands[0]] + rest:
        if n >= want_tokens:
            break
        out.append(r)
        n += r["n_tokens"]
    return out


def _gaps(ref, params, cfg, row, fp8: bool):
    """Per served token of one request: the reference's best logit minus
    its logit for the served token, and (with ``fp8``) minus its logit for
    the control's first choice at that position."""
    P, out = row["prompt_len"], row["output"]
    seq = row["prompt"] + out[:-1]
    rows = list(range(P - 1, P - 1 + len(out)))
    want = ref.logits_at(params, cfg, seq, rows)
    best = want.max(dim=-1).values
    served = want.gather(1, torch.as_tensor(out, device=want.device)[:, None])
    g = (best - served[:, 0]).cpu()
    c = None
    if fp8:
        lower = ref.logits_at(params, cfg, seq, rows, fp8=True)
        pick = lower.argmax(dim=-1, keepdim=True)
        c = (best - want.gather(1, pick)[:, 0]).cpu()
    return g, c


def summary(g: torch.Tensor) -> Dict[str, float]:
    """The numbers a sample's per-token gaps give: the widest, the mean,
    and the share of positions whose token is not the reference's best."""
    if g is None or g.numel() == 0:
        return {"logit_gap": float("nan"), "logit_gap_mean": float("nan"),
                "argmax_miss_share": float("nan")}
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean()),
            "argmax_miss_share": float((g > 0).float().mean())}


def gaps(run, params, spec, seed: int, fp8: bool = False) -> Dict[str, Any]:
    lim = spec["limits"]
    picked = sample(run.window_rows(), seed, lim["check_tokens"])
    ref = importlib.import_module("portbench.reference."
                                  + spec["config"]["family"])
    per = [_gaps(ref, params, spec["config"]["config"], r, fp8)
           for r in picked]
    cat = (lambda xs: torch.cat(xs) if xs else None)
    return {"requests": len(picked),
            "tokens": sum(r["n_tokens"] for r in picked),
            "program": summary(cat([g for g, _ in per])),
            "control": summary(cat([c for _, c in per]) if fp8 else None),
            "per_request": [[r["prompt_len"], r["n_tokens"],
                             float(g.max()), float(g.mean())]
                            for r, (g, _) in zip(picked, per)]}


def check(run, params, spec, seed: int) -> Tuple[bool, Dict[str, Any]]:
    """``correct`` and each compared number beside its limit."""
    lim = spec["limits"]
    g = gaps(run, params, spec, seed)
    wrong = sum(1 for r in run.window_rows()
                if r.get("done") and r["n_tokens"] != r["max_tokens"])
    checked = {name: {"value": g["program"][name], "limit": limit,
                      "pass": "<="}
               for name, limit in lim["compare"].items()}
    checked.update({
        "wrong_length_answers": {"value": wrong, "limit": 0, "pass": "<="},
        "checked_tokens": {"value": g["tokens"],
                           "limit": lim["min_checked_tokens"], "pass": ">="},
    })
    ok = all((v["value"] <= v["limit"]) if v["pass"] == "<="
             else (v["value"] >= v["limit"]) for v in checked.values())
    print(f"[check] sample (prompt, tokens, widest gap, mean gap): "
          f"{g['per_request']}",
          file=sys.stderr)
    return ok, checked
