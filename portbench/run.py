#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout on a machine with the cell's cards.  The
cell, its configuration, traffic mix, limits and metrics are found by name
from ``BENCHMARK.json`` (``core.py`` says what a run does).  The last line
of standard output is the result object; the last lines of standard error
give each number the check compared, beside its limit.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.

Two more modes share the set-up and are not part of a run:

* ``--sweep r1,r2,...``: one window per session rate (open-loop cells),
  printing offered and finished turns per second, the TTFT and TPOT tails
  and the scheduler's queue over the window: the sweep that finds a
  cell's knee;
* ``--calibrate s1,s2,...``: for each seed, weights drawn anew in place,
  one window, and the logit gap of the program's served tokens beside the
  gap of the reference's float8 control on the same sample: the readings
  a cell's limit is set from.

Exits non-zero, printing no result, without the cards the cell asks for,
and when a module of JAX or of the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _finite(x):
    """JSON has no NaN or infinity: such a number prints as null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def _env() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into ``build/`` beside it)."""
    cache = os.path.join(ROOT, "build", "portbench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def _sweep(args, spec) -> None:
    import time

    from portbench import core, stats

    lg = core.LoadGen()
    try:
        _params, server, _ = core.setup(spec, args.seed, "cuda", lg)
        for rate in [float(r) for r in args.sweep.split(",")]:
            mix = {**spec["mix"], "session_rate": rate}
            w = core.serve_window(server, lg, spec, args.seed, args.seconds,
                                  False, True, mix=mix)
            rows = [r for r in w["reply"]["rows"]
                    if w["t0"] <= r["due"] < w["t_close"]]
            done = [r for r in rows if r["ok"] and r["last"] <= w["t_close"]]
            ttft = [stats.ttft_s(r) for r in rows]
            tpot = [t for t in map(stats.tpot_s, done) if t is not None]
            third = args.seconds / 3
            late = [stats.ttft_s(r) for r in rows
                    if r["due"] >= w["t_close"] - third]
            mid = [stats.ttft_s(r) for r in rows
                   if w["t0"] + third <= r["due"] < w["t_close"] - third]
            print(json.dumps(_finite({
                "session_rate": rate,
                "turns_offered_per_s": len(rows) / args.seconds,
                "turns_finished_in_window_per_s": len(done) / args.seconds,
                "failed": sum(1 for r in rows if not r["ok"]),
                "ttft_p50_ms": 1e3 * stats.percentile(ttft, 0.5),
                "ttft_p95_ms": 1e3 * stats.percentile(ttft, 0.95),
                "ttft_p50_mid_third_ms": 1e3 * (stats.percentile(mid, 0.5)
                                                or math.nan),
                "ttft_p50_last_third_ms": 1e3 * (stats.percentile(late, 0.5)
                                                 or math.nan),
                "tpot_p95_ms": 1e3 * (stats.percentile(tpot, 0.95)
                                      or math.nan),
                "queue": [[round(t - w["t0"], 1), n]
                          for t, n in w["backlog"]][::4],
                "at": time.time()})), flush=True)
        core.free_server(server)
    finally:
        lg.close()


def _calibrate(args, spec) -> None:
    import importlib

    import torch

    from portbench import check, core

    seeds = [int(s) for s in args.calibrate.split(",")]
    fam = importlib.import_module("portbench.families."
                                  + spec["config"]["family"])
    lg = core.LoadGen()
    try:
        params, server, _ = core.setup(spec, seeds[0], "cuda", lg)
        V = spec["config"]["config"]["vocab_size"]
        opts = {**core.DEFAULTS, **spec["mix"].get("harness", {})}
        for seed in seeds:
            fam.draw(spec["config"]["config"], seed, "cuda", into=params)
            if spec["mix"]["loop"] == "open_sessions":
                lg.run(host="127.0.0.1", port=server.port, mix=spec["mix"],
                       seed=seed, vocab=V, t0=0.0, window_s=1.0,
                       drain_s=opts["drain_s"], system_only=True)
            w = core.serve_window(server, lg, spec, seed, args.seconds,
                                  False, True)
            run = core.Run(rows=w["reply"]["rows"], t_open=w["t0"],
                           t_close=w["t_close"])
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # the engine's cache stays: room
            g = check.gaps(run, params, spec, seed, fp8=True)
            rows = run.window_rows()
            print(json.dumps(_finite({
                "seed": seed, "program": g["program"],
                "control": g["control"], "requests": g["requests"],
                "tokens": g["tokens"], "per_request": g["per_request"],
                "attempted": len(rows),
                "failed": sum(1 for r in rows if not r["ok"])})), flush=True)
        core.free_server(server)
    finally:
        lg.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default=None)
    ap.add_argument("--calibrate", default=None)
    args = ap.parse_args(argv)
    _env()

    import torch

    from portbench import core

    spec = core.cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.sweep:
        _sweep(args, spec)
        return 0
    if args.calibrate:
        _calibrate(args, spec)
        return 0
    out = core.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), spec=spec)
    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    result = out["result"]
    print(f"[info] {json.dumps(out['info'])}", file=sys.stderr)
    for name, c in result["checked"].items():
        print(f"[check] {name} {c['value']} (limit {c['pass']} "
              f"{c['limit']})", file=sys.stderr)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
