"""Spawned ``torch.distributed`` worlds for the port's tensor-parallel tests.

``run_world(target, world, tmp_path, *args, **kw)`` starts ``world`` processes
(start method ``spawn``), each joining a gloo group through a ``FileStore``
under ``tmp_path`` and then calling ``target(rank, world, *args, **kw)``; it
returns every rank's result in rank order.  A rank that raises fails the
call with that rank's traceback; a world that outlives ``timeout`` has its
ranks killed and fails the call.  Each rank runs one intra-op thread, so a
world adds little host load.  The targets live in modules that import
torch and the port only (never jax): the children import nothing else.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import traceback

JOIN_TIMEOUT_S = 120.0


def _entry(rank, world, init_file, backend, target, args, kw, out_dir):
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        import torch

        torch.set_num_threads(1)
        from infinistore_tpu_torch.parallel import initialize

        initialize(init_method=f"file://{init_file}", world_size=world,
                   rank=rank, backend=backend, timeout_s=60)
        result = ("ok", target(rank, world, *args, **kw))
    except BaseException:  # noqa: BLE001 — reported to the parent
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    try:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — the result is already written
        pass


def run_world(target, world: int, tmp_path, *args, backend: str = "gloo",
              timeout: float = JOIN_TIMEOUT_S, dies=(), **kw):
    """Every rank's ``target(rank, world, *args, **kw)`` in rank order;
    the ranks in ``dies`` are killed by the test and give None."""
    tmp = str(tmp_path)
    init_file = os.path.join(tmp, "tp_world_store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(
        r, world, init_file, backend, target, args, kw, tmp), daemon=True)
        for r in range(world)]
    for p in procs:
        p.start()
    import time

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"ranks {alive} of a {world}-rank world "
                               f"still running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if r in dies:
            results.append(None)
            continue
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} exited {procs[r].exitcode} with "
                               f"no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        results.append(value)
    return results
