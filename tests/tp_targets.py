"""What each rank of a spawned tensor-parallel world runs in the port's tests
(``tests/tp_world.py`` starts the worlds).  Torch and the port only: the
ranks never import jax.  The tests compute the JAX side in their own
process and hand the ranks numpy arrays and port configs."""

from __future__ import annotations

import numpy as np
import torch


def _mesh(world: int, mesh_kw=None):
    from infinistore_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    mesh_kw = dict(mesh_kw or {"tp": world})
    if mesh_kw.pop("hybrid", False):
        return make_hybrid_mesh(**mesh_kw)
    return make_mesh(**mesh_kw)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# ---- the sharded forwards and the compositions ----

def forward_shard(rank, world, tree, cfg, kind, inputs):
    """One rank of ``make_tp_prefill`` / ``make_tp_decode`` on its shard of
    the reference's weights: (logits, KV or cache shard) as numpy."""
    from infinistore_tpu_torch.kv import PagedCacheConfig, init_cache
    from infinistore_tpu_torch.models import params_from_jax
    from infinistore_tpu_torch.parallel import (make_tp_decode,
                                                make_tp_prefill)

    mesh = _mesh(world)
    params = params_from_jax(tree, cfg, "cpu", tp_rank=rank, tp=world)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}
    if kind == "prefill":
        logits, kv = make_tp_prefill(cfg, mesh)(params, t["tokens"])
        return _np(logits), _np(kv)
    pc = PagedCacheConfig(n_layers=cfg.n_layers,
                          n_kv_heads=cfg.n_kv_heads // world,
                          head_dim=cfg.head_dim, n_blocks=inputs["n_blocks"],
                          block_tokens=inputs["block_tokens"],
                          dtype=cfg.dtype)
    logits, cache = make_tp_decode(cfg, mesh)(
        params, t["tokens"], t["positions"], init_cache(pc, "cpu"),
        t["table"], t["seq_lens"], t["slot_blocks"], t["slots"])
    return _np(logits), _np(cache)


def _head_shard(x: np.ndarray, axis: int, rank: int, world: int):
    n = x.shape[axis] // world
    return torch.from_numpy(np.ascontiguousarray(
        np.take(x, range(rank * n, (rank + 1) * n), axis=axis)))


def composition_shard(rank, world, kind, arrays, kw):
    """One rank's output shard of a tensor-parallel composition on its
    head shard of the whole inputs."""
    from infinistore_tpu_torch.models import attention as A

    if kind == "decode":
        q = _head_shard(arrays["q"], 1, rank, world)
        cache = _head_shard(arrays["cache"], 1, rank, world)
        out = A.paged_decode_attention_tp(
            q, cache, torch.from_numpy(arrays["table"]),
            torch.from_numpy(arrays["lens"]), world,
            n_heads=arrays["q"].shape[1],
            n_kv_heads=arrays["cache"].shape[1])
        return _np(out)
    q = _head_shard(arrays["q"], 2, rank, world)
    k = _head_shard(arrays["k"], 2, rank, world)
    v = _head_shard(arrays["v"], 2, rank, world)
    out = A.flash_causal_attention_tp(
        q, k, v, world, n_heads=arrays["q"].shape[2],
        n_kv_heads=arrays["k"].shape[2], **kw)
    return _np(out)


# ---- engines ----

_SPY = {"flash_causal_attention_tp": 0, "paged_decode_attention_tp": 0}


def _install_spies() -> None:
    from infinistore_tpu_torch.models import attention as A

    for name in _SPY:
        orig = getattr(A, name)

        def spy(*a, _orig=orig, _name=name, **k):
            _SPY[_name] += 1
            return _orig(*a, **k)

        setattr(A, name, spy)


def engine_world(rank, world, tree, cfg, pc, script, engine_kw=None,
                 mesh_kw=None, store=None, spy=False, script_kw=None,
                 device="cpu"):
    """Build this rank's engine of a tensor-parallel group over the
    reference's weights (``tree``, numpy; each rank shards the whole
    model); the group's leader runs ``script(engine, **script_kw)`` and
    returns its result with every rank's report, the others follow.
    ``store``: (port, transport, model_id) of a store server the leader
    connects to."""
    import os

    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import params_from_jax

    if spy:
        _install_spies()
    mesh = _mesh(world, mesh_kw)
    conn = None
    kw = dict(engine_kw or {})
    tp_rank = mesh.get_local_rank("tp")
    if store is not None and tp_rank == 0:
        conn = connect(*store[:2])
        kw["model_id"] = store[2]
        kw.setdefault("store_durability", "strict")
    params = params_from_jax(tree, cfg, device)
    eng = InferenceEngine(params, cfg, pc, conn=conn, mesh=mesh,
                          device=device, **kw)
    if tp_rank != 0:
        eng.follow()
        return {"follower": eng.rank_report(), "spy": dict(_SPY),
                "pid": os.getpid()}
    try:
        out = script(eng, **(script_kw or {}))
        out["reports"] = eng.tp_report()
        out["spy"] = dict(_SPY)
        return out
    finally:
        eng.shutdown_followers()
        if conn is not None:
            conn.close()


def connect(port, transport: str):
    """A connected client of the port (its Python runtime), or a
    ``RoutedStorePool`` over a list of ``host:port`` endpoints."""
    os_env = __import__("os").environ
    os_env["ISTPU_CLIENT"] = "python"
    from infinistore_tpu_torch import config as tconfig
    from infinistore_tpu_torch import lib as tlib

    if isinstance(port, list):
        from infinistore_tpu_torch.cluster import RoutedStorePool

        return RoutedStorePool(port, connection_type=transport.upper())

    conn = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="warning",
        connection_type=(tconfig.TYPE_SHM if transport == "shm"
                         else tconfig.TYPE_TCP)))
    conn.connect()
    return conn


# ---- leader scripts ----

def decode(eng, prompt, n_steps, batch=None, n_batch=8):
    """Greedy tokens of ``prompt``, then a lockstep batch of ``batch``'s
    prompts."""
    st = eng.prefill(prompt)
    out = {"tokens": eng.decode(st, n_steps), "reused": st.reused_chunks}
    if batch:
        states = [eng.prefill(p) for p in batch]
        out["batch"] = eng.decode_batch(states, n_batch)
    return out


def prefill_logits(eng, prompt, n_steps):
    """The prefill's last-token logits, then greedy tokens."""
    st = eng.prefill(prompt)
    logits = _np(st.last_logits)
    return {"logits": logits, "tokens": eng.decode(st, n_steps)}


def sampled(eng, prompt, n_steps):
    """Greedy, seeded-sampled and unseeded-sampled tokens."""
    out = {"greedy": eng.decode(eng.prefill(prompt), n_steps)}
    states = [eng.prefill(prompt), eng.prefill(prompt[:5])]
    out["seeded"] = eng.decode_batch(
        states, n_steps, sample="categorical", temperature=0.9, top_k=40,
        top_p=0.9, seed=[7, 8])
    out["penalized"] = eng.decode(eng.prefill(prompt), n_steps,
                                  sample="categorical", temperature=1.0,
                                  presence_penalty=0.5, seed=3)
    return out


def every_route(eng, prompt, n_steps, adopt_kv, adopt_logits):
    """The engine methods that launch model compute, each run through the
    leader's ops, beside the ones that raise under tensor parallelism."""
    out = {}
    st = eng.prefill(prompt)
    out["decode"] = eng.decode(st, n_steps)
    states = eng.prefill_batch([prompt[:9], prompt[1:10], prompt[:4]])
    out["batch"] = eng.decode_batch(states, n_steps)
    out["prompt_logprobs"] = eng.prompt_logprobs(prompt[:9], k=2)
    ad = eng.adopt_prefill(prompt[:7], torch.from_numpy(adopt_kv),
                           torch.from_numpy(adopt_logits))
    out["adopted"] = eng.decode(ad, n_steps)
    pp = eng.prefill_start(prompt)
    eng.abandon_prefill(pp)
    from infinistore_tpu_torch.engine.ngram import NgramSpeculator
    from infinistore_tpu_torch.engine.speculative import SpeculativeDecoder

    raised = {}
    for name, call in (
        ("verify", lambda: eng.verify(st, [1, 2], len(st.tokens))),
        ("propose", lambda: eng.propose(st, 2)),
        ("draft", lambda: SpeculativeDecoder(eng, eng, 2)),
        ("ngram", lambda: NgramSpeculator(eng, 2)),
    ):
        try:
            call()
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    out["raised"] = raised
    # nothing left on a follower after the abandon
    return out


def push_prompt(eng, prompt, n_steps):
    """Prefill ``prompt`` into the store (strict durability), decode."""
    st = eng.prefill(prompt)
    eng.store_flush()
    return {"reused": st.reused_chunks,
            "tokens": eng.decode(st, n_steps),
            "pages": _np(eng.transfer.gather_pages(
                eng.cache, st.block_ids[:len(prompt) // eng.pc.block_tokens]))
            if eng.transfer.quant is None else eng.transfer.gather_pages(
                eng.cache, st.block_ids[:len(prompt) // eng.pc.block_tokens]
            ).numpy()}


def push_and_pages(eng, prompt):
    """Prefill ``prompt`` into the store; return its complete chunks'
    whole pages gathered over the ranks ([L, 2, H_kv, n, T, D]) and the
    payload a push of them packs (``transfer.gather_pages``)."""
    st = eng.prefill(prompt)
    eng.store_flush()
    ids = st.block_ids[:len(prompt) // eng.pc.block_tokens]
    packed = eng.transfer.gather_pages(eng.cache, ids)
    return {"pages": _np(eng._op("gather_pages", ids)),
            "packed": packed.numpy() if packed.dtype == torch.uint8
            else _np(packed)}


def adopt_prompt(eng, prompt, n_steps):
    """Adopt ``prompt``'s stored prefix, return the adopted pages gathered
    over the ranks (whole, [L, 2, H_kv, n, T, D]) and greedy tokens."""
    st = eng.prefill(prompt)
    n = st.store_chunks
    pages = eng._op("gather_pages", st.block_ids[:n])
    return {"reused": st.reused_chunks, "store": n, "pages": _np(pages),
            "tokens": eng.decode(st, n_steps)}


def die_then_step(eng, prompt, n_steps, follower_pid):
    """Kill the follower, then time how long the next step takes to
    raise."""
    import os
    import signal
    import time

    st = eng.prefill(prompt)
    eng.decode(st, 2)
    os.kill(follower_pid, signal.SIGKILL)
    time.sleep(0.5)
    t0 = time.perf_counter()
    try:
        eng.decode(st, n_steps)
    except Exception as e:  # noqa: BLE001 — the test reads what raised
        return {"raised": type(e).__name__,
                "seconds": time.perf_counter() - t0}
    return {"raised": None, "seconds": time.perf_counter() - t0}


def follower_pid_world(rank, world, tree, cfg, pc, prompt, n_steps):
    """A 2-rank group whose follower publishes its pid through the
    process group before following; the leader kills it mid-serving."""
    import os

    import torch.distributed as dist

    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import params_from_jax

    mesh = _mesh(world)
    pids = [None] * world
    dist.all_gather_object(pids, os.getpid())
    eng = InferenceEngine(params_from_jax(tree, cfg, "cpu"), cfg, pc,
                          mesh=mesh, device="cpu", kv_quant=None)
    if rank != 0:
        eng.follow()
        return None
    return die_then_step(eng, prompt, n_steps, pids[1])


def capture_under_gloo(rank, world, tree, cfg, pc):
    """A gloo group refuses to capture a CUDA graph."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import params_from_jax

    mesh = _mesh(world)
    eng = InferenceEngine(params_from_jax(tree, cfg, "cpu"), cfg, pc,
                          mesh=mesh, device="cpu", kv_quant=None)
    try:
        eng._capture_graph(None, lambda: None, "decode_step", "decode")
    except RuntimeError as e:
        return str(e)
    return None


def hybrid_mesh(rank, world, kw):
    """The hybrid mesh's shape, and sums over its groups."""
    import torch.distributed as dist

    mesh = _mesh(world, {"hybrid": True, **kw})
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    x = torch.tensor([float(rank)])
    tp = x.clone()
    dist.all_reduce(tp, group=mesh.get_group("tp"))
    dp = x.clone()
    dist.all_reduce(dp, group=mesh.get_group("dp"))
    dist.all_reduce(x)
    return {"shape": shape, "tp_sum": float(tp), "dp_sum": float(dp),
            "world_sum": float(x)}


# ---- on the card ----

def card_inputs(dev):
    """Seeded bf16 inputs at Llama-3-8B's attention widths for the three
    compositions: K1 (B=4 rows over 16-token pages), K3 (256 tokens), K2
    (a 256-row prefix buffer holding 100 valid rows, 128 new rows)."""
    g = torch.Generator(device=dev).manual_seed(5)
    H, Hkv, D, T, n_blocks = 32, 8, 128, 16, 64

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    table = torch.randperm(n_blocks, device=dev, generator=g)[:4 * 8].view(
        4, 8).to(torch.int32)
    return {
        "decode": (rnd(4, H, D), rnd(2, Hkv, n_blocks, T, D), table,
                   torch.tensor([1, 37, 100, 128], dtype=torch.int32,
                                device=dev)),
        "causal": (rnd(1, 256, H, D), rnd(1, 256, Hkv, D),
                   rnd(1, 256, Hkv, D)),
        "prefix": (rnd(1, 128, H, D), rnd(1, 384, Hkv, D),
                   rnd(1, 384, Hkv, D)),
    }


def compositions_on_card(rank, world):
    """Each composition on this rank's head shard of ``card_inputs``, on
    the card; returns the output shards, the kernels each launched and
    the nvcc processes this rank started."""
    from infinistore_tpu_torch.models import attention as A
    from infinistore_tpu_torch.ops import build
    from infinistore_tpu_torch.ops import cuda_attention as ca

    dev = torch.device("cuda")
    x = card_inputs(dev)

    def sh(t, dim):
        n = t.shape[dim] // world
        return t.narrow(dim, rank * n, n).contiguous()

    before = dict(ca.LAUNCHES)
    q, cache, table, lens = x["decode"]
    out = {"decode": A.paged_decode_attention_tp(
        sh(q, 1), sh(cache, 1), table, lens, world, n_heads=32,
        n_kv_heads=8)}
    q, k, v = x["causal"]
    out["causal"] = A.flash_causal_attention_tp(
        sh(q, 2), sh(k, 2), sh(v, 2), world, n_heads=32, n_kv_heads=8)
    q, k, v = x["prefix"]
    out["prefix"] = A.flash_causal_attention_tp(
        sh(q, 2), sh(k, 2), sh(v, 2), world, q_offset=256, prefix_pad=256,
        prefix_len=100, n_heads=32, n_kv_heads=8)
    torch.cuda.synchronize()
    return ({k: v.float().cpu() for k, v in out.items()},
            {k: ca.LAUNCHES[k] - before[k] for k in before},
            build.NVCC_RUNS)
