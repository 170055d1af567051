"""The port's ``parallel/distributed.py`` against the reference's cases
(``tests/test_distributed.py``): ``initialize`` in one process, hybrid
meshes over spawned gloo worlds (``tp_world.py``), the dp x tp serving
engine, the per-process batch and the store targets."""

import jax
import numpy as np
import pytest
import torch

import tp_targets
from infinistore_tpu.engine.engine import InferenceEngine as JEngine
from infinistore_tpu.kv.cache import PagedCacheConfig as JPC
from infinistore_tpu.models import TINY, init_params, scaled
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.models import TINY as TTINY
from infinistore_tpu_torch.models import scaled as tscaled
from infinistore_tpu_torch.parallel import (dcn_aware_store_targets,
                                            initialize, process_local_batch)
from tp_world import run_world


def test_initialize_noop_single_process(monkeypatch):
    """``:15``: with nothing configured, ``initialize`` joins nothing and
    returns at once."""
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    initialize()
    assert not dist.is_initialized()


def test_hybrid_mesh_single_process(tmp_path):
    """``:19``: one host group, ``make_hybrid_mesh(tp=2)`` over a 4-rank
    world is dp=2 x tp=2 and usable: sums over tp, dp and the world see
    the right ranks."""
    out = run_world(tp_targets.hybrid_mesh, 4, tmp_path, {"tp": 2})
    for rank, r in enumerate(out):
        assert r["shape"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
        base = rank - rank % 2
        assert r["tp_sum"] == base + base + 1  # the rank's tp pair
        assert r["dp_sum"] == (rank % 2) * 2 + 2  # {r % 2, r % 2 + 2}
        assert r["world_sum"] == 6.0


def test_hybrid_mesh_dcn_groups_single_process(tmp_path):
    """``:32``: two host groups (``dcn_dp=2``) of 2 ranks each, tp=2: the
    same shape with dp outermost across the groups, every tp group inside
    one, and the mesh executes a collective over each axis."""
    out = run_world(tp_targets.hybrid_mesh, 4, tmp_path,
                    {"tp": 2, "dcn_dp": 2})
    for rank, r in enumerate(out):
        assert r["shape"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
        assert r["tp_sum"] == {0: 1, 1: 1, 2: 5, 3: 5}[rank]
        assert r["world_sum"] == 6.0


def test_hybrid_mesh_engine_decode(tmp_path):
    """``:47``: multi-host serving's shape, dp=2 x tp=2 over 4 ranks: each
    dp replica's tp group serves the prompt, and both replicas' greedy
    tokens equal the JAX single-device engine's (TINY in float32, where
    the reference's case runs bf16: token equality holds in f32)."""
    cfg = scaled(TINY, dtype=jax.numpy.float32)
    tcfg = tscaled(TTINY, dtype=torch.float32)
    params = init_params(cfg, jax.random.PRNGKey(2))
    jpc = JPC(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, n_blocks=16, block_tokens=4,
              dtype=cfg.dtype)
    tpc = PagedCacheConfig(n_layers=tcfg.n_layers,
                           n_kv_heads=tcfg.n_kv_heads,
                           head_dim=tcfg.head_dim, n_blocks=16,
                           block_tokens=4, dtype=tcfg.dtype)
    prompt = [1, 2, 3, 4, 5, 6, 7]
    ref = JEngine(params, cfg, jpc)
    want = ref.decode(ref.prefill(prompt), 4)
    out = run_world(tp_targets.engine_world, 4, tmp_path,
                    jax.tree.map(np.asarray, params), tcfg, tpc,
                    tp_targets.decode, {"kv_quant": None},
                    mesh_kw={"hybrid": True, "dcn_dp": 2, "tp": 2},
                    script_kw={"prompt": prompt, "n_steps": 4})
    leaders = [r for r in out if "tokens" in r]
    assert len(leaders) == 2
    for r in leaders:
        assert r["tokens"] == want
        assert len(r["reports"]) == 2


def test_process_local_batch_and_targets():
    """``:72``: one process takes the whole batch; a store host on this
    machine wins, else rank-affine round robin."""
    assert process_local_batch(32) == 32
    hosts = ["10.0.0.1", "10.0.0.2"]
    assert dcn_aware_store_targets(hosts, my_rank=0) == "10.0.0.1"
    assert dcn_aware_store_targets(hosts, my_rank=3) == "10.0.0.2"
    assert dcn_aware_store_targets(["10.0.0.9", "127.0.0.1"]) == "127.0.0.1"
    with pytest.raises(ValueError):
        dcn_aware_store_targets([])
