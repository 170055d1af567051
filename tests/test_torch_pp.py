"""Layer-sharded serving (``--pp``) on the CPU: the port's counterpart of
``tests/test_parallel.py::test_pp_sharded_engine_matches_unsharded``, the
store hop of a pp group both ways with JAX (whole pages, byte-compatible),
and ``serve --pp 2`` over HTTP.

Each group is a spawned gloo world (``tp_world.py``, ranks running
``tp_targets.py``): stage 0 embeds, each stage runs its half of the layers
on its tp shard and hands the hidden state to the next, the last stage's
logits reach every rank.  The JAX side runs in this process.  TINY in
float32 with ``kv_quant=None`` where tokens must be equal."""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tp_targets
from conftest import make_dense_greedy
from infinistore_tpu.engine import InferenceEngine as JEngine
from infinistore_tpu.kv import PagedCacheConfig as JPC
from infinistore_tpu.kv import read_pages as j_read_pages
from infinistore_tpu.models import TINY, init_params, scaled
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.models import TINY as TTINY
from infinistore_tpu_torch.models import scaled as tscaled
from test_torch_store import _connect as _conn
from test_torch_store import _free_port
from test_torch_store import servers  # noqa: F401  (fixture)
from tp_world import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = scaled(TINY, dtype=jnp.float32)
TCFG = tscaled(TTINY, dtype=torch.float32)
PARAMS = init_params(CFG, jax.random.PRNGKey(11))
TREE = jax.tree.map(np.asarray, PARAMS)
T = 4
PROMPT = [int(t) for t in np.random.RandomState(3).randint(1, 512, 11)]
# 5 complete chunks + a 3-token tail
PUSHED = [11, 42, 7, 99, 5, 3, 17, 28, 64, 1, 2, 90, 13, 8, 21, 34, 55, 3,
          77, 6, 15, 19, 24]

dense_greedy = make_dense_greedy(PARAMS, CFG)


def _pcs(n_blocks=64):
    return (JPC(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
                head_dim=CFG.head_dim, n_blocks=n_blocks, block_tokens=T,
                dtype=jnp.float32),
            PagedCacheConfig(n_layers=TCFG.n_layers,
                             n_kv_heads=TCFG.n_kv_heads,
                             head_dim=TCFG.head_dim, n_blocks=n_blocks,
                             block_tokens=T, dtype=torch.float32))


def _world(tmp_path, script, mesh_kw, store=None, engine_kw=None, **kw):
    _, tpc = _pcs()
    world = mesh_kw.get("pp", 1) * mesh_kw.get("tp", 1)
    return run_world(tp_targets.engine_world, world, tmp_path, TREE, TCFG,
                     tpc, script, {"kv_quant": None, **(engine_kw or {})},
                     store=store, mesh_kw=mesh_kw, script_kw=kw)[0]


@pytest.mark.parametrize("mesh_kw,shard", [
    ({"pp": 2}, False), ({"pp": 2, "tp": 2}, False),
    ({"pp": 2, "tp": 2}, True)],
    ids=["pp2", "pp2xtp2", "pp2xtp2-drawn-per-rank"])
def test_pp_sharded_engine_matches_unsharded(tmp_path, mesh_kw, shard):
    """pp=2 and pp=2 x tp=2 groups decode the JAX unsharded engine's
    ``decode_batch`` tokens exactly, and at rest every rank holds
    ``1/(pp*tp)`` of ``wq`` and of the paged cache (its stage's layers, its
    heads): the memory claim, asserted.  The weights reach the ranks whole
    (the engine shards them) or as each rank's shard
    (``params_from_jax(..., pp_rank=, pp=)``)."""
    jpc, tpc = _pcs()
    ref = JEngine(PARAMS, CFG, jpc, kv_quant=None)
    sa, sb = ref.prefill(PROMPT), ref.prefill(PROMPT[:5])
    want = ref.decode_batch([sa, sb], 10)
    out = _world(tmp_path, tp_targets.held, mesh_kw,
                 engine_kw={"shard_params": shard}, prompt=PROMPT,
                 n_steps=10)
    assert out["batch"] == want
    assert out["tokens"] == dense_greedy(PROMPT, 10)
    n = mesh_kw.get("pp", 1) * mesh_kw.get("tp", 1)
    whole_wq = TREE["layers"]["wq"].size * 4
    whole_cache = (2 * tpc.n_layers * tpc.n_kv_heads * tpc.n_blocks * T
                   * tpc.head_dim * 4)
    ranks = out["reports"]
    assert len(ranks) == n
    for r in ranks:
        assert r["wq_bytes"] * n == whole_wq, r
        assert r["cache_bytes"] * n == whole_cache, r
        assert r["layers"] == CFG.n_layers // mesh_kw["pp"]
    assert [r["stage"] for r in ranks] == sorted(
        list(range(mesh_kw["pp"])) * mesh_kw.get("tp", 1))
    assert all(r["tokens"] == ranks[0]["tokens"] for r in ranks)


# ---- the store hop: whole pages, as a tp=1 engine stores them ----

@pytest.mark.parametrize("mesh_kw", [{"pp": 2}, {"pp": 2, "tp": 2}],
                         ids=["pp2", "pp2xtp2"])
def test_jax_push_pp_adopts_bitwise(servers, tmp_path, monkeypatch,
                                    mesh_kw):
    """A JAX engine pushes a prompt (lossless); a pp group adopts its
    chunks, each rank its stage's layers and its heads, and the pages
    gathered over the ranks are bitwise the JAX engine's; the greedy
    tokens are the dense reference's."""
    port = servers["infinistore_tpu_torch"]
    model_id = f"pp-adopt-from-jax-{len(mesh_kw)}"
    jpc, _ = _pcs()
    jconn = _conn("jax", port, "shm", monkeypatch)
    try:
        je = JEngine(PARAMS, CFG, jpc, conn=jconn, kv_quant=None,
                     model_id=model_id)
        sa = je.prefill(PUSHED)
        n = (len(PUSHED) - 1) // T
        want = np.asarray(j_read_pages(je.cache,
                                       jnp.asarray(sa.block_ids[:n])))
    finally:
        jconn.close()
    out = _world(tmp_path, tp_targets.adopt_prompt, mesh_kw,
                 store=(port, "shm", model_id), prompt=PUSHED, n_steps=6)
    assert out["store"] == n
    np.testing.assert_array_equal(out["pages"], want)
    assert out["tokens"] == dense_greedy(PUSHED, 6)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_pp_push_jax_adopts(servers, tmp_path, monkeypatch, quant):
    """A pp=2 group pushes a prompt (lossless, and int8); a JAX engine
    adopts every complete chunk.  Lossless: the adopted pages are bitwise
    the pages the group gathered, and the tokens the dense reference's.
    int8: the JAX adopter's tokens equal a JAX adopter's of the same
    prompt pushed by a JAX producer."""
    port = servers["infinistore_tpu"]
    model_id = f"pp-push-{quant}"
    out = _world(tmp_path, tp_targets.push_and_pages, {"pp": 2},
                 engine_kw={"kv_quant": quant},
                 store=(port, "tcp", model_id), prompt=PUSHED)
    jpc, _ = _pcs()
    jconn = _conn("jax", port, "tcp", monkeypatch)
    n = (len(PUSHED) - 1) // T
    try:
        je = JEngine(PARAMS, CFG, jpc, conn=jconn, kv_quant=quant,
                     model_id=model_id)
        sb = je.prefill(PUSHED)
        assert sb.reused_chunks == n
        got = je.decode(sb, 6)
        if quant is None:
            pages = np.asarray(j_read_pages(je.cache,
                                            jnp.asarray(sb.block_ids[:n])))
            np.testing.assert_array_equal(pages, out["pages"][:, :, :, :n])
            assert got == dense_greedy(PUSHED, 6)
        else:
            mid = model_id + "-jax"
            JEngine(PARAMS, CFG, jpc, conn=jconn, kv_quant=quant,
                    model_id=mid).prefill(PUSHED)
            jb = JEngine(PARAMS, CFG, jpc, conn=jconn, kv_quant=quant,
                         model_id=mid)
            sj = jb.prefill(PUSHED)
            assert sj.reused_chunks == n
            assert got == jb.decode(sj, 6)
    finally:
        jconn.close()


# ---- serve --pp 2 over HTTP ----

def _get(port, path):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", path)
    r = c.getresponse()
    return json.loads(r.read())


def test_serve_pp_answers_a_completion():
    """``serve --pp 2 --device cpu --dist-backend gloo --model tiny``
    answers greedy completions equal to a tp=1 port engine's on the same
    weights (bf16: within the teacher-forced top 2), both stages report
    (each with one of TINY's two layers), and SIGTERM leaves no rank
    behind."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.serve", "--model",
         "tiny", "--device", "cpu", "--pp", "2", "--dist-backend", "gloo",
         "--port", str(port), "--n-blocks", "64", "--kv-quant", "none"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    try:
        deadline = time.time() + 90
        while True:
            try:
                _get(port, "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.time() < deadline, "serve --pp 2 never came up"
                time.sleep(0.5)
        import http.client

        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("POST", "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": 8, "temperature": 0}))
        r = c.getresponse()
        body = json.loads(r.read())
        assert r.status == 200, body
        got = body["choices"][0]["token_ids"]
        ranks = _get(port, "/debug/engine?limit=0")["tp"]["ranks"]
        assert [(r["rank"], r["stage"], r["layers"]) for r in ranks] == \
            [(0, 0, 1), (1, 1, 1)]
        assert ranks[0]["tokens"] == ranks[1]["tokens"]
        pids = [r["pid"] for r in ranks]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import prefill_forward
    from infinistore_tpu_torch.serve import load_model

    cfg, params, _ = load_model("tiny", torch.device("cpu"))
    ref = InferenceEngine(params, cfg, PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_blocks=64, block_tokens=16,
        dtype=cfg.dtype), kv_quant=None, device="cpu")
    want = ref.decode(ref.prefill(prompt), 8)
    if got != want:
        logits, _ = prefill_forward(params, cfg, torch.tensor([prompt + got]))
        for j, g in enumerate(got):
            row = logits[0, len(prompt) + j - 1].float()
            assert int((row > row[g]).sum()) < 2, (j, g)


@pytest.mark.parametrize("pp,tp", [(1, 2), (2, 1), (2, 2)],
                         ids=["tp2", "pp2", "pp2xtp2"])
def test_load_model_reads_each_ranks_shard_of_a_checkpoint(tmp_path, pp, tp):
    """``serve --model <dir> --pp/--tp``: each rank's ``load_model`` of a
    checkpoint directory is that rank's ``shard_tree`` of the whole load
    (its stage's layers, its heads, ``embed`` on stage 0 and ``ln_out`` /
    ``lm_head`` on the last), and its layer leaves are ``1/(pp*tp)`` of
    the whole's."""
    from test_torch_cuda import _write_checkpoint

    from infinistore_tpu_torch.parallel.sharding import (
        llama_inference_specs, shard_tree)
    from infinistore_tpu_torch.serve import load_model

    _write_checkpoint(tmp_path, "llama")
    cpu = torch.device("cpu")
    cfg, whole, _ = load_model(str(tmp_path), cpu)
    specs = llama_inference_specs(whole)
    for pp_rank in range(pp):
        for tp_rank in range(tp):
            cfg_r, got, fns = load_model(str(tmp_path), cpu, tp_rank=tp_rank,
                                         tp=tp, pp_rank=pp_rank, pp=pp)
            assert cfg_r == cfg and fns == {}
            want = shard_tree(whole, specs, tp_rank, tp, pp_rank, pp)
            for k in ("embed", "ln_out", "lm_head"):
                assert torch.equal(got[k], want[k]), (k, pp_rank, tp_rank)
            for k, v in want["layers"].items():
                assert torch.equal(got["layers"][k], v), (k, pp_rank,
                                                          tp_rank)
            assert got["layers"]["wq"].numel() * pp * tp == \
                whole["layers"]["wq"].numel()
