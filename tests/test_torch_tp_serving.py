"""Tensor-parallel serving end to end on the CPU: the store hop under tp
(whole pages, byte-compatible with JAX), ranks that agree, every route on
tp, pp and pp x tp groups, a follower that dies, the CLI's refusals and
``serve --tp 2`` over HTTP.

Each engine group is a spawned gloo world (``tp_world.py``); the JAX side
runs in this process.  TINY in float32 where tokens must be equal; the
HTTP case serves the CLI's TINY in bf16 and holds it by the rank rule of
``PERF.md`` (a token that differs from the JAX engine's must be within
that engine's teacher-forced top 2, its logit within ``BF16_GAP`` of the
best)."""

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
from infinistore_tpu.models.llama import prefill_forward as j_prefill
from infinistore_tpu.parallel import make_mesh as j_make_mesh
from infinistore_tpu_torch.engine import InferenceEngine
from infinistore_tpu_torch.kv import KVTransferEngine, PagedCacheConfig
from infinistore_tpu_torch.kv import init_cache, write_pages
from infinistore_tpu_torch.models import TINY as TTINY
from infinistore_tpu_torch.models import params_from_jax
from infinistore_tpu_torch.models import scaled as tscaled
from test_torch_store import _connect as _conn
from test_torch_store import _free_port, _serve
from test_torch_store import servers  # noqa: F401  (fixture)
from tp_world import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = scaled(TINY, dtype=jnp.float32)
TCFG = tscaled(TTINY, dtype=torch.float32)
PARAMS = init_params(CFG, jax.random.PRNGKey(7))
TREE = jax.tree.map(np.asarray, PARAMS)
# the speculators' draft: TINY with other weights
DRAFT_TREE = jax.tree.map(np.asarray, init_params(CFG, jax.random.PRNGKey(8)))
T = 4
PROMPT = [11, 42, 7, 99, 5, 3, 17, 28, 64, 1, 2, 90, 13, 8, 21, 34, 55, 3,
          77, 6, 15, 19, 24]  # 5 full chunks + a 3-token tail
# the largest logit gap a bf16 token may trail the reference's best by
BF16_GAP = 0.05

dense_greedy = make_dense_greedy(PARAMS, CFG)


def _pcs(n_blocks=32):
    return (JPC(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
                head_dim=CFG.head_dim, n_blocks=n_blocks, block_tokens=T,
                dtype=jnp.float32),
            PagedCacheConfig(n_layers=TCFG.n_layers,
                             n_kv_heads=TCFG.n_kv_heads,
                             head_dim=TCFG.head_dim, n_blocks=n_blocks,
                             block_tokens=T, dtype=torch.float32))


def _world(tmp_path, script, store=None, engine_kw=None, world=2, **kw):
    _, tpc = _pcs()
    return run_world(tp_targets.engine_world, world, tmp_path, TREE, TCFG,
                     tpc, script, {"kv_quant": None, **(engine_kw or {})},
                     store=store, script_kw=kw)[0]


# ---- the store hop: whole pages, as a tp=1 engine stores them ----

def test_jax_push_tp_adopts_bitwise(servers, tmp_path, monkeypatch):
    """A JAX engine pushes a prompt (lossless); a tp=2 port group adopts
    its chunks, each rank its head slice, and the pages gathered over the
    ranks are bitwise the JAX engine's; the greedy tokens are the dense
    reference's."""
    port = servers["infinistore_tpu_torch"]
    model_id = "tp-adopt-from-jax"
    jpc, _ = _pcs()
    jconn = _conn("jax", port, "shm", monkeypatch)
    try:
        je = JEngine(PARAMS, CFG, jpc, conn=jconn, kv_quant=None,
                     model_id=model_id)
        sa = je.prefill(PROMPT)
        n = (len(PROMPT) - 1) // T
        want = np.asarray(j_read_pages(
            je.cache, jnp.asarray(sa.block_ids[:n])))
    finally:
        jconn.close()
    out = _world(tmp_path, tp_targets.adopt_prompt,
                 store=(port, "shm", model_id), prompt=PROMPT, n_steps=6)
    assert out["store"] == n
    np.testing.assert_array_equal(out["pages"], want)
    assert out["tokens"] == dense_greedy(PROMPT, 6)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_tp_push_jax_adopts(servers, tmp_path, monkeypatch, quant):
    """A tp=2 port group pushes a prompt (lossless, and int8); a JAX engine
    adopts every complete chunk.  Lossless: its greedy tokens are the
    dense reference's.  int8: its tokens equal a JAX adopter's of the
    same prompt pushed by a JAX producer."""
    port = servers["infinistore_tpu"]
    model_id = f"tp-push-{quant}"
    out = _world(tmp_path, tp_targets.push_prompt, engine_kw={
        "kv_quant": quant}, store=(port, "tcp", model_id), prompt=PROMPT,
        n_steps=6)
    assert out["reused"] == 0
    jpc, _ = _pcs()
    jconn = _conn("jax", port, "tcp", monkeypatch)
    try:
        je = JEngine(PARAMS, CFG, jpc, conn=jconn, kv_quant=quant,
                     model_id=model_id)
        sb = je.prefill(PROMPT)
        assert sb.reused_chunks == (len(PROMPT) - 1) // T
        got = je.decode(sb, 6)
        if quant is None:
            assert got == dense_greedy(PROMPT, 6)
        else:
            mid = model_id + "-jax"
            jp = JEngine(PARAMS, CFG, jpc, conn=jconn, kv_quant=quant,
                         model_id=mid)
            jp.prefill(PROMPT)
            jb = JEngine(PARAMS, CFG, jpc, conn=jconn, kv_quant=quant,
                         model_id=mid)
            sj = jb.prefill(PROMPT)
            assert sj.reused_chunks == sb.reused_chunks
            assert got == jb.decode(sj, 6)
    finally:
        jconn.close()
    assert out["tokens"] == dense_greedy(PROMPT, 6)


def test_tp_int8_payload_equals_a_tp1_push(servers, tmp_path):
    """The packed int8 payload a tp=2 group pushes is byte-equal to what a
    tp=1 port engine packs from the same whole pages (per-(K|V, head)
    scales: the gather puts each rank's heads where a tp=1 cache holds
    them)."""
    port = servers["infinistore_tpu_torch"]
    out = _world(tmp_path, tp_targets.push_and_pages, engine_kw={
        "kv_quant": "int8"}, store=(port, "tcp", "tp-int8-bytes"),
        prompt=PROMPT)
    _, tpc = _pcs()
    pages = torch.from_numpy(out["pages"])  # [L, 2, H, n, T, D]
    n = pages.shape[3]
    cache = init_cache(tpc, "cpu")
    write_pages(cache, torch.arange(n), pages)
    tx = KVTransferEngine(None, tpc, quant="int8", device="cpu")
    want = tx.gather_pages(cache, list(range(n))).numpy()
    np.testing.assert_array_equal(out["packed"], want)


def test_tp_push_over_a_ring_adopts_bitwise(tmp_path):
    """Over a ``cluster.RoutedStorePool`` of two store nodes: a tp=2 group
    pushes (each chunk to its ring owner); a tp=1 port engine on its own
    pool adopts every chunk, and its pages are bitwise the pages the tp=2
    group gathered."""
    procs = [_serve("infinistore_tpu_torch") for _ in range(2)]
    try:
        eps = [f"127.0.0.1:{port}" for _proc, port in procs]
        out = _world(tmp_path, tp_targets.push_and_pages,
                     store=(eps, "tcp", "tp-ring"), prompt=PROMPT)
        from infinistore_tpu_torch.cluster import RoutedStorePool

        pool = RoutedStorePool(eps, connection_type="TCP")
        try:
            _, tpc = _pcs()
            b = InferenceEngine(params_from_jax(TREE, TCFG, "cpu"), TCFG,
                                tpc, conn=pool, kv_quant=None,
                                model_id="tp-ring", device="cpu")
            sb = b.prefill(PROMPT)
            n = (len(PROMPT) - 1) // T
            assert sb.store_chunks == n
            got = b.cache[:, :, :, torch.tensor(sb.block_ids[:n])]
            np.testing.assert_array_equal(got.numpy(),
                                          out["pages"][:, :, :, :n])
            assert b.decode(sb, 6) == dense_greedy(PROMPT, 6)
        finally:
            pool.close()
    finally:
        for proc, _port in procs:
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=10)


# ---- the ranks agree, the paths that do not run raise ----

def test_ranks_sample_the_same_tokens(tmp_path):
    """Greedy, seeded top-k/top-p and penalized sampling over 2 ranks:
    every rank's sampled tokens are the leader's, chunk by chunk (the
    logits are all-gathered, the draws counter-based); greedy equals the
    dense reference."""
    out = _world(tmp_path, tp_targets.sampled, prompt=PROMPT, n_steps=8)
    assert out["greedy"] == dense_greedy(PROMPT, 8)
    ranks = out["reports"]
    assert len(ranks) == 2 and ranks[0]["tokens"]
    assert ranks[0]["tokens"] == ranks[1]["tokens"]
    # the sampled rows really sampled: not every row is its greedy path
    assert out["seeded"][0] != dense_greedy(PROMPT, 8)


@pytest.mark.parametrize("mesh_kw", [{"tp": 2}, {"pp": 2},
                                     {"pp": 2, "tp": 2}],
                         ids=["tp2", "pp2", "pp2xtp2"])
def test_every_route_runs_through_the_mirror_or_raises(tmp_path, mesh_kw):
    """Every engine method that launches model compute, on a serving group
    of a tp=2, a pp=2 and a pp=2 x tp=2 mesh with a LoRA bank attached:
    prefill, decode, the batched group prefill, prompt logprobs, adopt,
    abandon, ``verify``, ``propose``, both speculators (the draft an
    unsharded engine beside the group, on its leader) and an adapter's
    decode give a tp=1 engine's answers (tokens equal, logits and
    probabilities within 1e-5)."""
    _, tpc = _pcs(96)
    from infinistore_tpu_torch.kv import pages_to_seq_kv
    from infinistore_tpu_torch.models.lora import init_lora_bank

    bank = init_lora_bank(TCFG, ["a", "b"], 4,
                          torch.Generator().manual_seed(0), "cpu",
                          init_scale=0.5)
    src_eng = InferenceEngine(params_from_jax(TREE, TCFG, "cpu"), TCFG, tpc,
                              kv_quant=None, device="cpu")
    src = src_eng.prefill(PROMPT[:7])
    kv = src_eng.cache[:, :, :, torch.tensor(src.block_ids)]
    adopt_kv = pages_to_seq_kv(kv).numpy()
    adopt_logits = src.last_logits.numpy()
    kw = dict(prompt=PROMPT, n_steps=5, adopt_kv=adopt_kv,
              adopt_logits=adopt_logits, draft_tree=DRAFT_TREE, cfg=TCFG,
              pc=tpc)
    world = mesh_kw.get("tp", 1) * mesh_kw.get("pp", 1)
    got = run_world(tp_targets.engine_world, world, tmp_path, TREE, TCFG,
                    tpc, tp_targets.every_route,
                    {"kv_quant": None, "lora": bank}, mesh_kw=mesh_kw,
                    script_kw=kw)[0]
    ref = InferenceEngine(params_from_jax(TREE, TCFG, "cpu"), TCFG, tpc,
                          kv_quant=None, device="cpu", lora=bank)
    want = tp_targets.every_route(ref, **kw)
    for name in ("decode", "batch", "adopted", "draft", "ngram", "adapter"):
        assert got[name] == want[name], name
    assert got["propose"][0] == want["propose"][0]
    np.testing.assert_allclose(got["propose"][1], want["propose"][1],
                               atol=1e-5)
    np.testing.assert_allclose(got["verify"], want["verify"], atol=1e-5)
    lp, wlp = got["prompt_logprobs"], want["prompt_logprobs"]
    assert [[t for t, _ in r[1]] for r in lp] == \
        [[t for t, _ in r[1]] for r in wlp]
    np.testing.assert_allclose([r[0] for r in lp], [r[0] for r in wlp],
                               atol=1e-5)
    # the plain routes are the dense reference's
    assert want["decode"] == dense_greedy(PROMPT, 5)
    assert want["adopted"] == src_eng.decode(src, 5)
    ranks = got["reports"]
    assert len(ranks) == world
    assert all(r["tokens"] == ranks[0]["tokens"] for r in ranks)


def test_a_gloo_group_refuses_to_capture(tmp_path):
    """Over gloo the collectives run on the host: asking the engine to
    capture a CUDA graph raises (the graph bodies run eagerly)."""
    _, tpc = _pcs()
    out = run_world(tp_targets.capture_under_gloo, 2, tmp_path, TREE, TCFG,
                    tpc)
    assert all(msg and "gloo" in msg for msg in out)


def test_a_dead_follower_fails_the_next_step_fast(tmp_path):
    """A follower killed mid-serving makes the leader's next step raise,
    well inside the group's timeout (60 s here), not hang."""
    _, tpc = _pcs()
    out = run_world(tp_targets.follower_pid_world, 2, tmp_path, TREE, TCFG,
                    tpc, PROMPT, 4, dies=(1,))
    assert out[0]["raised"] is not None
    assert out[0]["seconds"] < 30


def test_serve_refuses_pp_and_nccl_without_cards(tmp_path):
    """``serve --pp 3`` exits naming TINY's layer count (2 layers do not
    split in 3 stages); ``--pp 2`` with an MoE checkpoint exits naming the
    dense families; ``--tp 2`` over nccl on the CPU exits naming gloo."""
    moe = tmp_path / "moe"
    moe.mkdir()
    (moe / "config.json").write_text(json.dumps({"model_type": "mixtral"}))
    for argv, msg in ((["--pp", "3", "--device", "cpu"],
                       "n_layers=2 must divide over --pp 3"),
                      (["--pp", "2", "--device", "cpu", "--dist-backend",
                        "gloo", "--model", str(moe)], "dense families"),
                      (["--tp", "2", "--device", "cpu"], "gloo")):
        r = subprocess.run(
            [sys.executable, "-m", "infinistore_tpu_torch.serve", *argv],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert msg in r.stderr, r.stderr[-500:]


# ---- serve --tp 2 over HTTP ----

def _post(port, body):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("POST", "/v1/completions", json.dumps(body))
    r = c.getresponse()
    return r.status, json.loads(r.read())


def _get(port, path):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", path)
    r = c.getresponse()
    return json.loads(r.read())


def test_serve_tp_answers_a_completion(tmp_path):
    """``serve --tp 2 --device cpu --dist-backend gloo --model tiny``
    answers a greedy completion; its tokens follow the rank rule against
    the JAX engine's on a tp=2 mesh over the same bf16 weights; both ranks
    report; SIGTERM leaves no rank behind."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.serve", "--model",
         "tiny", "--device", "cpu", "--tp", "2", "--dist-backend", "gloo",
         "--port", str(port), "--n-blocks", "64", "--kv-quant", "none"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 90
        while True:
            try:
                _get(port, "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.time() < deadline, "serve --tp 2 never came up"
                time.sleep(0.5)
        prompt = [1, 2, 3, 4, 5, 6, 7, 8]
        status, body = _post(port, {"prompt": prompt, "max_tokens": 8,
                                    "temperature": 0})
        assert status == 200
        got = body["choices"][0]["token_ids"]
        ranks = _get(port, "/debug/engine?limit=0")["tp"]["ranks"]
        assert [r["rank"] for r in ranks] == [0, 1]
        assert ranks[0]["tokens"] == ranks[1]["tokens"]
        pids = [r["pid"] for r in ranks]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    # the JAX engine on a tp=2 mesh over the CLI's weights
    gen = torch.Generator().manual_seed(0)
    from infinistore_tpu_torch.models import init_params as t_init

    tw = t_init(TTINY, gen, "cpu")
    jparams = jax.tree.map(
        lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), tw)
    jpc = JPC(n_layers=TINY.n_layers, n_kv_heads=TINY.n_kv_heads,
              head_dim=TINY.head_dim, n_blocks=64, block_tokens=16)
    mesh = j_make_mesh(tp=2)
    with jax.set_mesh(mesh):
        je = JEngine(jparams, TINY, jpc, mesh=mesh)
        want = je.decode(je.prefill(prompt), 8)
    logits = np.asarray(j_prefill(jparams, TINY, jnp.asarray(
        [prompt + got], jnp.int32))[0][0], np.float32)
    if got != want:
        # teacher-forced along the served tokens
        for j, g in enumerate(got):
            row = logits[len(prompt) + j - 1]
            if g == int(row.argmax()):
                continue
            assert g in np.argsort(-row)[:2], (j, g)
            assert row.max() - row[g] <= BF16_GAP, (j, row.max() - row[g])
