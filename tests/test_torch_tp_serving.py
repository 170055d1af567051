"""Tensor-parallel serving end to end on the CPU: the store hop under tp
(whole pages, byte-compatible with JAX), ranks that agree, the paths that
raise, a follower that dies, and ``serve --tp 2`` over HTTP.

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


def test_every_route_runs_through_the_mirror_or_raises(tmp_path):
    """Every engine method that launches model compute, under tp=2: the
    routes (prefill, decode, the batched group prefill, prompt logprobs,
    adopt, abandon) give a tp=1 engine's answers; ``verify``, ``propose``
    and both speculators raise ``NotImplementedError`` naming their
    ROADMAP item, and so does a LoRA bank at construction."""
    _, tpc = _pcs()
    ref = InferenceEngine(params_from_jax(TREE, TCFG, "cpu"), TCFG, tpc,
                          kv_quant=None, device="cpu")
    src = ref.prefill(PROMPT[:7])
    kv = ref.cache[:, :, :, torch.tensor(src.block_ids)]  # [L,2,H,n,T,D]
    from infinistore_tpu_torch.kv import pages_to_seq_kv

    adopt_kv = pages_to_seq_kv(kv).numpy()
    adopt_logits = src.last_logits.numpy()
    out = _world(tmp_path, tp_targets.every_route, prompt=PROMPT,
                 n_steps=5, adopt_kv=adopt_kv, adopt_logits=adopt_logits)
    want = InferenceEngine(params_from_jax(TREE, TCFG, "cpu"), TCFG, tpc,
                           kv_quant=None, device="cpu")
    assert out["decode"] == want.decode(want.prefill(PROMPT), 5)
    states = want.prefill_batch([PROMPT[:9], PROMPT[1:10], PROMPT[:4]])
    assert out["batch"] == want.decode_batch(states, 5)
    lp = want.prompt_logprobs(PROMPT[:9], k=2)
    assert [[t for t, _ in r[1]] for r in out["prompt_logprobs"]] == \
        [[t for t, _ in r[1]] for r in lp]
    np.testing.assert_allclose([r[0] for r in out["prompt_logprobs"]],
                               [r[0] for r in lp], atol=1e-5)
    assert out["adopted"] == ref.decode(src, 5)
    for name in ("verify", "propose", "draft", "ngram"):
        assert "ROADMAP.md queue 1 item 5b" in out["raised"][name], name
    from infinistore_tpu_torch.models.lora import init_lora_bank

    bank = init_lora_bank(TCFG, ["a"], 4, torch.Generator().manual_seed(0),
                          "cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 5b"):
        InferenceEngine(params_from_jax(TREE, TCFG, "cpu"), TCFG, tpc,
                        lora=bank, mesh=object(), device="cpu")


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


def test_serve_refuses_pp_and_nccl_without_cards():
    """``serve --pp 2`` exits naming its ROADMAP item; ``--tp 2`` over
    nccl on the CPU exits naming gloo."""
    for argv, msg in ((["--pp", "2"], "queue 1 item 5a"),
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
