"""Speculation and LoRA under tensor parallelism on the CPU: ``verify`` on a
tp=2 group, the draft-model and n-gram speculators' round bodies with the
target sharded (the draft an unsharded engine on the group's leader), the
scheduler's speculative fast path, a LoRA bank sharded as the weights are,
a ``ServingServer`` over a tp=2 leader with a bank, and ``serve --tp 2``
with ``--ngram-spec`` or ``--draft-model``.

Each group is a spawned gloo world (``tp_world.py``, ranks running
``tp_targets.py``); the JAX side runs in this process.  TINY in float32
with ``kv_quant=None``: every greedy token is held exactly against the JAX
engine's, logits at 1e-5 against the tp=1 port engine's."""

import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tp_targets
from conftest import make_dense_greedy
from infinistore_tpu.engine import InferenceEngine as JEngine
from infinistore_tpu.kv import PagedCacheConfig as JPC
from infinistore_tpu.models import TINY, init_params, scaled
from infinistore_tpu.models import lora as jlora
from infinistore_tpu_torch.engine import InferenceEngine
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.models import TINY as TTINY
from infinistore_tpu_torch.models import bank_from_jax, params_from_jax
from infinistore_tpu_torch.models import scaled as tscaled
from test_torch_store import _free_port
from tp_world import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = scaled(TINY, dtype=jnp.float32)
TCFG = tscaled(TTINY, dtype=torch.float32)
PARAMS = init_params(CFG, jax.random.PRNGKey(7))
TREE = jax.tree.map(np.asarray, PARAMS)
DCFG = scaled(TINY, dtype=jnp.float32, n_layers=1, dim=64, ffn_dim=128)
TDCFG = tscaled(TTINY, dtype=torch.float32, n_layers=1, dim=64, ffn_dim=128)
DRAFT_TREE = jax.tree.map(np.asarray,
                          init_params(DCFG, jax.random.PRNGKey(99)))
# five adapters beside the base (rank 4, nonzero B so each one matters)
BANK = jlora.init_lora_bank(CFG, [f"ad{i}" for i in range(1, 5)], rank=4,
                            key=jax.random.PRNGKey(3), init_scale=0.5)
T = 4
PROMPT = [11, 42, 7, 99, 5, 3, 17, 28, 64, 1, 2, 90, 13, 8, 21]
# repetitive text: the n-gram matcher's proposals get accepted
REPEAT = [5, 6, 7, 8, 9, 5, 6, 7, 8, 9, 5, 6, 7]

dense_greedy = make_dense_greedy(PARAMS, CFG)


def _pc(n_blocks=96):
    return PagedCacheConfig(n_layers=TCFG.n_layers,
                            n_kv_heads=TCFG.n_kv_heads,
                            head_dim=TCFG.head_dim, n_blocks=n_blocks,
                            block_tokens=T, dtype=torch.float32)


def _world(tmp_path, script, engine_kw=None, mesh_kw=None, **kw):
    world = (mesh_kw or {"tp": 2}).get("tp", 1) * \
        (mesh_kw or {"tp": 2}).get("pp", 1)
    return run_world(tp_targets.engine_world, world, tmp_path, TREE, TCFG,
                     _pc(), script, {"kv_quant": None, **(engine_kw or {})},
                     mesh_kw=mesh_kw, script_kw=kw)[0]


def test_verify_on_a_tp_group_equals_tp1(tmp_path):
    """``verify`` (whole rows and the last-row form) on a tp=2 group: the
    tp=1 port engine's logits within 1e-5."""
    run = [3, 77, 41, 9]
    got = _world(tmp_path, tp_targets.verify_logits, prompt=PROMPT, run=run)
    ref = InferenceEngine(params_from_jax(TREE, TCFG, "cpu"), TCFG, _pc(),
                          kv_quant=None, device="cpu")
    want = tp_targets.verify_logits(ref, PROMPT, run)
    assert got["full"].shape == (len(run), TCFG.vocab_size)
    assert got["last"].shape == (1, TCFG.vocab_size)
    np.testing.assert_allclose(got["full"], want["full"], atol=1e-5)
    np.testing.assert_allclose(got["last"], want["last"], atol=1e-5)
    np.testing.assert_allclose(got["last"][0], got["full"][-1], atol=1e-5)


@pytest.mark.parametrize("mesh_kw", [{"tp": 2}, {"pp": 2, "tp": 2}],
                         ids=["tp2", "pp2xtp2"])
def test_speculation_under_tp_equals_greedy(tmp_path, mesh_kw):
    """The draft-model and n-gram speculators on a sharded target (their
    round bodies broadcast each round's run and accepted count to the
    followers, which verify on their shards): one row and a lockstep batch
    each give the JAX engine's plain greedy tokens exactly, rounds ran,
    and the ranks end at the same tokens."""
    prompts = [PROMPT, REPEAT, PROMPT[3:]]
    out = _world(tmp_path, tp_targets.speculate, mesh_kw=mesh_kw,
                 prompts=prompts, n_steps=10, draft_tree=DRAFT_TREE,
                 draft_cfg=TDCFG, pc=_pc())
    want = [dense_greedy(p, 10) for p in prompts]
    assert out["draft"] == want[0]
    assert out["draft_batch"] == want
    assert out["ngram"] == want[0]
    assert out["ngram_batch"] == want
    assert out["draft_rounds"] > 0 and out["ngram_rounds"] > 0
    assert out["after"] == dense_greedy(prompts[0], 13)[10:]
    ranks = out["reports"]
    assert all(r["tokens"] == ranks[0]["tokens"] for r in ranks)


@pytest.mark.parametrize("kind", ["draft", "ngram"])
def test_scheduler_spec_fast_path_under_tp_equals_plain(tmp_path, kind):
    """The scheduler's speculative fast path over a tp=2 leader engine
    (one request in flight, then three together, which step aside to the
    lockstep batch): every output is the plain greedy decode."""
    prompts = [PROMPT, REPEAT, PROMPT[2:11]]
    out = _world(tmp_path, tp_targets.scheduler_spec, prompts=prompts,
                 n_steps=9, kind=kind, draft_tree=DRAFT_TREE,
                 draft_cfg=TDCFG, pc=_pc())
    want = [dense_greedy(p, 9) for p in prompts]
    assert out["alone"] == want
    assert out["together"] == want
    assert out["rounds"] > 0


def _jax_lora_tokens(prompts, aids, n):
    jpc = JPC(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
              head_dim=CFG.head_dim, n_blocks=96, block_tokens=T,
              dtype=jnp.float32)
    je = JEngine(PARAMS, CFG, jpc, lora=BANK, kv_quant=None)
    states = [je.prefill(p, adapter_id=a) for p, a in zip(prompts, aids)]
    return je.decode_batch(states, n)


@pytest.mark.parametrize("whole", [True, False],
                         ids=["bank-sharded-by-engine", "bank-drawn-per-rank"])
def test_lora_under_tp_equals_jax(tmp_path, whole):
    """A LoRA bank on a tp=2 group (wq/wk/wv's B column-sliced, wo's A
    row-sliced, its partial delta summed by wo's all-reduce), adapters 0-4
    mixed in one lockstep batch: the JAX engine's tokens with the same
    bank, row by row and alone.  The bank reaches the ranks whole (the
    engine slices it) or as each rank's shard (``bank_from_jax``)."""
    prompts = [PROMPT, PROMPT[:9], REPEAT, PROMPT[4:], PROMPT[1:12]]
    aids = [0, 1, 2, 3, 4]
    if whole:
        kw = {"lora": bank_from_jax(BANK, TCFG, "cpu")}
    else:
        # each rank converts only its shard of the weights and the bank
        kw = {"shard_params": True, "lora_shard": SimpleNamespace(
            tree={t: (np.asarray(A), np.asarray(B))
                  for t, (A, B) in BANK.tree.items()},
            names=list(BANK.names), scale=float(BANK.scale))}
    got = _world(tmp_path, tp_targets.lora_batch, engine_kw=kw,
                 prompts=prompts, aids=aids, n_steps=6)
    want = _jax_lora_tokens(prompts, aids, 6)
    assert got["batch"] == want
    assert got["alone"] == want
    # the adapters differ from the base model (else this tests nothing)
    assert want[1] != dense_greedy(prompts[1], 6) or \
        want[2] != dense_greedy(prompts[2], 6)


def test_serving_server_over_a_tp_leader_with_a_bank(tmp_path):
    """A ``ServingServer`` over a tp=2 leader engine built with ``lora=``:
    ``/v1/models`` lists the base and the adapters, and a completion per
    adapter name gives the JAX engine's tokens with that adapter."""
    names = ["tiny-lora"] + BANK.names[1:]
    got = _world(tmp_path, tp_targets.lora_http,
                 engine_kw={"lora": bank_from_jax(BANK, TCFG, "cpu")},
                 prompt=PROMPT, n_steps=5, names=names)
    assert got["models"] == names
    for aid, (status, toks) in enumerate(got["tokens"]):
        assert status == 200, toks
        assert toks == _jax_lora_tokens([PROMPT], [aid], 5)[0], aid


# ---- serve --tp 2 with speculation over HTTP ----

def _get(port, path):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", path)
    r = c.getresponse()
    return r.read().decode()


def _post(port, body):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request("POST", "/v1/completions", json.dumps(body))
    r = c.getresponse()
    return r.status, json.loads(r.read())


@pytest.mark.parametrize("flags", [["--ngram-spec", "--spec-k", "4"],
                                   ["--draft-model", "tiny", "--spec-k", "3"]],
                         ids=["ngram", "draft"])
def test_serve_tp_speculation_answers(flags):
    """``serve --tp 2 --device cpu --dist-backend gloo --model tiny`` with
    ``--ngram-spec`` or ``--draft-model tiny`` answers greedy completions
    through the speculative fast path (``istpu_spec_rounds_total`` > 0),
    the ranks agree on every token, and the tokens equal a tp=1 port
    engine's plain decode of the CLI's weights within bf16's rank rule."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "infinistore_tpu_torch.serve", "--model",
         "tiny", "--device", "cpu", "--tp", "2", "--dist-backend", "gloo",
         "--port", str(port), "--n-blocks", "64", "--kv-quant", "none",
         *flags], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 90
        while True:
            try:
                _get(port, "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.time() < deadline, "serve never came up"
                time.sleep(0.5)
        prompt = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
        status, body = _post(port, {"prompt": prompt, "max_tokens": 10,
                                    "temperature": 0})
        assert status == 200, body
        got = body["choices"][0]["token_ids"]
        assert len(got) == 10
        rounds = [line for line in _get(port, "/metrics").splitlines()
                  if line.startswith("istpu_spec_rounds_total")]
        assert rounds and float(rounds[0].split()[1]) >= 1
        ranks = json.loads(_get(port, "/debug/engine?limit=0"))["tp"][
            "ranks"]
        assert [r["rank"] for r in ranks] == [0, 1]
        assert ranks[0]["tokens"] == ranks[1]["tokens"]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    from infinistore_tpu_torch.serve import load_model

    cfg, params, _ = load_model("tiny", torch.device("cpu"))
    ref = InferenceEngine(params, cfg, PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_blocks=64, block_tokens=16,
        dtype=cfg.dtype), kv_quant=None, device="cpu")
    want = ref.decode(ref.prefill(prompt), 10)
    if got != want:
        # bf16: a differing token is within the teacher-forced top 2
        from infinistore_tpu_torch.models import prefill_forward

        logits, _ = prefill_forward(params, cfg, torch.tensor([prompt + got]))
        for j, g in enumerate(got):
            row = logits[0, len(prompt) + j - 1].float()
            assert int((row > row[g]).sum()) < 2, (j, g)
