"""The port's last two entry points, ``examples/serving.py`` and
``examples/long_context.py`` (counterparts of the reference's
``examples/serving.py`` and ``examples/long_context.py``), run on the CPU
at TINY in float32, held against the reference examples' own paths on the
same weights: TINY drawn as they draw it (``init_params`` on
``jax.random.PRNGKey(0)``) and given to the port by ``params_from_jax``.

``serving``: a scheduler over greedy, sampled and streamed requests, then a
second engine adopting the first one's prefix from the port's store
server; the greedy and streamed answers equal the JAX scheduler's over the
same submissions.  ``long_context``: ``make_sp_prefill`` over a spawned
gloo world, ``adopt_prefill``, paged decode; the sp prefill's logits and
KV are held against the JAX ``make_sp_prefill`` on an sp x tp mesh
(``JAX_LOGITS_ATOL``/``JAX_KV_ATOL``, the reference's sp tolerances of
``tests/test_parallel.py``) and against a single-device port
``prefill_forward`` within ``LOGITS_ATOL`` (ring attention sums the blocks
in another order), and the adopted decode's tokens against the JAX
engine's adopted decode and the port engine's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.engine import InferenceEngine as JEngine
from infinistore_tpu.engine import Scheduler as JScheduler
from infinistore_tpu.kv import PagedCacheConfig as JPC
from infinistore_tpu.models import TINY as JTINY
from infinistore_tpu.models import init_params as j_init_params
from infinistore_tpu.models import scaled as j_scaled
from infinistore_tpu.parallel import MeshShape, make_mesh
from infinistore_tpu.parallel.sharding import (llama_inference_specs,
                                               make_sp_prefill, shard_params)
from infinistore_tpu_torch.examples import long_context, serving
from infinistore_tpu_torch.models import TINY, prefill_forward, scaled
from infinistore_tpu_torch.models.convert import params_from_jax
from test_torch_engine import _port_files
from test_torch_frontdoor import port_store

LOGITS_ATOL = 1e-4
JAX_LOGITS_ATOL = 2e-4
JAX_KV_ATOL = 2e-5

JCFG = j_scaled(JTINY, dtype=jnp.float32)
JPARAMS = j_init_params(JCFG, jax.random.PRNGKey(0))


def _port_params():
    return params_from_jax(jax.tree.map(np.asarray, JPARAMS),
                           scaled(TINY, dtype=torch.float32), "cpu")


def _jax_serving() -> dict:
    """The reference example's scheduler run (``examples/serving.py``) at
    float32, without a store: each request's tokens by name."""
    eng = JEngine(JPARAMS, JCFG, JPC(
        n_layers=JCFG.n_layers, n_kv_heads=JCFG.n_kv_heads,
        head_dim=JCFG.head_dim, block_tokens=16, n_blocks=256,
        dtype=jnp.float32), prefill_chunk=64)
    sched = JScheduler(eng, max_batch=4)
    prompts = {"a": list(range(1, 40)), "b": list(range(1, 12)),
               "c": [7, 99, 404, 42]}
    ids = {name: sched.submit(p, 32) for name, p in prompts.items()}
    ids["sampled"] = sched.submit(prompts["a"], 32, sample="categorical",
                                  temperature=0.8, top_k=40)
    ids["streamed"] = sched.submit(prompts["b"], 16,
                                   on_token=lambda toks, done: None)
    out = sched.run()
    return {name: out[rid] for name, rid in ids.items()}


def test_serving_example_reuses_the_prefix_through_the_store():
    with port_store() as (service, _manage):
        out = serving.main(["--service-port", str(service), "--device",
                            "cpu"], params=_port_params())
    assert out["requests"] == 5
    assert out["reused_chunks"] > 0
    # prompt 'a' is 39 tokens: two whole 16-token chunks leave a tail
    assert out["reused_chunks"] == (39 - 1) // 16
    assert out["streamed"][-1] == (0, True)
    assert sum(n for n, _done in out["streamed"]) == 16
    assert [len(out["outputs"][k]) for k in ("a", "b", "c", "sampled")] \
        == [32] * 4
    # every greedy answer is the reference scheduler's on the same weights
    want = _jax_serving()
    for name in ("a", "b", "c", "streamed"):
        assert out["outputs"][name] == want[name], name
    assert out["outputs"]["streamed"] == out["outputs"]["b"][:16]


def test_serving_example_runs_without_a_store():
    out = serving.main(["--device", "cpu"])
    assert out["requests"] == 5 and out["reused_chunks"] is None


def _jax_long_context(prompt, sp, tp, new_tokens):
    """The reference example's path (``examples/long_context.py``):
    the JAX ``make_sp_prefill`` on an sp x tp mesh of the host's virtual
    devices, its KV adopted by a JAX engine and decoded."""
    mesh = make_mesh(MeshShape(sp=sp, tp=tp), devices=jax.devices()[:sp * tp])
    with jax.set_mesh(mesh):
        sharded = shard_params(JPARAMS, mesh,
                               specs=llama_inference_specs(cfg=JCFG))
        logits, kv = make_sp_prefill(JCFG, mesh)(
            sharded, jnp.asarray([prompt], jnp.int32))
        logits, kv = np.asarray(logits), np.asarray(kv)
    eng = JEngine(JPARAMS, JCFG, JPC(
        n_layers=JCFG.n_layers, n_kv_heads=JCFG.n_kv_heads,
        head_dim=JCFG.head_dim, block_tokens=16,
        n_blocks=len(prompt) // 16 + new_tokens // 16 + 8,
        dtype=jnp.float32))
    st = eng.adopt_prefill(prompt, jnp.asarray(kv), jnp.asarray(logits)[0, -1])
    return logits, kv, eng.decode(st, new_tokens)


@pytest.mark.parametrize("tp", [1, 2])
def test_long_context_example_matches_a_single_device_forward(tp):
    params = _port_params()
    out = long_context.run(["--device", "cpu", "--sp", "2", "--tp", str(tp),
                            "--seq", "136", "--new-tokens", "8"],
                           params=params)
    prompt = out["prompt"]
    assert len(prompt) == 128  # cut to whole pages on both shards
    logits, kv, tokens = _jax_long_context(prompt, 2, tp, 8)
    np.testing.assert_allclose(out["logits"].numpy(), logits,
                               atol=JAX_LOGITS_ATOL)
    np.testing.assert_allclose(out["kv"].numpy(), kv, atol=JAX_KV_ATOL)
    assert out["tokens"] == tokens
    assert len(out["tokens"]) == 8
    # and the port's own single-device forward and engine
    logits, kv = prefill_forward(params, out["cfg"], torch.tensor([prompt]))
    torch.testing.assert_close(out["logits"], logits, rtol=0,
                               atol=LOGITS_ATOL)
    torch.testing.assert_close(out["kv"], kv, rtol=0, atol=LOGITS_ATOL)
    assert out["tokens"] == out["want"]


def test_the_examples_are_port_modules():
    """Both examples are among the modules
    ``test_port_imports_neither_jax_nor_the_reference`` imports and
    scans."""
    names = {p.name for p in _port_files()
             if p.parent.name == "examples"}
    assert {"serving.py", "long_context.py"} <= names
