"""Sequence-parallel prefill on the CPU: ``parallel/ring.py`` (ring
attention, the K/V blocks rotating around an sp group) against the JAX
package's ``make_ring_attention`` and against dense causal attention, and
``make_sp_prefill`` at sp=2 x tp=2 against the JAX ``prefill_forward``, its
KV adopted into a port engine (``tests/test_parallel.py:55,458,488``).

Each group is a spawned gloo world (``tp_world.py``, ranks running
``tp_targets.py``); the JAX side runs on the virtual 8-device host mesh in
this process.  float32, the reference's own tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tp_targets
from infinistore_tpu.engine import InferenceEngine as JEngine
from infinistore_tpu.kv import PagedCacheConfig as JPC
from infinistore_tpu.models import LlamaConfig, init_params, prefill_forward
from infinistore_tpu.models.attention import causal_attention
from infinistore_tpu.parallel import MeshShape, make_mesh
from infinistore_tpu.parallel import make_ring_attention as j_ring
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.models import LlamaConfig as TLlamaConfig
from tp_world import run_world

# the reference's sp cases' config (tests/test_parallel.py:40)
CFG = LlamaConfig(vocab_size=256, dim=64, n_layers=4, n_heads=8,
                  n_kv_heads=4, ffn_dim=128, dtype=jnp.float32)
TCFG = TLlamaConfig(vocab_size=256, dim=64, n_layers=4, n_heads=8,
                    n_kv_heads=4, ffn_dim=128, dtype=torch.float32)
PARAMS = init_params(CFG, jax.random.PRNGKey(7))
TREE = jax.tree.map(np.asarray, PARAMS)


def _qkv(B, S, H, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("sp,Hkv", [(2, 2), (4, 2), (4, 4)],
                         ids=["sp2-gqa", "sp4-gqa", "sp4-mha"])
def test_ring_attention_matches_jax_and_dense(tmp_path, sp, Hkv):
    """Ring attention over an sp group: the whole output on every rank
    equals JAX's ``make_ring_attention`` on an sp mesh and dense causal
    attention (``atol=2e-5``, the reference's), and each rank's
    ``ring_attention_local`` is its chunk of it."""
    q, k, v = _qkv(2, 64, 4, Hkv, 16, seed=sp * 10 + Hkv)
    outs = run_world(tp_targets.ring_shard, sp, tmp_path, q, k, v)
    mesh = make_mesh(MeshShape(sp=sp), devices=jax.devices()[:sp])
    with jax.set_mesh(mesh):
        want = np.asarray(j_ring(mesh, "sp")(q, k, v))
    dense = np.asarray(causal_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v)))
    np.testing.assert_allclose(want, dense, atol=2e-5)
    w = q.shape[1] // sp
    for r, (whole, mine) in enumerate(outs):
        np.testing.assert_allclose(whole, want, atol=2e-5)
        np.testing.assert_allclose(whole, dense, atol=2e-5)
        np.testing.assert_array_equal(mine, whole[:, r * w:(r + 1) * w])


def test_sp_prefill_matches_dense(tmp_path):
    """``make_sp_prefill`` at sp=2 x tp=2: logits (``atol=2e-4``) and the
    serving-contract KV (post-RoPE K, ``atol=2e-5``) of JAX
    ``prefill_forward``, whole on every rank; ``S % sp != 0`` raises."""
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(8), (2, 32), 0, CFG.vocab_size), np.int32)
    ref_logits, ref_kv = prefill_forward(PARAMS, CFG, jnp.asarray(tokens))
    outs = run_world(tp_targets.sp_prefill, 4, tmp_path, TREE, TCFG, tokens,
                     {"sp": 2, "tp": 2})
    for out in outs:
        np.testing.assert_allclose(out["logits"], np.asarray(ref_logits),
                                   atol=2e-4)
        np.testing.assert_allclose(out["kv"], np.asarray(ref_kv), atol=2e-5)
    odd = tmp_path / "odd"
    odd.mkdir()
    with pytest.raises(RuntimeError, match="S % sp == 0"):
        run_world(tp_targets.sp_prefill, 2, odd, TREE, TCFG, tokens[:, :31],
                  {"sp": 2})


def test_sp_prefill_kv_pages_into_engine_decode(tmp_path):
    """The sp=2 x tp=2 prefill's KV adopted into a port engine
    (``InferenceEngine.adopt_prefill``) decodes the JAX engine's greedy
    tokens of the same prompt, and releasing the state returns every
    page."""
    T = 4
    prompt = [int(t) for t in
              np.random.RandomState(9).randint(1, CFG.vocab_size, 32)]
    jpc = JPC(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
              head_dim=CFG.head_dim, n_blocks=64, block_tokens=T,
              dtype=jnp.float32)
    ref = JEngine(PARAMS, CFG, jpc, kv_quant=None)
    want = ref.decode(ref.prefill(prompt), 8)
    tpc = PagedCacheConfig(n_layers=TCFG.n_layers,
                           n_kv_heads=TCFG.n_kv_heads,
                           head_dim=TCFG.head_dim, n_blocks=64,
                           block_tokens=T, dtype=torch.float32)
    tmp = tmp_path / "world"
    tmp.mkdir()
    out = run_world(tp_targets.sp_prefill, 4, tmp, TREE, TCFG,
                    np.asarray([prompt], np.int32), {"sp": 2, "tp": 2},
                    pc=tpc, n_steps=8)[0]
    assert out["tokens"] == want
    assert out["free_pages"] == tpc.n_blocks
