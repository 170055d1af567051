"""Tensor-parallel serving on the CPU: the port's ``parallel/`` against the
JAX package's sharded cases (``tests/test_parallel.py``).

The JAX side runs on the 8-device virtual CPU mesh ``conftest.py`` sets
up, with ``ISTPU_PALLAS_INTERPRET=1`` where a ``_tp`` composition must be
traced; the port's side runs in spawned gloo worlds (``tp_world.py``), one
process per rank, on the same seeded weights (``init_params``, converted
by ``params_from_jax``), in float32.  Tolerances are the reference cases'
own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tp_targets
from infinistore_tpu.engine.engine import InferenceEngine as JEngine
from infinistore_tpu.kv.cache import PagedCacheConfig as JPC
from infinistore_tpu.kv.cache import init_cache as j_init_cache
from infinistore_tpu.models.llama import LlamaConfig as JLlamaConfig
from infinistore_tpu.models.llama import decode_forward as j_decode_forward
from infinistore_tpu.models.llama import init_params, prefill_forward
from infinistore_tpu.models.llama import scaled as jscaled
from infinistore_tpu.parallel import factor_devices as j_factor_devices
from infinistore_tpu.parallel import make_mesh as j_make_mesh
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.models.llama import LlamaConfig
from infinistore_tpu_torch.models.llama import scaled as tscaled
from infinistore_tpu_torch.parallel import MeshShape, factor_devices
from tp_world import run_world

# fp32 everywhere: bf16 rounding would swamp the sharded-vs-dense comparison
CFG = JLlamaConfig(vocab_size=256, dim=64, n_layers=4, n_heads=8,
                   n_kv_heads=4, ffn_dim=128, dtype=jnp.float32)
TCFG = LlamaConfig(vocab_size=256, dim=64, n_layers=4, n_heads=8,
                   n_kv_heads=4, ffn_dim=128, dtype=torch.float32)


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _pcs(cfg, tcfg, n_blocks, T=4):
    return (JPC(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, n_blocks=n_blocks, block_tokens=T,
                dtype=jnp.float32),
            PagedCacheConfig(n_layers=tcfg.n_layers,
                             n_kv_heads=tcfg.n_kv_heads,
                             head_dim=tcfg.head_dim, n_blocks=n_blocks,
                             block_tokens=T, dtype=torch.float32))


@pytest.mark.parametrize("caps", [(0, 0, 0), (2, 0, 0), (4, 2, 0),
                                  (0, 0, 2), (8, 4, 2)])
def test_factor_devices(caps):
    """``tests/test_parallel.py:47``: the port's factorization is the
    reference's, for 1..64 devices under each cap."""
    max_tp, max_sp, max_pp = caps
    for n in range(1, 65):
        got = factor_devices(n, max_tp, max_sp, max_pp)
        want = j_factor_devices(n, max_tp, max_sp, max_pp)
        assert got.as_tuple() == want.as_tuple(), n
        assert got.n_devices == n
    assert factor_devices(8) == MeshShape(dp=1, pp=2, sp=2, tp=2)


def test_tp_prefill_matches_dense(tmp_path):
    """``:198``: ``make_tp_prefill`` over 4 ranks; logits whole on every
    rank at atol 2e-4, the KV head shards concatenated at atol 2e-5."""
    params = init_params(CFG, jax.random.PRNGKey(7))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(8), (2, 16),
                                           0, CFG.vocab_size), np.int32)
    ref_logits, ref_kv = prefill_forward(params, CFG, jnp.asarray(tokens))
    out = run_world(tp_targets.forward_shard, 4, tmp_path, _tree(params),
                    TCFG, "prefill", {"tokens": tokens})
    for logits, _ in out:
        np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=2e-4)
    kv = np.concatenate([kv for _, kv in out], axis=4)  # [L, 2, B, S, H, D]
    np.testing.assert_allclose(kv, np.asarray(ref_kv), atol=2e-5)


def test_tp_decode_matches_dense(tmp_path):
    """``:214``: ``make_tp_decode`` over 4 ranks; logits at atol 2e-4, the
    cache head shards concatenated at atol 2e-5."""
    params = init_params(CFG, jax.random.PRNGKey(9))
    pc = JPC(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
             head_dim=CFG.head_dim, n_blocks=8, block_tokens=4,
             dtype=jnp.float32)
    inputs = {
        "tokens": np.asarray([5, 9], np.int32),
        "positions": np.asarray([0, 0], np.int32),
        "table": np.asarray([[0, 0], [1, 0]], np.int32),
        "seq_lens": np.asarray([1, 1], np.int32),
        "slot_blocks": np.asarray([0, 1], np.int32),
        "slots": np.asarray([0, 0], np.int32),
    }
    ref_logits, ref_cache = j_decode_forward(
        params, CFG, *(jnp.asarray(inputs[k]) for k in (
            "tokens", "positions")), j_init_cache(pc),
        *(jnp.asarray(inputs[k]) for k in (
            "table", "seq_lens", "slot_blocks", "slots")))
    out = run_world(tp_targets.forward_shard, 4, tmp_path, _tree(params),
                    TCFG, "decode", {**inputs, "n_blocks": 8,
                                     "block_tokens": 4})
    for logits, _ in out:
        np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=2e-4)
    cache = np.concatenate([c for _, c in out], axis=2)
    np.testing.assert_allclose(cache, np.asarray(ref_cache), atol=2e-5)


def test_sharded_engine_matches_unsharded(tmp_path):
    """``:250``: the serving engine over 4 ranks (chunked prefill, paged
    decode, sampling on every rank) emits the JAX single-device engine's
    greedy tokens, then a batched decode of two lengths."""
    params = init_params(CFG, jax.random.PRNGKey(11))
    jpc, tpc = _pcs(CFG, TCFG, 64)
    prompt = [int(t) for t in
              np.random.RandomState(3).randint(1, CFG.vocab_size, 11)]
    ref = JEngine(params, CFG, jpc)
    want = ref.decode(ref.prefill(prompt), 12)
    ref_b = JEngine(params, CFG, jpc)
    sa, sb = ref_b.prefill(prompt), ref_b.prefill(prompt[:5])
    want_b = ref_b.decode_batch([sa, sb], 8)
    out = run_world(tp_targets.engine_world, 4, tmp_path, _tree(params),
                    TCFG, tpc, tp_targets.decode,
                    {"kv_quant": None, "prefill_chunk": 4},
                    script_kw={"prompt": prompt, "n_steps": 12,
                               "batch": [prompt, prompt[:5]]})
    assert out[0]["tokens"] == want
    assert out[0]["batch"] == want_b


def _decode_inputs(B=2, H=8, Hkv=4, D=16, T=4, n_blocks=16, max_pages=3):
    rng = np.random.RandomState(0)
    return {
        "q": rng.randn(B, H, D).astype(np.float32),
        "cache": rng.randn(2, Hkv, n_blocks, T, D).astype(np.float32),
        "table": rng.randint(0, n_blocks, size=(B, max_pages)).astype(
            np.int32),
        "lens": np.asarray([11, 5], np.int32),
    }


def test_tp_pallas_decode_matches_xla(tmp_path):
    """``:289``: the port's ``paged_decode_attention_tp`` on each of 2
    ranks' head shards, gathered, against the reference's
    ``paged_decode_attention_tp(..., interpret=True)`` on a tp=2 mesh, at
    atol 2e-5."""
    from infinistore_tpu.models.attention import paged_decode_attention_tp

    a = _decode_inputs()
    mesh = j_make_mesh(tp=2)
    with jax.set_mesh(mesh):
        want = jax.jit(lambda q, c, t, s: paged_decode_attention_tp(
            q, c, t, s, mesh, interpret=True))(
            *(jnp.asarray(a[k]) for k in ("q", "cache", "table", "lens")))
    out = run_world(tp_targets.composition_shard, 2, tmp_path, "decode", a,
                    {})
    np.testing.assert_allclose(np.concatenate(out, axis=1),
                               np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("kind", ["causal", "prefix"])
def test_tp_flash_attention_matches_reference(tmp_path, kind):
    """The K3 and K2 counterparts of ``:289``: the port's
    ``flash_causal_attention_tp`` on each of 2 ranks' head shards,
    gathered, against the reference's (interpret mode, tp=2 mesh) at atol
    2e-5; with a ``prefix_len`` (K2) over a padded prefix of 128 rows of
    which 70 are valid."""
    from infinistore_tpu.models.attention import flash_causal_attention_tp

    rng = np.random.RandomState(1)
    B, Sq, H, Hkv, D = 1, 32, 4, 2, 128
    pad = 128 if kind == "prefix" else 0
    a = {"q": rng.randn(B, Sq, H, D).astype(np.float32),
         "k": rng.randn(B, pad + Sq, Hkv, D).astype(np.float32),
         "v": rng.randn(B, pad + Sq, Hkv, D).astype(np.float32)}
    if kind == "prefix":
        jkw = {"prefix_pad": pad, "prefix_len": jnp.asarray(70, jnp.int32)}
        tkw = {"q_offset": pad, "prefix_pad": pad, "prefix_len": 70}
    else:
        jkw, tkw = {}, {}
    mesh = j_make_mesh(tp=2)
    with jax.set_mesh(mesh):
        want = jax.jit(lambda q, k, v: flash_causal_attention_tp(
            q, k, v, mesh, interpret=True, **jkw))(
            *(jnp.asarray(a[x]) for x in ("q", "k", "v")))
    out = run_world(tp_targets.composition_shard, 2, tmp_path, "prefill", a,
                    tkw)
    np.testing.assert_allclose(np.concatenate(out, axis=2),
                               np.asarray(want), atol=2e-5)


def test_sharded_engine_pallas_tp_decode(tmp_path):
    """``:318``: with ``pallas_tp`` (kept for the reference's signature)
    and ``decode_chunk`` 3, 2 ranks' greedy tokens equal the JAX
    single-device engine's; every rank's decode went through
    ``paged_decode_attention_tp``."""
    params = init_params(CFG, jax.random.PRNGKey(21))
    jpc, tpc = _pcs(CFG, TCFG, 16)
    prompt = [int(t) for t in
              np.random.RandomState(5).randint(1, CFG.vocab_size, 9)]
    ref = JEngine(params, CFG, jpc)
    want = ref.decode(ref.prefill(prompt), 6)
    out = run_world(tp_targets.engine_world, 2, tmp_path, _tree(params),
                    TCFG, tpc, tp_targets.decode,
                    {"kv_quant": None, "pallas_tp": True,
                     "decode_chunk": 3},
                    spy=True, script_kw={"prompt": prompt, "n_steps": 6})
    assert out[0]["tokens"] == want
    for r in out:
        # 6 steps x 4 layers on every rank
        assert r["spy"]["paged_decode_attention_tp"] >= 6 * CFG.n_layers


def test_sharded_engine_pallas_tp_prefill(tmp_path):
    """``:343``: tp prefill at head size 128 over 2 ranks: the prefill's
    logits against the JAX single-device engine's at rtol = atol = 2e-4,
    its decode tokens equal, and every rank's prefill went through
    ``flash_causal_attention_tp``."""
    cfg = JLlamaConfig(vocab_size=256, dim=512, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=128, dtype=jnp.float32)
    tcfg = LlamaConfig(vocab_size=256, dim=512, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=128, dtype=torch.float32)
    params = init_params(cfg, jax.random.PRNGKey(3))
    jpc, tpc = _pcs(cfg, tcfg, 32)
    prompt = [int(t) for t in
              np.random.RandomState(5).randint(1, cfg.vocab_size, 13)]
    ref = JEngine(params, cfg, jpc)
    st = ref.prefill(prompt)
    want_logits = np.asarray(st.last_logits)
    want = ref.decode(st, 6)
    out = run_world(tp_targets.engine_world, 2, tmp_path, _tree(params),
                    tcfg, tpc, tp_targets.prefill_logits,
                    {"kv_quant": None, "pallas_tp": True}, spy=True,
                    script_kw={"prompt": prompt, "n_steps": 6})
    np.testing.assert_allclose(out[0]["logits"], want_logits, rtol=2e-4,
                               atol=2e-4)
    assert out[0]["tokens"] == want
    for r in out:
        assert r["spy"]["flash_causal_attention_tp"] >= cfg.n_layers


def test_sharded_engine_serves_biased_family(tmp_path):
    """``:389``: a Qwen2/3-style model (QKV biases, Q/K norms) over 2
    ranks: each rank holds its head slice of the biases (the norms whole),
    and the tokens equal the JAX single-device engine's."""
    cfg = jscaled(CFG, attn_bias=True, qk_norm=True)
    tcfg = tscaled(TCFG, attn_bias=True, qk_norm=True)
    params = init_params(cfg, jax.random.PRNGKey(13))
    jpc, tpc = _pcs(cfg, tcfg, 32)
    prompt = [int(t) for t in
              np.random.RandomState(5).randint(1, cfg.vocab_size, 9)]
    ref = JEngine(params, cfg, jpc)
    want = ref.decode(ref.prefill(prompt), 10)
    out = run_world(tp_targets.engine_world, 2, tmp_path, _tree(params),
                    tcfg, tpc, tp_targets.decode, {"kv_quant": None},
                    script_kw={"prompt": prompt, "n_steps": 10})
    assert out[0]["tokens"] == want
    hd = cfg.head_dim
    # held bytes: every rank holds half of each head-sharded leaf
    leaf = {"bq": cfg.n_heads * hd, "bk": cfg.n_kv_heads * hd,
            "bv": cfg.n_kv_heads * hd}
    from infinistore_tpu_torch.models import params_from_jax
    from infinistore_tpu_torch.parallel import llama_inference_specs

    shard = params_from_jax(_tree(params), tcfg, "cpu", tp_rank=1, tp=2)
    for k, n in leaf.items():
        assert shard["layers"][k].shape == (cfg.n_layers, n // 2)
        np.testing.assert_array_equal(
            shard["layers"][k].numpy(),
            np.asarray(params["layers"][k])[:, n // 2:])
    for k in ("q_norm", "k_norm"):
        assert shard["layers"][k].shape == (cfg.n_layers, hd)
    assert llama_inference_specs(cfg=tcfg)["layers"]["bq"] == 1
    reports = out[0]["reports"]
    assert reports[0]["held_bytes"] == reports[1]["held_bytes"]
