"""The port's model math against the reference on the CPU: RoPE with llama3
scaling, the attention dispatcher's plain modes, and whole prefill / decode
forwards with the reference's weights carried across by params_from_jax.

Tolerances: f32 attention 1e-5; whole-model f32 logits and KV 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.kv import cache as jcache
from infinistore_tpu.models import attention as jatt
from infinistore_tpu.models import llama as jllama
from infinistore_tpu_torch.kv import cache as tcache
from infinistore_tpu_torch.models import attention as tatt
from infinistore_tpu_torch.models import llama as tllama
from infinistore_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)

# TINY in f32, a narrow head_dim-128 variant (the kernels' head size), the
# Qwen-style knobs, and the Gemma-2 knobs with a window on alternate layers
# and both soft-caps (which the CPU runs through the plain attention)
VARIANTS = {
    "tiny": {},
    "hd128": dict(dim=256, n_heads=2, n_kv_heads=1),
    "bias_qknorm": dict(attn_bias=True, qk_norm=True),
    "gemma_knobs": dict(act="gelu_tanh", attn_softcap=50.0,
                        final_softcap=30.0, norm_offset=True,
                        post_norms=True, embed_scale=True,
                        query_pre_attn_scalar=24.0, sliding_window=6,
                        window_pattern=2),
}


def _configs(name):
    kw = VARIANTS[name]
    return (jllama.scaled(jllama.TINY, dtype=jnp.float32, **kw),
            tllama.scaled(tllama.TINY, dtype=torch.float32, **kw))


_PARAMS = {}


def _params(name):
    if name not in _PARAMS:
        jcfg, tcfg = _configs(name)
        jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
        # non-trivial norm weights, so the test sees them
        rng = np.random.default_rng(0)
        for k in ("q_norm", "k_norm", "ln_attn", "ln_post_attn"):
            if k in jp["layers"]:
                w = jp["layers"][k]
                jp["layers"][k] = w + jnp.asarray(
                    0.1 * rng.standard_normal(w.shape), jnp.float32)
        _PARAMS[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                             tcfg, "cpu"))
    return _PARAMS[name]


# the reference forwards, compiled once per shape (faster than op-by-op)
j_prefill = jax.jit(jllama.prefill_forward, static_argnames=("cfg",))
j_decode = jax.jit(jllama.decode_forward, static_argnames=("cfg",))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_rope_trig_halves_agree_across_intra_op_threads():
    """The RoPE case's angles (2 rows x 40 positions x 32 frequencies =
    2560 values) through torch's float cos/sin (MKL VML, ``vmsCos`` /
    ``vmsSin`` in high-accuracy mode, ``ATen/cpu/vml.h``), which run in
    chunks over the intra-op threads: at two threads batch row 1, the row
    that drifted by 4.34e-4 in the intermittent failure of the RoPE case
    after the reference's JAX servers ran in the same process, is the
    second chunk, computed off the calling thread (ROADMAP.md queue 3).
    Placed first, so it is the first torch math of the module: each row
    is held against float64 and against the one-thread result, and a
    failure names the row and the thread that computed it."""
    pos = torch.from_numpy(np.stack([np.arange(40), np.arange(40) + 50])
                           .astype(np.int32))
    angles = pos[..., None].float() * tatt.rope_freqs(64, 500000.0, None)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(2)
        two = {"cos": torch.cos(angles), "sin": torch.sin(angles)}
        torch.set_num_threads(1)
        one = {"cos": torch.cos(angles), "sin": torch.sin(angles)}
    finally:
        torch.set_num_threads(threads)
    a64 = angles.double().numpy()
    for name, f in (("cos", np.cos), ("sin", np.sin)):
        for row, who in ((0, "the calling thread"), (1, "the OpenMP worker")):
            err = float(np.abs(two[name][row].double().numpy()
                               - f(a64[row])).max())
            assert err <= 1e-6 and torch.equal(two[name][row],
                                               one[name][row]), (
                f"{name} of batch row {row}, computed by {who} at 2 "
                f"threads, is off float64 by {err}")


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 64)])
def test_apply_rope_equals_reference(scaling):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 64)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(40) + 50]).astype(np.int32)
    want = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0, scaling)
    got = tatt.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          500000.0, scaling)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(tatt.rope_freqs(64, 500000.0, scaling)),
        _np(jatt.rope_freqs(64, 500000.0, scaling)), rtol=1e-6)


@pytest.mark.parametrize("mode", [
    dict(), dict(q_offset=7), dict(prefix_pad=16, prefix_len=11),
    dict(window=5), dict(q_offset=7, softcap=2.0),
    dict(prefix_pad=16, prefix_len=11, window=9),
])
def test_causal_attention_modes_equal_reference(mode):
    rng = np.random.default_rng(len(mode))
    Sq = 12
    Sk = Sq + mode.get("prefix_pad", mode.get("q_offset", 0))
    q = rng.standard_normal((2, Sq, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 32)).astype(np.float32)
    jmode = dict(mode)
    if "prefix_len" in mode:
        jmode["prefix_len"] = jnp.asarray(mode["prefix_len"], jnp.int32)
    want = jatt.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **jmode)
    got = tatt.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **mode)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_paged_decode_dispatcher_window_and_softcap_equal_reference():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 32)).astype(np.float32)
    cache = rng.standard_normal((2, 2, 8, 4, 32)).astype(np.float32)
    table = np.array([[3, 1, 6], [2, 0, 0]], np.int32)
    lens = np.array([11, 3], np.int32)
    for kw in (dict(), dict(window=5), dict(softcap=3.0)):
        want = jatt.paged_decode_attention_xla(
            jnp.asarray(q), jnp.asarray(cache), jnp.asarray(table),
            jnp.asarray(lens), **kw)
        got = tatt.paged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(cache),
            torch.from_numpy(table), torch.from_numpy(lens), **kw)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_forward_equals_reference(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(variant)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 13),
                                             dtype=np.int32)
    jl, jkv = j_prefill(jp, jcfg, jnp.asarray(toks))
    tl, tkv = tllama.prefill_forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tkv), _np(jkv), rtol=1e-4, atol=1e-4)

    # chunked prefill over the first 8 tokens' KV: exact prefix (q_offset)
    # and a padded 16-row bucket holding 8 valid rows (prefix_len)
    _, jkv8 = j_prefill(jp, jcfg, jnp.asarray(toks[:, :8]))
    _, tkv8 = tllama.prefill_forward(tp, tcfg, torch.from_numpy(toks[:, :8]))
    for pad in (8, 16):
        jbuf = jnp.pad(jkv8, ((0, 0),) * 3 + ((0, pad - 8),) + ((0, 0),) * 2)
        tbuf = torch.nn.functional.pad(tkv8, (0, 0, 0, 0, 0, pad - 8))
        plen = None if pad == 8 else 8
        jl2, jkv2 = j_prefill(
            jp, jcfg, jnp.asarray(toks[:, 8:]), prefix_kv=jbuf,
            prefix_len=None if plen is None else jnp.asarray(plen, jnp.int32))
        tl2, tkv2 = tllama.prefill_forward(
            tp, tcfg, torch.from_numpy(toks[:, 8:]), prefix_kv=tbuf,
            prefix_len=plen)
        np.testing.assert_allclose(_np(tl2), _np(jl2), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(tkv2), _np(jkv2), rtol=1e-4, atol=1e-4)
        # and the chunked logits equal the one-shot ones
        np.testing.assert_allclose(_np(tl2), _np(tl)[:, 8:], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_forward_equals_reference(variant):
    jcfg, tcfg = _configs(variant)
    jp, tp = _params(variant)
    T, n_blocks = 4, 12
    rng = np.random.default_rng(5)
    cache = rng.standard_normal(
        (jcfg.n_layers, 2, jcfg.n_kv_heads, n_blocks, T, jcfg.head_dim)
    ).astype(np.float32)
    # rows 0/1 real (positions 9 and 2), row 2 a pad row
    table = np.array([[4, 7, 1, 0], [9, 0, 0, 0], [n_blocks] * 4], np.int32)
    pos = np.array([9, 2, 0], np.int32)
    toks = np.array([5, 77, 0], np.int32)
    slot_blocks = table[np.arange(3), pos // T]
    args = (pos, None, table, pos + 1, slot_blocks, pos % T)
    jl, jc = j_decode(
        jp, jcfg, jnp.asarray(toks), *[jnp.asarray(cache) if a is None
                                       else jnp.asarray(a) for a in args])
    tc = torch.from_numpy(cache.copy())
    tl, tc2 = tllama.decode_forward(
        tp, tcfg, torch.from_numpy(toks), *[tc if a is None
                                            else torch.from_numpy(a)
                                            for a in args])
    assert tc2 is tc  # updated in place
    np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-4, atol=1e-4)


def test_init_params_layout_and_scale():
    cfg = tllama.scaled(tllama.TINY, dtype=torch.float32, attn_bias=True)
    p = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jllama.init_params(jllama.scaled(jllama.TINY, attn_bias=True),
                            jax.random.PRNGKey(0))
    assert set(p) == set(jp) and set(p["layers"]) == set(jp["layers"])
    for k, v in jp["layers"].items():
        assert tuple(p["layers"][k].shape) == v.shape, k
    # normal / sqrt(fan_in): wq's std is ~1/sqrt(dim)
    std = float(p["layers"]["wq"].std())
    assert abs(std * np.sqrt(cfg.dim) - 1.0) < 0.05
    assert float(p["ln_out"].min()) == float(p["ln_out"].max()) == 1.0
