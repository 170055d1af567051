"""The port's compiled chunked prefill on the CPU: every chunk goes through
the prefill-graph body (``InferenceEngine._prefill_chunk``) over its key's
static buffers, with the prefix length as a 0-d int32 tensor, exactly the
body a CUDA graph captures on the card.  Held against the JAX engine's
``prefill_step`` on the same prompts and weights (carried across by
``params_from_jax``):

* f32 TINY: greedy tokens equal, last-row logits within 1e-4 (the two
  frameworks sum the same f32 products in other orders) and the written
  KV pages within 1e-5;
* bf16 TINY: last-row logits within 3e-2 * max|logit| and cosine >= 0.999
  (each framework rounds the products and activations to bf16 at its own
  points, 8 mantissa bits: the two frameworks' whole-prompt forwards of this
  input already differ by 2.15% of max|logit|), and within one bf16 step of
  max|logit| of the port's own whole-prompt forward.

Also: two partial prefills interleaved chunk by chunk give what each gives
alone, the graph keys and their buffers stay a handful however many prompt
lengths arrive, the whole prompt (``prefill_chunk`` None) runs in one
forward at its own length, and the plain K2 with a tensor ``prefix_len`` is ``torch.equal`` to its
host-int form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.engine import InferenceEngine as JEngine
from infinistore_tpu.kv import PagedCacheConfig as JPC
from infinistore_tpu.models import TINY, init_params, scaled
from infinistore_tpu_torch.engine import InferenceEngine
from infinistore_tpu_torch.kv import PagedCacheConfig, read_pages
from infinistore_tpu_torch.models import params_from_jax, prefill_forward
from infinistore_tpu_torch.models import scaled as tscaled
from infinistore_tpu_torch.models import TINY as TTINY
from infinistore_tpu_torch.ops import cuda_attention as ca

torch.set_num_threads(2)

T = 4    # block tokens
C = 16   # prefill_chunk: 4 pages per chunk
_PARAMS = {}


def _setup(dtype: str):
    if dtype not in _PARAMS:
        jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        cfg = scaled(TINY, dtype=jdt)
        tcfg = tscaled(TTINY, dtype=tdt)
        params = init_params(cfg, jax.random.PRNGKey(5))
        _PARAMS[dtype] = (cfg, tcfg, params, params_from_jax(
            jax.tree.map(lambda a: np.asarray(a, np.float32), params), tcfg,
            "cpu"))
    return _PARAMS[dtype]


def _engines(dtype="f32", n_blocks=96, chunk=C):
    cfg, tcfg, params, tparams = _setup(dtype)
    jpc = JPC(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, n_blocks=n_blocks, block_tokens=T,
              dtype=cfg.dtype)
    tpc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.head_dim, n_blocks=n_blocks,
                           block_tokens=T, dtype=tcfg.dtype)
    return (JEngine(params, cfg, jpc, kv_quant=None, prefill_chunk=chunk),
            InferenceEngine(tparams, tcfg, tpc, device="cpu",
                            prefill_chunk=chunk))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 500, n).tolist()


def _run(engine, tokens):
    """Chunk by chunk through ``prefill_start`` / ``prefill_step``."""
    pp = engine.prefill_start(tokens)
    while True:
        st = engine.prefill_step(pp)
        if st is not None:
            return st


def _pages(engine, st, jax_side: bool) -> np.ndarray:
    n = len(st.tokens) // T
    if jax_side:
        from infinistore_tpu.kv.cache import read_pages as jread
        return np.asarray(jread(engine.cache, jnp.asarray(st.block_ids[:n])),
                          np.float32)
    return read_pages(engine.cache, torch.tensor(st.block_ids[:n])
                      ).float().numpy()


# 1, 2 and 3 chunks, each with a ragged last chunk: 7 tokens (one 8-row
# bucket), 16 + 9 (a 12-token last chunk in a 16-row bucket), 16 + 16 + 5
# (an 8-token last chunk over a 32-row prefix buffer)
COLD = [7, 25, 37]


@pytest.mark.parametrize("n", COLD)
def test_cold_chunked_prefill_equals_reference_f32(n):
    je, te = _engines()
    p = _prompt(n, n)
    js, ts = _run(je, p), _run(te, p)
    np.testing.assert_allclose(ts.last_logits.numpy(),
                               np.asarray(js.last_logits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_pages(te, ts, False), _pages(je, js, True),
                               rtol=1e-5, atol=1e-5)
    assert te.decode(ts, 8) == je.decode(js, 8)
    n_chunks = -(-n // C)
    routes = sorted(k[0] for k in te._prefill_graphs)
    assert routes == ["causal"] + ["prefix"] * (n_chunks - 1)
    for g in te._prefill_graphs.values():
        assert g.graph is None  # the CPU runs the body eagerly
        if g.key[0] == "prefix":
            assert g.plen.dtype == torch.int32 and g.plen.dim() == 0


def test_reused_prefix_takes_the_bucketed_route_f32():
    """A prompt over 3 locally cached pages (12 tokens) and a 25-token tail:
    its first chunk runs K2 over a 16-row buffer holding 12 valid rows, the
    next one over a 32-row buffer."""
    je, te = _engines()
    base = _prompt(12, 1)
    longer = base + _prompt(25, 2)
    for e in (je, te):
        e.release(_run(e, base))
    js, ts = _run(je, longer), _run(te, longer)
    assert ts.reused_chunks == js.reused_chunks == 3
    np.testing.assert_allclose(ts.last_logits.numpy(),
                               np.asarray(js.last_logits), rtol=1e-4,
                               atol=1e-4)
    assert te.decode(ts, 8) == je.decode(js, 8)
    assert {("prefix", 16, 16), ("prefix", 32, 16)} <= set(te._prefill_graphs)


def test_chunked_prefill_bf16_within_tolerance():
    je, te = _engines("bf16")
    p = _prompt(37, 3)
    js, ts = _run(je, p), _run(te, p)
    got = ts.last_logits.float()
    want = torch.from_numpy(np.asarray(js.last_logits, np.float32))
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 3e-2 * scale
    assert torch.nn.functional.cosine_similarity(got, want, dim=0) >= 0.999
    # the chunks through the graph body against the port's own forward of
    # the whole prompt at once: within one bf16 step of max|logit|
    _, tcfg, _, tparams = _setup("bf16")
    padded = p + [0] * ((-len(p)) % T)
    whole, _ = prefill_forward(tparams, tcfg,
                               torch.tensor([padded], dtype=torch.int32))
    torch.testing.assert_close(got, whole[0, len(p) - 1].float(),
                               atol=2 ** -7 * scale, rtol=0)


def test_interleaved_partial_prefills_equal_each_alone():
    """Two 3-chunk prompts share every graph key; stepping them in turns
    (each step brings its own prefix into the key's buffer) gives each one
    the logits, pages and tokens it gets alone."""
    prompts = [_prompt(40, 10), _prompt(38, 11)]
    alone = []
    for p in prompts:
        _, te = _engines()
        st = _run(te, p)
        alone.append((st.last_logits, read_pages(
            te.cache, torch.tensor(st.block_ids[:len(p) // T])),
            te.decode(st, 6)))
    _, te = _engines()
    pps = [te.prefill_start(p) for p in prompts]
    states = [None, None]
    while None in states:
        for i, pp in enumerate(pps):
            if states[i] is None:
                states[i] = te.prefill_step(pp)
    assert len(te._prefill_graphs) == 3  # causal 16, prefix 16, prefix 32
    for p, st, (logits, pages, toks) in zip(prompts, states, alone):
        assert torch.equal(st.last_logits, logits)
        assert torch.equal(read_pages(
            te.cache, torch.tensor(st.block_ids[:len(p) // T])), pages)
        assert te.decode(st, 6) == toks


def test_graph_keys_stay_bounded_across_prompt_lengths():
    """Every prompt length from 1 to 64 tokens: the keys are (route, prefix
    capacity, power-of-two chunk bucket), not one per length."""
    _, te = _engines(n_blocks=256)
    for n in range(1, 65):
        te.release(_run(te, _prompt(n, 100 + n)))
    keys = set(te._prefill_graphs)
    buckets = {4, 8, 16}
    allowed = ({("causal", 0, b) for b in buckets}
               | {("prefix", cap, b) for cap in (16, 32, 64)
                  for b in buckets})
    assert keys <= allowed
    assert len(keys) <= 12
    print(f"prefill graph keys for 64 prompt lengths: {len(keys)}: "
          f"{sorted(keys)}")


def test_graph_buffers_stay_bounded_across_prompt_lengths():
    """The keys share their static buffers: one KV output at the largest
    bucket, one logits row, one length, one prefix buffer per capacity;
    each key adds only its token row."""
    _, te = _engines(n_blocks=256)
    for n in range(1, 65):
        te.release(_run(te, _prompt(n, 200 + n)))
    cfg = te.cfg
    row = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 4  # f32 KV
    caps = {k[1] for k in te._prefill_graphs if k[0] == "prefix"}
    assert caps == {16, 32, 64}
    want = (C * row                          # KV output, 16-row bucket
            + cfg.vocab_size * 4 + 8 + 4     # logits row, row index, length
            + sum(caps) * row                # prefix buffers
            + sum(k[2] for k in te._prefill_graphs) * 4)  # token rows
    _, fresh = _engines(n_blocks=256)
    assert te.held_bytes() - fresh.held_bytes() == want


def test_whole_prompt_route_runs_eagerly_f32():
    """``prefill_chunk`` None (the serve default) computes the whole
    prompt in one forward at its own length: no graph key, no bucket
    padding, and the reference's whole-prompt prefill within 1e-4."""
    je, te = _engines(chunk=None)
    for n in (7, 37):
        p = _prompt(n, 300 + n)
        js, ts = _run(je, p), _run(te, p)
        np.testing.assert_allclose(ts.last_logits.numpy(),
                                   np.asarray(js.last_logits), rtol=1e-4,
                                   atol=1e-4)
        assert te.decode(ts, 6) == je.decode(js, 6)
        for e, st in ((je, js), (te, ts)):
            e.release(st)
    assert not te._prefill_graphs and not te._pf_shared


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_k2_tensor_prefix_len_equals_host_int(dtype):
    pad, Sq = 256, 40
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
               for s in ((1, Sq, 4, 32), (1, pad + Sq, 2, 32),
                         (1, pad + Sq, 2, 32)))
    for plen in (0, 1, 127, 128, 129, pad):
        want = ca.causal_attention_xla(q, k, v, prefix_pad=pad,
                                       prefix_len=plen)
        t = torch.tensor(plen, dtype=torch.int32)
        assert torch.equal(ca.causal_attention_xla(
            q, k, v, prefix_pad=pad, prefix_len=t), want)
        assert torch.equal(ca.flash_prefix_attention_cuda(q, k, v, pad, t),
                           want)


def test_prefill_forward_tensor_prefix_len_equals_host_int():
    """Positions from ``arange(S) + prefix_len`` on the device: the same
    bits as the host-int call, at every valid length of the buffer."""
    _, tcfg, _, tparams = _setup("f32")
    toks = torch.tensor([_prompt(8, 4)], dtype=torch.int32)
    buf = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (tcfg.n_layers, 2, 1, 16, tcfg.n_kv_heads, tcfg.head_dim),
        np.float32))
    for plen in (0, 5, 16):
        want = prefill_forward(tparams, tcfg, toks, prefix_kv=buf,
                               prefix_len=plen)
        got = prefill_forward(tparams, tcfg, toks, prefix_kv=buf,
                              prefix_len=torch.tensor(plen,
                                                      dtype=torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
