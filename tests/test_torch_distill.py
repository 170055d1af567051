"""The port's draft distillation (``engine/distill.py``) against the
reference's on the CPU.

TINY float32 target and the reference's 1-layer draft shape, weights from
the reference's ``init_params`` carried across by ``params_from_jax``.
The corpus is held token for token against the reference's (greedy
float32 on the same weights and the same numpy prompt stream); from the
same corpus and initial params, ``distill``'s recorded losses are held to
1e-3 relative of the reference's over 60 steps (float32 SGD whose sums run
in another order drift apart slowly, step by step); ``acceptance_probe``
is held equal to the reference's on the same engines' weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinistore_tpu.engine import InferenceEngine as JEngine
from infinistore_tpu.engine import distill as jdistill
from infinistore_tpu.kv import PagedCacheConfig as JPC
from infinistore_tpu.models import TINY, init_params, scaled
from infinistore_tpu_torch.engine import InferenceEngine
from infinistore_tpu_torch.engine import distill as tdistill
from infinistore_tpu_torch.engine.speculative import SpeculativeDecoder
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.models import TINY as TTINY
from infinistore_tpu_torch.models import params_from_jax
from infinistore_tpu_torch.models import scaled as tscaled
from infinistore_tpu_torch.models.llama import leaves

torch.set_num_threads(2)

LOSS_RTOL = 1e-3
T = 4

CFG = scaled(TINY, dtype=jnp.float32)
TCFG = tscaled(TTINY, dtype=torch.float32)
PARAMS = init_params(CFG, jax.random.PRNGKey(7))
DRAFT_KW = dict(n_layers=1, dim=64, ffn_dim=128)
DCFG = scaled(TINY, dtype=jnp.float32, **DRAFT_KW)
TDCFG = tscaled(TTINY, dtype=torch.float32, **DRAFT_KW)
DRAFT0 = init_params(DCFG, jax.random.PRNGKey(99))


def carried(jparams, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


TPARAMS = carried(PARAMS, TCFG)


def jengine(params, cfg):
    return JEngine(params, cfg, JPC(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_blocks=64, block_tokens=T, dtype=cfg.dtype))


def tengine(params, cfg):
    return InferenceEngine(params, cfg, PagedCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_blocks=64, block_tokens=T,
        dtype=cfg.dtype), device="cpu")


CORPUS_KW = dict(n_seqs=8, prompt_len=8, gen_len=40, batch=4)


@pytest.fixture(scope="module")
def corpus():
    """The reference's corpus (4 rows x 12 pages fit the 64-page pool)."""
    return jdistill.generate_corpus(jengine(PARAMS, CFG), **CORPUS_KW)


@pytest.mark.parametrize("kw", [dict(CORPUS_KW),
                                dict(n_seqs=6, prompt_len=5, gen_len=9,
                                     batch=4, seed=3)],
                         ids=["standard", "ragged-last-batch"])
def test_generate_corpus_matches_reference(kw, corpus):
    want = corpus if kw == CORPUS_KW else \
        jdistill.generate_corpus(jengine(PARAMS, CFG), **kw)
    got = tdistill.generate_corpus(tengine(TPARAMS, TCFG), **kw)
    assert got.dtype == np.int32
    assert got.shape == (kw["n_seqs"], kw["prompt_len"] + kw["gen_len"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distill_losses_match_reference(dtype, corpus):
    """Same corpus, same initial params: the recorded losses (steps 0, 20,
    40, 59) within 1e-3 relative; the params come back in the draft
    config's dtype, the caller's params untouched."""
    jcfg = scaled(DCFG, dtype=getattr(jnp, dtype))
    tcfg = tscaled(TDCFG, dtype=getattr(torch, dtype))
    start = carried(DRAFT0, TDCFG)
    before = [p.clone() for p in leaves(start)]
    jp, jlosses = jdistill.distill(jcfg, corpus, steps=60, batch=4, lr=2e-2,
                                   params=DRAFT0)
    tp, tlosses = tdistill.distill(tcfg, corpus, steps=60, batch=4, lr=2e-2,
                                   params=start, device="cpu")
    assert len(tlosses) == len(jlosses) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tlosses[-1] < tlosses[0]
    assert all(p.dtype == tcfg.dtype and p.device.type == "cpu"
               for p in leaves(tp))
    assert all(str(x.dtype) == dtype for x in jax.tree.leaves(jp))
    assert all(torch.equal(a, b) for a, b in zip(leaves(start), before))


def test_distill_from_its_own_seed_trains():
    """Without params, the draft is drawn from a ``torch.Generator`` of
    ``seed``: the same seed gives the same run, and it trains."""
    corpus = np.random.RandomState(0).randint(1, 512, size=(4, 24)).astype(
        np.int32)
    a, la = tdistill.distill(TDCFG, corpus, steps=21, batch=2, lr=2e-2,
                             seed=5, device="cpu")
    b, lb = tdistill.distill(TDCFG, corpus, steps=21, batch=2, lr=2e-2,
                             seed=5, device="cpu")
    assert la == lb and len(la) == 2 and la[-1] < la[0]
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


@pytest.fixture(scope="module")
def distilled(corpus):
    """The reference's distilled draft (float32)."""
    return jdistill.distill(DCFG, corpus, steps=300, lr=2e-2, batch=8)[0]


@pytest.mark.parametrize("draft", ["random", "distilled"])
def test_acceptance_probe_matches_reference(draft, corpus, distilled):
    jd = DRAFT0 if draft == "random" else distilled
    prompts = [[int(t) for t in corpus[i][:8]] for i in (0, 5)]
    want = jdistill.acceptance_probe(jengine(PARAMS, CFG), jengine(jd, DCFG),
                                     prompts, gen_len=24, k=4)
    got = tdistill.acceptance_probe(tengine(TPARAMS, TCFG),
                                    tengine(carried(jd, TDCFG), TDCFG),
                                    prompts, gen_len=24, k=4)
    assert got == pytest.approx(want, abs=1e-12)
    if draft == "distilled":
        assert got[0] > 0.5


def test_distilled_draft_learns_target_outputs():
    """The port of ``tests/test_speculative.py::
    test_distilled_draft_learns_target_outputs``: corpus from the target's
    own greedy trajectories, a small draft distilled on it (float32 master
    weights); acceptance on a corpus prompt goes to ~1, and the output is
    EXACTLY the target's greedy decode."""
    corpus = tdistill.generate_corpus(tengine(TPARAMS, TCFG), **CORPUS_KW)
    dparams, losses = tdistill.distill(TDCFG, corpus, steps=700, lr=2e-2,
                                       batch=8, params=carried(DRAFT0, TDCFG),
                                       device="cpu")
    assert losses[-1] < 1.0 < losses[0]  # it actually trained

    prompt = [int(t) for t in corpus[0][:8]]
    acc, per_round = tdistill.acceptance_probe(
        tengine(TPARAMS, TCFG), tengine(dparams, TDCFG), [prompt],
        gen_len=32, k=4)
    assert acc > 0.8, acc
    assert per_round > 4.0, per_round

    want = tengine(TPARAMS, TCFG).generate(prompt, 16)
    spec = SpeculativeDecoder(tengine(TPARAMS, TCFG),
                              tengine(dparams, TDCFG), k=4)
    assert spec.generate(prompt, 16) == want


def test_main_runs_on_the_cpu(capsys):
    tdistill.main(["--device", "cpu", "--steps", "20", "--n-seqs", "8",
                   "--gen-len", "16"])
    out = capsys.readouterr().out
    assert "distill losses:" in out and "acceptance:" in out
    assert out.rstrip().endswith("on cpu")


def test_main_without_a_card_raises(monkeypatch):
    """The default device is the card; with none the entry point raises
    before any work (it never carries on on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tdistill.main([])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tdistill.distill(TDCFG, np.zeros((2, 8), np.int32), steps=1)
