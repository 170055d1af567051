"""The fleet's device half on the card: two engines of one process that
capture their decode graphs at once count only their own kernel calls, and
the ``TINY`` model the fleet examples serve (head size 32) runs on the card
through the hand-written kernels.

Every test here needs a CUDA device and skips without one.  This file
imports torch and the port only, so on the GPU machine it runs as:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_fleet.py
"""

import threading
import traceback

import pytest
import torch

from infinistore_tpu_torch.ops import cuda_attention as ca

pytestmark = pytest.mark.cuda

_PROMPTS = [list(range(3, 40)), [7] * 5, list(range(100, 170)),
            [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _parts(cfg, dev, n_blocks=96, T=16):
    from infinistore_tpu_torch.kv import PagedCacheConfig
    from infinistore_tpu_torch.models import init_params

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.head_dim, n_blocks=n_blocks,
                          block_tokens=T, dtype=cfg.dtype)
    return params, pc


def test_two_engines_capturing_at_once_count_their_own_launches(dev):
    """Two engines on two threads run their first decode (one eager step,
    a capture, replays) at the same time, over and over with fresh keys:
    each captured graph records one K1 per layer, whatever the other
    thread captured meanwhile, and the global K1 count is the sum of the
    two threads' counts."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import TINY, scaled

    cfg = scaled(TINY, dim=512, n_heads=4, n_kv_heads=2, ffn_dim=1024,
                 dtype=torch.bfloat16)
    params, pc = _parts(cfg, dev)
    engines = [InferenceEngine(params, cfg, pc, decode_chunk=4, device=dev)
               for _ in range(2)]
    barrier = threading.Barrier(2, timeout=120)
    errors = []
    idents = [None, None]

    def run(i):
        try:
            idents[i] = threading.get_ident()
            eng = engines[i]
            # a new batch bucket each round; no device-wide synchronize
            # here, which would reach into the other thread's capture
            for n_rows in (1, 2, 3, 4):
                states = [eng.prefill(p) for p in _PROMPTS[:n_rows]]
                barrier.wait()
                eng.decode_batch(states, 6)  # returns host tokens
                for st in states:
                    eng.release(st)
        except BaseException:  # reported below
            errors.append(traceback.format_exc())
            barrier.abort()

    ca.reset_launches()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, "\n".join(errors)
    for eng in engines:
        assert eng.graph_captures >= 3
        for g in eng._graphs.values():
            if g.graph is not None:
                assert g.captured == {"paged_decode": cfg.n_layers}, g.key
    launches = dict(ca.LAUNCHES)
    mine = [ca.BY_THREAD[i] for i in idents]
    assert all(launches[k] == mine[0][k] + mine[1][k] for k in launches)
    # each engine: every key's eager first step and every replay
    for eng, m in zip(engines, mine):
        assert m["paged_decode"] == cfg.n_layers * (
            eng.graph_replays + eng.graph_captures)
    ca.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiny_serves_on_the_card_through_the_kernels(dev, dtype):
    """TINY (head size 32) on the card launches K3 (a cold first chunk),
    K2 (the later chunks over their prefix) and K1 (the decode graphs'
    replays), and agrees with the same model on the CPU, where the plain
    versions run: float32 greedy tokens equal, bf16 first-token logits
    cosine >= 0.999 and max error <= 2e-2 of max |logit|."""
    from infinistore_tpu_torch.engine import InferenceEngine
    from infinistore_tpu_torch.models import TINY, scaled

    cfg = scaled(TINY, dtype=dtype)
    assert cfg.head_dim == 32
    cpu = torch.device("cpu")
    params, pc = _parts(cfg, cpu)
    got = {}
    for d in (cpu, dev):
        ca.reset_launches()
        eng = InferenceEngine({k: (v.to(d) if k != "layers" else
                                   {n: t.to(d) for n, t in v.items()})
                               for k, v in params.items()},
                              cfg, pc, prefill_chunk=32, decode_chunk=4,
                              device=d)
        states = [eng.prefill(p) for p in _PROMPTS]
        first = states[2].last_logits.float().cpu()
        toks = eng.decode_batch(states, 9)
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert eng.graph_replays > 0
        got[d.type] = (first, toks, dict(ca.LAUNCHES))
    assert not any(got["cpu"][2].values())
    launches = got["cuda"][2]
    assert all(launches[k] > 0 for k in ("flash_causal", "flash_prefix",
                                         "paged_decode")), launches
    if dtype == torch.float32:
        assert got["cuda"][1] == got["cpu"][1]
    ref, card = got["cpu"][0], got["cuda"][0]
    cos = torch.nn.functional.cosine_similarity(ref, card, dim=0).item()
    err = (ref - card).abs().max().item()
    assert cos >= 0.999 and err <= 2e-2 * ref.abs().max().item(), (cos, err)
    ca.reset_launches()
