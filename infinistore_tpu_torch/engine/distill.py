"""Draft distillation: train a cheap draft on the target's own outputs.

Counterpart of the reference's ``engine/distill.py``.  Speculative
decoding pays only with a draft that agrees with the target; when no
natural small checkpoint exists, the standard recipe is DISTILLATION:
sample trajectories from the target, train the draft with cross-entropy
on them (sequence-level knowledge distillation, Kim & Rush 2016).  This
module is that recipe over the port's engines:

1. ``generate_corpus``: batched greedy trajectories from the target
   engine (``decode_batch``: on the card K3 in prefill, K1 in decode);
2. ``distill``: plain-SGD training of a draft ``LlamaConfig`` on the
   corpus via ``models.llama.train_step_fn`` (float32 master weights, the
   plain attention under autograd, the params updated in place);
3. ``acceptance_probe``: measured greedy agreement between draft and
   target on held-out prompts, by running ``SpeculativeDecoder`` rounds
   (``SpeculativeDecoder`` emits exactly the target's tokens regardless;
   acceptance only sets the speedup).

The random streams are the reference's: prompts from
``np.random.RandomState(seed)``, batch indices from ``RandomState(seed +
1)``, so the same corpus and the same initial params give comparable
losses in the two packages.  Initial weights come from a
``torch.Generator`` (not the reference's ``jax.random`` stream).

    python -m infinistore_tpu_torch.engine.distill --steps 300   # on the card
    python -m infinistore_tpu_torch.engine.distill --device cpu --steps 300
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .engine import InferenceEngine


def generate_corpus(
    target: InferenceEngine,
    n_seqs: int = 32,
    prompt_len: int = 16,
    gen_len: int = 48,
    batch: int = 8,
    seed: int = 0,
) -> np.ndarray:
    """[n_seqs, prompt_len + gen_len] int32: random prompts + the
    target's GREEDY continuations (greedy: the draft must learn the
    argmax function speculation verifies against)."""
    rng = np.random.RandomState(seed)
    V = target.cfg.vocab_size
    rows: List[List[int]] = []
    for lo in range(0, n_seqs, batch):
        b = min(batch, n_seqs - lo)
        prompts = [
            [int(x) for x in rng.randint(1, V, size=prompt_len)]
            for _ in range(b)
        ]
        sts = [target.prefill(p) for p in prompts]
        outs = target.decode_batch(sts, gen_len)
        for p, o, st in zip(prompts, outs, sts):
            rows.append(p + o)
            target.release(st)
    return np.asarray(rows, dtype=np.int32)


def distill(
    draft_cfg,
    corpus: np.ndarray,
    steps: int = 300,
    batch: int = 16,
    lr: float = 3e-3,
    seed: int = 0,
    params=None,
    device=None,
):
    """Train ``draft_cfg`` on the corpus (next-token cross-entropy over
    the full sequences — prompts included, they are context the draft
    must condition on during speculation).  Returns (params, losses) —
    params in ``draft_cfg``'s dtype on ``device`` (``None``: the GPU),
    the loss recorded every 20 steps and at the last.

    ``params``: the draft's initial weights (copied, never updated in
    place); ``None`` draws them from a ``torch.Generator`` seeded
    ``seed``.  Training always runs in float32 regardless of the serving
    dtype: plain-SGD updates at distillation learning rates UNDERFLOW in
    bf16 — the master-weights rule, applied by casting once at the end.
    Matrix products run at torch's default float32 precision (no TF32
    unless the caller turned it on)."""
    from ..models.llama import init_params, scaled, train_step_fn

    dev = resolve_device(device)
    cfg32 = scaled(draft_cfg, dtype=torch.float32)
    if params is None:
        params = init_params(
            cfg32, torch.Generator(device=dev).manual_seed(seed), dev)
    else:
        params = _tree_to(params, dtype=torch.float32, device=dev, copy=True)
    step = train_step_fn(cfg32, lr=lr)
    rng = np.random.RandomState(seed + 1)
    losses: List[float] = []
    n = corpus.shape[0]
    for i in range(steps):
        idx = rng.randint(0, n, size=min(batch, n))
        toks = torch.from_numpy(np.ascontiguousarray(corpus[idx])).to(dev)
        params, loss = step(params, toks)
        if i % 20 == 0 or i == steps - 1:
            losses.append(float(loss))
    return _tree_to(params, dtype=draft_cfg.dtype), losses


def _tree_to(tree, **kw):
    """``Tensor.to(**kw)`` over a params tree."""
    return {k: _tree_to(v, **kw) if isinstance(v, dict) else v.to(**kw)
            for k, v in tree.items()}


def acceptance_probe(
    target: InferenceEngine,
    draft: InferenceEngine,
    prompts: Sequence[Sequence[int]],
    gen_len: int = 48,
    k: int = 4,
) -> Tuple[float, float]:
    """(acceptance_rate, tokens_per_round) of draft-vs-target greedy
    agreement, measured by actually running ``SpeculativeDecoder``
    rounds on held-out prompts.  tokens_per_round = 1 + k*acceptance is
    the speculation speedup's numerator."""
    from .speculative import SpeculativeDecoder

    spec = SpeculativeDecoder(target, draft, k=k)
    for p in prompts:
        st_t, st_d = spec.prefill(p)
        spec.decode(st_t, st_d, gen_len)
        spec.target.release(st_t)
        spec.draft.release(st_d)
    acc = spec.acceptance_rate
    per_round = (spec.accepted + spec.rounds) / max(1, spec.rounds)
    return acc, per_round


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser("distill_draft")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-seqs", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=48)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="the target's weights, the corpus and the draft's "
                         "initial weights (the random-init baseline draft "
                         "takes seed + 9)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..kv import PagedCacheConfig
    from ..models import TINY, init_params, scaled

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    tcfg = scaled(TINY, dtype=torch.float32)
    tparams = init_params(tcfg, gen(args.seed), dev)

    def engine(cfg, params):
        return InferenceEngine(params, cfg, PagedCacheConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, n_blocks=256, block_tokens=4,
            dtype=cfg.dtype,
        ), device=dev)

    target = engine(tcfg, tparams)
    corpus = generate_corpus(target, n_seqs=args.n_seqs,
                             gen_len=args.gen_len, seed=args.seed)
    dcfg = scaled(TINY, dtype=torch.float32, n_layers=1, dim=64, ffn_dim=128)
    dparams, losses = distill(dcfg, corpus, steps=args.steps,
                              seed=args.seed, device=dev)
    print("distill losses:", [round(x, 3) for x in losses])

    held_out = [
        [int(x) for x in np.random.RandomState(100 + i).randint(
            1, tcfg.vocab_size, size=16)]
        for i in range(4)
    ]
    base_acc, _ = acceptance_probe(
        engine(tcfg, tparams),
        engine(dcfg, init_params(dcfg, gen(args.seed + 9), dev)),
        held_out, gen_len=args.gen_len, k=args.spec_k)
    acc, per_round = acceptance_probe(
        engine(tcfg, tparams), engine(dcfg, dparams),
        held_out, gen_len=args.gen_len, k=args.spec_k)
    print(f"acceptance: random-init draft {base_acc:.3f} -> "
          f"distilled {acc:.3f} ({per_round:.2f} tokens/round at "
          f"k={args.spec_k}) on {dev}")


if __name__ == "__main__":
    main()
