"""Draft-model-free speculative decoding: n-gram prompt-lookup proposals.

Counterpart of the reference's ``engine/ngram.py`` (vLLM's ``[ngram]``
speculator; Saxena 2023, "prompt lookup decoding"): proposals come from
matching the newest ``g`` tokens against the sequence's own history and
replaying what followed the most recent match.  No draft model and no draft
cache: the draft costs a handful of vector compares, so any accepted token
is profit, and acceptance is a property of how repetitive the text is.

The matcher runs on the device inside the round body, over a padded ``[B,
L]`` history buffer: one round is k proposals, ONE target verify of ``[prev,
p_1..p_k]``, greedy acceptance and the history write (which is the whole
resync).  On the card the body is captured into a CUDA graph once per
(batch bucket, target table width, L, k, g) key, on the target engine's
stream and out of its graph pool, and replayed R times per dispatch, then a
refresh body (the target's verify of the last accepted token) once; one
host sync per dispatch.  On the CPU the same bodies run eagerly.

Greedy decision rule only, as in the reference: the output is the target's
greedy decode.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import stepprof as _stepprof
from .engine import InferenceEngine, SequenceState, _round_up_pow2
from .speculative import (
    _emitted,
    _greedy_accept,
    _RoundGraph,
    _RoundGraphOwner,
    _slots,
    follow_key,
    round_replay_equals_eager,
    run_body,
)

_R_MAX = 8  # the largest round count of a dispatch ({8, 2, 1})


def _propose_one(h: torch.Tensor, p: torch.Tensor, g: int) -> torch.Tensor:
    """The proposal at position ``p`` [B] (>= g) of each row of history
    ``h`` [B, L]: the token that followed the most recent earlier match of
    the suffix ``h[p-g:p]``, else a repeat of ``h[p-1]``."""
    L = h.shape[1]
    ar = torch.arange(g, device=h.device)
    suf = torch.gather(h, 1, (p[:, None] - g + ar[None]).long())  # [B, g]
    # window j holds h[:, j:j+g], as g shifted views
    win = torch.stack([h[:, t:L - g + t] for t in range(g)], dim=2)
    ok = (win == suf[:, None, :]).all(dim=2)  # [B, L-g]
    idx = torch.arange(L - g, device=h.device)[None]
    # strictly before the suffix itself; the most recent match wins
    ok = ok & (idx < (p - g)[:, None])
    j = torch.where(ok, idx, -1).max(dim=1).values
    hit = torch.gather(h, 1, (j + g).clamp(0, L - 1)[:, None])[:, 0]
    last = torch.gather(h, 1, (p - 1)[:, None].long())[:, 0]
    return torch.where(j >= 0, hit, last)


class NgramSpeculator(_RoundGraphOwner):
    """Model-free speculative decoder over a target ``InferenceEngine``.

    Mirrors ``SpeculativeDecoder``'s surface (``prefill`` / ``decode`` /
    ``decode_batch`` / ``generate`` / ``acceptance_rate``) minus the draft
    engine.  Greedy only: the output is the target's greedy decode.

    ``k``: proposals per round; ``g``: match gram size.
    """

    def __init__(self, target: InferenceEngine, k: int = 8, g: int = 2):
        if k < 1 or g < 1:
            raise ValueError(f"k and g must be >= 1, got k={k}, g={g}")
        self.target = target
        self.k = k
        self.g = g
        self.rounds = 0
        self.proposed = 0
        self.accepted = 0
        # the round graphs, by ("ngram", batch bucket, table width, L, k, g)
        self._graphs: Dict[tuple, _RoundGraph] = {}

    # -- lifecycle ---------------------------------------------------

    def prefill(self, tokens: Sequence[int]) -> SequenceState:
        return self.target.prefill(tokens)

    def eligible(self, st: SequenceState) -> bool:
        return self.target._has_verify and len(st.tokens) >= self.g + 1

    # -- the round graphs ---------------------------------------------

    def _graph(self, key: tuple) -> _RoundGraph:
        g = self._graphs.get(key)
        if g is not None:
            return g
        _, Bp, Wt, L, k, _g = key
        dev = self.target.device
        i32 = torch.int32

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        g = self._graphs[key] = _RoundGraph(key, dict(
            n=z((Bp,), i32), hist=z((Bp, L), i32), t_table=z((Bp, Wt), i32),
            t_logits=z((Bp, self.target.cfg.vocab_size),
                       self.target.params["lm_head"].dtype),
            outs=z((_R_MAX, Bp, k + 1), i32), cnts=z((_R_MAX, Bp), i32),
            r=z((1,), torch.long)))
        return g

    def _round_body(self, g: _RoundGraph) -> None:
        """One n-gram round for every row over ``g``'s buffers: k
        proposals, each written provisionally into the history so later
        proposals match through earlier ones; one target verify of ``[prev,
        p_1..p_k]``; greedy acceptance; the emitted window written into
        the history (positions past the accepted count hold provisional
        tokens the ``j < p-g`` mask excludes until overwritten)."""
        t, k = self.target, self.k
        T = t.pc.block_tokens
        ar = torch.arange(k + 1, dtype=torch.int32, device=g.n.device)
        props = []
        for i in range(k):
            p = g.n + i
            tok = _propose_one(g.hist, p, self.g)
            g.hist.scatter_(1, p[:, None].long(), tok[:, None])
            props.append(tok)
        props = torch.stack(props, dim=1)
        poss = g.n[:, None] - 1 + ar[None]
        run = torch.gather(g.hist, 1, poss.long())
        # in a serving group: the followers verify the same run
        t.spec_share_(run)
        blks, slots = _slots(g.t_table, poss, T)
        lgs, _ = t._verify(t.params, tokens=run, positions=poss,
                           cache=t.cache, block_table=g.t_table,
                           slot_block_ids=blks, slot_ids=slots)
        m, picked = _greedy_accept(lgs, props)
        e = _emitted(m, picked, props)
        cnt = m + 1
        t.spec_share_(cnt)  # the followers advance by the leader's count
        g.hist.scatter_(1, (g.n[:, None] + ar[None]).long(), e)
        g.outs.index_copy_(0, g.r, e[None])
        g.cnts.index_copy_(0, g.r, cnt[None])
        g.n.add_(cnt)
        g.r.add_(1)

    def _refresh_body(self, g: _RoundGraph) -> None:
        """The target's verify of each row's last accepted token: the
        logits after it, so the target comes back decode-ready."""
        t = self.target
        posF = g.n[:, None] - 1
        last = torch.gather(g.hist, 1, posF.long())
        t.spec_share_(last)
        blk, slot = _slots(g.t_table, posF, t.pc.block_tokens)
        lg, _ = t._verify_last(
            t.params, tokens=last, positions=posF, cache=t.cache,
            block_table=g.t_table, slot_block_ids=blk, slot_ids=slot)
        g.t_logits.copy_(lg[:, -1])

    def round_replay_equals_eager(self, key: tuple) -> bool:
        g = self._graphs[key]
        return round_replay_equals_eager(
            self.target, g, lambda: self._round_body(g), (self.target,))

    # -- decode ------------------------------------------------------

    def decode(self, st: SequenceState, n_steps: int) -> List[int]:
        if not self.eligible(st):
            return self.target.decode(st, n_steps)
        return self.decode_batch([st], n_steps)[0]

    def decode_batch(self, sts: List[SequenceState],
                     n_steps: int) -> List[List[int]]:
        """Lockstep batched n-gram speculation; every row's output equals
        the target's own greedy decode of that row."""
        if not sts:
            raise ValueError("decode_batch needs at least one sequence")
        for st in sts:
            if not self.eligible(st):
                raise ValueError("row not eligible for ngram spec")
        k, gram = self.k, self.g
        eng = self.target
        B = len(sts)
        Bp = _round_up_pow2(B, 1)
        T = eng.pc.block_tokens
        outs_h: List[List[int]] = [[] for _ in range(B)]

        # history bucket: pow2 covering the longest row + WORST-CASE growth
        # (lockstep rows overshoot: the loop runs until the SLOWEST row
        # meets the budget, so a fast row can emit up to ~n_steps*(k+1)
        # tokens, plus one final dispatch of up to 8*(k+1))
        max_len = max(len(st.tokens) for st in sts)
        need_L = max_len + (n_steps + 8) * (k + 1) + k + 2
        L = 256
        while L < need_L:
            L *= 2
        hist_h = np.zeros((Bp, L), dtype=np.int32) - 1
        hist_h[B:] = 0
        for b, st in enumerate(sts):
            hist_h[b, : len(st.tokens)] = st.tokens
        # pad rows: a length every real row has, so they grow no faster
        # (and reach no further into the history) than the real rows
        pad_n = [gram + 1] * (Bp - B)

        def fits(rounds: int) -> bool:
            short = 0
            for st in sts:
                need = -(-(len(st.tokens) + rounds * (k + 1)) // T)
                short += max(0, need - len(st.block_ids))
            return short <= eng.free_pages

        prev = None
        while min(len(o) for o in outs_h) < n_steps:
            remaining = n_steps - min(len(o) for o in outs_h)
            R = 8 if remaining > 2 * (k + 1) else 2
            # the {8, 2, 1} bucket walk of the model-draft fused path
            while R > 1 and not fits(R):
                R = 2 if R == 8 else 1
            grow = R * (k + 1)
            for st in sts:
                need = -(-(len(st.tokens) + grow) // T)
                if need > len(st.block_ids):
                    st.block_ids.extend(
                        eng.pages.acquire(need - len(st.block_ids)))
            # the history bucket bounds every write of this dispatch
            if max(len(st.tokens) for st in sts) + R * (k + 1) > L:
                raise RuntimeError("n-gram history buffer overflow")
            table = eng._block_table(sts, pad_to=Bp)
            g = self._graph(("ngram", Bp, table.shape[1], L, k, gram))
            _stepprof.note_dispatch("spec_round")  # R rounds, 1 sync
            with eng._on_engine_stream():
                g.t_table.copy_(torch.from_numpy(table))
                g.n.copy_(torch.from_numpy(np.asarray(
                    [len(st.tokens) for st in sts] + pad_n, np.int32)))
                if prev is None:
                    g.hist.copy_(torch.from_numpy(hist_h))
                elif prev is not g:
                    g.hist.copy_(prev.hist)
                prev = g
                g.r.zero_()
                # a serving group's followers: the same starting state and
                # the target's half of the same R rounds
                eng._op("spec_load", follow_key(g), n=g.n, table=g.t_table)
                eng._op(
                    "spec_rounds", follow_key(g), R,
                    body=lambda R: run_body(
                        eng, g, g.round, lambda: self._round_body(g),
                        f"ngram_round{g.key}", R, (eng,)),
                    refresh=lambda: run_body(
                        eng, g, g.refresh, lambda: self._refresh_body(g),
                        f"ngram_refresh{g.key}", 1, (eng,)))
                snap = torch.cat([g.outs[:R].flatten(), g.cnts[:R].flatten()])
                lrows = [g.t_logits[b].clone() for b in range(B)]
            _stepprof.note_sync("spec_tokens")
            h = snap.cpu().numpy()  # the one sync
            h_outs = h[:R * Bp * (k + 1)].reshape(R, Bp, k + 1)
            h_cnts = h[R * Bp * (k + 1):].reshape(R, Bp)[:, :B]
            for b in range(B):
                new_toks: List[int] = []
                for r in range(R):
                    cnt = int(h_cnts[r, b])
                    new_toks.extend(int(x) for x in h_outs[r, b, :cnt])
                outs_h[b].extend(new_toks)
                sts[b].tokens.extend(new_toks)
                sts[b].last_logits = lrows[b]
            self.rounds += R * B
            self.proposed += R * B * k
            self.accepted += int(h_cnts.sum()) - R * B
        for b in range(B):
            excess = len(outs_h[b]) - n_steps
            if excess:
                del outs_h[b][n_steps:]
                del sts[b].tokens[-excess:]
                sts[b].last_logits = self.target.verify(
                    sts[b], [sts[b].tokens[-1]], len(sts[b].tokens) - 1)[-1]
        return outs_h

    def generate(self, tokens: Sequence[int], n_steps: int) -> List[int]:
        st = self.prefill(tokens)
        out = self.decode(st, n_steps)
        self.target.release(st)
        return out

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(1, self.proposed)
