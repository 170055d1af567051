"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of the reference's ``engine/speculative.py``, SERVED through the
scheduler's batch=1 fast path (``Scheduler(draft_engine=...)``, ``serve.py
--draft-model``): speculation engages when one request is in flight (or up
to ``spec_batch`` in lockstep) and steps aside when lockstep batching fills
the card.  Acceptance counters surface in ``/metrics`` (``istpu_spec_*``).
Per round:

1. the DRAFT engine decodes ``k`` proposal tokens (a cheap model, its own
   paged cache);
2. the TARGET engine scores ``[last_accepted_token, p_1..p_k]`` in ONE
   multi-token paged forward (``models.llama.verify_forward``);
3. proposals are accepted per the decision rule (below), then a token from
   the target's own distribution is appended, so every round emits between
   1 and k+1 tokens;
4. the draft is resynced by verifying the accepted tail against its own
   cache (rewrites of already-correct slots are harmless: position-masked
   attention and slot overwrite semantics).

ROUND GRAPHS (the counterpart of ``_build_fused_rounds``): one round body
over static device buffers (accepted length ``n``, budget ``n_max``, a
``[B, k+2]`` window of the newest accepted ids, the draft's running logits,
both block tables, per-row sampling vectors and row keys, per-round outputs
written at an on-device round index) is captured into a CUDA graph once per
(batch bucket, target table width, draft table width, k, variant) key, on
the target engine's stream and out of its graph pool, and replayed ``R``
times per dispatch; a refresh body (the target's last-row verify of the
last accepted token) replays once after them, so both engines come back
decode-ready at exactly the budget.  ``R`` comes from a bounded bucket set
(``AdaptiveRController``), so the keys stay bounded.  One dispatch costs
ONE blocking host sync (the token download).  On the CPU the same bodies run
eagerly.  A key's first round runs eagerly on the target's stream (sizing
K1's workspace for the draft's steps) and is captured after it; a failed
capture or replay raises, and nothing falls back to the eager body.  The
graphs read and write both engines' caches and weights, so each replay
first checks that none of them moved.

Decision rules:

* ``sample="greedy"`` (default): accept while the proposal matches the
  target's argmax; the output is the target's greedy decode.  Exactness
  holds to the extent the verify forward's numerics match the decode
  step's: in bf16 a different reduction order can flip an argmax between
  near-tied logits, so bf16 serving holds the guarantee to a tolerance, f32
  bitwise.
* ``sample="categorical"``: rejection sampling (Leviathan et al. 2023):
  draft token ``x_i ~ q_i`` is accepted with probability ``min(1,
  p_i(x_i) / q_i(x_i))``; on the first rejection a replacement is drawn
  from ``norm(max(p_i - q_i, 0))`` and the round ends; if all ``k``
  survive, a bonus token is drawn from ``p_{k+1}``.  Every emitted token is
  an exact sample from the target's post-truncation distribution.  The
  draft's draws are the decode step's counter-based Gumbel draws keyed on
  the token's absolute position, the accept and replacement draws
  counter-based uniforms keyed on the absolute position they decide, so
  one generator state reproduces its stream whatever the R bucketing, and
  across call boundaries too unless a round cut by the boundary accepted
  all k proposals (one side then draws a bonus where the other proposes).
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import stepprof as _stepprof
from .engine import (
    _M32,
    InferenceEngine,
    SequenceState,
    _gumbel,
    _mix32,
    _round_up_pow2,
    _row_keys,
    _sampling_logits,
)

# the accept draws' key: a row key mixed with this salt, so they never
# repeat the draft's Gumbel draws
_ACCEPT_SALT = 0x27D4EB2F


def _parse_r_buckets(spec: Optional[str]) -> Tuple[int, ...]:
    """Parse ``ISTPU_SPEC_R_BUCKETS`` ("1,2,8") into a sorted, deduped,
    BOUNDED tuple.  Every bucket is a round count per dispatch that the
    fused path may replay, so the set is clamped to at most 4 values in
    [1, 32]; garbage falls back to the default."""
    default = (1, 2, 8)
    if not spec:
        return default
    try:
        vals = sorted({int(x) for x in spec.split(",") if x.strip()})
    except ValueError:
        return default
    vals = [v for v in vals if 1 <= v <= 32]
    if not vals:
        return default
    return tuple(vals[:4])


class AdaptiveRController:
    """Acceptance-adaptive rounds-per-dispatch: an EWMA of tokens emitted
    per fused round sizes the next dispatch's round count R from a small
    FIXED bucket set.

    A fused dispatch costs one host sync however many rounds it runs, so R
    should be just large enough that the dispatch's expected yield (``R *
    EWMA``) covers the chunk budget.  The controller is carried PER REQUEST
    across scheduler steps (``SpeculativeDecoder._controller``).

    Hysteresis: stepping DOWN to a smaller bucket requires the smaller
    bucket's expected yield to beat the remaining budget by a margin
    (``hysteresis``); staying put and stepping up need none.

    Pure host math, a copy of the reference's."""

    def __init__(self, k: int, buckets: Sequence[int] = (1, 2, 8),
                 alpha: float = 0.4, hysteresis: float = 0.25):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"R buckets must be >= 1, got {buckets}")
        self.k = k
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        self.alpha = float(alpha)
        self.hysteresis = float(hysteresis)
        # optimistic start: a fresh request assumes full acceptance, so its
        # first dispatch is sized to cover the whole chunk
        self.rate = float(k + 1)
        self._bucket = self.buckets[-1]

    def update(self, tokens: int, rounds: int) -> None:
        """Fold one dispatch's observation: ``tokens`` emitted over
        ``rounds`` effective (unclamped) rounds."""
        if rounds <= 0:
            return
        self.rate += self.alpha * (tokens / rounds - self.rate)
        self.rate = min(max(self.rate, 1.0), float(self.k + 1))

    def suggest(self, remaining: int) -> int:
        """Bucket for the next dispatch given ``remaining`` tokens of
        budget: the smallest bucket whose expected yield covers it (with
        the down-switch margin), else the largest."""
        if remaining <= 0:
            return self.buckets[0]
        choice = self.buckets[-1]
        for b in self.buckets:
            margin = 1.0 + self.hysteresis if b < self._bucket else 1.0
            if b * self.rate >= remaining * margin:
                choice = b
                break
        self._bucket = choice
        return choice


def _accept_uniforms(rowkey: torch.Tensor, n: torch.Tensor,
                     k: int) -> torch.Tensor:
    """[B, 2, k+1] uniforms in (0, 1) for a round that starts at accepted
    length ``n`` [B]: ``[:, 0, j]`` decides the proposal at absolute
    position ``n + j``, ``[:, 1, j]`` draws the replacement (or the bonus)
    there.  Counter-based, the counterpart of the reference's
    ``uniform(fold_in(key, n), (k+1,))``: a 24-bit hash of (the row's
    accept key, the position, the stream), so a position's draws are the
    same whichever round, dispatch or call decides it."""
    akey = _mix32(rowkey ^ _ACCEPT_SALT)
    pos = n.long()[:, None] + torch.arange(k + 1, device=n.device)[None]
    h = _mix32(akey[:, None] ^ _mix32(pos))  # [B, k+1]
    # no host-to-device copy: the body is captured into a CUDA graph
    stream = torch.arange(2, dtype=torch.long, device=n.device) * 0x9E3779B9
    x = _mix32((h[:, None, :] + stream[None, :, None]) & _M32)
    return ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _spec_decide(logits: torch.Tensor, q: torch.Tensor, toks: torch.Tensor,
                 us: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 use_filter: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rejection-sampling decision per row, on the device (no host
    read): the target's post-truncation p (the decode step's
    ``_sampling_logits`` math) against the draft's as-sampled q.

    logits [B, k+1, V] (the verify's rows), q [B, k, V], toks [B, k], us
    [B, 2, k+1] (``_accept_uniforms``), temperature / top_k / top_p [B].
    Accept x_i while ``u_i < min(1, p_i(x_i) / q_i(x_i))``; at the first
    rejection draw from ``norm(max(p_m - q_m, 0))`` (p_m when the residual
    vanishes); if all k survive, draw the bonus from ``p_{k+1}`` (the
    residual against q = 0).  Returns (m, repl) [B] int32: the accepted
    prefix length and the replacement or bonus token."""
    B, K1, V = logits.shape
    k = K1 - 1
    p = torch.softmax(_sampling_logits(
        logits.float().reshape(B * K1, V),
        "filter" if use_filter else "plain",
        temperature.repeat_interleave(K1), top_k.repeat_interleave(K1),
        top_p.repeat_interleave(K1)), dim=-1).reshape(B, K1, V)
    idx = toks.long()[..., None]
    px = torch.gather(p[:, :k], 2, idx)[..., 0]
    qx = torch.gather(q, 2, idx)[..., 0].float()
    acc = (qx > 0) & (us[:, 0, :k] < torch.clamp(px / qx, max=1.0))
    all_acc = acc.all(dim=1)
    m = torch.where(all_acc, k, (~acc).float().argmax(dim=1))
    pm = torch.gather(p, 1, m[:, None, None].expand(B, 1, V))[:, 0]
    qm = torch.gather(q, 1, m.clamp(max=k - 1)[:, None, None].expand(
        B, 1, V))[:, 0].float()
    qm = torch.where(all_acc[:, None], 0.0, qm)
    residual = torch.clamp(pm - qm, min=0.0)
    dist = torch.where(residual.sum(dim=1, keepdim=True) > 0, residual, pm)
    cdf = torch.cumsum(dist, dim=1)
    r = torch.gather(us[:, 1], 1, m[:, None]) * cdf[:, -1:]
    repl = torch.searchsorted(cdf, r, right=True)[:, 0].clamp(0, V - 1)
    return m.to(torch.int32), repl.to(torch.int32)


def _greedy_accept(lgs: torch.Tensor, props: torch.Tensor):
    """Greedy acceptance per row: lgs [B, k+1, V], props [B, k] -> (m,
    picked) [B] int32: the proposals accepted while they equal the
    target's argmax, and the target's own token after them."""
    k = props.shape[1]
    choices = torch.argmax(lgs.float(), dim=-1).to(torch.int32)
    ok = props == choices[:, :k]
    m = torch.where(ok.all(dim=1), k, (~ok).float().argmax(dim=1))
    picked = torch.gather(choices, 1, m[:, None].long())[:, 0]
    return m.to(torch.int32), picked


def _emitted(m: torch.Tensor, repl: torch.Tensor,
             props: torch.Tensor) -> torch.Tensor:
    """A round's emitted window [B, k+1]: the proposals with column ``m``
    replaced by ``repl`` (columns past ``m`` are not emitted)."""
    k = props.shape[1]
    tail = torch.cat([props, props[:, -1:]], dim=1)
    cols = torch.arange(k + 1, device=props.device)[None]
    return torch.where(cols == m[:, None], repl[:, None], tail)


def _slots(table: torch.Tensor, poss: torch.Tensor, T: int):
    """(page ids, in-page slots) of positions ``poss`` [B, S] in ``table``
    [B, W]; the page index is clamped into the table (a pad row that runs
    past it writes nothing: its entries are ``n_blocks``)."""
    page = (poss // T).long().clamp(0, table.shape[1] - 1)
    return torch.gather(table, 1, page), poss % T


class _Body:
    """One captured body of a round graph: the CUDA graph (None until
    captured; always None on the CPU), the launches its capture recorded,
    its replays, and its eager runs on the card."""

    def __init__(self):
        self.graph = None
        self.captured: Dict[str, int] = {}
        self.replays = 0
        self.eager = 0


class _RoundGraph:
    """One round-graph key's static device buffers (named attributes), its
    round body and its refresh body."""

    def __init__(self, key, bufs: Dict[str, torch.Tensor]):
        self.key = key
        for name, t in bufs.items():
            setattr(self, name, t)
        self.round = _Body()
        self.refresh = _Body()
        self.ptrs = None  # caches and weights the graphs were captured with

    def buffers(self) -> List[torch.Tensor]:
        return [t for t in vars(self).values() if isinstance(t, torch.Tensor)]


def follow_key(g: _RoundGraph) -> tuple:
    """The key of the followers' round buffers of a leader's round graph
    ``g`` (``InferenceEngine._follow_graph``): its batch bucket, target
    table width and proposal count."""
    return ("follow", g.t_table.shape[0], g.t_table.shape[1],
            g.outs.shape[2] - 1)


def _ptrs(engines: Sequence[InferenceEngine]) -> tuple:
    return tuple(p for e in engines
                 for p in (e.cache.data_ptr(), *e._param_ptrs()))


def run_body(target: InferenceEngine, g: _RoundGraph, body: _Body,
             fn: Callable[[], None], name: str, times: int,
             engines: Sequence[InferenceEngine]) -> None:
    """Run ``fn`` (a body over ``g``'s buffers) ``times`` times on the
    target's stream: eagerly on the CPU and in a serving group whose
    collectives run on the host (gloo); otherwise on the card the body's
    graph replays, and a body seen for the first time runs once eagerly and
    is captured after it (``target._capture_graph``, kind ``"spec"``).
    Before a replay the caches and weights of ``engines`` must be those the
    graph was captured with."""
    if times <= 0:
        return
    if target.device.type != "cuda" or not target._capture_ok:
        for _ in range(times):
            fn()
        return
    done = 0
    if body.graph is None:
        fn()
        body.eager += 1
        done = 1
        target._capture_graph(body, fn, name, "spec")
        if g.ptrs is None:
            g.ptrs = _ptrs(engines)
    if g.ptrs != _ptrs(engines):
        raise RuntimeError("a paged cache or the weights moved since this "
                           "round graph was captured")
    t0 = time.perf_counter()
    target._replay(body, "spec", times - done)
    target.graph_replay_s["spec"] += time.perf_counter() - t0


def round_replay_equals_eager(target: InferenceEngine, g: _RoundGraph,
                              round_fn: Callable[[], None],
                              engines: Sequence[InferenceEngine]) -> bool:
    """Diagnostics for the card tests and ``chip_smoke.py``: from one
    snapshot of ``g``'s buffers and the pages its tables name in every
    engine's cache, run the round body eagerly, restore, replay the
    captured round graph once, and compare every buffer and page
    (``torch.equal``).  Leaves the replay's state.  Counts no launch."""
    if g.round.graph is None:
        raise ValueError("this key has no captured round graph")
    tables = [t for name, t in vars(g).items()
              if name.endswith("table") and isinstance(t, torch.Tensor)]
    ids = []
    for eng, table in zip(engines, tables):
        live = np.unique(table.cpu().numpy())
        ids.append(torch.from_numpy(
            live[live < eng.pc.n_blocks].astype(np.int64)).to(eng.device))
    results = []
    with target._on_engine_stream():
        bufs0 = [t.clone() for t in g.buffers()]
        pages0 = [e.cache[:, :, :, i].clone() for e, i in zip(engines, ids)]
        for step in ("eager", "replay"):
            for t, t0 in zip(g.buffers(), bufs0):
                t.copy_(t0)
            g.r.zero_()  # the dispatch left it at its round count
            for e, i, p0 in zip(engines, ids, pages0):
                e.cache[:, :, :, i] = p0
            if step == "eager":
                round_fn()
            else:
                g.round.graph.replay()
            results.append(([t.clone() for t in g.buffers()],
                            [e.cache[:, :, :, i].clone()
                             for e, i in zip(engines, ids)]))
    (b_e, p_e), (b_r, p_r) = results
    return all(torch.equal(a, b) for a, b in zip(b_e + p_e, b_r + p_r))


class _RoundGraphOwner:
    """What a speculator reports of its round graphs (``_graphs``)."""

    _graphs: Dict[tuple, _RoundGraph]

    def graph_launches(self) -> Dict[str, int]:
        """The kernel launches the round graphs' replays made."""
        out: Dict[str, int] = {}
        for g in self._graphs.values():
            for body in (g.round, g.refresh):
                for name, c in body.captured.items():
                    out[name] = out.get(name, 0) + c * body.replays
        return out

    def held_bytes(self) -> int:
        """Bytes of the round graphs' static buffers."""
        return sum(t.numel() * t.element_size()
                   for g in self._graphs.values() for t in g.buffers())


class SpeculativeDecoder(_RoundGraphOwner):
    def __init__(
        self,
        target: InferenceEngine,
        draft: InferenceEngine,
        k: int = 4,
    ):
        if target.pc.block_tokens != draft.pc.block_tokens:
            raise ValueError("target and draft must page with the same "
                             "chunk size")
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("target and draft must share the vocabulary")
        if target.device != draft.device:
            raise ValueError(f"target on {target.device}, draft on "
                             f"{draft.device}: one device")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if draft.group_size > 1:
            raise ValueError("the draft is an unsharded engine beside the "
                             "target's serving group, on its leader")
        self.target = target
        self.draft = draft
        self.k = k
        # greedy and stochastic rounds run on the round graphs; turn off to
        # force the host round loop
        self.fuse_rounds = True
        # acceptance-adaptive rounds-per-dispatch (AdaptiveRController):
        # ISTPU_SPEC_ADAPTIVE=0 pins the static policy (largest bucket until
        # the tail, no second dispatch in flight); the bucket SET comes from
        # ISTPU_SPEC_R_BUCKETS either way
        self.adaptive = os.environ.get("ISTPU_SPEC_ADAPTIVE", "1") != "0"
        self.r_buckets = _parse_r_buckets(
            os.environ.get("ISTPU_SPEC_R_BUCKETS"))
        # per-request controllers keyed by TARGET seq id, carried across
        # scheduler steps (the scheduler forgets them at retirement);
        # bounded so a library caller who never retires can't grow it
        self._ctls: Dict[int, AdaptiveRController] = {}
        self.rounds = 0
        self.accepted = 0
        self.proposed = 0
        # the base seed of each unseeded stochastic call (callers may pass
        # their generator)
        self._gen = torch.Generator()
        self._gen.manual_seed(0)
        # the round graphs, by (kind, batch bucket, target table width,
        # draft table width, k, variant)
        self._graphs: Dict[tuple, _RoundGraph] = {}

    @property
    def _engines(self) -> Tuple[InferenceEngine, InferenceEngine]:
        return (self.target, self.draft)

    def _controller(self, st: SequenceState) -> AdaptiveRController:
        ctl = self._ctls.get(st.seq_id)
        if ctl is None:
            if len(self._ctls) >= 512:
                self._ctls.pop(next(iter(self._ctls)))
            ctl = self._ctls[st.seq_id] = AdaptiveRController(
                self.k, self.r_buckets)
        return ctl

    def forget(self, seq_id: int) -> None:
        """Drop the per-request adaptive-R state (called by the scheduler
        when the request retires)."""
        self._ctls.pop(seq_id, None)

    def prefill(self, tokens: Sequence[int]
                ) -> Tuple[SequenceState, SequenceState]:
        return self.target.prefill(tokens), self.draft.prefill(tokens)

    def _resync_draft(self, st_d: SequenceState, accepted: List[int],
                      clean: bool = False) -> None:
        """Bring the draft's cache and logits in line with the accepted
        sequence: its tokens are rewound and the accepted tail is
        re-verified, a window of k+1 (or 1 on ``clean`` all-accepted
        rounds, where every draft slot up to the bonus token already holds
        the right KV)."""
        st_d.tokens = list(accepted)
        w = 1 if clean else min(len(accepted), self.k + 1)
        logits = self.draft.verify(st_d, accepted[-w:], len(accepted) - w)
        st_d.last_logits = logits[-1]

    def _fusable(self, st_t: SequenceState, st_d: SequenceState) -> bool:
        k = self.k
        return (len(st_t.tokens) >= k + 2
                and len(st_t.tokens) == len(st_d.tokens)
                and st_t.tokens[-(k + 2):] == st_d.tokens[-(k + 2):])

    def decode(
        self,
        st_t: SequenceState,
        st_d: SequenceState,
        n_steps: int,
        sample: str = "greedy",
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        rng: Optional[torch.Generator] = None,
    ) -> List[int]:
        """Emit exactly ``n_steps`` tokens.  Greedy mode is equivalent to
        ``target.decode(st_t, n_steps)``; categorical mode draws every token
        from the target's post-truncation sampling distribution (rejection
        sampling, see the module docstring).  ``rng``: the generator the
        call's base seed comes from (default: the decoder's own)."""
        if sample not in ("greedy", "categorical"):
            raise ValueError(f"sample must be 'greedy' or 'categorical', "
                             f"got {sample!r}")
        if (self.fuse_rounds and self.target._has_verify
                and self.draft._has_verify and self._fusable(st_t, st_d)
                # the fused rounds run the base model: an engine with a
                # bank keeps the host round loop, whose calls carry the
                # rows' adapters (as the reference)
                and self.target.lora is None and self.draft.lora is None):
            if sample == "greedy":
                variant = "greedy"
            else:
                variant = "filter" if (top_k > 0 or top_p < 1.0) else "plain"
            return self._decode_fused_batch(
                [st_t], [st_d], n_steps, variant=variant,
                temperature=temperature, top_k=top_k, top_p=top_p, rng=rng,
            )[0]
        out: List[int] = []
        try:
            out = self._rounds(st_t, st_d, n_steps, sample, temperature,
                               top_k, top_p, rng)
        except MemoryError:
            # an allocator ran dry mid-round; the target state is not
            # decode-ready (the round's last emitted token's KV is written
            # only by the next round's verify, ``last_logits`` refreshed at
            # the end), so re-verify the tail before propagating
            st_t.last_logits = self.target.verify(
                st_t, [st_t.tokens[-1]], len(st_t.tokens) - 1)[-1]
            raise
        excess = len(out) - n_steps
        if excess:
            del out[n_steps:]
            del st_t.tokens[-excess:]
            self._resync_draft(st_d, list(st_t.tokens))
        # verify rounds do not carry logits for the bonus token: refresh
        # last_logits to leave the target state decode()-ready
        st_t.last_logits = self.target.verify(
            st_t, [st_t.tokens[-1]], len(st_t.tokens) - 1)[-1]
        return out

    def _acquire_for(self, eng: InferenceEngine, st: SequenceState,
                     n_new: int, base_len: Optional[int] = None) -> None:
        """Grow ``st``'s page list to cover ``n_new`` more tokens (raises
        MemoryError with the state untouched).  ``base_len`` overrides
        ``len(st.tokens)`` as the starting length: draft pages are sized
        from the TARGET length, so a stale-shorter draft can never
        undersize its block table."""
        T = eng.pc.block_tokens
        need = -(-((base_len if base_len is not None
                    else len(st.tokens)) + n_new) // T)
        if need > len(st.block_ids):
            st.block_ids.extend(eng.pages.acquire(need - len(st.block_ids)))

    def decode_batch(
        self,
        st_ts: List[SequenceState],
        st_ds: List[SequenceState],
        n_steps: int,
        sample: str = "greedy",
        temperature=1.0,
        top_k=0,
        top_p=1.0,
        rng: Optional[torch.Generator] = None,
    ) -> List[List[int]]:
        """Batched speculation: every row runs the fused rounds in
        LOCKSTEP, emitting exactly ``n_steps`` tokens per row.  Rows may
        have different lengths and (in categorical mode) different per-row
        temperature / top_k / top_p; ``sample`` is batch-wide.  Every row
        must be fusable (len(tokens) >= k+2, draft in sync): the host round
        loop has no batched form, so this raises otherwise."""
        if sample not in ("greedy", "categorical"):
            raise ValueError(f"sample must be 'greedy' or 'categorical', "
                             f"got {sample!r}")
        if not st_ts or len(st_ts) != len(st_ds):
            raise ValueError(f"{len(st_ts)} target rows, {len(st_ds)} "
                             f"draft rows")
        for st_t, st_d in zip(st_ts, st_ds):
            if len(st_t.tokens) < self.k + 2:
                raise ValueError("batched speculation needs prompts of at "
                                 "least k+2 tokens")
            # value equality alone is not enough: after a lockstep
            # interlude a tail of >= k+2 repeated tokens would let a
            # SHORTER stale draft pass as synced
            if not self._fusable(st_t, st_d):
                raise ValueError("draft state out of sync with target")
        if not (self.target._has_verify and self.draft._has_verify):
            raise ValueError("both engines need a verify step")
        if self.target.lora is not None or self.draft.lora is not None:
            raise ValueError("batched speculation runs the base model: "
                             "neither engine may carry a LoRA bank")
        if sample == "greedy":
            variant = "greedy"
        else:
            tk_any = np.any(np.asarray(top_k) > 0)
            tp_any = np.any(np.asarray(top_p) < 1.0)
            variant = "filter" if (tk_any or tp_any) else "plain"
        return self._decode_fused_batch(
            st_ts, st_ds, n_steps, variant=variant, temperature=temperature,
            top_k=top_k, top_p=top_p, rng=rng,
        )

    # ---- the round graphs ----

    def _graph(self, key: tuple) -> _RoundGraph:
        """``key``'s static buffers, made at its first use."""
        g = self._graphs.get(key)
        if g is not None:
            return g
        _, Bp, Wt, Wd, k, variant = key
        dev = self.target.device
        V = self.target.cfg.vocab_size
        R_max = max(self.r_buckets)
        i32 = torch.int32

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        bufs = dict(
            n=z((Bp,), i32), n_max=z((Bp,), i32), win=z((Bp, k + 2), i32),
            dlog=z((Bp, V), self.draft.params["lm_head"].dtype),
            t_logits=z((Bp, V), self.target.params["lm_head"].dtype),
            t_table=z((Bp, Wt), i32), d_table=z((Bp, Wd), i32),
            outs=z((R_max, Bp, k + 1), i32), cnts=z((R_max, Bp), i32),
            ms=z((R_max, Bp), i32), r=z((1,), torch.long))
        if variant != "greedy":
            bufs.update(temp=z((Bp,), torch.float32),
                        top_k=z((Bp,), i32),
                        top_p=z((Bp,), torch.float32),
                        rowkey=z((Bp,), torch.long))
        g = self._graphs[key] = _RoundGraph(key, bufs)
        return g

    def _round_body(self, g: _RoundGraph) -> None:
        """One complete round for every row over ``g``'s buffers: the
        draft proposes k tokens (argmax, or a Gumbel draw from its
        post-truncation distribution q_i, collected), the target verifies
        ``[prev, p_1..p_k]`` in one forward, the accept/reject step, the
        budget clamp ``cnt = min(m+1, n_max-n)``, the window and length
        update, and the draft's last-row resync of the newest k+1 accepted
        tokens.  No host read: the same code runs eagerly on the CPU and is
        what a CUDA graph captures on the card."""
        t, d, k = self.target, self.draft, self.k
        T = t.pc.block_tokens
        variant = g.key[-1]
        dev = g.n.device
        ar = torch.arange(k + 2, dtype=torch.int32, device=dev)
        logits = g.dlog
        props, qs = [], []
        for i in range(k):
            pos = g.n + i
            if variant == "greedy":
                tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            else:
                l = _sampling_logits(logits.float(), variant, g.temp,
                                     g.top_k, g.top_p)
                tok = torch.argmax(l + _gumbel(g.rowkey, pos, d._vocab_hash),
                                   dim=-1).to(torch.int32)
                qs.append(torch.softmax(l, dim=-1))
            blk, slot = _slots(g.d_table, pos[:, None], T)
            logits, _ = d._decode(
                d.params, tokens=tok, positions=pos, cache=d.cache,
                block_table=g.d_table, seq_lens=pos + 1,
                slot_block_ids=blk[:, 0], slot_ids=slot[:, 0])
            props.append(tok)
        props = torch.stack(props, dim=1)  # [B, k]
        run = torch.cat([g.win[:, -1:], props], dim=1)
        # in a serving group: the followers verify the same run
        t.spec_share_(run)
        poss = g.n[:, None] - 1 + ar[None, :k + 1]
        blks, slots = _slots(g.t_table, poss, T)
        lgs, _ = t._verify(t.params, tokens=run, positions=poss,
                           cache=t.cache, block_table=g.t_table,
                           slot_block_ids=blks, slot_ids=slots)
        if variant == "greedy":
            m, repl = _greedy_accept(lgs, props)
        else:
            m, repl = _spec_decide(
                lgs, torch.stack(qs, dim=1), props,
                _accept_uniforms(g.rowkey, g.n, k), g.temp, g.top_k,
                g.top_p, variant == "filter")
        e = _emitted(m, repl, props)
        # the budget clamp: a row at its budget keeps executing but emits
        # nothing and carries its state unchanged (its proposals land past
        # the budget, in pages sized for this overshoot: rem + k)
        cnt = torch.minimum(m + 1, g.n_max - g.n)
        t.spec_share_(cnt)  # the followers advance by the leader's count
        n2 = g.n + cnt
        win2 = torch.gather(torch.cat([g.win, e], dim=1), 1,
                            (cnt[:, None] + ar[None]).long())
        poss_d = n2[:, None] - 1 - k + ar[None, :k + 1]
        blks, slots = _slots(g.d_table, poss_d, T)
        dl, _ = d._verify_last(d.params, tokens=win2[:, 1:],
                               positions=poss_d, cache=d.cache,
                               block_table=g.d_table, slot_block_ids=blks,
                               slot_ids=slots)
        g.outs.index_copy_(0, g.r, e[None])
        g.cnts.index_copy_(0, g.r, cnt[None])
        g.ms.index_copy_(0, g.r, m[None])
        g.n.copy_(n2)
        g.win.copy_(win2)
        g.dlog.copy_(dl[:, -1])
        g.r.add_(1)

    def _refresh_body(self, g: _RoundGraph) -> None:
        """The target's last-row verify of each row's last accepted token
        (its KV slot rewritten in place): the logits after it, so the
        target comes back decode-ready."""
        t = self.target
        posF = g.n[:, None] - 1
        last = g.win[:, -1:].contiguous()
        t.spec_share_(last)
        blk, slot = _slots(g.t_table, posF, t.pc.block_tokens)
        lg, _ = t._verify_last(t.params, tokens=last,
                               positions=posF, cache=t.cache,
                               block_table=g.t_table, slot_block_ids=blk,
                               slot_ids=slot)
        g.t_logits.copy_(lg[:, -1])

    def round_replay_equals_eager(self, key: tuple) -> bool:
        """``round_replay_equals_eager`` for one of this decoder's keys."""
        g = self._graphs[key]
        return round_replay_equals_eager(
            self.target, g, lambda: self._round_body(g), self._engines)

    def _decode_fused_batch(
        self, st_ts: List[SequenceState], st_ds: List[SequenceState],
        n_steps: int, variant: str = "greedy", temperature=1.0,
        top_k=0, top_p=1.0, rng: Optional[torch.Generator] = None,
    ) -> List[List[int]]:
        """Speculation on the round graphs, batched over rows in lockstep.
        One chunk costs ONE blocking host sync in the common case:

        * the per-request ``AdaptiveRController`` sizes R so the first
          dispatch's expected yield covers the whole budget;
        * the rounds clamp emission at each row's budget on the device;
        * when acceptance disappoints and more dispatches are needed, the
          next one replays from the device-resident state (n, window,
          draft logits) before the previous one's tokens land on the host.

        Pages for the whole chunk (+k overshoot slack) are acquired up
        front when both pools can hold them; otherwise a degraded SERIAL
        mode sizes, acquires and drains per dispatch, stepping R down
        through the bucket set (the smallest bucket that still does not fit
        raises MemoryError out of the acquire, with every completed
        dispatch's tokens reconciled)."""
        k = self.k
        B = len(st_ts)
        Bp = _round_up_pow2(B, 1)
        npad = Bp - B
        t_eng, d_eng = self.target, self.draft
        T = t_eng.pc.block_tokens
        outs_h: List[List[int]] = [[] for _ in range(B)]
        if n_steps <= 0:
            return outs_h
        temp = InferenceEngine._per_row(temperature, B, np.float32)
        tk = InferenceEngine._per_row(top_k, B, np.int32)
        tp = InferenceEngine._per_row(top_p, B, np.float32)
        base = None
        if variant != "greedy":
            gen = rng if rng is not None else self._gen
            base = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                     device=gen.device))
        lens0 = [len(st.tokens) for st in st_ts]
        ctls = [self._controller(st) for st in st_ts]
        buckets = self.r_buckets
        g: Optional[_RoundGraph] = None
        launched = False

        def fits(grows: List[int]) -> bool:
            """Can both pools absorb per-row token growth ``grows``?  Draft
            rows size from the TARGET length."""
            short_t = sum(
                max(0, -(-(len(st.tokens) + gr) // T) - len(st.block_ids))
                for st, gr in zip(st_ts, grows))
            if short_t > t_eng.free_pages:
                return False
            short_d = sum(
                max(0, -(-(len(ts.tokens) + gr) // T) - len(ds.block_ids))
                for ts, ds, gr in zip(st_ts, st_ds, grows))
            return short_d <= d_eng.free_pages

        def acquire(grows: List[int]) -> None:
            for st, gr in zip(st_ts, grows):
                self._acquire_for(t_eng, st, gr)
            for ts, ds, gr in zip(st_ts, st_ds, grows):
                self._acquire_for(d_eng, ds, gr, base_len=len(ts.tokens))

        def load(n_max: List[int]) -> None:
            """Point ``g`` at the key of the current block tables and load
            every row's state from the host (pad rows: a fixed length at
            their budget, tables of ``n_blocks``)."""
            nonlocal g
            t_table = t_eng._block_table(st_ts, pad_to=Bp)
            d_table = d_eng._block_table(st_ds, pad_to=Bp)
            g = self._graph(("draft", Bp, t_table.shape[1],
                             d_table.shape[1], k, variant))
            pad_n = [k + 2] * npad

            def i32(rows):
                return torch.from_numpy(np.asarray(rows, np.int32))

            with t_eng._on_engine_stream():
                g.t_table.copy_(torch.from_numpy(t_table))
                g.n.copy_(i32([len(st.tokens) for st in st_ts] + pad_n))
                # a serving group's followers start from the same state
                t_eng._op("spec_load", follow_key(g), n=g.n,
                          table=g.t_table)
                g.d_table.copy_(torch.from_numpy(d_table))
                g.n_max.copy_(i32(list(n_max) + pad_n))
                g.win.copy_(i32([st.tokens[-(k + 2):] for st in st_ts]
                                + [[0] * (k + 2)] * npad))
                torch.stack([st.last_logits for st in st_ds],
                            out=g.dlog[:B])
                g.dlog[B:].zero_()
                if variant != "greedy":
                    ones = np.ones(npad, np.float32)
                    g.temp.copy_(torch.from_numpy(np.concatenate(
                        [np.maximum(temp, 1e-6), ones])))
                    g.top_k.copy_(i32(list(tk) + [0] * npad))
                    g.top_p.copy_(torch.from_numpy(np.concatenate(
                        [tp, ones]).astype(np.float32)))
                    g.rowkey.copy_(_row_keys([None] * Bp, base))

        inflight: "deque" = deque()  # (token snapshot, R)
        # per-row progress bounds over confirmed + in-flight work: floor
        # assumes 1 token/round, exp uses the controller's EWMA
        floor_rows = [0] * B
        exp_rows = [0.0] * B

        def launch(R: int) -> None:
            nonlocal launched
            launched = True
            # one dispatch = R complete rounds for every row, then the
            # refresh: the unit the step profiler's accepted-per-dispatch
            # attribution divides by
            _stepprof.note_dispatch("spec_round")
            with t_eng._on_engine_stream():
                g.r.zero_()
                t_eng._op(
                    "spec_rounds", follow_key(g), R,
                    body=lambda R: run_body(
                        t_eng, g, g.round, lambda: self._round_body(g),
                        f"spec_round{g.key}", R, self._engines),
                    refresh=lambda: run_body(
                        t_eng, g, g.refresh, lambda: self._refresh_body(g),
                        f"spec_refresh{g.key}", 1, self._engines))
                snap = torch.cat([g.outs[:R].flatten(), g.cnts[:R].flatten(),
                                  g.ms[:R].flatten()])
            inflight.append((snap, R))
            for b in range(B):
                floor_rows[b] = min(n_steps, floor_rows[b] + R)
                exp_rows[b] = min(float(n_steps),
                                  exp_rows[b] + R * ctls[b].rate)

        def drain() -> None:
            snap, R = inflight.popleft()
            # the chunk's one BLOCKING host sync
            _stepprof.note_sync("spec_tokens")
            h = snap.cpu().numpy()
            n_o = R * Bp * (k + 1)
            h_outs = h[:n_o].reshape(R, Bp, k + 1)
            h_cnts = h[n_o:n_o + R * Bp].reshape(R, Bp)[:, :B]
            h_ms = h[n_o + R * Bp:].reshape(R, Bp)[:, :B]
            for b in range(B):
                new_toks: List[int] = []
                for r in range(R):
                    c = int(h_cnts[r, b])
                    if c:
                        new_toks.extend(int(x) for x in h_outs[r, b, :c])
                outs_h[b].extend(new_toks)
                st_ts[b].tokens.extend(new_toks)
                st_ds[b].tokens = list(st_ts[b].tokens)
                eff = int((h_cnts[:, b] > 0).sum())
                if eff:
                    ctls[b].update(len(new_toks), eff)
            self.rounds += R * B
            self.proposed += R * B * k
            self.accepted += int(h_ms.sum())
            infl_R = sum(r for _s, r in inflight)
            for b in range(B):
                conf = len(outs_h[b])
                floor_rows[b] = min(n_steps, conf + infl_R)
                exp_rows[b] = min(float(n_steps),
                                  conf + infl_R * ctls[b].rate)

        def choose_R() -> int:
            if self.adaptive:
                return max(ctls[b].suggest(int(math.ceil(
                    n_steps - exp_rows[b]))) for b in range(B))
            # static policy: largest bucket until the tail
            rem = n_steps - min(floor_rows)
            return (buckets[-1] if rem > 2 * (k + 1)
                    else buckets[min(1, len(buckets) - 1)])

        def settle_logits() -> None:
            # both engines decode-ready: the newest dispatch's refresh
            # rewrote each row's last accepted token's KV slot and produced
            # the logits after it
            with t_eng._on_engine_stream():
                for b in range(B):
                    st_ts[b].last_logits = g.t_logits[b].clone()
                    st_ds[b].last_logits = g.dlog[b].clone()

        try:
            if fits([n_steps + k] * B):
                # fast path: the whole chunk's pages up front (budget + k
                # slack for the clamped rounds' past-budget writes), one
                # block table, one device-resident budget
                acquire([n_steps + k] * B)
                load([n + n_steps for n in lens0])
                while True:
                    if (min(len(o) for o in outs_h) >= n_steps
                            and not inflight):
                        break
                    if not inflight:
                        launch(choose_R())
                    # double-buffer: when the in-flight work's EXPECTED
                    # yield still leaves budget, enqueue the next dispatch
                    # before this one's tokens land (adaptive mode only)
                    if (self.adaptive and len(inflight) < 2
                            and min(exp_rows) < n_steps):
                        launch(choose_R())
                    drain()
            else:
                # degraded serial mode (memory pressure): size, acquire and
                # drain per dispatch; R steps DOWN through the bucket set
                # until the growth fits, and the smallest bucket that still
                # doesn't fit raises out of the acquire
                while min(len(o) for o in outs_h) < n_steps:
                    rems = [n_steps - len(o) for o in outs_h]
                    R = choose_R()
                    while True:
                        grows = [min(R * (k + 1), r + k) for r in rems]
                        if R == buckets[0] or fits(grows):
                            break
                        R = max(b for b in buckets if b < R)
                    acquire(grows)
                    load([len(st.tokens) + min(r, R * (k + 1))
                          for st, r in zip(st_ts, rems)])
                    launch(R)
                    drain()
                    settle_logits()
        except MemoryError:
            # a pool ran dry (degraded mode raises from the acquire BEFORE
            # a dispatch): every completed dispatch's tokens are on
            # st.tokens, so restoring decode-readiness is all that's left
            while inflight:
                drain()
            if launched:
                settle_logits()
            raise
        settle_logits()
        return outs_h

    def _rounds(self, st_t, st_d, n_steps, sample, temperature, top_k,
                top_p, rng) -> List[int]:
        """The host round loop (prompts shorter than the fused window, or
        ``fuse_rounds`` off): the draft's decode or ``propose``, the
        target's eager ``verify``, the decision on the device with its
        result read on the host, the draft's resync; eager on the card
        too."""
        out: List[int] = []
        k = self.k
        dev = self.target.device
        if sample != "greedy":
            gen = rng if rng is not None else self._gen
            base = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                     device=gen.device))
            rowkey = _row_keys([None], base).to(dev)
            use_filter = top_k > 0 or top_p < 1.0

            def vec(x, dt):
                return torch.tensor([x], dtype=dt, device=dev)

            temp_v = vec(max(temperature, 1e-6), torch.float32)
            tk_v, tp_v = vec(top_k, torch.int32), vec(top_p, torch.float32)
        while len(out) < n_steps:
            prev = st_t.tokens[-1]
            if sample == "greedy":
                # 1. the draft proposes k tokens (advances st_d by k)
                proposals = self.draft.decode(st_d, k)
                # 2. the target scores [prev, p_1..p_k] in one forward
                logits = self.target.verify(st_t, [prev] + proposals,
                                            len(st_t.tokens) - 1)
                choices = torch.argmax(logits.float(), dim=-1).cpu().tolist()
                # 3. accept while the draft agreed, then take the target's
                m = 0
                while m < k and proposals[m] == choices[m]:
                    m += 1
                emitted = proposals[:m] + [choices[m]]
            else:
                n = len(st_t.tokens)
                # 1. the draft samples k tokens AND the exact
                # distributions they came from (q stays on the device)
                proposals, q = self.draft.propose(
                    st_d, k, temperature=temperature, top_k=top_k,
                    top_p=top_p, rng=rng)
                logits = self.target.verify(st_t, [prev] + proposals, n - 1)
                # 2. the whole accept/reject/residual/bonus decision on the
                # device; only (m, replacement) come to the host
                us = _accept_uniforms(
                    rowkey, torch.tensor([n], dtype=torch.int32, device=dev),
                    k)
                m_d, repl_d = _spec_decide(
                    logits[None], q[None],
                    torch.tensor([proposals], dtype=torch.int32, device=dev),
                    us, temp_v, tk_v, tp_v, use_filter)
                m, repl = (int(x) for x in torch.cat([m_d, repl_d]).cpu())
                emitted = proposals[:m] + [repl]
            self.rounds += 1
            self.proposed += k
            self.accepted += m
            st_t.tokens.extend(emitted)
            out.extend(emitted)
            # 4. resync the draft onto the accepted sequence (width-1 when
            # every proposal survived: the draft cache is already right)
            self._resync_draft(st_d, list(st_t.tokens), clean=(m == k))
        return out

    def generate(self, tokens: Sequence[int], n_steps: int,
                 **kw) -> List[int]:
        st_t, st_d = self.prefill(tokens)
        return self.decode(st_t, st_d, n_steps, **kw)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0
