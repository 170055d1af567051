"""Inference engine: paged prefill/decode with store-backed prefix reuse.

Counterpart of the reference's ``engine/engine.py``.  One class serves both
roles of a disaggregated deployment:

* as a *prefill* engine, ``prefill`` (and its resumable halves
  ``prefill_start`` / ``prefill_step``) computes the prompt, pages its KV
  into the device cache and, with a store connection (``conn``), streams
  every complete page to the InfiniStore server while the next chunk
  computes;
* as a *decode* engine, ``prefill`` finds the longest prefix resident
  locally, then in the store, adopts those pages instead of recomputing
  them and computes only the tail; ``decode`` / ``decode_batch`` run paged
  single-token steps from the device cache.

Store pages are the reference's bytes under the reference's keys, so a JAX
engine and this one hand prompts to each other through one store.

Both halves of the model run as CUDA graphs on the card, each one Python
body over static device buffers that runs eagerly on the CPU:

* a prefill chunk is the counterpart of the reference's ``_prefill_jit``:
  one chunk body over the chunk's tokens padded to a power-of-two bucket,
  a device ``prefix_len`` and the prefix KV at the bucket's capacity,
  captured once per (route, prefix capacity, chunk bucket) key, so one
  graph serves every prefix length of a bucket as the reference's traced
  ``prefix_len`` does (K2 reads the length from device memory);
* decode is the counterpart of the reference's compiled ``_decode_many``
  (one ``lax.scan`` per decode chunk, sampling on the device): one step
  body over static device buffers (logits, positions, block table, per-row
  sampling vectors, penalty state, an on-device step index, the chunk's
  output tokens), captured once per (batch bucket, table-width bucket,
  variant, logprobs, penalties) key and replayed ``decode_chunk`` times per
  host sync.

A key's first use runs its body eagerly on the engine's stream and is
captured after it.  A failed capture or replay raises: nothing falls back
to the eager body.  The whole prompt in one forward (``prefill_chunk``
None), the single chunk over an exact adopted prefix, ``prefill_batch``'s
padded groups and ``prompt_logprobs`` run eagerly, as their shapes follow
the prompt.  A prefill computes the LM head at one row, the last
token's.  Where the reference donates the cache to a
compiled scatter, this engine updates it in place (``index_put_`` /
``copy_``).  Page bookkeeping stays in Python, as in the reference.

Not in this engine yet (each raises when asked for): a clustered store
(``RoutedStorePool``), LoRA adapters and speculative decoding
(``propose`` / ``sampling_probs`` / ``verify``).
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..kv.cache import (
    BlockAllocator,
    PagedCacheConfig,
    PrefixPageCache,
    init_cache,
    pages_to_seq_kv,
    prefill_to_pages,
    read_pages,
    write_pages,
)
from ..kv.hashing import chunk_keys
from ..kv.transfer import KVTransferEngine
from ..models.llama import LlamaConfig, decode_forward, prefill_forward
from ..ops import cuda_attention as ca
from .. import usage as _usage
from ..utils import metrics as _metrics
from ..utils import tracing
from . import stepprof as _stepprof

# prefix-reuse attribution in the admission path: of each admitted prompt's
# tokens, how many were served by the LOCAL prefix cache, how many by the
# STORE tier, and how many had to be COMPUTED (the reference's family)
_PREFIX_TOKENS = _metrics.default_registry().counter(
    "istpu_engine_prefix_tokens_total",
    "Admitted prompt tokens by provenance: local prefix cache, store "
    "tier, or computed",
    labelnames=("source",),
)

# the tenant-resolved twin: same provenance split with the TENANT
# dimension, incremented only when a request's tenant is bound
# (usage.bind_account)
_PREFIX_TOKENS_TENANT = _metrics.default_registry().counter(
    "istpu_engine_tenant_prefix_tokens_total",
    "Admitted prompt tokens by tenant and provenance (local prefix "
    "cache / store tier / computed) — the tokens-saved side of the "
    "per-tenant cache-economics ledger",
    labelnames=("tenant", "source"),
)


def _truncate_logits(l: torch.Tensor, top_k: torch.Tensor,
                     top_p: torch.Tensor) -> torch.Tensor:
    """Apply per-row top-k, then top-p (nucleus) truncation to f32 logits
    ``l`` [B, V] (already temperature-scaled): tokens outside the kept set go
    to -inf.  ``top_k[b] == 0`` / ``top_p[b] == 1.0`` disable the respective
    truncation for that row.  One descending sort serves both; the nucleus
    is taken over the top-k-renormalised distribution, crossing token
    included.  A direct port of the reference's ``_truncate_logits``."""
    V = l.shape[-1]
    neg_inf = float("-inf")  # python scalars: no host-to-device copy
    sl = torch.sort(l, dim=-1, descending=True).values
    k = top_k.long().clamp(0, V)
    kth = torch.gather(sl, 1, (k - 1).clamp(0, V - 1)[:, None])
    kth = torch.where((k > 0)[:, None], kth, neg_inf)  # [B, 1]
    lk = torch.where(l < kth, neg_inf, l)  # top-k applied FIRST
    slk = torch.where(sl < kth, neg_inf, sl)
    probs = torch.softmax(slk, dim=-1)
    excl = torch.cumsum(probs, dim=-1) - probs
    # top_p >= 1.0 rows keep everything: an f32 cumsum can reach 1.0 before
    # the last survivor
    keep_all = (top_p >= 1.0)[:, None]
    kept = torch.where(keep_all | (excl < top_p[:, None]), slk, float("inf"))
    pthresh = torch.min(kept, dim=-1, keepdim=True).values  # [B, 1]
    return torch.where(lk < pthresh, neg_inf, lk)


def _round_up_pow2(n: int, base: int) -> int:
    """Smallest ``base * 2**k`` >= n: the bucketing rule shared by chunked
    prefill, batched prefill and the decode batch dimension."""
    b = base
    while b < n:
        b *= 2
    return b


def _pad_seq_axis(kv: torch.Tensor, cap: int) -> torch.Tensor:
    """Pad the sequence axis (index 3) of [L, 2, B, S, H, D] up to ``cap``
    (the bucketed prefix-buffer grow)."""
    return F.pad(kv, (0, 0, 0, 0, 0, cap - kv.shape[3]))


def _read_prefix_kv(cache: torch.Tensor, block_ids: List[int]) -> torch.Tensor:
    """Gather of a reused prefix: pages -> [L, 2, 1, n*T, H, D]."""
    ids = torch.tensor(block_ids, dtype=torch.long, device=cache.device)
    return pages_to_seq_kv(read_pages(cache, ids))


def _write_prefill_pages(cache: torch.Tensor, block_ids: List[int],
                         kv: torch.Tensor, block_tokens: int) -> torch.Tensor:
    """A prefill chunk's cache landing: [L, 2, B=1, S, H, D] KV -> pages ->
    scatter into the cache in place."""
    ids = torch.tensor(block_ids, dtype=torch.long, device=cache.device)
    return write_pages(
        cache, ids, prefill_to_pages(kv[:, :, 0], len(block_ids), block_tokens)
    )


def _write_group_pages(cache: torch.Tensor, block_ids: List[int],
                       kv: torch.Tensor, sel: np.ndarray,
                       block_tokens: int) -> torch.Tensor:
    """Batched-prefill cache landing: per-row KV [L, 2, B, S, H, D] -> every
    row's bucket pages, of which ``sel`` (flat ``row * pages_per_bucket +
    page`` selectors) picks each row's leading pages in ``block_ids``
    order."""
    L, two, B, S, H, D = kv.shape
    full = S // block_tokens
    pages = kv.reshape(L, two, B, full, block_tokens, H, D)
    pages = pages.permute(0, 1, 5, 2, 3, 4, 6).reshape(
        L, two, H, B * full, block_tokens, D
    )
    sel_t = torch.as_tensor(sel, dtype=torch.long).to(cache.device)
    ids = torch.tensor(block_ids, dtype=torch.long, device=cache.device)
    return write_pages(cache, ids, pages[:, :, :, sel_t])


class _StoreStreamer:
    """One background worker that pushes gathered KV pages to the store
    WHILE the next prefill chunk computes on the device (the reference's
    layer-by-layer KV write during prefill, at chunk granularity).

    The engine snapshots each chunk's pages with a device-side gather (a
    new tensor: later in-place cache writes cannot reach it) and hands
    them here.  ``submit`` runs ``push_begin`` on the engine thread (an
    event on the compute stream, microseconds); this thread runs
    ``push_commit`` (the copies, ordered after that event on the transfer's
    copy stream, and COMMIT_PUT).  A single worker serializes store ops, and
    ``flush()`` joins the queue so prefill still returns with every page
    durably in the store.  The first push error parks, skips the rest
    (fail-fast on a dead store), and re-raises at the next flush, which
    also CLEARS it, so pushes resume afterwards.

    Failure semantics: every skipped or failed push is COUNTED
    (``istpu_store_push_dropped_total{reason=}``) and the flush-time
    re-raise carries the dropped-chunk count; transport failures feed the
    transfer's circuit breaker, and while the circuit is open pushes are
    skipped without touching the wire.  Strict durability gets ONE bounded
    retry per push before the error parks; relaxed mode fails straight to
    the counted-drop path."""

    def __init__(self, transfer: KVTransferEngine, maxsize: int = 2,
                 durability: str = "strict"):
        import queue
        import threading

        self._transfer = transfer
        self._durability = durability
        # bounded: each queued item pins a chunk's gathered pages in device
        # memory, so a store slower than compute backpressures prefill
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._err: Optional[BaseException] = None
        self._dropped = 0  # chunks dropped since the last flush
        self._started = False
        # per-request flush markers: every submit is tagged with the
        # submitting request's trace id, and ``flush(marker=...)`` waits
        # ONLY on that request's pushes
        self._cond = threading.Condition()
        self._pending: Dict[object, int] = {}
        self._marker_errs: "OrderedDict[object, BaseException]" = (
            OrderedDict()
        )

    def submit(self, pages, chunk_keys_) -> None:
        if not self._started:
            import threading

            threading.Thread(
                target=self._run, name="istpu-kv-stream", daemon=True
            ).start()
            self._started = True
        # the critical-path half runs HERE, on the submitting thread; the
        # request's trace id and account ride along so the worker attributes
        # the push (and bills the store's ALLOC_PUT frames) to the request
        # that paid for it
        tid = tracing.current_trace_id()
        acct = _usage.current_account()
        with self._cond:
            self._pending[tid] = self._pending.get(tid, 0) + 1
        self._q.put((self._transfer.push_begin(pages, chunk_keys_),
                     chunk_keys_, tid, acct))

    def _record_marker_err(self, tid, err: BaseException) -> None:
        if tid is None or err is None:
            return
        with self._cond:
            self._marker_errs[tid] = err
            while len(self._marker_errs) > 256:
                self._marker_errs.popitem(last=False)

    def _settle(self, tid) -> None:
        with self._cond:
            n = self._pending.get(tid, 1) - 1
            if n > 0:
                self._pending[tid] = n
            else:
                self._pending.pop(tid, None)
            self._cond.notify_all()

    def _run(self) -> None:
        from ..utils import resilience as _res

        while True:
            token, keys, tid, acct = self._q.get()
            try:
                if self._err is not None:
                    # parked error: skip queued items until the next
                    # flush() consumes it; the skipped request's own flush
                    # barrier sees the failure too
                    self._dropped += 1
                    self._record_marker_err(tid, self._err)
                    _res.count_push_dropped("parked_error")
                elif not self._transfer.breaker.allow():
                    # open circuit: don't even touch the wire
                    self._dropped += 1
                    _res.count_push_dropped("circuit_open")
                else:
                    with _usage.bind_account(acct):
                        self._push_one(token, keys, tid, _res)
            finally:
                self._settle(tid)
                self._q.task_done()

    def _push_one(self, token, keys, tid, _res) -> None:
        breaker = self._transfer.breaker
        attempts = 2 if self._durability == "strict" else 1
        for attempt in range(attempts):
            try:
                # the push span lands in the submitting request's trace
                # while it is addressable, else in a trace of its own
                with tracing.bind(tid) as owner:
                    if owner is not None:
                        with tracing.span("store.push_async",
                                          chunks=len(keys)):
                            self._transfer.push_commit(token)
                    else:
                        with tracing.trace("store.push_async",
                                           chunks=len(keys)):
                            self._transfer.push_commit(token)
                breaker.record_success()
                return
            except BaseException as e:  # noqa: BLE001 — reported at flush()
                if isinstance(e, _res.transport_errors()):
                    breaker.record_failure()
                last = attempt == attempts - 1
                if not last and breaker.allow():
                    # strict durability: one bounded retry; content-
                    # addressed keys make a replay harmless
                    time.sleep(0.05)
                    continue
                self._err = e
                self._dropped += 1
                self._record_marker_err(tid, e)
                _res.count_push_dropped("push_error")
                import logging

                logging.getLogger("infinistore_tpu").warning(
                    "store push of %d page keys failed (queued pushes "
                    "skipped until the next flush): %r", len(keys), e
                )
                return

    def flush(self, marker=None) -> None:
        """Wait for every submitted push; re-raise the first push error
        (its message carries how many queued chunks were dropped with
        it).  Clears the parked state, so pushes resume afterwards.

        With ``marker`` (a request's trace id), wait ONLY on that
        request's pushes (and pushes bound to no request) and raise ONLY
        its error."""
        if marker is None:
            self._q.join()
            err, self._err = self._err, None
            dropped, self._dropped = self._dropped, 0
            if err is not None:
                if dropped > 1:
                    err.args = (
                        f"{err} [{dropped} queued store pushes dropped "
                        f"with this error]",
                    )
                raise err
            return
        with self._cond:
            while (self._pending.get(marker, 0) > 0
                   or self._pending.get(None, 0) > 0):
                self._cond.wait()
            err = self._marker_errs.pop(marker, None)
        if err is not None:
            raise err


@dataclass
class SequenceState:
    seq_id: int
    tokens: List[int]
    block_ids: List[int]
    chunk_keys: List[str]
    reused_chunks: int = 0
    last_logits: Optional[torch.Tensor] = None  # [V], on the device
    # leading pages already returned to the pool by sliding-window
    # reclamation (ids stay in block_ids, masked off, so the table math is
    # unchanged)
    reclaimed_pages: int = 0
    # prefix provenance: of ``reused_chunks``, how many came from the local
    # prefix cache vs the store tier, and the wall seconds the store hops
    # (lookup + load) took
    local_chunks: int = 0
    store_chunks: int = 0
    store_load_s: float = 0.0


@dataclass
class PartialPrefill:
    """Resumable prefill: everything ``prefill_step`` needs to run the next
    chunk forward (chunked-prefill continuous batching)."""

    tokens: List[int]
    keys: List[str]
    block_ids: List[int]
    reused: int          # chunks satisfied from the prefix cache or store
    done: int            # pages written into the cache so far
    n_complete: int      # complete (store-eligible) chunks
    padded: List[int]    # suffix tokens padded to whole pages
    C: int               # tokens per chunk forward
    single: bool         # whole suffix fits one forward
    buf: Optional[torch.Tensor]  # bucketed prefix-KV buffer
    plen: int            # valid prefix length inside buf
    S: int               # unpadded suffix length
    off: int = 0         # next chunk offset into padded
    # provenance carried onto the SequenceState (see its fields)
    local_chunks: int = 0
    store_chunks: int = 0
    store_load_s: float = 0.0


class InferenceEngine:
    def __init__(
        self,
        params,
        cfg: LlamaConfig,
        pc: PagedCacheConfig,
        conn=None,
        model_id: str = "llama",
        prefill_chunk: Optional[int] = None,
        kv_quant: Optional[str] = "int8",
        decode_chunk: int = 32,
        store_durability: str = "strict",
        device=None,
    ):
        """``params``: the model's weights (``models.llama.init_params`` or
        ``models.convert.params_from_jax``), already on ``device``.

        ``device``: ``None`` means the GPU and raises when there is none;
        pass ``"cpu"`` to run the plain PyTorch versions of the kernels.

        ``conn``: an InfiniStore connection (``lib.InfinityConnection``);
        prefill then adopts store-resident prefixes and streams its pages
        to the store.  A clustered ``RoutedStorePool`` is not ported yet
        and raises.

        ``prefill_chunk``: process prompts in chunks of this many tokens (a
        multiple of ``pc.block_tokens``) instead of one full-sequence
        forward; later chunks attend to a bucketed prefix buffer through K2.

        ``kv_quant``: store pages int8-quantized (``kv/quant.py``), half
        the bytes per hop; device pages stay full precision.  The default,
        as in the reference.  ``None`` is the lossless hop (bitwise-exact
        store round trips).

        ``decode_chunk``: tokens per host sync in ``decode_batch`` (on the
        card: graph replays per sync).

        ``store_durability``: ``"strict"`` joins the store streamer before
        ``prefill`` returns (every page durably in the store, the prefill
        node's contract); ``"relaxed"`` returns once the last chunk's pages
        are queued, and ``store_flush()`` is the barrier."""
        if type(conn).__name__ == "RoutedStorePool":
            raise NotImplementedError(
                "a clustered store (RoutedStorePool) is not ported yet "
                "(ROADMAP.md queue 1 item 7); pass one store connection"
            )
        if pc.n_layers != cfg.n_layers:
            raise ValueError(f"cache has {pc.n_layers} layers, model "
                             f"{cfg.n_layers}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.pc = pc
        self.model_id = model_id
        self.params = params
        self.cache = init_cache(pc, self.device)
        self.alloc = BlockAllocator(pc.n_blocks)
        # automatic prefix caching: complete-chunk pages are content-
        # addressed by their prefix-commitment key and shared across
        # sequences (kv/cache.py PrefixPageCache)
        self.pages = PrefixPageCache(self.alloc)
        self.transfer = None if conn is None else KVTransferEngine(
            conn, pc, quant=kv_quant, device=self.device)
        if store_durability not in ("strict", "relaxed"):
            raise ValueError(
                f"store_durability must be 'strict' or 'relaxed', "
                f"got {store_durability!r}"
            )
        self.store_durability = store_durability
        # every store hop rides the transfer's circuit breaker, so a dead or
        # hung store degrades to recompute instead of failing requests
        self.breaker = self.transfer.breaker if self.transfer else None
        # relaxed mode must not backpressure prefill on a slow store, so its
        # queue holds a long prompt's chunks; strict keeps the 2-chunk
        # device-memory bound (flush joins anyway)
        self._streamer = (
            _StoreStreamer(
                self.transfer,
                maxsize=(64 if store_durability == "relaxed" else 2),
                durability=store_durability,
            )
            if self.transfer is not None else None
        )
        if prefill_chunk is not None and prefill_chunk % pc.block_tokens:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be a "
                             f"multiple of block_tokens={pc.block_tokens}")
        self.prefill_chunk = prefill_chunk
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.decode_chunk = int(decode_chunk)
        self.seqs: Dict[int, SequenceState] = {}
        self._next_id = 0
        # the engine's own host generator: one base seed per unseeded
        # decode call (callers may pass theirs)
        self._gen = torch.Generator()
        self._gen.manual_seed(0)
        # the decode graphs: static buffers (and, on the card, the
        # captured step) per key; every graph of this engine replays on
        # its own stream, one at a time, out of one shared memory pool.
        # The stream is the engine's: two engines in one process never
        # share K1's per-stream workspace.
        self._graphs: Dict[tuple, "_DecodeGraph"] = {}
        # the prefill graphs, by (route, prefix capacity, chunk bucket),
        # and the static buffers they share, since they replay one at a
        # time: the device prefix length, the logits row, the outputs (at
        # the largest bucket) and one prefix buffer per capacity
        self._prefill_graphs: Dict[tuple, "_PrefillGraph"] = {}
        self._pf_shared: Dict[str, torch.Tensor] = {}
        self._pf_prefix: Dict[int, torch.Tensor] = {}
        self._pool = None
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        # per graph kind ("decode", "prefill"): captures and their
        # seconds, replays and the host seconds spent issuing them (no
        # sync inside); ``graph_launches`` reads what the replays launched
        self.graph_captures = dict.fromkeys(_GRAPH_KINDS, 0)
        self.graph_capture_s = dict.fromkeys(_GRAPH_KINDS, 0.0)
        self.graph_replays = dict.fromkeys(_GRAPH_KINDS, 0)
        self.graph_replay_s = dict.fromkeys(_GRAPH_KINDS, 0.0)
        # the vocabulary's share of the counter-based sampling hash
        self._vocab_hash = (torch.arange(cfg.vocab_size, dtype=torch.long,
                                         device=self.device)
                            * 0x9E3779B9) & _M32

    def _tokens(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.int32, device=self.device)

    # ---- prefill ----

    def prefill(self, tokens: Sequence[int],
                adapter_id: int = 0) -> SequenceState:
        """Prompt ingestion: runs every prefill chunk back to back.  The
        resumable halves (``prefill_start`` / ``prefill_step``) let the
        scheduler interleave a newcomer's chunks with the batch's decode.
        ``adapter_id`` other than 0 (a LoRA adapter) raises."""
        with tracing.span("engine.prefill", tokens=len(tokens)):
            pp = self.prefill_start(tokens, adapter_id=adapter_id)
            while True:
                st = self.prefill_step(pp)
                if st is not None:
                    return st

    def prefill_start(self, tokens: Sequence[int],
                      adapter_id: int = 0) -> PartialPrefill:
        """Admission half of a prefill: prefix-reuse lookup, page
        acquisition, store prefix load and chunking setup.  Compute happens
        in subsequent ``prefill_step`` calls (one chunk forward each)."""
        _no_lora(adapter_id)
        T = self.pc.block_tokens
        tokens = list(tokens)
        S_total = len(tokens)
        if S_total < 1:
            raise ValueError("empty prompt")
        keys = chunk_keys(tokens, self.model_id, chunk_tokens=T)

        # longest reusable prefix, capped so >= 1 token is computed
        # (decoding needs the last token's logits).  Cheapest first: pages
        # resident locally, then the store (zero compute, one load)
        max_reuse = (S_total - 1) // T
        local_ids = self.pages.match_prefix(keys[:max_reuse])  # pins hits
        reused = len(local_ids)
        store_load_s = 0.0  # wall seconds spent on store hops
        if self.transfer is not None and keys and reused < max_reuse:
            # breaker-guarded: a dead/hung store (or an open circuit)
            # reports 0, a prefix-cache miss, never a failed request
            t_store = time.perf_counter()
            reused = max(
                reused,
                min(self.transfer.guarded_lookup_prefix(keys), max_reuse),
            )
            store_load_s += time.perf_counter() - t_store
        P = reused * T

        n_pages_total = -(-S_total // T)
        try:
            fresh_ids = self.pages.acquire(n_pages_total - len(local_ids))
        except MemoryError:
            self.pages.unpin(local_ids)
            raise
        block_ids = local_ids + fresh_ids

        if reused > len(local_ids):  # store hop for the non-local part
            # guarded: an eviction race or a transport failure mid-load
            # leaves the cache untouched; fall back to the local prefix and
            # recompute the rest instead of failing the request
            t_store = time.perf_counter()
            self.cache, ok = self.transfer.guarded_load(
                self.cache,
                block_ids[len(local_ids):reused],
                keys[len(local_ids):reused],
            )
            store_load_s += time.perf_counter() - t_store
            if not ok:
                reused = len(local_ids)
                P = reused * T
        # provenance accounting AFTER the load settled (a failed store load
        # degrades those chunks back to computed, and counts so)
        local_chunks = min(len(local_ids), reused)
        if local_chunks:
            _PREFIX_TOKENS.labels("local").inc(local_chunks * T)
        if reused > local_chunks:
            _PREFIX_TOKENS.labels("store").inc((reused - local_chunks) * T)
        _PREFIX_TOKENS.labels("computed").inc(S_total - P)
        tenant = _usage.current_account()
        if tenant is not None:
            if local_chunks:
                _PREFIX_TOKENS_TENANT.labels(tenant, "local").inc(
                    local_chunks * T)
            if reused > local_chunks:
                _PREFIX_TOKENS_TENANT.labels(tenant, "store").inc(
                    (reused - local_chunks) * T)
            _PREFIX_TOKENS_TENANT.labels(tenant, "computed").inc(S_total - P)
        prefix_kv = _read_prefix_kv(self.cache, block_ids[:reused]) \
            if reused else None  # [L, 2, 1, n*T, H, D]

        # compute the tail, padded to whole pages, ``prefill_chunk`` tokens
        # per forward; the prefix of a later chunk lives in a buffer bucketed
        # at power-of-two capacities with a host-side valid length
        suffix = tokens[P:]
        S = len(suffix)
        padded = suffix + [0] * ((-S) % T)
        C = self.prefill_chunk or len(padded)
        single = C >= len(padded)
        if single:
            buf, plen = prefix_kv, P  # exact buffer: no slack, K3 at q_offset=P
        elif prefix_kv is not None:
            buf, plen = _pad_seq_axis(prefix_kv, _round_up_pow2(P, C)), P
        else:
            buf, plen = None, 0
        return PartialPrefill(
            tokens=tokens, keys=keys, block_ids=block_ids, reused=reused,
            done=reused, n_complete=S_total // T, padded=padded, C=C,
            single=single, buf=buf, plen=plen, S=S,
            local_chunks=local_chunks, store_chunks=reused - local_chunks,
            store_load_s=store_load_s,
        )

    def prefill_step(self, pp: PartialPrefill,
                     eager: bool = False) -> Optional[SequenceState]:
        """One prefill chunk forward plus its cache landing.  Returns the
        finished SequenceState on the last chunk, else None.

        With ``prefill_chunk`` set, the chunk runs through its key's
        prefill-graph body (``_prefill_chunk``): on the card the key's CUDA
        graph replays it, and ``eager=True`` runs the body eagerly there
        too (the graphs' yardstick in the card tests and
        ``chip_smoke.py``).  Two routes run ``prefill_forward`` itself, as
        their shape follows the prompt: the whole prompt in one forward
        (``prefill_chunk`` None) and the single chunk over an exact
        adopted prefix (K3 at ``q_offset = P``)."""
        T = self.pc.block_tokens
        off, C = pp.off, pp.C
        chunk = pp.padded[off: off + C]
        n = len(chunk)
        # the only logits row a prefill needs: the prompt's last token's
        # (any row of a chunk that is not the last)
        last = max(0, min(pp.S - 1 - off, n - 1))
        with self._on_engine_stream():
            if self.prefill_chunk is None or (pp.single and
                                              pp.buf is not None):
                logits, kv = prefill_forward(
                    self.params, self.cfg, self._tokens([chunk]),
                    prefix_kv=pp.buf, logits_rows=torch.tensor(
                        [last], dtype=torch.long, device=self.device))
            else:
                logits, kv = self._prefill_chunk(pp, chunk, last, eager)
                kv = kv[:, :, :, :n]  # the bucket's pad rows stay out
            # the chunk forward + its cache landing: one prefill dispatch
            # unit for the step profiler
            _stepprof.note_dispatch("prefill")
            n_pg = n // T
            self.cache = _write_prefill_pages(
                self.cache, pp.block_ids[pp.done: pp.done + n_pg], kv, T
            )
            prev_done, pp.done = pp.done, pp.done + n_pg
            # stream this chunk's complete pages to the store NOW: the
            # gather is queued behind the cache write on the compute
            # stream, the streamer's copies run while the next chunk
            # computes
            if self.transfer is not None:
                lo, hi = max(prev_done, pp.reused), min(pp.done,
                                                        pp.n_complete)
                if hi > lo:
                    self._streamer.submit(
                        self.transfer.gather_pages(self.cache,
                                                   pp.block_ids[lo:hi]),
                        pp.keys[lo:hi],
                    )
            pp.off = off + C
            if pp.off < len(pp.padded):
                # another chunk attends to this KV: grow the bucketed
                # prefix buffer and append in place
                need = pp.plen + n
                ncap = _round_up_pow2(need, C)
                if pp.buf is None:
                    pp.buf = _pad_seq_axis(kv, ncap)
                else:
                    if ncap > pp.buf.shape[3]:
                        pp.buf = _pad_seq_axis(pp.buf, ncap)
                    pp.buf[:, :, :, pp.plen: need] = kv
                pp.plen = need
                return None
            # a copy, and taken now: a graph's logits are rewritten by the
            # next replay
            last_logits = logits[0, 0].clone()

        # finished.  Strict durability joins the pusher so the pages are
        # durably in the store before the state is visible; relaxed returns
        # now and store_flush() is the barrier
        if self.transfer is not None and self.store_durability == "strict":
            self._streamer.flush()

        # name this sequence's complete-chunk pages so later prefills can
        # share them in place (no-op for keys already resident)
        self.pages.register(
            pp.keys[: pp.n_complete], pp.block_ids[: pp.n_complete]
        )
        state = SequenceState(
            seq_id=self._next_id,
            tokens=pp.tokens,
            block_ids=pp.block_ids,
            chunk_keys=pp.keys,
            reused_chunks=pp.reused,
            last_logits=last_logits,
            local_chunks=pp.local_chunks, store_chunks=pp.store_chunks,
            store_load_s=pp.store_load_s,
        )
        self._next_id += 1
        self.seqs[state.seq_id] = state
        return state

    @contextlib.contextmanager
    def _on_engine_stream(self):
        """Run the block on the engine's stream (on the card), ordered after
        the caller's stream on entry and before it on exit: every graph of
        the engine is captured and replayed there, one at a time."""
        stream = self._stream
        if stream is None:
            yield
            return
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            current.wait_stream(stream)

    def _prefill_chunk(self, pp: PartialPrefill, chunk: List[int],
                       last: int, eager: bool):
        """A chunk's (logits of row ``last`` [1, 1, V], kv [L, 2, 1, Cb, H,
        D]) through its key's prefill-graph body: the tokens padded to the
        bucket, the row index, ``pp``'s valid prefix rows and length copied
        into the key's static buffers, then the body run eagerly (on the
        CPU, with ``eager``, and at a key's first use, which captures the
        key after it) or the key's graph replayed.  The outputs are the
        prefill graphs' shared static tensors, rewritten by the next
        prefill chunk."""
        n = len(chunk)
        Cb = _round_up_pow2(n, self.pc.block_tokens)
        if pp.buf is None:
            key = ("causal", 0, Cb)
        else:
            key = ("prefix", pp.buf.shape[3], Cb)
        g = self._prefill_graph(key)
        g.tokens.copy_(torch.tensor([chunk + [0] * (Cb - n)],
                                    dtype=torch.int32))
        g.last.fill_(last)
        if g.buf is not None:
            # several partial prefills share the buffer: each chunk brings
            # its own prefix in (the slack past ``plen`` is masked)
            g.plen.fill_(pp.plen)
            g.buf[:, :, :, :pp.plen].copy_(pp.buf[:, :, :, :pp.plen])
        if eager or self.device.type != "cuda":
            self._prefill_body(g)
        elif g.graph is None:
            self._prefill_body(g)
            self._capture_graph(g, lambda: self._prefill_body(g),
                                f"prefill{key}", "prefill")
            g.param_ptrs = self._param_ptrs()
        else:
            if g.param_ptrs != self._param_ptrs():
                # the graph reads the weights it was captured with
                raise RuntimeError("the weights moved since this prefill "
                                   "graph was captured")
            self._replay(g, "prefill")
        return g.logits, g.kv

    def _prefill_graph(self, key: tuple) -> "_PrefillGraph":
        """``key``'s prefill graph, made at its first use over the shared
        static buffers (the KV output at the largest bucket a chunk of
        ``prefill_chunk`` tokens takes)."""
        g = self._prefill_graphs.get(key)
        if g is not None:
            return g
        route, cap, Cb = key
        cfg, dev = self.cfg, self.device
        dtype = self.params["lm_head"].dtype
        sh = self._pf_shared
        if not sh:
            rows = _round_up_pow2(self.prefill_chunk, self.pc.block_tokens)
            sh.update(
                plen=torch.zeros((), dtype=torch.int32, device=dev),
                last=torch.zeros((1,), dtype=torch.long, device=dev),
                logits=torch.zeros((1, 1, cfg.vocab_size), dtype=dtype,
                                   device=dev),
                kv=torch.zeros(cfg.n_layers * 2 * rows * cfg.n_kv_heads
                               * cfg.head_dim, dtype=dtype, device=dev))
        buf = None
        if route == "prefix":
            buf = self._pf_prefix.get(cap)
            if buf is None:
                buf = self._pf_prefix[cap] = torch.zeros(
                    (cfg.n_layers, 2, 1, cap, cfg.n_kv_heads, cfg.head_dim),
                    dtype=dtype, device=dev)
        kv_shape = (cfg.n_layers, 2, 1, Cb, cfg.n_kv_heads, cfg.head_dim)
        g = self._prefill_graphs[key] = _PrefillGraph(
            key, torch.zeros((1, Cb), dtype=torch.int32, device=dev),
            sh["last"], sh["plen"] if buf is not None else None, buf,
            sh["logits"], sh["kv"][:math.prod(kv_shape)].view(kv_shape))
        return g

    def _prefill_body(self, g: "_PrefillGraph") -> None:
        """The prefill chunk body over ``g``'s static buffers: K3 over the
        bucket's tokens, or K2 over the prefix buffer with the device
        ``prefix_len``; the logits of row ``g.last`` and the chunk's KV land
        in the shared outputs.  The same code runs eagerly on the CPU and
        is what a CUDA graph captures on the card."""
        logits, kv = prefill_forward(self.params, self.cfg, g.tokens,
                                     prefix_kv=g.buf, prefix_len=g.plen,
                                     logits_rows=g.last)
        g.logits.copy_(logits)
        g.kv.copy_(kv)

    def _param_ptrs(self) -> tuple:
        p = self.params
        return tuple(t.data_ptr() for t in (
            p["embed"], p["lm_head"], p["ln_out"], *p["layers"].values()))

    def adopt_prefill(self, tokens: Sequence[int], kv: torch.Tensor,
                      last_logits: torch.Tensor) -> SequenceState:
        """Adopt prompt KV computed OUTSIDE this engine and return a
        decode-ready ``SequenceState``: the ingestion point for external
        prefill producers honouring ``prefill_forward``'s KV contract
        (``kv`` [L, 2, 1, S, Hkv, D], K after RoPE; ``last_logits`` [V],
        the last real position's row).

        ``S`` must be a whole number of pages and >= ``len(tokens)`` (pad
        the prompt to the page bucket: causal masking keeps pad KV out of
        real positions' attention, and ``seq_lens`` masks it during
        decode).  Nothing registers in the prefix cache and nothing
        streams to the store: external KV carries no prefix-commitment
        chain, so it is private to this sequence."""
        T = self.pc.block_tokens
        if kv.dim() != 6 or kv.shape[2] != 1:
            raise ValueError(f"adopted KV must be [L, 2, 1, S, Hkv, D], got "
                             f"{tuple(kv.shape)}")
        S = kv.shape[3]
        if S % T != 0 or S < len(tokens):
            raise ValueError(
                f"adopted KV must cover the prompt in whole pages: "
                f"S={S}, block_tokens={T}, len(tokens)={len(tokens)}")
        ids = self.pages.acquire(S // T)
        self.cache = _write_prefill_pages(
            self.cache, ids, kv.to(self.device, self.cache.dtype), T)
        state = SequenceState(
            seq_id=self._next_id, tokens=list(tokens), block_ids=list(ids),
            chunk_keys=[],
            last_logits=last_logits.to(self.device,
                                       self.params["lm_head"].dtype),
        )
        self._next_id += 1
        self.seqs[state.seq_id] = state
        return state

    def pin_prefix(self, tokens: Sequence[int], adapter_id: int = 0) -> int:
        """Pin a prompt's chunk stems hot in a store cluster (the
        system-prompt API).  A no-op returning 0 on one store node: it has
        nowhere to replicate, and the clustered store is not ported yet."""
        _no_lora(adapter_id)
        pin = getattr(self.transfer, "pin_prefix", None)
        if pin is None:
            return 0
        return pin(chunk_keys(tokens, self.model_id,
                              chunk_tokens=self.pc.block_tokens))

    def store_flush(self, marker=None) -> None:
        """Durability barrier: wait until every queued store push has
        landed, re-raising the first push error.  A no-op without a store.
        Under ``store_durability="relaxed"`` this is the point where a
        prefill's pages become visible to other hosts.  ``marker`` (a
        request's trace id) scopes the wait to that request's pushes."""
        if self._streamer is not None:
            self._streamer.flush(marker=marker)

    def abandon_prefill(self, pp: PartialPrefill) -> None:
        """Cancel a partial prefill: release its pages.  No streamer join:
        queued pushes hold their own gathered snapshots, not the pages
        being released."""
        self.pages.unpin(pp.block_ids)
        pp.block_ids = []

    def prefill_batch(
        self, prompts: Sequence[Sequence[int]],
        adapter_ids: Optional[Sequence[int]] = None,
    ) -> List[SequenceState]:
        """Prefill several prompts (the scheduler's admission wave).

        Prompts are grouped by their power-of-two length bucket and each
        group runs as ONE padded forward (batch dim also bucketed).  A prompt
        with a locally cached prefix, or sharing its first chunk with an
        earlier prompt of the wave, runs the per-sequence reuse path after
        the groups; so do singleton groups and groups whose padded tokens
        would exceed ``prefill_chunk``.  With a store attached every prompt
        runs the per-sequence path (each one's reusable prefix differs).

        On page exhaustion mid-batch, states created so far are released
        before the MemoryError propagates."""
        prompts = [list(p) for p in prompts]
        if not prompts or any(len(p) < 1 for p in prompts):
            raise ValueError("prefill_batch needs non-empty prompts")
        for aid in adapter_ids or ():
            _no_lora(aid)
        T = self.pc.block_tokens
        out: List[Optional[SequenceState]] = [None] * len(prompts)
        created: List[SequenceState] = []
        try:
            if self.transfer is not None:
                # with a store each sequence's reusable prefix differs:
                # the per-sequence path, as the reference
                for i, p in enumerate(prompts):
                    st = self.prefill(p)
                    created.append(st)
                    out[i] = st
                return out  # type: ignore[return-value]
            groups: Dict[int, List[int]] = {}
            deferred: List[int] = []
            wave_chunk0: set = set()
            for i, p in enumerate(prompts):
                ks = chunk_keys(p, self.model_id, chunk_tokens=T)
                cap = (len(p) - 1) // T
                if self.pages.peek_prefix(ks[:cap]) > 0 or (
                    cap > 0 and ks[0] in wave_chunk0
                ):
                    deferred.append(i)
                    continue
                if cap > 0:
                    wave_chunk0.add(ks[0])
                groups.setdefault(_round_up_pow2(len(p), T), []).append(i)

            for bucket, idxs in groups.items():
                if len(idxs) == 1 or (
                    self.prefill_chunk is not None
                    and len(idxs) * bucket > self.prefill_chunk
                ):
                    states = []
                    for i in idxs:
                        st = self.prefill(prompts[i])
                        created.append(st)
                        states.append(st)
                else:
                    states = self._prefill_group(
                        [prompts[i] for i in idxs], bucket)
                    created.extend(states)
                for i, st in zip(idxs, states):
                    out[i] = st

            for i in deferred:  # now the wave's pages are registered
                st = self.prefill(prompts[i])
                created.append(st)
                out[i] = st
        except MemoryError:
            for st in created:
                self.release(st)
            raise
        return out  # type: ignore[return-value]

    def _prefill_group(self, group: List[List[int]],
                       bucket: int) -> List[SequenceState]:
        """One padded forward + one cache scatter for a same-bucket group."""
        T = self.pc.block_tokens
        B = len(group)
        Bp = _round_up_pow2(B, 1)
        n_pages_each = [-(-len(p) // T) for p in group]
        ids_all = self.pages.acquire(sum(n_pages_each))  # before any mutation
        tokens = np.zeros((Bp, bucket), dtype=np.int32)
        for b, p in enumerate(group):
            tokens[b, : len(p)] = p
        logits, kv = prefill_forward(
            self.params, self.cfg, torch.from_numpy(tokens).to(self.device))
        _stepprof.note_dispatch("prefill")  # one padded group forward
        full = bucket // T
        sel = np.concatenate([
            b * full + np.arange(n_pg) for b, n_pg in enumerate(n_pages_each)
        ])
        self.cache = _write_group_pages(self.cache, ids_all, kv, sel, T)
        last = torch.tensor([len(p) - 1 for p in group], device=self.device)
        last_rows = logits[torch.arange(B, device=self.device), last]
        states = []
        off = 0
        for b, p in enumerate(group):
            n_pg = n_pages_each[b]
            st = SequenceState(
                seq_id=self._next_id,
                tokens=list(p),
                block_ids=list(ids_all[off: off + n_pg]),
                chunk_keys=chunk_keys(p, self.model_id, chunk_tokens=T),
                last_logits=last_rows[b],
            )
            self.pages.register(st.chunk_keys, st.block_ids[: len(p) // T])
            self._next_id += 1
            self.seqs[st.seq_id] = st
            states.append(st)
            off += n_pg
        return states

    # ---- decode ----

    def _decode_graph(self, key) -> "_DecodeGraph":
        """The static buffers (and, on the card, the captured step) of one
        decode-graph key, made at its first use."""
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _DecodeGraph(
                key, self.cfg.vocab_size, self.params["lm_head"].dtype,
                self.device)
        return g

    def _step(self, g: "_DecodeGraph") -> None:
        """One decode step over ``g``'s static buffers: pick each row's
        token from ``g.logits`` (penalties, temperature, truncation and the
        counter-based Gumbel draw on the device), write its KV, run the
        model, and advance positions and the on-device step index.  The
        same code runs eagerly on the CPU and is what a CUDA graph
        captures on the card."""
        T = self.pc.block_tokens
        tok = _pick(g.logits, g.variant, g.greedy, g.temp, g.top_k, g.top_p,
                    g.rowkey, g.pos, self._vocab_hash,
                    g.pen if g.penalized else None)
        if g.penalized:
            g.pen[0].scatter_add_(1, tok.long()[:, None], g.ones)
        slot = torch.gather(g.table, 1, (g.pos // T)[:, None].long())[:, 0]
        logits, _ = decode_forward(
            self.params, self.cfg, tokens=tok, positions=g.pos,
            cache=self.cache, block_table=g.table, seq_lens=g.pos + 1,
            slot_block_ids=slot, slot_ids=g.pos % T,
        )
        if g.lp_k:
            # the RAW model distribution of the step (OpenAI logprobs)
            lp = torch.log_softmax(g.logits.float(), dim=-1)
            g.chosen.index_copy_(0, g.step, lp.gather(1, tok.long()[:, None]).T)
            top_lp, top_id = torch.topk(lp, g.lp_k, dim=-1)
            g.top_lp.index_copy_(0, g.step, top_lp[None])
            g.top_id.index_copy_(0, g.step, top_id.to(torch.int32)[None])
        g.toks.index_copy_(0, g.step, tok[None])
        g.logits.copy_(logits)
        g.pos.add_(1)
        g.step.add_(1)

    def _capture(self, g: "_DecodeGraph") -> None:
        """Capture ``_step(g)`` into ``g``'s CUDA graph.  The caller has
        just run one eager step on the engine's stream, so K1's workspace
        is sized and cuBLAS is set up for these shapes."""
        self._capture_graph(g, lambda: self._step(g), f"decode_step{g.key}",
                            "decode")
        g.cache_ptr = self.cache.data_ptr()

    def _capture_graph(self, g, body, name: str, kind: str) -> None:
        """Capture ``body()`` into a CUDA graph on the engine's stream, out
        of the engine's graph pool; sets ``g.graph`` and ``g.captured`` (the
        launches each replay makes), notes the capture under ``name`` for
        the step profiler (``/debug/engine`` shows it as a compile) and
        counts it and its seconds under ``kind``.  ``body`` writes only
        static tensors made outside the capture, so nothing the pool holds
        outlives a replay and any graph of the pool may replay next.  A
        failed capture raises."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # ``capture_begin``/``capture_end`` on the engine's stream rather
        # than ``torch.cuda.graph``, whose entry synchronizes the whole
        # device and empties the allocator's cache: another engine's thread
        # in this process may hold a capture open, and those calls break
        # it.  The tally counts this thread's kernel calls only.
        with ca.capture_tally() as tally, torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        secs = time.perf_counter() - t0
        g.captured = tally
        g.graph = graph
        self.graph_captures[kind] += 1
        self.graph_capture_s[kind] += secs
        _stepprof.note_capture(name, secs)

    def _replay(self, g, kind: str, times: int = 1) -> None:
        """Replay ``g``'s graph ``times`` times, each adding its captured
        launches to this thread's counts, and account the replays and
        their host seconds under ``kind``."""
        t0 = time.perf_counter()
        for _ in range(times):
            g.graph.replay()
            ca.count_replay(g.captured)
        g.replays += times
        self.graph_replays[kind] += times
        self.graph_replay_s[kind] += time.perf_counter() - t0

    def graph_launches(self, kind: str) -> Dict[str, int]:
        """The kernel launches the replays of the ``kind`` graphs made:
        each graph's captured launches times its replays."""
        graphs = self._graphs if kind == "decode" else self._prefill_graphs
        out: Dict[str, int] = {}
        for g in graphs.values():
            for k, c in g.captured.items():
                out[k] = out.get(k, 0) + c * g.replays
        return out

    def _run_chunk(self, g: "_DecodeGraph", chunk: int, eager: bool) -> None:
        """``chunk`` decode steps over ``g``'s buffers.  On the CPU (and
        with ``eager``) the step body runs ``chunk`` times; on the card the
        key's graph replays ``chunk`` times, and a key seen for the first
        time runs its first step eagerly and is captured after it."""
        g.step.zero_()
        if eager or self.device.type != "cuda":
            for _ in range(chunk):
                self._step(g)
            return
        done = 0
        if g.graph is None:
            self._step(g)
            done = 1
            self._capture(g)
        if g.cache_ptr != self.cache.data_ptr():
            # the graph writes and reads the cache it was captured with:
            # a cache replaced from outside would be replayed against
            # memory the engine no longer owns
            raise RuntimeError("the paged cache moved since this decode "
                               "graph was captured")
        self._replay(g, "decode", chunk - done)

    def decode(
        self,
        state: SequenceState,
        n_steps: int,
        sample: str = "greedy",
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        rng: Optional[torch.Generator] = None,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        repetition_penalty: float = 1.0,
        gen_start: Optional[int] = None,
        seed: Optional[int] = None,
        logit_bias: Optional[Dict[int, float]] = None,
    ) -> List[int]:
        """Decode ``n_steps`` tokens for one sequence (scalar params; the
        batch API takes per-row sequences)."""
        return self.decode_batch(
            [state], n_steps, sample=sample, temperature=temperature,
            top_k=top_k, top_p=top_p, rng=rng,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            repetition_penalty=repetition_penalty,
            gen_start=None if gen_start is None else [gen_start],
            seed=None if seed is None else [seed],
            logit_bias=None if logit_bias is None else [logit_bias],
        )[0]

    @staticmethod
    def _per_row(x, B: int, dtype) -> np.ndarray:
        """Broadcast a scalar sampling param to [B], or validate a per-row
        sequence of length B."""
        if isinstance(x, (list, tuple, np.ndarray)):
            arr = np.asarray(x, dtype=dtype)
            if arr.shape != (B,):
                raise ValueError(f"per-row param has shape {arr.shape}, "
                                 f"expected ({B},)")
            return arr
        return np.full(B, x, dtype=dtype)

    def decode_batch(self, states: Sequence[SequenceState], n_steps: int,
                     **kw):
        """Decode ``n_steps`` tokens for a batch of sequences in lockstep
        (sequences may have different lengths: positions, lengths and write
        slots are per-row device values).

        Every sampling param is a scalar or a length-B per-row sequence:
        ``sample`` "greedy" / "categorical" (softmax at ``temperature``,
        optionally truncated to the ``top_k`` most likely tokens and/or the
        ``top_p`` nucleus).  Rows mix freely in one lockstep batch.

        Pages for the whole run are allocated up front; the batch dimension
        is padded to a power of two with inert pad rows (table entries
        ``n_blocks``: they write nothing and attend to nothing).  The token
        loop runs ``decode_chunk`` steps per host sync.  On the card each
        step is a replay of a CUDA graph captured once per (batch bucket,
        table-width bucket, variant, logprobs, penalties) key, on the
        engine's own stream, out of one memory pool shared by the engine's
        graphs; on the CPU the same step body runs eagerly.

        ``logprobs=k > 0`` returns ``(outs, lps)`` where ``lps[b]`` holds one
        record per generated token: ``(chosen_logprob, [(token_id, logprob)
        x k])`` from the raw model distribution (OpenAI ``logprobs``);
        ``logprobs_rows`` limits the host-side record building to the rows
        that asked.

        ``presence_penalty`` / ``frequency_penalty`` (over generated tokens)
        and ``repetition_penalty`` (over prompt + generated) and
        ``logit_bias`` (a token id -> bias map per row) apply before
        temperature, in the vLLM order; greedy rows argmax over the
        penalised logits.  Generated-token counts live on the device and
        advance by one scatter per step.  ``gen_start[b]`` is where
        generation began in ``states[b].tokens`` (default: everything
        present counts as prompt).  ``pen_cache`` (caller-owned) carries
        the device penalty state across calls while the batch composition,
        the per-row params and the lengths match.

        ``seed[b]`` (None = unseeded) pins row ``b``'s draws: each uniform
        is a 32-bit integer hash of (the row's seed, the token's absolute
        position, the vocabulary index), so a seeded row's tokens depend on
        neither its batchmates, ``decode_chunk``, nor the scheduler.
        Unseeded rows key on a base seed drawn per call on the host from
        ``rng`` (default: the engine's generator) and their row index."""
        return self._decode_batch(states, n_steps, eager=False, **kw)

    def _decode_batch(
        self,
        states: Sequence[SequenceState],
        n_steps: int,
        sample="greedy",
        temperature=1.0,
        top_k=0,
        top_p=1.0,
        rng: Optional[torch.Generator] = None,
        logprobs: int = 0,
        logprobs_rows: Optional[Sequence[bool]] = None,
        presence_penalty=0.0,
        frequency_penalty=0.0,
        repetition_penalty=1.0,
        gen_start: Optional[Sequence[int]] = None,
        seed: Optional[Sequence[Optional[int]]] = None,
        logit_bias: Optional[Sequence[Optional[Dict[int, float]]]] = None,
        pen_cache: Optional[dict] = None,
        eager: bool = False,
    ):
        """``decode_batch``; ``eager=True`` runs the step body eagerly on
        the card as well (the graphs' yardstick in the card tests and
        ``chip_smoke.py``)."""
        B = len(states)
        if B < 1:
            raise ValueError("decode_batch needs at least one sequence")
        samples = [sample] * B if isinstance(sample, str) else list(sample)
        if len(samples) != B or not all(
                s in ("greedy", "categorical") for s in samples):
            raise ValueError(f"sample must be 'greedy' or 'categorical' per "
                             f"row, got {samples}")
        greedy_mask = np.asarray([s == "greedy" for s in samples])
        temp = self._per_row(temperature, B, np.float32)
        top_k_v = self._per_row(top_k, B, np.int32)
        top_p_v = self._per_row(top_p, B, np.float32)
        if not np.all((0.0 < top_p_v) & (top_p_v <= 1.0)):
            raise ValueError(f"top_p must be in (0, 1], got {top_p_v}")
        # greedy rows ignore their sampling params; normalising them keeps
        # the variant minimal (an all-greedy batch never sorts)
        temp = np.where(greedy_mask, 1.0, np.maximum(temp, 1e-6))
        top_k_v = np.where(greedy_mask, 0, top_k_v)
        top_p_v = np.where(greedy_mask, 1.0, top_p_v)
        if greedy_mask.all():
            variant = "greedy"
        elif np.any((top_k_v > 0) | (top_p_v < 1.0)):
            variant = "filter"
        else:
            variant = "plain"
        V = self.cfg.vocab_size
        logprobs = int(logprobs)
        if not 0 <= logprobs <= V:
            raise ValueError(f"logprobs must be in [0, {V}], got {logprobs}")
        pres = self._per_row(presence_penalty, B, np.float32)
        freq = self._per_row(frequency_penalty, B, np.float32)
        rep = self._per_row(repetition_penalty, B, np.float32)
        if not np.all(rep > 0.0):
            raise ValueError(f"repetition_penalty must be > 0, got {rep}")
        biases = list(logit_bias) if logit_bias is not None else [None] * B
        seeds = list(seed) if seed is not None else [None] * B
        if len(biases) != B or len(seeds) != B:
            raise ValueError("logit_bias and seed take one entry per row")
        penalized = bool(np.any(pres != 0.0) or np.any(freq != 0.0)
                         or np.any(rep != 1.0) or any(biases))
        Bp = _round_up_pow2(B, 1)
        npad = Bp - B

        T = self.pc.block_tokens
        for st in states:
            # return window-dead pages first so the run's new tail pages
            # can come straight from them under memory pressure
            self._reclaim_window_pages(st)
            need = -(-(len(st.tokens) + n_steps) // T)
            if need > len(st.block_ids):
                st.block_ids.extend(self.pages.acquire(need - len(st.block_ids)))
        table = self._block_table(states, pad_to=Bp)
        g = self._decode_graph((Bp, table.shape[1], variant, logprobs,
                                penalized, self.decode_chunk))
        with self._on_engine_stream():
            torch.stack([st.last_logits for st in states], out=g.logits[:B])
            g.logits[B:].zero_()
            g.pos.copy_(torch.from_numpy(np.asarray(
                [len(st.tokens) for st in states] + [0] * npad, np.int32)))
            g.table.copy_(torch.from_numpy(table))
            if variant != "greedy":
                pad = np.ones(npad, bool)
                g.greedy.copy_(torch.from_numpy(
                    np.concatenate([greedy_mask, pad])))
                g.temp.copy_(torch.from_numpy(np.concatenate(
                    [temp, pad]).astype(np.float32)))
                g.top_k.copy_(torch.from_numpy(np.concatenate(
                    [top_k_v, np.zeros(npad)]).astype(np.int32)))
                g.top_p.copy_(torch.from_numpy(np.concatenate(
                    [top_p_v, pad]).astype(np.float32)))
                gen = rng if rng is not None else self._gen
                base = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                         device=gen.device))
                g.rowkey.copy_(_row_keys(seeds + [None] * npad, base))
            pen_key = None
            if penalized:
                pen_key = (
                    tuple(st.seq_id for st in states),
                    pres.tobytes(), freq.tobytes(), rep.tobytes(),
                    tuple(tuple(sorted(b.items())) if b else None
                          for b in biases),
                )
                self._load_penalties(g, states, pen_key, pres, freq, rep,
                                     biases, gen_start, pen_cache)
            out: List[List[int]] = [[] for _ in range(B)]
            lps: List[List[tuple]] = [[] for _ in range(B)]
            remaining = n_steps
            while remaining > 0:
                chunk = min(remaining, self.decode_chunk)
                self._run_chunk(g, chunk, eager)
                # the whole batch advanced a chunk
                _stepprof.note_dispatch("decode")
                _stepprof.note_tokens(chunk * B)
                _stepprof.note_sync("decode_tokens")
                host_toks = g.toks[:chunk].cpu().numpy()  # one sync/chunk
                for b in range(B):
                    out[b].extend(int(t) for t in host_toks[:, b])
                if logprobs:
                    h_ch = g.chosen[:chunk].cpu().numpy()   # [chunk, Bp]
                    h_ti = g.top_id[:chunk].cpu().numpy()   # [chunk, Bp, k]
                    h_tl = g.top_lp[:chunk].cpu().numpy()
                    for b in range(B):
                        if logprobs_rows is not None and not logprobs_rows[b]:
                            continue
                        lps[b].extend(
                            (float(h_ch[s, b]),
                             [(int(h_ti[s, b, j]), float(h_tl[s, b, j]))
                              for j in range(logprobs)])
                            for s in range(chunk)
                        )
                remaining -= chunk
            rows = g.logits[:B].clone()
        for b, st in enumerate(states):
            st.tokens.extend(out[b])
            st.last_logits = rows[b]
        if penalized and pen_cache is not None:
            # single entry: one active batch composition at a time
            pen_cache.clear()
            pen_cache[pen_key] = (tuple(len(st.tokens) for st in states), g)
        if logprobs:
            return out, lps
        return out

    def _load_penalties(self, g: "_DecodeGraph", states, pen_key, pres,
                        freq, rep, biases, gen_start, pen_cache) -> None:
        """Fill ``g``'s penalty buffers: generated-token counts, the
        prompt's seen-token mask, the per-row penalties and the dense
        logit bias.  A ``pen_cache`` hit for this composition and these
        lengths reuses the device state of the call that recorded it."""
        B = len(states)
        lens = tuple(len(st.tokens) for st in states)
        hit = None if pen_cache is None else pen_cache.get(pen_key)
        if hit is not None and hit[0] == lens and hit[1].pen_key == pen_key:
            if hit[1] is not g:  # the batch moved to another graph key
                for dst, src in zip(g.pen, hit[1].pen):
                    dst.copy_(src)
                g.pen_key = pen_key
            return
        Bp, V = g.logits.shape
        counts = np.zeros((Bp, V), np.int32)
        pseen = np.zeros((Bp, V), bool)
        bias = np.zeros((Bp, V), np.float32)
        gs = list(lens) if gen_start is None else list(gen_start)
        for b, st in enumerate(states):
            np.add.at(counts[b], np.asarray(st.tokens[gs[b]:], np.int64), 1)
            pseen[b, np.asarray(st.tokens[:gs[b]], np.int64)] = True
            for t, v in (biases[b] or {}).items():
                bias[b, int(t)] = float(v)
        npad = Bp - B
        vecs = [np.concatenate([x, np.full(npad, fill, np.float32)])
                for x, fill in ((pres, 0.0), (freq, 0.0), (rep, 1.0))]
        for dst, src in zip(g.pen, [counts, pseen, *vecs, bias]):
            dst.copy_(torch.from_numpy(src))
        g.pen_key = pen_key

    def propose(self, *args, **kwargs):
        """The speculative draft contract: not ported yet."""
        raise NotImplementedError(_SPEC_TODO)

    def sampling_probs(self, *args, **kwargs):
        """The speculative target distribution: not ported yet."""
        raise NotImplementedError(_SPEC_TODO)

    def verify(self, *args, **kwargs):
        """The speculative verify forward: not ported yet."""
        raise NotImplementedError(_SPEC_TODO)

    def _block_table(self, states: Sequence[SequenceState],
                    pad_to: Optional[int] = None) -> np.ndarray:
        """[rows, width] int32 on the host.  Width = the longest active
        sequence's page count in power-of-two buckets (at least 8), never
        the pool size: the plain decode path gathers width*T tokens per row
        whatever seq_lens says.  ``pad_to`` > len(states) appends pad rows
        whose every entry is ``n_blocks``, one past the pool: their KV
        writes are dropped (kv/cache.py write_token_kv) and K1 gives them
        zeros without reading the cache.  Logical pages may exceed the
        pool under sliding-window reclamation (window-dead prefix pages
        recycle while their table slots live on, masked by the window)."""
        need = max((len(st.block_ids) for st in states), default=0)
        width = 8
        while width < need:
            width *= 2
        rows = pad_to if pad_to is not None else len(states)
        table = np.zeros((rows, width), dtype=np.int32)
        table[len(states):] = self.pc.n_blocks
        for b, st in enumerate(states):
            table[b, : len(st.block_ids)] = st.block_ids
        return table

    def prompt_logprobs(
        self, tokens: Sequence[int], k: int = 0, adapter_id: int = 0
    ) -> List[tuple]:
        """Score a prompt: per position 1..S-1, the model's logprob of the
        ACTUAL next token plus the top-``k`` alternatives (the OpenAI
        ``echo + logprobs`` scoring contract; position 0 has no
        distribution, the caller renders it as null).

        One dense forward over a power-of-two padded bucket (causal masking
        keeps the padding out of the real positions' logits), the f32
        log-softmax and top-k over blocks of at most 256 rows on the
        device; [S, k] comes to the host, never [S, V].  Pure: no paged
        cache, no store traffic, no prefix-cache interaction."""
        _no_lora(adapter_id)
        S = len(tokens)
        if S < 1:
            raise ValueError("empty prompt")
        pad = 8
        while pad < S:
            pad *= 2
        toks = self._tokens([list(tokens) + [0] * (pad - S)])
        logits, _ = prefill_forward(self.params, self.cfg, toks)
        nxt = torch.cat([toks[0, 1:], toks[0, :1]]).long()
        R = min(pad, 256)
        kk = max(k, 1)
        ch, ti, tl = [], [], []
        for lo in range(0, pad, R):
            lp = torch.log_softmax(logits[0, lo:lo + R].float(), dim=-1)
            ch.append(lp.gather(1, nxt[lo:lo + R, None])[:, 0])
            top_lp, top_id = torch.topk(lp, kk, dim=-1)
            ti.append(top_id)
            tl.append(top_lp)
        h_ch = torch.cat(ch).cpu().numpy()
        h_ti = torch.cat(ti).cpu().numpy()
        h_tl = torch.cat(tl).cpu().numpy()
        # record i scores token i+1 given tokens[:i+1]
        return [
            (float(h_ch[i]),
             [(int(h_ti[i, j]), float(h_tl[i, j])) for j in range(k)])
            for i in range(S - 1)
        ]

    def generate(self, tokens: Sequence[int], n_steps: int) -> List[int]:
        state = self.prefill(tokens)
        return self.decode(state, n_steps)

    @property
    def free_pages(self) -> int:
        """Pages a new sequence can obtain (fresh + reclaimable cached)."""
        return self.pages.available

    def held_bytes(self) -> int:
        """Bytes of the tensors this engine holds: weights, the paged
        cache and the graphs' static buffers (the step profiler's memory
        reading on the CPU), each storage the graphs share counted once."""
        ts = [self.params["embed"], self.params["lm_head"],
              self.params["ln_out"], *self.params["layers"].values(),
              self.cache]
        graphs = {}
        for g in [*self._graphs.values(), *self._prefill_graphs.values()]:
            for t in g.buffers():
                st = t.untyped_storage()
                graphs[st.data_ptr()] = st.nbytes()
        return sum(t.numel() * t.element_size() for t in ts) + \
            sum(graphs.values())

    def _reclaim_window_pages(self, st: SequenceState) -> None:
        """Sliding-window page reclamation: when EVERY layer is windowed
        (``window_pattern == 1``, the Mistral stack), a page whose last
        token has aged out of the attention window of every current and
        future position goes back to the pool, so long generations hold
        about window/block_tokens live pages.  Mixed local/global stacks
        (Gemma-2, pattern 2) keep all pages: the global layers attend
        everything.

        The stale ids stay in ``block_ids`` so table construction and the
        page-need arithmetic are unchanged: the window mask makes those
        table slots unreadable even after the pool hands the page to
        another sequence.  ``reclaimed_pages`` marks the returned prefix
        so ``release`` does not unpin it twice.  Called at decode entry
        only: decode never rewinds below its entry length."""
        W = self.cfg.sliding_window
        if W is None or self.cfg.window_pattern != 1:
            return
        T = self.pc.block_tokens
        # page i holds positions [i*T, (i+1)*T); every position >= len-W
        # stays attendable, so pages 0..n_dead-1 with n_dead*T + W <= len
        # are dead for good
        n_dead = min((len(st.tokens) - W) // T, len(st.block_ids))
        if n_dead > st.reclaimed_pages:
            self.pages.unpin(st.block_ids[st.reclaimed_pages:n_dead])
            st.reclaimed_pages = n_dead

    def release(self, state: SequenceState) -> None:
        # shared pages just lose a ref; this sequence's registered pages
        # stay resident (reclaimable LRU) for future prefix hits
        self.pages.unpin(state.block_ids[state.reclaimed_pages:])
        state.block_ids = []
        state.reclaimed_pages = 0
        self.seqs.pop(state.seq_id, None)


class _DecodeGraph:
    """One decode-graph key's static device buffers, its captured step
    (``graph``, None until captured; always None on the CPU) and the
    kernel launches the capture recorded (``captured``, added to the
    launch counts at each replay).

    ``key`` = (padded batch, table width, variant, logprobs k, penalized,
    decode chunk).  ``variant`` "greedy" needs no sampling vectors;
    "plain" samples at temperature; "filter" also truncates by top-k /
    top-p.  Seeds need no key of their own: they only change ``rowkey``."""

    def __init__(self, key, vocab: int, dtype: torch.dtype, device):
        Bp, W, variant, lp_k, penalized, C = key
        self.key = key
        self.variant, self.lp_k, self.penalized = variant, lp_k, penalized

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        self.logits = z((Bp, vocab), dtype)
        self.pos = z((Bp,), torch.int32)
        self.table = z((Bp, W), torch.int32)
        self.step = z((1,), torch.long)  # the step index inside a chunk
        self.toks = z((C, Bp), torch.int32)
        self.greedy = self.temp = self.top_k = self.top_p = None
        self.rowkey = None
        if variant != "greedy":
            self.greedy = z((Bp,), torch.bool)
            self.temp = z((Bp,), torch.float32)
            self.top_k = z((Bp,), torch.int32)
            self.top_p = z((Bp,), torch.float32)
            self.rowkey = z((Bp,), torch.long)
        # (generated counts, prompt-seen mask, presence, frequency,
        # repetition, dense logit bias)
        self.pen = ()
        self.pen_key = None
        if penalized:
            self.pen = (z((Bp, vocab), torch.int32), z((Bp, vocab), torch.bool),
                        z((Bp,), torch.float32), z((Bp,), torch.float32),
                        z((Bp,), torch.float32), z((Bp, vocab), torch.float32))
            self.ones = torch.ones((Bp, 1), dtype=torch.int32, device=device)
        if lp_k:
            self.chosen = z((C, Bp), torch.float32)
            self.top_lp = z((C, Bp, lp_k), torch.float32)
            self.top_id = z((C, Bp, lp_k), torch.int32)
        self.graph = None
        self.cache_ptr = None  # the cache the graph was captured against
        self.captured: Dict[str, int] = {}
        self.replays = 0

    def buffers(self) -> List[torch.Tensor]:
        return [t for t in vars(self).values() if isinstance(t, torch.Tensor)
                ] + list(self.pen)


class _PrefillGraph:
    """One prefill-graph key: its token buffer, the static buffers it
    shares with the engine's other prefill keys, its captured chunk
    (``graph``, None until captured; always None on the CPU), the kernel
    launches the capture recorded (``captured``) and its replays.

    ``key`` = (route, prefix capacity, chunk bucket ``Cb``): route
    ``"causal"`` is a chunk with no prefix (K3; capacity 0), ``"prefix"`` a
    later chunk of a prompt over the bucketed prefix buffer of that many
    rows (K2, whose valid length it reads from ``plen`` on the device).
    Shared: ``last`` (the logits row, [1] int64), ``plen``, ``buf`` (one
    per capacity) and the outputs ``logits`` [1, 1, V] and ``kv`` [L, 2, 1,
    Cb, H_kv, D] (a view of one buffer at the largest bucket)."""

    def __init__(self, key, tokens, last, plen, buf, logits, kv):
        self.key = key
        self.tokens, self.last, self.plen, self.buf = tokens, last, plen, buf
        self.logits, self.kv = logits, kv
        self.graph = None
        self.param_ptrs = None  # the weights the graph was captured with
        self.captured: Dict[str, int] = {}
        self.replays = 0

    def buffers(self) -> List[torch.Tensor]:
        return [t for t in (self.tokens, self.last, self.plen, self.buf,
                            self.logits, self.kv) if t is not None]


_GRAPH_KINDS = ("decode", "prefill")
_M32 = 0xFFFFFFFF
_SPEC_TODO = ("speculative decoding (propose / sampling_probs / verify) is "
              "not ported yet (ROADMAP.md queue 1 item 8)")


def _no_lora(adapter_id: int) -> None:
    if adapter_id != 0:
        raise NotImplementedError(
            "LoRA adapters are not ported yet (ROADMAP.md queue 1 item 8); "
            "adapter_id must be 0")


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) of int64 values in
    [0, 2**32): every product stays below 2**63, so the CPU and the card
    compute the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _M32
    return x ^ (x >> 16)


def _row_keys(seeds: Sequence[Optional[int]], base: int) -> torch.Tensor:
    """[B] int64 row keys on the host: a seeded row's from its 64-bit seed
    alone, an unseeded row's from the call's ``base`` and its row index."""
    out = []
    for b, s in enumerate(seeds):
        if s is None:
            out.append([base & _M32, (b + 0x3C6EF372) & _M32])
        else:
            s = int(s) & 0xFFFFFFFFFFFFFFFF
            out.append([s & _M32, ((s >> 32) ^ 0x9E3779B9) & _M32])
    w = torch.tensor(out, dtype=torch.long).reshape(-1, 2)
    return _mix32(w[:, 0] ^ _mix32(w[:, 1]))


def _gumbel(rowkey: torch.Tensor, pos: torch.Tensor,
            vocab_hash: torch.Tensor) -> torch.Tensor:
    """[B, V] Gumbel noise, counter-based: the uniform of (row, vocab
    index) at absolute position ``pos[row]`` is a hash of (row key,
    position, index) in 24 bits, so it never depends on the batch, the
    chunking or any generator state."""
    h = _mix32(rowkey ^ _mix32(pos.long()))
    x = _mix32((h[:, None] + vocab_hash[None, :]) & _M32)
    u = ((x >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def _pick(logits: torch.Tensor, variant: str, greedy, temperature, top_k,
          top_p, rowkey, pos, vocab_hash, pen=None) -> torch.Tensor:
    """Next token per row [B] int32, on the device.  With ``pen`` =
    (generated counts, prompt-seen mask, presence, frequency, repetition,
    bias), the penalties apply first, before temperature (the vLLM order):
    repetition on seen tokens (positive logits divided, negative
    multiplied), then ``- frequency * count - presence * (count > 0)``,
    then the bias.  Greedy rows take the argmax; the others draw from
    softmax(logits / temperature), top-k / top-p truncated in the
    ``"filter"`` variant, by the Gumbel-max trick on ``_gumbel``'s
    noise."""
    l0 = logits.float()
    if pen is not None:
        counts, seen, presence, frequency, repetition, bias = pen
        seen = seen | (counts > 0)
        rep = repetition[:, None]
        l0 = torch.where(seen, torch.where(l0 > 0, l0 / rep, l0 * rep), l0)
        cnt = counts.float()
        l0 = (l0 - frequency[:, None] * cnt
              - presence[:, None] * (cnt > 0) + bias)
    am = torch.argmax(l0, dim=-1)
    if variant == "greedy":
        return am.to(torch.int32)
    l = l0 / temperature[:, None]
    if variant == "filter":
        l = _truncate_logits(l, top_k, top_p)
    samp = torch.argmax(l + _gumbel(rowkey, pos, vocab_hash), dim=-1)
    return torch.where(greedy, am, samp).to(torch.int32)
