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
  ``prefix_len`` does (K2 reads the length from device memory).  The
  chunks of a chunked prefill take it, and so does the single chunk over
  an exact prefix (a store-adopted or locally cached one: the decode
  worker's tail after a handoff), whether or not ``prefill_chunk`` is set,
  up to ``TAIL_GRAPH_ROWS`` tail rows over ``TAIL_GRAPH_PREFIX`` prefix
  rows;
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
None) with no prefix, a single chunk over an exact prefix beyond those
bounds, ``prefill_batch``'s padded groups and ``prompt_logprobs`` run
eagerly, as their shapes follow the prompt.  A prefill computes the LM
head at one row, the last token's.  Where the reference donates the cache
to a compiled scatter, this engine updates it in place (``index_put_`` /
``copy_``).  Page bookkeeping stays in Python, as in the reference.

Other model families plug in through ``prefill_fn`` / ``decode_fn`` /
``verify_fn`` (``models.moe``'s forwards) and run every route above, the
graphs included.  A LoRA bank (``lora=``, ``models/lora.py``) serves many
adapters of the base model in one batch: every forward takes a per-row
adapter-id vector (a static buffer of the graphs, copied in before each
replay; pad rows take id 0), the bank's tensors are captured by pointer and
checked at replay, and an adapter's pages are namespaced in the prefix
cache and the store (``model_id#a<n>``).

The speculative-decoding contract is here: ``verify`` (a run of tokens in
one paged forward, ``models.llama.verify_forward``, eager), ``propose`` (the
draft's sampled tokens and the exact distributions they came from, the
decode graph's collecting form) and ``sampling_probs``; ``engine/
speculative.py`` and ``engine/ngram.py`` build their round graphs on the
engine's stream and pool (``_capture_graph``, kind ``"spec"``).

The store is one connection or a ``cluster.RoutedStorePool``: then every
store hop routes per chunk over the consistent-hash ring
(``cluster.ClusterTransferEngine``), with per-node breakers and hot-prefix
replication.

Multi-device serving (``mesh=``, a ``parallel.make_mesh`` mesh with a
``tp`` axis, a ``pp`` axis or both) maps the reference's single controller
onto one process per rank.  The serving group (the mesh's ``pp x tp``
ranks) has one leader, its rank 0: it holds the page bookkeeping, the
prefix cache, the store connection, a speculator's draft and (in
``serve``) the ``Scheduler``.  Every rank holds its stage's ``n_layers/pp``
layers, each its Megatron shard, and the matching slice of the paged cache
``[L/pp, 2, H_kv/tp, n_blocks, T, D]``.  Each device step is a named op
(the ``_op_*`` methods): the leader broadcasts its name and host
arguments, then every rank runs it, the model's collectives inside
(``models/llama.py`` with ``tp=`` and ``pp=``: two all-reduces per layer
within a stage, the hidden state handed from stage to stage, the logits
gathered and broadcast to every rank); the other ranks run ``follow()``,
which waits for the leader's ops and runs them, and nothing else.  Every
rank samples the same token from the same bits.  The store holds whole
pages: a push gathers every rank's slice on the leader and packs it as a
tp=1 engine does; a load scatters each rank its slice.  Speculation keeps
its draft (or n-gram matcher) on the leader: ``verify`` is an op, and a
speculative round broadcasts its ``[prev, p_1..p_k]`` and accepted count
so the followers verify on their shards in step (``spec_rounds``).  A LoRA
bank is sliced as the weights are.  Over NCCL the graphs capture the
collectives (every rank captures a key at the same op); over gloo, whose
collectives run on the host, the graph bodies run eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import math
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..cluster import transfer_for
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
from ..models.llama import (
    LlamaConfig,
    decode_forward,
    prefill_forward,
    verify_forward,
)
from ..ops import cuda_attention as ca
from ..parallel.distributed import PPGroup, TPGroup
from ..parallel.sharding import (check_tp_heads, params_are_whole,
                                 pp_rank_size, shard_params, tp_rank_size)
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


# the single chunk over an exact prefix replays a prefill graph when its
# tail bucket holds at most TAIL_GRAPH_ROWS rows (with ``prefill_chunk`` set:
# that chunk's bucket) and its prefix at most TAIL_GRAPH_PREFIX rows; longer
# ones run eagerly.  Every prefix buffer of at most TAIL_GRAPH_PREFIX rows is
# a view of one storage of that size (256 MiB of bf16 at Llama-3-8B).
TAIL_GRAPH_ROWS = 256
TAIL_GRAPH_PREFIX = 2048


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
    adapter_id: int = 0  # LoRA adapter slot (0 = base model)
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
    adapter_id: int = 0  # LoRA adapter slot (0 = base model)
    # provenance carried onto the SequenceState (see its fields)
    local_chunks: int = 0
    store_chunks: int = 0
    store_load_s: float = 0.0
    pid: int = 0  # names its prefix buffer on tensor-parallel followers


class _TPPages:
    """The store hop's device halves on the leader of a serving group
    (``KVTransferEngine.tp_pages``): a push gathers every rank's slice of
    the pages (its stage's layers, its heads), a load scatters each rank
    its slice, each as an op of the leader's engine."""

    def __init__(self, engine: "InferenceEngine"):
        self._engine = engine

    def gather(self, cache: torch.Tensor, block_ids) -> torch.Tensor:
        return self._engine._op("gather_pages", list(block_ids))

    def scatter(self, cache: torch.Tensor, block_ids,
                pages: torch.Tensor) -> torch.Tensor:
        self._engine._op("scatter_pages", list(block_ids), pages=pages)
        return self._engine.cache


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
        verify_fn=None,
        prefill_fn=None,
        decode_fn=None,
        lora=None,
        mesh=None,
        param_specs=None,
        pallas_tp: bool = False,
    ):
        """``params``: the model's weights (``models.llama.init_params`` or
        ``models.convert.params_from_jax``), already on ``device``.

        ``device``: ``None`` means the GPU and raises when there is none;
        pass ``"cpu"`` to run the plain PyTorch versions of the kernels.

        ``conn``: an InfiniStore connection (``lib.InfinityConnection``)
        or a ``cluster.RoutedStorePool`` over several store nodes; prefill
        then adopts store-resident prefixes and streams its pages to the
        store (over the pool, each chunk to its ring owner).

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
        are queued, and ``store_flush()`` is the barrier.

        ``prefill_fn`` / ``decode_fn``: another model family with the
        contracts of ``models.llama.prefill_forward`` / ``decode_forward``
        (e.g. ``models.moe.moe_prefill_forward`` / ``moe_decode_forward``);
        every route runs them, the prefill and decode graphs included.

        ``verify_fn``: the multi-token verify step ``verify`` and the
        speculators run, with ``models.llama.verify_forward``'s contract
        (default: that function for the Llama family; a custom family has
        none unless it brings one).  One that takes ``last_only`` also
        serves the last-row-only resync and refresh; otherwise the full
        verify serves both.

        ``lora``: a ``models.lora.LoraBank`` enables multi-adapter serving:
        ``prefill(..., adapter_id=)`` / ``Scheduler.submit(adapter_id=)``
        pick an adapter, and one batch mixes them.  Built-in Llama family
        only (with a custom family it raises, as in the reference).

        ``mesh``: a ``parallel.make_mesh`` mesh with a ``tp`` axis, a
        ``pp`` axis or both makes this rank's engine one of a serving group
        (module docstring): ``params`` (and a ``lora`` bank) are the whole
        model, sharded here (``param_specs``, default
        ``parallel.llama_inference_specs``; with ``pp`` the rank's stage
        of the layers), or this rank's shard already; the cache holds this
        rank's layers and KV heads.  Every rank builds its engine with the
        same arguments; the group's rank 0 passes ``conn`` and is driven,
        the others call ``follow()``.  Built-in Llama family only.
        ``pallas_tp`` is kept for the reference's signature: its kernels
        need a ``shard_map`` to run on shards, the CUDA kernels run on each
        rank's head shard either way."""
        self._grp = self._tp = self._pp = None
        self._mesh_shape = (1, 1)  # (pp, tp)
        if mesh is not None:
            if prefill_fn or decode_fn or verify_fn:
                raise ValueError("mesh serving supports the built-in dense "
                                 "families (the MoE family scales by expert "
                                 "parallelism, parallel/moe.py)")
            tp_rank, tp_n = tp_rank_size(mesh)
            pp_rank, pp_n = pp_rank_size(mesh)
            check_tp_heads(cfg.n_heads, cfg.n_kv_heads, tp_n)
            if cfg.n_layers % pp_n:
                raise ValueError(f"n_layers={cfg.n_layers} must divide over "
                                 f"pp={pp_n}")
            wq = params["layers"]["wq"]
            if params_are_whole(params, cfg):
                if tp_n * pp_n > 1:
                    params = shard_params(params, mesh, param_specs)
            elif (wq.shape[0] * pp_n != cfg.n_layers
                  or wq.shape[-1] * tp_n != cfg.n_heads * cfg.head_dim):
                raise ValueError(
                    f"params' wq is {tuple(wq.shape)}: neither the whole "
                    f"model nor a pp={pp_n} x tp={tp_n} shard")
            if lora is not None and lora.is_whole(cfg) and tp_n * pp_n > 1:
                lora = lora.shard(tp_rank, tp_n, pp_rank, pp_n)
            grp = TPGroup.serving(mesh)
            if not grp.is_leader and conn is not None:
                raise ValueError("only the serving group's leader holds a "
                                 "store connection")
            self._grp = grp
            self._mesh_shape = (pp_n, tp_n)
            # the model's tp collectives; a pure-tp mesh keeps them at tp 1
            # too (a one-rank NCCL group captures them in its graphs),
            # under pp a single-rank tp axis needs none
            if tp_n > 1 or pp_n == 1:
                self._tp = TPGroup.from_mesh(mesh)
            if pp_n > 1:
                self._pp = PPGroup.from_mesh(mesh, cfg.n_layers)
        # a group whose collectives run on the host cannot be captured
        self._capture_ok = self._grp is None or not self._grp.host_staged
        self._op_lock = threading.Lock()
        self._next_pid = 0
        # followers: each partial prefill's prefix buffer, by pid
        self._tp_bufs: Dict[int, torch.Tensor] = {}
        # followers: the speculative round graphs' target halves, by key
        self._spec_graphs: Dict[tuple, object] = {}
        # the tokens of the last decode chunks this rank sampled (the ranks
        # agree on every one)
        self.rank_tokens: "deque" = deque(maxlen=64)
        if lora is not None and (prefill_fn or decode_fn or verify_fn):
            raise ValueError(
                "LoRA composes the built-in Llama family; custom families "
                "must thread lora/adapter_ids through their own forwards")
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
        self.lora = lora
        # this rank's layers and KV heads (all of them without a mesh)
        self._nl = pc.n_layers // self._mesh_shape[0]
        self._hkv = pc.n_kv_heads // self._mesh_shape[1]
        self.cache = init_cache(dataclasses.replace(
            pc, n_layers=self._nl, n_kv_heads=self._hkv), self.device)
        self.alloc = BlockAllocator(pc.n_blocks)
        # automatic prefix caching: complete-chunk pages are content-
        # addressed by their prefix-commitment key and shared across
        # sequences (kv/cache.py PrefixPageCache)
        self.pages = PrefixPageCache(self.alloc)
        # ``conn`` may be a single store connection (the classic one-node
        # path) OR a cluster.RoutedStorePool: then every store hop routes
        # per chunk over the consistent-hash ring with per-node breakers
        # and hot-prefix replication
        self.transfer = None if conn is None else transfer_for(
            conn, pc, quant=kv_quant, device=self.device)
        if self.transfer is not None and self._grp is not None:
            # the store holds whole pages (``pc``'s every layer and head)
            self.transfer.tp_pages = _TPPages(self)
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
        # the largest bucket) and the prefix buffers (one per capacity, the
        # capacities up to ``TAIL_GRAPH_PREFIX`` views of one storage)
        self._prefill_graphs: Dict[tuple, "_PrefillGraph"] = {}
        self._pf_shared: Dict[str, torch.Tensor] = {}
        self._pf_prefix: Dict[int, torch.Tensor] = {}
        self._pool = None
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        # per graph kind ("decode", "prefill", "spec"): captures and their
        # seconds, replays and the host seconds spent issuing them (no
        # sync inside: the ``decode.replay`` and ``prefill.graph`` phases'
        # readings around ``_replay``); ``graph_launches`` reads what the
        # replays launched
        self.graph_captures = dict.fromkeys(_GRAPH_KINDS, 0)
        self.graph_capture_s = dict.fromkeys(_GRAPH_KINDS, 0.0)
        self.graph_replays = dict.fromkeys(_GRAPH_KINDS, 0)
        self.graph_replay_s = dict.fromkeys(_GRAPH_KINDS, 0.0)
        # the device memory the graph pool took at the captures (the
        # bodies' intermediates live there between replays)
        self.graph_pool_bytes = 0
        # the vocabulary's share of the counter-based sampling hash
        self._vocab_hash = (torch.arange(cfg.vocab_size, dtype=torch.long,
                                         device=self.device)
                            * 0x9E3779B9) & _M32
        # the model family's forwards, called with keywords (under a mesh
        # with the tp and pp groups: the built-in family's collectives)
        tpkw = {k: g for k, g in (("tp", self._tp), ("pp", self._pp))
                if g is not None}
        self._prefill = functools.partial(prefill_fn or prefill_forward,
                                          cfg=cfg, **tpkw)
        self._decode = functools.partial(decode_fn or decode_forward, cfg=cfg,
                                         **tpkw)
        # the speculative verify step and its last-row-only form (the
        # reference's ``_verify_jit`` / ``_verify_last_jit``): a custom
        # family must bring its own, as binding llama's verify to foreign
        # params would fail deep inside the forward
        self._has_verify = verify_fn is not None or (
            decode_fn is None and prefill_fn is None)
        self._verify = self._verify_last = None
        vfn = verify_fn or (verify_forward if self._has_verify else None)
        if vfn is not None:
            self._verify = functools.partial(vfn, cfg=cfg, **tpkw)
            if vfn is verify_forward or \
                    "last_only" in inspect.signature(vfn).parameters:
                self._verify_last = functools.partial(vfn, cfg=cfg,
                                                      last_only=True, **tpkw)
            else:
                self._verify_last = self._verify

    def _lora_args(self, adapter_ids) -> dict:
        """A forward's LoRA keywords: the bank's tree, the per-row adapter
        ids (a list, or an int32 tensor on the device such as a graph's
        static buffer) and the scale; empty for an engine without a
        bank."""
        if self.lora is None:
            return {}
        if not isinstance(adapter_ids, torch.Tensor):
            adapter_ids = torch.tensor(adapter_ids, dtype=torch.int32,
                                       device=self.device)
        return {"lora": self.lora.tree, "adapter_ids": adapter_ids,
                "lora_scale": self.lora.scale}

    def _adapter_model_id(self, adapter_id: int) -> str:
        """The prefix-cache and store key namespace of an adapter: an
        adapter's KV never serves another adapter's prefix."""
        if adapter_id == 0:
            return self.model_id
        return f"{self.model_id}#a{adapter_id}"

    def _check_adapter(self, adapter_id: int) -> None:
        # an id outside the bank would gather another adapter's weights
        # (or none): rejected before any page moves
        n = 1 if self.lora is None else self.lora.n_adapters
        if not 0 <= adapter_id < n:
            raise ValueError(f"adapter_id {adapter_id} outside this "
                             f"engine's bank of {n} (0 = the base model)")

    def _lora_key(self) -> tuple:
        """The graph-key suffix of an engine with a bank."""
        return () if self.lora is None else ("lora",)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.int32, device=self.device)

    # ---- serving groups: the leader's ops and the followers' loop ----

    @property
    def group_size(self) -> int:
        """The ranks of this engine's serving group (1 without a mesh)."""
        return 1 if self._grp is None else self._grp.size

    @property
    def is_leader(self) -> bool:
        """Whether this rank drives the engine (no mesh, or the serving
        group's rank 0); the others ``follow()``."""
        return self._grp is None or self._grp.is_leader

    def _op(self, name: str, *args, **leader_kw):
        """Run the device op ``_op_<name>(*args)`` on this engine and, on a
        serving group's leader, on every follower first told its name and
        ``args`` (host values; a ``PartialPrefill`` travels without its
        prefix buffer, which each rank keeps).  ``leader_kw`` reach the
        leader's call only (tensors the op sends the others itself, the
        leader's own round bodies).  Ops are serialized: their collectives
        pair up in order on every rank."""
        fn = getattr(self, "_op_" + name)
        if self._grp is None:
            return fn(*args, **leader_kw)
        if not self._grp.is_leader:
            raise RuntimeError("a serving group's follower runs only the "
                               "ops its leader sends (follow())")
        with self._op_lock:
            self._grp.send_op((name, tuple(
                dataclasses.replace(a, buf=None)
                if isinstance(a, PartialPrefill) else a for a in args)))
            return fn(*args, **leader_kw)

    def follow(self) -> None:
        """A serving group's follower loop: run each op the leader sends,
        on the engine's stream, until the leader shuts the group down
        (``shutdown_followers``).  A leader that dies makes the wait
        raise."""
        if self.is_leader:
            raise RuntimeError("follow() runs on a serving group's "
                               "follower (a mesh rank other than its "
                               "group's rank 0)")
        while True:
            name, args = self._grp.recv_op()
            if name == "shutdown":
                return
            pp = args[0] if args and isinstance(args[0], PartialPrefill) \
                else None
            if pp is not None:
                pp.buf = self._tp_bufs.pop(pp.pid, None)
            with self._on_engine_stream():
                getattr(self, "_op_" + name)(*args)
            if pp is not None and pp.buf is not None \
                    and pp.off < len(pp.padded):
                self._tp_bufs[pp.pid] = pp.buf

    def shutdown_followers(self) -> None:
        """On a serving group's leader: end every follower's ``follow()``.
        A no-op elsewhere."""
        if self._grp is not None and self._grp.is_leader:
            with self._op_lock:
                self._grp.send_op(("shutdown", ()))

    def tp_report(self) -> Optional[List[dict]]:
        """Every rank's ``rank_report()`` in the serving group's rank order
        (None without a mesh): its held bytes, kernel launches and last
        sampled tokens."""
        if self._grp is None:
            return None
        return self._op("report")

    def rank_report(self) -> dict:
        """This rank's numbers, as ``tp_report`` gathers them."""
        from ..ops import build

        rank = self._grp.rank if self._grp else 0
        wq = self.params["layers"]["wq"]
        return {
            "rank": rank,
            "stage": rank // self._mesh_shape[1],
            "layers": self._nl,
            "pid": os.getpid(),
            "backend": self._grp.backend if self._grp else None,
            "cuda_graphs": self._capture_ok and self.device.type == "cuda",
            "held_bytes": self.held_bytes(),
            # the shard's share of the whole: the paged cache and wq
            "cache_bytes": self.cache.numel() * self.cache.element_size(),
            "wq_bytes": wq.numel() * wq.element_size(),
            "kernel_launches": dict(ca.LAUNCHES),
            "nvcc_runs": build.NVCC_RUNS,
            "tokens": [list(t) for t in self.rank_tokens],
        }

    def _op_report(self):
        return self._grp.gather_objects(self.rank_report())

    def _assemble(self, parts: List[torch.Tensor], layer_dim: int,
                  head_dim: int) -> torch.Tensor:
        """The whole tensor from the serving group's slices in rank order
        (stage-major): each stage's heads side by side, the stages'
        layers one after another."""
        pp_n, tp_n = self._mesh_shape
        return torch.cat([torch.cat(parts[s * tp_n:(s + 1) * tp_n],
                                    dim=head_dim) for s in range(pp_n)],
                         dim=layer_dim)

    def _split(self, whole: torch.Tensor, layer_dim: int,
               head_dim: int) -> List[torch.Tensor]:
        """``_assemble``'s inverse: every rank's slice, in rank order."""
        _, tp_n = self._mesh_shape
        return [h for st in whole.chunk(self._mesh_shape[0], dim=layer_dim)
                for h in st.chunk(tp_n, dim=head_dim)]

    def _op_prefill_begin(self, pp: "PartialPrefill") -> None:
        """A prefill's prefix buffer from the pages already in the cache:
        exact for a single forward, else bucketed at a power of two."""
        P = pp.reused * self.pc.block_tokens
        prefix_kv = _read_prefix_kv(self.cache, pp.block_ids[:pp.reused]) \
            if pp.reused else None  # [L, 2, 1, n*T, H, D]
        if pp.single or prefix_kv is None:
            pp.buf = prefix_kv  # exact: no slack, K3 at q_offset=P
        else:
            pp.buf = _pad_seq_axis(prefix_kv, _round_up_pow2(P, pp.C))

    def _op_prefill_drop(self, pid: int) -> None:
        self._tp_bufs.pop(pid, None)

    def _op_gather_pages(self, block_ids: List[int]) -> Optional[torch.Tensor]:
        """Every rank's slice of ``block_ids``'s pages; on the leader the
        whole pages [L, 2, H_kv, n, T, D]."""
        ids = torch.tensor(block_ids, dtype=torch.long, device=self.device)
        parts = self._grp.gather_parts(read_pages(self.cache, ids))
        return None if parts is None else self._assemble(parts, 0, 2)

    def _op_scatter_pages(self, block_ids: List[int],
                          pages: Optional[torch.Tensor] = None) -> None:
        """Each rank's slice of the leader's whole ``pages`` [L, 2, H_kv,
        n, T, D] into its cache at ``block_ids``, in place."""
        L, two, H, _, T, D = self.cache.shape
        local = torch.empty((L, two, H, len(block_ids), T, D),
                            dtype=self.cache.dtype, device=self.device)
        self._grp.scatter_(local, None if pages is None else self._split(
            pages.to(self.cache.dtype), 0, 2))
        ids = torch.tensor(block_ids, dtype=torch.long, device=self.device)
        self.cache = write_pages(self.cache, ids, local)

    def _op_adopt_pages(self, block_ids: List[int],
                        kv: Optional[torch.Tensor] = None) -> None:
        """Adopted prompt KV [L, 2, 1, S, H_kv, D] into the cache at
        ``block_ids``; in a serving group each rank gets its slice of the
        leader's ``kv``."""
        T = self.pc.block_tokens
        if self._grp is not None:
            L, two, H, _, _, D = self.cache.shape
            local = torch.empty((L, two, 1, len(block_ids) * T, H, D),
                                dtype=self.cache.dtype, device=self.device)
            self._grp.scatter_(local, None if kv is None else self._split(
                kv.to(self.device, self.cache.dtype), 0, 4))
            kv = local
        self.cache = _write_prefill_pages(
            self.cache, block_ids, kv.to(self.device, self.cache.dtype), T)

    def _op_prompt_forward(self, tokens: List[int], adapter_id: int):
        logits, _ = self._prefill(self.params, tokens=self._tokens([tokens]),
                                  **self._lora_args([adapter_id]))
        return logits

    # ---- prefill ----

    def prefill(self, tokens: Sequence[int],
                adapter_id: int = 0) -> SequenceState:
        """Prompt ingestion: runs every prefill chunk back to back.  The
        resumable halves (``prefill_start`` / ``prefill_step``) let the
        scheduler interleave a newcomer's chunks with the batch's decode.
        ``adapter_id`` picks a LoRA adapter of the engine's bank (0 = the
        base model)."""
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
        self._check_adapter(adapter_id)
        T = self.pc.block_tokens
        tokens = list(tokens)
        S_total = len(tokens)
        if S_total < 1:
            raise ValueError("empty prompt")
        keys = chunk_keys(tokens, self._adapter_model_id(adapter_id),
                          chunk_tokens=T)

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

        # compute the tail, padded to whole pages, ``prefill_chunk`` tokens
        # per forward; the prefix of a later chunk lives in a buffer bucketed
        # at power-of-two capacities with a host-side valid length
        suffix = tokens[P:]
        S = len(suffix)
        padded = suffix + [0] * ((-S) % T)
        C = self.prefill_chunk or len(padded)
        pp = PartialPrefill(
            tokens=tokens, keys=keys, block_ids=block_ids, reused=reused,
            done=reused, n_complete=S_total // T, padded=padded, C=C,
            single=C >= len(padded), buf=None, plen=P, S=S,
            adapter_id=adapter_id, local_chunks=local_chunks,
            store_chunks=reused - local_chunks, store_load_s=store_load_s,
            pid=self._next_pid,
        )
        self._next_pid += 1
        self._op("prefill_begin", pp)
        return pp

    def prefill_step(self, pp: PartialPrefill,
                     eager: bool = False) -> Optional[SequenceState]:
        """One prefill chunk forward plus its cache landing.  Returns the
        finished SequenceState on the last chunk, else None.

        A chunk of a chunked prefill (``prefill_chunk`` set), and the
        single chunk over an exact prefix within ``TAIL_GRAPH_ROWS`` and
        ``TAIL_GRAPH_PREFIX``, run through their key's prefill-graph body
        (``_prefill_chunk``): on the card the key's CUDA graph replays it,
        and ``eager=True`` runs the body eagerly there too (the graphs'
        yardstick in the card tests and ``chip_smoke.py``).  The other
        routes run ``prefill_forward`` itself, as their shape follows the
        prompt: the whole prompt in one forward (``prefill_chunk`` None, no
        prefix) and a single chunk over an exact prefix beyond those bounds
        (K3 at ``q_offset = P``)."""
        with self._on_engine_stream():
            prev_done, off = pp.done, pp.off
            n = len(pp.padded[off: off + pp.C])
            graph = self._takes_graph(pp, n)
            logits = self._op("prefill_chunk", pp, eager, graph)
            # the chunk forward + its cache landing: one prefill dispatch
            # unit for the step profiler; its work the prompt positions it
            # computed (the pad to a whole page excluded), by route
            _stepprof.note_dispatch("prefill")
            _stepprof.note_work(
                "prefill_tokens_graph" if graph else "prefill_tokens_eager",
                max(0, min(n, pp.S - off)))
            # stream this chunk's complete pages to the store NOW: the
            # gather is queued behind the cache write on the compute
            # stream, the streamer's copies run while the next chunk
            # computes
            if self.transfer is not None:
                lo, hi = max(prev_done, pp.reused), min(pp.done,
                                                        pp.n_complete)
                if hi > lo:
                    with _stepprof.phase("prefill.land"):
                        self._streamer.submit(
                            self.transfer.gather_pages(
                                self.cache, pp.block_ids[lo:hi]),
                            pp.keys[lo:hi],
                        )
            if pp.off < len(pp.padded):
                return None
            with _stepprof.phase("prefill.finish"):
                # a copy, and taken now: a graph's logits are rewritten by
                # the next replay
                last_logits = logits[0, 0].clone()

                # finished.  Strict durability joins the pusher so the
                # pages are durably in the store before the state is
                # visible; relaxed returns now and store_flush() is the
                # barrier
                if self.transfer is not None \
                        and self.store_durability == "strict":
                    self._streamer.flush()

                # name this sequence's complete-chunk pages so later
                # prefills can share them in place (no-op for keys already
                # resident)
                self.pages.register(
                    pp.keys[: pp.n_complete], pp.block_ids[: pp.n_complete]
                )
                state = SequenceState(
                    seq_id=self._next_id,
                    tokens=pp.tokens,
                    block_ids=pp.block_ids,
                    chunk_keys=pp.keys,
                    reused_chunks=pp.reused,
                    last_logits=last_logits, adapter_id=pp.adapter_id,
                    local_chunks=pp.local_chunks,
                    store_chunks=pp.store_chunks,
                    store_load_s=pp.store_load_s,
                )
                self._next_id += 1
                self.seqs[state.seq_id] = state
                return state

    def _op_prefill_chunk(self, pp: PartialPrefill, eager: bool,
                          graph: bool) -> torch.Tensor:
        """``pp``'s next chunk: its forward (through its prefill-graph body
        when ``graph``), its cache landing and, when another chunk follows,
        the prefix buffer grown by its KV.  Advances ``pp``; returns the
        logits row [1, 1, V]."""
        T = self.pc.block_tokens
        off, C = pp.off, pp.C
        chunk = pp.padded[off: off + C]
        n = len(chunk)
        # the only logits row a prefill needs: the prompt's last token's
        # (any row of a chunk that is not the last)
        last = max(0, min(pp.S - 1 - off, n - 1))
        if not graph:
            with _stepprof.phase("prefill.inputs"):
                tokens = self._tokens([chunk])
                rows = torch.tensor([last], dtype=torch.long,
                                    device=self.device)
            with _stepprof.phase("prefill.eager"):
                logits, kv = self._prefill(
                    self.params, tokens=tokens, prefix_kv=pp.buf,
                    logits_rows=rows, **self._lora_args([pp.adapter_id]))
        else:
            logits, kv = self._prefill_chunk(pp, chunk, last, eager)
        with _stepprof.phase("prefill.land"):
            if graph:
                kv = kv[:, :, :, :n]  # the bucket's pad rows stay out
            n_pg = n // T
            self.cache = _write_prefill_pages(
                self.cache, pp.block_ids[pp.done: pp.done + n_pg], kv, T
            )
            pp.done += n_pg
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
        return logits

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

    def _takes_graph(self, pp: PartialPrefill, n: int) -> bool:
        """Whether ``pp``'s next chunk of ``n`` tokens runs through a
        prefill graph's body (see ``prefill_step``)."""
        if pp.single and pp.buf is not None:
            T = self.pc.block_tokens
            return (_round_up_pow2(n, T) <= self._pf_rows()
                    and _round_up_pow2(pp.plen, T) <= TAIL_GRAPH_PREFIX)
        return self.prefill_chunk is not None

    def _pf_rows(self) -> int:
        """The largest chunk bucket a prefill graph takes: the chunk's own
        with ``prefill_chunk`` set, else ``TAIL_GRAPH_ROWS``."""
        return _round_up_pow2(self.prefill_chunk or TAIL_GRAPH_ROWS,
                              self.pc.block_tokens)

    def _prefill_chunk(self, pp: PartialPrefill, chunk: List[int],
                       last: int, eager: bool):
        """A chunk's (logits of row ``last`` [1, 1, V], kv [L, 2, 1, Cb, H,
        D]) through its key's prefill-graph body: the tokens padded to the
        bucket, the row index, ``pp``'s valid prefix rows and length copied
        into the key's static buffers, then the body run eagerly (on the
        CPU, with ``eager``, and at a key's first use, which captures the
        key after it) or the key's graph replayed.  The outputs are the
        prefill graphs' shared static tensors, rewritten by the next
        prefill chunk.  The single chunk over an exact prefix of ``P``
        rows takes the capacity ``block_tokens * 2**k >= P``.  With a bank
        the key ends in ``"lora"`` and the chunk's adapter id goes into the
        shared id buffer."""
        T = self.pc.block_tokens
        n = len(chunk)
        Cb = _round_up_pow2(n, T)
        with _stepprof.phase("prefill.inputs"):
            if pp.buf is None:
                key = ("causal", 0, Cb)
            elif pp.single:
                key = ("prefix", _round_up_pow2(pp.plen, T), Cb)
            else:
                key = ("prefix", pp.buf.shape[3], Cb)
            g = self._prefill_graph(key + self._lora_key())
            g.tokens.copy_(torch.tensor([chunk + [0] * (Cb - n)],
                                        dtype=torch.int32))
            g.last.fill_(last)
            if g.aid is not None:
                g.aid.fill_(pp.adapter_id)
            if g.buf is not None:
                # several partial prefills share the buffer: each chunk
                # brings its own prefix in (the slack past ``plen`` is
                # masked)
                g.plen.fill_(pp.plen)
                g.buf[:, :, :, :pp.plen].copy_(pp.buf[:, :, :, :pp.plen])
            graphs = not eager and self.device.type == "cuda" \
                and self._capture_ok
            replay = graphs and g.graph is not None
            if replay and g.param_ptrs != self._param_ptrs():
                # the graph reads the weights (and the bank) it was
                # captured with
                raise RuntimeError("the weights or the LoRA bank moved "
                                   "since this prefill graph was captured")
        with _stepprof.phase("prefill.graph", timed=True) as ph:
            if replay:
                self._replay(g, "prefill")
            else:
                self._prefill_body(g)
                if graphs:  # the key's first use: capture it
                    self._capture_graph(g, lambda: self._prefill_body(g),
                                        f"prefill{key}", "prefill")
                    g.param_ptrs = self._param_ptrs()
        if replay:
            self.graph_replay_s["prefill"] += ph.wall_s
        return g.logits, g.kv

    def _prefill_graph(self, key: tuple) -> "_PrefillGraph":
        """``key``'s prefill graph, made at its first use over the shared
        static buffers (the KV output at the largest bucket a chunk of
        ``prefill_chunk`` tokens takes)."""
        g = self._prefill_graphs.get(key)
        if g is not None:
            return g
        route, cap, Cb = key[:3]
        cfg, dev = self.cfg, self.device
        dtype = self.params["lm_head"].dtype
        sh = self._pf_shared
        if not sh:
            rows = self._pf_rows()
            sh.update(
                plen=torch.zeros((), dtype=torch.int32, device=dev),
                last=torch.zeros((1,), dtype=torch.long, device=dev),
                aid=torch.zeros((1,), dtype=torch.int32, device=dev),
                logits=torch.zeros((1, 1, cfg.vocab_size), dtype=dtype,
                                   device=dev),
                kv=torch.zeros(self._nl * 2 * rows * self._hkv
                               * cfg.head_dim, dtype=dtype, device=dev))
        buf = None
        if route == "prefix":
            buf = self._pf_prefix.get(cap)
            if buf is None:
                buf = self._pf_prefix[cap] = self._prefix_buffer(cap, dtype)
        kv_shape = (self._nl, 2, 1, Cb, self._hkv, cfg.head_dim)
        g = self._prefill_graphs[key] = _PrefillGraph(
            key, torch.zeros((1, Cb), dtype=torch.int32, device=dev),
            sh["last"], sh["plen"] if buf is not None else None, buf,
            sh["logits"], sh["kv"][:math.prod(kv_shape)].view(kv_shape),
            sh["aid"] if key[3:] == ("lora",) else None)
        return g

    def _prefix_buffer(self, cap: int, dtype: torch.dtype) -> torch.Tensor:
        """A zeroed prefix buffer of ``cap`` rows [L, 2, 1, cap, H_kv, D]
        (this rank's layers and KV heads): a
        view of the shared storage of ``TAIL_GRAPH_PREFIX`` rows (made at
        the first such capacity) when it fits, else a tensor of its own.
        The keys may share it: each chunk copies its own prefix in before
        its body runs, and the engine's prefill graphs run one at a time."""
        cfg = self.cfg
        shape = (self._nl, 2, 1, cap, self._hkv, cfg.head_dim)
        if cap > TAIL_GRAPH_PREFIX:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        flat = self._pf_shared.get("prefix")
        if flat is None:
            flat = self._pf_shared["prefix"] = torch.zeros(
                math.prod(shape[:3] + (TAIL_GRAPH_PREFIX,) + shape[4:]),
                dtype=dtype, device=self.device)
        return flat[:math.prod(shape)].view(shape)

    def _prefill_body(self, g: "_PrefillGraph") -> None:
        """The prefill chunk body over ``g``'s static buffers: K3 over the
        bucket's tokens, or K2 over the prefix buffer with the device
        ``prefix_len``; the logits of row ``g.last`` and the chunk's KV land
        in the shared outputs.  The same code runs eagerly on the CPU and
        is what a CUDA graph captures on the card."""
        lkw = {} if g.aid is None else self._lora_args(g.aid)
        logits, kv = self._prefill(self.params, tokens=g.tokens,
                                   prefix_kv=g.buf, prefix_len=g.plen,
                                   logits_rows=g.last, **lkw)
        g.logits.copy_(logits)
        g.kv.copy_(kv)

    def _param_ptrs(self) -> tuple:
        """The weights' pointers, then the bank's and its scale: what a
        graph reads by address and bakes in."""
        p = self.params
        ptrs = tuple(t.data_ptr() for t in (
            p["embed"], p["lm_head"], p["ln_out"], *p["layers"].values()))
        if self.lora is not None:
            ptrs += tuple(t.data_ptr() for ab in self.lora.tree.values()
                          for t in ab) + (self.lora.scale,)
        return ptrs

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
        chain, so it is private to this sequence.  Under tensor
        parallelism ``kv`` holds every head, on the leader; each rank gets
        its slice."""
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
        self._op("adopt_pages", list(ids), kv=kv)
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
        system-prompt API), under the adapter's key namespace: their pages
        replicate to the ring successors on the next push.  Returns the
        stems pinned; a no-op returning 0 on one store node, which has
        nowhere to replicate."""
        self._check_adapter(adapter_id)
        pin = getattr(self.transfer, "pin_prefix", None)
        if pin is None:
            return 0
        return pin(chunk_keys(tokens, self._adapter_model_id(adapter_id),
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
        self._op("prefill_drop", pp.pid)

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
        ``adapter_ids`` (one per prompt, default 0): a group mixes adapters
        in its one forward.

        On page exhaustion mid-batch, states created so far are released
        before the MemoryError propagates."""
        prompts = [list(p) for p in prompts]
        if not prompts or any(len(p) < 1 for p in prompts):
            raise ValueError("prefill_batch needs non-empty prompts")
        aids = list(adapter_ids) if adapter_ids else [0] * len(prompts)
        if len(aids) != len(prompts):
            raise ValueError(f"{len(aids)} adapter ids for {len(prompts)} "
                             f"prompts")
        for aid in aids:
            self._check_adapter(aid)
        T = self.pc.block_tokens
        out: List[Optional[SequenceState]] = [None] * len(prompts)
        created: List[SequenceState] = []
        try:
            if self.transfer is not None:
                # with a store each sequence's reusable prefix differs:
                # the per-sequence path, as the reference
                for i, p in enumerate(prompts):
                    st = self.prefill(p, adapter_id=aids[i])
                    created.append(st)
                    out[i] = st
                return out  # type: ignore[return-value]
            groups: Dict[int, List[int]] = {}
            deferred: List[int] = []
            wave_chunk0: set = set()
            for i, p in enumerate(prompts):
                ks = chunk_keys(p, self._adapter_model_id(aids[i]),
                                chunk_tokens=T)
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
                        st = self.prefill(prompts[i], adapter_id=aids[i])
                        created.append(st)
                        states.append(st)
                else:
                    states = self._prefill_group(
                        [prompts[i] for i in idxs], bucket,
                        [aids[i] for i in idxs])
                    created.extend(states)
                for i, st in zip(idxs, states):
                    out[i] = st

            for i in deferred:  # now the wave's pages are registered
                st = self.prefill(prompts[i], adapter_id=aids[i])
                created.append(st)
                out[i] = st
        except MemoryError:
            for st in created:
                self.release(st)
            raise
        return out  # type: ignore[return-value]

    def _prefill_group(self, group: List[List[int]], bucket: int,
                       aids: List[int]) -> List[SequenceState]:
        """One padded forward + one cache scatter for a same-bucket group
        (mixed adapters ride the per-row id vector; pad rows take 0)."""
        T = self.pc.block_tokens
        B = len(group)
        Bp = _round_up_pow2(B, 1)
        n_pages_each = [-(-len(p) // T) for p in group]
        ids_all = self.pages.acquire(sum(n_pages_each))  # before any mutation
        tokens = np.zeros((Bp, bucket), dtype=np.int32)
        for b, p in enumerate(group):
            tokens[b, : len(p)] = p
        full = bucket // T
        sel = np.concatenate([
            b * full + np.arange(n_pg) for b, n_pg in enumerate(n_pages_each)
        ])
        with _stepprof.phase("prefill.eager"):
            logits = self._op("prefill_group", tokens, list(ids_all), sel,
                              aids + [0] * (Bp - B))
        _stepprof.note_dispatch("prefill")  # one padded group forward
        _stepprof.note_work("prefill_tokens_eager",
                            sum(len(p) for p in group))
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
                chunk_keys=chunk_keys(p, self._adapter_model_id(aids[b]),
                                      chunk_tokens=T),
                last_logits=last_rows[b], adapter_id=aids[b],
            )
            self.pages.register(st.chunk_keys, st.block_ids[: len(p) // T])
            self._next_id += 1
            self.seqs[st.seq_id] = st
            states.append(st)
            off += n_pg
        return states

    def _op_prefill_group(self, tokens: np.ndarray, block_ids: List[int],
                          sel: np.ndarray, aids: List[int]) -> torch.Tensor:
        """A same-bucket group's padded forward and its cache landing;
        returns the logits [Bp, bucket, V]."""
        logits, kv = self._prefill(
            self.params, tokens=torch.from_numpy(tokens).to(self.device),
            **self._lora_args(aids))
        self.cache = _write_group_pages(self.cache, block_ids, kv, sel,
                                        self.pc.block_tokens)
        return logits

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
        if g.collect:
            q = torch.softmax(_sampling_logits(g.logits.float(), g.variant,
                                               g.temp, g.top_k, g.top_p), -1)
            g.q.index_copy_(0, g.step, q[None])
        if g.penalized:
            g.pen[0].scatter_add_(1, tok.long()[:, None], g.ones)
        slot = torch.gather(g.table, 1, (g.pos // T)[:, None].long())[:, 0]
        lkw = {} if g.aid is None else self._lora_args(g.aid)
        logits, _ = self._decode(
            self.params, tokens=tok, positions=g.pos,
            cache=self.cache, block_table=g.table, seq_lens=g.pos + 1,
            slot_block_ids=slot, slot_ids=g.pos % T, **lkw,
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
        g.param_ptrs = self._param_ptrs()

    def _capture_graph(self, g, body, name: str, kind: str) -> None:
        """Capture ``body()`` into a CUDA graph on the engine's stream, out
        of the engine's graph pool; sets ``g.graph`` and ``g.captured`` (the
        launches each replay makes), notes the capture under ``name`` for
        the step profiler (``/debug/engine`` shows it as a compile) and
        counts it and its seconds under ``kind``.  ``body`` writes only
        static tensors made outside the capture, so nothing the pool holds
        outlives a replay and any graph of the pool may replay next.  A
        failed capture raises, and so does a tensor-parallel group whose
        collectives run on the host (gloo)."""
        if not self._capture_ok:
            raise RuntimeError(
                f"a {self._grp.backend} serving group runs its "
                f"collectives on the host: no CUDA graph can capture them "
                f"(the graph bodies run eagerly)")
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # ``capture_begin``/``capture_end`` on the engine's stream rather
        # than ``torch.cuda.graph``, whose entry synchronizes the whole
        # device and empties the allocator's cache: another engine's thread
        # in this process may hold a capture open, and those calls break
        # it.  The cyclic garbage collector is held off meanwhile: a
        # collection inside the capture that frees an unreachable engine
        # destroys its CUDA graphs on this thread, which invalidates the
        # capture.  The tally counts this thread's kernel calls only.
        reserved = torch.cuda.memory_reserved(self.device)
        with _cyclic_gc_held(), ca.capture_tally() as tally, \
                torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        secs = time.perf_counter() - t0
        self.graph_pool_bytes += max(
            0, torch.cuda.memory_reserved(self.device) - reserved)
        g.captured = tally
        g.graph = graph
        self.graph_captures[kind] += 1
        self.graph_capture_s[kind] += secs
        _stepprof.note_capture(name, secs)

    def _replay(self, g, kind: str, times: int = 1) -> None:
        """Replay ``g``'s graph ``times`` times, each adding its captured
        launches to this thread's counts, and count the replays under
        ``kind`` (the caller adds their host seconds, from the phase that
        timed them, to ``graph_replay_s``)."""
        for _ in range(times):
            g.graph.replay()
            ca.count_replay(g.captured)
        g.replays += times
        self.graph_replays[kind] += times

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
        time runs its first step eagerly and is captured after it.  The
        ``decode.replay`` phase times the replays (or the eager bodies)."""
        g.step.zero_()
        if eager or self.device.type != "cuda" or not self._capture_ok:
            with _stepprof.phase("decode.replay"):
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
        if g.param_ptrs != self._param_ptrs():
            raise RuntimeError("the weights or the LoRA bank moved since "
                               "this decode graph was captured")
        with _stepprof.phase("decode.replay", timed=True) as ph:
            self._replay(g, "decode", chunk - done)
        self.graph_replay_s["decode"] += ph.wall_s

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
        collect: bool = False,
    ):
        """``decode_batch``; ``eager=True`` runs the step body eagerly on
        the card as well (the graphs' yardstick in the card tests and
        ``chip_smoke.py``).  ``collect=True`` (``propose``) also returns,
        per step and row, the exact post-truncation distribution each
        token was drawn from: ``(outs, q [n_steps, B, V] f32)``."""
        with self._on_engine_stream():
            with _stepprof.phase("decode.prep"):
                g, penalized, pen_key = self._decode_inputs(
                    states, n_steps, sample, temperature, top_k, top_p, rng,
                    logprobs, presence_penalty, frequency_penalty,
                    repetition_penalty, gen_start, seed, logit_bias,
                    pen_cache, collect)
                B = len(states)
                logprobs = int(logprobs)
                out: List[List[int]] = [[] for _ in range(B)]
                lps: List[List[tuple]] = [[] for _ in range(B)]
                qs: List[torch.Tensor] = []
                ctx0 = sum(len(st.tokens) for st in states)
            remaining = n_steps
            while remaining > 0:
                chunk = min(remaining, self.decode_chunk)
                self._op("decode_chunk", g.key, chunk, eager)
                # the whole batch advanced a chunk: its work is rows x
                # steps, and the context each row-step attends over (a row
                # of L tokens at the chunk's start reads L + 1 .. L + chunk)
                done = n_steps - remaining
                _stepprof.note_dispatch("decode")
                _stepprof.note_tokens(chunk * B)
                _stepprof.note_sync("decode_tokens")
                _stepprof.note_work("decode_rows", chunk * B)
                _stepprof.note_work(
                    "decode_ctx_tokens",
                    chunk * (ctx0 + B * done) + B * chunk * (chunk + 1) // 2)
                with _stepprof.phase("decode.sync"):
                    host_toks = g.toks[:chunk].cpu().numpy()  # one per chunk
                with _stepprof.phase("decode.unpack"):
                    if self._grp is not None:
                        self.rank_tokens.append(host_toks[:, :B].tolist())
                    if collect:
                        qs.append(g.q[:chunk, :B].clone())
                    for b in range(B):
                        out[b].extend(int(t) for t in host_toks[:, b])
                    if logprobs:
                        h_ch = g.chosen[:chunk].cpu().numpy()  # [chunk, Bp]
                        h_ti = g.top_id[:chunk].cpu().numpy()  # [.., Bp, k]
                        h_tl = g.top_lp[:chunk].cpu().numpy()
                        for b in range(B):
                            if logprobs_rows is not None \
                                    and not logprobs_rows[b]:
                                continue
                            lps[b].extend(
                                (float(h_ch[s, b]),
                                 [(int(h_ti[s, b, j]), float(h_tl[s, b, j]))
                                  for j in range(logprobs)])
                                for s in range(chunk)
                            )
                remaining -= chunk
            with _stepprof.phase("decode.unpack"):
                rows = g.logits[:B].clone()
                for b, st in enumerate(states):
                    st.tokens.extend(out[b])
                    st.last_logits = rows[b]
                if penalized and pen_cache is not None:
                    # single entry: one active batch composition at a time
                    pen_cache.clear()
                    pen_cache[pen_key] = (
                        tuple(len(st.tokens) for st in states), g)
        if collect:
            return out, torch.cat(qs)
        if logprobs:
            return out, lps
        return out

    def _decode_inputs(self, states, n_steps, sample, temperature, top_k,
                       top_p, rng, logprobs, presence_penalty,
                       frequency_penalty, repetition_penalty, gen_start,
                       seed, logit_bias, pen_cache, collect):
        """``decode_batch``'s arguments checked, the rows' pages acquired
        for ``n_steps`` more tokens and their inputs copied into the
        buffers of their decode-graph key, on the engine's stream; returns
        the key's ``_DecodeGraph``, whether the batch is penalised and its
        penalty-cache key."""
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
                                penalized, self.decode_chunk, collect)
                               + self._lora_key())
        torch.stack([st.last_logits for st in states], out=g.logits[:B])
        if g.aid is not None:
            # each row's adapter; pad rows take the base model
            g.aid.copy_(torch.tensor(
                [st.adapter_id for st in states] + [0] * npad,
                dtype=torch.int32))
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
        self._op("decode_begin", g.key)
        return g, penalized, pen_key

    def _op_decode_begin(self, key: tuple) -> None:
        """In a serving group: the leader's inputs of ``key``'s decode graph
        (logits, positions, table, sampling vectors, penalty state) into
        every rank's buffers, so every rank steps from the same bits."""
        if self._grp is None:
            return
        for t in self._decode_graph(key).inputs():
            self._grp.broadcast_(t)

    def _op_decode_chunk(self, key: tuple, chunk: int, eager: bool) -> None:
        g = self._decode_graph(key)
        self._run_chunk(g, chunk, eager)
        if not self.is_leader:
            self.rank_tokens.append(
                g.toks[:chunk].cpu().numpy()[:, :self._rows(g)].tolist())

    def _rows(self, g: "_DecodeGraph") -> int:
        # the real rows of the leader's batch: the pad rows' table entries
        # are n_blocks
        return int((g.table[:, 0] != self.pc.n_blocks).sum())

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

    def propose(
        self,
        state: SequenceState,
        k: int,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        rng: Optional[torch.Generator] = None,
    ):
        """Sample ``k`` tokens autoregressively (the speculative-decoding
        DRAFT contract) and return ``(tokens, q)`` where ``q[i]`` is the
        full post-truncation distribution token ``i`` was drawn from [k,
        V] f32, on the device: the accept/reject test needs q_i(x) exactly
        as sampled, so it comes out of the same decode step that drew the
        tokens (the decode graph's collecting form).  Advances ``state``
        like ``decode``; the draft proposes unpenalized."""
        toks, q = self._decode_batch(
            [state], k, sample="categorical", temperature=temperature,
            top_k=top_k, top_p=top_p, rng=rng, collect=True)
        return toks[0], q[:, 0]

    def sampling_probs(
        self,
        logits: torch.Tensor,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
    ) -> torch.Tensor:
        """The engine's exact post-truncation sampling distribution for a
        stack of logits rows [S, V] (f32): the TARGET side of the
        speculative accept/reject test, the math ``decode`` samples from."""
        S = logits.shape[0]
        variant = "filter" if (top_k > 0 or top_p < 1.0) else "plain"

        def full(x, dt):
            return torch.full((S,), x, dtype=dt, device=logits.device)

        return torch.softmax(_sampling_logits(
            logits.float(), variant, full(max(temperature, 1e-6),
                                          torch.float32),
            full(top_k, torch.int32), full(top_p, torch.float32)), dim=-1)

    def verify(self, state: SequenceState, run_tokens: Sequence[int],
               start_pos: int, last_only: bool = False) -> torch.Tensor:
        """Process ``run_tokens`` at positions ``start_pos..`` in ONE paged
        forward (the speculative-decode verify step, eager): their K/V are
        written into the cache and the logits after each token come back
        [S, V] ([1, V], the last token's, with ``last_only``).  In a
        serving group it is an op every rank runs on its shard, the logits
        gathered as decode's are.

        Does NOT update ``state.tokens``: the caller decides which tokens
        are accepted.  K/V written for later-rejected tokens is harmless:
        attention masks by absolute position, and a future token at the
        same position overwrites the same page slot."""
        if not self._has_verify:
            raise ValueError(
                "this engine's model family has no verify step; pass "
                "verify_fn= with the contract of models.llama."
                "verify_forward to use verify()/speculative decoding")
        S = len(run_tokens)
        if S < 1:
            raise ValueError("verify needs at least one token")
        T = self.pc.block_tokens
        need = -(-(start_pos + S) // T)
        if need > len(state.block_ids):
            state.block_ids.extend(self.pages.acquire(
                need - len(state.block_ids)))
        poss = np.arange(start_pos, start_pos + S, dtype=np.int32)
        slot_blocks = np.asarray([state.block_ids[p // T] for p in poss],
                                 dtype=np.int32)
        _stepprof.note_dispatch("verify")
        with self._on_engine_stream():
            logits = self._op("verify", [list(run_tokens)], poss[None],
                              slot_blocks[None], self._block_table([state]),
                              [state.adapter_id], last_only)
        return logits[0]

    def _op_verify(self, tokens: List[List[int]], poss: np.ndarray,
                   slot_blocks: np.ndarray, table: np.ndarray,
                   adapter_ids: List[int], last_only: bool) -> torch.Tensor:
        """The verify forward over host rows: logits [B, S or 1, V]."""
        T = self.pc.block_tokens

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        fn = self._verify_last if last_only else self._verify
        logits, self.cache = fn(
            self.params, tokens=self._tokens(tokens), positions=dev(poss),
            cache=self.cache, block_table=dev(table),
            slot_block_ids=dev(slot_blocks), slot_ids=dev(poss % T),
            **self._lora_args(adapter_ids))
        return logits

    # ---- speculation's rounds in a serving group ----

    def spec_share_(self, t: torch.Tensor) -> None:
        """In a serving group: the leader's ``t`` into every rank's, in
        place (a round body's proposals and accepted counts); a no-op
        without a mesh.  A collective: the followers' bodies
        (``_follow_round``) make the same calls in the same order."""
        if self._grp is not None:
            self._grp.broadcast_(t)

    def _follow_graph(self, key: tuple):
        """A follower's round-graph buffers for ``key`` = ("follow", batch
        bucket, target table width, k): each row's accepted length and
        block table, loaded by ``spec_load``."""
        from .speculative import _RoundGraph

        g = self._spec_graphs.get(key)
        if g is None:
            _, Bp, Wt, _k = key
            g = self._spec_graphs[key] = _RoundGraph(key, dict(
                n=torch.zeros((Bp,), dtype=torch.int32, device=self.device),
                t_table=torch.zeros((Bp, Wt), dtype=torch.int32,
                                    device=self.device)))
        return g

    def _op_spec_load(self, key: tuple, n: Optional[torch.Tensor] = None,
                      table: Optional[torch.Tensor] = None) -> None:
        """A round dispatch's starting state: the leader's accepted lengths
        ``n`` and target block table into every follower's ``key``
        buffers."""
        if self._grp is None:
            return
        if n is None:
            g = self._follow_graph(key)
            n, table = g.n, g.t_table
        self._grp.broadcast_(table)
        self._grp.broadcast_(n)

    def _op_spec_rounds(self, key: tuple, R: int, body=None,
                        refresh=None) -> None:
        """``R`` speculative rounds, then the refresh: on the leader its
        speculator's own bodies (``body()``, ``refresh()``); on a follower
        the target's half of them over its ``key`` buffers: each round
        takes the leader's ``[prev, p_1..p_k]``, verifies them on this
        rank's shard and advances by the leader's accepted count, so the
        ranks' caches end at the same length."""
        if body is not None:
            body(R)
            refresh()
            return
        from .speculative import run_body

        g = self._follow_graph(key)
        run_body(self, g, g.round, lambda: self._follow_round(g),
                 f"spec_follow{key}", R, (self,))
        run_body(self, g, g.refresh, lambda: self._follow_refresh(g),
                 f"spec_follow_refresh{key}", 1, (self,))

    def _follow_round(self, g) -> None:
        """A follower's half of one round (the collectives of the leader's
        round body, in its order)."""
        from .speculative import _slots

        _, Bp, _, k = g.key
        run = torch.zeros((Bp, k + 1), dtype=torch.int32, device=self.device)
        self.spec_share_(run)
        poss = g.n[:, None] - 1 + torch.arange(
            k + 1, dtype=torch.int32, device=self.device)[None]
        blks, slots = _slots(g.t_table, poss, self.pc.block_tokens)
        self._verify(self.params, tokens=run, positions=poss,
                     cache=self.cache, block_table=g.t_table,
                     slot_block_ids=blks, slot_ids=slots)
        cnt = torch.zeros((Bp,), dtype=torch.int32, device=self.device)
        self.spec_share_(cnt)
        g.n.add_(cnt)

    def _follow_refresh(self, g) -> None:
        """A follower's half of the refresh: the last accepted token's
        last-row verify."""
        from .speculative import _slots

        last = torch.zeros((g.n.shape[0], 1), dtype=torch.int32,
                           device=self.device)
        self.spec_share_(last)
        posF = g.n[:, None] - 1
        blk, slot = _slots(g.t_table, posF, self.pc.block_tokens)
        self._verify_last(self.params, tokens=last, positions=posF,
                          cache=self.cache, block_table=g.t_table,
                          slot_block_ids=blk, slot_ids=slot)

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
        self._check_adapter(adapter_id)
        S = len(tokens)
        if S < 1:
            raise ValueError("empty prompt")
        pad = 8
        while pad < S:
            pad *= 2
        row = list(tokens) + [0] * (pad - S)
        toks = self._tokens([row])
        logits = self._op("prompt_forward", row, adapter_id)
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
        reading on the CPU), each storage the graphs share counted once,
        the LoRA bank, and the device memory the graph pool took at the
        captures (the bodies' intermediates; 0 on the CPU)."""
        ts = [self.params["embed"], self.params["lm_head"],
              self.params["ln_out"], *self.params["layers"].values(),
              self.cache]
        if self.lora is not None:
            ts += [t for ab in self.lora.tree.values() for t in ab]
        graphs = {}
        for g in [*self._graphs.values(), *self._prefill_graphs.values()]:
            for t in g.buffers():
                st = t.untyped_storage()
                graphs[st.data_ptr()] = st.nbytes()
        return sum(t.numel() * t.element_size() for t in ts) + \
            sum(graphs.values()) + self.graph_pool_bytes

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
    decode chunk, collect), then ``"lora"`` for an engine with a bank (an
    adapter-id buffer ``aid``, one int32 per row).  ``variant`` "greedy" needs no sampling vectors;
    "plain" samples at temperature; "filter" also truncates by top-k /
    top-p.  Seeds need no key of their own: they only change ``rowkey``.
    ``collect`` (``propose``) keeps each step's sampling distribution."""

    def __init__(self, key, vocab: int, dtype: torch.dtype, device):
        Bp, W, variant, lp_k, penalized, C, collect = key[:7]
        self.key = key
        self.variant, self.lp_k, self.penalized = variant, lp_k, penalized
        self.collect = collect

        def z(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        self.logits = z((Bp, vocab), dtype)
        self.pos = z((Bp,), torch.int32)
        self.table = z((Bp, W), torch.int32)
        self.step = z((1,), torch.long)  # the step index inside a chunk
        self.aid = z((Bp,), torch.int32) if key[7:] == ("lora",) else None
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
        if collect:
            self.q = z((C, Bp, vocab), torch.float32)
        if lp_k:
            self.chosen = z((C, Bp), torch.float32)
            self.top_lp = z((C, Bp, lp_k), torch.float32)
            self.top_id = z((C, Bp, lp_k), torch.int32)
        self.graph = None
        self.cache_ptr = None  # the cache the graph was captured against
        self.param_ptrs = None  # the weights and bank it was captured with
        self.captured: Dict[str, int] = {}
        self.replays = 0

    def buffers(self) -> List[torch.Tensor]:
        return [t for t in vars(self).values() if isinstance(t, torch.Tensor)
                ] + list(self.pen)

    def inputs(self) -> List[torch.Tensor]:
        """The buffers a decode call fills before its first step."""
        return [t for t in (self.logits, self.pos, self.table, self.aid,
                            self.greedy, self.temp, self.top_k, self.top_p,
                            self.rowkey) if t is not None] + list(self.pen)


class _PrefillGraph:
    """One prefill-graph key: its token buffer, the static buffers it
    shares with the engine's other prefill keys, its captured chunk
    (``graph``, None until captured; always None on the CPU), the kernel
    launches the capture recorded (``captured``) and its replays.

    ``key`` = (route, prefix capacity, chunk bucket ``Cb``): route
    ``"causal"`` is a chunk with no prefix (K3; capacity 0), ``"prefix"`` a
    later chunk of a prompt, or the single chunk over an exact prefix, over
    the bucketed prefix buffer of that many rows (K2, whose valid length it
    reads from ``plen`` on the device).  Shared: ``last`` (the logits row,
    [1] int64), ``plen``, ``buf`` (one per capacity, views of one storage
    up to ``TAIL_GRAPH_PREFIX``) and the outputs ``logits`` [1, 1, V] and
    ``kv`` [L, 2, 1, Cb, H_kv, D] (a view of one buffer at the largest
    bucket).  An engine with a bank appends ``"lora"`` to the key and
    shares one adapter-id buffer ``aid`` ([1] int32) across its keys."""

    def __init__(self, key, tokens, last, plen, buf, logits, kv, aid=None):
        self.key = key
        self.tokens, self.last, self.plen, self.buf = tokens, last, plen, buf
        self.logits, self.kv, self.aid = logits, kv, aid
        self.graph = None
        self.param_ptrs = None  # the weights the graph was captured with
        self.captured: Dict[str, int] = {}
        self.replays = 0

    def buffers(self) -> List[torch.Tensor]:
        return [t for t in (self.tokens, self.last, self.plen, self.buf,
                            self.logits, self.kv, self.aid)
                if t is not None]


_GRAPH_KINDS = ("decode", "prefill", "spec")
_M32 = 0xFFFFFFFF
# captures in progress in this process (any thread) and whether the cyclic
# garbage collector was on when the first of them began
_GC_HOLD = {"captures": 0, "was_enabled": False}
_GC_HOLD_LOCK = threading.Lock()


@contextlib.contextmanager
def _cyclic_gc_held():
    """Keep the cyclic garbage collector off while any thread of the
    process captures a CUDA graph, and restore it after the last capture
    ends (``gc`` is process-wide, and captures of two engines overlap)."""
    with _GC_HOLD_LOCK:
        if _GC_HOLD["captures"] == 0:
            _GC_HOLD["was_enabled"] = gc.isenabled()
            gc.disable()
        _GC_HOLD["captures"] += 1
    try:
        yield
    finally:
        with _GC_HOLD_LOCK:
            _GC_HOLD["captures"] -= 1
            if _GC_HOLD["captures"] == 0 and _GC_HOLD["was_enabled"]:
                gc.enable()


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
    l = _sampling_logits(l0, variant, temperature, top_k, top_p)
    samp = torch.argmax(l + _gumbel(rowkey, pos, vocab_hash), dim=-1)
    return torch.where(greedy, am, samp).to(torch.int32)


def _sampling_logits(l0: torch.Tensor, variant: str, temperature, top_k,
                     top_p) -> torch.Tensor:
    """The logits a sampled row draws from: f32 ``l0`` [B, V] over the
    per-row temperature, top-k / top-p truncated in the ``"filter"``
    variant.  Their softmax is the row's sampling distribution."""
    l = l0 / temperature[:, None]
    if variant == "filter":
        l = _truncate_logits(l, top_k, top_p)
    return l
