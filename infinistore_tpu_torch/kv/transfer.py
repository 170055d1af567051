"""Device <-> store movement for paged KV.

Counterpart of the reference's ``kv/transfer.py``, with the same surface,
store layout and stage records.  A save gathers a sequence's pages on the
device (one gather, plus the int8 quantize when asked), copies them to the
host in layer bands, and puts them into the store; a load is the mirror
image.  What differs is how the bytes cross PCIe:

* **shm (same host).**  The store's pool is a POSIX shm mapping in this
  process.  Each mapping is page-locked once with ``cudaHostRegister``, so a
  band's device-to-host copy is one DMA straight into the pool slot the
  store allocated for it (the alloc-first ``write_cache_into`` path): no
  host staging copy at all, the counterpart of the reference's GPUDirect
  path.  A registration that fails raises.
* **TCP (cross host).**  Bands land in a pinned, double-buffered staging
  ring: band i+1's DMA runs while band i goes out on the socket.
* **Loads** read each band into pinned staging and start its host-to-device
  copy at once (asynchronous), so the next band's pool read overlaps it;
  the stacked pages are then scattered into the cache IN PLACE
  (``scatter_pages``) after every byte has landed, so a failed load leaves
  the cache untouched.

Ordering on the card: ``push_begin`` (on the thread that computed the
pages) records an event on the compute stream; each band's copy runs on
this engine's copy stream after that event, and ``fill`` returns only when
its band's bytes are in ``dst``, so ``COMMIT_PUT`` never publishes a page
whose DMA is still running.  The gathered pages are a separate tensor (a
snapshot: later in-place cache writes cannot reach it), kept alive by the
push token until every band's copy has finished.

bf16 crosses the wire as raw bytes: staging is a uint8 tensor viewed as
``torch.bfloat16``, never converted (numpy has no bf16).

Key layout: page (layer L, chunk c) of a sequence is stored under
``layer_key(chunk_keys(tokens)[c], L)`` (``:q8`` appended when quantized),
as in the reference, so the two packages read each other's pages.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils import resilience as _resilience
from ..utils import tracing
from .cache import PagedCacheConfig, read_pages, write_pages
from .hashing import layer_key
from .quant import dequantize_pages, page_quant_bytes, quantize_pages


class KVTransferEngine:
    """Moves pages between a paged device cache and an infinistore server.

    ``quant="int8"`` quantizes pages on the device before the device-to-host
    hop (and dequantizes after the host-to-device hop on load), halving
    every byte the store, the shm pool and the link touch; quantized pages
    live under a distinct key namespace (``...#L{i}:q8``) so they can never
    be misread as full-precision pages.

    ``device``: where loaded pages land (``None`` means the GPU and raises
    when there is none; the tests pass ``"cpu"``).
    """

    def __init__(
        self,
        conn,
        cfg: PagedCacheConfig,
        pipeline_groups: int = 4,
        quant: Optional[str] = None,
        breaker: Optional[_resilience.CircuitBreaker] = None,
        push_mode: str = "auto",
        device=None,
    ):
        # the SOURCE connection is kept (not unwrapped): the public wrapper
        # owns the reconnect machinery; ``self.conn`` resolves the CURRENT
        # raw connection and ``_call`` dispatches reconnect-aware
        self._src = conn
        self.cfg = cfg
        self.device = resolve_device(device)
        # circuit breaker over the store transport (the degraded-serving
        # contract: a dead store costs a miss, never a request)
        self.breaker = breaker or _resilience.CircuitBreaker()
        # layer bands per save/load; 1 = fully serial
        self.pipeline_groups = pipeline_groups
        if quant not in (None, "int8"):
            raise ValueError(f"unsupported quant mode: {quant!r}")
        self.quant = quant
        # bytes of one page as it crosses the wire / sits in the pool
        self.wire_page_bytes = page_quant_bytes(cfg) if quant else cfg.page_bytes
        self._key_suffix = ":q8" if quant else ""
        # DOUBLE-buffered load staging, alternated per load call: a band's
        # host-to-device copy may still be running when the next call
        # starts reading the pool.  Both slots grow together, so only a
        # load of a new largest size allocates
        self._staging: list = [None, None]
        self._staging_idx = 0
        if push_mode not in ("auto", "legacy"):
            raise ValueError(f"unsupported push_mode: {push_mode!r}")
        self.push_mode = push_mode
        # pinned staging ring for pushes that do not fill the pool in
        # place (TCP, the native client), double-buffered per band
        self._push_staging: list = [None, None]
        self._push_idx = 0
        # page-locked shm pool mappings: base address -> bytes
        self._pinned: Dict[int, int] = {}
        self._copy_stream: Optional[torch.cuda.Stream] = None
        # per-stage seconds of the LAST push_commit / load_pages (the
        # reference's keys)
        self.last_push_stages: dict = {}
        self.last_load_stages: dict = {}
        # a tensor-parallel engine's page hook (``gather(cache, ids)`` ->
        # whole pages, ``scatter(cache, ids, pages)``): the cache holds
        # one rank's KV heads, the store whole pages (``cfg``'s heads)
        self.tp_pages = None

    @property
    def conn(self):
        """The CURRENT raw wire connection (fresh after a wrapper
        reconnect)."""
        return getattr(self._src, "conn", self._src)

    def _call(self, name: str, *args):
        """Dispatch a connection op reconnect-aware: through the public
        wrapper's ``_call`` when the source is one, directly otherwise.
        Raw-connection semantics either way (``check_exist`` returns the
        wire int, ``get_match_last_index`` returns -1 instead of
        raising)."""
        call = getattr(self._src, "_call", None)
        if call is not None:
            return call(name, *args)
        return getattr(self._src, name)(*args)

    # -- host buffers --

    def _release_mr(self, buf: torch.Tensor) -> None:
        fn = getattr(self._src, "unregister_mr", None)
        if fn is not None:
            fn(buf.data_ptr())

    def _grow(self, ring: list, nbytes: int) -> None:
        """Make both slots of a double-buffered host ring at least
        ``nbytes`` long: page-locked when the device is a GPU (so copies to
        and from them are DMAs that do not block the host), registered
        with the connection, a replaced buffer's registration dropped.
        The slots grow together, so alternating between them never
        allocates at a size the ring has held."""
        for idx, buf in enumerate(ring):
            if buf is None or buf.numel() < nbytes:
                new = torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=self.device.type == "cuda")
                self._src.register_mr(new.data_ptr(), new.numel())
                ring[idx] = new
                if buf is not None:
                    self._release_mr(buf)

    def _ensure_staging(self, nbytes: int) -> torch.Tensor:
        self._grow(self._staging, nbytes)
        self._staging_idx ^= 1
        return self._staging[self._staging_idx]

    def _ensure_push_staging(self, nbytes: int) -> torch.Tensor:
        self._grow(self._push_staging, nbytes)
        self._push_idx ^= 1
        return self._push_staging[self._push_idx]

    def _pin_pool_of(self, dst: np.ndarray) -> None:
        """Page-lock the shm pool mapping that ``dst`` lies in, once per
        mapping (pools the connection maps later are pinned when a band
        first lands in them); registrations of mappings the connection no
        longer holds (a reconnect remapped them) are dropped first.  A
        ``dst`` outside every pool (scratch) stays pageable."""
        addr = dst.ctypes.data
        live = {}
        for pool in getattr(self.conn, "pools", ()):
            arr = getattr(pool, "arr", None)
            if arr is not None:
                live[arr.ctypes.data] = arr.nbytes
        cudart = torch.cuda.cudart()
        for base in [b for b in self._pinned if b not in live]:
            cudart.cudaHostUnregister(base)
            del self._pinned[base]
        for base, size in live.items():
            if base <= addr < base + size and base not in self._pinned:
                err = int(cudart.cudaHostRegister(base, size, 0))
                if err != 0:
                    raise RuntimeError(
                        f"cudaHostRegister of the store's shm pool ({size} "
                        f"bytes) failed with cudaError {err}"
                    )
                self._pinned[base] = size

    def close(self) -> None:
        """Unpin the pool mappings this engine page-locked.  Call before
        closing the connection (its close unmaps them)."""
        if self._pinned:
            cudart = torch.cuda.cudart()
            for base in self._pinned:
                cudart.cudaHostUnregister(base)
            self._pinned.clear()

    # -- the device half of a copy --

    def _stream(self) -> torch.cuda.Stream:
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        return self._copy_stream

    def _d2h_start(self, band: torch.Tensor, ready, dst: np.ndarray):
        """Start copying ``band``'s bytes into host ``dst``: on the copy
        stream after ``ready`` (the compute stream's event at
        ``push_begin``) for a device band, at once for a CPU band.  Returns
        what ``_d2h_wait`` waits on."""
        src = band.reshape(-1).view(torch.uint8)
        if not band.is_cuda:
            np.copyto(dst, src.numpy())
            return None
        stream = self._stream()
        with torch.cuda.device(band.device), torch.cuda.stream(stream):
            stream.wait_event(ready)
            torch.from_numpy(dst).copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return done

    @staticmethod
    def _d2h_wait(done) -> None:
        if done is not None:
            done.synchronize()

    def _band_fill(self, p: torch.Tensor, ready, stages: dict):
        """``fill(dst)`` for one band: copy THIS band into ``dst`` and
        return once its bytes have landed.  When ``dst`` is the mapped
        (page-locked) pool, that one DMA is the whole device->pool
        journey; a CPU band is one host memcpy."""

        def fill(dst: np.ndarray) -> None:
            t0 = time.perf_counter()
            if p.is_cuda:
                self._pin_pool_of(dst)
                self._d2h_wait(self._d2h_start(p, ready, dst))
                stages["d2h_s"] += time.perf_counter() - t0
            else:
                self._d2h_start(p, ready, dst)
                stages["pool_copy_s"] += time.perf_counter() - t0

        return fill

    def _band_host(self, p: torch.Tensor, ready):
        """Just-in-time host materialization of one band (the legacy
        path): a fresh host array holding the band's bytes."""

        def mat() -> np.ndarray:
            host = np.empty(p.numel() * p.element_size(), dtype=np.uint8)
            self._d2h_wait(self._d2h_start(p, ready, host))
            return host

        return mat

    # -- layout --

    def _page_blocks(
        self, chunk_keys_: Sequence[str], l0: int, l1: int
    ) -> List[Tuple[str, int]]:
        """The store layout, defined once for both directions: layer-major,
        chunk-minor ``(key, offset)`` pairs for layers [l0, l1), offsets
        relative to a buffer that starts at layer ``l0``."""
        pb = self.wire_page_bytes
        n = len(chunk_keys_)
        return [
            (layer_key(ck, layer) + self._key_suffix, ((layer - l0) * n + i) * pb)
            for layer in range(l0, l1)
            for i, ck in enumerate(chunk_keys_)
        ]

    def _page_keys(self, chunk_keys_: Sequence[str]) -> List[str]:
        return [
            k for k, _ in self._page_blocks(chunk_keys_, 0, self.cfg.n_layers)
        ]

    def _bands(self) -> List[Tuple[int, int]]:
        L = self.cfg.n_layers
        G = max(1, min(self.pipeline_groups, L))
        Lg = -(-L // G)
        return [(l0, min(l0 + Lg, L)) for l0 in range(0, L, Lg)]

    # -- save --

    def gather_pages(self, cache: torch.Tensor,
                     block_ids: Sequence[int]) -> torch.Tensor:
        """Device half of a save: gather ``block_ids``'s pages as
        [L, n, 2, H, T, D], contiguous so each (layer, chunk) page is one
        run of bytes (+ the int8 quantize: [L, n, wire_page_bytes] uint8).
        A new tensor, so a caller can hand it to a background pusher while
        later chunks write the cache in place."""
        if self.tp_pages is not None:  # every rank's heads
            gathered = self.tp_pages.gather(cache, block_ids)
        else:
            ids = torch.as_tensor(np.asarray(block_ids, dtype=np.int64),
                                  device=cache.device)
            gathered = read_pages(cache, ids)  # [L, 2, H, n, T, D]
        pages = gathered.permute(0, 3, 1, 2, 4, 5).contiguous()
        if self.quant:
            pages = quantize_pages(pages)  # [L, n, wire_page_bytes] uint8
        return pages

    def push_begin(self, pages: torch.Tensor, chunk_keys_: Sequence[str]):
        """Critical-path half of a push, on the thread that computed the
        pages: record an event on its (compute) stream and slice the
        pages into layer bands.  Each band's copy starts on the copy
        stream once ``push_commit`` knows where it goes.  Returns an opaque
        token for ``push_commit``; the token keeps the pages alive."""
        parts = [pages[l0:l1] for l0, l1 in self._bands()]
        ready = None
        if pages.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(pages.device))
        return parts, list(chunk_keys_), ready

    def push_commit(self, token) -> int:
        """Off-critical-path half of a push: land each band straight in the
        shm pool on connections that negotiated alloc-first descriptors,
        through the pinned staging ring on TCP, and COMMIT_PUT.
        Per-stage seconds land in ``last_push_stages``.  Returns bytes
        written."""
        parts, chunk_keys_, ready = token
        L = self.cfg.n_layers
        pb = self.wire_page_bytes
        stages = {"d2h_s": 0.0, "pool_copy_s": 0.0, "wire_s": 0.0,
                  "alloc_s": 0.0, "commit_s": 0.0,
                  "zero_copy_bands": 0, "staged_bands": 0}
        with tracing.span("kv.push_pages", pages=len(chunk_keys_) * L,
                          bytes=len(chunk_keys_) * L * pb):
            total = self._push_banded(parts, chunk_keys_, ready, stages)
        self.last_push_stages = stages
        return total

    def _push_banded(self, parts, chunk_keys_: Sequence[str], ready,
                     stages: dict) -> int:
        pb = self.wire_page_bytes
        raw = self.conn
        l0s = []
        l0 = 0
        for p in parts:
            l0s.append(l0)
            l0 += p.shape[0]
        if (self.push_mode != "legacy"
                and getattr(raw, "shm_mode", False)
                and getattr(raw, "alloc_first", False)):
            # zero-copy path: descriptors learned up front, each band's
            # fill DMAs into the mapped pool itself
            bands = [
                (self._page_blocks(chunk_keys_, l0, l0 + p.shape[0]), pb,
                 self._band_fill(p, ready, stages))
                for l0, p in zip(l0s, parts)
            ]
            info = self._src.write_cache_into(bands)
            stages["alloc_s"] += info.get("alloc_s", 0.0)
            stages["commit_s"] += info.get("commit_s", 0.0)
            stages["zero_copy_bands"] += info.get("zero_copy_bands", 0)
            stages["staged_bands"] += info.get("staged_bands", 0)
            return info["bytes"]
        if self.push_mode != "legacy":
            # no pool to fill in place (TCP / cross-host, or the native
            # client, which copies into its own mapping of the pool): each
            # band lands in the pinned staging ring; band i+1's copy is
            # started before band i's write, into the ring's other slot
            def start(i):
                p = parts[i]
                blocks = self._page_blocks(chunk_keys_, l0s[i],
                                           l0s[i] + p.shape[0])
                nbytes = pb * len(blocks)
                slot = self._ensure_push_staging(nbytes)
                t0 = time.perf_counter()
                done = self._d2h_start(p, ready, slot.numpy()[:nbytes])
                key = "d2h_s" if p.is_cuda else "pool_copy_s"
                stages[key] += time.perf_counter() - t0
                return blocks, nbytes, slot, done

            total = 0
            nxt = start(0)
            for i in range(len(parts)):
                blocks, nbytes, slot, done = nxt
                t0 = time.perf_counter()
                self._d2h_wait(done)
                stages["d2h_s"] += time.perf_counter() - t0
                if i + 1 < len(parts):
                    nxt = start(i + 1)
                stages["staged_bands"] += 1
                t0 = time.perf_counter()
                self._call("write_cache", blocks, pb, slot.data_ptr())
                stages["wire_s"] += time.perf_counter() - t0
                total += nbytes
            return total
        # legacy path (push_mode="legacy"): the banded pipelined put from
        # pageable host arrays
        bands = [
            (self._page_blocks(chunk_keys_, l0, l0 + p.shape[0]), pb,
             self._band_host(p, ready))
            for l0, p in zip(l0s, parts)
        ]
        writer = getattr(self._src, "write_cache_pipelined", None)
        if writer is not None:
            return writer(bands)
        total = 0
        for blocks, _pb, mat in bands:
            host = mat()
            self._call("write_cache", blocks, pb, host.ctypes.data)
            total += host.nbytes
        return total

    def push_pages(self, pages: torch.Tensor,
                   chunk_keys_: Sequence[str]) -> int:
        """Host-side half of a save: ``push_begin`` followed at once by
        ``push_commit``.  The engine's ``_StoreStreamer`` calls the two
        halves on two threads."""
        return self.push_commit(self.push_begin(pages, chunk_keys_))

    def save_pages(
        self, cache: torch.Tensor, block_ids: Sequence[int],
        chunk_keys_: Sequence[str],
    ) -> int:
        """Gather pages from the device cache and put them into the store.

        ``block_ids[i]`` holds the page whose key stem is ``chunk_keys_[i]``.
        Returns bytes written.
        """
        if len(block_ids) != len(chunk_keys_):
            raise ValueError(f"{len(block_ids)} block ids for "
                             f"{len(chunk_keys_)} chunk keys")
        if len(block_ids) == 0:
            return 0
        return self.push_pages(
            self.gather_pages(cache, block_ids), chunk_keys_
        )

    # -- load --

    def load_pages(
        self, cache: torch.Tensor, block_ids: Sequence[int],
        chunk_keys_: Sequence[str],
    ) -> torch.Tensor:
        """Get pages from the store and scatter them into the device cache,
        in place.  Banded: each band's host-to-device copy overlaps the
        next band's pool read.  Returns the cache.  Raises
        InfiniStoreKeyNotFound if any page is missing (reference read
        semantics), leaving the cache untouched."""
        if len(block_ids) != len(chunk_keys_):
            raise ValueError(f"{len(block_ids)} block ids for "
                             f"{len(chunk_keys_)} chunk keys")
        n = len(block_ids)
        if n == 0:
            return cache
        nbytes = self.cfg.n_layers * n * self.wire_page_bytes
        with tracing.span("kv.load_pages", pages=self.cfg.n_layers * n,
                          bytes=nbytes):
            return self._load_pages_banded(cache, block_ids, chunk_keys_, n)

    def fetch_pages(self, chunk_keys_: Sequence[str]) -> torch.Tensor:
        """Wire half of a load: read every (layer, chunk) page of
        ``chunk_keys_`` into this engine's staging ring and start each
        band's host-to-device copy as soon as its bytes are in.  Returns
        the stacked pages on the device in store layout
        (``[L, n, wire_page_bytes]`` uint8 quantized, ``[L, n] +
        page_shape`` otherwise) WITHOUT touching any cache."""
        n = len(chunk_keys_)
        pb = self.wire_page_bytes
        nbytes = self.cfg.n_layers * n * pb
        staging = self._ensure_staging(nbytes)
        bands = []
        meta = []  # (staging offset, span, n_layers) per band
        for l0, l1 in self._bands():
            off = l0 * n * pb
            bands.append((self._page_blocks(chunk_keys_, l0, l1), pb,
                          staging.data_ptr() + off))
            meta.append((off, (l1 - l0) * n * pb, l1 - l0))
        devs: list = [None] * len(bands)

        def upload(i: int) -> None:
            off, span, nl = meta[i]
            band = staging[off: off + span]
            if self.quant:
                host = band.view(nl, n, pb)
            else:
                host = band.view(self.cfg.dtype).view(
                    (nl, n) + self.cfg.page_shape)
            # asynchronous from pinned memory on a GPU; a copy either way,
            # so the staging slot is free for the next call's reads
            devs[i] = host.to(self.device, non_blocking=True, copy=True)

        reader = getattr(self._src, "read_cache_pipelined", None)
        if reader is not None:
            reader(bands, on_band=upload)
        else:  # a bare client: per-band reads, same upload overlap
            for i, (blocks, _pb, ptr) in enumerate(bands):
                self._call("read_cache", blocks, pb, ptr)
                upload(i)
        return devs[0] if len(devs) == 1 else torch.cat(devs, dim=0)

    def scatter_pages(
        self, cache: torch.Tensor, block_ids: Sequence[int],
        stacked: torch.Tensor,
    ) -> torch.Tensor:
        """Device half of a load: dequantize/transpose the stacked pages
        ``fetch_pages`` returned and scatter them into ``block_ids``'s
        slots, in place.  Returns the cache."""
        if self.quant:
            stacked = dequantize_pages(stacked, self.cfg)  # [L, n, 2, H, T, D]
        pages = stacked.permute(0, 2, 3, 1, 4, 5)  # [L, 2, H, n, T, D]
        if self.tp_pages is not None:  # each rank its heads
            return self.tp_pages.scatter(cache, block_ids, pages)
        ids = torch.as_tensor(np.asarray(block_ids, dtype=np.int64),
                              device=cache.device)
        return write_pages(cache, ids, pages)

    def _load_pages_banded(
        self, cache: torch.Tensor, block_ids: Sequence[int],
        chunk_keys_: Sequence[str], n: int,
    ) -> torch.Tensor:
        t0 = time.perf_counter()
        stacked = self.fetch_pages(chunk_keys_)
        t1 = time.perf_counter()
        out = self.scatter_pages(cache, block_ids, stacked)
        # every copy out of this call's staging slot must end before a
        # later call can rewrite it
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
        t2 = time.perf_counter()
        self.last_load_stages = {
            "fetch_s": round(t1 - t0, 6), "scatter_s": round(t2 - t1, 6),
            "pages": self.cfg.n_layers * n,
            "bytes": self.cfg.n_layers * n * self.wire_page_bytes,
        }
        return out

    def lookup_prefix(self, chunk_keys_: Sequence[str]) -> int:
        """Longest store-resident prefix, in chunks.  Probes layer 0 keys
        (a chunk is only readable if every layer committed; layer 0 is
        written first, so verify the last layer before trusting a hit)."""
        if not chunk_keys_:
            return 0
        with tracing.span("kv.lookup_prefix", chunks=len(chunk_keys_)):
            sfx = self._key_suffix
            probe = [layer_key(ck, 0) + sfx for ck in chunk_keys_]
            idx = self._call("get_match_last_index", probe)
            while idx >= 0:
                last = layer_key(chunk_keys_[idx], self.cfg.n_layers - 1) + sfx
                # 0 => exists (wire semantics)
                if self._call("check_exist", last) == 0:
                    break
                idx -= 1
            return idx + 1

    # -- breaker-guarded hops (the degraded-serving contract) --
    #
    # A store failure must cost a cache MISS, never a request.  Transport
    # failures feed the breaker; while it is open the hop is skipped
    # outright.  KeyNotFound (an eviction race) and integrity failures are
    # healthy protocol answers: they degrade to a miss without touching
    # the circuit.

    def guarded_lookup_prefix(self, chunk_keys_: Sequence[str]) -> int:
        """``lookup_prefix`` degraded to 0 (miss) on store failure or an
        open circuit."""
        if not self.breaker.allow():
            _resilience.count_degraded("lookup")
            return 0
        try:
            n = self.lookup_prefix(chunk_keys_)
        except _resilience.transport_errors():
            self.breaker.record_failure()
            _resilience.count_degraded("lookup")
            return 0
        except Exception:  # noqa: BLE001 — a lookup is an optimization
            _resilience.count_degraded("lookup")
            return 0
        self.breaker.record_success()
        return n

    def guarded_load(
        self, cache: torch.Tensor, block_ids: Sequence[int],
        chunk_keys_: Sequence[str],
    ) -> Tuple[torch.Tensor, bool]:
        """``load_pages`` degraded to ``(cache-unchanged, False)`` on any
        failure.  Loads are all-or-nothing (the scatter runs after every
        byte landed), so a failed load leaves the cache untouched and the
        caller falls back to recompute."""
        if not self.breaker.allow():
            _resilience.count_degraded("load")
            return cache, False
        from ..lib import InfiniStoreIntegrityError, InfiniStoreKeyNotFound

        try:
            out = self.load_pages(cache, block_ids, chunk_keys_)
        except InfiniStoreKeyNotFound:
            # a matched page was evicted between lookup and load
            _resilience.count_degraded("load")
            return cache, False
        except InfiniStoreIntegrityError as e:
            # a verification failure IS a cache miss; ask the store to drop
            # the pages that failed so later requests miss cleanly
            if e.cause in ("checksum", "lease") and e.keys:
                try:
                    self._call("delete_keys", list(e.keys))
                except Exception:  # noqa: BLE001 — best-effort hygiene
                    pass
            _resilience.count_degraded("load")
            return cache, False
        except _resilience.transport_errors():
            self.breaker.record_failure()
            _resilience.count_degraded("load")
            return cache, False
        self.breaker.record_success()
        return out, True

    # -- small-blob sidecar (stream-resume checkpoints) --

    def put_blob(self, key: str, data: bytes) -> bool:
        """Write one inline blob under ``key``.  Returns False instead of
        raising on any failure."""
        if not self.breaker.allow():
            return False
        try:
            self._call("w_tcp_bytes", key, data)
        except _resilience.transport_errors():
            self.breaker.record_failure()
            return False
        except Exception:  # noqa: BLE001 — checkpoints are best-effort
            return False
        self.breaker.record_success()
        return True

    def get_blob(self, key: str) -> Optional[bytes]:
        """Read one inline blob, or None.  A miss never touches the
        circuit."""
        if not self.breaker.allow():
            return None
        try:
            arr = self._call("r_tcp", key)
        except _resilience.transport_errors():
            self.breaker.record_failure()
            return None
        except Exception:  # noqa: BLE001 — a miss is a normal answer
            return None
        self.breaker.record_success()
        return bytes(bytearray(arr))
