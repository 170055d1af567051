"""Client-side multi-node store cluster: consistent-hash sharding, a
routed per-endpoint connection pool, and hot-prefix replication.

The single-store stack caps capacity at one host's DRAM and bandwidth at
one host's NIC; PAPER.md §1(c) (cross-host prefix-cache reuse) needs a
fleet.  This module composes pieces the repo already has into that
cluster layer:

* **Sharding** — ``HashRing``: stable virtual-node consistent hashing
  over N store endpoints.  Content-addressed chunk keys
  (``kv/hashing.py``) make routing trivial: the *chunk stem* (the key
  before its ``#L{layer}`` suffix) is the routing unit, so every layer
  of a chunk co-locates on one node and ``get_match_last_index`` still
  answers per node.  The ring is deterministic across processes
  (blake2b, never ``hash()``) and pure — unit-testable with no sockets.
* **Routing** — ``RoutedStorePool``: one reconnect-aware
  ``InfinityConnection`` per endpoint, each with its *own*
  ``CircuitBreaker`` (``utils/resilience.py``) and its own epoch fence
  (``lib.py``), so a dead or restarted node degrades to recompute for
  only its key range — never the fleet — and a restart's stale bytes
  fail closed per node.
* **Replication** — writes for chunk stems flagged *hot* (client-side
  reuse counting in ``HotKeyTracker``, the routed twin of the store's
  server-side hot-key analytics, plus an explicit ``pin`` API for
  system prompts) fan out to R ring-successor nodes; reads fail over
  owner → replica → replica before declaring a miss.
* **Lazy rebalance** — membership change moves no bytes.  A key whose
  owner changed is simply a cache miss that re-pushes under the same
  content-addressed name; the old copy ages out of the old owner's LRU.

``ClusterTransferEngine`` presents the same surface as
``kv.transfer.KVTransferEngine`` (push/load/lookup + the breaker-guarded
degraded hops), so the engine, scheduler, and connector are agnostic:
hand them a ``RoutedStorePool`` instead of a connection and every
per-chunk hop routes by key hash, with multi-endpoint batches split and
issued concurrently.  Single-endpoint configs never construct any of
this — they keep the classic one-connection path byte-identically.

This is the PyTorch port's copy of the reference ``infinistore_tpu.
cluster``: the ring, the pool, membership and migration are the same host
code (so a JAX and a torch client route every chunk stem to the same
node); the device half moves ``torch`` tensors on the card (or the CPU,
when asked).

Metrics (process-default registry, rides every serving ``/metrics``):

* ``istpu_cluster_node_state{endpoint}`` — 0 closed / 1 open / 2 half-open
* ``istpu_cluster_requests_total{endpoint,outcome}`` — per-node hops by
  outcome (ok / error / skipped / miss)
* ``istpu_cluster_replica_reads_total{result}`` — replica failovers that
  hit vs. exhausted as a miss
* ``istpu_cluster_ring_ownership{endpoint}`` — fraction of the hash
  space each endpoint owns
"""

from __future__ import annotations

import bisect
import hashlib
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from .config import ClientConfig, TYPE_SHM
from .utils import metrics as _metrics
from .utils import resilience as _resilience
from .utils.logging import Logger

# virtual nodes per endpoint: enough that ownership spread over a few
# physical nodes stays within ~2x of even (tested), cheap to rebuild
DEFAULT_VNODES = int(os.environ.get("ISTPU_CLUSTER_VNODES", "64"))
# total copies of a HOT chunk (owner + R-1 ring successors); 1 = no
# replication.  Reads always probe up to this many candidates before a
# miss, so it also bounds the failover walk.
DEFAULT_REPLICAS = int(os.environ.get("ISTPU_CLUSTER_REPLICAS", "2"))
# a chunk stem becomes hot after this many lookups touch it (system
# prompts are read-heavy: their stems recur across requests, cold
# one-off prompts never do)
DEFAULT_HOT_AFTER = int(os.environ.get("ISTPU_HOT_AFTER", "3"))
# background migration pacing: copy this many keys per breath, then
# yield — membership changes run UNDER live traffic, so the migrator
# must never saturate a node's data plane
MIGRATE_BATCH = int(os.environ.get("ISTPU_MIGRATE_BATCH", "64"))
MIGRATE_SLEEP_S = float(os.environ.get("ISTPU_MIGRATE_SLEEP_S", "0.005"))

_MEMBERSHIP_CODE = {"active": 0, "joining": 1, "draining": 2}

_RING_SPACE = float(1 << 64)


def ring_hash(s) -> int:
    """Stable 64-bit ring position.  blake2b, never ``hash()``: routing
    must agree across processes and runs (PYTHONHASHSEED randomizes
    ``hash``), or two clients would shard one fleet two ways."""
    if isinstance(s, str):
        s = s.encode()
    return int.from_bytes(hashlib.blake2b(s, digest_size=8).digest(), "big")


def route_stem(key: str) -> str:
    """The routing unit of a page key: its chunk stem — everything
    before the ``#L{layer}`` suffix (and therefore before the ``:q8``
    quant marker that follows it), so every layer of a chunk lands on
    one node and a node-local ``get_match_last_index`` stays sound."""
    return key.rsplit("#L", 1)[0]


def parse_endpoints(spec) -> List[str]:
    """``host:port,host:port`` (or an iterable of them) → normalized,
    order-preserving, deduplicated endpoint list."""
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",")]
    else:
        parts = [str(p).strip() for p in spec]
    out: List[str] = []
    for p in parts:
        if not p:
            continue
        host, sep, port = p.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"bad store endpoint {p!r} (want host:port)")
        ep = f"{host}:{int(port)}"
        if ep not in out:
            out.append(ep)
    if not out:
        raise ValueError("no store endpoints given")
    return out


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Pure and deterministic: ownership depends only on the endpoint set
    and ``vnodes`` — not insertion order, process, or run.  Adding or
    removing one endpoint moves ~1/N of the key space (the consistent-
    hashing contract the unit tests pin)."""

    def __init__(self, endpoints: Sequence[str] = (), vnodes: int = DEFAULT_VNODES):
        assert vnodes >= 1
        self.vnodes = vnodes
        self._endpoints: List[str] = []
        # one ATOMICALLY-swapped snapshot (endpoints, hashes, points):
        # membership changes rebuild a fresh tuple and assign it in one
        # statement, so a router thread mid-``owner()`` never sees a
        # half-updated ring (live join/drain mutates under traffic)
        self._snap: Tuple[Tuple[str, ...], Tuple[int, ...],
                          Tuple[Tuple[int, str], ...]] = ((), (), ())
        for ep in endpoints:
            self.add(ep)

    @property
    def endpoints(self) -> List[str]:
        return list(self._snap[0])

    def __len__(self) -> int:
        return len(self._snap[0])

    def _rebuild(self) -> None:
        pts = [
            (ring_hash(f"{ep}#vn{i}"), ep)
            for ep in self._endpoints
            for i in range(self.vnodes)
        ]
        pts.sort()
        self._snap = (tuple(self._endpoints),
                      tuple(h for h, _ in pts), tuple(pts))

    def clone(self) -> "HashRing":
        return HashRing(self._snap[0], vnodes=self.vnodes)

    def add(self, endpoint: str) -> None:
        if endpoint in self._endpoints:
            return
        self._endpoints.append(endpoint)
        self._rebuild()

    def remove(self, endpoint: str) -> None:
        if endpoint not in self._endpoints:
            return
        self._endpoints.remove(endpoint)
        self._rebuild()

    def owner(self, key: str) -> str:
        """The endpoint owning ``key``'s routing stem: the first virtual
        node at or clockwise of the key's ring position."""
        _eps, hashes, points = self._snap
        if not points:
            raise ValueError("empty ring")
        h = ring_hash(route_stem(key))
        i = bisect.bisect_left(hashes, h) % len(points)
        return points[i][1]

    def successors(self, key: str, n: int) -> List[str]:
        """Up to ``n`` DISTINCT endpoints walking clockwise from the
        key's position — element 0 is the owner, the rest are the
        replica candidates (and the read-failover order)."""
        eps, hashes, points = self._snap
        if not points:
            raise ValueError("empty ring")
        n = min(n, len(eps))
        h = ring_hash(route_stem(key))
        i = bisect.bisect_left(hashes, h)
        out: List[str] = []
        for k in range(len(points)):
            ep = points[(i + k) % len(points)][1]
            if ep not in out:
                out.append(ep)
                if len(out) == n:
                    break
        return out

    def ownership(self) -> Dict[str, float]:
        """Fraction of the hash space each endpoint owns (arc lengths of
        its virtual nodes) — the ring-balance gauge."""
        eps, _hashes, points = self._snap
        if not points:
            return {}
        out = {ep: 0.0 for ep in eps}
        prev = points[-1][0] - (1 << 64)  # wraparound arc
        for h, ep in points:
            out[ep] += (h - prev) / _RING_SPACE
            prev = h
        return out


class HotKeyTracker:
    """Client-side hot-prefix detection: bounded reuse counting over
    chunk stems.  A stem probed by ``hot_after`` distinct lookups is
    hot (system prompts recur across requests; cold prompts are seen
    once); ``pin`` marks stems hot unconditionally and exempts them
    from capacity eviction — the operator API for known system
    prompts."""

    def __init__(self, hot_after: Optional[int] = None, capacity: int = 4096):
        self.hot_after = DEFAULT_HOT_AFTER if hot_after is None else int(hot_after)
        self.capacity = capacity
        self._lock = threading.Lock()
        self._counts: "OrderedDict[str, int]" = OrderedDict()
        self._pinned: set = set()

    def record(self, key: str) -> int:
        stem = route_stem(key)
        with self._lock:
            c = self._counts.pop(stem, 0) + 1
            self._counts[stem] = c  # re-append: LRU order
            while len(self._counts) > self.capacity:
                self._counts.popitem(last=False)
            return c

    def record_many(self, keys: Sequence[str]) -> None:
        for k in keys:
            self.record(k)

    def is_hot(self, key: str) -> bool:
        stem = route_stem(key)
        with self._lock:
            if stem in self._pinned:
                return True
            return self._counts.get(stem, 0) >= self.hot_after

    def pin(self, keys: Sequence[str]) -> int:
        with self._lock:
            before = len(self._pinned)
            self._pinned.update(route_stem(k) for k in keys)
            return len(self._pinned) - before

    def unpin(self, keys: Sequence[str]) -> None:
        with self._lock:
            self._pinned.difference_update(route_stem(k) for k in keys)

    def snapshot(self) -> dict:
        with self._lock:
            hot = sum(1 for c in self._counts.values() if c >= self.hot_after)
            return {
                "hot_after": self.hot_after,
                "tracked": len(self._counts),
                "hot": hot + len(self._pinned - set(self._counts)),
                "pinned": len(self._pinned),
            }


class _Node:
    """One endpoint's client-side state: the reconnect-aware public
    connection, its own circuit breaker (named by endpoint so the
    per-node walk shows up in ``istpu_store_circuit_state``), and a
    lock serializing staging-buffer ops (failover can route two
    groups' fetches at one node concurrently)."""

    def __init__(self, endpoint: str, make_conn, breaker=None):
        self.endpoint = endpoint
        self._make_conn = make_conn
        self.conn = make_conn(endpoint)
        self.breaker = breaker or _resilience.CircuitBreaker(
            name=f"store@{endpoint}"
        )
        # reentrant: ensure_connected() runs both standalone (lookup
        # probes) and under a caller-held staging lock (fetch/commit)
        self.lock = threading.RLock()
        self.connected = False
        self.engine = None  # per-node KVTransferEngine, built lazily

    def ensure_connected(self) -> None:
        """Connect if never (successfully) connected; raises the
        transport error on failure.  A half-connected wrapper is
        replaced wholesale — ``InfinityConnection.connect`` is not
        re-entrant after a partial bootstrap."""
        if self.connected:
            return
        with self.lock:
            if self.connected:
                return
            try:
                self.conn.connect()
            except Exception:
                # fresh wrapper next attempt (a partial connect leaves
                # channels the wrapper refuses to rebuild over)
                self.conn = self._make_conn(self.endpoint)
                self.engine = None
                raise
            self.connected = True


class RoutedStorePool:
    """The routed multi-endpoint pool: ring + per-node connections +
    hot tracker + cluster metrics.  Pure bookkeeping — the transfer
    logic lives in ``ClusterTransferEngine``; benches and tests drive
    the pool directly."""

    def __init__(
        self,
        endpoints,
        connection_type: str = TYPE_SHM,
        op_timeout_s: Optional[float] = None,
        replicas: int = DEFAULT_REPLICAS,
        vnodes: int = DEFAULT_VNODES,
        hot_after: Optional[int] = None,
        num_streams: int = 4,
        conn_factory=None,
        connect: bool = True,
        registry=None,
    ):
        eps = parse_endpoints(endpoints)
        assert replicas >= 1
        self.replicas = min(replicas, len(eps))
        self.ring = HashRing(eps, vnodes=vnodes)
        self.tracker = HotKeyTracker(hot_after=hot_after)
        self.connection_type = connection_type
        self.op_timeout_s = op_timeout_s
        self._num_streams = num_streams
        self._make_conn = conn_factory or self._default_conn
        self._nodes: Dict[str, _Node] = {
            ep: _Node(ep, self._make_conn) for ep in eps
        }
        self._exec = ThreadPoolExecutor(
            max_workers=min(8, max(2, len(eps))),
            thread_name_prefix="istpu-cluster",
        )
        reg = registry or _metrics.default_registry()
        self._g_state = reg.gauge(
            "istpu_cluster_node_state",
            "Per-endpoint store circuit: 0 closed / 1 open / 2 half-open",
            labelnames=("endpoint",),
        )
        self._c_requests = reg.counter(
            "istpu_cluster_requests_total",
            "Cluster store hops per endpoint by outcome "
            "(ok / error / skipped / miss)",
            labelnames=("endpoint", "outcome"),
        )
        self._c_replica = reg.counter(
            "istpu_cluster_replica_reads_total",
            "Reads answered by a replica after owner failover (hit) or "
            "exhausted across all replicas (miss)",
            labelnames=("result",),
        )
        self._g_own = reg.gauge(
            "istpu_cluster_ring_ownership",
            "Fraction of the consistent-hash space each endpoint owns",
            labelnames=("endpoint",),
        )
        # python-side mirrors of the counters, for /debug/cluster
        self._req_counts: Dict[Tuple[str, str], int] = {}
        self._replica_counts = {"hit": 0, "miss": 0}
        self._counts_lock = threading.Lock()
        # live membership: per-endpoint state (active / joining /
        # draining), the PREVIOUS ring while a transition migrates (its
        # owner rides the read-failover walk so any placement stays
        # correct mid-migration), and the migration progress record
        self._membership: Dict[str, str] = {ep: "active" for ep in eps}
        self._old_ring: Optional[HashRing] = None
        self._mig_lock = threading.Lock()
        self._mig_thread: Optional[threading.Thread] = None
        self._migration: Dict = {"state": "idle"}
        self._g_member = reg.gauge(
            "istpu_cluster_membership",
            "Per-endpoint membership state: 0 active / 1 joining "
            "(background migration filling it) / 2 draining (its range "
            "migrating away while it still serves reads)",
            labelnames=("endpoint",),
        )
        self._c_migrated = reg.counter(
            "istpu_cluster_migrated_keys_total",
            "Background membership-migration key copies by result "
            "(copied / skipped already-present / error)",
            labelnames=("result",),
        )
        self._c_mig_bytes = reg.counter(
            "istpu_cluster_migrate_bytes_total",
            "Bytes moved by background membership migration, by copy "
            "path (batched descriptor runs vs the per-key fallback)",
            labelnames=("path",),
        )
        self._refresh_ring_gauges()
        self._refresh_membership_gauges()
        if connect:
            for node in self._nodes.values():
                try:
                    node.ensure_connected()
                except Exception as e:  # noqa: BLE001 — a node down at
                    # boot is a degraded start, not a failed one: its
                    # breaker counts the failure and later hops retry
                    node.breaker.record_failure()
                    self.record_outcome(node.endpoint, "error")
                    Logger.warn(
                        f"store endpoint {node.endpoint} unreachable at "
                        f"pool construction: {e!r} (its key range serves "
                        f"degraded until it comes back)"
                    )

    def _default_conn(self, endpoint: str):
        from .lib import InfinityConnection

        host, _, port = endpoint.rpartition(":")
        return InfinityConnection(ClientConfig(
            host_addr=host,
            service_port=int(port),
            connection_type=self.connection_type,
            op_timeout_s=self.op_timeout_s,
            num_streams=self._num_streams,
            log_level="warning",
        ))

    @classmethod
    def from_config(cls, config: ClientConfig, **kw):
        """Build a pool from a ``ClientConfig`` whose ``endpoints``
        field names the fleet (the template's connection_type /
        op_timeout_s / num_streams apply to every node)."""
        assert config.endpoints, "ClientConfig.endpoints is empty"
        return cls(
            config.endpoints,
            connection_type=config.connection_type or TYPE_SHM,
            op_timeout_s=config.op_timeout_s,
            num_streams=config.num_streams,
            **kw,
        )

    # -- membership / topology --

    @property
    def endpoints(self) -> List[str]:
        return self.ring.endpoints

    def node(self, endpoint: str) -> _Node:
        return self._nodes[endpoint]

    def node_or_none(self, endpoint: str) -> Optional[_Node]:
        """Tolerant lookup: a candidate list computed mid-transition may
        name a node the migrator has since let go."""
        return self._nodes.get(endpoint)

    def nodes(self) -> List[_Node]:
        out = []
        for ep in self.ring.endpoints:
            node = self._nodes.get(ep)
            if node is not None:
                out.append(node)
        return out

    def add_endpoint(self, endpoint: str) -> None:
        """Join a node WITHOUT migration.  Rebalance is LAZY: no bytes
        move — a key whose owner changed is a cache miss that re-pushes
        under its content-addressed name, and the old copy LRU-ages out.
        ``join_node`` is the managed, migrating spelling."""
        ep = parse_endpoints([endpoint])[0]
        if ep in self._nodes:
            return
        self._nodes[ep] = _Node(ep, self._make_conn)
        self._membership[ep] = "active"
        self.ring.add(ep)
        self.replicas = min(max(self.replicas, 1), len(self._nodes))
        self._refresh_ring_gauges()
        self._refresh_membership_gauges()

    def remove_endpoint(self, endpoint: str) -> None:
        node = self._nodes.pop(endpoint, None)
        self._membership.pop(endpoint, None)
        self.ring.remove(endpoint)
        self._refresh_ring_gauges()
        self._refresh_membership_gauges()
        if node is not None:
            try:
                node.conn.close()
            except Exception:  # noqa: BLE001 — already dead is fine
                pass

    def _refresh_ring_gauges(self) -> None:
        own = self.ring.ownership()
        for ep in set(own) | set(self._nodes):
            self._g_own.labels(ep).set(own.get(ep, 0.0))

    def _refresh_membership_gauges(self) -> None:
        for ep in self._nodes:
            self._g_member.labels(ep).set(
                float(_MEMBERSHIP_CODE.get(
                    self._membership.get(ep, "active"), 0))
            )

    # -- live membership: join / drain with background migration --

    def membership(self, endpoint: str) -> str:
        return self._membership.get(endpoint, "active")

    def migration_report(self) -> Dict:
        with self._mig_lock:
            rep = dict(self._migration)
        if rep.get("started_at") and rep.get("state") == "running":
            rep["elapsed_s"] = round(time.monotonic() - rep["started_at"], 2)
        rep.pop("started_at", None)
        # reshape-plane throughput: bytes over the live window while
        # running, over the recorded wall clock once done
        wall = rep.get("elapsed_s") if rep.get("state") == "running" \
            else rep.get("wall_s")
        if wall:
            rep["migrate_gbps"] = round(rep.get("bytes", 0) / wall / 1e9, 3)
            rep["keys_per_s"] = round(
                (rep.get("copied", 0) + rep.get("skipped", 0)) / wall, 1)
        return rep

    def migration_idle(self) -> bool:
        with self._mig_lock:
            return self._migration.get("state") != "running"

    def join_node(self, endpoint: str) -> None:
        """Grow the fleet by one node UNDER TRAFFIC: the node enters the
        ring immediately (new writes land on it; reads that miss there
        fail over to the pre-join owner via the extended candidate walk)
        and a background migrator copies its ~1/N key range over from
        the old owners.  When the copy finishes the node flips
        ``active`` and the old ring is dropped."""
        ep = parse_endpoints([endpoint])[0]
        with self._mig_lock:
            if self._migration.get("state") == "running":
                raise RuntimeError("a membership change is already running")
            if ep in self._nodes:
                raise ValueError(f"{ep} is already a member")
            old = self.ring.clone()
            node = _Node(ep, self._make_conn)
            try:
                node.ensure_connected()
            except Exception as e:  # noqa: BLE001 — refuse, don't degrade:
                # joining an unreachable node would shrink every key's
                # effective replica set for nothing
                raise RuntimeError(f"cannot join {ep}: {e!r}") from e
            self._nodes[ep] = node
            self._membership[ep] = "joining"
            self.ring.add(ep)
            self.replicas = min(max(self.replicas, 1), len(self._nodes))
            self._old_ring = old
            self._migration = {
                "state": "running", "mode": "join", "endpoint": ep,
                "copied": 0, "skipped": 0, "errors": 0, "sources": 0,
                "bytes": 0, "batched": 0,
                "started_at": time.monotonic(),
            }
            self._refresh_ring_gauges()
            self._refresh_membership_gauges()
            self._mig_thread = threading.Thread(
                target=self._migrate_join, args=(ep, old),
                name="istpu-migrate", daemon=True,
            )
            self._mig_thread.start()

    def drain_node(self, endpoint: str) -> None:
        """Shrink the fleet by one node UNDER TRAFFIC: the node leaves
        the ring immediately (no new writes), KEEPS serving reads as the
        old-ring owner on the extended candidate walk, while the
        migrator copies its owned range to the new owners; when the copy
        finishes the node is disconnected and forgotten."""
        ep = parse_endpoints([endpoint])[0]
        with self._mig_lock:
            if self._migration.get("state") == "running":
                raise RuntimeError("a membership change is already running")
            if ep not in self._nodes:
                raise ValueError(f"{ep} is not a member")
            if len(self.ring.endpoints) <= 1:
                raise ValueError("cannot drain the last node")
            old = self.ring.clone()
            self.ring.remove(ep)
            self._membership[ep] = "draining"
            self.replicas = min(self.replicas, len(self.ring.endpoints))
            self._old_ring = old
            self._migration = {
                "state": "running", "mode": "drain", "endpoint": ep,
                "copied": 0, "skipped": 0, "errors": 0, "sources": 1,
                "bytes": 0, "batched": 0,
                "started_at": time.monotonic(),
            }
            self._refresh_ring_gauges()
            self._refresh_membership_gauges()
            self._mig_thread = threading.Thread(
                target=self._migrate_drain, args=(ep, old),
                name="istpu-migrate", daemon=True,
            )
            self._mig_thread.start()

    def _node_keys(self, ep: str) -> Dict[str, Optional[int]]:
        """Enumerate a node's retrievable keys as ``{key: size | None}``.
        Sized listings (LIST_KEYS_F_SIZES) feed the descriptor-batched
        copy path; a peer that predates the flag — or a test double that
        only implements the names-only surface — yields ``None`` sizes
        and those keys ride the per-key fallback."""
        node = self._nodes.get(ep)
        if node is None:
            return {}
        with node.lock:
            node.ensure_connected()
            sized = getattr(node.conn, "list_keys_sizes", None)
            if sized is not None:
                try:
                    rows = sized()
                except Exception:  # noqa: BLE001 — old peer / test double
                    rows = None
                if rows is not None:
                    return {k: int(sz) for k, sz in rows}
            return dict.fromkeys(node.conn.list_keys())

    def _copy_key(self, key: str, src_ep: str, dst_ep: str) -> str:
        """Move one key's bytes src → dst (reads and writes ride the
        nodes' own reconnect-aware connections).  Returns the counted
        result: already-present destinations are ``skipped`` (pushes
        since the ring changed already landed there), a vanished source
        key too (it LRU-aged out — lazy heal covers it)."""
        src = self._nodes.get(src_ep)
        dst = self._nodes.get(dst_ep)
        if src is None or dst is None:
            return "error"
        from .lib import InfiniStoreKeyNotFound

        try:
            with dst.lock:
                dst.ensure_connected()
                if dst.conn.check_exist(key):
                    return "skipped"
            with src.lock:
                data = src.conn.tcp_read_cache(key)
            with dst.lock:
                dst.conn.tcp_write_cache(
                    key, data.ctypes.data, data.nbytes
                )
            return "copied"
        except InfiniStoreKeyNotFound:
            return "skipped"
        except Exception:  # noqa: BLE001 — counted; lazy rebalance heals
            return "error"

    def _copy_batch(self, keys: List[str], size: int,
                    src_ep: str, dst_ep: str, have=None):
        """Move a same-size run of keys src → dst over the batched
        descriptor machinery pointed at a peer store: one batched
        ``ALLOC_PUT`` reserves the whole run at the destination, bulk
        descriptor reads stream it out of the source pool, and ONE
        ``COMMIT_PUT`` (shm) / one atomic inline frame (tcp) commits —
        so a torn run is never committed; the pending-TTL reaper
        reclaims any uncommitted allocation if this thread dies mid-run.

        ``have`` is an optional snapshot of the destination's key set
        (one listing per destination, taken by the caller) — it replaces
        the per-key ``check_exist`` round trip that would otherwise
        dominate a batched run.  The skip it implements is best-effort
        either way: a push can land between any existence check and the
        batch commit, so the snapshot only widens an existing race
        window, it doesn't open one.

        Returns ``(copied, skipped, errors, nbytes)``, or ``None`` when
        the batch cannot complete as a unit (a source key vanished
        mid-run, a transport error, or a peer without the batched
        surface) — the caller re-walks that run per-key, which skips
        vanished keys individually and counts real failures."""
        src = self._nodes.get(src_ep)
        dst = self._nodes.get(dst_ep)
        if src is None or dst is None or size <= 0:
            return None
        if not (hasattr(src.conn, "read_cache")
                and hasattr(dst.conn, "write_cache")):
            return None
        import numpy as np

        try:
            if have is not None:
                todo = [key for key in keys if key not in have]
                skipped = len(keys) - len(todo)
            else:
                todo = []
                skipped = 0
                with dst.lock:
                    dst.ensure_connected()
                    for key in keys:
                        if dst.conn.check_exist(key):
                            skipped += 1  # a push since the ring changed
                        else:
                            todo.append(key)
            if not todo:
                return (0, skipped, 0, 0)
            buf = np.empty(len(todo) * size, dtype=np.uint8)
            blocks = [(key, i * size) for i, key in enumerate(todo)]
            with src.lock:
                src.ensure_connected()
                src.conn.read_cache(blocks, size, buf.ctypes.data)
            with dst.lock:
                dst.ensure_connected()
                dst.conn.write_cache(blocks, size, buf.ctypes.data)
            return (len(todo), skipped, 0, len(todo) * size)
        except Exception:  # noqa: BLE001 — incl. KeyNotFound: the run
            # is re-walked per-key so one vanished entry costs only its
            # own skip, never the batch
            return None

    def _migrate_pairs(self, pairs, ep: str) -> None:
        """Drive the copy loop and settle the transition.  ``pairs`` is
        a sequence of (key, src, dst, size-or-None).  Consecutive keys
        with the same (src, dst, size) move as ONE descriptor-batched
        run of up to ``MIGRATE_BATCH`` keys; unsized keys (old peer,
        names-only listing) and failed runs fall back to the per-key
        copy, which is also the monkeypatch point the membership tests
        pace on."""
        # group-friendly order: same (src, dst, size) keys become
        # adjacent so batched runs form even from interleaved listings
        pairs = sorted(pairs, key=lambda p: (p[1], p[2], p[3] or 0))
        copied = skipped = errors = moved_bytes = batched = 0

        def _account(c, s, e, nb, via_batch):
            nonlocal copied, skipped, errors, moved_bytes, batched
            copied += c
            skipped += s
            errors += e
            moved_bytes += nb
            batched += c if via_batch else 0
            if nb:
                self._c_mig_bytes.labels(
                    "batched" if via_batch else "per_key").inc(nb)
            with self._mig_lock:
                self._migration.update(
                    copied=copied, skipped=skipped, errors=errors,
                    bytes=moved_bytes, batched=batched)

        def _per_key(run):
            for key, src, dst, size in run:
                result = self._copy_key(key, src, dst)
                self._c_migrated.labels(result).inc()
                _account(result == "copied", result == "skipped",
                         result == "error",
                         (size or 0) if result == "copied" else 0, False)

        # one key-listing snapshot per destination feeds every batched
        # run's already-present filter (``None`` = listing unavailable,
        # fall back to per-key existence checks inside the batch)
        dst_have: Dict[str, Optional[set]] = {}

        i = 0
        n = len(pairs)
        since_breath = 0
        while i < n:
            key, src, dst, size = pairs[i]
            run = [pairs[i]]
            i += 1
            while (i < n and len(run) < MIGRATE_BATCH
                   and pairs[i][1:] == (src, dst, size)):
                run.append(pairs[i])
                i += 1
            res = None
            if size:
                if dst not in dst_have:
                    try:
                        dst_have[dst] = set(self._node_keys(dst))
                    except Exception:  # noqa: BLE001 — per-key checks
                        dst_have[dst] = None
                res = self._copy_batch(
                    [p[0] for p in run], size, src, dst,
                    have=dst_have[dst])
                if res is not None and dst_have[dst] is not None:
                    dst_have[dst].update(p[0] for p in run)
            if res is None:
                _per_key(run)
            else:
                c, s, e, nb = res
                for _ in range(c):
                    self._c_migrated.labels("copied").inc()
                for _ in range(s):
                    self._c_migrated.labels("skipped").inc()
                _account(c, s, e, nb, True)
            since_breath += len(run)
            if since_breath >= MIGRATE_BATCH:
                since_breath = 0
                time.sleep(MIGRATE_SLEEP_S)  # breathe under live traffic

    def _migrate_join(self, ep: str, old: HashRing) -> None:
        try:
            pairs = []
            sources = 0
            for src in old.endpoints:
                try:
                    keys = self._node_keys(src)
                    sources += 1
                except Exception:  # noqa: BLE001 — a dead source's range
                    # heals lazily (its keys re-push on recompute)
                    with self._mig_lock:
                        self._migration["errors"] = (
                            self._migration.get("errors", 0) + 1)
                    continue
                for key, size in keys.items():
                    # copy exactly the new node's range: keys it now owns
                    # that lived on this (pre-join) owner
                    if (self.ring.owner(key) == ep
                            and old.owner(key) == src):
                        pairs.append((key, src, ep, size))
            with self._mig_lock:
                self._migration["sources"] = sources
                self._migration["total"] = len(pairs)
            self._migrate_pairs(pairs, ep)
        finally:
            with self._mig_lock:
                self._membership[ep] = "active"
                self._old_ring = None
                started = self._migration.get("started_at")
                self._migration.update(state="done")
                if started:
                    self._migration["wall_s"] = round(
                        time.monotonic() - started, 3)
                self._refresh_membership_gauges()

    def _migrate_drain(self, ep: str, old: HashRing) -> None:
        try:
            try:
                keys = self._node_keys(ep)
            except Exception:  # noqa: BLE001 — draining a dead node:
                # nothing to copy, its range recomputes (same outcome as
                # the crash the drain exists to avoid)
                keys = {}
                with self._mig_lock:
                    self._migration["errors"] = (
                        self._migration.get("errors", 0) + 1)
            pairs = [
                (key, ep, self.ring.owner(key), size)
                for key, size in keys.items()
                if old.owner(key) == ep
            ]
            with self._mig_lock:
                self._migration["total"] = len(pairs)
            self._migrate_pairs(pairs, ep)
        finally:
            with self._mig_lock:
                node = self._nodes.pop(ep, None)
                self._membership.pop(ep, None)
                self._old_ring = None
                started = self._migration.get("started_at")
                self._migration.update(state="done")
                if started:
                    self._migration["wall_s"] = round(
                        time.monotonic() - started, 3)
                self._g_member.labels(ep).set(0.0)
                self._refresh_membership_gauges()
            if node is not None:
                try:
                    node.conn.close()
                except Exception:  # noqa: BLE001
                    pass

    # -- routing --

    def owner(self, key: str) -> str:
        return self.ring.owner(key)

    def candidates(self, key: str) -> List[str]:
        """Read-failover / replica order for a key: owner first, then
        ring successors, ``replicas`` long.  During a membership
        transition the PRE-CHANGE owner is appended — migration reads
        ride the normal replica-failover walk, which is what keeps every
        placement correct while the background copy catches up."""
        cands = self.ring.successors(key, self.replicas)
        old = self._old_ring
        if old is not None and len(old):
            try:
                oep = old.owner(key)
            except ValueError:
                oep = None
            if oep is not None and oep not in cands and oep in self._nodes:
                cands.append(oep)
        return cands

    def write_targets(self, key: str) -> List[str]:
        """Where a chunk's pages go: the owner — plus the replica
        successors when the stem is hot or pinned (R-way fan-out)."""
        if self.replicas > 1 and self.tracker.is_hot(key):
            return self.candidates(key)
        return [self.ring.owner(key)]

    def partition(self, keys: Sequence[str]) -> "OrderedDict[str, List[int]]":
        """Group key indices by owning endpoint, order-preserving."""
        groups: "OrderedDict[str, List[int]]" = OrderedDict()
        for i, k in enumerate(keys):
            groups.setdefault(self.ring.owner(k), []).append(i)
        return groups

    def write_partition(self, keys: Sequence[str]) -> "OrderedDict[str, List[int]]":
        """Like ``partition`` but fanned out: a hot key's index appears
        in every replica target's group."""
        groups: "OrderedDict[str, List[int]]" = OrderedDict()
        for i, k in enumerate(keys):
            for ep in self.write_targets(k):
                groups.setdefault(ep, []).append(i)
        return groups

    # -- pin API (system prompts) --

    def pin(self, keys: Sequence[str]) -> int:
        """Mark chunk stems permanently hot: their writes fan out to
        every replica target from now on.  Returns newly pinned count."""
        return self.tracker.pin(keys)

    def unpin(self, keys: Sequence[str]) -> None:
        self.tracker.unpin(keys)

    # -- accounting --

    def record_outcome(self, endpoint: str, outcome: str) -> None:
        self._c_requests.labels(endpoint, outcome).inc()
        with self._counts_lock:
            k = (endpoint, outcome)
            self._req_counts[k] = self._req_counts.get(k, 0) + 1
        node = self._nodes.get(endpoint)
        if node is not None:
            self._g_state.labels(endpoint).set(node.breaker.state_code)

    def record_replica_read(self, result: str) -> None:
        self._c_replica.labels(result).inc()
        with self._counts_lock:
            self._replica_counts[result] = (
                self._replica_counts.get(result, 0) + 1
            )

    def report(self) -> dict:
        """The ``/debug/cluster`` payload: ring, per-node state, and
        the request/replica counters."""
        own = self.ring.ownership()
        with self._counts_lock:
            req = dict(self._req_counts)
            replica = dict(self._replica_counts)
        nodes = []
        # every known node renders — a DRAINING node has left the ring
        # but still serves reads, and operators must see it until the
        # migration lets it go
        eps = list(self.ring.endpoints)
        eps += [ep for ep in list(self._nodes) if ep not in eps]
        for ep in eps:
            node = self._nodes.get(ep)
            if node is None:
                continue
            state = node.breaker.state
            self._g_state.labels(ep).set(node.breaker.state_code)
            nodes.append({
                "endpoint": ep,
                "state": state,
                "membership": self._membership.get(ep, "active"),
                "connected": node.connected,
                "epoch": getattr(getattr(node.conn, "conn", None),
                                 "epoch", None),
                "ownership": round(own.get(ep, 0.0), 4),
                "requests": {
                    oc: req.get((ep, oc), 0)
                    for oc in ("ok", "error", "skipped", "miss")
                },
            })
        return {
            "enabled": True,
            "replicas": self.replicas,
            "vnodes": self.ring.vnodes,
            "nodes": nodes,
            "replica_reads": replica,
            "hot": self.tracker.snapshot(),
            "migration": self.migration_report(),
        }

    def close(self) -> None:
        self._exec.shutdown(wait=False)
        for node in self._nodes.values():
            try:
                # unpin the node's shm pool before its connection unmaps it
                if node.engine is not None:
                    node.engine.close()
                node.conn.close()
            except Exception:  # noqa: BLE001
                pass


class FleetBreaker:
    """Aggregate, read-only view over the pool's per-node breakers for
    callers that expect ONE circuit (serve /healthz, the streamer's
    skip check).  ``state``: closed when every node is closed, open
    when EVERY node is open (full-fleet outage), else ``partial`` —
    /healthz reports degraded for anything non-closed, which is true:
    some key ranges are recomputing.

    Deliberately never consumes half-open probe slots (``allow`` reads
    state only) and never records: per-node attribution happens at the
    per-node hop, where the failure actually occurred."""

    def __init__(self, pool: RoutedStorePool):
        self._pool = pool

    def _states(self) -> List[str]:
        return [n.breaker.state for n in self._pool.nodes()]

    @property
    def state(self) -> str:
        states = self._states()
        if all(s == "closed" for s in states):
            return "closed"
        if states and all(s == "open" for s in states):
            return "open"
        return "partial"

    @property
    def state_code(self) -> int:
        return {"closed": 0, "open": 1, "partial": 2}[self.state]

    def allow(self) -> bool:
        """May a cluster hop run?  Yes while ANY node might answer.
        Per-node gating (and probe consumption) happens per hop."""
        return any(s != "open" for s in self._states())

    def record_success(self) -> None:  # per-node breakers record instead
        pass

    def record_failure(self) -> None:
        pass


class ClusterTransferEngine:
    """``KVTransferEngine``'s surface over a ``RoutedStorePool``: every
    chunk routes to its ring owner, multi-endpoint batches split and
    issue concurrently, hot chunks replicate on push and fail over on
    read.  The engine, streamer, connector, and serve layer use it
    interchangeably with the single-node transfer.

    ``device``: where loaded pages land, passed to every node's
    ``KVTransferEngine`` (``None`` means the GPU and raises when there is
    none; the tests pass ``"cpu"``).

    Ordering on the card.  A push slices each write target's pages on the
    calling (compute) stream, and each node's ``push_begin`` records its
    ready event after that slice.  A load fetches each node's group on a
    worker thread, its host-to-device copies on that node's load stream;
    the group's event gates the scatter on the caller's stream, the
    stacked pages are recorded on that stream for the allocator, and the
    call returns after the caller's stream drains (every copy out of a
    node's staging slot has ended).  A node's next fetch also waits for
    its previous one's copies, so a failover walk that visits one node
    several times in a call never rewrites a staging slot in flight.

    Staging.  Before its walk, a load grows each node's staging slots to
    the largest group the walk can send that node: every chunk of the
    call whose candidate list names it.  A failover hop therefore never
    allocates page-locked memory; only a call with a new largest reach
    does, at its start."""

    def __init__(
        self,
        pool: RoutedStorePool,
        cfg,
        pipeline_groups: int = 4,
        quant: Optional[str] = None,
        push_mode: str = "auto",
        device=None,
    ):
        from . import resolve_device
        from .kv.transfer import KVTransferEngine

        self._KVTransferEngine = KVTransferEngine
        self.pool = pool
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pipeline_groups = pipeline_groups
        self.quant = quant
        self.push_mode = push_mode
        self.breaker = FleetBreaker(pool)
        # per endpoint: the load stream its uploads run on and the event
        # after its last fetch's uploads (on the card only)
        self._load_streams: Dict[str, object] = {}
        self._upload_done: Dict[str, object] = {}
        # template engine for endpoint-independent halves (device-side
        # gather, key layout, scatter): same cfg/quant as every node
        self._tpl = self._engine(pool.endpoints[0])
        self.wire_page_bytes = self._tpl.wire_page_bytes
        self._key_suffix = self._tpl._key_suffix
        self.last_push_stages: dict = {}
        self.last_load_stages: dict = {}
        self.last_lookup_stages: dict = {}

    # -- per-node plumbing --

    def _engine(self, endpoint: str):
        node = self.pool.node(endpoint)
        eng = node.engine
        if eng is None or eng._src is not node.conn:
            # (re)bind: a node whose wrapper was replaced after a failed
            # bootstrap needs a fresh transfer engine over the new conn
            if eng is not None:
                eng.close()
            eng = self._KVTransferEngine(
                node.conn, self.cfg, pipeline_groups=self.pipeline_groups,
                quant=self.quant, breaker=node.breaker,
                push_mode=self.push_mode, device=self.device,
            )
            node.engine = eng
        return eng

    def _map_nodes(self, items, fn):
        """Run ``fn(item)`` for every item — concurrently when there is
        more than one (the split-batch issue path).  The calling
        thread's bound account is re-bound inside each worker:
        contextvars do not propagate into the pool's executor threads,
        and losing the binding there would strip usage attribution from
        every multi-node push/load."""
        items = list(items)
        if len(items) <= 1:
            return [fn(it) for it in items]
        from .usage import bind_account, current_account

        acct = current_account()
        if acct is not None:
            inner = fn

            def fn(it):  # noqa: F811 — deliberate rebind-wrapping
                with bind_account(acct):
                    return inner(it)
        return list(self.pool._exec.map(fn, items))

    def trace_srcs(self) -> list:
        """Every connected node's public connection — serve's
        /debug/traces stitches all of their server-side span rings."""
        return [n.conn for n in self.pool.nodes() if n.connected]

    @property
    def _src(self):
        """Single-conn compatibility probe (trace stitching falls back
        here): the first connected node."""
        srcs = self.trace_srcs()
        return srcs[0] if srcs else self.pool.nodes()[0].conn

    def cluster_report(self) -> dict:
        return self.pool.report()

    def pinned_bytes(self) -> Dict[str, int]:
        """Host bytes the node engines hold page-locked: ``pools``, the shm
        pool mappings they registered (once per mapping), and ``staging``,
        their pinned staging slots (each node's load double buffer and
        push ring; pinned on the card only)."""
        out = {"pools": 0, "staging": 0}
        for node in list(self.pool._nodes.values()):
            eng = node.engine
            if eng is None:
                continue
            out["pools"] += sum(eng._pinned.values())
            out["staging"] += sum(
                t.numel() for t in eng._staging + eng._push_staging
                if t is not None and t.is_pinned())
        return out

    def close(self) -> None:
        """Unpin every node's pool mapping.  Call before closing the pool
        (its close unmaps them; ``RoutedStorePool.close`` unpins too)."""
        for node in list(self.pool._nodes.values()):
            if node.engine is not None:
                node.engine.close()

    def pin_prefix(self, chunk_keys_: Sequence[str]) -> int:
        """Pin chunk stems hot (the system-prompt API): their pages
        replicate to every ring successor on the next push."""
        return self.pool.pin(chunk_keys_)

    def _call(self, name: str, *args):
        """Metadata fan-out for connector parity.  Only ``delete_keys``
        is meaningful cluster-wide (content-addressed keys may live on
        any node — owner, replica, or a pre-rebalance owner); routed
        ops go through push/load/lookup."""
        if name != "delete_keys":
            raise NotImplementedError(
                f"cluster transfer routes {name!r} per-chunk; only "
                f"delete_keys fans out"
            )
        (keys,) = args
        total = 0
        for node in self.pool.nodes():
            if not node.connected or not node.breaker.allow():
                continue
            try:
                total += self._engine(node.endpoint)._call("delete_keys", keys)
                node.breaker.record_success()
            except _resilience.transport_errors():
                node.breaker.record_failure()
                self.pool.record_outcome(node.endpoint, "error")
        return total

    def _page_keys(self, chunk_keys_: Sequence[str]) -> List[str]:
        return self._tpl._page_keys(chunk_keys_)

    # -- device-side halves (endpoint-independent) --

    @property
    def tp_pages(self):
        """A tensor-parallel engine's page hook (``KVTransferEngine.
        tp_pages``), held by the template engine that gathers and
        scatters for every node."""
        return self._tpl.tp_pages

    @tp_pages.setter
    def tp_pages(self, hook) -> None:
        self._tpl.tp_pages = hook

    def gather_pages(self, cache, block_ids):
        return self._tpl.gather_pages(cache, block_ids)

    # -- push: route per chunk, fan out hot stems, commit concurrently --

    def push_begin(self, pages, chunk_keys_: Sequence[str]):
        """Critical-path half: group chunks by write target (owner +
        replicas for hot stems), slice the gathered pages per target
        along the chunk axis (on the calling stream; each node's
        ``push_begin`` records its ready event after the slice).
        Returns the token ``push_commit`` consumes off-thread."""
        import torch

        chunk_keys_ = list(chunk_keys_)
        groups = self.pool.write_partition(chunk_keys_)
        token = []
        for ep, idxs in groups.items():
            sub_keys = [chunk_keys_[i] for i in idxs]
            if len(idxs) == len(chunk_keys_):
                sub_pages = pages
            else:
                sub_pages = pages.index_select(
                    1, torch.tensor(idxs, dtype=torch.long).to(pages.device)
                )
            token.append(
                (ep, self._engine(ep).push_begin(sub_pages, sub_keys),
                 len(idxs))
            )
        return token

    def push_commit(self, token) -> int:
        """Off-critical-path half: commit every group on its node,
        concurrently.  A failing node costs ONLY its own chunks
        (counted drops, its breaker fed); the push raises only when
        every attempted node failed — the full-fleet outage the
        streamer's parked-error path exists for.  ``last_push_stages``
        adds ``node_bytes``, the bytes each node took."""
        stages = {"d2h_s": 0.0, "pool_copy_s": 0.0, "wire_s": 0.0,
                  "alloc_s": 0.0, "commit_s": 0.0,
                  "zero_copy_bands": 0, "staged_bands": 0}
        results = self._map_nodes(token, self._commit_one)
        total = 0
        attempted = 0
        errors = []
        node_bytes: Dict[str, int] = {}
        for (ep, _tok, _n), (written, err, node_stages) in zip(token,
                                                                results):
            total += written
            node_bytes[ep] = node_bytes.get(ep, 0) + written
            if err is not None:
                errors.append(err)
            if err is not None or written:
                attempted += 1
            for k, v in (node_stages or {}).items():
                if k in stages:
                    stages[k] += v
        stages["nodes"] = len(token)
        stages["failed_nodes"] = len(errors)
        stages["node_bytes"] = node_bytes
        self.last_push_stages = stages
        if errors and attempted and total == 0:
            raise errors[0]
        return total

    def _commit_one(self, entry):
        ep, node_token, n_chunks = entry
        node = self.pool.node_or_none(ep)
        if node is None:  # drained between begin and commit
            _resilience.count_push_dropped("circuit_open", n_chunks)
            return 0, None, None
        if not node.breaker.allow():
            self.pool.record_outcome(ep, "skipped")
            _resilience.count_push_dropped("circuit_open", n_chunks)
            return 0, None, None
        try:
            with node.lock:
                node.ensure_connected()
                eng = self._engine(ep)
                written = eng.push_commit(node_token)
                node_stages = dict(eng.last_push_stages)
        except _resilience.transport_errors() as e:
            node.breaker.record_failure()
            self.pool.record_outcome(ep, "error")
            _resilience.count_push_dropped("push_error", n_chunks)
            return 0, e, None
        except Exception as e:  # noqa: BLE001 — a node-local fault
            self.pool.record_outcome(ep, "error")
            _resilience.count_push_dropped("push_error", n_chunks)
            return 0, e, None
        node.breaker.record_success()
        self.pool.record_outcome(ep, "ok")
        return written, None, node_stages

    def push_pages(self, pages, chunk_keys_: Sequence[str]) -> int:
        return self.push_commit(self.push_begin(pages, chunk_keys_))

    def save_pages(self, cache, block_ids, chunk_keys_) -> int:
        if len(block_ids) != len(chunk_keys_):
            raise ValueError(f"{len(block_ids)} block ids for "
                             f"{len(chunk_keys_)} chunk keys")
        if len(block_ids) == 0:
            return 0
        return self.push_pages(
            self.gather_pages(cache, block_ids), chunk_keys_
        )

    # -- load: route per chunk, fail over replica -> replica --

    def load_pages(self, cache, block_ids, chunk_keys_):
        """Sharded load: each chunk fetched from its owner (all
        endpoint groups concurrently), failing over along the ring
        successors before a miss; the scatter into the cache happens
        after every group's bytes verified.  All-or-nothing like the
        single-node path: any unservable chunk raises KeyNotFound and
        the cache is returned untouched by the guarded wrapper."""
        import torch

        from .lib import InfiniStoreKeyNotFound

        if len(block_ids) != len(chunk_keys_):
            raise ValueError(f"{len(block_ids)} block ids for "
                             f"{len(chunk_keys_)} chunk keys")
        n = len(block_ids)
        if n == 0:
            return cache
        t0 = time.perf_counter()
        chunk_keys_ = list(chunk_keys_)
        candidates = [self.pool.candidates(k) for k in chunk_keys_]
        grown = self._size_staging(candidates)
        fetched: List[Tuple[str, List[int], object, object]] = []
        walk: List[list] = []  # [endpoint, depth, chunks, seconds, ok]
        pending = list(range(n))
        last_exc: Optional[Exception] = None
        # candidate lists run one PAST the replica count while a
        # membership transition is live (the old-ring owner rides the
        # failover walk), so the walk is depth-bounded by the lists
        max_depth = max((len(c) for c in candidates), default=0)
        for depth in range(max_depth):
            if not pending:
                break
            groups: "OrderedDict[str, List[int]]" = OrderedDict()
            exhausted: List[int] = []
            for i in pending:
                if depth < len(candidates[i]):
                    groups.setdefault(candidates[i][depth], []).append(i)
                else:
                    exhausted.append(i)
            def fetch(kv):
                t = time.perf_counter()
                out = self._fetch_group(kv[0], kv[1], chunk_keys_, depth)
                return out, time.perf_counter() - t

            results = self._map_nodes(groups.items(), fetch)
            pending = list(exhausted)
            for (ep, idxs), ((stacked, done, err), dt) in zip(
                    groups.items(), results):
                walk.append([ep, depth, len(idxs), round(dt, 6),
                             stacked is not None])
                if stacked is not None:
                    fetched.append((ep, idxs, stacked, done))
                else:
                    last_exc = err or last_exc
                    pending.extend(idxs)
        if pending:
            if max_depth > 1:
                self.pool.record_replica_read("miss")
            raise (last_exc if isinstance(last_exc, InfiniStoreKeyNotFound)
                   else InfiniStoreKeyNotFound(
                       f"cluster: {len(pending)}/{n} chunks unservable "
                       f"across {max_depth} candidates "
                       f"({last_exc!r})"))
        t1 = time.perf_counter()
        stream = (torch.cuda.current_stream(cache.device)
                  if cache.is_cuda else None)
        for _ep, idxs, stacked, done in fetched:
            if stream is not None:
                # the group's uploads ran on its node's load stream
                stream.wait_event(done)
                stacked.record_stream(stream)
            cache = self._tpl.scatter_pages(
                cache, [block_ids[i] for i in idxs], stacked
            )
        if stream is not None:
            # the counterpart of the reference's block_until_ready: every
            # upload and scatter has ended, so no staging slot is live
            stream.synchronize()
        t2 = time.perf_counter()
        self.last_load_stages = {
            "fetch_s": round(t1 - t0, 6), "scatter_s": round(t2 - t1, 6),
            "pages": self.cfg.n_layers * n,
            "bytes": self.cfg.n_layers * n * self.wire_page_bytes,
            "nodes": len({ep for ep, *_ in fetched}),
            "groups": len(fetched),
            "staging_grown": grown,
            "walk": walk,
        }
        return cache

    def _size_staging(self, candidates: List[List[str]]) -> int:
        """Grow each candidate node's staging slots to the bytes of every
        chunk whose candidate list names it: the most any failover walk
        of this call can send the node.  Returns the slots allocated."""
        reach: Dict[str, int] = {}
        for cands in candidates:
            for ep in cands:
                reach[ep] = reach.get(ep, 0) + 1
        grown = 0
        for ep, k in reach.items():
            node = self.pool.node_or_none(ep)
            if (node is None or not node.connected
                    or node.breaker.state == "open"):
                continue  # the walk skips it
            with node.lock:
                eng = self._engine(ep)
                before = [id(t) for t in eng._staging]
                eng._grow(eng._staging,
                          self.cfg.n_layers * k * self.wire_page_bytes)
                grown += sum(a != id(t)
                             for a, t in zip(before, eng._staging))
        return grown

    def _load_stream(self, ep: str):
        import torch

        s = self._load_streams.get(ep)
        if s is None:
            s = self._load_streams[ep] = torch.cuda.Stream(
                device=self.device)
        return s

    def _fetch_on_card(self, ep: str, sub: List[str]):
        """One node's ``fetch_pages`` with its uploads on the node's load
        stream, after its previous fetch's uploads ended (a staging slot
        is never rewritten while a copy out of it runs).  Returns the
        stacked pages and the event after their uploads."""
        import torch

        prev = self._upload_done.pop(ep, None)
        if prev is not None:
            prev.synchronize()
        stream = self._load_stream(ep)
        done = torch.cuda.Event()
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                stacked = self._engine(ep).fetch_pages(sub)
        finally:
            # recorded on failure too: a group that failed mid-fetch may
            # have uploads in flight out of its staging slot
            done.record(stream)
            self._upload_done[ep] = done
        return stacked, done

    def _fetch_group(self, ep: str, idxs: List[int],
                     chunk_keys_: Sequence[str], depth: int):
        """One node's fetch attempt for one group.  Returns ``(stacked,
        done, None)`` on success (``done``: the event after its uploads on
        the card, else None), ``(None, None, err)`` to send the group to
        the next ring successor."""
        from .lib import (
            InfiniStoreIntegrityError,
            InfiniStoreKeyNotFound,
        )

        sub = [chunk_keys_[i] for i in idxs]
        node = self.pool.node_or_none(ep)
        if node is None:  # drained away mid-walk: treat as failed hop
            return None, None, None
        if not node.breaker.allow():
            self.pool.record_outcome(ep, "skipped")
            return None, None, None
        done = None
        try:
            with node.lock:
                node.ensure_connected()
                if self.device.type == "cuda":
                    stacked, done = self._fetch_on_card(ep, sub)
                else:
                    stacked = self._engine(ep).fetch_pages(sub)
        except InfiniStoreKeyNotFound as e:
            # healthy protocol miss: the transport answered
            node.breaker.record_success()
            self.pool.record_outcome(ep, "miss")
            return None, None, e
        except InfiniStoreIntegrityError as e:
            # bad bytes on THIS node (checksum / epoch fence): hand the
            # failed pages back for quarantine and try a replica — the
            # transport is healthy, the circuit is untouched
            if e.keys:
                try:
                    self._engine(ep)._call("delete_keys", list(e.keys))
                except Exception:  # noqa: BLE001 — best-effort hygiene
                    pass
            self.pool.record_outcome(ep, "error")
            return None, None, e
        except _resilience.transport_errors() as e:
            node.breaker.record_failure()
            self.pool.record_outcome(ep, "error")
            return None, None, e
        node.breaker.record_success()
        self.pool.record_outcome(ep, "ok")
        if depth > 0:
            self.pool.record_replica_read("hit")
        return stacked, done, None

    # -- lookup: per-node longest-match, merged --

    def lookup_prefix(self, chunk_keys_: Sequence[str]) -> int:
        """Longest store-resident prefix across the fleet: each node
        answers ``get_match_last_index`` over ITS owned subsequence
        (order within a node preserves the global order, so its answer
        is a prefix property there too), merged into the longest global
        prefix where every chunk's owner — or, when the owner is dead,
        a ring successor — has the chunk.  An authoritative miss does
        NOT fail over (a missing chunk re-pushes on recompute; lazy
        rebalance makes that the heal path); node FAILURE does."""
        if not chunk_keys_:
            return 0
        from .kv.hashing import layer_key

        chunk_keys_ = list(chunk_keys_)
        self.pool.tracker.record_many(chunk_keys_)
        n = len(chunk_keys_)
        sfx = self._key_suffix
        avail = [False] * n
        served: List[Optional[str]] = [None] * n
        candidates = [self.pool.candidates(k) for k in chunk_keys_]
        pending = list(range(n))
        max_depth = max((len(c) for c in candidates), default=0)
        t0 = time.perf_counter()
        walk: List[list] = []  # [endpoint, depth, chunks, seconds, matched]
        for depth in range(max_depth):
            if not pending:
                break
            groups: "OrderedDict[str, List[int]]" = OrderedDict()
            exhausted: List[int] = []
            for i in pending:
                if depth < len(candidates[i]):
                    groups.setdefault(candidates[i][depth], []).append(i)
                else:
                    exhausted.append(i)

            def probe(kv):
                t = time.perf_counter()
                out = self._probe_group(kv[0], kv[1], chunk_keys_, sfx)
                return out, time.perf_counter() - t

            results = self._map_nodes(groups.items(), probe)
            pending = list(exhausted)
            for (ep, idxs), (matched, dt) in zip(groups.items(), results):
                walk.append([ep, depth, len(idxs), round(dt, 6), matched])
                if matched is None:  # node failure: next successor
                    pending.extend(idxs)
                    continue
                for j in range(matched):
                    avail[idxs[j]] = True
                    served[idxs[j]] = ep
        del served  # per-node probes verified their own tails
        p = 0
        while p < n and avail[p]:
            p += 1
        self.last_lookup_stages = {"s": round(time.perf_counter() - t0, 6),
                                   "walk": walk}
        return p

    def _probe_group(self, ep: str, idxs: List[int],
                     chunk_keys_: Sequence[str], sfx: str):
        """One node's longest-match probe over its owned subsequence.
        Returns the matched chunk count, or None on node failure (the
        caller walks the group to the next ring successor)."""
        from .kv.hashing import layer_key

        node = self.pool.node_or_none(ep)
        if node is None:  # drained away mid-walk: treat as failed hop
            return None
        if not node.breaker.allow():
            self.pool.record_outcome(ep, "skipped")
            return None
        probe = [layer_key(chunk_keys_[i], 0) + sfx for i in idxs]
        try:
            node.ensure_connected()
            eng = self._engine(ep)
            idx = eng._call("get_match_last_index", probe)
            # trust-but-verify like the single-node path: a chunk is
            # only readable if its LAST layer committed (layer 0 lands
            # first, so the match's tail must hold the whole chunk)
            while idx >= 0:
                last = layer_key(
                    chunk_keys_[idxs[idx]], self.cfg.n_layers - 1) + sfx
                if eng._call("check_exist", last) == 0:
                    break
                idx -= 1
        except _resilience.transport_errors():
            node.breaker.record_failure()
            self.pool.record_outcome(ep, "error")
            return None
        except Exception:  # noqa: BLE001 — a lookup is an optimization
            self.pool.record_outcome(ep, "error")
            return None
        node.breaker.record_success()
        self.pool.record_outcome(ep, "ok")
        return idx + 1

    # -- breaker-guarded hops (the degraded-serving contract, fleet
    #    edition: per-node breakers fed at the hop, aggregate gate
    #    here) --

    def guarded_lookup_prefix(self, chunk_keys_: Sequence[str]) -> int:
        if not self.breaker.allow():
            _resilience.count_degraded("lookup")
            return 0
        try:
            return self.lookup_prefix(chunk_keys_)
        except Exception:  # noqa: BLE001 — a lookup is an optimization
            _resilience.count_degraded("lookup")
            return 0

    def guarded_load(self, cache, block_ids, chunk_keys_):
        if not self.breaker.allow():
            _resilience.count_degraded("load")
            return cache, False
        from .lib import InfiniStoreIntegrityError, InfiniStoreKeyNotFound

        try:
            out = self.load_pages(cache, block_ids, chunk_keys_)
        except (InfiniStoreKeyNotFound, InfiniStoreIntegrityError):
            _resilience.count_degraded("load")
            return cache, False
        except _resilience.transport_errors():
            _resilience.count_degraded("load")
            return cache, False
        return out, True


def transfer_for(conn, cfg, quant: Optional[str] = None, breaker=None,
                 device=None):
    """The transfer engine over ``conn``: a ``ClusterTransferEngine`` for a
    ``RoutedStorePool`` (per-node breakers; ``breaker`` is not used), else
    one ``KVTransferEngine``.  ``device`` as both engines take it."""
    if isinstance(conn, RoutedStorePool):
        return ClusterTransferEngine(conn, cfg, quant=quant, device=device)
    from .kv.transfer import KVTransferEngine

    return KVTransferEngine(conn, cfg, quant=quant, breaker=breaker,
                            device=device)
