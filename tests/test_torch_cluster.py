"""The store cluster against the reference, on the CPU (TINY model, f32).

The port's ``cluster.py`` is held three ways:

* the reference's pure cases of ``tests/test_cluster.py`` (ring math,
  endpoint parsing, the hot tracker, the ``top`` cluster view) run
  unchanged against the port: the file is compiled with its
  ``infinistore_tpu`` module names pointed at the port
  (``against_the_port``), so each case's inputs and assertions are the
  reference's, character for character;
* the ring agrees with the reference's on every owner and successor list:
  a JAX and a torch client sharing one store fleet route every chunk stem
  to the same node;
* the live cases drive three of the port's store servers through the
  port's ``RoutedStorePool`` and ``ClusterTransferEngine(device="cpu")``,
  the port's ``InferenceEngine`` and ``ServingServer`` (greedy tokens
  against the reference's dense greedy), and a prompt handed across
  frameworks over the ring in both directions.

``against_the_port`` and ``collect`` are shared with the other port files
of the cluster slice (membership, reshape, top).
"""

import json
import pathlib
import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).parent

# the port's copies of the reference's jax-free modules: a test file's
# imports of them (and its ``python -m`` commands of the CLIs) are pointed
# at the port; every other name (the reference's engine, models, serve)
# stays as it is
_MODULES = (r"(?:cluster|top|doctor|benchmark|lib|config|pyserver|store"
            r"|server|utils|loadgen|health|engine\.engine)")
_NAME = re.compile(r"\binfinistore_tpu\.(%s)\b" % _MODULES)


def port_source(filename: str):
    """The reference test file's source with its names of the ported
    modules pointed at the port, and how many were rewritten."""
    return _NAME.subn(r"infinistore_tpu_torch.\1",
                      (HERE / filename).read_text())


def against_the_port(filename: str) -> types.ModuleType:
    path = HERE / filename
    mod = types.ModuleType(f"port_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(port_source(filename)[0], str(path), "exec"), mod.__dict__)
    return mod


def collect(cases: dict, fixtures: dict = None) -> dict:
    """``{reference file: [case, ...]}`` -> the cases (as
    ``test_<file>__<case>``), compiled against the port, and the fixtures
    named per file in ``fixtures``."""
    found = {}
    for filename, names in cases.items():
        mod = against_the_port(filename)
        stem = pathlib.Path(filename).stem[5:]
        for name in names:
            found[f"test_{stem}__{name[5:]}"] = getattr(mod, name)
        for name in (fixtures or {}).get(filename, ()):
            found[name] = getattr(mod, name)
    return found


CASES = {
    "test_cluster.py": [
        "test_ring_deterministic_across_processes",
        "test_ring_ownership_spread",
        "test_ring_minimal_movement_on_add_and_remove",
        "test_ring_replica_successors_distinct_and_stable",
        "test_route_stem_colocates_layers",
        "test_parse_endpoints",
        "test_client_config_endpoints_template",
        "test_hot_tracker_threshold_and_pin",
        "test_console_cluster_view",
    ],
}

globals().update(collect(CASES))


def test_cases_run_against_the_ports_modules():
    """Every chosen case exists in its reference file, and no name of a
    ported module is left pointing at the reference."""
    for filename, names in CASES.items():
        src, n = port_source(filename)
        assert n > 0 and not _NAME.search(src), filename
        mod = against_the_port(filename)
        assert mod.RoutedStorePool.__module__ == "infinistore_tpu_torch.cluster"
        assert all(callable(getattr(mod, name)) for name in names)


# ---- the ring is a contract between frameworks ----

from conftest import make_dense_greedy  # noqa: E402
from infinistore_tpu import cluster as ref_cluster  # noqa: E402
from infinistore_tpu.engine import InferenceEngine as JEngine  # noqa: E402
from infinistore_tpu.kv import PagedCacheConfig as JPC  # noqa: E402
from infinistore_tpu.kv import chunk_keys  # noqa: E402
from infinistore_tpu.kv import read_pages as j_read_pages  # noqa: E402
from infinistore_tpu.models import TINY, init_params, scaled  # noqa: E402
from infinistore_tpu_torch import cluster  # noqa: E402
from infinistore_tpu_torch import lib as tlib  # noqa: E402
from infinistore_tpu_torch.cluster import (  # noqa: E402
    DEFAULT_REPLICAS,
    ClusterTransferEngine,
    HashRing,
    RoutedStorePool,
)
from infinistore_tpu_torch.engine import InferenceEngine  # noqa: E402
from infinistore_tpu_torch.kv import KVTransferEngine  # noqa: E402
from infinistore_tpu_torch.kv import PagedCacheConfig, init_cache  # noqa: E402
from infinistore_tpu_torch.kv import quantize_pages, read_pages  # noqa: E402
from infinistore_tpu_torch.models import TINY as TTINY  # noqa: E402
from infinistore_tpu_torch.models import params_from_jax  # noqa: E402
from infinistore_tpu_torch.models import scaled as tscaled  # noqa: E402
from infinistore_tpu_torch.serve import ServingServer  # noqa: E402
from infinistore_tpu_torch.utils import metrics as m  # noqa: E402

torch.set_num_threads(2)

EPS = [f"10.0.0.{i}:5000" for i in range(1, 9)]


@pytest.mark.parametrize("n", range(3, 9))
def test_ring_agrees_with_the_reference(n):
    """For 3-8 endpoints and 1000 chunk keys (their stems and every layer
    key, full precision and int8), the port's ring names the same owner
    and the same successor lists as the reference's, and the same
    ownership arcs; so do the pools' read candidates and write targets."""
    eps = EPS[:n]
    keys = chunk_keys(list(range(1000 * 4)), "ring-agree", chunk_tokens=4)
    assert len(keys) == 1000
    port, ref = HashRing(eps), ref_cluster.HashRing(eps)
    assert port.ownership() == ref.ownership()
    for k in keys:
        for key in (k, f"{k}#L0", f"{k}#L31:q8"):
            assert cluster.ring_hash(key) == ref_cluster.ring_hash(key)
            assert cluster.route_stem(key) == ref_cluster.route_stem(key)
            assert port.owner(key) == ref.owner(key), key
        for r in range(1, n + 1):
            assert port.successors(k, r) == ref.successors(k, r), (k, r)

    class _Idle:
        def connect(self):
            pass

        def close(self):
            pass

    pools = [mod.RoutedStorePool(eps, conn_factory=lambda ep: _Idle(),
                                 connect=False, replicas=2)
             for mod in (cluster, ref_cluster)]
    try:
        for p in pools:
            p.pin(keys[:100])
        for k in keys:
            assert pools[0].candidates(k) == pools[1].candidates(k)
            assert pools[0].write_targets(k) == pools[1].write_targets(k)
        assert pools[0].write_partition(keys) == pools[1].write_partition(keys)
    finally:
        for p in pools:
            p.close()


# ---- live cluster: three of the port's store nodes ----

# the reference file's fleet helpers, its ``python -m`` pointed at the
# port's server (``--backend python``)
_ref_live = against_the_port("test_cluster.py")
_Fleet = _ref_live._Fleet
_post, _get = _ref_live._post, _ref_live._get

CFG = scaled(TINY, dtype=jnp.float32)
TCFG = tscaled(TTINY, dtype=torch.float32)
PARAMS = init_params(CFG, jax.random.PRNGKey(7))
TPARAMS = params_from_jax(jax.tree.map(np.asarray, PARAMS), TCFG, "cpu")
T = 4
PROMPT = [11, 42, 7, 99, 5, 3, 17, 28, 64, 1, 2]

dense_greedy = make_dense_greedy(PARAMS, CFG)


def make_pc(n_blocks=64):
    return PagedCacheConfig(
        n_layers=TCFG.n_layers, n_kv_heads=TCFG.n_kv_heads,
        head_dim=TCFG.head_dim, n_blocks=n_blocks, block_tokens=T,
        dtype=torch.float32,
    )


def small_pc():
    return PagedCacheConfig(
        n_layers=4, n_kv_heads=2, head_dim=8, n_blocks=32,
        block_tokens=4, dtype=torch.float32,
    )


def _random_cache(pc, seed):
    shape = tuple(init_cache(pc, "cpu").shape)
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape)
        .astype(np.float32))


@pytest.fixture(scope="module")
def fleet():
    f = _Fleet()
    yield f
    f.stop()


def _pool(fleet, **kw):
    kw.setdefault("op_timeout_s", 5.0)
    return RoutedStorePool(fleet.endpoints, **kw)


def test_cluster_routes_push_load_lookup(fleet):
    """Pages land on their ring owners, a sharded lookup answers the
    longest global prefix, and a sharded load is byte-exact."""
    pool = _pool(fleet)
    pc = small_pc()
    eng = ClusterTransferEngine(pool, pc, device="cpu")
    cache = _random_cache(pc, 0)
    keys = [f"route:chunk{i}" for i in range(8)]
    ids = list(range(8))
    assert eng.save_pages(cache, ids, keys) == 8 * pc.n_layers * pc.page_bytes
    # batches split across >1 endpoint (8 stems over 3 nodes)
    parts = pool.partition(keys)
    assert len(parts) >= 2
    assert eng.last_push_stages["nodes"] == len(parts)
    assert sum(eng.last_push_stages["node_bytes"].values()) == \
        8 * pc.n_layers * pc.page_bytes
    # every page key exists on its owner — and the routing is exhaustive
    for k in keys:
        owner = pool.ring.owner(k)
        node_eng = eng._engine(owner)
        for layer in range(pc.n_layers):
            assert node_eng._call("check_exist", f"{k}#L{layer}") == 0
    assert eng.lookup_prefix(keys) == 8
    # evicting a tail of the sequence cuts the global prefix at the
    # shard level: delete chunks 3..7 on their respective owners
    for k in keys[3:]:
        page_keys = [f"{k}#L{layer}" for layer in range(pc.n_layers)]
        eng._engine(pool.ring.owner(k))._call("delete_keys", page_keys)
    assert eng.lookup_prefix(keys) == 3
    fresh = init_cache(pc, "cpu")
    out, ok = eng.guarded_load(fresh, ids[:3], keys[:3])
    assert ok
    assert torch.equal(out[:, :, :, :3], cache[:, :, :, :3])
    pool.close()


def test_hot_prefix_replication_and_failover(fleet):
    """Pinned stems fan out to every ring successor on push; killing
    the owner mid-fleet leaves reads served by the replica (counted in
    istpu_cluster_replica_reads_total{result="hit"}), and only the dead
    node's circuit accumulates failures."""
    pool = _pool(fleet, replicas=2)
    pc = small_pc()
    eng = ClusterTransferEngine(pool, pc, device="cpu")
    cache = _random_cache(pc, 1)
    keys = [f"hotrep:chunk{i}" for i in range(4)]
    pool.pin(keys)
    eng.save_pages(cache, list(range(4)), keys)
    # every chunk's pages exist on BOTH candidates
    for k in keys:
        cands = pool.candidates(k)
        assert len(cands) == 2
        for ep in cands:
            assert eng._engine(ep)._call("check_exist", f"{k}#L0") == 0
    # kill the owner of keys[0]; its replica must serve the read
    victim = pool.ring.owner(keys[0])
    vi = fleet.endpoints.index(victim)
    fleet.kill(vi)
    served = [k for k in keys if pool.ring.owner(k) == victim]
    assert served, "expected at least one chunk owned by the victim"
    fresh = init_cache(pc, "cpu")
    out, ok = eng.guarded_load(fresh, list(range(4)), keys)
    assert ok, "replica failover must serve pinned chunks"
    assert torch.equal(out[:, :, :, :4], cache[:, :, :, :4])
    rep = pool.report()
    assert rep["replica_reads"].get("hit", 0) >= 1, rep["replica_reads"]
    by_ep = {n["endpoint"]: n for n in rep["nodes"]}
    assert by_ep[victim]["requests"]["error"] >= 1
    for ep in fleet.endpoints:
        if ep != victim:
            assert by_ep[ep]["requests"]["error"] == 0, by_ep[ep]
    # prometheus families carry the same story
    text = m.default_registry().to_prometheus_text()
    parsed = m.parse_prometheus_text(text)
    assert parsed.get(("istpu_cluster_replica_reads_total",
                       (("result", "hit"),)), 0) >= 1
    assert ("istpu_cluster_node_state",
            (("endpoint", victim),)) in parsed
    pool.close()
    fleet.restart(vi)


def test_native_clients_fail_over_to_replicas(fleet, monkeypatch):
    """The same failover over the port's native clients: a dead node's
    refused reconnect raises ``InfiniStoreConnectionError`` (a transport
    error, as the Python client's refused connect is), so its breaker is
    fed and its chunks are read from their replicas.  The reference's
    native client raises a bare ``InfiniStoreException`` there, which no
    failover catches (``ROADMAP.md`` queue 3)."""
    monkeypatch.setenv("ISTPU_CLIENT", "native")

    def native_conn(ep):
        host, _, port = ep.rpartition(":")
        return tlib.InfinityConnection(tlib.ClientConfig(
            host_addr=host, service_port=int(port),
            connection_type=tlib.TYPE_SHM, log_level="warning"))

    pool = RoutedStorePool(fleet.endpoints, replicas=2,
                           conn_factory=native_conn)
    pc = small_pc()
    eng = ClusterTransferEngine(pool, pc, device="cpu")
    assert {type(n.conn.conn).__name__ for n in pool.nodes()} == {
        "NativeConnection"}
    cache = _random_cache(pc, 2)
    keys = [f"native-fail:chunk{i}" for i in range(12)]
    pool.pin(keys)
    eng.save_pages(cache, list(range(12)), keys)
    owners = [pool.ring.owner(k) for k in keys]
    victim = max(fleet.endpoints, key=owners.count)
    vi = fleet.endpoints.index(victim)
    fleet.kill(vi)
    try:
        assert eng.guarded_lookup_prefix(keys) == 12
        out, ok = eng.guarded_load(init_cache(pc, "cpu"), list(range(12)),
                                   keys)
        assert ok
        assert torch.equal(out[:, :, :, :12], cache[:, :, :, :12])
        rep = pool.report()
        assert rep["replica_reads"]["hit"] >= 1
        by_ep = {n["endpoint"]: n for n in rep["nodes"]}
        assert by_ep[victim]["requests"]["error"] >= 1
        assert all(by_ep[ep]["requests"]["error"] == 0
                   for ep in fleet.endpoints if ep != victim)
    finally:
        pool.close()
        fleet.restart(vi)


def test_failover_never_grows_staging_inside_the_walk(fleet):
    """A load sizes each node's staging slots, before its walk, to every
    chunk whose candidate list names the node; after a node dies, the
    survivors take its chunks in slots they already hold, and the lookup
    walk records the dead node's failed probe."""
    pool = _pool(fleet, replicas=2)
    pc = small_pc()
    eng = ClusterTransferEngine(pool, pc, device="cpu")
    cache = _random_cache(pc, 3)
    keys = [f"staging:chunk{i}" for i in range(12)]
    ids = list(range(12))
    pool.pin(keys)
    eng.save_pages(cache, ids, keys)
    reach = {ep: sum(ep in pool.candidates(k) for k in keys)
             for ep in fleet.endpoints}
    out, ok = eng.guarded_load(init_cache(pc, "cpu"), ids, keys)
    assert ok and torch.equal(out[:, :, :, :12], cache[:, :, :, :12])
    assert eng.last_load_stages["staging_grown"] == 2 * len(reach)
    slots = {}
    for ep, k in reach.items():
        staging = eng._engine(ep)._staging
        assert [t.numel() for t in staging] == [
            pc.n_layers * k * pc.page_bytes] * 2
        slots[ep] = [t.data_ptr() for t in staging]
    owners = [pool.ring.owner(k) for k in keys]
    victim = max(fleet.endpoints, key=owners.count)
    vi = fleet.endpoints.index(victim)
    fleet.kill(vi)
    try:
        assert eng.guarded_lookup_prefix(keys) == 12
        walk = eng.last_lookup_stages["walk"]
        assert [victim, 0, owners.count(victim)] == [
            w[:3] for w in walk if w[0] == victim][0]
        assert [w[4] for w in walk if w[0] == victim] == [None]
        out, ok = eng.guarded_load(init_cache(pc, "cpu"), ids, keys)
        assert ok and torch.equal(out[:, :, :, :12], cache[:, :, :, :12])
        stages = eng.last_load_stages
        assert stages["staging_grown"] == 0
        assert any(depth == 1 and good for _ep, depth, _n, _s, good
                   in stages["walk"])
        for ep in fleet.endpoints:
            if ep != victim:
                assert [t.data_ptr() for t in eng._engine(ep)._staging] \
                    == slots[ep]
    finally:
        pool.close()
        fleet.restart(vi)


def test_single_endpoint_keeps_single_connection_path(fleet):
    """One endpoint is NOT a cluster: the engine keeps the classic
    KVTransferEngine over a plain connection (no ring, no routing
    layer), and a RoutedStorePool engine is only built for fleets."""
    conn = tlib.InfinityConnection(tlib.ClientConfig(
        host_addr="127.0.0.1",
        service_port=int(fleet.endpoints[0].rsplit(":", 1)[1]),
        connection_type=tlib.TYPE_SHM, op_timeout_s=5.0,
        log_level="warning",
    ))
    conn.connect()
    eng = InferenceEngine(TPARAMS, TCFG, make_pc(), conn=conn,
                          model_id="single-path", device="cpu")
    assert type(eng.transfer) is KVTransferEngine
    assert eng.pin_prefix(PROMPT) == 0  # nowhere to replicate
    conn.close()

    pool = _pool(fleet)
    eng2 = InferenceEngine(TPARAMS, TCFG, make_pc(), conn=pool,
                           model_id="cluster-path", device="cpu")
    assert type(eng2.transfer) is ClusterTransferEngine
    assert eng2.transfer.device == torch.device("cpu")
    assert eng2.pin_prefix(PROMPT) >= 1
    pool.close()


class _Started(Exception):
    pass


@pytest.mark.parametrize("n_endpoints", [3, 1])
def test_cli_store_endpoints_build_a_ring(fleet, monkeypatch, n_endpoints):
    """``serve --store-endpoints a,b,c --store-replicas 2`` shards the
    engine's store over a ``RoutedStorePool`` (the server answers a
    completion and ``/debug/cluster`` shows three nodes); one endpoint
    keeps the single-connection path (``/debug/cluster`` disabled).
    ``main`` is stopped once its server has started."""
    from infinistore_tpu_torch import serve as tserve

    built = []
    real_start = tserve.ServingServer.start

    def start(self):
        real_start(self)
        built.append(self)
        raise _Started

    monkeypatch.setattr(tserve.ServingServer, "start", start)
    with pytest.raises(_Started):
        tserve.main(["--model", "tiny", "--device", "cpu", "--port", "0",
                     "--n-blocks", "64", "--block-tokens", "4",
                     "--kv-quant", "none", "--store-op-timeout", "5",
                     "--store-endpoints",
                     ",".join(fleet.endpoints[:n_endpoints]),
                     "--store-replicas", "2"])
    (srv,) = built
    transfer = srv.engine.transfer
    try:
        status, body = _post(srv.port, {"prompt": PROMPT, "max_tokens": 4,
                                        "temperature": 0}, timeout=60)
        assert status == 200 and len(body["choices"][0]["token_ids"]) == 4
        st, data = _get(srv.port, "/debug/cluster")
        rep = json.loads(data)
        if n_endpoints == 1:
            assert type(transfer) is KVTransferEngine
            assert rep == {"enabled": False}
        else:
            assert type(transfer) is ClusterTransferEngine
            assert rep["enabled"] and rep["replicas"] == 2
            assert [n["endpoint"] for n in rep["nodes"]] == fleet.endpoints
            assert all(n["state"] == "closed" for n in rep["nodes"])
    finally:
        srv.close()
        if n_endpoints == 1:
            transfer._src.close()
        else:
            transfer.pool.close()


def test_cluster_report_shape(fleet):
    pool = _pool(fleet)
    rep = pool.report()
    assert rep["enabled"] is True
    assert rep["replicas"] == min(DEFAULT_REPLICAS, 3)
    assert len(rep["nodes"]) == 3
    total_own = sum(n["ownership"] for n in rep["nodes"])
    assert 0.99 <= total_own <= 1.01
    for n in rep["nodes"]:
        assert {"endpoint", "state", "connected", "epoch", "ownership",
                "requests"} <= set(n)
        assert n["state"] == "closed" and n["connected"]
    assert {"hot_after", "tracked", "hot", "pinned"} <= set(rep["hot"])
    pool.close()


# ---- the handoff across frameworks over a ring, both directions ----

def _spanning_prompt(pool, model_id):
    """A 21-token prompt (5 complete chunks + a 1-token tail) whose chunks
    the ring ``pool`` spreads over at least two nodes, whatever ports the
    fleet's nodes took: the first of seeded candidates that does (one
    lands on a single node about 1 time in 80)."""
    rng = np.random.RandomState(531)
    cand = [23, 5, 77, 190, 3, 44, 8, 61, 12, 9, 100, 31, 2, 70, 18, 6,
            55, 4, 39, 27, 13]
    for _ in range(64):
        keys = chunk_keys(cand, model_id, chunk_tokens=T)
        if len(pool.partition(keys)) >= 2:
            return cand
        cand = [int(t) for t in rng.randint(1, TCFG.vocab_size, 21)]
    raise AssertionError("64 seeded prompts each landed on one node")


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_handoff_across_frameworks_over_a_ring(fleet, producer, quant):
    """One framework's engine prefills over three live nodes (each chunk
    to its ring owner); the other framework's engine, on its own pool,
    adopts every complete chunk and decodes the same greedy tokens.
    Lossless pages land byte-exact; int8 pages are the same packed bytes
    as the consumer's own quantizer makes of the producer's pages."""
    model_id = f"ring-handoff-{producer}-{quant}"
    jpool = ref_cluster.RoutedStorePool(fleet.endpoints, op_timeout_s=5.0)
    tpool = _pool(fleet)
    prompt = _spanning_prompt(tpool, model_id)
    try:
        je = JEngine(PARAMS, CFG, JPC(
            n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
            head_dim=CFG.head_dim, n_blocks=64, block_tokens=T,
            dtype=jnp.float32), conn=jpool, kv_quant=quant,
            model_id=model_id)
        te = InferenceEngine(TPARAMS, TCFG, make_pc(), conn=tpool,
                             kv_quant=quant, model_id=model_id,
                             device="cpu")
        a, b = (je, te) if producer == "jax" else (te, je)
        sa = a.prefill(prompt)
        a.store_flush()
        assert sa.reused_chunks == 0
        keys = chunk_keys(prompt, model_id, chunk_tokens=T)
        assert len(tpool.partition(keys)) >= 2, "the prompt spans one node"
        sb = b.prefill(prompt)
        n = (len(prompt) - 1) // T
        assert sb.reused_chunks == sb.store_chunks == n
        want = dense_greedy(prompt, 6)
        ids_a, ids_b = sa.block_ids[:n], sb.block_ids[:n]
        jpages = (j_read_pages(je.cache, jnp.asarray(
            ids_a if producer == "jax" else ids_b)))
        tpages = read_pages(te.cache, torch.tensor(
            ids_b if producer == "jax" else ids_a))
        if quant is None:
            assert a.decode(sa, 6) == want
            assert b.decode(sb, 6) == want
            np.testing.assert_array_equal(tpages.numpy(),
                                          np.asarray(jpages))
        else:
            # the bytes on the ring, read back through the torch pool
            tx = ClusterTransferEngine(tpool, make_pc(), quant="int8",
                                       device="cpu")
            stored = torch.cat([
                tx._engine(tpool.ring.owner(k)).fetch_pages([k])
                for k in keys[:n]], dim=1)
            src = (torch.from_numpy(np.array(jpages)) if producer == "jax"
                   else tpages)
            packed = quantize_pages(src.permute(0, 3, 1, 2, 4, 5)
                                    .contiguous())
            assert torch.equal(stored, packed)
            assert a.decode(sa, 6) == want
            assert b.decode(sb, 6) == want
    finally:
        jpool.close()
        tpool.close()


# ---- THE chaos test: 1-of-3 node outage under the port's serving stack ----

def _prompt(i):
    """Distinct 11-token prompts (same shapes, distinct chunk keys).  Keep
    i < 450: TINY's vocab is 512."""
    assert i < 450, i
    return [50 + i] + PROMPT[1:]


def _owned_prompt(pool, model_id, owner_ep, start=100, invert=False):
    """A prompt whose complete chunks are ALL owned by ``owner_ep`` (or,
    with ``invert``, all owned by OTHER nodes)."""
    for i in range(start, 450):
        p = _prompt(i)
        keys = chunk_keys(p, model_id, chunk_tokens=T)
        owners = {pool.ring.owner(k) for k in keys}
        if not invert and owners == {owner_ep}:
            return p
        if invert and owner_ep not in owners:
            return p
    raise AssertionError("no prompt found with the wanted ownership")


@pytest.fixture(scope="module")
def chaos_cluster():
    """The port's serving server over a 3-node store fleet, per-node
    breakers tuned for fast transitions, plus a producer engine on its own
    pool (seeding store-resident prefixes the serving engine never
    computed)."""
    f = _Fleet()
    pool = RoutedStorePool(f.endpoints, op_timeout_s=2.0, replicas=2)
    # kv_quant=None: byte-exact greedy tokens on the store-hit paths too
    eng = InferenceEngine(
        TPARAMS, TCFG, make_pc(n_blocks=128), conn=pool,
        model_id="cluster-serve", store_durability="relaxed",
        kv_quant=None, device="cpu",
    )
    eng.decode_chunk = 4
    for node in pool.nodes():
        node.breaker.failure_threshold = 2
        node.breaker.cooldown_s = 0.5
    prod_pool = RoutedStorePool(f.endpoints, op_timeout_s=5.0, replicas=2)
    prod = InferenceEngine(TPARAMS, TCFG, make_pc(), conn=prod_pool,
                           model_id="cluster-serve", kv_quant=None,
                           device="cpu")
    srv = ServingServer(eng, port=0, max_batch=4, model_id="cluster-serve")
    srv.start()
    yield srv, f, pool, prod
    srv.close()
    pool.close()
    prod_pool.close()
    f.stop()


def test_chaos_one_node_outage_degrades_only_its_range(chaos_cluster):
    """The reference's cluster acceptance walk on the port: kill 1 of 3
    store nodes mid-load -> every request still answers 200 with the dense
    reference's greedy tokens; ONLY the dead node's circuit opens (from
    /metrics and /debug/cluster); the survivors' key ranges keep serving
    store hits; restart -> the epoch fence fires on reconnect and the node
    rejoins."""
    srv, f, pool, prod = chaos_cluster
    victim_ep = f.endpoints[1]
    vi = 1
    live_ep = [ep for ep in f.endpoints if ep != victim_ep]

    def ask(p):
        status, body = _post(srv.port, {
            "prompt": p, "max_tokens": 6, "temperature": 0,
        }, timeout=60)
        assert status == 200, body
        assert body["choices"][0]["token_ids"] == dense_greedy(p, 6), body
        return body

    def serve_metrics():
        st, data = _get(srv.port, "/metrics")
        assert st == 200
        return m.parse_prometheus_text(data.decode())

    def cluster_report():
        st, data = _get(srv.port, "/debug/cluster")
        assert st == 200
        return json.loads(data)

    def store_tokens():
        return serve_metrics().get(
            ("istpu_engine_prefix_tokens_total", (("source", "store"),)),
            0.0)

    # phase 0: healthy fleet; the producer pushes a prefix living entirely
    # in the victim's key range and one entirely outside it
    victim_prompt = _owned_prompt(pool, "cluster-serve", victim_ep)
    survivor_prompt = _owned_prompt(pool, "cluster-serve", victim_ep,
                                    start=200, invert=True)
    prod.release(prod.prefill(victim_prompt))
    prod.release(prod.prefill(survivor_prompt))
    prod.store_flush()
    ask(_prompt(0))
    rep = cluster_report()
    assert rep["enabled"] and len(rep["nodes"]) == 3
    assert all(n["state"] == "closed" for n in rep["nodes"])
    st, data = _get(srv.port, "/healthz")
    assert json.loads(data)["status"] == "ok"

    # phase 1: kill the node; its range recomputes, and repeated hits on
    # it open ONLY its circuit (long cooldown holds OPEN for the checks)
    pool.node(victim_ep).breaker.cooldown_s = 60.0
    f.kill(vi)
    ask(victim_prompt)
    deadline = time.time() + 10
    while (pool.node(victim_ep).breaker.state != "open"
           and time.time() < deadline):
        ask(_owned_prompt(pool, "cluster-serve", victim_ep,
                          start=300 + int(time.time() * 7) % 100))
        time.sleep(0.05)
    assert pool.node(victim_ep).breaker.state == "open"
    for ep in live_ep:
        assert pool.node(ep).breaker.state == "closed"
    before_store = store_tokens()
    ask(survivor_prompt)
    assert store_tokens() > before_store, \
        "live nodes' key range must keep serving store hits"
    rep = cluster_report()
    by_ep = {n["endpoint"]: n for n in rep["nodes"]}
    assert by_ep[victim_ep]["state"] == "open"
    assert by_ep[victim_ep]["requests"]["error"] >= 2
    for ep in live_ep:
        assert by_ep[ep]["state"] == "closed"
        assert by_ep[ep]["requests"]["error"] == 0
    assert sum(by_ep[ep]["requests"]["ok"] for ep in live_ep) >= 1
    parsed = serve_metrics()
    assert parsed.get(("istpu_cluster_node_state",
                       (("endpoint", victim_ep),))) == 1.0
    for ep in live_ep:
        assert parsed.get(("istpu_cluster_node_state",
                           (("endpoint", ep),))) == 0.0
    assert parsed.get(("istpu_store_circuit_state",
                       (("name", f"store@{victim_ep}"),))) == 1.0
    st, data = _get(srv.port, "/healthz")
    health = json.loads(data)
    assert health["status"] == "degraded"
    assert health["store_circuit"] == "partial"

    # while the victim's circuit is open its range is SKIPPED outright
    t0 = time.perf_counter()
    ask(_owned_prompt(pool, "cluster-serve", victim_ep, start=420))
    assert time.perf_counter() - t0 < 1.5

    # phase 2: restart on the SAME port — reconnect fences the epoch and
    # the node rejoins: circuit closes, its range serves again
    epoch_before = serve_metrics().get(
        ("istpu_integrity_failures_total", (("cause", "epoch"),)), 0.0)
    f.restart(vi)
    pool.node(victim_ep).breaker.cooldown_s = 0.5
    time.sleep(pool.node(victim_ep).breaker.cooldown_s + 0.1)
    deadline = time.time() + 30
    while (pool.node(victim_ep).breaker.state != "closed"
           and time.time() < deadline):
        ask(_owned_prompt(pool, "cluster-serve", victim_ep,
                          start=340 + int(time.time() * 3) % 60))
        time.sleep(0.05)
    assert pool.node(victim_ep).breaker.state == "closed"
    assert serve_metrics().get(
        ("istpu_integrity_failures_total", (("cause", "epoch"),)), 0.0
    ) > epoch_before, "reconnect across the restart must fence the epoch"
    rejoin_prompt = _owned_prompt(pool, "cluster-serve", victim_ep,
                                  start=240)
    prod.release(prod.prefill(rejoin_prompt))
    prod.store_flush()
    before_store = store_tokens()
    ask(rejoin_prompt)
    assert store_tokens() > before_store
    rep = cluster_report()
    assert {n["endpoint"]: n["state"] for n in rep["nodes"]} == {
        ep: "closed" for ep in f.endpoints
    }
    deadline = time.time() + 10  # a clean idle flush clears the flag
    while time.time() < deadline:
        st, data = _get(srv.port, "/healthz")
        if json.loads(data)["status"] == "ok":
            break
        time.sleep(0.1)
    assert json.loads(data)["status"] == "ok", data
