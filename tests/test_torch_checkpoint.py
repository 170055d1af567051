"""The port's checkpoints and engine resume (``utils/checkpoint.py``) on the
CPU.

``CheckpointManager`` (``torch.save`` step directories, keep-N, async
save, ``like``), the ports of ``tests/test_checkpoint.py``'s
``test_keep_n`` and ``test_engine_resume`` on the port's own store server,
and resume across the two packages: the state file is the reference's
JSON, so a JAX engine's saved state resumes in a port engine over the
shared store, and the reverse.  TINY float32 with the reference's weights,
lossless pages (``kv_quant=None``): greedy tokens are held equal to an
uninterrupted engine's."""

import json
import os
import signal
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu as ist
from infinistore_tpu.engine.engine import InferenceEngine as JEngine
from infinistore_tpu.kv import PagedCacheConfig as JPC
from infinistore_tpu.models import TINY, init_params, scaled
from infinistore_tpu.utils import checkpoint as jckpt
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch.engine import InferenceEngine
from infinistore_tpu_torch.kv import PagedCacheConfig
from infinistore_tpu_torch.models import TINY as TTINY
from infinistore_tpu_torch.models import params_from_jax
from infinistore_tpu_torch.models import scaled as tscaled
from infinistore_tpu_torch.utils import (
    CheckpointManager,
    resume_engine_state,
    save_engine_state,
)
from test_torch_store import _serve

torch.set_num_threads(2)


# ---- CheckpointManager ----

def _state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 8, generator=g),
            "layers": {"a": torch.randn(3, generator=g),
                       "b": torch.arange(6, dtype=torch.int32)},
            "pair": [torch.ones(2, dtype=torch.bfloat16), torch.zeros(1)]}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_keep_n(tmp_path):
    """The port of ``tests/test_checkpoint.py::test_keep_n``."""
    mgr = CheckpointManager(str(tmp_path / "k"), max_to_keep=2)
    state = {"w": torch.arange(8.0)}
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.latest_step() == 3
    assert 1 not in mgr.all_steps()
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "k")) == ["2", "3"]
    mgr.close()


def test_roundtrip_and_a_step_restored_by_number(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=3)
    first = _state()
    mgr.save(7, first)
    second = {k: v for k, v in _state().items()}
    second["w"] = second["w"] + 1
    mgr.save(8, second)
    mgr.wait()
    assert _equal(mgr.restore(), second)
    assert _equal(mgr.restore(7), first)
    assert isinstance(mgr.restore(7)["pair"], list)
    mgr.close()


def test_restore_like_takes_each_leafs_dtype_and_device(tmp_path):
    """``like`` puts every leaf on that tensor's dtype and device (``meta``
    stands in for the card here; ``tests/test_torch_cuda.py`` restores
    onto ``cuda``)."""
    mgr = CheckpointManager(str(tmp_path / "l"))
    state = _state()
    mgr.save(1, state)
    mgr.wait()
    like = {"w": torch.empty(4, 8, dtype=torch.bfloat16),
            "layers": {"a": torch.empty(3, dtype=torch.float64),
                       "b": torch.empty(6, dtype=torch.int32, device="meta")},
            "pair": [torch.empty(2, dtype=torch.float32), torch.empty(1)]}
    got = mgr.restore(like=like)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], state["w"].to(torch.bfloat16))
    assert got["layers"]["a"].dtype == torch.float64
    assert got["layers"]["b"].device.type == "meta"
    assert got["pair"][0].dtype == torch.float32
    assert torch.equal(got["pair"][0], state["pair"][0].float())
    with pytest.raises(ValueError, match="keys differ"):
        mgr.restore(like={"w": like["w"]})


@pytest.mark.parametrize("metadata", [None, {"step": 1, "model": "tiny"}])
def test_metadata_present_and_absent(tmp_path, metadata):
    mgr = CheckpointManager(str(tmp_path / "m"))
    assert mgr.restore_metadata() is None  # nothing saved yet
    mgr.save(1, {"w": torch.zeros(2)}, metadata=metadata)
    mgr.wait()
    assert mgr.restore_metadata() == metadata
    assert mgr.restore_metadata(1) == metadata
    mgr.close()


def test_unreadable_metadata_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "u"))
    mgr.save(1, {"w": torch.zeros(2)}, metadata={"ok": True})
    mgr.wait()
    with open(tmp_path / "u" / "1" / "metadata.json", "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError):
        mgr.restore_metadata()


def test_async_save_copies_at_save_and_reads_after_wait(tmp_path):
    """The host copy is taken when ``save`` returns: a caller updating
    its tensors in place right after (as ``train_step_fn`` does) saves
    the values it had; the step directory appears whole, and a second
    save of a step raises."""
    mgr = CheckpointManager(str(tmp_path / "a"))
    state = _state()
    want = {"w": state["w"].clone()}
    mgr.save(1, {"w": state["w"]})
    state["w"].add_(100.0)
    mgr.wait()
    assert _equal(mgr.restore(), want)
    assert sorted(os.listdir(tmp_path / "a")) == ["1"]
    assert sorted(os.listdir(tmp_path / "a" / "1")) == ["state.pt"]
    with pytest.raises(ValueError, match="already saved"):
        mgr.save(1, want)
    mgr.close()


def test_no_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "e"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()


def test_failed_background_save_raises_at_wait(tmp_path):
    """A save that fails on its thread raises at ``wait()`` and leaves no
    step behind (here a file sits where step 2's hidden directory goes)."""
    mgr = CheckpointManager(str(tmp_path / "f"))
    mgr.save(1, {"w": torch.zeros(2)}, metadata={"ok": True})
    (tmp_path / "f" / ".2.tmp").write_text("in the way")
    mgr.save(2, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        mgr.wait()
    assert mgr.all_steps() == [1]
    mgr.wait()  # the error is reported once


# ---- engine resume through a live store ----

CFG = scaled(TINY, dtype=jnp.float32)
TCFG = tscaled(TTINY, dtype=torch.float32)
PARAMS = init_params(CFG, jax.random.PRNGKey(0))
TPARAMS = params_from_jax(jax.tree.map(np.asarray, PARAMS), TCFG, "cpu")
PROMPT = [int(t) for t in np.random.default_rng(3).integers(
    0, CFG.vocab_size, 40)]


@pytest.fixture(scope="module")
def server():
    """The port's own store server (asyncio backend)."""
    proc, port = _serve("infinistore_tpu_torch")
    yield port
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()


def _tconn(port):
    c = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="warning",
        connection_type=tconfig.TYPE_SHM))
    c.connect()
    return c


def _jconn(port):
    c = ist.InfinityConnection(ist.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="warning",
        connection_type=ist.TYPE_SHM))
    c.connect()
    return c


def tengine(conn, model_id):
    pc = PagedCacheConfig(n_layers=TCFG.n_layers, n_kv_heads=TCFG.n_kv_heads,
                          head_dim=TCFG.head_dim, n_blocks=32,
                          block_tokens=16, dtype=TCFG.dtype)
    return InferenceEngine(TPARAMS, TCFG, pc, conn=conn, kv_quant=None,
                           model_id=model_id, device="cpu")


def jengine(conn, model_id):
    pc = JPC(n_layers=CFG.n_layers, n_kv_heads=CFG.n_kv_heads,
             head_dim=CFG.head_dim, n_blocks=32, block_tokens=16,
             dtype=CFG.dtype)
    return JEngine(PARAMS, CFG, pc, conn=conn, kv_quant=None,
                   model_id=model_id)


def _uninterrupted(n):
    return tengine(None, "ref").generate(PROMPT, n)


def test_engine_resume(server, tmp_path):
    """The port of ``tests/test_checkpoint.py::test_engine_resume``: a
    fresh engine with an empty cache resumes from the store, decodes on
    as the uninterrupted engine does, and a foreign model id is
    rejected."""
    conns = [_tconn(server) for _ in range(3)]
    try:
        eng1 = tengine(conns[0], "ck")
        st = eng1.prefill(PROMPT)
        first = eng1.decode(st, 3)
        path = str(tmp_path / "engine.json")
        save_engine_state(path, eng1)

        eng2 = tengine(conns[1], "ck")
        assert resume_engine_state(path, eng2) == 1
        st2 = eng2.seqs[st.seq_id]
        assert st2.tokens == st.tokens
        assert st2.reused_chunks > 0  # pages came from the store
        cont = eng2.decode(st2, 3)
        assert first + cont == _uninterrupted(6)

        eng4 = tengine(conns[2], "other")
        with pytest.raises(ValueError, match="checkpoint is for model"):
            resume_engine_state(path, eng4)
        with pytest.raises(ValueError, match="already live"):
            resume_engine_state(path, eng2)
    finally:
        for c in conns:
            c.close()


def test_state_file_is_the_references_json(server, tmp_path):
    """The port writes the reference's keys, with the same values the
    reference's writer gives for the same engine."""
    conn = _tconn(server)
    try:
        eng = tengine(conn, "json")
        a = eng.prefill(PROMPT)
        eng.decode(a, 2)
        eng.prefill(PROMPT[:20])
        save_engine_state(str(tmp_path / "port.json"), eng)
        jckpt.save_engine_state(str(tmp_path / "ref.json"), eng)
    finally:
        conn.close()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert port == ref
    assert set(port) == {"model_id", "next_id", "seqs"}
    assert set(port["seqs"]["0"]) == {"tokens", "block_ids", "chunk_keys",
                                      "reused_chunks"}
    assert not (tmp_path / "port.json.tmp").exists()


def test_resume_keeps_every_id_whatever_the_file_order(server, tmp_path):
    """A file listing a higher sequence id before a lower one resumes
    both under their ids (fresh ids start past the file's ``next_id``
    before the first prefill)."""
    conns = [_tconn(server) for _ in range(2)]
    try:
        eng1 = tengine(conns[0], "order")
        s0 = eng1.prefill(PROMPT)
        s1 = eng1.prefill(PROMPT[:24])
        path = tmp_path / "engine.json"
        save_engine_state(str(path), eng1)
        blob = json.loads(path.read_text())
        blob["seqs"] = dict(reversed(list(blob["seqs"].items())))
        path.write_text(json.dumps(blob))
        eng2 = tengine(conns[1], "order")
        assert resume_engine_state(str(path), eng2) == 2
        assert sorted(eng2.seqs) == [s0.seq_id, s1.seq_id]
        assert eng2.seqs[s0.seq_id].tokens == PROMPT
        assert eng2.seqs[s1.seq_id].tokens == PROMPT[:24]
        assert eng2._next_id > max(eng2.seqs)
    finally:
        for c in conns:
            c.close()


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_resume_across_frameworks(server, tmp_path, saver):
    """One package's engine prefills into the store, decodes three tokens
    and saves its state; the OTHER package's engine resumes it from the
    store (its own connection and cache), and its next three tokens equal
    the uninterrupted engine's."""
    jc, tc = _jconn(server), _tconn(server)
    model_id = f"xf-from-{saver}"
    path = str(tmp_path / "engine.json")
    try:
        if saver == "jax":
            a = jengine(jc, model_id)
            st = a.prefill(PROMPT)
            first = a.decode(st, 3)
            jckpt.save_engine_state(path, a)
            b = tengine(tc, model_id)
            assert resume_engine_state(path, b) == 1
        else:
            a = tengine(tc, model_id)
            st = a.prefill(PROMPT)
            first = a.decode(st, 3)
            save_engine_state(path, a)
            b = jengine(jc, model_id)
            assert jckpt.resume_engine_state(path, b) == 1
        st2 = b.seqs[st.seq_id]
        assert st2.tokens == PROMPT + first
        assert st2.reused_chunks > 0 and st2.store_chunks == st2.reused_chunks
        assert first + b.decode(st2, 3) == _uninterrupted(6)
    finally:
        jc.close()
        tc.close()
