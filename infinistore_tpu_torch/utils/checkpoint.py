"""Checkpoint/resume for params, optimizer state, and engine metadata.

Counterpart of the reference's ``utils/checkpoint.py``, torch-native: the
reference wraps orbax-checkpoint, the port writes ``torch.save`` files and
reads them back with ``torch.load(weights_only=True)``, so no package
beyond PyTorch is needed and no pickled code is ever run on restore.

* **numbered steps, keep-N**: each ``save`` makes one directory named by
  its step under ``directory``; only the newest ``max_to_keep`` stay.
* **async save**: the device-to-host copy happens at ``save()`` (so the
  caller may update its tensors in place right after); serialization runs
  on a background thread and each step directory appears atomically (it
  is written under a hidden name and renamed).  ``wait()`` (or the next
  save) joins it and raises what the thread raised.
* **restore onto the caller's devices**: ``like`` (a tree of tensors of
  the same structure) puts every leaf on that tensor's device and dtype.

Engine metadata (page tables, chunk keys, token history) is plain Python
and rides along as JSON, the same JSON as the reference's, so a state file
written by either package resumes in the other's engine over a shared
store.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, List, Optional

import torch

_STATE = "state.pt"
_METADATA = "metadata.json"


def _tree_map(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn`` over the tensors of a tree of dicts, lists and tuples
    (``others``: trees of the same structure, their leaves passed beside);
    anything else is kept as it is."""
    if isinstance(tree, dict):
        for o in others:
            if not isinstance(o, dict) or set(o) != set(tree):
                raise ValueError(f"tree keys differ: {sorted(tree)} against "
                                 f"{sorted(o) if isinstance(o, dict) else o}")
        return {k: _tree_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        for o in others:
            if not isinstance(o, (list, tuple)) or len(o) != len(tree):
                raise ValueError("tree lengths differ")
        out = [_tree_map(fn, v, *(o[i] for o in others))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    if isinstance(tree, torch.Tensor):
        return fn(tree, *others)
    return tree


class CheckpointManager:
    """Numbered steps under one directory, keep-N, async save."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    # ---- save ----

    def save(self, step: int, state: Any,
             metadata: Optional[dict] = None) -> None:
        """Async-save a tree of tensors (on any device); ``metadata`` is
        JSON-serializable.  The tensors are copied to the host before this
        returns."""
        self.wait()
        step = int(step)
        if os.path.exists(self._step_dir(step)):
            raise ValueError(f"step {step} already saved under "
                             f"{self.directory}")
        host = _tree_map(lambda t: t.detach().to("cpu", copy=True), state)
        blob = None if metadata is None else json.dumps(metadata)
        self._thread = threading.Thread(
            target=self._write, args=(step, host, blob),
            name=f"checkpoint-{step}")
        self._thread.start()

    def _write(self, step: int, host: Any, blob: Optional[str]) -> None:
        tmp = os.path.join(self.directory, f".{step}.tmp")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(host, os.path.join(tmp, _STATE))
            if blob is not None:
                with open(os.path.join(tmp, _METADATA), "w") as f:
                    f.write(blob)
            os.rename(tmp, self._step_dir(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))
        except BaseException as e:  # re-raised by wait()
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e

    def wait(self) -> None:
        """Join the background save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    # ---- restore ----

    def all_steps(self) -> List[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """Restore the state tree (host tensors).  ``like`` (a tree of
        tensors of the same structure) puts each leaf on that tensor's
        device and dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        state = torch.load(os.path.join(self._step_dir(step), _STATE),
                           map_location="cpu", weights_only=True)
        if like is None:
            return state
        return _tree_map(
            lambda t, ref: t.to(device=ref.device, dtype=ref.dtype),
            state, like)

    def restore_metadata(self, step: Optional[int] = None) -> Optional[dict]:
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self._step_dir(step), _METADATA)
        if not os.path.exists(path):
            return None  # this step was saved without metadata
        # a present-but-unreadable blob is corruption: let it raise
        with open(path) as f:
            return json.load(f)

    def close(self) -> None:
        self.wait()


def save_engine_state(path: str, engine) -> None:
    """Persist an InferenceEngine's host-side serving state (sequences,
    page tables, chunk keys) as the reference's JSON.  The device cache
    itself is NOT saved: committed pages live in the store and are
    re-fetched on resume (the reference's "DRAM tier outlives engine
    restarts" behavior).  The file is replaced atomically."""
    seqs = {
        str(sid): {
            "tokens": [int(t) for t in s.tokens],
            "block_ids": [int(b) for b in s.block_ids],
            "chunk_keys": list(s.chunk_keys),
            "reused_chunks": int(s.reused_chunks),
        }
        for sid, s in engine.seqs.items()
    }
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"model_id": engine.model_id, "next_id": engine._next_id,
                   "seqs": seqs}, f)
    os.replace(tmp, path)


def resume_engine_state(path: str, engine) -> int:
    """Re-attach persisted sequences through ``engine.prefill``: store-
    resident prefix pages are re-fetched into device memory and only the
    tail (plus anything evicted from the store) is recomputed -- the exact
    decode-node startup path, so resumed sequences have correct logits and
    can keep decoding immediately.  Original sequence ids are preserved.
    Returns the number of sequences resumed."""
    with open(path) as f:
        blob = json.load(f)
    if blob["model_id"] != engine.model_id:
        raise ValueError(
            f"checkpoint is for model {blob['model_id']!r}, engine has "
            f"{engine.model_id!r}"
        )
    clash = set(engine.seqs) & {int(s) for s in blob["seqs"]}
    if clash:
        raise ValueError(
            f"sequence ids {sorted(clash)} already live in this engine; "
            "resume into a fresh engine or release them first"
        )
    # fresh ids start past every persisted one first, so no prefill below
    # takes the id of a sequence resumed before it (the reference moves
    # the counter after the loop, where a file listing a higher id before
    # a lower one loses a sequence)
    engine._next_id = max(blob["next_id"], engine._next_id)
    resumed = 0
    for sid, s in blob["seqs"].items():
        state = engine.prefill(s["tokens"])
        # restore the persisted identity
        engine.seqs.pop(state.seq_id, None)
        state.seq_id = int(sid)
        engine.seqs[state.seq_id] = state
        resumed += 1
    return resumed
