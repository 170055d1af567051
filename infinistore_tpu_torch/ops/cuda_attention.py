"""Attention kernels written by hand for Hopper, beside their plain versions.

Counterpart of the reference's ``ops/pallas_attention.py``.  Four kernels,
CUDA C++ in ``csrc/`` (built by ``build.py`` at first use):

* K1 ``paged_decode_attention_cuda`` (``csrc/paged_decode.cu``): one-token
  GQA decode attention read straight off the paged cache, each row's page
  walk split across blocks (``decode_splits``) and merged in the same
  launch; replaces ``paged_decode_attention_pallas``.
* K3 ``flash_causal_attention_cuda`` (``csrc/flash_attention.cu``): causal
  flash prefill with a ``q_offset``; replaces
  ``flash_causal_attention_pallas``.
* K2 ``flash_prefix_attention_cuda`` (same source, prefix mask): flash
  prefill over a bucketed prefix; replaces ``flash_prefix_attention_pallas``.
* K4 ``paged_decode_attention_alllayers_cuda`` (``csrc/paged_decode.cu``):
  K1 over every layer in one launch, bitwise equal to L K1 launches; an
  instrument for launch overhead (``bench_gpu.py``), not a model path;
  replaces ``paged_decode_attention_pallas_alllayers``.

Each wrapper takes the plain PyTorch version for a tensor on the CPU and
only then.  For a CUDA tensor it checks device, type, shape, contiguity and
alignment, launches the kernel on the current stream, raises if the launch
fails, and counts the launch against the launching thread in
``BY_THREAD``; it never falls back.  ``LAUNCHES`` reads the sum over the
threads: in an in-process fleet each worker's engine thread launches and
replays its own kernels.  A call made while its stream is being captured
into a CUDA graph launches nothing: it counts in ``CAPTURED`` instead, and
whoever replays the graph adds the graph's captured launches to its own
thread's count at each replay (``count_replay``).  A capturer learns what
its own capture recorded from ``capture_tally``, which counts the
capturing thread's calls only, so two engines capturing at once in one
process never count each other's.

The plain versions are direct ports of the XLA functions the Pallas kernels
were tested against: ``paged_decode_attention_xla`` for K1 and the
causal / ``q_offset`` / padded-prefix modes of ``causal_attention_xla`` for
K3 and K2.  They repeat the math in bf16 where the reference does (products
in the input type, softmax in fp32); the kernels accumulate in fp32.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from collections.abc import Mapping
from typing import Optional

import torch

from . import build

KERNELS = ("paged_decode", "flash_causal", "flash_prefix",
           "paged_decode_alllayers")
# launches of each kernel per launching thread (thread ident -> counts),
# since the last reset (CPU calls are not launches)
BY_THREAD: dict = {}
# calls recorded into a CUDA graph under capture, since the last reset: a
# capture records a launch for each replay to make, and launches nothing
CAPTURED = dict.fromkeys(KERNELS, 0)
# guards the tallies: engines on several threads launch at once
_COUNT_LOCK = threading.Lock()
# the capture tally of the calling thread, while ``capture_tally`` is open
_TALLY = threading.local()


class _Launches(Mapping):
    """Launches of each kernel since the last reset, over all threads: a
    read-only view that sums ``BY_THREAD``."""

    def __getitem__(self, kernel: str) -> int:
        if kernel not in CAPTURED:
            raise KeyError(kernel)
        with _COUNT_LOCK:
            return sum(c[kernel] for c in BY_THREAD.values())

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self) -> int:
        return len(KERNELS)

    def __repr__(self) -> str:
        return repr(dict(self))


LAUNCHES = _Launches()

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (32, 64, 128)  # the head sizes the kernels are built for
_MAX_REP = 16  # query heads per KV head a decode block holds

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "istpu_paged_decode": ("paged_decode",
                           [_P] * 7 + [_I] * 10 + [_F, _I, _P]),
    "istpu_flash_attention": ("flash_attention",
                              [_P] * 4 + [_I] * 9 + [_F, _I, _P]),
}
_FNS: dict = {}

# K1/K4's split page walk: a row's pages are walked in splits of
# SPLIT_TOKENS tokens (rounded up to whole pages), at most MAX_SPLITS per
# row; the size that gave the decode step the least K1 time on the card
# (PERF.md, Findings).
SPLIT_TOKENS = 128
MAX_SPLITS = 64
_STATS_FLOATS = 2 * _MAX_REP  # a split's m and l beside its acc [R, D]
# per (device, stream handle): (workspace, counters) of csrc/paged_decode.cu:
# the splits' fp32 partials, and the merge counters, [L * B * H_kv] int32,
# zero between launches (the kernel's last block resets its row).  Launches
# on one stream run one at a time, so one pair serves them all, and
# launches on two streams never share one.  Each grows only when a larger
# call first appears on its stream; a grown-out tensor is kept alive, since
# a captured CUDA graph may still point at it.  A graph holds its capture
# stream's pair: replay it where nothing else runs on that pair meanwhile.
_SCRATCH: dict = {}
_RETIRED: list = []


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in KERNELS:
            CAPTURED[k] = 0
        BY_THREAD.clear()


def _launched(counter: str, n: int) -> None:
    """Count ``n`` launches of ``counter`` against the calling thread; the
    caller holds the lock."""
    mine = BY_THREAD.setdefault(threading.get_ident(),
                                dict.fromkeys(KERNELS, 0))
    mine[counter] += n


def _count(counter: str) -> None:
    capturing = torch.cuda.is_current_stream_capturing()
    with _COUNT_LOCK:
        if capturing:
            CAPTURED[counter] += 1
            tally = getattr(_TALLY, "counts", None)
            if tally is not None:
                tally[counter] = tally.get(counter, 0) + 1
        else:
            _launched(counter, 1)


@contextlib.contextmanager
def capture_tally():
    """Yields a dict that counts, by kernel, the calls THIS thread makes
    under stream capture while the block runs: what a graph captured there
    will launch at each replay, whatever other threads capture meanwhile."""
    tally: dict = {}
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = tally
    try:
        yield tally
    finally:
        _TALLY.counts = outer


def count_replay(captured: dict) -> None:
    """One replay of a CUDA graph that captured ``captured[k]`` launches of
    kernel ``k``: each of them launches again."""
    with _COUNT_LOCK:
        for k, n in captured.items():
            _launched(k, n)


def _kernel(fn_name: str):
    fn = _FNS.get(fn_name)
    if fn is None:
        lib_name, argtypes = _SIGNATURES[fn_name]
        lib = build.load(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.istpu_error_string.argtypes = [ctypes.c_int]
        lib.istpu_error_string.restype = ctypes.c_char_p
        _FNS[fn_name] = fn
        _FNS[fn_name + ".err"] = lib.istpu_error_string
    return fn


def _launch(fn_name: str, device: torch.device, stream: int, *args) -> None:
    """Launch ``fn_name`` on ``stream`` (the handle of the current stream of
    ``device``); raise if the launch fails."""
    fn = _kernel(fn_name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        msg = _FNS[fn_name + ".err"](err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")


def _check_cuda(name: str, t: torch.Tensor, device: torch.device,
                dtype: Optional[torch.dtype] = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_attention_dtype(q: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA attention kernels take bf16 or f32, got "
                        f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the CUDA attention kernels are built for head_dim "
                         f"in {HEAD_DIMS}, got {q.shape[-1]}")


# ---- plain versions ----


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[..., S, H_kv, D] -> [..., S, H_kv*n_rep, D]: KV head j serves query
    heads j*n_rep .. j*n_rep + n_rep - 1."""
    if n_rep == 1:
        return x
    shape = tuple(x.shape)
    x = x[..., :, :, None, :].expand(shape[:-1] + (n_rep, shape[-1]))
    return x.reshape(shape[:-2] + (shape[-2] * n_rep, shape[-1]))


def causal_attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset: int = 0,
    prefix_pad: Optional[int] = None,
    prefix_len: Optional[int] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal SDPA, the plain version of K3 and K2: a port of the XLA path of
    the reference's ``models/attention.py:causal_attention`` (:253-284).

    q: [B, Sq, H, D]; k/v: [B, Sk, H_kv, D] -> [B, Sq, H, D].
    ``q_offset``: absolute position of q[0] minus that of k[0].
    Padded-prefix mode (``prefix_pad`` and ``prefix_len`` given): the first
    ``prefix_pad`` K/V rows are a prefix buffer of which the first
    ``prefix_len`` are valid; the remaining rows are the queries' own KV,
    causal by chunk-local index.  ``window`` (sliding window, HF
    convention) and ``softcap`` (Gemma-2 logit soft-capping) are masks the
    kernels do not carry.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    k = repeat_kv(k, H // Hkv)
    v = repeat_kv(v, H // Hkv)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    k_pos = torch.arange(Sk, device=q.device)
    if prefix_len is not None:
        if prefix_pad is None:
            raise ValueError("padded-prefix mode needs prefix_pad")
        i = torch.arange(Sq, device=q.device)[:, None]  # query row in chunk
        in_prefix = k_pos[None, :] < prefix_len
        in_self = (k_pos[None, :] >= prefix_pad) & (
            k_pos[None, :] - prefix_pad <= i
        )
        mask = in_prefix | in_self
        if window is not None:
            k_abs = torch.where(
                k_pos < prefix_pad, k_pos, prefix_len + k_pos - prefix_pad
            )
            mask &= k_abs[None, :] > prefix_len + i - window
    else:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = logits.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def paged_decode_attention_xla(
    q: torch.Tensor,
    layer_cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode attention against the paged cache, the plain version
    of K1: a port of the reference's ``paged_decode_attention_xla``
    (``models/attention.py:287-323``), a gather of every table page.

    q: [B, H, D] (RoPE applied); layer_cache: [2, H_kv, n_blocks, T, D];
    block_table: [B, max_pages]; seq_lens: [B] (valid tokens incl. the
    current one) -> [B, H, D].

    Pad rows (a table entry the row would read outside ``[0, n_blocks)``, or
    ``seq_len <= 0``) give zeros, as K1 does.  The reference's gather clamps
    such indices and returns whatever it read; torch raises on them, so
    indices are clamped here and the rows zeroed after.
    """
    B, H, D = q.shape
    Hkv, n_blocks, T = layer_cache.shape[1:4]
    max_pages = block_table.shape[1]
    table = block_table.long()
    n_pages = (seq_lens.long() + T - 1) // T
    used = torch.arange(max_pages, device=q.device)[None, :] < n_pages[:, None]
    bad = ((table < 0) | (table >= n_blocks)) & used
    pad_row = bad.any(dim=1) | (seq_lens <= 0) | (n_pages > max_pages)
    table = table.clamp(0, n_blocks - 1)
    # gather pages: [H_kv, B, max_pages, T, D] -> [B, S_max, H_kv, D]
    k = layer_cache[0][:, table].permute(1, 2, 3, 0, 4)
    v = layer_cache[1][:, table].permute(1, 2, 3, 0, 4)
    k = repeat_kv(k.reshape(B, max_pages * T, Hkv, D), H // Hkv)
    v = repeat_kv(v.reshape(B, max_pages * T, Hkv, D), H // Hkv)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bhd,bkhd->bhk", q, k).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(max_pages * T, device=q.device)
    mask = pos[None, :] < seq_lens[:, None]
    if window is not None:
        mask &= pos[None, :] >= seq_lens[:, None] - window
    logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype), v)
    return out.masked_fill(pad_row[:, None, None], 0)


def paged_decode_attention_alllayers_xla(
    qs: torch.Tensor,
    cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """The plain version of K4: ``paged_decode_attention_xla`` for every
    layer.  qs: [L, B, H, D]; cache: [L, 2, H_kv, n_blocks, T, D];
    block_table / seq_lens shared by all layers -> [L, B, H, D]."""
    return torch.stack([
        paged_decode_attention_xla(qs[l], cache[l], block_table, seq_lens)
        for l in range(qs.shape[0])
    ])


# ---- kernel wrappers ----


def decode_splits(T: int, max_pages: int) -> tuple:
    """(pages per split, splits per row) of K1/K4's page walk, from the
    page size and the table width alone: never from ``seq_lens``, so a
    launch needs no host sync, and never from L, so K4 equals L K1
    launches."""
    pages = max(-(-SPLIT_TOKENS // T), -(-max_pages // MAX_SPLITS), 1)
    return pages, max(1, -(-max_pages // pages))


def _scratch(device: torch.device, stream: int, n_ws: int,
             n_counters: int) -> tuple:
    """The (workspace, counters) of launches on ``stream``, at least
    ``n_ws`` floats and ``n_counters`` counters."""
    pair = _SCRATCH.get((device, stream))
    if pair is not None and pair[0].numel() >= n_ws and \
            pair[1].numel() >= n_counters:
        return pair
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "K1/K4's workspace and merge counters must be sized by one launch "
            "at this shape on the capture stream before a CUDA graph is "
            "captured")
    if pair is not None:
        _RETIRED.extend(pair)
        n_ws = max(n_ws, pair[0].numel())
        n_counters = max(n_counters, pair[1].numel())
    pair = _SCRATCH[(device, stream)] = (
        torch.empty(n_ws, dtype=torch.float32, device=device),
        torch.zeros(n_counters, dtype=torch.int32, device=device))
    return pair


def _paged_decode(qs: torch.Tensor, cache: torch.Tensor,
                  block_table: torch.Tensor, seq_lens: torch.Tensor,
                  name: str, counter: str) -> torch.Tensor:
    """Check and launch ``csrc/paged_decode.cu`` over qs [L, B, H, D] and
    cache [L, 2, H_kv, n_blocks, T, D]: K4, or K1 at L = 1.  One launch,
    no host sync; the splits' partials go to the stream's workspace
    (``_scratch``) and are merged in the same launch."""
    _check_attention_dtype(qs)
    L, B, H, D = qs.shape
    if cache.dim() != 6 or cache.shape[0] != L or cache.shape[1] != 2 or \
            cache.shape[5] != D:
        raise ValueError(f"{name}: the cache must be [2, H_kv, n_blocks, T, "
                         f"{D}] per layer, got {tuple(cache.shape)}")
    Hkv, n_blocks, T = cache.shape[2:5]
    if H % Hkv or H // Hkv > _MAX_REP:
        raise ValueError(f"{name} takes H % H_kv == 0 and H/H_kv <= "
                         f"{_MAX_REP}, got H={H}, H_kv={Hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != B or \
            tuple(seq_lens.shape) != (B,):
        raise ValueError("block_table must be [B, max_pages], seq_lens [B]")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_table and seq_lens must be int32")
    _check_cuda("q", qs, qs.device)
    _check_cuda("cache", cache, qs.device, qs.dtype)
    _check_cuda("block_table", block_table, qs.device)
    _check_cuda("seq_lens", seq_lens, qs.device)
    out = torch.empty_like(qs)
    if B == 0 or L == 0:
        return out
    max_pages = block_table.shape[1]
    split_pages, n_splits = decode_splits(T, max_pages)
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    ws = counters = None
    if n_splits > 1:
        rec = (H // Hkv) * D + _STATS_FLOATS
        ws, counters = _scratch(qs.device, stream,
                                L * B * Hkv * n_splits * rec, L * B * Hkv)
    _launch(
        "istpu_paged_decode", qs.device, stream,
        qs.data_ptr(), cache.data_ptr(), block_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        L, B, H, Hkv, n_blocks, T, D, max_pages, split_pages, n_splits,
        1.0 / math.sqrt(D), _DTYPE_CODE[qs.dtype],
    )
    _count(counter)
    return out


def paged_decode_attention_cuda(
    q: torch.Tensor,
    layer_cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """K1 (``csrc/paged_decode.cu``); same signature and layout as
    ``paged_decode_attention_xla``, which it runs for CPU tensors."""
    if q.device.type == "cpu":
        return paged_decode_attention_xla(q, layer_cache, block_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA (or its plain version on the CPU), "
                         f"got {q.device}")
    if q.dim() != 3 or layer_cache.dim() != 5:
        raise ValueError(f"K1 takes q [B, H, D] and layer_cache [2, H_kv, "
                         f"n_blocks, T, D], got {tuple(q.shape)} and "
                         f"{tuple(layer_cache.shape)}")
    return _paged_decode(q[None], layer_cache[None], block_table, seq_lens,
                         "K1", "paged_decode")[0]


def paged_decode_attention_alllayers_cuda(
    qs: torch.Tensor,
    cache: torch.Tensor,
    block_table: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """K4 (``csrc/paged_decode.cu``): every layer's K1 in one launch; same
    signature and layout as ``paged_decode_attention_alllayers_xla``, which
    it runs for CPU tensors.  Its output equals L K1 launches bit for
    bit."""
    if qs.device.type == "cpu":
        return paged_decode_attention_alllayers_xla(qs, cache, block_table,
                                                    seq_lens)
    if qs.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA (or its plain version on the "
                         f"CPU), got {qs.device}")
    if qs.dim() != 4:
        raise ValueError(f"qs must be [L, B, H, D], got {tuple(qs.shape)}")
    return _paged_decode(qs, cache, block_table, seq_lens, "K4",
                         "paged_decode_alllayers")


def _flash(q, k, v, q_offset: int, prefix_pad: int, prefix_len: int,
           counter: str) -> torch.Tensor:
    _check_attention_dtype(q)
    B, Sq, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != D:
        raise ValueError(f"k/v must be [B, Sk, H_kv, {D}], got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"H={H} must be a multiple of H_kv={Hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, q.device, q.dtype)
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    _launch(
        "istpu_flash_attention", q.device,
        torch.cuda.current_stream(q.device).cuda_stream,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hkv, D, q_offset, prefix_pad, prefix_len,
        1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
    )
    _count(counter)
    return out


def flash_causal_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int = 0,
) -> torch.Tensor:
    """K3 (``csrc/flash_attention.cu``): causal GQA attention, query row i at
    key position ``q_offset + i``.  q: [B, Sq, H, D]; k/v: [B, Sk, H_kv, D]
    -> [B, Sq, H, D].  Runs ``causal_attention_xla`` for CPU tensors."""
    if q.device.type == "cpu":
        return causal_attention_xla(q, k, v, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA (or its plain version on the CPU), "
                         f"got {q.device}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return _flash(q, k, v, int(q_offset), -1, 0, "flash_causal")


def flash_prefix_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prefix_pad: int,
    prefix_len: int,
) -> torch.Tensor:
    """K2 (``csrc/flash_attention.cu``, prefix mask): q: [B, Sq, H, D];
    k/v: [B, prefix_pad + Sq, H_kv, D] whose rows [0, prefix_len) are the
    valid prefix, [prefix_len, prefix_pad) bucket slack, and the rest the
    queries' own KV.  ``prefix_len`` is a host int.  Runs the padded-prefix
    mode of ``causal_attention_xla`` for CPU tensors."""
    if q.device.type == "cpu":
        return causal_attention_xla(q, k, v, prefix_pad=prefix_pad,
                                    prefix_len=prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA (or its plain version on the CPU), "
                         f"got {q.device}")
    prefix_pad, prefix_len = int(prefix_pad), int(prefix_len)
    if not 0 <= prefix_len <= prefix_pad:
        raise ValueError(f"need 0 <= prefix_len <= prefix_pad, got "
                         f"{prefix_len}, {prefix_pad}")
    if k.shape[1] != prefix_pad + q.shape[1]:
        raise ValueError(f"k/v must hold prefix_pad + Sq = "
                         f"{prefix_pad + q.shape[1]} rows, got {k.shape[1]}")
    return _flash(q, k, v, 0, prefix_pad, prefix_len, "flash_prefix")
