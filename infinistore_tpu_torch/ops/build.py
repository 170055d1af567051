"""Build the CUDA kernels of ``ops/csrc`` at first use and load them.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into its
own shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds, not minutes.  All
sources build in parallel, one ``nvcc`` each, started together.

Libraries land in ``build/istpu_torch_kernels/`` beside the package, named by
a digest of their sources and flags, so an edited source never loads a stale
library.  Nothing here runs at import: the first launch on a CUDA tensor
calls ``load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "istpu_torch_kernels"

# one library per source; the shared header is part of every digest
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "flash_attention": "flash_attention.cu",
}
HEADERS = ("attention_common.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# the nvcc processes this process started: a tensor-parallel rank spawned
# after its leader built the libraries starts none
NVCC_RUNS = 0
# one build at a time in a process: engines on several threads (an
# in-process fleet) may launch their first kernel at once
_BUILD_LOCK = threading.Lock()


def _nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME/bin): the port's CUDA kernels are "
        "built from source at first use"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every library not yet built, one ``nvcc`` per source, all
    started together.  Returns name -> library path.  The assembler's
    register/shared-memory report of each build is kept beside its library
    as ``<library>.log``.  Raises with the compiler's output on failure.
    Threads of one process build one at a time, so a library is compiled
    once however many of them ask for it."""
    with _BUILD_LOCK:
        return _build_missing()


def _build_missing() -> Dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in SOURCES}
    global NVCC_RUNS
    procs = {}
    for name, so in paths.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        NVCC_RUNS += 1
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{log}")
            continue
        paths[name].with_suffix(".log").write_text(log)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The assembler's report (registers, shared memory, spills) of one
    library's build, once built."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass_counts(name: str, ops=("HGMMA", "HMMA")) -> Dict[str, Dict[str, int]]:
    """Per kernel of the built library ``name`` (mangled name): how many
    SASS instructions of each opcode in ``ops`` ``cuobjdump -sass`` finds.
    HGMMA is ``wgmma`` on the tensor cores, HMMA ``mma.sync``."""
    cuobjdump = Path(_nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building every library first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        for n, path in build_all().items():
            _LIBS.setdefault(n, ctypes.CDLL(str(path)))
        lib = _LIBS[name]
    return lib
