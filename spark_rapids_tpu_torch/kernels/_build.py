"""Build and load the port's CUDA sources with ``nvcc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on first
use into ``<repo>/build/lib<name>-<source hash>.so`` for ``sm_90a``; the
library is then loaded with ``ctypes``.  A build failure raises with the
compiler's output: there is no fallback.

Each thread counts the builds it ran and the libraries it opened that an
earlier process built (:func:`thread_counts`); the compile observatory
(obs/compile.py) reads the pair around a kernel's first call to tell a
fresh build from a reload.  :func:`warm` is the precompile service's
(sched/precompile.py) build-or-reopen of one library ahead of its first
use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

_loaded: Dict[str, ctypes.CDLL] = {}
# one lock per source: partitions drained on several threads may reach a
# kernel's first use together, while different sources still build in
# parallel
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
# name -> nvcc's output of the build this process made (registers, shared
# memory and spills per kernel, from -Xptxas -v)
compiler_output: Dict[str, str] = {}
# per thread: [nvcc builds run, libraries opened that this process did
# not build]
_tls = threading.local()
# libraries the precompile service made ready (sched/precompile.py)
_warmed: set = set()


def _thread_tally() -> List[int]:
    tally = getattr(_tls, "tally", None)
    if tally is None:
        tally = _tls.tally = [0, 0]
    return tally


def thread_counts() -> Tuple[int, int]:
    """(builds, reloads) on the calling thread so far: ``nvcc`` runs of
    :func:`build`, and libraries :func:`load` opened that an earlier
    process built."""
    tally = _thread_tally()
    return tally[0], tally[1]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_command(name: str, out: Path) -> List[str]:
    """nvcc command line for ``csrc/<name>.cu``; ``-Xptxas -v`` reports
    each kernel's registers, shared memory and spills."""
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / f"{name}.cu")]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(compile_command(name, tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc={proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    compiler_output[name] = proc.stdout + proc.stderr
    _thread_tally()[0] += 1
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
            if name not in compiler_output:
                _thread_tally()[1] += 1
    return lib


def warm(name: str) -> str:
    """Make ``csrc/<name>.cu``'s library ready ahead of its first use:
    the precompile service's replay step.  Returns ``fresh`` when this
    call ran ``nvcc`` (the library is written to the build directory),
    else ``persistent`` (an earlier process built it, or this process
    already had it open).  The library then counts as warmed for the
    compile observatory's tier (obs/compile.classify_tier)."""
    builds = _thread_tally()[0]
    load(name)
    _warmed.add(name)
    return "fresh" if _thread_tally()[0] > builds else "persistent"


def warmed() -> frozenset:
    """Names of the libraries :func:`warm` made ready in this process."""
    return frozenset(_warmed)

