"""Kernel-backend selection, and the launch and fallback counters of the
port's hand-written kernels.

Ported from ``spark_rapids_tpu/kernels/backend.py`` (``configure``,
``default_backend``, ``resolve`` :121, ``choose`` :242).  The reference
chooses per call site between a Pallas kernel and its XLA composition
(``kernel.backend``).  In the port the planner reads the same key: it
stamps the resolved backend on every plan node (``_kernel_backend``) and
pushes scan filters only under ``pallas`` (plan/overrides.py), so one
conf gives one plan shape in both packages.  The kernels themselves
route by the tensor's device: a CUDA tensor of a shape the kernel covers
launches the kernel (or raises), a CPU tensor takes the kernel's plain
torch version.

What a call site could not hand to its kernel is a *fallback*, counted
with its reason by :func:`choose` exactly where the reference falls back
to XLA (for example a 2-D string payload in the segmented reduction).
Every kernel launch is counted by name.  Both counters are plain ints
behind one lock (partitions may drain on several threads), so a run can
show that its main path went through the kernels.  A thread may also
capture the names it launches (:func:`capture_begin`): the compile
observatory names the kernel libraries a program's step loads that way.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set

XLA = "xla"
PALLAS = "pallas"

_lock = threading.Lock()
_default_backend = PALLAS
# kernel name -> launches since the last reset_counts()
launches: Dict[str, int] = {}
# "family.reason" -> call sites that took the plain composition
fallbacks: Dict[str, int] = {}
# per thread: the set of kernel names launched inside an open capture
# (capture_begin / capture_end), None when no capture is open
_tls = threading.local()


def configure(conf) -> None:
    """Session-init hook: validate ``spark.rapids.tpu.kernel.backend`` and
    install it as the process default (every new session re-asserts its
    own conf).  Plans carry their own ``_kernel_backend`` stamp, which
    wins wherever a plan node is in scope."""
    from spark_rapids_tpu_torch import config as cfg
    global _default_backend
    backend = str(conf.get(cfg.KERNEL_BACKEND) or PALLAS).strip().lower()
    if backend not in (XLA, PALLAS):
        raise ValueError(
            f"spark.rapids.tpu.kernel.backend must be 'xla' or "
            f"'pallas', got {backend!r}")
    with _lock:
        _default_backend = backend


def default_backend() -> str:
    with _lock:
        return _default_backend


def resolve(stamped: Optional[str] = None) -> str:
    """The backend in effect at a call site: the plan-stamped value when
    the caller has one (``_kernel_backend``), else the process default."""
    if stamped in (XLA, PALLAS):
        return stamped
    return default_backend()


def selection_snapshot() -> dict:
    """The ``/compiles`` endpoint's selection block (obs/server.py), from
    :data:`fallbacks` and :data:`launches` since the last
    :func:`reset_counts`: the fallbacks under the reference's names
    (``kernel.backend.pallas.fallbacks[.<family>.<reason>]``) and each
    hand kernel's launches (``kernel.backend.launches.<kernel>``, where
    the reference counts its Pallas selections)."""
    with _lock:
        fb, ln = dict(fallbacks), dict(launches)
    out = {f"kernel.backend.pallas.fallbacks.{k}": v for k, v in fb.items()}
    if fb:
        out["kernel.backend.pallas.fallbacks"] = sum(fb.values())
    out.update((f"kernel.backend.launches.{k}", v) for k, v in ln.items())
    return dict(sorted(out.items()))


def choose(family: str, supported: bool, reason: str = "unsupported"
           ) -> str:
    """One call site's route: ``pallas`` (the hand kernel) when it covers
    this shape and dtype, else ``xla`` (the plain torch composition),
    counted as a fallback of ``family`` with ``reason``."""
    if not supported:
        record_fallback(family, reason)
        return XLA
    return PALLAS


def record_launch(name: str) -> None:
    with _lock:
        launches[name] = launches.get(name, 0) + 1
    names = getattr(_tls, "names", None)
    if names is not None:
        names.add(name)


def capture_begin() -> Optional[Set[str]]:
    """Start collecting the kernels this thread launches; pass the
    result to :func:`capture_end`.  Captures nest: an inner capture's
    launches also count in the enclosing one."""
    prev = getattr(_tls, "names", None)
    _tls.names = set()
    return prev


def capture_end(prev: Optional[Set[str]]) -> Set[str]:
    """The kernel names launched on this thread since the matching
    :func:`capture_begin` (``<library>.<kernel>``)."""
    names = _tls.names
    _tls.names = prev
    if prev is not None:
        prev |= names
    return names


def record_fallback(family: str, reason: str) -> None:
    key = f"{family}.{reason}"
    with _lock:
        fallbacks[key] = fallbacks.get(key, 0) + 1


def reset_counts() -> None:
    with _lock:
        launches.clear()
        fallbacks.clear()


def tpu_block(cap: int, base: int) -> int:
    """The element block the reference's TPU tile planner
    (``spark_rapids_tpu/kernels/tiling.py::_build``) gives a capacity:
    ``base`` grown in powers of two toward 128 blocks, at most 2^17
    elements.  Only the reference's gates read it; no CUDA kernel of the
    port is tiled by it."""
    def pow2_ceil(n: int) -> int:
        return 1 << max(int(n) - 1, 0).bit_length()
    b = min(pow2_ceil(cap), 1 << 17, max(base, pow2_ceil(max(cap // 128,
                                                               1))))
    if cap % b:
        b = min(cap, base)
    return b
