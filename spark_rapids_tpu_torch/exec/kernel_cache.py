"""Process-wide kernel cache: the dispatch wrapper of every device exec.

Ported from ``spark_rapids_tpu/exec/kernel_cache.py``.  The engine plans
a fresh exec tree for every ``collect()``, so each exec's per-batch
device step is looked up here under a canonical (operator,
expression-tree, parameter) key: ``get_kernel(key, builder)`` builds
the step's callable once per key per process (LRU-bounded at
``_MAX_ENTRIES``) and returns it wrapped, in the reference's order
(:468-481):

  1. observe (obs/compile.py): the first call of each (key, argument
     shape) is timed and recorded as a CompileEvent — in the port its
     wall is the first-call cost (see obs/compile.py), there is no
     ``jax.jit``;
  2. OOM retry: a device out-of-memory error inside the call spills the
     spill catalog's device tier (``mem/spill.hbm_oom_recover``) and
     runs the call once more; any other error is raised as it is;
  3. count: ``kernel.dispatches``, ``kernel.dispatches.<family>`` and,
     at backend-aware sites, ``kernel.dispatches.<family>.<backend>``,
     each charged to the query's tenant (obs/accounting.py).

The cache lives for the whole process, so a builder's callable must not
capture an exec instance, a batch or a plan: call sites pass what the
step reads through a ``types.SimpleNamespace`` shim, and a step that
writes into one of its arguments is registered with ``oom_retry=False``
(a retry would replay a half-written input).

``_shape_sig`` walks the port's own leaves — tensors, ``DeviceBatch``
and ``DeviceColumn`` (the reference's pytree leaves and aux data), and
the attributes of plain objects — giving ``(shape, dtype)`` per leaf.
A host scalar is a 0-d leaf: its value forms no new program.  Strings
and other opaque values are structure, as the reference's static
arguments are.

The replay payload of the precompile corpus (``_replay_payload``) names
the ``csrc`` libraries a program's first call launched kernels from
(``kernels/backend.capture_begin``), in place of the reference's
pickled jax traceable.  The reference's JAX-only parts have no
counterpart: ``jax.jit`` and its keyword arguments,
``_no_persistent_cache`` (a jax 0.4.37 donation bug), ``tile_plan`` (the
Pallas tiler's VMEM plans) and the legacy ``SRT_COMPILE_LOG`` ledger.
"""

from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from typing import Any, Callable

import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.expr import ir

_MAX_ENTRIES = 1024
_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_LOCK = threading.Lock()
# objects keyed by identity in _value_sig; pinned so CPython can't hand
# their address to a different value while a cache key references it
_ID_PINNED: dict = {}


# output-name attributes cannot change a program: a BoundReference reads
# by ordinal and an Alias only labels its child, so identical projections
# under different aliases share one kernel
_NAME_ATTRS = ("ref_name", "alias", "attr_name")


def expr_sig(e) -> Any:
    """Canonical hashable signature of an expression tree (class, dtype,
    scalar params, children) — the kernel-cache key component for any
    closed-over expression.  Canonical: ordinals and dtypes only, never
    column/alias names."""
    if e is None:
        return None
    if isinstance(e, ir.Expression):
        parts = [type(e).__name__,
                 e.dtype.name if e.dtype is not None else "?",
                 bool(e.nullable)]
        for k in sorted(e.__dict__):
            if k in ("children", "dtype", "nullable") or k in _NAME_ATTRS:
                continue
            parts.append((k, _value_sig(e.__dict__[k])))
        parts.append(tuple(expr_sig(c) for c in e.children))
        return tuple(parts)
    return _value_sig(e)


def _value_sig(v) -> Any:
    if isinstance(v, (str, int, float, bool, bytes, type(None))):
        return v
    if isinstance(v, (list, tuple)):
        return tuple(_value_sig(x) for x in v)
    if isinstance(v, ir.Expression):
        return expr_sig(v)
    import numpy as _np
    if isinstance(v, _np.ndarray):
        # repr() truncates large arrays ('...') so two big IN-lists could
        # collide; hash the full buffer instead.
        import hashlib
        return ("ndarray", str(v.dtype), v.shape,
                hashlib.sha1(_np.ascontiguousarray(v).tobytes())
                .hexdigest())
    if hasattr(v, "name") and not callable(v):  # DType-like
        return getattr(v, "name")
    if callable(v):
        # UDF payloads etc. — unique per object, no cross-instance reuse
        return ("callable", id(v))
    d = getattr(v, "__dict__", None)
    if d is not None:  # WindowFrame / SortOrder-like value objects
        return (type(v).__name__,) + tuple(
            (k, _value_sig(x)) for k, x in sorted(d.items()))
    # unknown opaque object: content hash when picklable; identity as a
    # last resort — with the object PINNED so its address can't be
    # recycled into a different value aliasing this cache key
    try:
        import hashlib
        import pickle
        return ("pickle", type(v).__name__,
                hashlib.sha1(pickle.dumps(v)).hexdigest())
    except Exception:
        _ID_PINNED.setdefault(id(v), v)
        return ("id", type(v).__name__, id(v))


def exprs_sig(exprs) -> Any:
    return tuple(expr_sig(e) for e in exprs)


# ---------------------------------------------------------------------------
# argument signatures: the port's leaf walk
# ---------------------------------------------------------------------------

def _dtype_name(d) -> str:
    s = str(d)
    return s[6:] if s.startswith("torch.") else s


def _leaf(t, leaves: list) -> str:
    leaves.append((tuple(t.shape), _dtype_name(t.dtype)))
    return "*"


def _flatten(x, leaves: list) -> Any:
    """The static structure of ``x`` (the reference's treedef), appending
    one ``(shape, dtype)`` per array leaf to ``leaves``."""
    if isinstance(x, torch.Tensor):
        return _leaf(x, leaves)
    if isinstance(x, DeviceColumn):
        for t in (x.data, x.validity, x.lengths, x.elem_validity):
            if t is not None:
                _leaf(t, leaves)
        return ("col", x.dtype.name, x.lengths is not None,
                x.elem_validity is not None, x.vbits, x.nonnull)
    if isinstance(x, DeviceBatch):
        cols = tuple(_flatten(c, leaves) for c in x.columns)
        nr = x.num_rows
        if isinstance(nr, torch.Tensor):
            _leaf(nr, leaves)
        else:
            # the reference's flatten makes a host count an int32 scalar
            leaves.append(((), "int32"))
        return ("batch", tuple(x.names), x._capacity, cols)
    if x is None or isinstance(x, (str, bytes)):
        return x
    if isinstance(x, bool):
        leaves.append(((), "bool"))
        return "*"
    if isinstance(x, int):
        leaves.append(((), "int64"))
        return "*"
    if isinstance(x, float):
        leaves.append(((), "float64"))
        return "*"
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _flatten(v, leaves))
                              for k, v in x.items()))
    if isinstance(x, dt.DType):
        return x.name
    d = getattr(x, "__dict__", None)
    if d is not None and not callable(x):
        # a plain object (ColVal, a join's probe tables): its attributes
        return (type(x).__name__, tuple((k, _flatten(v, leaves))
                                        for k, v in d.items()))
    # anything else by its type: a repr could read a tensor's values
    return type(x).__name__


def _shape_sig(args, kwargs):
    """(structure, leaves) of one call's arguments: the unit of "first
    call" for the observe wrapper."""
    leaves: list = []
    tree = _flatten((args, kwargs), leaves)
    return (tree, tuple(leaves))


class _ShapeSeen:
    """Per-wrapper first-call-per-shape detector: ``claim`` marks and
    returns first atomically, so a shape fires at most once even under
    races.  (The reference's ``peek``/``mark`` pair serves only its
    JAX-only ``_no_persistent_cache``.)"""

    def __init__(self):
        self._seen = set()
        self._lock = threading.Lock()

    def claim(self, sig) -> bool:
        """True exactly once per sig (atomic check-and-mark)."""
        with self._lock:
            if sig in self._seen:
                return False
            self._seen.add(sig)
            return True


def _replay_payload(libraries, key: Any, leaves) -> "str | None":
    """The precompile corpus's replay payload of one program: a JSON
    string naming the ``csrc`` libraries its step launched kernels from,
    with the program's key and signature; None when it launched none
    (replay counts it as skipped)."""
    if not libraries:
        return None
    import json
    from spark_rapids_tpu_torch.obs import compile as obscompile
    return json.dumps({"libraries": sorted(libraries),
                       "key": repr(key)[:200],
                       "signature": obscompile.canonical_signature(leaves)},
                      sort_keys=True)


def load_replay_payload(payload: str) -> dict:
    """Inverse of :func:`_replay_payload` (the precompile service's
    decode half; lives here so the payload format has one owner).
    Raises ValueError on a payload that names no library."""
    import json
    spec = json.loads(payload)
    libs = spec.get("libraries") if isinstance(spec, dict) else None
    if not libs or not all(isinstance(n, str) for n in libs):
        raise ValueError(f"replay payload names no library: {payload!r}")
    return spec


def _observe_compiles(key: Any, fn: Callable,
                      backend: str = None) -> Callable:
    """Compile-observatory wrapper (obs/compile.py): the first call of
    each (key, arg-shape) program is timed on the host clock and recorded
    as a CompileEvent with its tier, backend, and the triggering query's
    id and plan digest.  Wraps the step DIRECTLY (inside the OOM/dispatch
    counter wrappers) so the measured wall is the step, not the counters;
    an OOM-retry replay of the same shape is not a first call and never
    re-records.

    Installed only when the observatory is enabled at BUILD time
    (get_kernel).  Once installed, the wrapper tracks first calls even
    through a mid-process disable (``record_compile`` itself no-ops
    then), so a later re-enable cannot report an already-seen shape's
    next dispatch as a first call.  Kernels BUILT while disabled stay
    unobserved for their lifetime."""
    from spark_rapids_tpu_torch.kernels import backend as kb
    from spark_rapids_tpu_torch.obs import compile as obscompile
    fam = _family(key)
    bk = backend or ("pallas" if "pallas" in str(key) else "xla")
    seen = _ShapeSeen()

    def wrapped(*args, **kwargs):
        sig = _shape_sig(args, kwargs)
        if not seen.claim(sig):
            return fn(*args, **kwargs)
        probe = obscompile.probe_begin()
        cap = kb.capture_begin()
        t0 = _time.perf_counter_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            # record in finally: a first call that raises (a device OOM)
            # still paid its first-call cost, and the retry is no first
            # call
            dur = _time.perf_counter_ns() - t0
            libs = sorted({n.split(".", 1)[0]
                           for n in kb.capture_end(cap)})
            replay = None
            if obscompile.corpus_path() and \
                    obscompile.corpus_replay_enabled():
                replay = _replay_payload(libs, key, sig[1])
            obscompile.record_compile(
                key=key, family=fam, backend=bk, leaves=sig[1],
                t0_ns=t0, dur_ns=dur,
                tier=obscompile.classify_tier(probe, libs),
                replay=replay)
    return wrapped


def _with_oom_recovery(fn, family: str = "other"):
    """Retry a kernel dispatch once after a device out-of-memory error,
    with the spill catalog's synchronous device-tier eviction in between
    (the RMM onAllocFailure retry loop, DeviceMemoryEventHandler.scala:
    42-70, restructured for an allocator the engine doesn't own).

    The retry runs after the handler has ended, so the failed attempt's
    frames, and the tensors they hold, are released before it allocates.
    ``kernel.oomRetries.<family>`` names the family that retried (a
    port-side counter beside the reference's ``mem.oomRetries``)."""
    def run(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            from spark_rapids_tpu_torch.mem import spill as _spill
            if not _spill.hbm_oom_recover(e):
                raise
        from spark_rapids_tpu_torch.obs import registry as _obsreg
        _obsreg.get_registry().inc(f"kernel.oomRetries.{family}")
        return fn(*args, **kwargs)
    return run


def _family(key: Any) -> str:
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return "other"


def _count_dispatches(key: Any, fn: Callable,
                      backend: str = None) -> Callable:
    """Per-call registry counters: ``kernel.dispatches`` is the ground
    truth the fusion layer's dispatch-reduction claims are measured
    against.  Backend-aware call sites also tag the family counter with
    the backend in effect (``kernel.dispatches.<family>.<pallas|xla>``):
    a ``.pallas`` dispatch ran with the hand kernels requested, and
    ``kernels/backend.launches`` / ``fallbacks`` say which of them
    launched."""
    from spark_rapids_tpu_torch.obs import accounting as _acct
    from spark_rapids_tpu_torch.obs import registry as _obsreg
    fam = _family(key)
    pairs = [("kernel.dispatches", 1), (f"kernel.dispatches.{fam}", 1)]
    if backend:
        pairs.append((f"kernel.dispatches.{fam}.{backend}", 1))
    pairs = tuple(pairs)

    def wrapped(*args, **kwargs):
        _obsreg.get_registry().inc_many(*pairs)
        # ledger: every dispatch bills the owning tenant with the SAME
        # n as the global counter
        _acct.charge("kernel.dispatches", 1)
        return fn(*args, **kwargs)
    return wrapped


def get_kernel(key: Any, builder: Callable[[], Callable],
               oom_retry: bool = True, backend: str = None) -> Callable:
    """Return the cached step for ``key``, building it via ``builder`` on
    first use (LRU-bounded).

    ``oom_retry=False`` skips the OOM-retry wrapper — required when the
    step writes into one of its arguments (a retry would replay an input
    the failed call may already have changed).

    ``backend`` tags this kernel's per-dispatch family counter with the
    kernel backend ('pallas'/'xla') at backend-aware call sites; the
    backend must already be folded into ``key`` by the caller.

    Cache-tier counters: an in-memory hit bumps ``kernel.cache.memHits``
    (``kernel.cache.hits`` is its legacy alias, per family too); a miss
    invokes the builder (``kernel.cache.misses``, distinct KEYS built),
    after which each first (key, shape) call counts as
    ``kernel.cache.compiles`` or ``kernel.cache.persistentHits`` through
    obs/compile.py — one key can see several shapes, so misses is not
    the sum of the two."""
    from spark_rapids_tpu_torch.obs import registry as _obsreg
    fam = _family(key)
    with _LOCK:
        fn = _CACHE.get(key)
        if fn is not None:
            _CACHE.move_to_end(key)
            _obsreg.get_registry().inc_many(
                ("kernel.cache.hits", 1),
                (f"kernel.cache.hits.{fam}", 1),
                ("kernel.cache.memHits", 1))
            return fn
    _obsreg.get_registry().inc_many(
        ("kernel.cache.misses", 1), (f"kernel.cache.misses.{fam}", 1))
    fn = builder()
    from spark_rapids_tpu_torch.obs import compile as _obscompile
    if _obscompile.is_enabled():
        fn = _observe_compiles(key, fn, backend)
    if oom_retry:
        fn = _with_oom_recovery(fn, fam)
    fn = _count_dispatches(key, fn, backend)
    with _LOCK:
        cur = _CACHE.setdefault(key, fn)
        if len(_CACHE) > _MAX_ENTRIES:
            _CACHE.popitem(last=False)
    return cur


def clear() -> None:
    _CACHE.clear()
    _ID_PINNED.clear()


def clear_compile_state() -> None:
    """Drop every cached step so what their closures hold is released."""
    import gc
    clear()
    gc.collect()


_maps_calls = 0
_maps_guard_disabled = False


def _count_maps() -> int:
    with open("/proc/self/maps", "rb") as f:
        return f.read().count(b"\n")


def maybe_clear_for_map_pressure(threshold: int = 40000,
                                 every: int = 16,
                                 force_check: bool = False) -> bool:
    """Executor-longevity guard: a long-lived process that keeps mapping
    memory would hit ``vm.max_map_count`` (65530) and die.  Samples the
    process's own memory map every ``every`` calls and clears the cached
    steps past ``threshold``; if clearing doesn't reduce the count
    (mappings owned by something else), the guard disables itself
    instead of thrashing rebuilds."""
    global _maps_calls, _maps_guard_disabled
    if _maps_guard_disabled:
        return False
    _maps_calls += 1
    if not force_check and _maps_calls % every:
        return False
    try:
        n = _count_maps()
    except OSError:
        _maps_guard_disabled = True
        return False
    if n <= threshold:
        return False
    clear_compile_state()
    try:
        if _count_maps() > 0.9 * threshold:
            _maps_guard_disabled = True
    except OSError:
        _maps_guard_disabled = True
    return True
