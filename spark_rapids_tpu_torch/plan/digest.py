"""Canonical plan digest: one stable identity per logical query shape.

The port's copy of ``spark_rapids_tpu/plan/digest.py``, whole, with only
its imports retargeted: class and attribute names, ``expr_sig`` and the
Arrow IPC content hash carry over, so a plan built the same way gives
the same hex digest in both packages.

The engine already canonicalizes *expressions* for the process-wide
kernel cache (``exec/kernel_cache.expr_sig``: ordinals and dtypes,
never column/alias names — the alias-dedup contract).  This module
lifts that same canonicalization to whole logical plans:

  * :func:`plan_digest` — a stable hex digest of the plan's canonical
    structure.  Insensitive to aliasing/renaming (two queries that
    differ only in intermediate or output names share a digest, exactly
    as they share compiled kernels), sensitive to everything that can
    change the *result*: literal values, source files, join kinds,
    sort orders, limits.
  * :func:`plan_fingerprint` — the digest plus what the serving tier's
    result-set cache needs to key on it safely: the referenced file
    sources (stamped at lookup time by ``io/scan_cache``) and a
    ``cacheable`` verdict (False for non-deterministic expressions,
    opaque user functions, or sources whose content can't be stamped).

Surfaces: the ``plan_digest`` column on QueryProfile and the
``/queries`` table (obs), the result-set cache key (serve), and the
prepared-statement template identity.
"""

from __future__ import annotations

import hashlib
import weakref
from dataclasses import dataclass
from typing import Any, Iterator, Optional, Tuple

from spark_rapids_tpu_torch.exec.kernel_cache import expr_sig
from spark_rapids_tpu_torch.expr import ir
from spark_rapids_tpu_torch.plan import logical as lp

# expression classes whose value depends on more than their inputs —
# a plan containing any of these must never be served from a result
# cache (conservative: SparkPartitionID/InputFileName are deterministic
# for a fixed layout, but a cache hit must never be a judgement call)
_NONDETERMINISTIC_EXPRS = frozenset({
    "Rand", "Randn", "MonotonicallyIncreasingID", "Uuid",
    "CurrentTimestamp", "CurrentDate", "Now",
    "PythonUDF", "PandasUDF", "SparkPartitionID", "InputFileName",
})

# content-hash in-memory tables up to this size; beyond it identity
# (not content) keys the digest and the plan is marked non-cacheable
_INMEM_HASH_CAP = 64 << 20

# id(table) -> sha1 of its IPC payload, computed once per object;
# pa.Table is unhashable so WeakKeyDictionary is out — key by id with a
# finalizer evicting the entry when the table dies, so a recycled id
# can never serve another table's hash
_TABLE_HASH: dict = {}

# plan-node attributes that only carry *names* (output labels) or
# redundant unbound copies of bound expressions — never result content
_SKIP_ATTRS = frozenset({
    "children", "raw_groupings", "raw_aggregates",
    "out_names", "blobs", "device_encoded",
})


@dataclass(frozen=True)
class PlanFingerprint:
    """What the result-set cache keys on (see module docstring)."""

    digest: str
    sources: Tuple[str, ...]
    cacheable: bool


# ---------------------------------------------------------------------------
# Expression enumeration (shared by digest, prepared-statement binding)
# ---------------------------------------------------------------------------

def iter_node_exprs(node: lp.LogicalPlan) -> Iterator[ir.Expression]:
    """Every bound expression root hanging off one plan node's public
    attributes (lists/tuples and SortOrder wrappers included)."""
    for k in sorted(vars(node)):
        if k.startswith("_") or k in _SKIP_ATTRS:
            continue
        yield from _exprs_in(vars(node)[k])


def _exprs_in(v: Any) -> Iterator[ir.Expression]:
    if isinstance(v, ir.Expression):
        yield v
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _exprs_in(x)
    elif isinstance(v, lp.SortOrder):
        yield v.expr


def iter_plan_exprs(plan: lp.LogicalPlan) -> Iterator[ir.Expression]:
    """Every bound expression root in the whole plan tree."""
    for node in walk(plan):
        yield from iter_node_exprs(node)


def walk(plan: lp.LogicalPlan) -> Iterator[lp.LogicalPlan]:
    """Every node, first-visit only: plans are DAGs (a CTE referenced
    twice is one shared subtree with two parents), so a naive tree walk
    re-visits shared subtrees once per path and goes exponential on
    stacked CTEs — the same path-counting trap plan/fusion._refcounts
    already fixed for the fusion pass."""
    seen: set = set()

    def _walk(node: lp.LogicalPlan) -> Iterator[lp.LogicalPlan]:
        if id(node) in seen:
            return
        seen.add(id(node))
        yield node
        for c in node.children:
            yield from _walk(c)

    return _walk(plan)


# ---------------------------------------------------------------------------
# Canonical structure
# ---------------------------------------------------------------------------

def _table_sig(table) -> Tuple:
    """Content signature of an in-memory Arrow table (InMemoryScan):
    IPC-payload hash for small tables (cached per object), identity for
    large ones — identity keeps the digest stable within a process but
    bars result caching (see :func:`plan_fingerprint`)."""
    meta = (tuple(table.schema.names),
            tuple(str(t) for t in table.schema.types),
            int(table.num_rows))
    if table.nbytes > _INMEM_HASH_CAP:
        return ("inmem-id", meta, id(table))
    key = id(table)
    h = _TABLE_HASH.get(key)
    if h is None:
        import pyarrow as pa
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as w:
            for b in table.to_batches():
                w.write_batch(b)
        h = hashlib.sha1(sink.getvalue()).hexdigest()
        _TABLE_HASH[key] = h
        weakref.finalize(table, _TABLE_HASH.pop, key, None)
    return ("inmem", meta, h)


def _value_sig(v: Any) -> Any:
    """Deterministic hashable signature for non-expression attribute
    values (the plan-level sibling of kernel_cache._value_sig, with
    dict support for scan options)."""
    if isinstance(v, (str, int, float, bool, bytes, type(None))):
        return v
    if isinstance(v, ir.Expression):
        return expr_sig(v)
    if isinstance(v, (list, tuple)):
        return tuple(_value_sig(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((str(k), _value_sig(x)) for k, x in v.items()))
    if isinstance(v, lp.SortOrder):
        return ("SortOrder", expr_sig(v.expr), v.ascending,
                v.nulls_first_resolved)
    if hasattr(v, "name") and not callable(v):       # DType-like
        return getattr(v, "name")
    if callable(v):
        return ("callable", id(v))
    return ("repr", type(v).__name__, repr(v)[:128])


def _node_hash(node: lp.LogicalPlan, memo: dict) -> str:
    """Merkle-style per-node hash: children contribute their HASHES,
    not their expanded signatures, and shared subtrees hash once (memo
    by node identity).  Plans are DAGs — a CTE referenced twice is one
    subtree with two parents — so both a naive tree walk AND an
    expanded-tuple repr go exponential on stacked CTEs (the
    path-counting trap plan/fusion._refcounts already fixed for the
    fusion pass); hashing per node keeps the digest linear in unique
    nodes while preserving structural identity."""
    hit = memo.get(id(node))
    if hit is not None:
        return hit
    parts: list = [type(node).__name__]
    if isinstance(node, lp.InMemoryScan):
        parts.append(_table_sig(node.table))
        parts.append(node.num_partitions)
    elif isinstance(node, lp.FileScan):
        import os
        parts.append(node.fmt)
        roots = node.options.get("source_roots")
        if roots:
            # watched scan: the recorded roots are the dataset's
            # identity.  The expanded snapshot (and its per-file
            # part_values) drifts with every append, so digesting it
            # would hand each session its own digest for the same
            # directory — the source stamps, which key the result
            # cache alongside this digest, carry the content identity
            parts.append(("roots",
                          tuple(os.path.abspath(p) for p in roots)))
            parts.append(_value_sig(
                {k: v for k, v in node.options.items()
                 if k != "part_values"}))
        else:
            parts.append(tuple(os.path.abspath(p) for p in node.paths))
            parts.append(_value_sig(node.options))
        # the inferred schema participates: re-reading the same paths
        # after a rewrite with new columns must change the digest even
        # before the stamps do
        parts.append(tuple((f.name, f.dtype.name)
                           for f in node.schema.fields))
    else:
        for k in sorted(vars(node)):
            if k.startswith("_") or k in _SKIP_ATTRS:
                continue
            parts.append((k, _value_sig(vars(node)[k])))
    parts.append(tuple(_node_hash(c, memo) for c in node.children))
    h = hashlib.sha1(repr(tuple(parts)).encode()).hexdigest()
    memo[id(node)] = h
    return h


def plan_digest(plan: lp.LogicalPlan) -> str:
    """Stable hex digest of the plan's canonical structure (module
    docstring).  Raises only on truly malformed plans; callers on the
    query hot path should use :func:`safe_plan_digest`."""
    return _node_hash(plan, {})


def safe_plan_digest(plan) -> Optional[str]:
    """``plan_digest`` that never raises — observability attribution
    must not be able to fail a query."""
    try:
        return plan_digest(plan)
    except Exception:
        return None


def plan_fingerprint(plan: lp.LogicalPlan) -> PlanFingerprint:
    """Digest + result-cache admissibility (module docstring)."""
    digest = plan_digest(plan)
    sources: list = []
    cacheable = True
    for node in walk(plan):
        if isinstance(node, lp.FileScan):
            import os
            sources.extend(os.path.abspath(p) for p in node.paths)
        elif isinstance(node, lp.InMemoryScan):
            if node.table.nbytes > _INMEM_HASH_CAP:
                cacheable = False
        elif getattr(node, "fn", None) is not None:
            cacheable = False          # opaque user function (pandas/UDF)
        for e in iter_node_exprs(node):
            if ir.collect(e, lambda n: type(n).__name__
                          in _NONDETERMINISTIC_EXPRS):
                cacheable = False
    return PlanFingerprint(digest=digest,
                           sources=tuple(sorted(set(sources))),
                           cacheable=cacheable)
