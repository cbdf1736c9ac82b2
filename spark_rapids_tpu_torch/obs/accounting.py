"""Per-tenant resource metering: the ResourceLedger.

Copied whole from ``spark_rapids_tpu/obs/accounting.py``, its imports
retargeted.  The port charges ``kernel.dispatches`` (exec/kernel_cache),
``kernel.compile.wallNs`` (obs/compile), ``scan.bytesWalked``
(io/parquet_meta), ``scan.bytesUploaded`` (io/parquet_fused), and the
queue wait and ``hbm.byteSeconds`` (sched/service); the query service
registers each query under ``("(in-process)", "digest:<16 hex>")``.
The shuffle wire bytes and the result-cache charges come with the
modules that own them.

ROADMAP item 1's per-tenant quotas and item 2's elastic executors both
need a trustworthy answer to "who is consuming the chip".  The ledger
attributes every metered resource — kernel dispatches, compile wall,
scan bytes walked/uploaded, shuffle wire bytes, result-cache
hits/misses, HBM high-water byte-seconds, queue wait — to the owning
**tenant**: ``(session_id, statement_template | plan_digest)``.
In-process submissions bill to the ``(in-process)`` session;
charges fired on a thread that carries no query token bill to the
``(unattributed)`` tenant row, so the accounting identity

    sum over tenant rows of metric M  ==  total charged at M's sites

holds **by construction** — nothing is dropped, nothing is counted
twice (the obs/compile accounting-closure idiom).  Every charging site
bumps the global registry counter and the ledger with the same ``n``,
so the CI exactness gate can assert the per-tenant sum against the
global counter delta over any window.

Attribution mechanics (the compile-observatory pattern,
obs/compile.py):

* ``register_query`` (sched/service.submit) binds qid -> tenant for
  the query's lifetime; ``charge`` resolves the current qid from the
  thread's installed CancelToken (sched/cancel.py) via a lazy
  function-level import, keeping obs an import leaf.
* Charges accumulate on the per-query record and **fold into the
  tenant row** at ``finish_query`` (or at eviction — finished records
  only, bounded table), so a mid-flight settle can still re-split
  them.
* **Single-flight followers** (sched.dedup.*): ``settle_flight``
  splits the leader's bill equally across leader + followers — dedup
  must not hide a tenant's true consumption.  Shares are floats; they
  sum exactly to the leader's original bill.
* **Batched prepared statements** (serve/batching.py): the coalesced
  execution registers with ``hold=True`` so its bill is retained
  un-folded; ``settle_batch`` splits it across the member tenants by
  per-binding result-row share.

Disabled path (``obs.accounting.enabled=false``): every public entry
is one module-bool check, the existing ``obs.compile`` pattern.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.obs import registry as obsreg

_MAX_QUERIES = 256          # per-query records (finished evict first)
_MAX_TENANTS = 512          # tenant rows (LRU-fold into "(evicted)")
_MAX_TEMPLATES = 256        # distinct SLO template labels

IN_PROCESS = "(in-process)"
UNATTRIBUTED = ("-", "(unattributed)")
EVICTED = ("-", "(evicted)")

_enabled = True             # obs.accounting.enabled default
_LOCK = threading.Lock()
_queries: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
_tenants: "OrderedDict[Tuple[str, str], Dict[str, Any]]" = OrderedDict()
# template label -> short metric key (slo.latencyMs.tpl.<key>), capped
_template_keys: Dict[str, str] = {}

# log-spaced millisecond boundaries shared by every SLO histogram
SLO_BOUNDS_MS = obsreg.DEFAULT_MS_BOUNDS


def configure(enabled: bool) -> None:
    """Session init (last session wins, the trace/recorder idiom)."""
    global _enabled
    _enabled = bool(enabled)


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    """Test hook: drop all ledger state."""
    with _LOCK:
        _queries.clear()
        _tenants.clear()
        _template_keys.clear()


def _current_query_id() -> Optional[int]:
    # lazy import: sched imports obs, never the reverse (the
    # obs/compile layering note)
    try:
        from spark_rapids_tpu_torch.sched import cancel as _cancel
        tok = _cancel.current()
        return tok.query_id if tok is not None else None
    except Exception:
        return None


def tenant_of(session_id: Optional[str], template: Optional[str],
              plan_digest: Optional[str]) -> Tuple[str, str]:
    """The ledger's tenant key: owning session x workload identity.
    Prepared statements bill under their template; ad-hoc plans under
    their canonical digest."""
    sid = str(session_id) if session_id else IN_PROCESS
    if template:
        return (sid, str(template))
    if plan_digest:
        return (sid, f"digest:{str(plan_digest)[:16]}")
    return (sid, "(ad-hoc)")


def _tenant_row_locked(tenant: Tuple[str, str]) -> Dict[str, Any]:
    row = _tenants.get(tenant)
    if row is None:
        row = _tenants[tenant] = {"usage": {}, "queries": 0,
                                  "first_unix": time.time(),
                                  "last_unix": time.time()}
        # LRU bound: fold the coldest row into "(evicted)" so the
        # accounting identity survives the eviction
        while len(_tenants) > _MAX_TENANTS:
            old_key, old = next(iter(_tenants.items()))
            if old_key == tenant:
                break
            del _tenants[old_key]
            ev = _tenants.get(EVICTED)
            if ev is None:
                ev = _tenants[EVICTED] = {
                    "usage": {}, "queries": 0,
                    "first_unix": time.time(),
                    "last_unix": time.time()}
            for m, v in old["usage"].items():
                ev["usage"][m] = ev["usage"].get(m, 0.0) + v
            ev["queries"] += old["queries"]
            ev["last_unix"] = time.time()
    else:
        _tenants.move_to_end(tenant)
        row["last_unix"] = time.time()
    return row


def _add_usage(usage: Dict[str, float], metric: str, n: float) -> None:
    usage[metric] = usage.get(metric, 0.0) + float(n)


def _evict_queries_locked() -> None:
    """Bound the per-query table by folding FINISHED (or abandoned
    held) records into their tenant rows oldest first — the
    obs/compile eviction contract: live records survive, and nothing
    escapes the tenant table."""
    if len(_queries) <= _MAX_QUERIES:
        return
    for qid in list(_queries):
        rec = _queries[qid]
        if rec["finished"] or rec["hold"]:
            _fold_locked(rec)
            del _queries[qid]
            if len(_queries) <= _MAX_QUERIES:
                return


def _fold_locked(rec: Dict[str, Any]) -> None:
    if not rec["usage"]:
        return
    row = _tenant_row_locked(rec["tenant"])
    for m, v in rec["usage"].items():
        _add_usage(row["usage"], m, v)
    rec["usage"] = {}


def register_query(query_id: int, session_id: Optional[str] = None,
                   template: Optional[str] = None,
                   plan_digest: Optional[str] = None,
                   hold: bool = False) -> None:
    """Bind qid -> tenant for the query's lifetime (sched/service
    .submit, beside the compile observatory's register_query).
    ``hold=True`` marks a coalesced batch execution whose bill must
    stay un-folded until ``settle_batch`` re-splits it."""
    if not _enabled or query_id is None:
        return
    tenant = tenant_of(session_id, template, plan_digest)
    with _LOCK:
        rec = _queries.get(query_id)
        if rec is None:
            rec = _queries[query_id] = {
                "tenant": tenant, "usage": {}, "finished": False,
                "hold": bool(hold)}
            _evict_queries_locked()
        else:
            rec["tenant"] = tenant
            rec["hold"] = bool(hold)
        row = _tenant_row_locked(tenant)
        row["queries"] += 1


def charge(metric: str, n: float = 1.0) -> None:
    """Attribute ``n`` of ``metric`` to the query installed on the
    current thread; a token-less thread bills "(unattributed)" so the
    sum identity holds regardless."""
    if not _enabled:
        return
    charge_qid(_current_query_id(), metric, n)


def charge_qid(query_id: Optional[int], metric: str, n: float) -> None:
    if not _enabled or not n:
        return
    with _LOCK:
        if query_id is not None:
            rec = _queries.get(query_id)
            if rec is None:
                # attribution without registration (a path that
                # bypassed sched/service): track anyway, tenant unknown
                rec = _queries[query_id] = {
                    "tenant": UNATTRIBUTED, "usage": {},
                    "finished": False, "hold": False}
                _evict_queries_locked()
            _add_usage(rec["usage"], metric, n)
            return
        row = _tenant_row_locked(UNATTRIBUTED)
        _add_usage(row["usage"], metric, n)


def charge_tenant(session_id: Optional[str], template: Optional[str],
                  plan_digest: Optional[str], metric: str,
                  n: float = 1.0) -> None:
    """Direct tenant charge for work that never passes the scheduler
    (the serve result-cache hit path)."""
    if not _enabled or not n:
        return
    tenant = tenant_of(session_id, template, plan_digest)
    with _LOCK:
        row = _tenant_row_locked(tenant)
        _add_usage(row["usage"], metric, n)


def finish_query(query_id: int) -> None:
    """Fold the query's accumulated bill into its tenant row
    (idempotent; held batch executions keep their bill for
    settle_batch).  Never raises."""
    if not _enabled:
        return
    try:
        with _LOCK:
            rec = _queries.get(query_id)
            if rec is None:
                return
            rec["finished"] = True
            if not rec["hold"]:
                _fold_locked(rec)
            _evict_queries_locked()
    except Exception:
        pass


def settle_flight(leader_qid: int,
                  follower_qids: Sequence[int]) -> None:
    """Split the leader's CURRENT bill equally across leader +
    followers (sched/service._finish_exec, before the followers
    resolve).  Follower shares land on the followers' own records and
    fold into their tenants at their finish — shares sum exactly to
    the leader's original bill."""
    if not _enabled or not follower_qids:
        return
    with _LOCK:
        leader = _queries.get(leader_qid)
        if leader is None or not leader["usage"]:
            return
        share = 1.0 / (1 + len(follower_qids))
        shared = {m: v * share for m, v in leader["usage"].items()}
        leader["usage"] = dict(shared)
        for fq in follower_qids:
            rec = _queries.get(fq)
            if rec is None:
                rec = _queries[fq] = {
                    "tenant": UNATTRIBUTED, "usage": {},
                    "finished": False, "hold": False}
            for m, v in shared.items():
                _add_usage(rec["usage"], m, v)
        _evict_queries_locked()
    obsreg.get_registry().inc("obs.accounting.flightSettles")


def settle_batch(exec_qid: int,
                 members: Sequence[Tuple[Tuple[str, str], float]]
                 ) -> None:
    """Split a held coalesced execution's bill across the member
    tenants by weight (per-binding result-row share;
    serve/batching._run_coalesced).  Weights normalize; zero/absent
    weights degrade to an equal split.  The exec record's hold drops
    so it can no longer double-bill."""
    if not _enabled or not members:
        return
    with _LOCK:
        rec = _queries.get(exec_qid)
        if rec is None:
            return
        usage = rec["usage"]
        rec["usage"] = {}
        rec["hold"] = False
        if rec["finished"]:
            _evict_queries_locked()
        total_w = sum(max(0.0, float(w)) for _, w in members)
        n = len(members)
        for tenant, w in members:
            frac = (max(0.0, float(w)) / total_w) if total_w > 0 \
                else 1.0 / n
            if frac <= 0.0:
                continue
            row = _tenant_row_locked(tuple(tenant))
            for m, v in usage.items():
                _add_usage(row["usage"], m, v * frac)
    obsreg.get_registry().inc("obs.accounting.batchSettles")


# ---------------------------------------------------------------------------
# SLO histogram helper (bounded per-template cardinality)
# ---------------------------------------------------------------------------

def template_key(label: str) -> str:
    """Short stable metric-name key for a statement template / digest
    label, capped at _MAX_TEMPLATES distinct labels (overflow pools
    under "other")."""
    with _LOCK:
        key = _template_keys.get(label)
        if key is None:
            if len(_template_keys) >= _MAX_TEMPLATES:
                return "other"
            key = hashlib.sha1(
                label.encode("utf-8", "replace")).hexdigest()[:10]
            _template_keys[label] = key
        return key


def template_labels() -> Dict[str, str]:
    """key -> full template label (the /slo payload's legend)."""
    with _LOCK:
        return {v: k for k, v in _template_keys.items()}


def observe_slo(metric: str, ms: float,
                template: Optional[str] = None) -> None:
    """One SLO observation: the global bucketed histogram plus the
    per-template series when a template label is known.  One bool when
    the ledger is off."""
    if not _enabled:
        return
    reg = obsreg.get_registry()
    reg.observe_bucket(metric, ms)
    if template:
        reg.observe_bucket(f"{metric}.tpl.{template_key(template)}", ms)


# ---------------------------------------------------------------------------
# the /tenants surface
# ---------------------------------------------------------------------------

def snapshot() -> Dict[str, Any]:
    """Ledger table under ONE lock (the /compiles snapshot idiom):
    tenant rows with folded usage PLUS each live query's un-folded
    bill merged in, so a mid-flight scrape still sums to the global
    counters."""
    with _LOCK:
        merged: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for tenant, row in _tenants.items():
            merged[tenant] = {"usage": dict(row["usage"]),
                              "queries": row["queries"],
                              "first_unix": row["first_unix"],
                              "last_unix": row["last_unix"]}
        live = 0
        for rec in _queries.values():
            if not rec["usage"]:
                continue
            live += 1
            t = rec["tenant"]
            m = merged.get(t)
            if m is None:
                m = merged[t] = {"usage": {}, "queries": 0,
                                 "first_unix": time.time(),
                                 "last_unix": time.time()}
            for k, v in rec["usage"].items():
                m["usage"][k] = m["usage"].get(k, 0.0) + v
        rows: List[Dict[str, Any]] = []
        for (sid, workload), m in merged.items():
            rows.append({"session_id": sid, "workload": workload,
                         **m})
    rows.sort(key=lambda r: -sum(r["usage"].values()))
    return {"enabled": _enabled, "tenants": rows,
            "live_queries": live, "tenant_count": len(rows)}


def top_talkers(base: Optional[Dict[str, Any]] = None,
                limit: int = 5) -> List[Dict[str, Any]]:
    """Tenant rows ranked by window consumption: current snapshot
    minus ``base`` (a previous snapshot; None ranks lifetime totals)
    — the sentinel attaches this to its breach bundles."""
    cur = snapshot()["tenants"]
    base_usage = {}
    for r in (base or {}).get("tenants", []):
        base_usage[(r["session_id"], r["workload"])] = r["usage"]
    out = []
    for r in cur:
        prev = base_usage.get((r["session_id"], r["workload"]), {})
        delta = {m: v - prev.get(m, 0.0) for m, v in r["usage"].items()
                 if v - prev.get(m, 0.0) > 0}
        if delta:
            out.append({"session_id": r["session_id"],
                        "workload": r["workload"], "window": delta})
    out.sort(key=lambda r: -sum(r["window"].values()))
    return out[:max(1, int(limit))]
