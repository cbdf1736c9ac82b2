"""Compile observatory: per-first-call attribution, shape-churn
analytics, and a precompile corpus.

Ported from ``spark_rapids_tpu/obs/compile.py``, its imports retargeted.
Every first call of a (kernel-cache key, argument-shape) program through
``exec/kernel_cache.get_kernel`` records one **CompileEvent**: kernel
family, cache-key repr, canonical shape/dtype signature, backend, the
call's wall, its tier, and the triggering query id and plan digest.

What a "compile" is in the port.  The port's device steps are eager
torch compositions plus the hand-written CUDA kernels under ``csrc/``;
no per-shape program is traced or compiled.  The wall of a first call
is the first-call cost of that (key, shape): lazy CUDA module loads,
allocator growth and, when the call is the first to reach a kernel
library, its ``nvcc`` build or the load of a library an earlier process
built.  The tier reads a thread-local pair of counters that
``kernels/_build.py`` bumps (the reference reads jax's persistent-cache
monitoring events the same way, per thread):

  * ``fresh`` when ``build()`` ran ``nvcc`` inside the window;
  * ``persistent`` when ``load()`` opened a library that an earlier
    process built, or when every library the step launched was made
    ready by the precompile service (``kernels/_build.warm``) before the
    call: the serving path pays no build, as the reference's first call
    after a replay reads the persistent XLA cache;
  * otherwise ``fresh``, the reference's conservative reading.

Events land in a bounded ring plus process-lifetime aggregates:
per-family program/signature-cardinality counts (with a width-bucketed
projection) and a bounded per-query attribution table.  Surfaces:
``kernel.compile`` spans in the Chrome trace, the ``kernel.compile.*``
counters and the ``kernel.compile.wallMs`` histogram, the cache-tier
split ``kernel.cache.memHits`` / ``.persistentHits`` / ``.compiles``,
the profile's "compile" section and ``compile_s``, flight-recorder
``compile.storm`` events when one query records more than
``obs.compile.stormThreshold`` programs (once per query), and the
precompile corpus (``obs.compile.corpusPath``: one JSONL record per
distinct plan digest).

The replay payload of a corpus program (``obs.compile.corpusReplay``,
default on) is the port's reading of the reference's pickled jax
traceable: the port's persistent compile cache is the ``build/``
directory of ``kernels/_build.py``, so the payload is a JSON string
naming the ``csrc`` libraries the program's step launched kernels from,
with the program's key and signature
(``exec/kernel_cache._replay_payload``).  A program that launched no
kernel (every step on the CPU, and the steps without a hand kernel on
the card) carries ``null``; the precompile service counts it as
``skipped``.

Disabled path (``obs.compile.enabled=false``): the get_kernel wrapper
is not installed on kernels built while it is off, and
``record_compile`` is one bool check.  Configuration is process-wide,
last session wins.

Layering: this module imports only obs siblings at load time; the
query's CancelToken (sched/cancel) and the build counters
(kernels/_build) are imported inside the functions that read them.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.obs import trace as obstrace

DEFAULT_RING_EVENTS = 4096
DEFAULT_STORM_THRESHOLD = 64

# bounds on the process-lifetime aggregates: headroom, not expected
# operation — past them a family's signature sets stop growing and flag
# overflow (counts keep accumulating; only *distinctness* saturates)
_MAX_SIGS_PER_FAMILY = 8192
_MAX_QUERIES = 256
_MAX_PROGRAMS_PER_QUERY = 1024

TIER_FRESH = "fresh"
TIER_PERSISTENT = "persistent"

_enabled = True                       # obs.compile.enabled default
_storm_threshold = DEFAULT_STORM_THRESHOLD
_corpus_path = ""
_corpus_replay = True                 # obs.compile.corpusReplay default

_LOCK = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_RING_EVENTS)
_seq = 0
# family -> {programs, fresh, persistent, wall_ns, sigs, bucketed,
#            sig_overflow}
_families: Dict[str, Dict[str, Any]] = {}
# query id -> {digest, compiled, persistent, wall_ns, storm, programs}
_queries: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
# accounting closure for the per-query table: fresh compiles recorded
# with NO token on the thread (engine warm-up, direct exec paths), and
# compiled counts lost to finished-record eviction — so
# sum(per_query kernels_compiled) + unattributed + evicted always
# equals the kernel.cache.compiles counter (the bench attribution
# cross-check leans on this identity)
_unattributed_fresh = 0
_evicted_compiled = 0
_corpus_seen: set = set()
_corpus_lock = threading.Lock()


def configure(enabled: bool,
              ring_events: int = DEFAULT_RING_EVENTS,
              storm_threshold: int = DEFAULT_STORM_THRESHOLD,
              corpus_path: str = "",
              corpus_replay: bool = True) -> None:
    """Session-init hook (``obs.compile.*`` knobs; last session wins).
    Resizing the ring preserves its newest events; process-lifetime
    aggregates are never reset by reconfiguration."""
    global _enabled, _storm_threshold, _corpus_path, _ring, \
        _corpus_replay
    with _LOCK:
        ring_events = max(16, int(ring_events))
        if ring_events != (_ring.maxlen or 0):
            _ring = deque(_ring, maxlen=ring_events)
        _enabled = bool(enabled)
        _storm_threshold = max(1, int(storm_threshold))
        _corpus_path = str(corpus_path or "")
        _corpus_replay = bool(corpus_replay)


def corpus_replay_enabled() -> bool:
    return _corpus_replay


def is_enabled() -> bool:
    return _enabled


def reset() -> None:
    """Test hook: drop the ring, aggregates, query table and corpus
    dedup state (configuration is left alone)."""
    global _seq, _unattributed_fresh, _evicted_compiled
    with _LOCK:
        _ring.clear()
        _families.clear()
        _queries.clear()
        _seq = 0
        _unattributed_fresh = 0
        _evicted_compiled = 0
    with _corpus_lock:
        _corpus_seen.clear()


# ---------------------------------------------------------------------------
# cache-tier classification: the kernel-library build counters, per thread
# ---------------------------------------------------------------------------
# kernels/_build.py counts, on the calling thread, every nvcc build it
# runs and every library it opens that an earlier process built.  A
# snapshot bracketing the first call classifies the tier; builds on
# other threads cannot bleed into this thread's window.


def probe_begin() -> Tuple[int, int]:
    """Snapshot this thread's build counters before a potential first
    call; pass the result to :func:`classify_tier`."""
    from spark_rapids_tpu_torch.kernels import _build
    return _build.thread_counts()


def classify_tier(probe: Tuple[int, int],
                  libraries: Sequence[str] = ()) -> str:
    """``fresh`` when ``nvcc`` ran in the window, ``persistent`` when the
    window only opened libraries an earlier process built, or when the
    step launched kernels (from ``libraries``) whose libraries the
    precompile service had all made ready.  Any other window (every
    library already loaded, or no CUDA kernel on the path) reports
    ``fresh``: the reference's conservative reading."""
    from spark_rapids_tpu_torch.kernels import _build
    f0, p0 = probe
    f1, p1 = _build.thread_counts()
    if f1 - f0 > 0:
        return TIER_FRESH
    if p1 - p0 > 0:
        return TIER_PERSISTENT
    if libraries and set(libraries) <= _build.warmed():
        return TIER_PERSISTENT
    return TIER_FRESH


# ---------------------------------------------------------------------------
# query attribution
# ---------------------------------------------------------------------------

def _current_query_id() -> Optional[int]:
    # function-level import: see the layering note in the module
    # docstring (sched.cancel itself imports nothing from obs, so this
    # cannot cycle at runtime either)
    try:
        from spark_rapids_tpu_torch.sched import cancel as _cancel
        tok = _cancel.current()
        return tok.query_id if tok is not None else None
    except Exception:
        return None


def _new_query_rec() -> Dict[str, Any]:
    return {"digest": None, "compiled": 0, "persistent": 0,
            "wall_ns": 0, "storm": False, "finished": False,
            "programs": []}


def _evict_queries_locked() -> None:
    """Bound the per-query table by evicting FINISHED records oldest
    first — a long-running query's record (its digest binding and
    accumulating attribution) must survive any number of short
    neighbours completing around it.  Live records are bounded by the
    scheduler's own queue/concurrency caps, so skipping them cannot
    grow the table unboundedly."""
    global _evicted_compiled
    if len(_queries) <= _MAX_QUERIES:
        return
    for qid in list(_queries):
        if _queries[qid]["finished"]:
            _evicted_compiled += _queries[qid]["compiled"]
            del _queries[qid]
            if len(_queries) <= _MAX_QUERIES:
                return


def _query_rec_locked(qid: Optional[int]) -> Optional[Dict[str, Any]]:
    if qid is None:
        return None
    q = _queries.get(qid)
    if q is None:
        # attribution without registration (a query path that bypassed
        # sched/service): track it anyway, digest unknown
        q = _queries[qid] = _new_query_rec()
        _evict_queries_locked()
    return q


def register_query(query_id: int, plan_digest: Optional[str]) -> None:
    """Bind a query id to its canonical plan digest for the lifetime of
    the query (called by sched/service.submit for every submission, so
    compile events fired on any thread carrying the query's CancelToken
    can be stamped with both)."""
    if query_id is None:
        return
    with _LOCK:
        q = _query_rec_locked(query_id)
        if q is not None and plan_digest is not None:
            q["digest"] = plan_digest


def finish_query(query_id: int) -> None:
    """Query-completion hook (sched/service worker, success or not):
    emits the precompile-corpus record for a distinct plan digest that
    compiled at least one program.  The per-query attribution record
    stays in the bounded table for the /queries + /compiles surfaces.
    Never raises."""
    try:
        with _LOCK:
            q = _queries.get(query_id)
            path = _corpus_path
            if q is None:
                return
            q["finished"] = True        # now evictable (_MAX_QUERIES)
            _evict_queries_locked()
            digest = q["digest"]
            programs = list(q["programs"])
        if not path or not digest or not programs:
            return
        with _corpus_lock:
            if digest in _corpus_seen:
                return
            record = {"plan_digest": digest, "query_id": query_id,
                      "ts_unix": time.time(),
                      "programs": programs}
            with open(path, "a") as f:
                f.write(json.dumps(record, default=str) + "\n")
            # mark seen only AFTER the append succeeded: a transient
            # write failure must leave the record emittable by the
            # plan's next completion, not drop it for the process life
            _corpus_seen.add(digest)
        obsreg.get_registry().inc("kernel.compile.corpusPlans")
    except Exception:
        pass


def query_stats(query_id: int) -> Optional[Dict[str, Any]]:
    """Per-query compile attribution (None when the query never
    compiled nor registered): fresh-compiled program count, persistent
    reload count, compile wall ms, storm flag."""
    with _LOCK:
        q = _queries.get(query_id)
        if q is None:
            return None
        return {"kernels_compiled": q["compiled"],
                "persistent_reloads": q["persistent"],
                "compile_ms": q["wall_ns"] / 1e6,
                "storm": q["storm"]}


def row_fields(query_id: int) -> Dict[str, Any]:
    """The ``kernels_compiled``/``compile_ms`` field pair shared by the
    ``/queries`` table rows and the slow-query JSONL — ONE derivation
    (fresh compiles + persistent reloads, both paid on the query's
    wall; null when zero) so the two surfaces cannot drift."""
    stats = query_stats(query_id)
    compiled = (stats["kernels_compiled"] +
                stats["persistent_reloads"]) if stats else 0
    compile_ms = stats["compile_ms"] if stats else 0.0
    return {"kernels_compiled": compiled or None,
            "compile_ms": round(compile_ms, 3) if compile_ms else None}


# ---------------------------------------------------------------------------
# signatures + width-bucketing projection
# ---------------------------------------------------------------------------

def _leaf_str(leaf: Any) -> str:
    if isinstance(leaf, tuple) and len(leaf) == 2 and \
            isinstance(leaf[0], tuple):
        shape, dty = leaf
        return f"{dty}[{','.join(str(d) for d in shape)}]"
    return str(leaf)[:32]


def canonical_signature(leaves: Sequence[Any]) -> str:
    """Compact ``dtype[shape]`` rendering of a program's argument
    leaves — the shape/dtype signature CompileEvents carry."""
    return ";".join(_leaf_str(x) for x in leaves)


def _pow2_bucket(n: int) -> int:
    return n if n <= 1 else 1 << (int(n) - 1).bit_length()


def _dtype_class(dty: str) -> str:
    d = str(dty)
    for cls in ("int", "uint", "float", "bool", "complex"):
        if d.startswith(cls):
            return cls
    return d


def _bucket_leaf(leaf: Any) -> Any:
    if isinstance(leaf, tuple) and len(leaf) == 2 and \
            isinstance(leaf[0], tuple):
        shape, dty = leaf
        return (tuple(_pow2_bucket(d) for d in shape),
                _dtype_class(dty))
    return "op"


def _bucket_key(key: Any) -> Any:
    """Width-bucketed projection of a kernel-cache key: integer
    components >= 16 (capacities, widths, row counts that leaked into
    keys) round up to powers of two.  This models what a shape-erased
    ABI with width-bucketed layouts would collapse — an ESTIMATE for
    the churn report, not a semantic statement about the keys."""
    if isinstance(key, tuple):
        return tuple(_bucket_key(k) for k in key)
    if isinstance(key, bool):
        return key
    if isinstance(key, int) and key >= 16:
        return _pow2_bucket(key)
    return key


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------

def record_compile(key: Any, family: str, backend: str,
                   leaves: Sequence[Any], t0_ns: int, dur_ns: int,
                   tier: str, replay: Optional[str] = None) -> None:
    """Record one CompileEvent (called by the kernel-cache observe
    wrapper on the first call of each (key, shape) program).
    ``replay`` is the program's replay payload (see the module
    docstring), which rides the program's corpus record only."""
    if not _enabled:
        return
    global _seq
    qid = _current_query_id()
    sig = canonical_signature(leaves)
    key_repr = repr(key)[:200]
    storm_fired = None
    try:
        bkey = _bucket_key(key)
        bleaves = tuple(_bucket_leaf(x) for x in leaves)
    except Exception:
        bkey, bleaves = key_repr, sig
    with _LOCK:
        _seq += 1
        q = _query_rec_locked(qid)
        digest = q["digest"] if q is not None else None
        evt = {"seq": _seq, "ts_unix": time.time(),
               "family": family, "key": key_repr,
               "signature": sig, "backend": backend, "tier": tier,
               "wall_ms": round(dur_ns / 1e6, 3),
               "query_id": qid, "plan_digest": digest}
        _ring.append(evt)
        fam = _families.get(family)
        if fam is None:
            fam = _families[family] = {
                "programs": 0, "fresh": 0, "persistent": 0,
                "wall_ns": 0, "wall_fresh_ns": 0,
                "wall_persistent_ns": 0, "sigs": set(),
                "bucketed": set(), "sig_overflow": False}
        fam["programs"] += 1
        eff_tier = tier if tier in (TIER_FRESH, TIER_PERSISTENT) \
            else TIER_FRESH
        fam[eff_tier] += 1
        fam["wall_ns"] += int(dur_ns)
        # per-tier wall split: the persistent share is what a restart
        # pays to reopen libraries an earlier process built
        fam["wall_fresh_ns" if eff_tier == TIER_FRESH
            else "wall_persistent_ns"] += int(dur_ns)
        if len(fam["sigs"]) < _MAX_SIGS_PER_FAMILY:
            fam["sigs"].add((key_repr, sig))
            fam["bucketed"].add((bkey, bleaves))
        else:
            fam["sig_overflow"] = True
        if q is None:
            if tier != TIER_PERSISTENT:
                global _unattributed_fresh
                _unattributed_fresh += 1
        else:
            if tier == TIER_PERSISTENT:
                q["persistent"] += 1
            else:
                q["compiled"] += 1
            q["wall_ns"] += int(dur_ns)
            if len(q["programs"]) < _MAX_PROGRAMS_PER_QUERY:
                # a program without a payload says so as null
                prog = {"family": family, "key": key_repr,
                        "signature": sig, "backend": backend,
                        "replay": replay}
                q["programs"].append(prog)
            total = q["compiled"] + q["persistent"]
            if total > _storm_threshold and not q["storm"]:
                q["storm"] = True
                storm_fired = total
    # registry counters + trace span outside the ledger lock (both
    # have their own locking; holding two at once buys nothing)
    tier_counter = ("kernel.cache.compiles" if tier != TIER_PERSISTENT
                    else "kernel.cache.persistentHits")
    obsreg.get_registry().inc_many(
        ("kernel.compile.events", 1),
        (f"kernel.compile.events.{family}", 1),
        ("kernel.compile.wallNs", int(dur_ns)),
        (tier_counter, 1))
    obsreg.get_registry().observe("kernel.compile.wallMs", dur_ns / 1e6)
    # ledger: compile wall bills the owning tenant (same qid binding;
    # one bool inside when accounting is off)
    from spark_rapids_tpu_torch.obs import accounting as _acct
    _acct.charge_qid(qid, "kernel.compile.wallNs", int(dur_ns))
    obstrace.record("kernel.compile", t0_ns, dur_ns, cat="kernel",
                    args={"family": family, "tier": tier,
                          "backend": backend, "query": qid,
                          "signature": sig})
    if storm_fired is not None:
        obsreg.get_registry().inc("kernel.compile.storms")
        obsrec.record_event("compile.storm", query=qid,
                            programs=storm_fired,
                            threshold=_storm_threshold,
                            plan_digest=digest)


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def _churn_rows_locked() -> List[Dict[str, Any]]:
    rows = []
    for family, a in _families.items():
        distinct = len(a["sigs"])
        bucketed = len(a["bucketed"])
        rows.append({
            "family": family,
            "programs": a["programs"],
            "fresh": a["fresh"],
            "persistent": a["persistent"],
            "compile_wall_ms": round(a["wall_ns"] / 1e6, 3),
            "distinct_signatures": distinct,
            "est_programs_width_bucketed": bucketed,
            "est_collapse_savings": distinct - bucketed,
            "sig_overflow": a["sig_overflow"],
        })
    rows.sort(key=lambda r: (-r["distinct_signatures"],
                             -r["compile_wall_ms"], r["family"]))
    return rows


def _totals_locked() -> Dict[str, Any]:
    fresh = sum(a["fresh"] for a in _families.values())
    persistent = sum(a["persistent"] for a in _families.values())
    wall_ns = sum(a["wall_ns"] for a in _families.values())
    distinct = sum(len(a["sigs"]) for a in _families.values())
    bucketed = sum(len(a["bucketed"]) for a in _families.values())
    return {"events": fresh + persistent, "fresh": fresh,
            "persistent": persistent,
            "compile_wall_ms": round(wall_ns / 1e6, 3),
            "compile_wall_fresh_ms": round(sum(
                a["wall_fresh_ns"] for a in _families.values()) / 1e6,
                3),
            "compile_wall_persistent_ms": round(sum(
                a["wall_persistent_ns"]
                for a in _families.values()) / 1e6, 3),
            "distinct_programs": distinct,
            "width_bucketed_projection": bucketed,
            "families": len(_families),
            "queries_tracked": len(_queries),
            # closure terms for the attribution identity (see the
            # _unattributed_fresh comment): per-query compiled totals
            # + these two == the kernel.cache.compiles counter
            "unattributed_fresh": _unattributed_fresh,
            "evicted_compiled": _evicted_compiled}


def _events_locked(max_events: Optional[int]) -> List[Dict[str, Any]]:
    out = list(_ring)
    if max_events is None:
        return out
    return out[-max_events:] if max_events > 0 else []


def churn_report() -> List[Dict[str, Any]]:
    """Shape-churn analytics, ranked by signature cardinality: for each
    kernel family, the distinct (key, shape) program count, the
    estimated program count after width-bucketing (powers-of-two shape
    dims + dtype classes + bucketed key capacities), and the estimated
    collapse savings — the candidates ROADMAP item 2's shape-erased
    ABI should attack first."""
    with _LOCK:
        return _churn_rows_locked()


def totals() -> Dict[str, Any]:
    with _LOCK:
        return _totals_locked()


def events(max_events: Optional[int] = None) -> List[Dict[str, Any]]:
    """The newest ``max_events`` ring events (all when None; an
    explicit 0 means none — a scraper asking for totals only)."""
    with _LOCK:
        return _events_locked(max_events)


def snapshot(max_events: int = 256) -> Dict[str, Any]:
    """The ``/compiles`` endpoint payload: config, totals, the newest
    ring events, per-query attribution, and the churn report —
    assembled under ONE lock acquisition so a scrape racing a compile
    cannot observe totals/events/churn from different instants."""
    with _LOCK:
        per_query = {
            str(qid): {"plan_digest": q["digest"],
                       "kernels_compiled": q["compiled"],
                       "persistent_reloads": q["persistent"],
                       "compile_ms": round(q["wall_ns"] / 1e6, 3),
                       "storm": q["storm"]}
            for qid, q in _queries.items()}
        return {"enabled": _enabled, "ring_capacity": _ring.maxlen,
                "storm_threshold": _storm_threshold,
                "corpus_path": _corpus_path or None,
                "totals": _totals_locked(),
                "events": _events_locked(max_events),
                "per_query": per_query,
                "churn": _churn_rows_locked()}


def corpus_path() -> str:
    return _corpus_path
