"""Drift sentinel: a background watcher that notices the engine
getting worse before a human reads ``BENCH_trend.json``.

On a fixed interval (``obs.sentinel.intervalMs``) the sentinel
snapshots the process MetricsRegistry, forms the **window delta**
against the previous tick, and evaluates a rule set against a trailing
EWMA baseline (updated only on healthy windows, so a regression cannot
poison its own reference):

  ``latency``    windowed p95 of ``slo.latencyMs`` (interpolated from
                 the bucketed histogram's count deltas) exceeds
                 ``factor`` x baseline — the p95 regression rule.
  ``slow``       ``obs.slowQueries`` window count spikes past
                 ``factor`` x baseline rate.
  ``cacheHit``   result-cache hit rate (hits / (hits+misses) in the
                 window) collapses below ``drop`` x baseline.
  ``compile``    ``kernel.cache.compiles`` window count spikes — the
                 compile-storm rule (shape churn, cache wipe).
  ``spill``      ``spill.deviceToHostBytes`` window bytes surge.

A rule must breach ``sustain`` consecutive windows before it fires —
one noisy window is weather, a streak is drift.  Firing opens an
**episode**: exactly one flight-recorder bundle (reason ``"slo"``)
with the breached window, rule verdicts, and the ledger's window
top-talkers attached (``sentinel.json``), one
``obs.sentinel.breaches`` / ``obs.sentinel.breaches.<rule>`` counter
increment, and one structured JSONL line (size-rotated, the
slow-query-log writer).  The episode closes when the rule goes a full
window without breaching; only then can it fire again.

Rules grammar (``obs.sentinel.rules``): semicolon-separated
``rule:key=val,key=val`` specs — ``"latency:factor=2,sustain=2"``
enables ONLY the latency rule with those overrides; the empty string
enables every rule at defaults.

Disabled (``obs.sentinel.enabled=false``, the default): nothing is
constructed and no thread runs — the one-bool contract.

Copied whole from ``spark_rapids_tpu/obs/sentinel.py``, its imports
retargeted.  Until the serving tier is ported no ``serve.resultCache*``
counter moves, so the ``cacheHit`` rule never sees a window.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

from spark_rapids_tpu_torch.obs import accounting as acct
from spark_rapids_tpu_torch.obs import jsonl as obsjsonl
from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg

# per-rule defaults; every value is overridable from the rules spec
DEFAULT_RULES: Dict[str, Dict[str, float]] = {
    # windowed p95 latency > factor x EWMA baseline (and > floor_ms,
    # so microsecond workloads can't alarm on scheduler jitter)
    "latency": {"factor": 2.0, "min": 4, "floor_ms": 5.0, "sustain": 2},
    # slow-query count spike: >= min in the window AND > factor x
    # baseline window rate
    "slow": {"factor": 2.0, "min": 3, "sustain": 2},
    # hit-rate collapse: window rate < drop x baseline rate, with at
    # least min lookups in the window
    "cacheHit": {"drop": 0.5, "min": 8, "sustain": 2},
    # compile storm: fresh-compile count spike
    "compile": {"factor": 3.0, "min": 8, "sustain": 2},
    # spill surge: device->host bytes spike
    "spill": {"factor": 3.0, "min": float(1 << 20), "sustain": 2},
}

_EWMA_ALPHA = 0.3


def parse_rules(spec: str) -> Dict[str, Dict[str, float]]:
    """``"latency:factor=2;slow"`` -> enabled-rule dict with defaults
    merged.  Empty spec = all rules at defaults.  Unknown rule names
    and malformed pairs raise ``ValueError`` (a config typo must not
    silently disable the watcher)."""
    spec = (spec or "").strip()
    if not spec:
        return {k: dict(v) for k, v in DEFAULT_RULES.items()}
    rules: Dict[str, Dict[str, float]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, kvs = part.partition(":")
        name = name.strip()
        if name not in DEFAULT_RULES:
            raise ValueError(f"unknown sentinel rule {name!r} "
                             f"(known: {sorted(DEFAULT_RULES)})")
        params = dict(DEFAULT_RULES[name])
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, eq, v = kv.partition("=")
            if not eq or k.strip() not in params:
                raise ValueError(
                    f"bad sentinel param {kv!r} for rule {name!r} "
                    f"(known: {sorted(params)})")
            params[k.strip()] = float(v)
        rules[name] = params
    return rules


class _RuleState:
    __slots__ = ("ewma", "streak", "in_episode")

    def __init__(self):
        self.ewma: Optional[float] = None
        self.streak = 0
        self.in_episode = False


def _counter_delta(cur: Dict[str, Any], prev: Dict[str, Any],
                   name: str) -> float:
    return (cur["counters"].get(name, 0.0)
            - prev["counters"].get(name, 0.0))


def _latency_window(cur: Dict[str, Any], prev: Dict[str, Any]):
    """(sample count, p95 ms) of slo.latencyMs over the window, from
    bucket-count deltas; (0, None) when the histogram is absent."""
    h = cur.get("bucket_histograms", {}).get("slo.latencyMs")
    if h is None:
        return 0, None
    p = prev.get("bucket_histograms", {}).get("slo.latencyMs")
    counts = list(h["counts"]) if p is None else \
        [c - q for c, q in zip(h["counts"], p["counts"])]
    n = sum(counts)
    if n <= 0:
        return 0, None
    return n, obsreg.bucket_quantile(h["bounds"], counts, 0.95)


class DriftSentinel:
    """One per session when ``obs.sentinel.enabled=true`` (the
    PrecompileService lifecycle shape: ``start`` a daemon thread,
    ``stop`` sets an event the interval-wait observes, ``tick()`` is
    the synchronous unit the thread loops — and what deterministic
    tests call directly)."""

    def __init__(self, interval_ms: int = 1000, rules: str = "",
                 jsonl_path: str = "", jsonl_max_bytes: int = 0):
        self.interval_s = max(1, int(interval_ms)) / 1e3
        self.rules = parse_rules(rules)
        self.jsonl_path = str(jsonl_path or "")
        self.jsonl_max_bytes = int(jsonl_max_bytes)
        self._states = {name: _RuleState() for name in self.rules}
        self._prev: Optional[Dict[str, Any]] = None
        self._prev_ledger: Optional[Dict[str, Any]] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._stats = {"ticks": 0, "breaches": 0, "episodes": 0}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="obs-sentinel", daemon=True)
        self._thread.start()

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._stats)

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # the watcher must never take the engine down with it
                obsreg.get_registry().inc("obs.sentinel.tickErrors")

    # -- evaluation ---------------------------------------------------------
    def tick(self) -> List[str]:
        """Evaluate one window; returns the rules that OPENED an
        episode this tick (usually empty)."""
        reg = obsreg.get_registry()
        cur = reg.snapshot()
        cur_ledger = acct.snapshot() if acct.is_enabled() else None
        prev, prev_ledger = self._prev, self._prev_ledger
        self._prev, self._prev_ledger = cur, cur_ledger
        with self._lock:
            self._stats["ticks"] += 1
        reg.inc("obs.sentinel.ticks")
        if prev is None:
            return []                      # first tick only arms it
        fired: List[str] = []
        verdicts: Dict[str, Dict[str, Any]] = {}
        for name, params in self.rules.items():
            st = self._states[name]
            breached, obs_v = self._evaluate(name, params, cur, prev,
                                             st.ewma)
            verdicts[name] = {"breached": breached, "observed": obs_v,
                              "baseline": st.ewma,
                              "streak": st.streak}
            if breached:
                st.streak += 1
                if st.streak >= int(params.get("sustain", 2)) \
                        and not st.in_episode:
                    st.in_episode = True
                    fired.append(name)
            else:
                st.streak = 0
                st.in_episode = False
                # baseline learns only from healthy windows — a
                # sustained regression must not become the new normal
                if obs_v is not None:
                    st.ewma = obs_v if st.ewma is None else (
                        _EWMA_ALPHA * obs_v
                        + (1 - _EWMA_ALPHA) * st.ewma)
        if fired:
            self._emit(fired, verdicts, prev_ledger)
        return fired

    @staticmethod
    def _evaluate(name: str, params: Dict[str, float],
                  cur: Dict[str, Any], prev: Dict[str, Any],
                  baseline: Optional[float]):
        """(breached, observed value) for one rule over one window."""
        if name == "latency":
            n, p95 = _latency_window(cur, prev)
            if n < params["min"] or p95 is None:
                return False, None
            if baseline is None:
                return False, p95          # warmup window
            threshold = max(params["floor_ms"],
                            baseline * params["factor"])
            return p95 > threshold, p95
        if name == "slow":
            d = _counter_delta(cur, prev, "obs.slowQueries")
            if d < params["min"]:
                return False, d if d > 0 else None
            base = baseline or 0.0
            return d > base * params["factor"], d
        if name == "cacheHit":
            hits = _counter_delta(cur, prev, "serve.resultCacheHits")
            misses = _counter_delta(cur, prev,
                                    "serve.resultCacheMisses")
            total = hits + misses
            if total < params["min"]:
                return False, None
            rate = hits / total
            if baseline is None:
                return False, rate
            return rate < baseline * params["drop"], rate
        if name == "compile":
            d = _counter_delta(cur, prev, "kernel.cache.compiles")
            if d < params["min"]:
                return False, d if d > 0 else None
            base = baseline or 0.0
            return d > base * params["factor"], d
        if name == "spill":
            d = _counter_delta(cur, prev, "spill.deviceToHostBytes")
            if d < params["min"]:
                return False, d if d > 0 else None
            base = baseline or 0.0
            return d > base * params["factor"], d
        return False, None

    # -- emission -----------------------------------------------------------
    def _emit(self, fired: List[str],
              verdicts: Dict[str, Dict[str, Any]],
              prev_ledger: Optional[Dict[str, Any]]) -> None:
        reg = obsreg.get_registry()
        pairs = [("obs.sentinel.breaches", len(fired))]
        pairs += [(f"obs.sentinel.breaches.{r}", 1) for r in fired]
        reg.inc_many(*pairs)
        with self._lock:
            self._stats["breaches"] += len(fired)
            self._stats["episodes"] += 1
        talkers = acct.top_talkers(base=prev_ledger) \
            if acct.is_enabled() else []
        payload = {
            "unix": time.time(),
            "rules": fired,
            "verdicts": verdicts,
            "interval_s": self.interval_s,
            "top_talkers": talkers,
        }
        rec = obsrec.get_recorder()
        if rec is not None:
            payload["bundle"] = rec.dump_bundle(
                None, reason="slo", extra=payload)
        obsrec.record_event("sentinel.breach", rules=fired)
        if self.jsonl_path:
            try:
                obsjsonl.rotating_append(
                    self.jsonl_path, json.dumps(payload, default=str),
                    self.jsonl_max_bytes)
            except OSError:
                pass                       # breach log is best-effort
