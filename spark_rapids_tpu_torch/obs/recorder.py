"""Flight recorder: a bounded ring of recent engine events plus
self-contained diagnostic bundles on query failure.

Copied from ``spark_rapids_tpu/obs/recorder.py``, its imports
retargeted.  The port records the spill catalog's traffic and OOM
retries (``mem/spill.py``), the grace join's activations, recursions
and fallbacks (``exec/join_partition.py``), the scheduler's
submission, admission, dedup and finish events (``sched/admission.py``,
``sched/service.py``), slow queries, sentinel breaches and bundles.

A long-lived serving engine is undebuggable post-hoc: when a query
dies, the context that explains it (what admission decided, what
spilled, whether the device OOM-retried) died with it.  The recorder
keeps the last ``obs.recorder.maxEvents`` engine events in memory —
scheduler admission decisions, spill/arena traffic, OOM retries,
donation disarms, query lifecycle marks — and on query **failure,
timeout, or cancellation** (via the QueryExecutionListener failure
path) writes a self-contained bundle to ``obs.recorder.dir``:

  ``<dir>/q<id>-<reason>-<YYYYmmdd-HHMMSS>-p<pid>-<n>/``
      ``profile.json``   the query's QueryProfile (plan, metrics, spans)
      ``trace.json``     the query's span window as a Chrome trace
      ``events.jsonl``   the event ring (one JSON object per line)
      ``config.json``    the session conf snapshot
      ``registry.json``  the full MetricsRegistry snapshot at dump time

A *successful* query that needed an HBM OOM-retry (``mem.oomRetries``
moved) also dumps a bundle — a query that only survived by evicting
the whole device tier is a diagnosis waiting to happen.

Disabled path: ``record_event`` is a module function behind one bool
check — with no ``obs.recorder.dir`` configured the hooks in
admission/spill/session cost nothing measurable.  Configuration is
process-wide, last session wins (the trace/scan-cache configure
idiom).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.obs import trace as obstrace

DEFAULT_MAX_EVENTS = 4096

_enabled = False
_RECORDER: Optional["FlightRecorder"] = None
_LOCK = threading.Lock()


def record_event(kind: str, **fields: Any) -> None:
    """Append one event to the recorder ring.  One bool check when the
    recorder is disabled (the hot-path contract shared with
    trace.record)."""
    if not _enabled:
        return
    r = _RECORDER
    if r is not None:
        r.record(kind, fields)


def is_enabled() -> bool:
    return _enabled


def get_recorder() -> Optional["FlightRecorder"]:
    return _RECORDER


def configure(out_dir: str, max_events: int = DEFAULT_MAX_EVENTS,
              config_snapshot: Optional[Dict[str, Any]] = None
              ) -> "FlightRecorder":
    """Install the process-wide recorder (session init; last session
    wins)."""
    global _enabled, _RECORDER
    with _LOCK:
        _RECORDER = FlightRecorder(out_dir, max_events=max_events,
                                   config_snapshot=config_snapshot)
        _enabled = True
        return _RECORDER


def disable() -> None:
    global _enabled, _RECORDER
    with _LOCK:
        _enabled = False
        _RECORDER = None


def _classify(exc: Optional[BaseException]) -> str:
    """Bundle reason from the failure exception, by type NAME so the
    obs layer stays import-leaf (sched imports obs, never the
    reverse)."""
    if exc is None:
        return "oom-retry"
    names = {c.__name__ for c in type(exc).__mro__}
    if "QueryRejectedError" in names:
        return "rejected"         # refused before admission (queue full)
    if "QueryTimeoutError" in names:
        return "timeout"
    if "QueryCancelledError" in names:
        return "cancelled"
    return "failure"


class FlightRecorder:
    """Bounded event ring + bundle writer; doubles as a
    QueryExecutionListener (obs/listener.py duck type) so the session's
    existing failure fan-out is the wiring."""

    def __init__(self, out_dir: str,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 config_snapshot: Optional[Dict[str, Any]] = None):
        self.out_dir = str(out_dir)
        self._ring: deque = deque(maxlen=max(16, int(max_events)))
        self._lock = threading.Lock()
        self._bundle_seq = itertools.count(1)
        self._config_snapshot = dict(config_snapshot or {})
        # oom-retry watermark: a success whose window moved this
        # counter still gets a bundle (localization, not accounting —
        # the registry-delta contract)
        self._oom_seen = obsreg.get_registry().counter("mem.oomRetries")
        self.last_bundle_path: Optional[str] = None

    # -- the ring ----------------------------------------------------------
    def record(self, kind: str, fields: Dict[str, Any]) -> None:
        evt = {"ts_unix": time.time(),
               "t_ns": time.perf_counter_ns(),
               "kind": kind}
        if fields:
            evt.update(fields)
        with self._lock:
            self._ring.append(evt)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    # -- listener surface --------------------------------------------------
    def _stale(self) -> bool:
        """True once a LATER session reconfigured/disabled the
        process-wide recorder: this instance's listener may still be
        registered on its own session, but its frozen event ring would
        produce a bundle that misleadingly claims to show recent engine
        activity — stand down instead."""
        return get_recorder() is not self

    def on_success(self, profile) -> None:
        if self._stale():
            return
        reg = obsreg.get_registry()
        oom = reg.counter("mem.oomRetries")
        if oom > self._oom_seen:
            self._oom_seen = oom
            self.dump_bundle(profile, reason="oom-retry")

    def on_failure(self, profile, exception: BaseException) -> None:
        if self._stale():
            return
        self._oom_seen = obsreg.get_registry().counter("mem.oomRetries")
        self.dump_bundle(profile, reason=_classify(exception))

    # -- the bundle --------------------------------------------------------
    def dump_bundle(self, profile, reason: str = "failure",
                    extra: Optional[Dict[str, Any]] = None) -> str:
        """Write one self-contained diagnostic bundle; returns its
        directory.  An IO error here cannot fail the query: the
        listener fan-out (obs/listener.notify) swallows listener
        exceptions by contract.  ``extra``, when given, lands in
        ``sentinel.json`` — the drift sentinel attaches the breached
        window and its ledger top-talkers there."""
        qid = getattr(profile, "query_id", 0)
        # name must be unique ACROSS engine restarts: query ids and the
        # bundle counter both restart at 1 per process, and a flight
        # recorder that overwrites the previous crash's bundle destroys
        # exactly what it exists to preserve
        stamp = time.strftime("%Y%m%d-%H%M%S")
        name = (f"q{int(qid):05d}-{reason}-{stamp}"
                f"-p{os.getpid()}-{next(self._bundle_seq)}")
        bundle = os.path.join(self.out_dir, name)
        os.makedirs(bundle, exist_ok=True)

        def dump(fname: str, obj: Any) -> None:
            with open(os.path.join(bundle, fname), "w") as f:
                json.dump(obj, f, indent=2, default=str)

        dump("profile.json",
             profile.to_dict() if profile is not None else None)
        dump("trace.json", obstrace.chrome_trace(
            getattr(profile, "_raw_spans", []) or []))
        with open(os.path.join(bundle, "events.jsonl"), "w") as f:
            for evt in self.events():
                f.write(json.dumps(evt, default=str) + "\n")
        dump("config.json", self._config_snapshot)
        dump("registry.json", obsreg.get_registry().snapshot())
        if extra is not None:
            dump("sentinel.json", extra)
        self.record("recorder.bundle", {"path": bundle,
                                        "reason": reason,
                                        "query": qid})
        obsreg.get_registry().inc("recorder.bundles")
        self.last_bundle_path = bundle
        return bundle
