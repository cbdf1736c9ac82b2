"""Low-overhead span tracer with a Chrome trace-event exporter.

Copied whole from ``spark_rapids_tpu/obs/trace.py``.

Design constraints (the engine's hot paths run this per batch):

  * **Zero-allocation no-op path when disabled** — ``span()`` returns a
    shared singleton context manager and ``record()`` returns
    immediately; the only cost is one module-global bool check.
  * **Bounded memory** — spans land in a ring buffer
    (``collections.deque`` with ``maxlen``); when a query outruns the
    buffer the oldest spans drop, never the process.
  * **Thread-safe** — partition iterators drain on the task pool and
    prefetch threads record concurrently; ``deque.append`` is atomic
    and the monotonic sequence counter hands out carve marks.

Spans are recorded at *exit* with monotonic-ns timestamps (so recording
order is children-before-parents); the Chrome exporter re-derives the
nesting per thread from the intervals and emits matched ``B``/``E``
event pairs a Perfetto / chrome://tracing load renders as a flame
graph.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_BUFFER_SPANS = 65536

# one span record:
#   (seq, tid, name, cat, t0_ns, dur_ns, depth, args)
Span = Tuple[int, int, str, str, int, int, int, Optional[Dict[str, Any]]]

_enabled = False
_ring: deque = deque(maxlen=DEFAULT_BUFFER_SPANS)
_seq = itertools.count()
_lock = threading.Lock()
_tls = threading.local()

# cross-process stitching state: synthetic lane ids for spans merged
# from other processes (executor map stages), plus human labels the
# Chrome exporter renders as thread_name metadata.  Real tids are
# CPython thread idents (pthread pointers, far above this range), so
# small synthetic ids cannot collide with them.  Bounded: labels embed
# executor pids, so a long-lived process restarting pools mints fresh
# keys — past _MAX_LANES the oldest mapping evicts (its spans keep the
# label in args["lane"]; only the chrome thread_name metadata for a
# lane that old is lost).
_MAX_LANES = 1024
_lane_ids = itertools.count(1)
_lane_map: Dict[Tuple[str, int], int] = {}   # (label, foreign tid) -> lane
_lane_counts: Dict[str, int] = {}            # label -> lanes minted
_tid_labels: Dict[int, str] = {}


def configure(enabled: bool, buffer_spans: Optional[int] = None) -> None:
    """Process-wide tracer switch (called by TpuSparkSession from the
    ``spark.rapids.tpu.obs.trace.*`` knobs; last session wins, the
    scan-cache ``configure`` idiom)."""
    global _enabled, _ring
    with _lock:
        if buffer_spans is not None and \
                int(buffer_spans) != (_ring.maxlen or 0):
            _ring = deque(_ring, maxlen=max(16, int(buffer_spans)))
        _enabled = bool(enabled)


def is_enabled() -> bool:
    return _enabled


def clear() -> None:
    with _lock:
        _ring.clear()


def mark() -> int:
    """Monotonic carve mark: ``spans_since(mark())`` returns only spans
    recorded after this call (per-query span windows)."""
    return next(_seq)


def record(name: str, t0_ns: int, dur_ns: int, cat: str = "exec",
           args: Optional[Dict[str, Any]] = None,
           depth: Optional[int] = None) -> None:
    """Record one completed span. No-op (one bool check) when disabled."""
    if not _enabled:
        return
    if depth is None:
        depth = getattr(_tls, "depth", 0)
    _ring.append((next(_seq), threading.get_ident(), name, cat,
                  int(t0_ns), int(dur_ns), depth, args))


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "t0", "_depth")

    def __init__(self, name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        d = getattr(_tls, "depth", 0)
        self._depth = d + 1
        _tls.depth = self._depth
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        dur = time.perf_counter_ns() - self.t0
        _tls.depth = self._depth - 1
        record(self.name, self.t0, dur, self.cat, self.args,
               depth=self._depth)
        return False


def span(name: str, cat: str = "exec",
         args: Optional[Dict[str, Any]] = None):
    """``with span("scan.decode"):`` — a nested, thread-local span.
    Returns the shared no-op singleton when tracing is disabled."""
    if not _enabled:
        return _NOOP
    return _Span(name, cat, args)


def record_foreign(spans: Sequence[Span], offset_ns: int,
                   label: str) -> int:
    """Merge spans recorded in ANOTHER process into this ring (the
    cross-process trace stitch): each foreign timestamp is shifted by
    ``offset_ns`` (foreign clock -> this process's perf_counter_ns
    domain, aligned by the caller from the request/reply envelope) and
    each foreign thread maps to a stable synthetic lane labeled
    ``label`` (``label/t0``, ``label/t1``, ... when the foreign process
    used several threads) that the Chrome exporter names via
    thread_name metadata — executor map stages render as their own
    lanes in Perfetto.  Returns the number of spans merged.  No-op when
    tracing is disabled."""
    if not _enabled or not spans:
        return 0
    n = 0
    with _lock:
        for s in spans:
            seq_, ftid, name, cat, t0, dur, depth, args = s
            key = (label, ftid)
            lane = _lane_map.get(key)
            if lane is None:
                lane = next(_lane_ids)
                _lane_map[key] = lane
                nth = _lane_counts.get(label, 0)
                _lane_counts[label] = nth + 1
                _tid_labels[lane] = (label if nth == 0
                                     else f"{label}/t{nth}")
                while len(_lane_map) > _MAX_LANES:
                    old_key = next(iter(_lane_map))
                    _tid_labels.pop(_lane_map.pop(old_key), None)
                    # drop a label's mint counter with its last lane —
                    # labels embed executor pids, so a long-lived
                    # process would otherwise leak one counter per pool
                    # generation forever
                    old_label = old_key[0]
                    if all(k[0] != old_label for k in _lane_map):
                        _lane_counts.pop(old_label, None)
            a = dict(args) if args else {}
            a.setdefault("lane", _tid_labels[lane])
            _ring.append((next(_seq), lane, name, cat,
                          int(t0) + int(offset_ns), int(dur),
                          int(depth), a))
            n += 1
    return n


def lane_label(tid: int) -> Optional[str]:
    """Human label of a synthetic (stitched) lane; None for real
    threads."""
    return _tid_labels.get(tid)


def snapshot() -> List[Span]:
    with _lock:
        return list(_ring)


def spans_since(seq_mark: int) -> List[Span]:
    return [s for s in snapshot() if s[0] >= seq_mark]


def span_dicts(spans: Sequence[Span]) -> List[Dict[str, Any]]:
    """JSON-friendly rendering (the QueryProfile ``spans`` section)."""
    out = []
    for seq, tid, name, cat, t0, dur, depth, args in spans:
        d = {"name": name, "cat": cat, "tid": tid, "ts_ns": t0,
             "dur_ns": dur, "depth": depth}
        if args:
            d["args"] = args
        out.append(d)
    return out


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------

def chrome_trace(spans: Optional[Sequence[Span]] = None
                 ) -> Dict[str, Any]:
    """Render spans as a Chrome trace-event object (the ``traceEvents``
    duration-event format: matched ``B``/``E`` pairs, ``ts`` in
    microseconds).

    Spans were recorded at exit (children before parents), so per
    thread the nesting forest is rebuilt from the intervals: pre-order
    sort ``(t0, -t1, seq)``, then an explicit stack walk emits every
    ``E`` exactly when the next span starts outside it — matched pairs
    by construction, properly nested for stack-based (per-thread)
    producers."""
    if spans is None:
        spans = snapshot()
    events: List[Dict[str, Any]] = []
    by_tid: Dict[int, List[Span]] = {}
    for s in spans:
        by_tid.setdefault(s[1], []).append(s)
    # stitched executor lanes get their human name (thread_name
    # metadata events — Perfetto renders the label on the lane)
    for tid in sorted(by_tid):
        label = _tid_labels.get(tid)
        if label is not None:
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": label}})
    for tid, ss in sorted(by_tid.items()):
        ivs = sorted(((s[4], s[4] + s[5], s[0], s) for s in ss),
                     key=lambda x: (x[0], -x[1], x[2]))
        stack: List[Tuple[int, int, int, Span]] = []

        def emit(ph: str, s: Span, ts_ns: int) -> None:
            ev = {"name": s[2], "cat": s[3], "ph": ph, "pid": 0,
                  "tid": tid, "ts": ts_ns / 1e3}
            if ph == "B" and s[7]:
                ev["args"] = s[7]
            events.append(ev)

        for t0, t1, _seq, s in ivs:
            while stack and stack[-1][1] <= t0:
                pt0, pt1, _pseq, ps = stack.pop()
                emit("E", ps, pt1)
            emit("B", s, t0)
            stack.append((t0, t1, _seq, s))
        while stack:
            pt0, pt1, _pseq, ps = stack.pop()
            emit("E", ps, pt1)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(path: str,
                      spans: Optional[Sequence[Span]] = None) -> str:
    """Write the Chrome trace JSON to ``path`` (open it in Perfetto or
    chrome://tracing).  Returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f)
    return path
