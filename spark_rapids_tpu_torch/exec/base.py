"""Physical plan contracts.

Ported from ``spark_rapids_tpu/exec/base.py``: the coalesce goals,
``Metrics``, ``PhysicalPlan`` (``is_tpu``, ``simple_string``,
``tree_string``, ``foreach``), ``TpuExec``, ``timed`` and
``timed_extra``, with their hooks into tracing (``obs/trace.py``) and
cooperative cancellation (``sched/cancel.py``), and the per-node metrics
walk ``collect_plan_metrics`` / ``merge_plan_metrics`` that the query
profile reads and the process transport will ship.  ``peak_dev_memory``
is kept for the profile's layout; as in the reference, only a merge sets
it.

Execution model: ``execute()`` returns one Python iterator per partition.
CPU execs yield ``pyarrow.Table`` batches; device execs yield
``DeviceBatch``; HostToDeviceExec / DeviceToHostExec convert between them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from spark_rapids_tpu_torch.obs import trace as _trace
from spark_rapids_tpu_torch.plan.logical import Schema
from spark_rapids_tpu_torch.sched import cancel as _cancel


# ---------------------------------------------------------------------------
# Coalesce goals
# ---------------------------------------------------------------------------

class CoalesceGoal:
    pass


@dataclass(frozen=True)
class TargetSize(CoalesceGoal):
    bytes: int


class RequireSingleBatch(CoalesceGoal):
    """Operator needs its whole input in one batch."""


REQUIRE_SINGLE_BATCH = RequireSingleBatch()


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@dataclass
class Metrics:
    """Per-exec counters; every time is in NANOSECONDS."""

    _rows_host: int = 0
    num_output_batches: int = 0
    total_time_ns: int = 0
    peak_dev_memory: int = 0
    extra: Dict[str, float] = field(default_factory=dict)
    _rows_pending: list = field(default_factory=list)
    _rows_lock: Any = field(default_factory=threading.Lock)

    def add_rows(self, nr) -> None:
        """Count output rows without reading a device count: 0-d tensors
        buffer and resolve when the metric is read.  Thread-safe:
        partition iterators of one exec run concurrently."""
        with self._rows_lock:
            if isinstance(nr, int):
                self._rows_host += nr
            else:
                self._rows_pending.append(nr)

    def add_batches(self, n: int = 1) -> None:
        with self._rows_lock:
            self.num_output_batches += n

    def add_extra(self, key: str, n: float) -> None:
        with self._rows_lock:
            self.extra[key] = self.extra.get(key, 0) + n

    def add_time_ns(self, ns: int) -> None:
        with self._rows_lock:
            self.total_time_ns += ns

    def max_peak(self, v: int) -> None:
        with self._rows_lock:
            if v > self.peak_dev_memory:
                self.peak_dev_memory = v

    @property
    def num_output_rows(self) -> int:
        with self._rows_lock:
            if self._rows_pending:
                self._rows_host += sum(int(x)
                                       for x in self._rows_pending)
                self._rows_pending.clear()
            return self._rows_host


class PhysicalPlan:
    """Base physical node."""

    children: Tuple["PhysicalPlan", ...] = ()

    def __init__(self):
        self.metrics = Metrics()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def is_tpu(self) -> bool:
        return False

    def execute(self) -> List[Iterator[Any]]:
        """One iterator of batches per partition."""
        raise NotImplementedError

    def simple_string(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [f"{pad}{'*' if self.is_tpu else ' '}{self.simple_string()}"]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def foreach(self, fn) -> None:
        fn(self)
        for c in self.children:
            c.foreach(fn)


class TpuExec(PhysicalPlan):
    """Marker base for device-side execs (the name is the reference's)."""

    @property
    def is_tpu(self) -> bool:
        return True


class _Timed:
    """Accumulates elapsed host ns into ``metrics.total_time_ns`` and, for
    a named section, into ``metrics.extra[name]`` and a trace span of that
    name (obs/trace.py; one bool check when tracing is off).  Entry is the
    per-batch cancellation checkpoint, as in the reference."""

    __slots__ = ("metrics", "name", "t0")

    def __init__(self, metrics: Metrics, name: Optional[str]):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        _cancel.check_current()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        dur = time.perf_counter_ns() - self.t0
        self.metrics.add_time_ns(dur)
        if self.name is not None:
            self.metrics.add_extra(self.name, dur)
            _trace.record(self.name, self.t0, dur)


def timed(metrics: Metrics, name: Optional[str] = None):
    return _Timed(metrics, name)


class _TimedExtra:
    __slots__ = ("metrics", "key", "t0")

    def __init__(self, metrics: Metrics, key: str):
        self.metrics = metrics
        self.key = key

    def __enter__(self):
        _cancel.check_current()   # prefetch-thread batch checkpoint
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        dur = time.perf_counter_ns() - self.t0
        self.metrics.add_extra(self.key, dur)
        _trace.record(self.key, self.t0, dur)


def timed_extra(metrics: Metrics, key: str):
    """Time a sub-phase into ``Metrics.extra[key]`` (nanoseconds) WITHOUT
    touching total_time_ns — for phases that overlap the operator's main
    timing (scan host prep / upload running on a prefetch thread while
    the consumer's ``timed`` covers the dispatch).  Also recorded as a
    span named ``key`` when tracing is enabled."""
    return _TimedExtra(metrics, key)


# ---------------------------------------------------------------------------
# Per-node metrics walk (reference: exec/base.py:276-332)
# ---------------------------------------------------------------------------

def collect_plan_metrics(plan: PhysicalPlan) -> List[dict]:
    """Flatten a plan tree's Metrics in pre-order (``foreach`` order).
    The pre-order index IS the plan node id: two copies of one plan
    share the structure, so index + class name key the merge."""
    out: List[dict] = []

    def one(n: PhysicalPlan) -> None:
        m = n.metrics
        out.append({
            "name": type(n).__name__,
            "rows": int(m.num_output_rows),
            "batches": int(m.num_output_batches),
            "time_ns": int(m.total_time_ns),
            "peak_dev_memory": int(m.peak_dev_memory),
            "extra": {k: v for k, v in m.extra.items()
                      if isinstance(v, (int, float))},
        })
    plan.foreach(one)
    return out


def merge_plan_metrics(plan: PhysicalPlan,
                       recorded: Optional[List[dict]],
                       skip_root: bool = False) -> None:
    """Merge recorded metrics into a tree of the same shape (keyed by
    pre-order node id + class name; a shape mismatch drops the payload
    rather than corrupting the tree's metrics).  Additive, so every
    copy's share accumulates.  ``skip_root`` leaves the root untouched
    (the caller times that node itself)."""
    if not recorded:
        return
    nodes: List[PhysicalPlan] = []
    plan.foreach(nodes.append)
    if len(nodes) != len(recorded):
        return
    for i, (n, r) in enumerate(zip(nodes, recorded)):
        if (skip_root and i == 0) or r.get("name") != type(n).__name__:
            continue
        m = n.metrics
        if r.get("rows"):
            m.add_rows(int(r["rows"]))
        if r.get("batches"):
            m.add_batches(int(r["batches"]))
        if r.get("time_ns"):
            m.add_time_ns(int(r["time_ns"]))
        if r.get("peak_dev_memory"):
            m.max_peak(int(r["peak_dev_memory"]))
        for k, v in (r.get("extra") or {}).items():
            m.add_extra(k, v)
