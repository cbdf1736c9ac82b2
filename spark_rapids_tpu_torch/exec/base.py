"""Physical plan contracts.

Ported from ``spark_rapids_tpu/exec/base.py``: the coalesce goals,
``Metrics``, ``PhysicalPlan`` (``is_tpu``, ``simple_string``,
``tree_string``, ``foreach``), ``TpuExec``, ``timed`` and
``timed_extra``, with their hooks into tracing (``obs/trace.py``) and
cooperative cancellation (``sched/cancel.py``).  The reference's
peak-memory metric and the executor-side metrics round trip wait for the
ported ``shuffle/``.

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
