"""BenchmarkRunner + CompareResults.

Ported from ``spark_rapids_tpu/bench/runner.py`` unchanged (it imports
nothing of either engine): a suite's queries run N times against one
session with per-iteration timings collected into a JSON report, and a
result comparison with a float tolerance and optional row-order
independence.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import pyarrow as pa


@dataclass
class QueryReport:
    query: str
    iterations: List[float]          # seconds per iteration
    rows: int
    error: Optional[str] = None

    @property
    def best(self) -> float:
        return min(self.iterations) if self.iterations else math.nan

    @property
    def mean(self) -> float:
        return (sum(self.iterations) / len(self.iterations)
                if self.iterations else math.nan)


@dataclass
class BenchmarkReport:
    suite: str
    mode: str                        # "cpu" | "tpu"
    queries: List[QueryReport] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({
            "suite": self.suite,
            "mode": self.mode,
            "queries": [{
                "query": q.query, "iterations": q.iterations,
                "rows": q.rows, "best_s": q.best, "mean_s": q.mean,
                "error": q.error,
            } for q in self.queries],
        }, indent=2)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


class BenchmarkRunner:
    """Runs a suite's queries N times against one session and collects
    timings (reference: BenchmarkRunner "collect" mode)."""

    def __init__(self, session, tables: Dict[str, "object"],
                 queries: Dict[str, Callable], suite: str = "tpch",
                 mode: str = "tpu"):
        self.session = session
        self.tables = tables
        self.queries = queries
        self.suite = suite
        self.mode = mode

    def run(self, names: Optional[List[str]] = None, iterations: int = 1,
            warmup: int = 0) -> BenchmarkReport:
        report = BenchmarkReport(self.suite, self.mode)
        for name in (names or sorted(self.queries,
                                     key=lambda q: int(q[1:]))):
            fn = self.queries[name]
            try:
                for _ in range(warmup):
                    fn(self.tables).collect()
                times, rows = [], 0
                for _ in range(iterations):
                    t0 = time.perf_counter()
                    out = fn(self.tables).collect()
                    times.append(time.perf_counter() - t0)
                    rows = out.num_rows
                report.queries.append(QueryReport(name, times, rows))
            except Exception as e:  # noqa: BLE001 — keep benching
                report.queries.append(QueryReport(name, [], 0,
                                                  error=repr(e)))
        return report


class CompareResults:
    """Deep-compares two result tables (reference: BenchUtils.compareResults
    — epsilon floats, optional order independence)."""

    def __init__(self, epsilon: float = 1e-4,
                 ignore_ordering: bool = False):
        self.epsilon = epsilon
        self.ignore_ordering = ignore_ordering

    def _rows(self, t: pa.Table):
        rows = list(zip(*(t.column(i).to_pylist()
                          for i in range(t.num_columns))))
        if self.ignore_ordering:
            rows.sort(key=lambda r: tuple(
                (v is None, str(type(v)), v) for v in r))
        return rows

    def compare(self, expected: pa.Table, actual: pa.Table) -> List[str]:
        """Returns a list of mismatch descriptions (empty = equal)."""
        problems: List[str] = []
        if expected.num_rows != actual.num_rows:
            return [f"row count {expected.num_rows} != {actual.num_rows}"]
        if expected.num_columns != actual.num_columns:
            return [f"column count {expected.num_columns} != "
                    f"{actual.num_columns}"]
        for i, (er, ar) in enumerate(zip(self._rows(expected),
                                         self._rows(actual))):
            for j, (ev, av) in enumerate(zip(er, ar)):
                if not self._value_eq(ev, av):
                    problems.append(
                        f"row {i} col {expected.column_names[j]}: "
                        f"{ev!r} != {av!r}")
                    if len(problems) >= 10:
                        return problems
        return problems

    def _value_eq(self, ev, av) -> bool:
        if ev is None or av is None:
            return ev is None and av is None
        if isinstance(ev, float) and isinstance(av, float):
            if math.isnan(ev) or math.isnan(av):
                return math.isnan(ev) and math.isnan(av)
            scale = max(abs(ev), abs(av), 1.0)
            return abs(ev - av) <= self.epsilon * scale
        return ev == av
