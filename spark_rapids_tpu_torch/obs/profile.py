"""Per-query profiles: the whole-query view assembled after each action.

A :class:`QueryProfile` is the engine's answer to "where did this query
spend its time": the physical plan tree annotated per-exec with
rows/batches/time/extra, a wall-clock breakdown (host prep vs upload vs
dispatch vs shuffle vs semaphore wait), the per-query registry delta
grouped into sections (scan / shuffle / semaphore / spill / pyworker),
spill and arena high-water marks, the plan-time ``explain`` fallback
report, and the query's span window (exportable as a Chrome trace).

Assembly: :class:`QueryRun` is opened by
``TpuSparkSession._execute_attributed`` before planning; ``finish()``
carves the registry delta and span window and walks the executed plan.
Surfaces: ``session.last_query_profile()``, ``DataFrame.explain("profile")``,
``profile.to_json()`` and ``profile.dump_chrome_trace(path)``.

Copied from ``spark_rapids_tpu/obs/profile.py``, its imports
retargeted.  ``plan_digest`` is the query service's
(``plan/digest.py``).  The per-exec times and the wall breakdown are
host timers, as in the reference: CUDA launches return before the card
finishes, so the exec that waits on the card (the packed download, a
host read of a count) carries the device time of the execs before it.
Assembly adds no wait on the card; a row count that an exec left on the
card as a 0-d tensor is read when its ``Metrics`` are (after the
query's download has waited for the card).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.obs import trace as obstrace

# registry sections the profile always surfaces, even when empty — the
# acceptance contract is "includes scan, shuffle, semaphore, and spill
# sections" whether or not the query touched them
SECTIONS = ("scan", "shuffle", "semaphore", "spill", "pyworker",
            "fusion", "sched", "kernel", "compile", "incremental",
            "sharing", "join")

# work-sharing metrics routed into one "sharing" section even though
# their names span three prefixes (sched.dedup.*, scan.shared.*,
# serve.batch.*): the per-query work-sharing story — flights joined,
# scan batches multicast, statements coalesced — reads as one section
_SHARING_PREFIXES = ("sched.dedup.", "scan.shared.", "serve.batch.")

# the out-of-core/skew join story reads as ONE section: grace-join
# counters (join.grace.* — activations, partitions, restreams, spilled
# build bytes, recursion depth) route by their natural prefix, and the
# shuffle-boundary skew-split counters (shuffle.skew.* — hot buckets
# detected, splits, broadcast-vs-replicate decisions) are pulled in
# beside them so a skewed join's whole mitigation record sits together
_JOIN_PREFIXES = ("join.", "shuffle.skew.")

# compile-observatory metrics routed into the "compile" section even
# though their names carry the kernel. prefix: the per-query compile
# story (programs compiled, cache tiers, compile wall) reads as one
# section instead of drowning in the dispatch counters
_COMPILE_SECTION = ("kernel.cache.compiles", "kernel.cache.memHits",
                    "kernel.cache.persistentHits")


def _section_of(name: str) -> str:
    if name.startswith("kernel.compile.") or name in _COMPILE_SECTION:
        return "compile"
    if name.startswith(_SHARING_PREFIXES):
        return "sharing"
    if name.startswith(_JOIN_PREFIXES):
        return "join"
    return name.split(".", 1)[0]


@dataclass
class ExecNodeProfile:
    """One physical-plan node's annotated metrics."""

    name: str
    is_tpu: bool
    rows: int
    batches: int
    time_ns: int
    peak_dev_memory: int
    extra: Dict[str, Any]
    children: List["ExecNodeProfile"] = field(default_factory=list)

    @classmethod
    def from_plan(cls, node) -> "ExecNodeProfile":
        m = node.metrics
        return cls(
            name=node.simple_string(),
            is_tpu=bool(node.is_tpu),
            rows=int(m.num_output_rows),
            batches=int(m.num_output_batches),
            time_ns=int(m.total_time_ns),
            peak_dev_memory=int(m.peak_dev_memory),
            extra=dict(m.extra),
            children=[cls.from_plan(c) for c in node.children])

    def to_dict(self) -> Dict[str, Any]:
        extra = {}
        for k, v in self.extra.items():
            extra[k] = v
            # time-valued extras are ns internally (the Metrics unit
            # contract); render the explicit seconds view alongside
            if isinstance(v, (int, float)) and (
                    k.endswith("Time") or k.endswith("Ns")):
                extra[k + "_s"] = v / 1e9
        return {"name": self.name, "is_tpu": self.is_tpu,
                "rows": self.rows, "batches": self.batches,
                "time_ns": self.time_ns,
                "time_s": self.time_ns / 1e9,
                "peak_dev_memory": self.peak_dev_memory,
                "extra": extra,
                "children": [c.to_dict() for c in self.children]}

    def tree_lines(self, depth: int = 0) -> List[str]:
        pad = "  " * depth
        bits = [f"rows={self.rows}", f"batches={self.batches}",
                f"time={self.time_ns / 1e9:.4f}s"]
        for k in sorted(self.extra):
            v = self.extra[k]
            if isinstance(v, (int, float)) and (
                    k.endswith("Time") or k.endswith("Ns")):
                bits.append(f"{k}={v / 1e9:.4f}s")
            else:
                bits.append(f"{k}={v}")
        star = "*" if self.is_tpu else " "
        lines = [f"{pad}{star}{self.name} [{', '.join(bits)}]"]
        for c in self.children:
            lines.extend(c.tree_lines(depth + 1))
        return lines

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


@dataclass
class QueryProfile:
    """The whole-query observability record (see module docstring)."""

    query_id: int
    status: str                      # "success" | "failure"
    error: Optional[str]
    result_rows: Optional[int]
    wall_ns: int
    phases: Dict[str, int]           # phase name -> ns
    plan: Optional[ExecNodeProfile]
    metrics: Dict[str, Dict[str, Any]]   # section -> flat metric dict
    wall_breakdown: Dict[str, float]     # phase -> seconds
    explain_lines: List[str]
    spans: List[Dict[str, Any]]
    # canonical logical-plan digest (plan/digest.py): alias-insensitive
    # identity shared with the kernel-cache keys and the serving tier's
    # result-set cache; also a /queries column
    plan_digest: Optional[str] = None
    _raw_spans: List[Any] = field(default_factory=list, repr=False)

    # -- rendering ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "query_id": self.query_id,
            "plan_digest": self.plan_digest,
            "status": self.status,
            "error": self.error,
            "result_rows": self.result_rows,
            "wall_s": self.wall_ns / 1e9,
            "phases": {k: v / 1e9 for k, v in self.phases.items()},
            "plan": self.plan.to_dict() if self.plan else None,
            "metrics": self.metrics,
            "wall_breakdown": self.wall_breakdown,
            "explain_lines": self.explain_lines,
            "spans": self.spans,
        }

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def tree_string(self) -> str:
        head = [f"QueryProfile #{self.query_id} [{self.status}] "
                f"wall={self.wall_ns / 1e9:.4f}s "
                f"rows={self.result_rows}"]
        for k, v in self.wall_breakdown.items():
            head.append(f"  {k}: {v:.4f}" +
                        ("" if k.endswith("bytes") else "s"))
        if self.plan is not None:
            head.extend(self.plan.tree_lines(1))
        return "\n".join(head)

    def dump_chrome_trace(self, path: str) -> str:
        """Write this query's span window as Chrome trace-event JSON."""
        return obstrace.dump_chrome_trace(path, self._raw_spans)


def _sectioned(delta: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Group a registry delta's flat names into profile sections by
    prefix; the canonical sections always exist."""
    out: Dict[str, Dict[str, Any]] = {s: {} for s in SECTIONS}
    for kind in ("counters", "gauges"):
        for name, v in delta.get(kind, {}).items():
            d = out.setdefault(_section_of(name), {})
            d[name] = v
            if isinstance(v, (int, float)) and name.endswith("Ns"):
                d[name + "_s"] = v / 1e9
    for name, h in delta.get("histograms", {}).items():
        out.setdefault(_section_of(name), {})[name] = h
    return out


def _compile_attr_s(query_id: Optional[int],
                    sections: Dict[str, Dict[str, Any]]) -> float:
    """Compile wall this query triggered, in seconds: the compile
    observatory's exact token-based attribution (the same source the
    slow-query log uses), falling back to the registry-window delta only
    when the ledger never saw the query — a window delta alone would
    bleed a concurrent neighbour's first calls into this breakdown."""
    if query_id is not None:
        with contextlib.suppress(Exception):
            from spark_rapids_tpu_torch.obs import compile as obscompile
            stats = obscompile.query_stats(query_id)
            if stats is not None:
                return stats["compile_ms"] / 1e3
    return sections.get("compile", {}).get(
        "kernel.compile.wallNs", 0) / 1e9


def _breakdown(plan: Optional[ExecNodeProfile],
               sections: Dict[str, Dict[str, Any]],
               wall_ns: int,
               query_id: Optional[int] = None) -> Dict[str, float]:
    """Wall-clock breakdown in seconds: host prep vs upload vs dispatch
    vs shuffle vs semaphore wait, plus spill traffic in bytes."""
    host_prep = upload = dispatch = shuffle = fused = 0.0
    shuf_map = shuf_transfer = shuf_decode = 0.0
    if plan is not None:
        for n in plan.walk():
            host_prep += n.extra.get("scan.hostPrepTime", 0) / 1e9
            upload += n.extra.get("scan.uploadTime", 0) / 1e9
            # the shuffle wall SPLIT: map-stage compute vs DCN transfer
            # vs reduce-side decode+upload (exchange extras, ns; the
            # map leg is ONE fleet-wide wall in both launch modes —
            # first submit to last submit out — never a per-thread
            # sum).  The legs are walls of possibly-CONCURRENT phases
            # — with the pipelined exchange their sum exceeds
            # shuffle_s exactly when overlap is working
            # (shuffle.pipeline.overlapNs is the headline for how
            # much)
            shuf_map += n.extra.get("exchange.mapStages", 0) / 1e9
            shuf_transfer += n.extra.get("exchange.transfer", 0) / 1e9
            shuf_decode += n.extra.get("exchange.upload", 0) / 1e9
            if "Exchange" in n.name or "Shuffle" in n.name:
                shuffle += n.time_ns / 1e9
            elif n.is_tpu:
                dispatch += n.time_ns / 1e9
                if n.name.startswith("TpuFusedStageExec"):
                    # fused-stage share of dispatch time, so the
                    # whole-stage fusion layer's cost/benefit is
                    # attributable per query (also counted in
                    # dispatch_s — this is an attribution, not a
                    # disjoint phase)
                    fused += n.time_ns / 1e9
    sem = sections.get("semaphore", {})
    spill = sections.get("spill", {})
    sched = sections.get("sched", {})
    return {
        "wall_s": wall_ns / 1e9,
        "queue_wait_s": sched.get("sched.queueWaitNs", 0) / 1e9,
        "host_prep_s": host_prep,
        "upload_s": upload,
        "dispatch_s": dispatch,
        "fused_stage_s": fused,
        # compile wall this query triggered (obs/compile.py; first
        # (kernel, shape) calls — an attribution inside dispatch_s and
        # the exec node times, not a disjoint phase)
        "compile_s": _compile_attr_s(query_id, sections),
        "shuffle_s": shuffle,
        "shuffle_map_s": shuf_map,
        "shuffle_transfer_s": shuf_transfer,
        "shuffle_decode_s": shuf_decode,
        "semaphore_wait_s": sem.get("semaphore.waitNs", 0) / 1e9,
        "spill_device_to_host_bytes":
            spill.get("spill.deviceToHostBytes", 0),
        "spill_host_to_disk_bytes":
            spill.get("spill.hostToDiskBytes", 0),
    }


class _Phase:
    __slots__ = ("run", "name", "t0")

    def __init__(self, run: "QueryRun", name: str):
        self.run = run
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        dur = time.perf_counter_ns() - self.t0
        self.run.phases[self.name] = \
            self.run.phases.get(self.name, 0) + dur
        obstrace.record(f"query.{self.name}", self.t0, dur, cat="query")


class QueryRun:
    """Per-query capture opened by the session before planning."""

    def __init__(self, query_id: int,
                 sched_extra: Optional[Dict[str, Any]] = None,
                 plan_digest: Optional[str] = None):
        self.query_id = query_id
        self.plan_digest = plan_digest
        self.phases: Dict[str, int] = {}
        # the session stashes the planner's OverrideResult here as soon
        # as planning succeeds, so a mid-execution failure still
        # profiles the plan (the on_failure contract carries the tree)
        self.planned = None
        # scheduler attribution (queue wait, admission estimate,
        # priority) — recorded by the QueryService BEFORE this run
        # opened its registry view, so it rides the profile explicitly
        # instead of the (later) per-query delta carve
        self.sched_extra: Dict[str, Any] = dict(sched_extra or {})
        self._view = obsreg.get_registry().view()
        self._span_mark = obstrace.mark()
        self._t0 = time.perf_counter_ns()
        wait = self.sched_extra.get("sched.queueWaitNs", 0)
        if wait:
            # re-record the pre-execution queue wait inside this
            # query's span window, so its trace shows the wait
            obstrace.record("sched.queueWait", self._t0 - int(wait),
                            int(wait), cat="sched",
                            args={"query": query_id})

    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def finish(self, result=None, table=None,
               error: Optional[BaseException] = None) -> QueryProfile:
        """Assemble the QueryProfile.  ``result`` is the planner's
        OverrideResult (may be None when planning itself failed);
        ``table`` the collected Arrow table on success."""
        wall_ns = time.perf_counter_ns() - self._t0
        plan_prof = None
        explain_lines: List[str] = []
        if result is not None:
            with contextlib.suppress(Exception):
                plan_prof = ExecNodeProfile.from_plan(result.plan)
            with contextlib.suppress(Exception):
                explain_lines = result.meta.explain_lines(all_=True)
        delta = self._view.delta()
        sections = _sectioned(delta)
        if self.sched_extra:
            sec = sections.setdefault("sched", {})
            for k, v in self.sched_extra.items():
                sec[k] = v
                if isinstance(v, (int, float)) and k.endswith("Ns"):
                    sec[k + "_s"] = v / 1e9
        # arena / spill high-water marks ride the spill section
        with contextlib.suppress(Exception):
            from spark_rapids_tpu_torch.mem import spill as spillmod
            if spillmod.is_enabled():
                cat = spillmod.get_catalog()
                sections["spill"]["spill.deviceBytesNow"] = \
                    cat.device_bytes
                sections["spill"]["spill.hostBytesNow"] = cat.host_bytes
                # read without making the arena (a pinned allocation)
                sections["spill"]["spill.arenaPeakBytes"] = \
                    cat.arena_peak
        raw_spans = obstrace.spans_since(self._span_mark)
        prof = QueryProfile(
            query_id=self.query_id,
            plan_digest=self.plan_digest,
            status="failure" if error is not None else "success",
            error=(f"{type(error).__name__}: {error}"
                   if error is not None else None),
            result_rows=(table.num_rows if table is not None else None),
            wall_ns=wall_ns,
            phases=dict(self.phases),
            plan=plan_prof,
            metrics=sections,
            wall_breakdown=_breakdown(plan_prof, sections, wall_ns,
                                      query_id=self.query_id),
            explain_lines=explain_lines,
            spans=obstrace.span_dicts(raw_spans),
            _raw_spans=raw_spans)
        return prof
