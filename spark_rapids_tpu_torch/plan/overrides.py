"""Plan-override layer: wrap -> tag -> convert, with explain and CPU fallback.

Ported from ``spark_rapids_tpu/plan/overrides.py``.  The flow is the
reference's:

  1. the CPU physical plan is wrapped in a meta tree;
  2. tagging walks the tree recording ``will_not_work_on_tpu`` reasons:
     per-op kill-switch confs (``spark.rapids.tpu.sql.exec.<SparkName>``,
     ``...sql.expression.<Name>``), unsupported dtypes, expressions the
     device evaluator does not cover, incompatible ops gated behind
     their confs;
  3. conversion replaces only fully supported nodes with device execs on
     the session's device and inserts HostToDevice/DeviceToHost
     transitions at currency boundaries; then whole-stage fusion
     (plan/fusion.py), the filter fused into the aggregate, the
     ``_kernel_backend`` stamp, the filter pushed into the Parquet scan
     (under ``pallas``; never into an ORC scan) and, when the plan reads
     ``input_file_name()``, the scan's switch to its PERFILE reader, in
     that order;
  4. ``explain`` renders the per-node decisions
     (``spark.rapids.tpu.sql.explain=NOT_ON_TPU|ALL``).

Rules exist for the execs the port has: Project, Filter, HashAggregate,
Range, Union, GlobalLimit, Expand, Generate, Sort, Window, the shuffle
exchange and the partition coalesce, the shuffled and the broadcast hash
joins, the broadcast nested-loop join, the cartesian product, the cached
scan and the file scan (the in-memory scan stays a host node under its
HostToDevice transition).  The file-scan rule is the reference's
(:505-548): Parquet, ORC and CSV scans convert to ``TpuParquetScanExec``,
``TpuOrcScanExec`` and ``TpuCsvScanExec``, and stay on the host under
their ``deviceDecode.enabled`` kill switches, as does a CSV scan with
Hive partition columns.

The shuffled-join rule wraps the join's two exchanges in coordinated
adaptive readers (``exec/adaptive.wrap_join_children``:
``TpuAdaptiveJoinReaderExec`` under ``sql.adaptive.enabled``, on by
default, or ``TpuSkewJoinReaderExec`` under ``sql.join.skew.enabled``),
as the reference's does; a user's ``repartition`` stays a bare exchange.
It also stamps the grace-join budget on the join (``_oocore``,
exec/join_partition.resolve_oocore; None under
``sql.join.oocore.enabled=false`` or ``buildSideBudgetBytes=-1``), so
the skew split composes with the grace join.  The port's planner never
builds the reference's plain ``CpuJoinExec``, so it has no rule for
one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Type

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.config import RapidsTpuConf
from spark_rapids_tpu_torch.exec import cpu as cpux
from spark_rapids_tpu_torch.exec import tpu_basic as tpub
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.exec.tpu_aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.tpu_sort import TpuSortExec
from spark_rapids_tpu_torch.expr import eval_tpu, ir


# ---------------------------------------------------------------------------
# Expression support checks
# ---------------------------------------------------------------------------

_LITERAL_ARG_EXPRS = {
    # the pattern splits into its segments on the host; a per-row pattern
    # column would need a dynamic matcher -- fall back (the reference's
    # GpuLike literal-pattern restriction)
    ir.Like: "LIKE pattern must be a literal",
}


_TPU_AGG_FNS = (ir.Count, ir.Sum, ir.Min, ir.Max, ir.Average, ir.First,
                ir.Last)


def _check_expr_node(e: ir.Expression, conf: RapidsTpuConf
                     ) -> Optional[str]:
    """Return a fallback reason if this single node can't run on the
    device."""
    if isinstance(e, ir.AggregateExpression):
        # aggregates are evaluated by the aggregate exec's update/merge
        # specs, not the row-wise evaluator
        if not isinstance(e, _TPU_AGG_FNS):
            return (f"aggregate {type(e).__name__} is not supported on TPU")
    elif not eval_tpu.supported_on_tpu(type(e)):
        return f"expression {type(e).__name__} is not supported on TPU"
    key = f"spark.rapids.tpu.sql.expression.{type(e).__name__}"
    if not conf.is_operator_enabled(key, incompat=False,
                                   disabled_by_default=False):
        return f"expression {type(e).__name__} disabled by {key}"
    if type(e) in _LITERAL_ARG_EXPRS:
        if not isinstance(e.children[1], ir.Literal):
            return _LITERAL_ARG_EXPRS[type(e)]
    if isinstance(e, ir.RegExpReplace):
        pat = e.children[1]
        rep = e.children[2]
        if not isinstance(pat, ir.Literal) or pat.value is None or \
                not isinstance(rep, ir.Literal) or rep.value is None:
            return "regexp_replace pattern/replacement must be literals"
        from spark_rapids_tpu_torch.expr.eval_tpu import _REGEX_META
        if "$" in rep.value or "\\" in rep.value:
            return ("regexp replacement with $group/backslash "
                    "references is not supported on TPU")
        if not pat.value or any(ch in _REGEX_META for ch in pat.value):
            # real regex: device NFA subset (expr/device_regex.py);
            # alternation replace diverges from Java's leftmost-branch
            # pick and empty-matchable patterns insert at every gap
            from spark_rapids_tpu_torch.expr import device_regex as dr
            try:
                cr = dr.compile_pattern(pat.value or "")
            except dr.Unsupported as ex:
                return (f"regexp pattern '{pat.value}' outside the "
                        f"device regex subset: {ex}")
            if not cr.replace_safe:
                return ("regexp_replace pattern where Java greedy "
                        "semantics may differ from longest-match "
                        "(alternation, empty-matchable, or multiple "
                        "variable-length elements) — not on TPU")
    if isinstance(e, ir.RLike):
        pat = e.children[1]
        if not isinstance(pat, ir.Literal):
            return "rlike pattern must be a literal"
        if pat.value is not None:
            from spark_rapids_tpu_torch.expr import device_regex as dr
            try:
                dr.compile_pattern(pat.value)
            except dr.Unsupported as ex:
                return (f"rlike pattern '{pat.value}' outside the "
                        f"device regex subset: {ex}")
    if isinstance(e, ir.StringLocate):
        if not isinstance(e.children[0], ir.Literal) or \
           not isinstance(e.children[2], ir.Literal):
            return "locate substr/start must be literals"
    if isinstance(e, (ir.LPad, ir.RPad)):
        if not isinstance(e.children[1], ir.Literal) or \
           not isinstance(e.children[2], ir.Literal):
            return "pad length/fill must be literals"
    if isinstance(e, ir.Cast):
        src = e.children[0].dtype
        if src is not None and src != e.to and src != dt.NULL:
            if src.is_string and e.to.is_floating and \
                    not conf.get(cfg.CAST_STRING_TO_FLOAT) and \
                    not conf.get(cfg.INCOMPATIBLE_OPS):
                return ("cast string->float can differ from Spark in "
                        "the last ulp; enable "
                        f"{cfg.CAST_STRING_TO_FLOAT.key}")
            if src.is_string and e.to.id == dt.TypeId.TIMESTAMP_US and \
                    not conf.get(cfg.ALLOW_INCOMPAT_UTC_ONLY):
                return ("cast string->timestamp is UTC-only on TPU; "
                        f"enable {cfg.ALLOW_INCOMPAT_UTC_ONLY.key}")
            if src.is_string and not eval_tpu.cast_supported(src, e.to):
                return f"cast string->{e.to.name} not supported on TPU yet"
            if e.to.is_string and src.is_floating and \
                    not conf.get(cfg.CAST_FLOAT_TO_STRING):
                return ("cast float->string disabled; enable "
                        f"{cfg.CAST_FLOAT_TO_STRING.key}")
            if e.to.is_string and not eval_tpu.cast_supported(src, e.to):
                return f"cast {src.name}->string not supported on TPU yet"
            if not eval_tpu.cast_supported(src, e.to):
                return f"cast {src.name}->{e.to.name} not supported on TPU yet"
    if isinstance(e, (ir.Sum, ir.Average)) and e.child is not None and \
            e.child.dtype is not None and e.child.dtype.is_floating:
        if not conf.get(cfg.VARIABLE_FLOAT_AGG) and \
           not conf.get(cfg.INCOMPATIBLE_OPS):
            return ("float/double aggregation order differs from Spark; "
                    "enable spark.rapids.tpu.sql.variableFloatAgg.enabled")
    return None


def check_exprs(exprs: List[ir.Expression], conf: RapidsTpuConf
                ) -> List[str]:
    reasons: List[str] = []

    def walk(e: ir.Expression):
        r = _check_expr_node(e, conf)
        if r:
            reasons.append(r)
        for c in e.children:
            walk(c)
    for e in exprs:
        walk(e)
    return reasons


# ---------------------------------------------------------------------------
# Exec replacement rules
# ---------------------------------------------------------------------------

@dataclass
class ExecRule:
    spark_name: str                      # key used for kill-switch + explain
    description: str
    exprs_of: Callable[[PhysicalPlan], List[ir.Expression]]
    # (cpu node, converted children, conf, device) -> device exec
    convert: Callable[..., PhysicalPlan]
    extra_tag: Optional[Callable[[PhysicalPlan, RapidsTpuConf],
                                 List[str]]] = None
    incompat: bool = False
    disabled_by_default: bool = False


def _no_exprs(n: PhysicalPlan) -> List[ir.Expression]:
    return []


_EXEC_RULES: Dict[Type[PhysicalPlan], ExecRule] = {}


def register_exec_rule(cpu_cls: Type[PhysicalPlan], rule: ExecRule) -> None:
    _EXEC_RULES[cpu_cls] = rule


def _sort_unsupported_types(n: cpux.CpuSortExec, conf) -> List[str]:
    out = []
    for o in n.orders:
        if o.expr.dtype is not None and o.expr.dtype.is_floating and \
                not conf.get(cfg.ENABLE_FLOAT_SORT):
            out.append("float sort disabled")
    out.extend(_nested_key_reasons((o.expr for o in n.orders), "sort"))
    return out


def _nested_key_reasons(exprs, role: str) -> List[str]:
    out = []
    for e in exprs:
        if e is not None and e.dtype is not None and e.dtype.is_nested:
            out.append(f"nested type {e.dtype.name} not supported as a "
                       f"{role} key on TPU")
    return out


register_exec_rule(cpux.CpuScanExec, ExecRule(
    "InMemoryScan", "in-memory table scan feeding the device",
    _no_exprs,
    # the scan stays on the host; the HostToDevice transition above it
    # makes it device-feeding
    convert=lambda n, ch, conf, device: n))

register_exec_rule(cpux.CpuProjectExec, ExecRule(
    "ProjectExec", "device projection (bound-expression columnar eval)",
    lambda n: list(n.exprs),
    convert=lambda n, ch, conf, device: tpub.TpuProjectExec(
        ch[0], n.exprs, n.schema)))

register_exec_rule(cpux.CpuFilterExec, ExecRule(
    "FilterExec", "device filter (mask + stream compaction)",
    lambda n: [n.condition],
    convert=lambda n, ch, conf, device: tpub.TpuFilterExec(
        ch[0], n.condition)))

register_exec_rule(cpux.CpuRangeExec, ExecRule(
    "RangeExec", "device range generation",
    _no_exprs,
    convert=lambda n, ch, conf, device: tpub.TpuRangeExec(
        n.start, n.end, n.step, n.num_partitions, device=device)))

register_exec_rule(cpux.CpuUnionExec, ExecRule(
    "UnionExec", "device union (partition concatenation)",
    _no_exprs,
    convert=lambda n, ch, conf, device: tpub.TpuUnionExec(ch)))

register_exec_rule(cpux.CpuLimitExec, ExecRule(
    "GlobalLimitExec", "device global limit",
    _no_exprs,
    convert=lambda n, ch, conf, device: tpub.TpuGlobalLimitExec(ch[0],
                                                                n.n)))

register_exec_rule(cpux.CpuSortExec, ExecRule(
    "SortExec", "device total sort (total-order key encode + lexsort)",
    lambda n: [o.expr for o in n.orders],
    convert=lambda n, ch, conf, device: TpuSortExec(ch[0], n.orders,
                                                    n.partitionwise),
    extra_tag=_sort_unsupported_types))

register_exec_rule(cpux.CpuHashAggregateExec, ExecRule(
    "HashAggregateExec",
    "device hash aggregate (sort-based segmented reduction)",
    lambda n: list(n.groupings) + list(n.aggregates),
    convert=lambda n, ch, conf, device: TpuHashAggregateExec(
        ch[0], n.groupings, n.aggregates, n.schema,
        per_partition=n.per_partition),
    extra_tag=lambda n, conf: _nested_key_reasons(n.groupings, "grouping")))

register_exec_rule(cpux.CpuExpandExec, ExecRule(
    "ExpandExec", "device expand (N projections per row)",
    lambda n: [e for p in n.projections for e in p],
    convert=lambda n, ch, conf, device: tpub.TpuExpandExec(
        ch[0], n.projections, n.schema)))


def _tag_window(n, conf) -> List[str]:
    out = []
    for we in n.window_exprs:
        out.extend(_nested_key_reasons(we.partition_exprs,
                                       "window partition"))
        out.extend(_nested_key_reasons(we.order_exprs, "window order"))
        out.extend(_nested_key_reasons(we.function.children,
                                       "window input"))
        fn = we.function
        fr = we.frame
        finite_range = fr.kind == "range" and not (
            fr.start is None and fr.end in (0, None))
        if finite_range:
            # device range frames binary-search the single numeric/
            # temporal order key
            if len(we.order_exprs) != 1:
                out.append("finite RANGE frames require exactly one "
                           "ORDER BY expression")
            else:
                od = we.order_exprs[0].dtype
                if od is not None and not (od.is_numeric or od.is_temporal):
                    out.append(f"finite RANGE frames need a numeric or "
                               f"temporal order key, got {od.name}")
        if isinstance(fn, ir.AggregateExpression):
            if not isinstance(fn, (ir.Count, ir.Sum, ir.Average, ir.Min,
                                   ir.Max)):
                out.append(f"window aggregate {type(fn).__name__} not "
                           f"supported on TPU")
            if fn.child is not None and fn.child.dtype is not None and \
                    fn.child.dtype.is_string:
                out.append("string window aggregates not supported on TPU")
        elif not isinstance(fn, (ir.RowNumber, ir.Rank, ir.DenseRank,
                                 ir.Lead, ir.Lag)):
            out.append(f"window function {type(fn).__name__} not "
                       f"supported on TPU")
    return out


def _register_window_rule():
    from spark_rapids_tpu_torch.exec.cpu_window import CpuWindowExec
    from spark_rapids_tpu_torch.exec.tpu_window import TpuWindowExec

    def _win_exprs(n) -> List[ir.Expression]:
        # partition/order exprs and the function's inputs; the window
        # function node itself is vetted by _tag_window
        out: List[ir.Expression] = []
        for we in n.window_exprs:
            out.extend(we.partition_exprs)
            out.extend(we.order_exprs)
            out.extend(we.function.children)
        return out

    register_exec_rule(CpuWindowExec, ExecRule(
        "WindowExec",
        "device window functions (one stable sort + segmented scans/"
        "prefix sums)",
        _win_exprs,
        convert=lambda n, ch, conf, device: TpuWindowExec(
            ch[0], n.window_exprs, n.out_names, n.schema, n.partitionwise),
        extra_tag=_tag_window))


_register_window_rule()


def _tag_join(n: cpux.CpuJoinExec, conf) -> List[str]:
    out = []
    if n.how != "cross" and not n.left_keys:
        out.append("non-equi join without keys requires nested loop "
                   "(only cross supported on TPU)")
    for kd in (n.key_dtypes or []):
        if kd is not None and kd.is_nested:
            out.append(f"nested type {kd.name} not supported as a join "
                       f"key on TPU")
    return out


def _join_exprs(n: cpux.CpuJoinExec) -> List[ir.Expression]:
    return [n.condition] if n.condition is not None else []


def _register_join_strategy_rules():
    from spark_rapids_tpu_torch.exec.tpu_join import (
        TpuBroadcastHashJoinExec, TpuBroadcastNestedLoopJoinExec,
        TpuCartesianProductExec, TpuShuffledHashJoinExec)

    def _convert_shuffled_join(n, ch, conf, device):
        # AQE analog: both exchange children share one coordinated spec
        # list (coalesce + skew split) so co-partitioning survives
        from spark_rapids_tpu_torch.exec.adaptive import wrap_join_children
        from spark_rapids_tpu_torch.exec.join_partition import \
            resolve_oocore
        left, right = wrap_join_children(ch[0], ch[1], n.how, conf)
        j = TpuShuffledHashJoinExec(left, right, n.left_keys,
                                    n.right_keys, n.how, n.condition,
                                    n.schema)
        # the out-of-core budget is resolved at conversion time (None:
        # the unconditional gather); execute() never reads the conf
        j._oocore = resolve_oocore(conf, device)
        return j

    register_exec_rule(cpux.CpuShuffledHashJoinExec, ExecRule(
        "ShuffledHashJoinExec",
        "device partitioned equi-join over co-partitioned exchanges",
        _join_exprs,
        convert=_convert_shuffled_join,
        extra_tag=_tag_join))

    register_exec_rule(cpux.CpuBroadcastHashJoinExec, ExecRule(
        "BroadcastHashJoinExec",
        "device broadcast equi-join (build side gathered once, stream "
        "side stays partitioned)",
        _join_exprs,
        convert=lambda n, ch, conf, device: TpuBroadcastHashJoinExec(
            ch[0], ch[1], n.left_keys, n.right_keys, n.how, n.condition,
            n.schema, build_side=n.build_side,
            transport=conf.get(cfg.SHUFFLE_TRANSPORT)),
        extra_tag=_tag_join))

    register_exec_rule(cpux.CpuBroadcastNestedLoopJoinExec, ExecRule(
        "BroadcastNestedLoopJoinExec",
        "device broadcast nested-loop join (cross product + filter)",
        _join_exprs,
        convert=lambda n, ch, conf, device: TpuBroadcastNestedLoopJoinExec(
            ch[0], ch[1], n.condition, n.schema,
            build_side=n.build_side)))

    register_exec_rule(cpux.CpuCartesianProductExec, ExecRule(
        "CartesianProductExec",
        "device partition-pairwise cartesian product",
        _join_exprs,
        convert=lambda n, ch, conf, device: TpuCartesianProductExec(
            ch[0], ch[1], n.condition, n.schema)))


_register_join_strategy_rules()


def _register_generate_rule():
    from spark_rapids_tpu_torch.exec.generate import (CpuGenerateExec,
                                                      TpuGenerateExec)

    def _tag_generate(n, conf) -> List[str]:
        out = []
        d = n.generator.children[0].dtype
        if d is None or not d.is_list or not dt.device_supported(d):
            out.append(f"generator input type "
                       f"{d.name if d else '?'} not supported on TPU")
        return out

    register_exec_rule(CpuGenerateExec, ExecRule(
        "GenerateExec",
        "TPU explode/posexplode (two-pass count-then-emit element gather)",
        lambda n: list(n.generator.children),
        convert=lambda n, ch, conf, device: TpuGenerateExec(
            ch[0], n.generator, n.schema),
        extra_tag=_tag_generate))


_register_generate_rule()


def _tag_exchange(n, conf) -> List[str]:
    from spark_rapids_tpu_torch.shuffle import exchange as ex
    out = []
    if isinstance(n.partitioning, ex.RangePartitioning):
        for o in n.partitioning.orders:
            if o.expr.dtype is not None and o.expr.dtype.is_floating and \
                    not conf.get(cfg.ENABLE_FLOAT_SORT):
                out.append("float range partitioning disabled")
    out.extend(_nested_key_reasons(n.partitioning.exprs(), "partitioning"))
    return out


def _register_exchange_rule():
    from spark_rapids_tpu_torch.shuffle import exchange as ex

    register_exec_rule(ex.CpuCoalescePartitionsExec, ExecRule(
        "CoalesceExec",
        "device partition coalesce (iterator regrouping, no data "
        "movement)",
        _no_exprs,
        convert=lambda n, ch, conf, device: ex.TpuCoalescePartitionsExec(
            ch[0], n.num_partitions)))

    # a user repartition keeps its exact partition count; the reference
    # wraps only the planner's join exchanges in adaptive readers
    register_exec_rule(ex.CpuShuffleExchangeExec, ExecRule(
        "ShuffleExchangeExec",
        "device shuffle exchange (on-device partition slicing; local "
        "Arrow-IPC or device-resident data plane)",
        lambda n: n.partitioning.exprs(),
        convert=lambda n, ch, conf, device: ex.TpuShuffleExchangeExec(
            ch[0], n.partitioning, conf),
        extra_tag=_tag_exchange))


_register_exchange_rule()


def _register_file_scan_rule():
    from spark_rapids_tpu_torch.io.device_scan import (TpuCsvScanExec,
                                                       TpuOrcScanExec,
                                                       TpuParquetScanExec)
    from spark_rapids_tpu_torch.io.readers import CpuFileScanExec

    def _tag_scan(n, conf) -> List[str]:
        out = []
        if n.scan.fmt == "parquet":
            if not conf.get(cfg.PARQUET_DEVICE_DECODE):
                out.append("parquet device decode disabled by "
                           f"{cfg.PARQUET_DEVICE_DECODE.key}")
        elif n.scan.fmt == "orc":
            if not conf.get(cfg.ORC_DEVICE_DECODE):
                out.append("orc device decode disabled by "
                           f"{cfg.ORC_DEVICE_DECODE.key}")
        elif n.scan.fmt == "csv":
            if not conf.get(cfg.CSV_DEVICE_DECODE):
                out.append("csv device decode disabled by "
                           f"{cfg.CSV_DEVICE_DECODE.key}")
            elif n.scan.options.get("part_fields"):
                out.append("csv device decode does not yet append "
                           "Hive partition columns")
        else:
            out.append(f"{n.scan.fmt} scans decode on host "
                       "(device decode is parquet/orc/csv-only)")
        return out

    def _convert_scan(n, ch, conf, device):
        if n.scan.fmt == "orc":
            return TpuOrcScanExec(n.scan, conf, device=device)
        if n.scan.fmt == "csv":
            return TpuCsvScanExec(n.scan, conf, device=device)
        return TpuParquetScanExec(n.scan, conf, device=device)

    register_exec_rule(CpuFileScanExec, ExecRule(
        "FileSourceScanExec",
        "device parquet/ORC/CSV scan: packed pages/streams or raw bytes "
        "upload, RLE/dictionary/def-level decode or the delimiter scan "
        "and field parse on the device",
        _no_exprs,
        convert=_convert_scan,
        extra_tag=_tag_scan))


_register_file_scan_rule()


def _register_cache_scan_rule():
    from spark_rapids_tpu_torch.exec.cache import (CpuInMemoryTableScanExec,
                                                   TpuInMemoryTableScanExec)

    def _tag_cache(n, conf) -> List[str]:
        if not conf.get(cfg.CACHE_DEVICE_DECODE):
            return ["cached-batch device decode disabled by "
                    f"{cfg.CACHE_DEVICE_DECODE.key}"]
        return []

    register_exec_rule(CpuInMemoryTableScanExec, ExecRule(
        "InMemoryTableScanExec",
        "device cached-batch scan: parquet blobs decode on the device "
        "through the PERFILE reader",
        _no_exprs,
        convert=lambda n, ch, conf, device: TpuInMemoryTableScanExec(
            n.relation, conf, device=device),
        extra_tag=_tag_cache))


_register_cache_scan_rule()


# ---------------------------------------------------------------------------
# Meta tree
# ---------------------------------------------------------------------------

@dataclass
class ExecMeta:
    node: PhysicalPlan
    rule: Optional[ExecRule]
    children: List["ExecMeta"] = field(default_factory=list)
    reasons: List[str] = field(default_factory=list)

    def will_not_work_on_tpu(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_run_on_tpu(self) -> bool:
        return self.rule is not None and not self.reasons

    def explain_lines(self, all_: bool, depth: int = 0) -> List[str]:
        name = self.rule.spark_name if self.rule else \
            type(self.node).__name__
        pad = "  " * depth
        lines = []
        if self.can_run_on_tpu:
            if all_:
                lines.append(f"{pad}*Exec <{name}> will run on TPU")
        else:
            why = "; ".join(self.reasons) or "no TPU replacement rule"
            lines.append(f"{pad}!Exec <{name}> cannot run on TPU because "
                         f"{why}")
        for c in self.children:
            lines.extend(c.explain_lines(all_, depth + 1))
        return lines


def _supported_schema_reasons(node: PhysicalPlan) -> List[str]:
    out = []
    for f in node.schema.fields:
        if not dt.device_supported(f.dtype):
            out.append(f"unsupported type {f.dtype} for column {f.name}")
    return out


def wrap_and_tag(node: PhysicalPlan, conf: RapidsTpuConf) -> ExecMeta:
    rule = _EXEC_RULES.get(type(node))
    meta = ExecMeta(node, rule)
    meta.children = [wrap_and_tag(c, conf) for c in node.children]
    if rule is None:
        meta.will_not_work_on_tpu(
            f"no TPU replacement for {type(node).__name__}")
        return meta
    if not conf.sql_enabled:
        meta.will_not_work_on_tpu("TPU SQL acceleration is disabled")
        return meta
    key = f"spark.rapids.tpu.sql.exec.{rule.spark_name}"
    if not conf.is_operator_enabled(key, rule.incompat,
                                   rule.disabled_by_default):
        meta.will_not_work_on_tpu(f"disabled by {key}")
    for r in _supported_schema_reasons(node):
        meta.will_not_work_on_tpu(r)
    for r in check_exprs(rule.exprs_of(node), conf):
        meta.will_not_work_on_tpu(r)
    if rule.extra_tag is not None:
        for r in rule.extra_tag(node, conf):
            meta.will_not_work_on_tpu(r)
    return meta


# ---------------------------------------------------------------------------
# Conversion with transition insertion
# ---------------------------------------------------------------------------

def _convert(meta: ExecMeta, conf: RapidsTpuConf, device) -> PhysicalPlan:
    """Bottom-up conversion; returns a plan whose output currency is the
    device (TpuExec) or the host (PhysicalPlan)."""
    children = [_convert(c, conf, device) for c in meta.children]

    # a CPU scan feeding a device subtree is handled by the parent's
    # transition; the in-memory scan itself never converts
    if meta.can_run_on_tpu and not isinstance(meta.node, cpux.CpuScanExec):
        min_bucket = conf.get(cfg.MIN_BUCKET_ROWS)
        dev_children = [
            c if c.is_tpu else tpub.HostToDeviceExec(c, min_bucket,
                                                     device=device)
            for c in children]
        return meta.rule.convert(meta.node, dev_children, conf, device)

    # CPU node: host inputs required
    host_children = [
        c if not c.is_tpu else tpub.DeviceToHostExec(c)
        for c in children]
    node = meta.node
    if host_children and tuple(host_children) != tuple(node.children):
        node.children = tuple(host_children)
    return node


def _plan_uses_input_file(plan: PhysicalPlan) -> bool:
    """Does any expression anywhere in the plan read input_file_name()?"""
    found: List[bool] = []

    def walk_expr(e):
        if isinstance(e, ir.InputFileName):
            found.append(True)
        for c in getattr(e, "children", ()):
            walk_expr(c)

    def visit(n):
        for v in vars(n).values():
            if isinstance(v, ir.Expression):
                walk_expr(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, ir.Expression):
                        walk_expr(x)
                    elif hasattr(x, "expr") and \
                            isinstance(getattr(x, "expr"), ir.Expression):
                        walk_expr(x.expr)  # SortOrder-like wrappers

    plan.foreach(visit)
    return bool(found)


class TpuOverrides:
    """The ColumnarRule analog: apply() rewrites the CPU physical plan."""

    @staticmethod
    def apply(cpu_plan: PhysicalPlan, conf: RapidsTpuConf,
              device="cuda") -> "OverrideResult":
        """Rewrite ``cpu_plan``; device execs and transitions are built
        on ``device`` (the session's)."""
        from spark_rapids_tpu_torch.kernels import backend as kb
        meta = wrap_and_tag(cpu_plan, conf)
        plan = _convert(meta, conf, device)
        if conf.get(cfg.FUSION_ENABLED):
            # whole-stage fusion: collapse Project/Filter chains and
            # inline aggregate prologues before the lone-filter pass
            from spark_rapids_tpu_torch.plan.fusion import fuse_stages
            plan = fuse_stages(plan, conf)
        if conf.get(cfg.AGG_FUSED_FILTER):
            _fuse_filters_into_aggregates(plan)
        if plan.is_tpu:
            plan = tpub.DeviceToHostExec(plan)
        # every node carries its plan's kernel backend, so concurrent
        # sessions with different kernel.backend settings stay
        # independent
        kbackend = kb.resolve(str(conf.get(cfg.KERNEL_BACKEND) or
                                  kb.PALLAS).strip().lower())

        from spark_rapids_tpu_torch.exec.cache import \
            CpuInMemoryTableScanExec

        def _stamp(n):
            n._kernel_backend = kbackend
            if isinstance(n, CpuInMemoryTableScanExec):
                # a host cached scan still materializes on the device
                n.device = device
        plan.foreach(_stamp)
        if kbackend == kb.PALLAS:
            # push eligible filter conditions into a directly-below fused
            # parquet scan so filtered-out rows never materialize
            # decoded dictionary values (kernels/filter_decode.py)
            _push_scan_filters(plan)
        if _plan_uses_input_file(cpu_plan):
            # fused multi-file batches can't answer input_file_name():
            # the scan takes its PERFILE reader (after the push above, so
            # a PERFILE scan carries a stamp it ignores, as the
            # reference's does)
            from spark_rapids_tpu_torch.io.device_scan import \
                TpuParquetScanExec

            def _disable(n):
                if isinstance(n, TpuParquetScanExec):
                    n.allow_fused = False
            plan.foreach(_disable)
        explain = conf.explain
        if explain in ("NOT_ON_TPU", "ALL"):
            lines = meta.explain_lines(all_=(explain == "ALL"))
            if lines:
                print("\n".join(lines))
        return OverrideResult(plan, meta)


def _fuse_filters_into_aggregates(plan: PhysicalPlan) -> None:
    """Post-conversion pass: a TpuFilterExec DIRECTLY under a
    TpuHashAggregateExec becomes a row mask inside the aggregate's update
    (TpuHashAggregateExec.fused_condition) instead of a compaction."""
    # the aggregate's update runs without the task context a standalone
    # filter threads through, so a partition- or position-dependent
    # condition stays outside (the fusion pass's R2 barrier set)
    from spark_rapids_tpu_torch.plan.fusion import _AGG_BARRIERS, _has_barrier

    def rec(n: PhysicalPlan) -> None:
        if isinstance(n, TpuHashAggregateExec) and \
                n.fused_condition is None and \
                isinstance(n.children[0], tpub.TpuFilterExec) and \
                not _has_barrier([n.children[0].condition], _AGG_BARRIERS):
            f = n.children[0]
            n.fused_condition = f.condition
            n.children = (f.children[0],)
        for c in n.children:
            rec(c)

    rec(plan)


def _push_scan_filters(plan: PhysicalPlan) -> None:
    """``kernel.backend=pallas`` only: when a filtering consumer sits
    DIRECTLY on a fused parquet scan, stamp its condition onto the scan
    (``_pushed_filter``) so the fused decode defers dictionary gathers
    until the mask is known: rows the consumer will drop never
    materialize decoded values (kernels/filter_decode.py).

    The stamp only ZEROES deferred dictionary values on mask-false rows;
    the consumer re-evaluates the same deterministic row-wise condition
    over the same (never-deferred) operand columns and drops exactly
    those rows.  Gates:

      * the consumer is a ``TpuFusedStageExec`` with a condition, a
        ``TpuHashAggregateExec`` with a fused_condition, or a plain
        ``TpuFilterExec``;
      * the condition carries no barrier expression (the R2 set);
      * the scan has exactly ONE consumer (parent-edge refcounts);
      * the scan ignores the stamp wherever the filtered decode can't
        cover a batch (io/parquet_fused.py), which is always correct.
    """
    from spark_rapids_tpu_torch.exec.fused_stage import TpuFusedStageExec
    from spark_rapids_tpu_torch.io.device_scan import (TpuOrcScanExec,
                                                       TpuParquetScanExec)
    from spark_rapids_tpu_torch.plan.fusion import (_AGG_BARRIERS,
                                                    _has_barrier, _refcounts)

    refs = _refcounts(plan)

    def cond_of(n):
        if isinstance(n, TpuFusedStageExec):
            return n.condition
        if isinstance(n, TpuHashAggregateExec):
            return n.fused_condition
        if isinstance(n, tpub.TpuFilterExec):
            return n.condition
        return None

    seen = set()

    def rec(n: PhysicalPlan) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        cond = cond_of(n)
        if cond is not None and n.children:
            scan = n.children[0]
            if (isinstance(scan, TpuParquetScanExec) and
                    not isinstance(scan, TpuOrcScanExec) and
                    scan.allow_fused and
                    refs.get(id(scan), 1) <= 1 and
                    getattr(scan, "_pushed_filter", None) is None and
                    not _has_barrier([cond], _AGG_BARRIERS)):
                scan._pushed_filter = cond
        for c in n.children:
            rec(c)

    rec(plan)


@dataclass
class OverrideResult:
    plan: PhysicalPlan
    meta: ExecMeta

    def explain_string(self, all_: bool = True) -> str:
        return "\n".join(self.meta.explain_lines(all_))


def assert_is_on_tpu(plan: PhysicalPlan, allowed_non_tpu: List[str]) -> None:
    """Test-mode assertion (``spark.rapids.tpu.sql.test.enabled``): every
    node runs on the device but the transitions, the host scans and the
    allowed class names."""
    always_ok = {"CpuScanExec", "CpuFileScanExec", "HostToDeviceExec",
                 "DeviceToHostExec"}
    bad: List[str] = []

    def visit(n: PhysicalPlan):
        name = type(n).__name__
        if not n.is_tpu and name not in always_ok and \
                name not in allowed_non_tpu:
            bad.append(name)
    plan.foreach(visit)
    if bad:
        raise AssertionError(
            f"plan contains CPU nodes not allowed in test mode: {bad}")
