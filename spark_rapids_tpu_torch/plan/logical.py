"""Logical plans produced by the DataFrame API.

Role analog: Spark's Catalyst logical plans, which sit *above* the reference
plugin (the reference only rewrites physical plans; reference:
SURVEY.md L3, GpuOverrides.scala:2047).  We are standalone, so we own this
layer too — it stays deliberately thin: resolution here, optimization and
device placement in the physical planner/overrides.

The port's copy of ``spark_rapids_tpu/plan/logical.py``: the layer is
engine-neutral, so only its imports are retargeted.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.expr import ir


@dataclass(frozen=True)
class Field:
    name: str
    dtype: dt.DType
    nullable: bool = True


class Schema:
    def __init__(self, fields: Sequence[Field]):
        self.fields = list(fields)

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def dtypes(self) -> List[dt.DType]:
        return [f.dtype for f in self.fields]

    @property
    def nullables(self) -> List[bool]:
        return [f.nullable for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def __len__(self) -> int:
        return len(self.fields)

    def __repr__(self) -> str:
        inner = ", ".join(f"{f.name}:{f.dtype.name}" for f in self.fields)
        return f"Schema({inner})"

    @staticmethod
    def from_arrow(schema: pa.Schema) -> "Schema":
        fields = []
        for f in schema:
            d = dt.from_arrow(f.type)
            if d is None:
                raise TypeError(f"unsupported Arrow type {f.type} for "
                                f"column {f.name}")
            fields.append(Field(f.name, d if d != dt.NULL else dt.BOOL,
                                f.nullable))
        return Schema(fields)


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    def bind(self, e: ir.Expression) -> ir.Expression:
        """Bind an expression against the *child* schema."""
        s = self.children[0].schema if self.children else self.schema
        return ir.bind(e, s.names, s.dtypes, s.nullables)

    def tree_string(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [f"{pad}{self.simple_string()}"]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def simple_string(self) -> str:
        return type(self).__name__


class InMemoryScan(LogicalPlan):
    def __init__(self, table: pa.Table, num_partitions: int = 1):
        self.table = table
        self.num_partitions = max(1, num_partitions)
        self._schema = Schema.from_arrow(table.schema)

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return (f"InMemoryScan(rows={self.table.num_rows}, "
                f"parts={self.num_partitions})")


class FileScan(LogicalPlan):
    """Parquet/CSV/ORC file scan. Schema inferred from footer/header."""

    def __init__(self, fmt: str, paths: Sequence[str], schema: Schema,
                 options: Optional[dict] = None):
        self.fmt = fmt
        self.paths = list(paths)
        self._schema = schema
        self.options = dict(options or {})

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return f"FileScan({self.fmt}, files={len(self.paths)})"


class Project(LogicalPlan):
    def __init__(self, child: LogicalPlan, exprs: Sequence[ir.Expression]):
        self.children = (child,)
        self.exprs = [self.bind(e) for e in exprs]
        self._schema = Schema([
            Field(ir.output_name(raw), b.dtype, b.nullable)
            for raw, b in zip(exprs, self.exprs)])

    @property
    def schema(self) -> Schema:
        return self._schema


class Filter(LogicalPlan):
    def __init__(self, child: LogicalPlan, condition: ir.Expression):
        self.children = (child,)
        self.condition = self.bind(condition)
        if self.condition.dtype != dt.BOOL:
            raise TypeError("filter condition must be boolean")

    @property
    def schema(self) -> Schema:
        return self.children[0].schema


@dataclass(frozen=True)
class SortOrder:
    expr: ir.Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # default: first if asc, last if desc

    @property
    def nulls_first_resolved(self) -> bool:
        if self.nulls_first is None:
            return self.ascending
        return self.nulls_first


class Sort(LogicalPlan):
    def __init__(self, child: LogicalPlan, orders: Sequence[SortOrder]):
        self.children = (child,)
        self.orders = [SortOrder(self.bind(o.expr), o.ascending,
                                 o.nulls_first) for o in orders]

    @property
    def schema(self) -> Schema:
        return self.children[0].schema


class Aggregate(LogicalPlan):
    def __init__(self, child: LogicalPlan,
                 groupings: Sequence[ir.Expression],
                 aggregates: Sequence[ir.Expression]):
        self.children = (child,)
        self.groupings = [self.bind(g) for g in groupings]
        self.raw_groupings = list(groupings)
        self.aggregates = [self.bind(a) for a in aggregates]
        self.raw_aggregates = list(aggregates)
        fields = []
        for raw, b in zip(groupings, self.groupings):
            fields.append(Field(ir.output_name(raw), b.dtype, b.nullable))
        for raw, b in zip(aggregates, self.aggregates):
            fields.append(Field(ir.output_name(raw), b.dtype, b.nullable))
        self._schema = Schema(fields)

    @property
    def schema(self) -> Schema:
        return self._schema


class Limit(LogicalPlan):
    def __init__(self, child: LogicalPlan, n: int):
        self.children = (child,)
        self.n = int(n)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def simple_string(self) -> str:
        return f"Limit({self.n})"


def widen_union_branches(children: Sequence["LogicalPlan"]
                         ) -> List["LogicalPlan"]:
    """Spark's WidenSetOperationTypes: mismatched numeric columns across
    UNION branches promote to a common type via inserted cast
    projections; non-promotable mismatches raise as before."""
    schemas = [c.schema for c in children]
    n = len(schemas[0].names)
    if any(len(s.names) != n for s in schemas[1:]):
        raise TypeError("UNION requires the same column count")
    targets = []
    for i in range(n):
        t = schemas[0].dtypes[i]
        for s in schemas[1:]:
            d = s.dtypes[i]
            if d == t:
                continue
            if d.is_numeric and t.is_numeric:
                t = dt.promote(t, d)
            else:
                raise TypeError(
                    f"UNION column {schemas[0].names[i]!r}: "
                    f"incompatible types {t.name} vs {d.name}")
        targets.append(t)
    out = []
    for c, s in zip(children, schemas):
        if list(s.dtypes) == targets:
            out.append(c)
            continue
        exprs = []
        for i, name in enumerate(s.names):
            e: ir.Expression = ir.UnresolvedAttribute(name)
            if s.dtypes[i] != targets[i]:
                e = ir.Cast(e, targets[i])
            exprs.append(ir.Alias(e, name))
        out.append(Project(c, exprs))
    return out


class Union(LogicalPlan):
    def __init__(self, children: Sequence[LogicalPlan]):
        children = widen_union_branches(list(children))
        self.children = tuple(children)
        s0 = children[0].schema
        for c in children[1:]:
            if c.schema.dtypes != s0.dtypes:
                raise TypeError("UNION requires matching schemas")

    @property
    def schema(self) -> Schema:
        # a column is nullable if ANY branch's is (Spark unions
        # nullability the same way); taking branch 0's alone mis-marks
        # e.g. lit("x") UNION lit(None) as non-nullable, which breaks
        # every downstream null-aware path (sort null placement,
        # null-flag key encoding)
        s0 = self.children[0].schema
        fields = []
        for i, f in enumerate(s0.fields):
            nullable = any(c.schema.fields[i].nullable
                           for c in self.children)
            fields.append(Field(f.name, f.dtype, nullable))
        return Schema(fields)


def rewrite_distinct_aggregates(plan: LogicalPlan, groupings, exprs):
    """DISTINCT-aggregate rewrite shared by the DataFrame and SQL
    frontends (Spark's RewriteDistinctAggregates, single-distinct shape):
    dedup on (grouping keys, child) with an inner Aggregate, then
    aggregate plainly over the deduped values.

    ``exprs`` are the aggregate-bearing output expressions (plus HAVING,
    if any).  Returns (plan, groupings, exprs) — unchanged when no
    distinct aggregate is present; otherwise the inner Aggregate plan,
    name-reference groupings, and exprs with distinct stripped and
    grouping subtrees replaced by their output-name references.
    """
    all_aggs = [a for e in exprs for a in ir.collect(
        e, lambda n: isinstance(n, ir.AggregateExpression))]
    distincts = [a for a in all_aggs if getattr(a, "distinct", False)]
    if not distincts:
        return plan, groupings, exprs
    if any(a.child is None for a in distincts):
        raise ValueError("DISTINCT requires an aggregate child "
                         "expression")
    same_child = all(ir.expr_eq(a.child, distincts[0].child)
                     for a in distincts[1:])
    if not same_child or len(distincts) != len(all_aggs):
        return _rewrite_multi_distinct(plan, groupings, exprs)
    x = distincts[0].child
    xname = "__distinct_val"
    inner = Aggregate(plan, list(groupings) + [ir.Alias(x, xname)], [])
    new_groupings = [ir.UnresolvedAttribute(ir.output_name(g))
                     for g in groupings]

    def repl(node):
        for g in groupings:
            if ir.expr_eq(node, g):
                return ir.UnresolvedAttribute(ir.output_name(g))
        if isinstance(node, ir.AggregateExpression) and \
                getattr(node, "distinct", False):
            r = node.with_children([ir.UnresolvedAttribute(xname)])
            r.distinct = False
            return r
        return None

    new_exprs = [ir.transform(e, repl) for e in exprs]
    return inner, new_groupings, new_exprs


def expand_grouping_sets(plan: LogicalPlan,
                         exprs: Sequence[ir.Expression],
                         sets: Sequence[tuple]):
    """Lower rollup/cube-style grouping sets to an Expand (GpuExpandExec
    analog): one projection per set with the excluded keys nulled and a
    Spark-compatible grouping-id bitmask (bit i set = key i aggregated
    away).  Returns (expanded_plan, internal_group_refs, renames) where
    ``internal_group_refs`` are the (keys..., __gid) grouping
    expressions for the downstream Aggregate and ``renames`` maps the
    internal key names back to their public output names.  Keeping the
    gid in the grouping keys keeps natural null key values at the
    detail level from merging with subtotal rows."""
    s = plan.schema
    k = len(exprs)
    bound = [ir.bind(copy.deepcopy(e), s.names, s.dtypes, s.nullables)
             for e in exprs]
    g_internal = [f"__gset{i}" for i in range(k)]
    projections = []
    for S in sets:
        gid = sum(1 << (k - 1 - i) for i in range(k) if i not in S)
        projections.append(
            [ir.UnresolvedAttribute(n) for n in s.names] +
            [copy.deepcopy(exprs[i]) if i in S
             else ir.Literal(None, bound[i].dtype) for i in range(k)] +
            [ir.Literal(gid, dt.INT64)])
    expanded = Expand(plan, projections,
                      list(s.names) + g_internal + ["__gid"])
    refs = [ir.UnresolvedAttribute(n) for n in g_internal] + \
        [ir.UnresolvedAttribute("__gid")]
    renames = dict(zip(g_internal, [ir.output_name(e) for e in exprs]))
    return expanded, refs, renames


def _rewrite_multi_distinct(plan: LogicalPlan, groupings, exprs):
    """Expand-based multi-distinct rewrite (Spark's
    RewriteDistinctAggregates general shape,
    RewriteDistinctAggregates.scala): replicate each input row once per
    distinct-child group with a ``gid`` tag (Expand), pre-aggregate on
    (grouping keys, gid, distinct values) so each distinct value
    survives once per group, then finish with gid-filtered plain
    aggregates — ``AGG(if(gid = j, d_j, null))`` for the distinct
    functions and merge forms over the gid-0 partials for the plain
    ones (Average splits into Sum/Count partials)."""
    all_aggs = [a for e in exprs for a in ir.collect(
        e, lambda n: isinstance(n, ir.AggregateExpression))]
    distincts = [a for a in all_aggs if getattr(a, "distinct", False)]
    plains = [a for a in all_aggs if not getattr(a, "distinct", False)]
    for a in plains:
        if not isinstance(a, (ir.Count, ir.Sum, ir.Average, ir.Min,
                              ir.Max, ir.First, ir.Last)):
            raise NotImplementedError(
                f"{type(a).__name__} alongside DISTINCT aggregates is "
                f"not supported")

    # unique distinct children -> gid groups 1..k
    dchildren: List[ir.Expression] = []
    for a in distincts:
        if not any(ir.expr_eq(a.child, c) for c in dchildren):
            dchildren.append(a.child)

    g_names = [ir.output_name(g) for g in groupings]
    d_names = [f"__d{j}" for j in range(len(dchildren))]
    schema = plan.schema

    def b(e):
        return ir.bind(e, schema.names, schema.dtypes, schema.nullables)

    d_dtypes = [b(copy.deepcopy(c)).dtype for c in dchildren]
    # plain-agg inputs (Count(*) needs no input column)
    p_names: List[str] = []
    p_children: List[ir.Expression] = []
    for m, a in enumerate(plains):
        p_names.append(f"__p{m}")
        p_children.append(a.child)
    p_dtypes = [dt.INT32 if c is None else b(copy.deepcopy(c)).dtype
                for c in p_children]

    # Expand projections over [g..., gid, d..., p...]
    out_names = g_names + ["__gid"] + d_names + p_names
    projections = []
    base = [copy.deepcopy(g) for g in groupings]
    proj0 = base + [ir.Literal(0, dt.INT32)] + \
        [ir.Literal(None, d) for d in d_dtypes] + \
        [ir.Literal(1, dt.INT32) if c is None else copy.deepcopy(c)
         for c in p_children]
    projections.append(proj0)
    for j, c in enumerate(dchildren):
        projections.append(
            [copy.deepcopy(g) for g in groupings] +
            [ir.Literal(j + 1, dt.INT32)] +
            [copy.deepcopy(c) if jj == j else ir.Literal(None, d)
             for jj, d in enumerate(d_dtypes)] +
            [ir.Literal(None, d) for d in p_dtypes])
    expanded = Expand(plan, projections, out_names)

    # inner pre-aggregate: group by (g, gid, d...), partials for plains
    inner_groupings: List[ir.Expression] = [
        ir.UnresolvedAttribute(n) for n in g_names + ["__gid"] + d_names]
    inner_aggs: List[ir.Expression] = []
    buf_names: List[List[str]] = []
    for m, a in enumerate(plains):
        pm = ir.UnresolvedAttribute(p_names[m])
        if isinstance(a, ir.Count):
            # Count(*) counts the gid-0 lit(1); Count(x) counts
            # non-null x — both are Count over __pm (null elsewhere)
            bufs = [(f"__b{m}_0", ir.Count(pm))]
        elif isinstance(a, ir.Average):
            bufs = [(f"__b{m}_0", ir.Sum(pm)),
                    (f"__b{m}_1", ir.Count(pm))]
        else:
            bufs = [(f"__b{m}_0", type(a)(pm))]
        buf_names.append([n for n, _ in bufs])
        inner_aggs.extend(ir.Alias(e, n) for n, e in bufs)
    inner = Aggregate(expanded, inner_groupings, inner_aggs)

    # outer: group by g, gid-filtered aggregates
    gid = ir.UnresolvedAttribute("__gid")

    def _if_gid(j: int, value: ir.Expression, d: dt.DType):
        return ir.If(ir.EqualTo(copy.deepcopy(gid), ir.Literal(j, dt.INT32)),
                     value, ir.Literal(None, d))

    new_groupings = [ir.UnresolvedAttribute(n) for n in g_names]
    inner_schema = inner.schema

    def repl(node):
        for gi, g in enumerate(groupings):
            if ir.expr_eq(node, g):
                return ir.UnresolvedAttribute(g_names[gi])
        if isinstance(node, ir.AggregateExpression) and \
                getattr(node, "distinct", False):
            j = next(jj for jj, c in enumerate(dchildren)
                     if ir.expr_eq(node.child, c))
            r = node.with_children([_if_gid(
                j + 1, ir.UnresolvedAttribute(d_names[j]),
                d_dtypes[j])])
            r.distinct = False
            return r
        if isinstance(node, ir.AggregateExpression):
            m = next(mm for mm, a in enumerate(plains)
                     if a is node or ir.expr_eq(a, node))
            bufs = buf_names[m]

            def buf(i):
                d = inner_schema.field(bufs[i]).dtype
                return _if_gid(0, ir.UnresolvedAttribute(bufs[i]), d)
            a = plains[m]
            if isinstance(a, ir.Count):
                return ir.Sum(buf(0))
            if isinstance(a, ir.Average):
                return ir.Divide(
                    ir.Cast(ir.Sum(buf(0)), dt.FLOAT64),
                    ir.Cast(ir.Sum(buf(1)), dt.FLOAT64))
            return type(a)(buf(0))
        return None

    new_exprs = [ir.transform(e, repl) for e in exprs]
    # groupings must reach the Expand by their original shapes: alias
    # them in a pre-projection so complex grouping exprs stay intact
    return inner, new_groupings, new_exprs


def split_join_condition(condition: ir.Expression, lnames, rnames):
    """Split a boolean join condition into equi key pairs + residual.

    Conjuncts of the form ``EqualTo(left_col, right_col)`` become key
    pairs, resolved by which side owns each column name (the analyzer
    role; reference: GpuHashJoin equi keys + optional condition).  A name
    owned by both sides is ambiguous and raises.  Returns
    ``(left_keys, right_keys, residual_or_None)``.
    """
    lset, rset = set(lnames), set(rnames)
    conjuncts: List[ir.Expression] = []
    stack = [condition]
    while stack:
        c = stack.pop()
        if isinstance(c, ir.And):
            stack.extend(c.children)
        else:
            conjuncts.append(c)

    def side(e: ir.Expression) -> Optional[str]:
        names = [n.attr_name for n in ir.collect(
            e, lambda x: isinstance(x, ir.UnresolvedAttribute))]
        for n in names:
            if n in lset and n in rset:
                raise ValueError(
                    f"ambiguous column '{n}' appears on both sides of "
                    f"the join; rename one side or use a same-name "
                    f"equi key")
        if names and all(n in lset for n in names):
            return "l"
        if names and all(n in rset for n in names):
            return "r"
        return None

    left_keys: List[str] = []
    right_keys: List[str] = []
    residual: List[ir.Expression] = []
    for c in conjuncts:
        if isinstance(c, ir.EqualTo):
            a, b = c.children
            if (isinstance(a, ir.UnresolvedAttribute)
                    and isinstance(b, ir.UnresolvedAttribute)):
                sa, sb = side(a), side(b)
                if sa == "l" and sb == "r":
                    left_keys.append(a.attr_name)
                    right_keys.append(b.attr_name)
                    continue
                if sa == "r" and sb == "l":
                    left_keys.append(b.attr_name)
                    right_keys.append(a.attr_name)
                    continue
        residual.append(c)
    cond = None
    for c in residual:
        cond = c if cond is None else ir.And(cond, c)
    return left_keys, right_keys, cond


class Join(LogicalPlan):
    """Equi-join on named key pairs; how in inner/left/right/full/semi/anti,
    cross for cartesian."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 how: str = "inner",
                 condition: Optional[ir.Expression] = None,
                 hint: Optional[str] = None):
        self.children = (left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how
        # "broadcast_left"/"broadcast_right" (functions.broadcast analog)
        self.hint = hint
        if how != "cross" and not self.left_keys and how != "inner":
            # a keyless outer/semi/anti join is a nested-loop join with
            # outer semantics we don't implement; refusing beats silently
            # computing a cross product
            raise NotImplementedError(
                f"{how} join without keys is not supported; only "
                f"inner/cross joins may omit join keys")
        lf, rf = left.schema.fields, right.schema.fields
        # Spark promotes mismatched numeric key pairs to a common type
        # before comparing; record the promoted dtype per key pair
        self.key_dtypes = []
        for lk, rk in zip(self.left_keys, self.right_keys):
            ld = left.schema.field(lk).dtype
            rd = right.schema.field(rk).dtype
            if ld == rd:
                self.key_dtypes.append(ld)
            elif ld.is_numeric and rd.is_numeric:
                self.key_dtypes.append(dt.promote(ld, rd))
            else:
                raise TypeError(
                    f"join key type mismatch: {lk}:{ld.name} vs "
                    f"{rk}:{rd.name}")
        if how in ("semi", "anti"):
            self._schema = Schema(lf)
        else:
            nullable_l = how in ("right", "full")
            nullable_r = how in ("left", "full")
            self._schema = Schema(
                [Field(f.name, f.dtype, f.nullable or nullable_l)
                 for f in lf] +
                [Field(f.name, f.dtype, f.nullable or nullable_r)
                 for f in rf])
        self.condition = None
        if condition is not None:
            if how not in ("inner", "cross"):
                raise NotImplementedError(
                    f"join condition is only supported for inner/cross "
                    f"joins, not {how}")
            # bind against the joined output (left fields then right fields)
            joined = Schema(lf + rf)
            self.condition = ir.bind(condition, joined.names,
                                     joined.dtypes, joined.nullables)
            if self.condition.dtype != dt.BOOL:
                raise TypeError("join condition must be boolean")

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return (f"Join({self.how}, {list(zip(self.left_keys, self.right_keys))})")


class CachedRelation(LogicalPlan):
    """df.cache(): the child's output materialized once as parquet blobs
    (one per partition) and served from them afterwards.

    Reference analog: ``ParquetCachedBatchSerializer``
    (shims/spark310/.../ParquetCachedBatchSerializer.scala:253 —
    ``compressColumnarBatchWithParquet`` at :333) + GpuInMemoryTableScanExec.
    exec/cache.py materializes it: the device parquet encoder when the
    child plan ends on the device, else host Arrow; the blobs decode on
    the device through the PERFILE reader of file scans.  Column pruning
    stops here (plan/optimizer.py), so every plan shares this one object.
    """

    def __init__(self, child: LogicalPlan):
        self.children = (child,)
        self.blobs: Optional[List[bytes]] = None   # one per partition
        self.device_encoded = False

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def materialized(self) -> bool:
        return self.blobs is not None

    def simple_string(self) -> str:
        state = "materialized" if self.materialized else "pending"
        return f"CachedRelation({state})"


class Range(LogicalPlan):
    """spark.range analog (reference: GpuRangeExec,
    basicPhysicalOperators.scala:187)."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1):
        self.start, self.end, self.step = start, end, step
        self.num_partitions = max(1, num_partitions)
        self._schema = Schema([Field("id", dt.INT64, False)])

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return f"Range({self.start}, {self.end}, {self.step})"


class Window(LogicalPlan):
    """Append window-expression columns (GpuWindowExec analog).

    Output = child columns + one column per window expression, in the
    (partition, order)-sorted row order like Spark's WindowExec.
    """

    def __init__(self, child: LogicalPlan,
                 window_exprs: Sequence[ir.Expression],
                 names: Sequence[str]):
        self.children = (child,)
        self.window_exprs = [self.bind(e) for e in window_exprs]
        self.out_names = list(names)
        for e in self.window_exprs:
            if not isinstance(e, ir.WindowExpression):
                raise TypeError("Window node requires WindowExpression")
            fr = e.frame
            finite_range = fr.kind == "range" and not (
                fr.start is None and fr.end in (0, None))
            if finite_range:
                # Spark: range frames with offsets need exactly one
                # numeric/temporal ORDER BY column
                oe = e.order_exprs
                if len(oe) != 1 or oe[0].dtype is None or not (
                        oe[0].dtype.is_numeric or oe[0].dtype.is_temporal):
                    raise TypeError(
                        "RANGE frame with offsets requires exactly one "
                        "numeric or temporal ORDER BY column")
        self._schema = Schema(
            list(child.schema.fields) +
            [Field(n, e.dtype, e.nullable)
             for n, e in zip(self.out_names, self.window_exprs)])

    @property
    def schema(self) -> Schema:
        return self._schema


class Expand(LogicalPlan):
    """N projections per input row (rollup/cube building block; reference:
    GpuExpandExec.scala:67)."""

    def __init__(self, child: LogicalPlan,
                 projections: Sequence[Sequence[ir.Expression]],
                 names: Sequence[str]):
        self.children = (child,)
        self.projections = [[self.bind(e) for e in p] for p in projections]
        p0 = self.projections[0]
        self._schema = Schema([
            Field(n, b.dtype, True) for n, b in zip(names, p0)])

    @property
    def schema(self) -> Schema:
        return self._schema


class Repartition(LogicalPlan):
    """Explicit exchange: df.repartition(n[, cols]) / repartitionByRange /
    coalesce.  kind in {"hash", "range", "roundrobin", "single"}.

    Planned as a ShuffleExchangeExec (reference:
    GpuShuffleExchangeExec.scala:143 + the four partitionings §2d)."""

    def __init__(self, child: LogicalPlan, kind: str, num_partitions: int,
                 exprs: Sequence[ir.Expression] = (),
                 orders: Sequence[SortOrder] = ()):
        self.children = (child,)
        self.kind = kind
        self.num_partitions = max(1, int(num_partitions))
        self.exprs = [self.bind(e) for e in exprs]
        self.orders = [SortOrder(self.bind(o.expr), o.ascending,
                                 o.nulls_first) for o in orders]

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def simple_string(self) -> str:
        return f"Repartition({self.kind}, n={self.num_partitions})"


def size_estimate(node: LogicalPlan) -> int:
    """Rough plan-size statistic in bytes, for broadcast-join selection
    (the role of Spark's plan statistics feeding
    spark.sql.autoBroadcastJoinThreshold)."""
    import os
    if isinstance(node, InMemoryScan):
        return node.table.nbytes
    if isinstance(node, FileScan):
        total = 0
        for p in node.paths:
            try:
                total += os.path.getsize(p)
            except OSError:
                return 1 << 62
        # parquet/orc are compressed on disk; assume 3x in-memory growth
        return total * (3 if node.fmt in ("parquet", "orc") else 1)
    if isinstance(node, Range):
        step = node.step if node.step else 1
        n = (node.end - node.start + step + (-1 if step > 0 else 1)) // step
        return max(0, n) * 8
    if isinstance(node, Filter):
        return size_estimate(node.children[0]) // 2
    if isinstance(node, (Aggregate, Limit)):
        return size_estimate(node.children[0]) // 2
    if isinstance(node, Join):
        return sum(size_estimate(c) for c in node.children)
    if not node.children:
        return 1 << 62
    return max(size_estimate(c) for c in node.children)


class Generate(LogicalPlan):
    """Row-generating node for explode/posexplode (reference:
    GpuGenerateExec.scala:101 — per-row list explode).

    Output = child columns + generated columns (``pos`` first for
    posexplode, then the element column)."""

    def __init__(self, child: LogicalPlan, generator: ir.Generator,
                 out_names: Sequence[str]):
        self.children = (child,)
        g = self.bind(generator)
        if g.children[0].dtype is None or not g.children[0].dtype.is_list:
            raise TypeError("explode/posexplode requires an array column")
        self.generator = g
        self.out_names = list(out_names)
        gen_fields = []
        if isinstance(g, ir.PosExplode):
            gen_fields.append(Field(self.out_names[0], dt.INT32, False))
            gen_fields.append(Field(self.out_names[1],
                                    g.children[0].dtype.element, True))
        else:
            gen_fields.append(Field(self.out_names[0],
                                    g.children[0].dtype.element, True))
        self._schema = Schema(list(child.schema.fields) + gen_fields)

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return f"Generate({type(self.generator).__name__})"


class CoalescePartitions(LogicalPlan):
    """df.coalesce(n): merge contiguous partitions without a shuffle
    (reference: GpuCoalesceExec, basicPhysicalOperators.scala:346)."""

    def __init__(self, child: LogicalPlan, num_partitions: int):
        self.children = (child,)
        self.num_partitions = max(1, int(num_partitions))

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def simple_string(self) -> str:
        return f"CoalescePartitions({self.num_partitions})"


# ---------------------------------------------------------------------------
# Pandas-UDF nodes (reference: SURVEY.md §2d Pandas/Python execs,
# sql-plugin/.../execution/python/*)
# ---------------------------------------------------------------------------

def _parse_udf_schema(schema) -> Schema:
    """Accept a Schema, a pyarrow.Schema, or a list of (name, DType)."""
    if isinstance(schema, Schema):
        return schema
    if isinstance(schema, pa.Schema):
        return Schema.from_arrow(schema)
    return Schema([Field(n, d, True) for n, d in schema])


class MapInPandas(LogicalPlan):
    """df.map_in_pandas(fn, schema) — GpuMapInPandasExec analog."""

    def __init__(self, child: LogicalPlan, fn, schema):
        self.children = (child,)
        self.fn = fn
        self._schema = _parse_udf_schema(schema)

    @property
    def schema(self) -> Schema:
        return self._schema


class FlatMapGroupsInPandas(LogicalPlan):
    """group_by(keys).apply_in_pandas(fn, schema) —
    GpuFlatMapGroupsInPandasExec analog."""

    def __init__(self, child: LogicalPlan, keys: Sequence[str], fn, schema):
        self.children = (child,)
        for k in keys:
            child.schema.field(k)  # raises KeyError if missing
        self.keys = list(keys)
        self.fn = fn
        self._schema = _parse_udf_schema(schema)

    @property
    def schema(self) -> Schema:
        return self._schema


class CoGroupedMapInPandas(LogicalPlan):
    """cogroup(...).apply_in_pandas(fn, schema) —
    GpuFlatMapCoGroupsInPandasExec analog."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 fn, schema):
        if len(left_keys) != len(right_keys):
            raise ValueError("cogroup key lists must have equal length")
        self.children = (left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.fn = fn
        self._schema = _parse_udf_schema(schema)

    @property
    def schema(self) -> Schema:
        return self._schema


class AggregateInPandas(LogicalPlan):
    """group_by(keys).agg_in_pandas(fn, args, name, dtype) —
    GpuAggregateInPandasExec analog."""

    def __init__(self, child: LogicalPlan, keys: Sequence[str], fn,
                 args: Sequence[ir.Expression], out_name: str,
                 out_dtype: dt.DType):
        self.children = (child,)
        self.keys = list(keys)
        self.fn = fn
        self.args = [self.bind(a) for a in args]
        self.out_field = Field(out_name, out_dtype, True)
        self._schema = Schema(
            [child.schema.field(k) for k in self.keys] + [self.out_field])

    @property
    def schema(self) -> Schema:
        return self._schema


class WindowInPandas(LogicalPlan):
    """Unbounded-frame pandas window UDF — GpuWindowInPandasExec analog."""

    def __init__(self, child: LogicalPlan, part_keys: Sequence[str], fn,
                 args: Sequence[ir.Expression], out_name: str,
                 out_dtype: dt.DType):
        self.children = (child,)
        for k in part_keys:
            child.schema.field(k)
        self.part_keys = list(part_keys)
        self.fn = fn
        self.args = [self.bind(a) for a in args]
        self.out_field = Field(out_name, out_dtype, True)
        self._schema = Schema(list(child.schema.fields) + [self.out_field])

    @property
    def schema(self) -> Schema:
        return self._schema
