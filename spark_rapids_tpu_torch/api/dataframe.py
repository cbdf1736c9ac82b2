"""DataFrame API: the user surface over logical plans.

Ported from ``spark_rapids_tpu/api/dataframe.py``: everything that builds
logical nodes (select/with_column/filter/group_by/rollup/cube/agg/sort/
limit/union/join/repartition/coalesce/cache/distinct), ``collect``
(``submit().result()`` through the session's query service),
``collect_async`` (the ``QueryFuture``), ``collect_device`` (the device
batches, no download, run directly as in the reference), ``count``,
``show``, ``explain_string`` (modes ``physical``, ``tpu``, ``logical``
and ``profile``: the last action's ``QueryProfile`` tree),
``schema``/``columns``, ``write`` (io/writers.py) and
``create_or_replace_temp_view``.  A plan whose exec the port has not
ported yet raises ``NotImplementedError`` naming its module when it is
planned (plan/planner.py).  Not ported: the pandas-UDF methods
(``pyworker/execs.py``); each raises ``NotImplementedError`` naming its
module.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import pyarrow as pa

from spark_rapids_tpu_torch.api.column import Column, _to_expr
from spark_rapids_tpu_torch.expr import ir
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.logical import SortOrder


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs spark_rapids_tpu/{module}, which the torch port "
        f"has not ported yet")


def _as_expr(c: Union[str, Column, ir.Expression]) -> ir.Expression:
    if isinstance(c, str):
        return ir.UnresolvedAttribute(c)
    return _to_expr(c)


class DataFrame:
    def __init__(self, plan: lp.LogicalPlan, session: "TpuSparkSession"):
        self.plan = plan
        self.session = session

    # -- transformations ---------------------------------------------------
    def select(self, *cols) -> "DataFrame":
        exprs = [_as_expr(c) for c in cols]

        # generators (explode/posexplode) compute in a Generate node below
        # the projection (the Spark analyzer's ExtractGenerator role)
        gens = [e for e in exprs
                if isinstance(e, ir.Generator) or
                (isinstance(e, ir.Alias) and
                 isinstance(e.children[0], ir.Generator))]
        if len(gens) > 1:
            raise ValueError("only one generator (explode/posexplode) is "
                             "allowed per select")
        if gens and any(ir.collect(e, lambda n: isinstance(
                n, ir.WindowExpression)) for e in exprs):
            raise ValueError("a generator and a window expression cannot "
                             "share one select; explode first, then window "
                             "over the result")
        if gens:
            g = gens[0]
            alias = None
            if isinstance(g, ir.Alias):
                alias, g = g.alias, g.children[0]
            if isinstance(g, ir.PosExplode):
                out_names = ["pos", alias or "col"]
            else:
                out_names = [alias or "col"]
            child = lp.Generate(self.plan, g, out_names)
            plain = []
            for e in exprs:
                inner = e.children[0] if isinstance(e, ir.Alias) else e
                if inner is g:
                    for n in out_names:
                        plain.append(ir.UnresolvedAttribute(n))
                else:
                    plain.append(e)
            return DataFrame(lp.Project(child, plain), self.session)

        # window expressions compute in a Window node below the projection
        wins: List[ir.WindowExpression] = []

        def repl(node):
            if isinstance(node, ir.WindowExpression):
                name = f"__w{len(wins)}"
                wins.append(node)
                return ir.UnresolvedAttribute(name)
            return None

        plain = [ir.transform(e, repl) for e in exprs]
        child = self.plan
        if wins:
            child = lp.Window(child, wins,
                              [f"__w{i}" for i in range(len(wins))])
            # preserve user-facing output names
            plain = [p if isinstance(p, ir.Alias) or
                     not isinstance(p, ir.UnresolvedAttribute) or
                     not p.attr_name.startswith("__w")
                     else ir.Alias(p, ir.output_name(orig))
                     for p, orig in zip(plain, exprs)]
        return DataFrame(lp.Project(child, plain), self.session)

    def with_column(self, name: str, c: Column) -> "DataFrame":
        cols: List = []
        replaced = False
        for n in self.plan.schema.names:
            if n == name:
                cols.append(Column(ir.Alias(_as_expr(c), name)))
                replaced = True
            else:
                cols.append(Column(ir.UnresolvedAttribute(n)))
        if not replaced:
            cols.append(Column(ir.Alias(_as_expr(c), name)))
        return self.select(*cols)

    withColumn = with_column

    def filter(self, condition: Union[Column, ir.Expression]) -> "DataFrame":
        return DataFrame(lp.Filter(self.plan, _as_expr(condition)),
                         self.session)

    where = filter

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, [_as_expr(c) for c in cols])

    groupBy = group_by

    def rollup(self, *cols) -> "GroupedData":
        """Hierarchical subtotals: grouping sets over every key prefix
        (reference: rollup lowered through GpuExpandExec,
        GpuExpandExec.scala:67)."""
        exprs = [_as_expr(c) for c in cols]
        k = len(exprs)
        sets = [tuple(range(i)) for i in range(k, -1, -1)]
        return _grouping_sets(self, exprs, sets)

    def cube(self, *cols) -> "GroupedData":
        """All grouping-set combinations of the keys (GpuExpandExec
        lowering, as rollup)."""
        import itertools
        exprs = [_as_expr(c) for c in cols]
        k = len(exprs)
        sets = [s for n in range(k, -1, -1)
                for s in itertools.combinations(range(k), n)]
        return _grouping_sets(self, exprs, sets)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self, []).agg(*aggs)

    def sort(self, *cols, ascending: Optional[Any] = None) -> "DataFrame":
        orders: List[SortOrder] = []
        for i, c in enumerate(cols):
            if isinstance(c, SortOrder):
                orders.append(c)
                continue
            asc = True
            if ascending is not None:
                asc = ascending[i] if isinstance(ascending, (list, tuple)) \
                    else bool(ascending)
            orders.append(SortOrder(_as_expr(c), asc, None))
        return DataFrame(lp.Sort(self.plan, orders), self.session)

    orderBy = sort
    order_by = sort

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(lp.Limit(self.plan, n), self.session)

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(lp.Union([self.plan, other.plan]), self.session)

    unionAll = union

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        how = {"left_outer": "left", "right_outer": "right",
               "outer": "full", "full_outer": "full",
               "leftsemi": "semi", "left_semi": "semi",
               "leftanti": "anti", "left_anti": "anti",
               "cross": "cross"}.get(how, how)
        condition: Optional[ir.Expression] = None
        if on is None:
            left_keys: List[str] = []
            right_keys: List[str] = []
        elif isinstance(on, str):
            left_keys, right_keys = [on], [on]
        elif isinstance(on, (list, tuple)) and all(
                isinstance(c, str) for c in on):
            left_keys = list(on)
            right_keys = list(on)
        elif isinstance(on, (Column, ir.Expression)) or (
                isinstance(on, (list, tuple)) and all(
                    isinstance(c, (Column, ir.Expression)) for c in on)):
            # Expression join condition: equi conjuncts become key pairs,
            # the rest a residual condition (shared analyzer policy —
            # lp.split_join_condition).
            exprs = [_as_expr(e) for e in
                     (on if isinstance(on, (list, tuple)) else [on])]
            whole = exprs[0]
            for e in exprs[1:]:
                whole = ir.And(whole, e)
            left_keys, right_keys, condition = lp.split_join_condition(
                whole, self.plan.schema.names, other.plan.schema.names)
        else:
            raise TypeError("join on must be a column name, list of names, "
                            "or a Column join condition")
        hint = None
        if getattr(other, "_broadcast_hint", False):
            hint = "broadcast_right"
        elif getattr(self, "_broadcast_hint", False):
            hint = "broadcast_left"
        return DataFrame(lp.Join(self.plan, other.plan, left_keys,
                                 right_keys, how, condition=condition,
                                 hint=hint), self.session)

    crossJoin = lambda self, other: self.join(other, how="cross")  # noqa

    def map_in_pandas(self, fn, schema) -> "DataFrame":
        raise _not_ported("map_in_pandas", "pyworker/execs.py")

    def window_in_pandas(self, partition_by, fn, args, out_name: str,
                         out_type="double") -> "DataFrame":
        raise _not_ported("window_in_pandas", "pyworker/execs.py")

    def repartition(self, num_partitions: int, *cols) -> "DataFrame":
        """Hash exchange on cols, or round-robin without cols
        (GpuShuffleExchangeExec + GpuHashPartitioning/
        GpuRoundRobinPartitioning analog)."""
        if cols:
            return DataFrame(lp.Repartition(
                self.plan, "hash", num_partitions,
                exprs=[_as_expr(c) for c in cols]), self.session)
        return DataFrame(lp.Repartition(self.plan, "roundrobin",
                                        num_partitions), self.session)

    def repartition_by_range(self, num_partitions: int, *cols
                             ) -> "DataFrame":
        """Range exchange (GpuRangePartitioning analog)."""
        orders = [c if isinstance(c, SortOrder)
                  else SortOrder(_as_expr(c), True, None) for c in cols]
        return DataFrame(lp.Repartition(self.plan, "range", num_partitions,
                                        orders=orders), self.session)

    repartitionByRange = repartition_by_range

    def coalesce(self, num_partitions: int) -> "DataFrame":
        """Reduce the partition count by merging contiguous partitions —
        no shuffle, and never increases the count (GpuCoalesceExec analog,
        reference: basicPhysicalOperators.scala:346)."""
        return DataFrame(lp.CoalescePartitions(self.plan, num_partitions),
                         self.session)

    def cache(self) -> "DataFrame":
        """Materialize this plan's output once as parquet blobs and serve
        later executions from them (ParquetCachedBatchSerializer /
        InMemoryTableScan analog; materialization is lazy — it happens on
        the first action).  Only this DataFrame and ones derived from it
        afterwards see the cache."""
        if not isinstance(self.plan, lp.CachedRelation):
            self.plan = lp.CachedRelation(self.plan)
        return self

    persist = cache

    def unpersist(self) -> "DataFrame":
        if isinstance(self.plan, lp.CachedRelation):
            # free the blobs for every dependent (derived DataFrames
            # holding this CachedRelation re-materialize on next action)
            self.plan.blobs = None
            self.plan = self.plan.children[0]
        return self

    @property
    def is_cached(self) -> bool:
        return isinstance(self.plan, lp.CachedRelation)

    def create_or_replace_temp_view(self, name: str) -> None:
        self.session.register_view(name, self)

    createOrReplaceTempView = create_or_replace_temp_view

    def distinct(self) -> "DataFrame":
        names = self.plan.schema.names
        return DataFrame(
            lp.Aggregate(self.plan,
                         [ir.UnresolvedAttribute(n) for n in names], []),
            self.session)

    # -- properties --------------------------------------------------------
    @property
    def schema(self) -> lp.Schema:
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return self.plan.schema.names

    @property
    def write(self):
        from spark_rapids_tpu_torch.io.writers import DataFrameWriter
        return DataFrameWriter(self)

    # -- actions -----------------------------------------------------------
    def collect(self) -> pa.Table:
        """Execute and return an Arrow table (the terminal device->host
        transition): ``submit().result()`` through the session's query
        service, so admission control, cancellation and deadlines govern
        blocking collects too."""
        return self.session._execute(self.plan)

    def collect_async(self, priority: int = 0,
                      timeout_ms: Optional[int] = None,
                      estimate_bytes: Optional[int] = None):
        """Submit this query to the session's QueryService and return a
        QueryFuture at once (sched/service.py): ``result(timeout)``
        blocks for the Arrow table, ``cancel()`` unwinds the query at its
        next cooperative checkpoint, ``done()``/``state`` inspect, and
        ``profile`` carries the QueryProfile once complete.  Higher
        ``priority`` admits first; ``timeout_ms`` overrides
        ``sched.defaultTimeoutMs``; ``estimate_bytes`` overrides the
        admission estimate for this submission."""
        return self.session.submit(self.plan, priority=priority,
                                   timeout_ms=timeout_ms,
                                   estimate_bytes=estimate_bytes)

    collectAsync = collect_async

    def to_pandas(self):
        return self.collect().to_pandas()

    toPandas = to_pandas

    def collect_device(self):
        """Execute and return the device-resident batches, with no
        download: the ColumnarRdd-style handoff to an ML framework (the
        tensors stay on the session's device)."""
        return self.session._execute_device(self.plan)

    def count(self) -> int:
        from spark_rapids_tpu_torch.api import functions as F
        t = self.agg(F.count("*").alias("count")).collect()
        return t.column("count")[0].as_py()

    def show(self, n: int = 20) -> None:
        print(self.limit(n).collect().to_pandas().to_string(index=False))

    def explain(self, mode: str = "physical") -> None:
        print(self.explain_string(mode))

    def explain_string(self, mode: str = "physical") -> str:
        if mode == "logical":
            return self.plan.tree_string()
        if mode == "profile":
            # metrics-annotated plan of the last executed action
            # (obs/profile.py; run collect() first)
            prof = self.session.last_query_profile()
            if prof is None:
                return ("no query profile recorded — run an action "
                        "(collect) first, with "
                        "spark.rapids.tpu.obs.profile.enabled=true")
            return prof.tree_string()
        result = self.session._plan_physical(self.plan)
        if mode == "tpu":
            return result.explain_string(all_=True)
        return result.plan.tree_string()

    def __repr__(self):
        inner = ", ".join(f"{f.name}: {f.dtype.name}"
                          for f in self.plan.schema.fields)
        return f"DataFrame[{inner}]"


def _grouping_sets(df: DataFrame, exprs: List[ir.Expression],
                   sets: List[tuple]) -> "GroupedData":
    """Lower rollup/cube to Expand + Aggregate (shared helper
    lp.expand_grouping_sets); agg() renames the internal key columns
    back and drops the gid."""
    expanded, refs, renames = lp.expand_grouping_sets(df.plan, exprs,
                                                      sets)
    gd = GroupedData(DataFrame(expanded, df.session), refs)
    gd._gset_renames = renames
    return gd


class GroupedData:
    def __init__(self, df: DataFrame, groupings: List[ir.Expression]):
        self.df = df
        self.groupings = groupings
        # rollup/cube: internal grouping-set key names -> public names;
        # agg() renames them and drops the __gid column
        self._gset_renames: Optional[dict] = None

    def agg(self, *aggs) -> DataFrame:
        res = self._agg_impl(*aggs)
        if self._gset_renames:
            # rollup/cube epilogue: public key names back, gid dropped
            final = [ir.Alias(ir.UnresolvedAttribute(n),
                              self._gset_renames.get(n, n))
                     for n in res.plan.schema.names if n != "__gid"]
            res = DataFrame(lp.Project(res.plan, final), res.session)
        return res

    def _agg_impl(self, *aggs) -> DataFrame:
        agg_exprs = [_as_expr(a) for a in aggs]

        # DISTINCT aggregates: shared double-aggregate rewrite (pre-alias
        # so output names survive the strip)
        plan2, groupings2, exprs2 = lp.rewrite_distinct_aggregates(
            self.df.plan, self.groupings,
            [e if isinstance(e, ir.Alias)
             else ir.Alias(e, ir.output_name(e)) for e in agg_exprs])
        if plan2 is not self.df.plan:
            return GroupedData(DataFrame(plan2, self.df.session),
                               groupings2)._agg_impl(*exprs2)

        if all(isinstance(e.children[0] if isinstance(e, ir.Alias) else e,
                          ir.AggregateExpression) for e in agg_exprs):
            return DataFrame(
                lp.Aggregate(self.df.plan, self.groupings, agg_exprs),
                self.df.session)
        # Compound post-aggregation expressions (sum(a)/sum(b), ...):
        # decompose into plain aggregates + a final projection, the same
        # split the reference's final-projection stage performs
        # (reference: aggregate.scala:326-421 "final projection").
        leaves: List[ir.Expression] = []

        def repl(node):
            if isinstance(node, ir.AggregateExpression):
                name = f"__agg{len(leaves)}"
                leaves.append(ir.Alias(node, name))
                return ir.UnresolvedAttribute(name)
            return None

        projected = []
        for e in agg_exprs:
            name = ir.output_name(e)
            inner = e.children[0] if isinstance(e, ir.Alias) else e
            projected.append(ir.Alias(ir.transform(inner, repl), name))
        agg_plan = lp.Aggregate(self.df.plan, self.groupings, leaves)
        final = [ir.UnresolvedAttribute(ir.output_name(g))
                 for g in self.groupings] + projected
        return DataFrame(lp.Project(agg_plan, final), self.df.session)

    def _simple(self, fn, cols) -> DataFrame:
        from spark_rapids_tpu_torch.api import functions as F
        if not cols:
            cols = [f.name for f in self.df.plan.schema.fields
                    if f.dtype.is_numeric]
        builder = {"count": F.count, "sum": F.sum, "min": F.min,
                   "max": F.max, "avg": F.avg}[fn]
        if fn == "count":
            return self.agg(F.count("*").alias("count"))
        return self.agg(*[
            builder(c).alias(f"{fn}({c})") for c in cols])

    def count(self) -> DataFrame:
        return self._simple("count", [])

    def sum(self, *cols) -> DataFrame:
        return self._simple("sum", cols)

    def min(self, *cols) -> DataFrame:
        return self._simple("min", cols)

    def max(self, *cols) -> DataFrame:
        return self._simple("max", cols)

    def avg(self, *cols) -> DataFrame:
        return self._simple("avg", cols)

    mean = avg

    # -- pandas-UDF entry points: not ported yet -----------------------------
    def apply_in_pandas(self, fn, schema) -> DataFrame:
        raise _not_ported("apply_in_pandas", "pyworker/execs.py")

    def agg_in_pandas(self, fn, args, out_name: str,
                      out_type="double") -> DataFrame:
        raise _not_ported("agg_in_pandas", "pyworker/execs.py")

    def cogroup(self, other: "GroupedData"):
        raise _not_ported("cogroup", "pyworker/execs.py")
