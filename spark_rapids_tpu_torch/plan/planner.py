"""Physical planner: logical plan -> CPU physical plan.

Ported from ``spark_rapids_tpu/plan/planner.py`` (``plan_cpu`` :27).  It
produces the "stock" CPU physical plan that ``TpuOverrides.apply``
(plan/overrides.py) then rewrites.  Planning pipeline (session
``_plan_physical``): ``prune_columns`` (plan/optimizer.py) -> ``plan_cpu``
(here) -> ``TpuOverrides.apply``, which converts to device execs and runs
the whole-stage fusion pass (plan/fusion.py).

The exchanges are planned as the reference plans them
(``shuffle/exchange.py``): a hash exchange under the two-stage aggregate
(``sql.agg.exchange.enabled``, or transport ici/ici_ring/process) and the
partitionwise window (``sql.window.exchange.enabled``, or ici/ici_ring),
a range exchange under the distributed sort (``sql.sort.exchange.enabled``,
or ici/ici_ring), repartition/coalesce, and a hash exchange on both sides
of a shuffled join.  A cached relation plans as a
``CpuInMemoryTableScanExec`` (exec/cache.py), which the overrides turn
into the device's cached scan.  A node whose exec lives in a module the
port has not ported yet raises ``NotImplementedError`` naming that
module: pandas UDFs (``pyworker/execs.py``).
"""

from __future__ import annotations

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import RapidsTpuConf
from spark_rapids_tpu_torch.exec import cpu as cpux
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.expr import ir
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.shuffle import exchange as ex


def _not_ported(what: str, module: str):
    return NotImplementedError(
        f"planner: {what} needs spark_rapids_tpu/{module}, which the "
        f"torch port has not ported yet")


def plan_cpu(node: lp.LogicalPlan, conf: RapidsTpuConf) -> PhysicalPlan:
    if isinstance(node, lp.InMemoryScan):
        return cpux.CpuScanExec(node.table, node.num_partitions,
                                conf.get(cfg.MAX_READER_BATCH_SIZE_ROWS))
    if isinstance(node, lp.FileScan):
        from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
        return CpuFileScanExec(node, conf)
    if isinstance(node, lp.CachedRelation):
        from spark_rapids_tpu_torch.exec.cache import \
            CpuInMemoryTableScanExec
        return CpuInMemoryTableScanExec(node, conf)
    if isinstance(node, lp.Project):
        _check_no_pandas_udfs(node.exprs)
        return cpux.CpuProjectExec(plan_cpu(node.children[0], conf),
                                   node.exprs, node.schema)
    if isinstance(node, lp.Filter):
        _check_no_pandas_udfs([node.condition])
        return cpux.CpuFilterExec(plan_cpu(node.children[0], conf),
                                  node.condition)
    if isinstance(node, lp.Sort):
        return _plan_sort(node, plan_cpu(node.children[0], conf), conf)
    if isinstance(node, lp.Aggregate):
        child = plan_cpu(node.children[0], conf)
        aggs = []
        for a in node.aggregates:
            inner = a.children[0] if isinstance(a, ir.Alias) else a
            if not isinstance(inner, ir.AggregateExpression):
                raise NotImplementedError(
                    "aggregate expressions must be plain aggregate "
                    "functions (optionally aliased) for now")
            aggs.append(inner)
        groupings = list(node.groupings)
        _check_no_pandas_udfs(groupings + [a.children[0] for a in aggs
                                           if a.children])
        # distributed plan shape: hash exchange on the grouping keys,
        # then a per-partition aggregate
        two_stage = bool(groupings) and (
            conf.get(cfg.AGG_EXCHANGE)
            or str(conf.get(cfg.SHUFFLE_TRANSPORT)) in ("ici", "ici_ring",
                                                        "process"))
        if two_stage and all(g.dtype is not None and not g.dtype.is_nested
                             for g in groupings):
            child = ex.CpuShuffleExchangeExec(
                child, ex.HashPartitioning(conf.shuffle_partitions,
                                           list(groupings)))
            return cpux.CpuHashAggregateExec(child, groupings, aggs,
                                             node.schema,
                                             per_partition=True)
        return cpux.CpuHashAggregateExec(child, groupings, aggs,
                                         node.schema)
    if isinstance(node, lp.Limit):
        return cpux.CpuLimitExec(plan_cpu(node.children[0], conf), node.n)
    if isinstance(node, lp.Union):
        return cpux.CpuUnionExec([plan_cpu(c, conf) for c in node.children])
    if isinstance(node, lp.Join):
        return _plan_join(node, conf)
    if isinstance(node, lp.Repartition):
        child = plan_cpu(node.children[0], conf)
        n = node.num_partitions
        if node.kind == "hash":
            part = ex.HashPartitioning(n, node.exprs)
        elif node.kind == "range":
            part = ex.RangePartitioning(n, node.orders)
        elif node.kind == "single":
            part = ex.SinglePartitioning(n)
        else:
            part = ex.RoundRobinPartitioning(n)
        return ex.CpuShuffleExchangeExec(child, part)
    if isinstance(node, lp.CoalescePartitions):
        return ex.CpuCoalescePartitionsExec(plan_cpu(node.children[0], conf),
                                            node.num_partitions)
    if isinstance(node, lp.Range):
        return cpux.CpuRangeExec(node.start, node.end, node.step,
                                 node.num_partitions)
    if isinstance(node, lp.Expand):
        return cpux.CpuExpandExec(plan_cpu(node.children[0], conf),
                                  node.projections, node.schema)
    if isinstance(node, lp.Generate):
        from spark_rapids_tpu_torch.exec.generate import CpuGenerateExec
        return CpuGenerateExec(plan_cpu(node.children[0], conf),
                               node.generator, node.schema)
    if isinstance(node, lp.Window):
        from spark_rapids_tpu_torch.exec.cpu_window import CpuWindowExec
        child = plan_cpu(node.children[0], conf)
        # distributed plan shape: every window spec shares one non-empty
        # PARTITION BY -> hash exchange on those keys, then the window per
        # partition
        dist = conf.get(cfg.WINDOW_EXCHANGE) or \
            str(conf.get(cfg.SHUFFLE_TRANSPORT)) in ("ici", "ici_ring")
        if dist and node.window_exprs:
            psigs = {tuple(e.sql() for e in we.partition_exprs)
                     for we in node.window_exprs}
            pk = list(node.window_exprs[0].partition_exprs)
            if len(psigs) == 1 and pk and \
                    all(e.dtype is not None and not e.dtype.is_nested
                        for e in pk):
                child = ex.CpuShuffleExchangeExec(
                    child, ex.HashPartitioning(conf.shuffle_partitions,
                                               pk))
                return CpuWindowExec(child, node.window_exprs,
                                     node.out_names, node.schema,
                                     partitionwise=True)
        return CpuWindowExec(child, node.window_exprs, node.out_names,
                             node.schema)
    if isinstance(node, (lp.MapInPandas, lp.FlatMapGroupsInPandas,
                         lp.CoGroupedMapInPandas, lp.AggregateInPandas,
                         lp.WindowInPandas)):
        raise _not_ported(type(node).__name__, "pyworker/execs.py")
    raise NotImplementedError(f"planner: {type(node).__name__}")


def _check_no_pandas_udfs(exprs) -> None:
    """Vectorized (pandas) PythonUDFs evaluate in an ArrowEvalPython
    stage the port does not have yet."""
    for e in exprs:
        if e is not None and ir.collect(e, lambda x: isinstance(
                x, ir.PythonUDF) and getattr(x, "vectorized", False)):
            raise _not_ported("a pandas UDF", "pyworker/execs.py")


def _plan_sort(node: lp.Sort, child: PhysicalPlan,
               conf: RapidsTpuConf) -> PhysicalPlan:
    _check_no_pandas_udfs([o.expr for o in node.orders])
    dist = bool(node.orders) and (
        conf.get(cfg.SORT_EXCHANGE)
        or str(conf.get(cfg.SHUFFLE_TRANSPORT)) in ("ici", "ici_ring"))
    if dist and all(o.expr.dtype is not None and not o.expr.dtype.is_nested
                    for o in node.orders):
        # partition p holds range bucket p, so the partition-ordered
        # concatenation of the per-partition sorts is the total order
        exch = ex.CpuShuffleExchangeExec(
            child, ex.RangePartitioning(conf.shuffle_partitions,
                                        node.orders))
        return cpux.CpuSortExec(exch, node.orders, partitionwise=True)
    return cpux.CpuSortExec(child, node.orders)


def _plan_join(node, conf: RapidsTpuConf):
    """Join strategy selection, as the reference's: broadcast-hash when a
    side is hinted or estimated under
    spark.rapids.tpu.sql.autoBroadcastJoinThreshold, else shuffled-hash
    with a hash exchange on both sides; cross joins become
    broadcast-nested-loop (small side) or a cartesian product."""
    left = plan_cpu(node.children[0], conf)
    right = plan_cpu(node.children[1], conf)
    threshold = conf.get(cfg.AUTO_BROADCAST_THRESHOLD)
    lsize = lp.size_estimate(node.children[0])
    rsize = lp.size_estimate(node.children[1])
    args = (node.left_keys, node.right_keys, node.how, node.condition,
            node.schema, node.key_dtypes)

    if node.how == "cross" or not node.left_keys:
        small = min(lsize, rsize)
        if node.hint == "broadcast_left" or (
                node.hint is None and small <= threshold and lsize <= rsize):
            return cpux.CpuBroadcastNestedLoopJoinExec(
                left, right, *args, build_side="left")
        if node.hint == "broadcast_right" or (
                node.hint is None and small <= threshold):
            return cpux.CpuBroadcastNestedLoopJoinExec(
                left, right, *args, build_side="right")
        return cpux.CpuCartesianProductExec(left, right, *args)

    # Spark build-side validity: inner/cross either; left/semi/anti build
    # right only; right outer build left only; full outer no broadcast
    can_build_right = node.how in ("inner", "left", "semi", "anti")
    can_build_left = node.how in ("inner", "right")
    build = None
    if node.hint == "broadcast_right" and can_build_right:
        build = "right"
    elif node.hint == "broadcast_left" and can_build_left:
        build = "left"
    elif can_build_right and rsize <= threshold and \
            (not can_build_left or rsize <= lsize):
        build = "right"
    elif can_build_left and lsize <= threshold:
        build = "left"
    if build is not None:
        return cpux.CpuBroadcastHashJoinExec(left, right, *args,
                                             build_side=build)

    n = conf.shuffle_partitions

    def bound_keys(side, names):
        s = side.schema
        out = []
        for k, kd in zip(names, node.key_dtypes):
            e = ir.bind(ir.UnresolvedAttribute(k), s.names, s.dtypes,
                        s.nullables)
            if e.dtype != kd:
                # both sides must hash the promoted key type identically
                e = ir.Cast(e, kd)
                e.resolve()
            out.append(e)
        return out

    lex = ex.CpuShuffleExchangeExec(
        left, ex.HashPartitioning(n, bound_keys(node.children[0],
                                                node.left_keys)))
    rex = ex.CpuShuffleExchangeExec(
        right, ex.HashPartitioning(n, bound_keys(node.children[1],
                                                 node.right_keys)))
    return cpux.CpuShuffledHashJoinExec(lex, rex, *args)
