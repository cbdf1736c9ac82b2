"""Whole-stage fusion pass: collapse Project/Filter chains into single
fused stages.

Runs inside ``TpuOverrides.apply`` (the physical-plan rewrite point the
planner pipeline funnels through — session ``_plan_physical`` ->
``prune_columns`` -> ``plan_cpu`` -> overrides -> THIS), after
conversion produced Tpu execs and before the lone-filter-under-
aggregate post-pass.  Two rewrites, both gated by
``spark.rapids.tpu.sql.fusion.enabled``:

**R1 — chain collapse.**  A maximal chain of single-consumer
``TpuProjectExec`` / ``TpuFilterExec`` nodes becomes one
``TpuFusedStageExec`` (exec/fused_stage.py): every filter condition is
rewritten over the chain INPUT schema by substituting the projections
below it and AND-combined into one mask (one compaction at most); the
composed output projection evaluates after the compaction, so the
chain's intermediate columns are never materialized.  A chain whose
composition degenerates to pure column selection becomes a
zero-dispatch passthrough stage.

**R2 — aggregate prologue inlining.**  Projections (and filters)
directly under a ``TpuHashAggregateExec`` are the aggregate's
expression-evaluation prologue: their expressions substitute straight
into the grouping keys / aggregate arguments (filters AND into
``fused_condition``, the update kernel's row mask), eliminating those
dispatches entirely — the fused q6 shape is ONE update kernel per
batch for scan->project->filter->aggregate.

Fusion barriers (a chain stops at, and never crosses):
  * position-dependent expressions — ``MonotonicallyIncreasingID``,
    ``Rand`` key on row position, which a fused compaction reorders;
  * non-deterministic / CPU-only payloads — ``PythonUDF``,
    ``InputFileName`` (scan-scoped context);
  * multi-consumer subtrees — a node referenced by two parents must
    keep its identity (each parent drains its iterators);
  * ``SparkPartitionID`` additionally bars R2 only: the aggregate's
    update kernel runs without the task context the fused stage
    threads through (the stage itself fuses it fine);
  * the composed DAG exceeding ``sql.fusion.maxExprs`` nodes
    (substitution duplicates shared subtrees).

The port's copy of ``spark_rapids_tpu/plan/fusion.py``, with the
reference's plan-shape counters (``fusion.stages``, ``fusion.execsFused``,
``fusion.aggProloguesInlined``) in the obs registry; a query profile
shows them in its ``fusion`` section.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import RapidsTpuConf
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.exec.fused_stage import TpuFusedStageExec
from spark_rapids_tpu_torch.exec.tpu_basic import TpuFilterExec, TpuProjectExec
from spark_rapids_tpu_torch.expr import ir
from spark_rapids_tpu_torch.obs import registry as obsreg

# position-dependent or otherwise unfusable expression nodes
_STAGE_BARRIERS = (ir.MonotonicallyIncreasingID, ir.Rand, ir.PythonUDF,
                   ir.InputFileName, ir.AggregateExpression,
                   ir.WindowExpression)
# the aggregate update kernel runs without a task context
_AGG_BARRIERS = _STAGE_BARRIERS + (ir.SparkPartitionID,)


def _has_barrier(exprs, barriers) -> bool:
    return any(
        ir.collect(e, lambda n: isinstance(n, barriers)) for e in exprs
        if e is not None)


def _strip_alias(e: ir.Expression) -> ir.Expression:
    while isinstance(e, ir.Alias):
        e = e.children[0]
    return e


def _subst(e: ir.Expression,
           mapping: List[ir.Expression]) -> ir.Expression:
    """Rewrite ``e`` (over the mapping's output schema) into an
    expression over the mapping's INPUT schema.  Shared subtrees stay
    shared — expressions are read-only at eval time."""
    def repl(n):
        if isinstance(n, ir.BoundReference):
            return mapping[n.ordinal]
        return None
    return ir.transform(e, repl)


def _n_nodes(e: Optional[ir.Expression]) -> int:
    if e is None:
        return 0
    return 1 + sum(_n_nodes(c) for c in e.children)


def _mk_and(a: ir.Expression, b: ir.Expression) -> ir.Expression:
    out = ir.And(a, b)
    out.resolve()
    return out


def _identity_mapping(schema) -> List[ir.Expression]:
    return [ir.BoundReference(i, f.dtype, f.nullable, name_=f.name)
            for i, f in enumerate(schema.fields)]


def _refcounts(plan: PhysicalPlan) -> Dict[int, int]:
    """Parent-edge counts by node identity; >1 marks a multi-consumer
    subtree no chain may consume.  Recurse into a node only on first
    visit: re-walking a shared subtree once per parent would count
    root-to-node PATHS, inflating every descendant of a multi-consumer
    node past 1 and silently barring single-consumer chains below it
    from ever fusing (and is exponential on stacked shared nodes)."""
    refs: Dict[int, int] = {}

    def rec(n: PhysicalPlan) -> None:
        for c in n.children:
            first = id(c) not in refs
            refs[id(c)] = refs[id(c)] + 1 if not first else 1
            if first:
                rec(c)
    rec(plan)
    return refs


def _node_exprs(n: PhysicalPlan) -> List[ir.Expression]:
    if isinstance(n, TpuProjectExec):
        return list(n.exprs)
    return [n.condition]


def _collect_chain(head: PhysicalPlan,
                   refs: Dict[int, int]) -> List[PhysicalPlan]:
    """Maximal fusable chain starting at ``head``, top-down."""
    seq: List[PhysicalPlan] = []
    n = head
    while isinstance(n, (TpuProjectExec, TpuFilterExec)) and \
            refs.get(id(n), 0) <= 1 and \
            not _has_barrier(_node_exprs(n), _STAGE_BARRIERS):
        seq.append(n)
        n = n.children[0]
    return seq


def _compose(seq: List[PhysicalPlan], max_nodes: int
             ) -> Optional[Tuple[List[ir.Expression],
                                 Optional[ir.Expression]]]:
    """Compose a top-down chain into (out_exprs, condition) over the
    chain input schema; None when past the maxExprs guard."""
    mapping = _identity_mapping(seq[-1].children[0].schema)
    cond: Optional[ir.Expression] = None
    for n in reversed(seq):
        if isinstance(n, TpuFilterExec):
            c = _subst(n.condition, mapping)
            cond = c if cond is None else _mk_and(cond, c)
        else:
            mapping = [_subst(_strip_alias(e), mapping) for e in n.exprs]
    total = sum(_n_nodes(e) for e in mapping) + _n_nodes(cond)
    if total > max_nodes or not mapping:
        return None
    return mapping, cond


def _worthwhile(seq: List[PhysicalPlan], out_exprs: List[ir.Expression],
                cond: Optional[ir.Expression]) -> bool:
    """Fuse only when the stage costs fewer dispatches than the chain:
    >= 2 chain nodes collapse to one dispatch; a single pure-select
    project collapses to zero (passthrough)."""
    if len(seq) >= 2:
        return True
    pure = cond is None and all(isinstance(e, ir.BoundReference)
                                for e in out_exprs)
    return pure and len(seq) >= 1


def _try_collapse(head: PhysicalPlan, refs: Dict[int, int],
                  max_nodes: int) -> Optional[TpuFusedStageExec]:
    seq = _collect_chain(head, refs)
    if not seq:
        return None
    composed = _compose(seq, max_nodes)
    if composed is None:
        return None
    out_exprs, cond = composed
    if not _worthwhile(seq, out_exprs, cond):
        return None
    return TpuFusedStageExec(
        seq[-1].children[0], out_exprs, seq[0].schema, cond,
        fused=[type(n).__name__ for n in seq])


def _absorb_agg_prologue(agg, refs: Dict[int, int],
                         max_nodes: int,
                         allow_filter: bool = True) -> int:
    """R2: inline the Project/Filter prologue directly under a hash
    aggregate into its grouping/aggregate-argument expressions and
    ``fused_condition`` row mask.  Returns execs absorbed."""
    from spark_rapids_tpu_torch.exec.tpu_aggregate import TpuHashAggregateExec
    assert isinstance(agg, TpuHashAggregateExec)
    absorbed = 0
    while True:
        child = agg.children[0]
        if refs.get(id(child), 0) > 1:
            break
        if isinstance(child, TpuFilterExec):
            if not allow_filter or \
                    _has_barrier([child.condition], _AGG_BARRIERS):
                break
            # a filter sitting DIRECTLY under the aggregate in the
            # original plan is absorbed by the legacy
            # _fuse_filters_into_aggregates post-pass even with fusion
            # off (same agg.fusedFilter gate), so it is not a dispatch
            # fusion saves — don't let it inflate dispatchesSaved
            legacy_would_absorb = (absorbed == 0
                                   and agg.fused_condition is None)
            cond = child.condition if agg.fused_condition is None \
                else _mk_and(agg.fused_condition, child.condition)
            if (_n_nodes(cond) + sum(_n_nodes(g) for g in agg.groupings)
                    + sum(_n_nodes(c) for a in agg.aggregates
                          for c in a.children)) > max_nodes:
                break
            agg.fused_condition = cond
            agg.children = (child.children[0],)
            agg.fused_prologue_execs += 1
            if not legacy_would_absorb:
                agg.fused_prologue_saved += 1
        elif isinstance(child, TpuProjectExec):
            exprs = [_strip_alias(e) for e in child.exprs]
            if _has_barrier(exprs, _AGG_BARRIERS):
                break
            new_groupings = [_subst(g, exprs) for g in agg.groupings]
            # CLONE the aggregate nodes (with_children) — the
            # AggregateExpression objects are shared with the logical
            # plan, and mutating their children in place would poison
            # the NEXT planning of the same DataFrame (the second
            # collect() would substitute already-substituted ordinals
            # through a different projection)
            new_aggs = [a.with_children(
                tuple(_subst(c, exprs) for c in a.children))
                for a in agg.aggregates]
            new_cond = None if agg.fused_condition is None \
                else _subst(agg.fused_condition, exprs)
            total = (sum(_n_nodes(g) for g in new_groupings)
                     + sum(_n_nodes(c) for a in new_aggs
                           for c in a.children)
                     + _n_nodes(new_cond))
            if total > max_nodes:
                break
            from spark_rapids_tpu_torch.exec.tpu_aggregate import make_spec
            agg.groupings[:] = new_groupings
            agg.aggregates[:] = new_aggs
            # specs wrap the aggregate nodes; rebuild over the clones
            agg.specs[:] = [make_spec(a) for a in new_aggs]
            agg.fused_condition = new_cond
            agg.children = (child.children[0],)
            agg.fused_prologue_execs += 1
            agg.fused_prologue_saved += 1  # legacy never absorbs projects
        else:
            break
        absorbed += 1
    return absorbed


class _Holder(PhysicalPlan):
    """Transient root wrapper so the real root can head a chain."""

    def __init__(self, child: PhysicalPlan):
        self.children = (child,)


def fuse_stages(plan: PhysicalPlan, conf: RapidsTpuConf) -> PhysicalPlan:
    """Apply R2 then R1 over the whole converted plan; returns the
    (possibly new) root."""
    from spark_rapids_tpu_torch.exec.tpu_aggregate import TpuHashAggregateExec

    max_nodes = int(conf.get(cfg.FUSION_MAX_EXPRS))
    allow_filter = bool(conf.get(cfg.AGG_FUSED_FILTER))
    refs = _refcounts(plan)
    reg = obsreg.get_registry()
    holder = _Holder(plan)
    # a shared subtree is rewritten ONCE (both parents keep pointing at
    # the same mutated object); re-walking it per parent would re-run
    # the agg-prologue absorption and double the plan-shape counters
    seen = set()

    def rec(n: PhysicalPlan) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, TpuHashAggregateExec):
            inlined = _absorb_agg_prologue(n, refs, max_nodes,
                                           allow_filter)
            if inlined:
                reg.inc("fusion.aggProloguesInlined", inlined)
        new_children = []
        for c in n.children:
            stage = _try_collapse(c, refs, max_nodes)
            if stage is not None:
                reg.inc("fusion.stages")
                reg.inc("fusion.execsFused", stage.n_fused())
            new_children.append(c if stage is None else stage)
        if tuple(new_children) != tuple(n.children):
            n.children = tuple(new_children)
        for c in n.children:
            rec(c)

    rec(holder)
    return holder.children[0]
