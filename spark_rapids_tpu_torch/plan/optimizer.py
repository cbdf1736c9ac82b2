"""Logical optimizations: column pruning.

Reference analog: Spark's ``ColumnPruning`` rule, which the reference
plugin inherits from Catalyst before ``GpuOverrides`` ever sees the
plan — scans read only referenced columns.  This engine owns its whole
stack, so the rule lives here: a top-down required-ordinal analysis over
the bound logical plan, then a bottom-up rebuild that narrows
``FileScan``/``InMemoryScan`` leaves and remaps every ancestor's
``BoundReference`` ordinals through the changed schemas.

Pruning a scan matters twice on TPU: the device parquet decode skips
whole column chunks (the q6 bench decodes 4 of 6 columns), and
in-memory uploads skip the HBM transfer entirely.

The port's copy of ``spark_rapids_tpu/plan/optimizer.py``, with its
imports retargeted and one repair: a cached relation is a leaf here.
The reference's rewrite recurses below it and copies the relation
whenever its child narrows (a cached projection of a scan), so every
action materializes a fresh copy; the port leaves the shared relation in
place, and ``exec/cache.materialize`` prunes its child instead.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch.expr import ir
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.logical import Schema

# mapping: old output ordinal -> new output ordinal; None = unchanged
_Mapping = Optional[Dict[int, int]]


def _refs(exprs) -> Set[int]:
    out: Set[int] = set()
    for e in exprs:
        if e is None:
            continue
        for b in ir.collect(e, lambda n: isinstance(n, ir.BoundReference)):
            out.add(b.ordinal)
    return out


def _remap_expr(e: ir.Expression, mapping: Dict[int, int]
                ) -> ir.Expression:
    if isinstance(e, ir.BoundReference):
        if e.ordinal not in mapping:
            raise KeyError(f"pruned column referenced: {e.sql()}")
        return ir.BoundReference(mapping[e.ordinal], e.dtype, e.nullable,
                                 e.ref_name)
    if not e.children:
        return e
    new_children = tuple(_remap_expr(c, mapping) for c in e.children)
    if all(n is o for n, o in zip(new_children, e.children)):
        return e
    e2 = copy.copy(e)
    e2.children = new_children
    return e2


def _remap_all(exprs, mapping):
    return [None if e is None else _remap_expr(e, mapping)
            for e in exprs]


def _shallow(node, **attrs):
    n2 = copy.copy(node)
    for k, v in attrs.items():
        setattr(n2, k, v)
    return n2


def _all(node) -> Set[int]:
    return set(range(len(node.schema.names)))


def prune_columns(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """Return an equivalent plan whose scans read only needed columns."""
    try:
        new, mapping = _rewrite(plan, None)
    except KeyError:
        return plan          # a reference the analysis missed: bail out
    # the root's output schema must be unchanged (needed=None = all)
    return plan if mapping is not None else new


def _rewrite(node: lp.LogicalPlan, needed: Optional[Set[int]]
             ) -> Tuple[lp.LogicalPlan, _Mapping]:
    if needed is not None and needed >= _all(node):
        needed = None

    # ---- leaves -----------------------------------------------------------
    if isinstance(node, lp.CachedRelation):
        # one shared object holds the blobs: a copy would materialize anew
        return node, None
    if isinstance(node, lp.FileScan):
        if needed is None or node.options.get("columns"):
            return node, None
        keep = sorted(needed)
        if not keep:                       # COUNT(*)-style: keep one
            keep = [0]
        names = [node.schema.names[o] for o in keep]
        # the logical schema must narrow too: ancestors that derive
        # their schema from child.schema (Join, Window) otherwise
        # compute ordinal offsets from the unpruned column list
        # ``file_schema`` keeps the unpruned schema: the device CSV
        # decode counts every column of the file (the reference passes
        # the narrowed one, and each of its pruned CSV scans falls back
        # whole-file)
        new = lp.FileScan(node.fmt, node.paths,
                          Schema([node.schema.field(c) for c in names]),
                          dict(node.options, columns=names,
                               file_schema=node.schema))
        return new, {o: i for i, o in enumerate(keep)}
    if isinstance(node, lp.InMemoryScan):
        if needed is None:
            return node, None
        keep = sorted(needed)
        if not keep:
            keep = [0]
        names = [node.schema.names[o] for o in keep]
        new = lp.InMemoryScan(node.table.select(names),
                              node.num_partitions)
        return new, {o: i for i, o in enumerate(keep)}
    if not node.children:
        return node, None

    # ---- single-child nodes ----------------------------------------------
    if isinstance(node, lp.Project):
        child, m = _rewrite(node.children[0], _refs(node.exprs))
        if m is None:
            if child is node.children[0]:
                return node, None
            return _shallow(node, children=(child,)), None
        return _shallow(node, children=(child,),
                        exprs=_remap_all(node.exprs, m)), None
    if isinstance(node, lp.Aggregate):
        child, m = _rewrite(node.children[0],
                            _refs(node.groupings) |
                            _refs(node.aggregates))
        if m is None:
            if child is node.children[0]:
                return node, None
            return _shallow(node, children=(child,)), None
        return _shallow(
            node, children=(child,),
            groupings=_remap_all(node.groupings, m),
            aggregates=_remap_all(node.aggregates, m)), None
    if isinstance(node, lp.Filter):
        child_need = None if needed is None else \
            set(needed) | _refs([node.condition])
        child, m = _rewrite(node.children[0], child_need)
        if m is None:
            if child is node.children[0]:
                return node, None
            return _shallow(node, children=(child,)), None
        return _shallow(node, children=(child,),
                        condition=_remap_expr(node.condition, m)), m
    if isinstance(node, lp.Sort):
        child_need = None if needed is None else \
            set(needed) | _refs([o.expr for o in node.orders])
        child, m = _rewrite(node.children[0], child_need)
        if m is None:
            if child is node.children[0]:
                return node, None
            return _shallow(node, children=(child,)), None
        orders = [lp.SortOrder(_remap_expr(o.expr, m), o.ascending,
                               o.nulls_first) for o in node.orders]
        return _shallow(node, children=(child,), orders=orders), m
    if isinstance(node, (lp.Limit, lp.CoalescePartitions)):
        child, m = _rewrite(node.children[0], needed)
        if m is None:
            if child is node.children[0]:
                return node, None
            return _shallow(node, children=(child,)), None
        return _shallow(node, children=(child,)), m
    if isinstance(node, lp.Repartition):
        child_need = None if needed is None else (
            set(needed) | _refs(node.exprs)
            | _refs([o.expr for o in node.orders]))
        child, m = _rewrite(node.children[0], child_need)
        if m is None:
            if child is node.children[0]:
                return node, None
            return _shallow(node, children=(child,)), None
        orders = [lp.SortOrder(_remap_expr(o.expr, m), o.ascending,
                               o.nulls_first) for o in node.orders]
        return _shallow(node, children=(child,),
                        exprs=_remap_all(node.exprs, m),
                        orders=orders), m
    if isinstance(node, lp.Window):
        n_child = len(node.children[0].schema.names)
        if needed is None:
            child_need = None
        else:
            child_need = {o for o in needed if o < n_child} | \
                _refs(node.window_exprs)
        child, m = _rewrite(node.children[0], child_need)
        if m is None:
            if child is node.children[0]:
                return node, None
            return _shallow(node, children=(child,)), None
        wexprs = _remap_all(node.window_exprs, m)
        new_fields = list(child.schema.fields) + \
            [lp.Field(n, e.dtype, e.nullable)
             for n, e in zip(node.out_names, wexprs)]
        out_map = {o: m[o] for o in sorted(m)}
        n_new_child = len(child.schema.names)
        for i, _ in enumerate(node.out_names):
            out_map[n_child + i] = n_new_child + i
        return _shallow(node, children=(child,), window_exprs=wexprs,
                        _schema=Schema(new_fields)), out_map

    # ---- multi-child nodes ------------------------------------------------
    if isinstance(node, lp.Union):
        if needed is None:
            outs = [_rewrite(c, None) for c in node.children]
            # needed=None passes through, so no branch can narrow its
            # OUTPUT (mapping None) — but a branch may still have pruned
            # scans deeper down (e.g. below its own Project)
            assert all(m is None for _, m in outs)
            if all(c is o for (c, _), o in zip(outs, node.children)):
                return node, None
            return _shallow(node,
                            children=tuple(c for c, _ in outs)), None
        # positional schemas: same ordinals for every branch; narrow the
        # union output only when every branch narrows identically —
        # otherwise keep each branch's internal pruning but present the
        # full output (re-rewrite with needed=None)
        outs = [_rewrite(c, set(needed)) for c in node.children]
        maps = [m for _, m in outs]
        if all(m is None for m in maps):
            if all(c is o for (c, _), o in zip(outs, node.children)):
                return node, None
            return _shallow(node,
                            children=tuple(c for c, _ in outs)), None
        if any(m is None for m in maps) or len({tuple(sorted(m.items()))
                                                for m in maps}) != 1:
            outs = [_rewrite(c, None) for c in node.children]
            if all(c is o for (c, _), o in zip(outs, node.children)):
                return node, None
            return _shallow(node,
                            children=tuple(c for c, _ in outs)), None
        return _shallow(node, children=tuple(c for c, _ in outs)), \
            maps[0]
    if isinstance(node, lp.Join):
        lnames = node.children[0].schema.names
        rnames = node.children[1].schema.names
        n_l = len(lnames)
        semi = node.how in ("semi", "anti")
        if needed is None:
            l_need: Optional[Set[int]] = None
            r_need: Optional[Set[int]] = None
        else:
            l_need = {o for o in needed if o < n_l}
            r_need = set() if semi else \
                {o - n_l for o in needed if o >= n_l}
        cond_refs = _refs([node.condition])
        if l_need is not None:
            l_need |= {lnames.index(k) for k in node.left_keys}
            l_need |= {o for o in cond_refs if o < n_l}
        if r_need is not None:
            r_need |= {rnames.index(k) for k in node.right_keys}
            r_need |= {o - n_l for o in cond_refs if o >= n_l}
        lc, lm = _rewrite(node.children[0], l_need)
        rc, rm = _rewrite(node.children[1], r_need)
        if lm is None and rm is None:
            if lc is node.children[0] and rc is node.children[1]:
                return node, None
            return _shallow(node, children=(lc, rc)), None
        lm = lm if lm is not None else {i: i for i in range(n_l)}
        n_l_new = len(lc.schema.names)
        rm = rm if rm is not None else {i: i for i in range(len(rnames))}
        # rebuild through the constructor: it rederives the output
        # schema, key dtypes, and binds the (unbound-equivalent)
        # condition — remap the old condition to the new joined space
        joined_map = dict(lm)
        for o, n in rm.items():
            joined_map[n_l + o] = n_l_new + n
        cond = None if node.condition is None else \
            _remap_expr(node.condition, joined_map)
        new = copy.copy(node)
        new.children = (lc, rc)
        new.condition = cond
        lf, rf = lc.schema.fields, rc.schema.fields
        if semi:
            new._schema = Schema(list(lf))
        else:
            nullable_l = node.how in ("right", "full")
            nullable_r = node.how in ("left", "full")
            new._schema = Schema(
                [lp.Field(f.name, f.dtype, f.nullable or nullable_l)
                 for f in lf] +
                [lp.Field(f.name, f.dtype, f.nullable or nullable_r)
                 for f in rf])
        if semi:
            return new, (None if lm == {i: i for i in range(n_l)}
                         else lm)
        return new, (None if joined_map ==
                     {i: i for i in range(len(node.schema.names))}
                     else joined_map)

    # unhandled node kinds (Generate, Expand, pandas nodes, caches, …):
    # require everything below, never narrow through
    new_children = []
    changed = False
    for c in node.children:
        nc, m = _rewrite(c, None)
        changed = changed or nc is not c
        assert m is None
        new_children.append(nc)
    if not changed:
        return node, None
    return _shallow(node, children=tuple(new_children)), None
