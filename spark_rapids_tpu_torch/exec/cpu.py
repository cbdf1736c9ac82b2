"""CPU physical execs — the engine's "stock Spark" execution path.

In the reference, unsupported operators stay as Spark's own CPU execs
(reference: RapidsMeta.scala:605-624 convertIfNeeded keeps original nodes).
We are standalone, so these execs play that role: a complete, independent
columnar CPU engine over pyarrow, used (a) as the fallback target for
anything the TPU path can't run, and (b) as the oracle side of the parity
test harness (reference: SparkQueryCompareTestSuite).

Batch currency: ``pyarrow.Table``.

The port's copy of ``spark_rapids_tpu/exec/cpu.py``, with its imports
retargeted.
"""

from __future__ import annotations

import itertools
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.expr import eval_cpu, ir
from spark_rapids_tpu_torch.plan.logical import Field, Schema, SortOrder
from spark_rapids_tpu_torch.exec.base import PhysicalPlan


def _empty_table(schema: Schema) -> pa.Table:
    return pa.Table.from_arrays(
        [pa.array([], type=f.dtype.to_arrow()) for f in schema.fields],
        names=schema.names)


def concat_tables(tables: List[pa.Table], schema: Schema) -> pa.Table:
    if not tables:
        return _empty_table(schema)
    if len(tables) == 1:
        return tables[0]
    # no schema promotion: batches of one plan share a schema, and joins
    # legitimately produce duplicate column names that unification rejects
    return pa.concat_tables(tables)


class CpuScanExec(PhysicalPlan):
    def __init__(self, table: pa.Table, num_partitions: int = 1,
                 max_batch_rows: int = 1 << 20):
        super().__init__()
        self.table = table
        self.num_partitions = max(1, num_partitions)
        self.max_batch_rows = max_batch_rows
        self._schema = Schema.from_arrow(table.schema)

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self) -> List[Iterator[pa.Table]]:
        n = self.table.num_rows
        per = (n + self.num_partitions - 1) // self.num_partitions or 1

        def part(i: int) -> Iterator[pa.Table]:
            lo = min(i * per, n)
            hi = min(lo + per, n)
            chunk = self.table.slice(lo, hi - lo)
            for off in range(0, max(chunk.num_rows, 1), self.max_batch_rows):
                yield chunk.slice(off, self.max_batch_rows)
                if chunk.num_rows == 0:
                    break
        return [part(i) for i in range(self.num_partitions)]

    def simple_string(self) -> str:
        return f"CpuScanExec(rows={self.table.num_rows})"


class CpuRangeExec(PhysicalPlan):
    def __init__(self, start: int, end: int, step: int, num_partitions: int):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_partitions = max(1, num_partitions)
        self._schema = Schema([Field("id", dt.INT64, False)])

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self) -> List[Iterator[pa.Table]]:
        vals = np.arange(self.start, self.end, self.step, dtype=np.int64)
        per = (len(vals) + self.num_partitions - 1) // self.num_partitions or 1

        def part(i):
            chunk = vals[i * per:(i + 1) * per]
            yield pa.Table.from_arrays([pa.array(chunk)], names=["id"])
        return [part(i) for i in range(self.num_partitions)]


class CpuProjectExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, exprs: Sequence[ir.Expression],
                 schema: Schema):
        super().__init__()
        self.children = (child,)
        self.exprs = list(exprs)
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self):
        from spark_rapids_tpu_torch.exec import context

        def run(pid, it):
            offset = 0
            for t in it:
                with context.task_context(pid, offset):
                    arrays = [eval_cpu.to_arrow_array(
                        eval_cpu.evaluate(e, t)) for e in self.exprs]
                offset += t.num_rows
                yield pa.Table.from_arrays(arrays, names=self._schema.names)
        return [run(pid, it) for pid, it in
                enumerate(self.children[0].execute())]


class CpuFilterExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, condition: ir.Expression):
        super().__init__()
        self.children = (child,)
        self.condition = condition

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        def run(it):
            for t in it:
                v = eval_cpu.evaluate(self.condition, t)
                mask = v.data.astype(bool) & v.valid
                yield t.filter(pa.array(mask))
        return [run(it) for it in self.children[0].execute()]


class CpuUnionExec(PhysicalPlan):
    def __init__(self, children: Sequence[PhysicalPlan]):
        super().__init__()
        self.children = tuple(children)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        parts: List[Iterator[pa.Table]] = []
        for c in self.children:
            parts.extend(c.execute())
        return parts


class CpuLimitExec(PhysicalPlan):
    """Global limit: concatenates partitions in order and takes n rows."""

    def __init__(self, child: PhysicalPlan, n: int):
        super().__init__()
        self.children = (child,)
        self.n = n

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        def run():
            remaining = self.n
            for it in self.children[0].execute():
                for t in it:
                    if remaining <= 0:
                        return
                    take = min(remaining, t.num_rows)
                    remaining -= take
                    yield t.slice(0, take)
        return [run()]


def _gather_single(child: PhysicalPlan, schema: Schema) -> pa.Table:
    tables = []
    for it in child.execute():
        tables.extend(list(it))
    return concat_tables(tables, schema)


class CpuSortExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder],
                 partitionwise: bool = False):
        super().__init__()
        self.children = (child,)
        self.orders = list(orders)
        # partitionwise: each child partition sorts independently (the
        # planner put a range exchange below, so partition-ordered
        # concatenation is the total order)
        self.partitionwise = partitionwise

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        if self.partitionwise:
            return [self._run_one(
                lambda it=it: concat_tables(list(it), self.schema))
                for it in self.children[0].execute()]
        return [self._run_one(
            lambda: _gather_single(self.children[0], self.schema))]

    def _run_one(self, get_table):
        def run():
            t = get_table()
            key_names = []
            key_arrays = []
            sort_keys = []
            for i, o in enumerate(self.orders):
                name = f"__sort_{i}"
                v = eval_cpu.evaluate(o.expr, t)
                if v.dtype.is_floating:
                    # Spark total order: -inf < ... < +inf < NaN, and
                    # -0.0 == 0.0.  Arrow's sort groups NaN with nulls,
                    # so sort on the sign-flipped IEEE bit key instead
                    # (same transform as the device sortkeys encoder).
                    x = v.data.astype(np.float64)
                    x = np.where(np.isnan(x), np.nan, x)   # canonical NaN
                    x = np.where(x == 0.0, 0.0, x)         # -0.0 -> 0.0
                    u = x.view(np.uint64)
                    sign = np.uint64(1) << np.uint64(63)
                    ukey = np.where(u >> np.uint64(63) == 1, ~u,
                                    u | sign)
                    key = (ukey ^ sign).view(np.int64)
                    v = eval_cpu.CpuVal(dt.INT64, key, v.valid)
                key_names.append(name)
                key_arrays.append(eval_cpu.to_arrow_array(v))
                sort_keys.append((name, "ascending" if o.ascending
                                  else "descending"))
            keyed = t
            for n_, a in zip(key_names, key_arrays):
                keyed = keyed.append_column(n_, a)
            # Spark: nulls_first default matches ascending; arrow option is
            # global so sort per-key from least significant using stable sort
            idx = np.arange(t.num_rows)
            for (name, order), o in zip(reversed(sort_keys),
                                        reversed(self.orders)):
                col = keyed.column(name).combine_chunks()
                sub = col.take(pa.array(idx))
                order_idx = pc.sort_indices(
                    sub, sort_keys=[("", order)],
                    null_placement="at_start" if o.nulls_first_resolved
                    else "at_end")
                idx = idx[np.asarray(order_idx)]
            yield t.take(pa.array(idx))
        return run()


_AGG_MAP = {
    ir.Sum: "sum",
    ir.Min: "min",
    ir.Max: "max",
    ir.Average: "mean",
}


class CpuHashAggregateExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan,
                 groupings: Sequence[ir.Expression],
                 aggregates: Sequence[ir.Expression],
                 schema: Schema, per_partition: bool = False):
        super().__init__()
        self.children = (child,)
        self.groupings = list(groupings)
        self.aggregates = list(aggregates)
        self._schema = schema
        # per_partition: each child partition aggregates independently
        # (correct when the child is hash-partitioned on the grouping
        # keys — the distributed plan shape, see planner two-stage agg)
        self.per_partition = per_partition

    @property
    def schema(self) -> Schema:
        return self._schema

    def _agg_arrays(self, t: pa.Table) -> pa.Table:
        """Project grouping keys and agg inputs with temp names."""
        arrays, names = [], []
        for i, g in enumerate(self.groupings):
            arrays.append(eval_cpu.to_arrow_array(eval_cpu.evaluate(g, t)))
            names.append(f"__k{i}")
        for i, a in enumerate(self.aggregates):
            child = a.child
            if child is None:
                col = pa.array(np.ones(t.num_rows, dtype=np.int64))
            else:
                col = eval_cpu.to_arrow_array(eval_cpu.evaluate(child, t))
            arrays.append(col)
            names.append(f"__a{i}")
        return pa.Table.from_arrays(arrays, names=names)

    @staticmethod
    def _hashable(v):
        """Nested value -> hashable group key (NaN==NaN, -0.0==0.0)."""
        if isinstance(v, list):
            return tuple(CpuHashAggregateExec._hashable(x) for x in v)
        if isinstance(v, tuple):
            return tuple(CpuHashAggregateExec._hashable(x) for x in v)
        if isinstance(v, float):
            if v != v:
                return "__NaN__"
            if v == 0.0:
                return 0.0
        return v

    def execute(self):
        if self.per_partition:
            def run_part(it):
                t = concat_tables(list(it), self.children[0].schema)
                out = self._agg_one(t)
                if out.num_rows:
                    yield out
            return [run_part(it) for it in self.children[0].execute()]

        def run():
            t = _gather_single(self.children[0], self.children[0].schema)
            yield self._agg_one(t)
        return [run()]

    def _agg_one(self, t: pa.Table) -> pa.Table:
        proj = self._agg_arrays(t)
        key_names = [f"__k{i}" for i in range(len(self.groupings))]

        # arrow group_by cannot key on nested types; substitute a dense
        # surrogate id per distinct nested value, map back afterwards
        # (Spark supports grouping on arrays)
        nested_originals = {}
        for i, g in enumerate(self.groupings):
            if g.dtype is None or not g.dtype.is_nested:
                continue
            cname = f"__k{i}"
            arr = proj.column(cname)
            py = arr.to_pylist()
            seen, originals = {}, []
            sur = np.empty(len(py), dtype=np.int64)
            for r, v in enumerate(py):
                k = self._hashable(v)
                if k not in seen:
                    seen[k] = len(seen)
                    originals.append(v)
                sur[r] = seen[k]
            proj = proj.set_column(
                proj.column_names.index(cname), cname, pa.array(sur))
            nested_originals[i] = (originals, arr.type)
        aggs = []
        out_names_in_result = []
        count_modes = {}
        # Spark float ordering: NaN is GREATEST (max -> NaN if any NaN;
        # min -> NaN only when every non-null value is NaN).  Arrow's
        # min/max skip NaN, so strip NaNs to null and carry a per-group
        # NaN count to patch the results after the aggregation.
        nan_fix = {}
        for i, a in enumerate(self.aggregates):
            if isinstance(a, (ir.Min, ir.Max)) and \
                    a.dtype is not None and a.dtype.is_floating:
                cname = f"__a{i}"
                c = proj.column(cname).combine_chunks()
                isn = pc.fill_null(pc.is_nan(c), False)
                clean = pc.if_else(isn, pa.scalar(None, c.type), c)
                proj = proj.set_column(
                    proj.column_names.index(cname), cname, clean)
                proj = proj.append_column(
                    f"{cname}__nan", pc.cast(isn, pa.int64()))
                nan_fix[i] = isinstance(a, ir.Min)
        for i, a in enumerate(self.aggregates):
            if isinstance(a, ir.Count):
                mode = "all" if a.child is None else "only_valid"
                count_modes[f"__a{i}"] = mode
                aggs.append((f"__a{i}", "count",
                             pc.CountOptions(mode=mode)))
                out_names_in_result.append(f"__a{i}_count")
            elif isinstance(a, ir.First):
                aggs.append((f"__a{i}", "first", pc.ScalarAggregateOptions(
                    skip_nulls=a.ignore_nulls)))
                out_names_in_result.append(f"__a{i}_first")
            elif isinstance(a, ir.Last):
                aggs.append((f"__a{i}", "last", pc.ScalarAggregateOptions(
                    skip_nulls=a.ignore_nulls)))
                out_names_in_result.append(f"__a{i}_last")
            else:
                fn = _AGG_MAP[type(a)]
                aggs.append((f"__a{i}", fn))
                out_names_in_result.append(f"__a{i}_{fn}")
        for i in nan_fix:
            aggs.append((f"__a{i}__nan", "sum"))
            out_names_in_result.append(f"__a{i}__nan_sum")

        if key_names:
            res = proj.group_by(key_names, use_threads=False).aggregate(
                aggs)
        else:
            # global aggregation (always exactly one output row)
            cols, names2 = [], []
            for (col_name, fn, *opt), oname in zip(aggs,
                                                   out_names_in_result):
                c = proj.column(col_name).combine_chunks()
                options = opt[0] if opt else None
                if fn == "count":
                    val = pc.count(c, mode=count_modes.get(
                        col_name, "only_valid"))
                elif fn == "first":
                    cc = c.drop_null() if (options and
                                           options.skip_nulls) else c
                    val = cc[0] if len(cc) else pa.scalar(None, c.type)
                elif fn == "last":
                    cc = c.drop_null() if (options and
                                           options.skip_nulls) else c
                    val = cc[-1] if len(cc) else pa.scalar(None, c.type)
                else:
                    val = getattr(pc, fn)(c)
                cols.append(pa.array([val.as_py()],
                                     type=getattr(val, "type", None)))
                names2.append(oname)
            res = pa.Table.from_arrays(cols, names=names2)

        # patch Spark NaN ordering into float min/max results
        for i, is_min in nan_fix.items():
            fn = "min" if is_min else "max"
            base_name = f"__a{i}_{fn}"
            base = res.column(base_name).combine_chunks()
            has_nan = pc.greater(
                pc.coalesce(res.column(f"__a{i}__nan_sum"),
                            pa.scalar(0, pa.int64())),
                pa.scalar(0, pa.int64()))
            if is_min:
                # NaN is greatest: min -> NaN only when every non-null
                # value in the group was NaN (clean min came up null)
                cond = pc.and_(pc.is_null(base), has_nan)
            else:
                cond = has_nan
            fixed = pc.if_else(cond, pa.scalar(float("nan"), base.type),
                               base)
            res = res.set_column(
                res.column_names.index(base_name), base_name, fixed)

        # assemble final output: keys then aggs with target dtypes
        out_arrays = []
        for i in range(len(self.groupings)):
            if not key_names:
                out_arrays.append(None)
                continue
            kcol = res.column(f"__k{i}")
            if i in nested_originals:
                originals, ktype = nested_originals[i]
                ids = kcol.to_pylist()
                kcol = pa.chunked_array([pa.array(
                    [originals[s] for s in ids], type=ktype)])
            out_arrays.append(kcol)
        for i, a in enumerate(self.aggregates):
            col = res.column(out_names_in_result[i])
            tgt = self._schema.fields[len(self.groupings) + i].dtype
            col = col.cast(tgt.to_arrow())
            out_arrays.append(col)
        arrays = [a for a in out_arrays if a is not None]
        return pa.Table.from_arrays(arrays, names=self._schema.names)


class CpuExpandExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan,
                 projections: Sequence[Sequence[ir.Expression]],
                 schema: Schema):
        super().__init__()
        self.children = (child,)
        self.projections = projections
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self):
        def run(it):
            for t in it:
                for proj in self.projections:
                    arrays = [eval_cpu.to_arrow_array(
                        eval_cpu.evaluate(e, t)) for e in proj]
                    yield pa.Table.from_arrays(arrays,
                                               names=self._schema.names)
        return [run(it) for it in self.children[0].execute()]


def _cast_join_keys(t: pa.Table, keys: List[str], dtypes) -> pa.Table:
    for k, d in zip(keys, dtypes):
        i = t.column_names.index(k)
        col = t.column(k)
        if col.type != d.to_arrow():
            t = t.set_column(i, k, col.cast(d.to_arrow()))
    return t


def _normalize_float_join_keys(t: pa.Table, keys: List[str]
                               ) -> Tuple[pa.Table, List[str]]:
    """Replace float key columns with canonicalized bit-pattern columns."""
    out_keys = []
    for k in keys:
        col = t.column(k).combine_chunks()
        if pa.types.is_floating(col.type):
            mask = np.asarray(col.is_null())
            vals = col.fill_null(0.0).to_numpy(zero_copy_only=False)
            vals = np.where(vals == 0.0, 0.0, vals)
            vals = np.where(np.isnan(vals), np.nan, vals)  # canonical NaN
            if col.type == pa.float32():
                bits = vals.astype(np.float32).view(np.int32)
            else:
                bits = vals.astype(np.float64).view(np.int64)
            name = f"{k}__bits"
            t = t.append_column(name, pa.array(bits, mask=mask))
            out_keys.append(name)
        else:
            out_keys.append(k)
    return t, out_keys


class CpuJoinExec(PhysicalPlan):
    """Hash join via pyarrow Table.join (+ cross join by replication)."""

    _HOW_MAP = {
        "inner": "inner",
        "left": "left outer",
        "right": "right outer",
        "full": "full outer",
        "semi": "left semi",
        "anti": "left anti",
    }

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 how: str, condition: Optional[ir.Expression],
                 schema: Schema, key_dtypes: Optional[List] = None):
        super().__init__()
        self.children = (left, right)
        self.left_keys, self.right_keys = list(left_keys), list(right_keys)
        self.how = how
        self.condition = condition
        self._schema = schema
        self.key_dtypes = key_dtypes

    @property
    def schema(self) -> Schema:
        return self._schema

    def _exec_cross(self, lt: pa.Table, rt: pa.Table) -> pa.Table:
        li = np.repeat(np.arange(lt.num_rows), rt.num_rows)
        ri = np.tile(np.arange(rt.num_rows), lt.num_rows)
        left = lt.take(pa.array(li))
        right = rt.take(pa.array(ri))
        arrays = list(left.columns) + list(right.columns)
        return pa.Table.from_arrays(arrays, names=self._schema.names)

    def execute(self):
        def run():
            lt = _gather_single(self.children[0], self.children[0].schema)
            rt = _gather_single(self.children[1], self.children[1].schema)
            if self.how == "cross":
                out = self._exec_cross(lt, rt)
            else:
                # rename to positional names to avoid collisions; duplicate
                # right keys so they survive arrow's key coalescing
                ln = [f"__l{i}" for i in range(lt.num_columns)]
                rn = [f"__r{i}" for i in range(rt.num_columns)]
                lt2 = lt.rename_columns(ln)
                rt2 = rt.rename_columns(rn)
                lk = [f"__l{lt.column_names.index(k)}" for k in self.left_keys]
                rk = [f"__r{rt.column_names.index(k)}" for k in
                      self.right_keys]
                # promote mismatched numeric key pairs to the common type
                # (Spark's implicit cast before key comparison)
                if self.key_dtypes is not None:
                    lt2 = _cast_join_keys(lt2, lk, self.key_dtypes)
                    rt2 = _cast_join_keys(rt2, rk, self.key_dtypes)
                # Spark joins NaN==NaN and -0.0==0.0 (NormalizeFloatingNumbers);
                # arrow's join does not, so float keys join on canonical bits
                lt2, lk = _normalize_float_join_keys(lt2, lk)
                rt2, rk = _normalize_float_join_keys(rt2, rk)
                joined = lt2.join(
                    rt2, keys=lk, right_keys=rk,
                    join_type=self._HOW_MAP[self.how],
                    coalesce_keys=False, use_threads=False)
                if self.how in ("semi", "anti"):
                    out = pa.Table.from_arrays(
                        [joined.column(n) for n in ln],
                        names=self._schema.names)
                else:
                    out = pa.Table.from_arrays(
                        [joined.column(n) for n in ln + rn],
                        names=self._schema.names)
            if self.condition is not None:
                v = eval_cpu.evaluate(self.condition, out)
                out = out.filter(pa.array(v.data.astype(bool) & v.valid))
            yield out
        return [run()]


class CpuShuffledHashJoinExec(CpuJoinExec):
    """Equi-join planned with both sides exchanged on their keys
    (ShuffledHashJoinExec analog; SortMergeJoin is replaced by this,
    reference: shims/spark300/.../GpuSortMergeJoinExec.scala)."""


class CpuBroadcastHashJoinExec(CpuJoinExec):
    """Equi-join with one side small enough to broadcast (reference:
    GpuBroadcastHashJoinExec).  build_side in {"left", "right"}."""

    def __init__(self, *args, build_side: str = "right", **kwargs):
        super().__init__(*args, **kwargs)
        self.build_side = build_side


class CpuBroadcastNestedLoopJoinExec(CpuJoinExec):
    """Cross join (+ condition) with a broadcast side (reference:
    GpuBroadcastNestedLoopJoinExec.scala:311)."""

    def __init__(self, *args, build_side: str = "right", **kwargs):
        super().__init__(*args, **kwargs)
        self.build_side = build_side


class CpuCartesianProductExec(CpuJoinExec):
    """Partition-pairwise cross join (reference:
    GpuCartesianProductExec.scala:304)."""
