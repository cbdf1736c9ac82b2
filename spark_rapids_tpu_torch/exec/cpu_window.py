"""CPU window exec — the oracle/fallback for window functions.

Ported whole from ``spark_rapids_tpu/exec/cpu_window.py`` with its
imports retargeted at the port.  It is the planner's stock window node
and the fallback for what the window rule keeps off the device.

Deliberately a direct row-loop interpretation of SQL window semantics
(partition slices, peer groups, frame bounds), independent of the TPU
path's segmented-scan formulation, so parity tests cross-check two very
different algorithms (same philosophy as eval_cpu vs eval_tpu).
"""

from __future__ import annotations

import bisect as _bisect
import functools
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.exec.cpu import _gather_single
from spark_rapids_tpu_torch.expr import eval_cpu, ir
from spark_rapids_tpu_torch.plan.logical import Schema


def _vals(v: eval_cpu.CpuVal) -> List[Any]:
    out = []
    for i in range(len(v.data)):
        out.append(v.data[i] if v.valid[i] else None)
    return out


def _cmp_scalar(a, b, asc: bool, nulls_first: bool) -> int:
    def rank(x):
        if x is None:
            return (0 if nulls_first else 2, 0)
        if isinstance(x, float) and math.isnan(x):
            return (1, 1)
        return (1, 0)
    ra, rb = rank(a), rank(b)
    if ra[0] != rb[0]:
        return -1 if ra[0] < rb[0] else 1
    if ra[0] == 1:  # both non-null
        if ra[1] != rb[1]:  # NaN greatest within values
            c = -1 if ra[1] < rb[1] else 1
        elif ra[1] == 1:
            c = 0   # NaN == NaN (Double.compare semantics)
        elif a == b:
            c = 0
        else:
            c = -1 if a < b else 1
        return c if asc else -c
    return 0


def _order_cmp(keys_a, keys_b, dirs) -> int:
    for (a, b), (asc, nf) in zip(zip(keys_a, keys_b), dirs):
        c = _cmp_scalar(a, b, asc, nf)
        if c != 0:
            return c
    return 0


def _fast_order_and_parts(pvals, plists, ovals, olists, dirs, n):
    """Vectorized ordering + partition boundaries via Arrow's stable
    multi-key sort — semantics identical to the _order_cmp comparator
    (per-key null flag columns give per-key null placement; Arrow sorts
    NaN greatest among values, the same rank _cmp_scalar assigns).

    The comparator path is O(n log n) PYTHON comparisons — minutes at
    millions of rows — and stays as the fallback for value types Arrow
    cannot sort.  Returns (order ndarray, parts [(start, end)]).
    """
    import pyarrow.compute as pc
    all_vals = list(zip(pvals, plists, [(True, True)] * len(pvals))) + \
        list(zip(ovals, olists, list(dirs or ())))
    if not all_vals:
        return np.arange(n, dtype=np.int64), [(0, n)]
    cols = {}
    keys = []
    for i, (cv, vlist, (asc, nf)) in enumerate(all_vals):
        valid = np.asarray(cv.valid, dtype=bool)
        flag = np.where(valid, 1, 0) if nf else np.where(valid, 0, 1)
        cols[f"f{i}"] = pa.array(flag.astype(np.int8))
        arr = pa.array(vlist)               # None-mapped values
        cols[f"v{i}"] = arr
        d = "ascending" if asc else "descending"
        keys.append((f"f{i}", "ascending"))
        if pa.types.is_floating(arr.type):
            # Spark ranks NaN greatest among values in BOTH directions;
            # Arrow sorts NaN after values regardless of direction, so
            # the NaN rank rides its own direction-following key
            data = np.asarray(cv.data, dtype=np.float64)
            cols[f"g{i}"] = pa.array(
                (valid & np.isnan(data)).astype(np.int8))
            keys.append((f"g{i}", d))
        keys.append((f"v{i}", d))
    table = pa.table(cols)
    order = pc.sort_indices(table, sort_keys=keys).to_numpy(
        zero_copy_only=False).astype(np.int64)

    # partition boundaries: adjacent sorted rows differ in any
    # partition key (flag catches null-vs-value; NaN==NaN for floats)
    flags_diff = np.zeros(n, dtype=bool)
    if n:
        flags_diff[0] = True
    for i in range(len(pvals)):
        fl = np.asarray(cols[f"f{i}"])[order]
        flags_diff[1:] |= fl[1:] != fl[:-1]
        filled = pc.fill_null(
            cols[f"v{i}"],
            _null_fill_for(table.schema.field(f"v{i}").type))
        vv = filled.to_numpy(zero_copy_only=False)[order]
        neq = vv[1:] != vv[:-1]
        if vv.dtype.kind == "f":
            neq &= ~(np.isnan(vv[1:].astype(np.float64)) &
                     np.isnan(vv[:-1].astype(np.float64)))
        flags_diff[1:] |= neq
    starts = np.flatnonzero(flags_diff)
    parts = [(int(s), int(e)) for s, e in
             zip(starts, list(starts[1:]) + [n])]
    return order, parts


def _null_fill_for(t: pa.DataType):
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return ""
    if pa.types.is_boolean(t):
        return False
    if pa.types.is_floating(t):
        return 0.0
    if pa.types.is_null(t):
        raise TypeError("all-null key: comparator fallback")
    return 0


class CpuWindowExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan,
                 window_exprs: Sequence[ir.WindowExpression],
                 out_names: Sequence[str], schema: Schema,
                 partitionwise: bool = False):
        super().__init__()
        self.children = (child,)
        self.window_exprs = list(window_exprs)
        self.out_names = list(out_names)
        self._schema = schema
        # partitionwise: each child partition evaluates independently —
        # the planner hashed-exchanged on the PARTITION BY keys, so
        # every window group is colocated in one partition
        self.partitionwise = partitionwise

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self):
        if self.partitionwise:
            from spark_rapids_tpu_torch.exec.cpu import concat_tables
            return [self._run_one(
                lambda it=it: concat_tables(list(it),
                                            self.children[0].schema))
                for it in self.children[0].execute()]
        return [self._run_one(
            lambda: _gather_single(self.children[0],
                                   self.children[0].schema))]

    def _run_one(self, get_table):
        def run():
            t = get_table()
            n = t.num_rows
            result_cols = {name: None for name in self.out_names}
            final_order = list(range(n))

            # group exprs sharing (partition, order) into one pass
            groups = {}
            for name, we in zip(self.out_names, self.window_exprs):
                sig = (tuple(e.sql() for e in we.partition_exprs),
                       tuple(e.sql() for e in we.order_exprs),
                       we.order_dirs)
                groups.setdefault(sig, []).append((name, we))

            for (_, _, dirs), items in groups.items():
                we0 = items[0][1]
                pcv = [eval_cpu.evaluate(e, t)
                       for e in we0.partition_exprs]
                ocv = [eval_cpu.evaluate(e, t) for e in we0.order_exprs]
                pvals = [_vals(v) for v in pcv]
                ovals = [_vals(v) for v in ocv]

                def key_of(i):
                    return tuple(p[i] for p in pvals), \
                        tuple(o[i] for o in ovals)

                try:
                    order, parts = _fast_order_and_parts(
                        pcv, pvals, ocv, ovals, dirs, n)
                    order = list(order)
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError,
                        TypeError):
                    def cmp(i, j):
                        pa_, oa = key_of(i)
                        pb, ob = key_of(j)
                        c = _order_cmp(pa_, pb,
                                       [(True, True)] * len(pa_))
                        if c != 0:
                            return c
                        return _order_cmp(oa, ob, dirs or ())

                    order = sorted(range(n),
                                   key=functools.cmp_to_key(cmp))
                    parts = []
                    ps = 0
                    for i in range(1, n + 1):
                        if i == n or _order_cmp(
                                key_of(order[i])[0],
                                key_of(order[ps])[0],
                                [(True, True)] * len(pvals)) != 0:
                            parts.append((ps, i))
                            ps = i
                final_order = order

                for name, we in items:
                    out_sorted = self._compute(we, t, order, parts, dirs)
                    col = [None] * n
                    for si, orig in enumerate(order):
                        col[orig] = out_sorted[si]
                    result_cols[name] = col

            # emit in last pass's sorted order (Spark emits sorted)
            arrays = [t.column(i).take(pa.array(final_order))
                      for i in range(t.num_columns)]
            for name, we in zip(self.out_names, self.window_exprs):
                vals = [result_cols[name][orig] for orig in final_order]
                arrays.append(pa.array(vals, type=we.dtype.to_arrow()))
            yield pa.Table.from_arrays(
                arrays, names=list(t.column_names) + self.out_names)
        return run()

    # ------------------------------------------------------------------
    def _compute(self, we: ir.WindowExpression, t, order, parts, dirs):
        n = len(order)
        fn = we.function
        frame = we.frame
        self._range_dirs = we.order_dirs
        ovals = [_vals(eval_cpu.evaluate(e, t)) for e in we.order_exprs]

        # peer groups once per spec (the per-row while-loop scan was
        # O(n * peer_size)): one adjacent comparison per sorted row
        qs_arr = np.zeros(n, dtype=np.int64)
        qe_arr = np.zeros(n, dtype=np.int64)
        for ps, pe in parts:
            gs = ps
            for i in range(ps + 1, pe + 1):
                if i == pe or _order_cmp(
                        tuple(o[order[i]] for o in ovals),
                        tuple(o[order[i - 1]] for o in ovals),
                        dirs or ()) != 0:
                    qs_arr[gs:i] = gs
                    qe_arr[gs:i] = i
                    gs = i

        def peers(ps, pe, i):
            """peer range [qs, qe) of sorted index i within [ps, pe)."""
            return int(qs_arr[i]), int(qe_arr[i])

        out = [None] * n
        if isinstance(fn, (ir.RowNumber, ir.Rank, ir.DenseRank)):
            for ps, pe in parts:
                dense = 0
                for i in range(ps, pe):
                    qs, qe = peers(ps, pe, i)
                    if i == qs:
                        dense += 1
                    if isinstance(fn, ir.RowNumber):
                        out[i] = i - ps + 1
                    elif isinstance(fn, ir.Rank):
                        out[i] = qs - ps + 1
                    else:
                        out[i] = dense
            return out

        if isinstance(fn, (ir.Lead, ir.Lag)):
            src = _vals(eval_cpu.evaluate(fn.children[0], t))
            off = fn.offset if isinstance(fn, ir.Lead) else -fn.offset
            for ps, pe in parts:
                for i in range(ps, pe):
                    j = i + off
                    if ps <= j < pe:
                        out[i] = src[order[j]]
                    else:
                        out[i] = fn.default
            return out

        if isinstance(fn, ir.AggregateExpression):
            a_arr = np.empty(n, dtype=np.int64)
            b_arr = np.empty(n, dtype=np.int64)
            for ps, pe in parts:
                # partition-level range-scan stats are row-independent:
                # hoist them out of the per-row loop (O(n) not O(n^2))
                stats = self._range_stats(frame, ps, pe, ovals, order)
                for i in range(ps, pe):
                    a_arr[i], b_arr[i] = self._bounds(
                        frame, ps, pe, i, peers, ovals, order, stats)
            cv = eval_cpu.evaluate(fn.child, t) \
                if fn.child is not None else None
            res = _agg_windows(fn, cv, order, a_arr, b_arr)
            if res is not None:
                return res
            # fallback (non-numeric sources): per-row materialization
            src = _vals(eval_cpu.evaluate(fn.child, t)) \
                if fn.child is not None else [1] * t.num_rows
            for i in range(n):
                a, b = int(a_arr[i]), int(b_arr[i])
                window = [src[order[j]] for j in range(a, b + 1)] \
                    if b >= a else []
                out[i] = _agg_py(fn, window)
            return out

        raise NotImplementedError(type(fn).__name__)

    def _range_stats(self, frame, ps, pe, ovals, order):
        """Row-independent per-partition stats for finite numeric RANGE
        frames: normalized order values plus null/NaN run boundaries.

        Spark's frame scans (Sliding/Unbounded*WindowFunctionFrame): the
        comparator treats a null order key as -inf when nulls sort first
        and +inf when they sort last, and NaN as above every finite
        value; value-bounded sides exclude the null runs (or degenerate
        TO the run that ranks past the bound), while an unbounded side
        reaches the partition bound.
        """
        if frame.kind != "range" or not ovals or \
                (frame.start is None and frame.end in (None, 0)):
            return None
        ascending = True
        if getattr(self, "_range_dirs", None):
            ascending = self._range_dirs[0][0]
        # normalize to ascending w-space exactly like the TPU path
        # (tpu_window's `w = -w` for DESC) so the monotonic scans are
        # direction-agnostic
        raw = [ovals[0][order[j]] for j in range(ps, pe)]
        wvals = [None if x is None
                 else (x if isinstance(x, float) and math.isnan(x)
                       else (x if ascending else -x))
                 for x in raw]
        nulls_first = bool(wvals) and wvals[0] is None
        nleading = 0
        while nleading < len(wvals) and wvals[nleading] is None:
            nleading += 1
        ntrailing = 0
        while ntrailing < len(wvals) - nleading and \
                wvals[-1 - ntrailing] is None:
            ntrailing += 1
        if not nulls_first:
            nleading = 0
        else:
            ntrailing = 0
        vlo, vhi = ps + nleading, pe - 1 - ntrailing
        # NaN rows rank above every finite value, so after normalization
        # the NaN run sits at the high end of the value run under ASC and
        # at the low (physical-start) end under DESC
        nnan = sum(1 for j in range(vlo, vhi + 1)
                   if isinstance(wvals[j - ps], float)
                   and math.isnan(wvals[j - ps]))
        if ascending:
            flo, fhi = vlo, vhi - nnan
        else:
            flo, fhi = vlo + nnan, vhi
        return (ascending, wvals, nleading, ntrailing, nnan, flo, fhi)

    def _bounds(self, frame, ps, pe, i, peers, ovals, order, stats=None):
        if frame.kind == "rows":
            a = ps if frame.start is None else max(ps, i + frame.start)
            b = pe - 1 if frame.end is None else min(pe - 1, i + frame.end)
            return a, b
        # range
        if frame.start is None and frame.end == 0:
            qs, qe = peers(ps, pe, i)
            return ps, qe - 1
        if frame.start is None and frame.end is None:
            return ps, pe - 1
        # numeric range offsets over a single order column
        v = ovals[0][order[i]]
        if v is None or (isinstance(v, float) and math.isnan(v)):
            # null/NaN current row: its peers on value-bounded sides, the
            # partition bound on unbounded sides (Spark's bound
            # comparators: null+offset is null and NaN+offset is NaN,
            # which compare equal to the row's own key and outside every
            # finite value run)
            qs, qe = peers(ps, pe, i)
            a = ps if frame.start is None else qs
            b = pe - 1 if frame.end is None else qe - 1
            return a, b
        if stats is None:
            stats = self._range_stats(frame, ps, pe, ovals, order)
        ascending, wvals, nleading, ntrailing, nnan, flo, fhi = stats
        w = v if ascending else -v
        lo = w + frame.start if frame.start is not None else None
        hi = w + frame.end if frame.end is not None else None

        # the finite run [flo, fhi] is ascending in w-space, so the
        # first >= lo / last <= hi rows bisect in O(log) instead of the
        # former O(partition) linear scan per row
        if frame.start is None:
            a = ps
        else:
            if ascending and nnan:
                a = fhi + 1        # NaN run satisfies >= any finite bound
            else:
                a = pe - ntrailing  # trailing null run (pe when none)
            if flo <= fhi:
                j = ps + _bisect.bisect_left(wvals, lo, flo - ps,
                                             fhi - ps + 1)
                if j <= fhi:
                    a = j
        if frame.end is None:
            b = pe - 1
        else:
            if not ascending and nnan:
                b = flo - 1        # NaN run (in w-space) precedes finites
            else:
                b = ps + nleading - 1  # leading null run (ps-1 when none)
            if flo <= fhi:
                j = ps + _bisect.bisect_right(wvals, hi, flo - ps,
                                              fhi - ps + 1) - 1
                if j >= flo:
                    b = j
        return a, b


def _agg_windows(fn: ir.AggregateExpression, cv, order,
                 a_arr: np.ndarray, b_arr: np.ndarray):
    """Vectorized per-row window aggregation over [a, b] bounds —
    identical results to _agg_py (wrapping i64 sums, Spark NaN/null
    ranking) computed with prefix sums and ufunc.reduceat instead of
    materializing every window (the old path was O(rows x frame) in
    Python).  Returns None for source types it does not cover (the
    caller falls back to _agg_py)."""
    n = a_arr.shape[0]
    empty = b_arr < a_arr
    if cv is None:                       # COUNT(*)
        if not isinstance(fn, ir.Count):
            return None
        ln = np.where(empty, 0, b_arr - a_arr + 1)
        return [int(v) for v in ln]
    data0 = np.asarray(cv.data)
    if data0.dtype.kind not in "iufb":
        return None
    order_np = np.asarray(order, dtype=np.int64)
    data = data0[order_np]
    valid = np.asarray(cv.valid, dtype=bool)[order_np]
    is_f = data.dtype.kind == "f"
    nanm = (np.isnan(data) & valid) if is_f else np.zeros(n, bool)
    finite = valid & ~nanm

    aa = np.where(empty, 0, a_arr)
    bb1 = np.where(empty, 1, b_arr + 1)

    def pdiff(x32):
        p = np.concatenate([[0], np.cumsum(x32.astype(np.int64))])
        return np.where(empty, 0, p[bb1] - p[aa])

    def win_reduce(x, ufunc, fill):
        xpad = np.concatenate([x, np.asarray([fill], dtype=x.dtype)])
        idx = np.empty(2 * n, dtype=np.int64)
        idx[0::2] = aa
        idx[1::2] = bb1
        if n == 0:
            return np.asarray([], dtype=x.dtype)
        r = ufunc.reduceat(xpad, idx)[0::2]
        return np.where(empty, fill, r)

    cnt_valid = pdiff(valid)
    if isinstance(fn, ir.Count):
        return [int(v) for v in cnt_valid]
    if isinstance(fn, ir.Sum):
        if is_f:
            x = np.where(valid, data.astype(np.float64), 0.0)
            s = win_reduce(x, np.add, 0.0)
            return [float(v) if c else None
                    for v, c in zip(s, cnt_valid)]
        with np.errstate(over="ignore"):
            x = np.where(valid, data.astype(np.int64), 0)
            p = np.concatenate([[0], np.cumsum(x)])
            s = np.where(empty, 0, p[bb1] - p[aa])
        return [np.int64(v) if c else None
                for v, c in zip(s, cnt_valid)]
    if isinstance(fn, ir.Average):
        x = np.where(valid, data.astype(np.float64), 0.0)
        s = win_reduce(x, np.add, 0.0)
        return [(float(v) / int(c)) if c else None
                for v, c in zip(s, cnt_valid)]
    if isinstance(fn, (ir.Min, ir.Max)):
        is_min = isinstance(fn, ir.Min)
        cnt_fin = pdiff(finite)
        cnt_nan = pdiff(nanm)
        if is_f:
            fill = np.inf if is_min else -np.inf
            x = np.where(finite, data.astype(np.float64), fill)
            m = win_reduce(x, np.minimum if is_min else np.maximum,
                           fill)
            out = []
            for v, cf, cn in zip(m, cnt_fin, cnt_nan):
                if (cn and not is_min) or (cn and is_min and not cf):
                    out.append(float("nan"))
                elif cf:
                    out.append(float(v))
                else:
                    out.append(None)
            return out
        info = np.iinfo(np.int64)
        fill = info.max if is_min else info.min
        x = np.where(finite, data.astype(np.int64), fill)
        m = win_reduce(x, np.minimum if is_min else np.maximum, fill)
        if data.dtype.kind == "b":
            return [bool(v) if c else None
                    for v, c in zip(m, cnt_fin)]
        return [data0.dtype.type(v) if c else None
                for v, c in zip(m, cnt_fin)]
    return None


def _agg_py(fn: ir.AggregateExpression, window: List[Any]):
    non_null = [v for v in window if v is not None and
                not (isinstance(v, float) and math.isnan(v))]
    nans = [v for v in window if isinstance(v, float) and math.isnan(v)]
    if isinstance(fn, ir.Count):
        if fn.child is None:
            return len(window)
        return len(non_null) + len(nans)
    if isinstance(fn, ir.Sum):
        vals = non_null + nans
        if not vals:
            return None
        if all(isinstance(v, (int, np.integer)) for v in vals):
            # numpy-scalar sum() wraps with a RuntimeWarning and its
            # behavior shifted across numpy versions; Spark's long SUM
            # wraps silently (Java long add, non-ANSI).  Sum exactly in
            # Python ints, then wrap to int64 explicitly so the oracle
            # has pinned overflow semantics.
            s = sum(int(v) for v in vals)
            return np.int64(((s + (1 << 63)) & ((1 << 64) - 1))
                            - (1 << 63))
        return sum(vals)
    if isinstance(fn, ir.Average):
        # Spark averages in double space (no integral overflow)
        vals = [float(v) for v in non_null] + nans
        return (sum(vals) / len(vals)) if vals else None
    if isinstance(fn, ir.Min):
        if nans and not non_null:
            return float("nan")
        return min(non_null) if non_null else None
    if isinstance(fn, ir.Max):
        if nans:
            return float("nan")
        return max(non_null) if non_null else None
    raise NotImplementedError(type(fn).__name__)
