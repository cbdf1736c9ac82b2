"""Device window exec.

Ported from ``spark_rapids_tpu/exec/tpu_window.py`` (the reference's
analog of ``GpuWindowExec``/``GpuWindowExpression``: count, sum, avg,
min, max, row_number, rank, dense_rank, lead and lag over ROWS and RANGE
frames).

One stable sort by (partition keys, order keys) turns every window
primitive into arithmetic over sorted rows: partition and peer
boundaries from key changes, ranking functions from positions, frame
sums and counts from prefix sums (float sums from a table of pairwise
partial sums, added block by block and never subtracted), running
min/max from segmented scans, and bounded min/max frames from a
log-stride sparse table (two overlapping power-of-two blocks cover any
range).  The reference composes these from XLA ops, with no Pallas
kernel; here they are eager torch operations.  Partitions are contiguous
runs in sorted space, so segment starts and ends are binary searches of
the running segment number, and per-partition counts are prefix-count
differences: no reducing scatter, whose atomics would serialize on the
one huge segment the padding rows form.

As in the reference (:557-571), the exec dispatches through the process
kernel cache: one ``win_keys`` step per (partition, order) spec encodes
its order values, partition fields and sort digits, the shared
``shared_digit_sort`` orders the digits, and one ``window_apply`` step
evaluates every window expression from those keys and orders, so no key
is evaluated or encoded twice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, concat_batches
from spark_rapids_tpu_torch.exec import scans, sortkeys
from spark_rapids_tpu_torch.exec.base import (PhysicalPlan,
                                              REQUIRE_SINGLE_BATCH, TpuExec,
                                              timed)
from spark_rapids_tpu_torch.exec.tpu_aggregate import normalize_key
from spark_rapids_tpu_torch.expr import eval_tpu, ir
from spark_rapids_tpu_torch.expr.eval_tpu import ColVal
from spark_rapids_tpu_torch.plan.logical import Schema


def _win_fields(v, asc, nf):
    # null field dropped only on the propagated no-null hint (schema
    # nullability alone is metadata and can be stale)
    return sortkeys.encode_fields(v, asc, nf, nullable=not v.nonnull)


def segment_bounds(new: torch.Tensor):
    """(start, end) position of each row's segment, where ``new`` marks
    the first row of each contiguous segment (``new[0]`` is True).  The
    running segment number is sorted, so a binary search of each row's
    number finds its segment's first and last row: the reference's
    segment_min/segment_max of the positions, with no scatter (the
    padding's one huge segment would serialize its atomics) and no
    torch.cummax, whose indexed scans were the costliest device
    operations of the first q47 run on the H100 (PERF.md)."""
    seg = torch.cumsum(new, 0, dtype=torch.int32)
    return (torch.searchsorted(seg, seg),
            torch.searchsorted(seg, seg, right=True) - 1)


def _spec_fields(batch: DeviceBatch, part_exprs, order_exprs, order_dirs):
    """(order values, partition key fields, full sort digits) of one
    (partition, order) spec over ``batch``: the exec's ``win_keys``
    step."""
    pvals = [normalize_key(eval_tpu.evaluate(e, batch)) for e in part_exprs]
    ovals = [normalize_key(eval_tpu.evaluate(e, batch))
             for e in order_exprs]
    pfields = [_win_fields(v, True, True) for v in pvals]
    ofields = [_win_fields(v, asc, nf)
               for v, (asc, nf) in zip(ovals, order_dirs)]
    digits = sortkeys.stack_sort_digits(pfields + ofields, batch.row_mask())
    return ovals, pfields, digits


class _WinCtx:
    """Sorted-space context for one (partition, order) spec."""

    def __init__(self, batch: DeviceBatch, order_dirs, keys,
                 order: torch.Tensor):
        """``keys`` is the spec's ``_spec_fields`` triple and ``order``
        the stable sort of its digits (ties keep their input order, as
        in the reference): the exec's ``win_keys`` and shared sort
        steps."""
        cap = batch.capacity
        self.cap = cap
        row_mask = batch.row_mask()
        ovals, pfields, full_digits = keys
        self.order = order
        if pfields:
            pdigits = sortkeys.fields_to_digits(
                [f for g in pfields for f in g])
            new_part = sortkeys.digit_boundaries(pdigits, self.order,
                                                 row_mask)
        else:
            new_part = sortkeys._starts(row_mask[self.order])
        new_peer = sortkeys.digit_boundaries(full_digits, self.order,
                                             row_mask)
        self.new_part = new_part
        self.new_peer = new_peer
        self.pos = torch.arange(cap, device=batch.device)
        self.part_start, self.part_end = segment_bounds(new_part)
        self.peer_start, self.peer_end = segment_bounds(new_peer)
        self.sorted_exists = row_mask[self.order]
        # finite RANGE frames need the (single) order value in sorted
        # space plus its direction/null placement
        self.order_dirs = tuple(order_dirs)
        self.order_vals = ovals

    def sorted_val(self, v: ColVal) -> ColVal:
        c = v.to_column().gather(self.order, self.sorted_exists)
        return ColVal(c.dtype, c.data, c.validity, c.lengths,
                      vbits=c.vbits)

    def part_flags(self, reverse: bool = False) -> torch.Tensor:
        """Segment-start flags of the partitions, or of the reversed
        sequence (the partitions' last rows, flipped)."""
        if not reverse:
            return self.new_part
        is_end = torch.cat([self.new_part[1:],
                            torch.ones(1, dtype=torch.bool,
                                       device=self.new_part.device)])
        return is_end.flip(0)

    def pcount(self, mask: torch.Tensor) -> torch.Tensor:
        """Rows of ``mask`` in each row's partition: a prefix-count
        difference (partitions are contiguous in sorted space)."""
        P = _prefix(mask.to(torch.int64))
        return P[self.part_end + 1] - P[self.part_start]


def _seg_searchsorted(vals: torch.Tensor, lo0: torch.Tensor,
                      hi0: torch.Tensor, target: torch.Tensor,
                      left: bool) -> torch.Tensor:
    """Vectorized per-row binary search of ``target`` within the sorted
    slice [lo0, hi0] of ``vals`` (inclusive positions).  Returns the
    insertion point (bisect_left/bisect_right semantics), after the
    reference's ceil(log2(cap + 1)) + 1 steps."""
    cap = vals.shape[0]
    lo = lo0.to(torch.int64)
    hi = hi0.to(torch.int64) + 1
    for _ in range(int(np.ceil(np.log2(cap + 1))) + 1):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = vals[torch.clamp(mid, 0, cap - 1)]
        go_right = (v < target) if left else (v <= target)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


_I64_MAX = int(np.iinfo(np.int64).max)
_I64_MIN = int(np.iinfo(np.int64).min)


def _sat_add(w: torch.Tensor, off) -> torch.Tensor:
    """w + off with int64 saturation (full-range order values must not
    wrap; torch's integer add wraps silently)."""
    if w.dtype == torch.float64:
        return w + off
    off = int(np.int64(off))
    t = w + off
    if off > 0:
        return torch.where(t < w, _I64_MAX, t)
    if off < 0:
        return torch.where(t > w, _I64_MIN, t)
    return t


def _range_frame_bounds(ctx: _WinCtx, frame: ir.WindowFrame):
    """Finite RANGE offsets: row i's frame = partition rows whose order
    value lies within [v_i + start, v_i + end] along the sort direction,
    via a segmented binary search over the sorted order values.

    Nulls (and NaN for float keys) sort into contiguous runs at one end
    of the partition; the search is restricted to the plain-value run,
    and a null/NaN current row frames over its peer group on finite
    sides and the partition bound on unbounded sides (Spark semantics).
    """
    v = ctx.sorted_val(ctx.order_vals[0])
    asc, nulls_first = ctx.order_dirs[0]
    use_float = v.dtype.is_floating
    w = v.data.to(torch.float64 if use_float else torch.int64)
    if not asc:
        w = -w   # descending sort == ascending on the negation
    exists = ctx.sorted_exists
    is_null = ~v.validity & exists
    if use_float:
        is_nan = torch.isnan(w) & ~is_null & exists
        w = torch.where(is_nan, 0.0, w)   # value unused once excluded
    else:
        is_nan = torch.zeros_like(is_null)
    special = is_null | is_nan

    # the plain-value run of each partition: nulls at the nulls_first/
    # last end; NaN at the largest-value end, which after the DESC
    # negation is the sequence start
    nulls = ctx.pcount(is_null)
    nans = ctx.pcount(is_nan)
    lo = ctx.part_start + (nulls if nulls_first else 0) + \
        (0 if asc else nans)
    hi = ctx.part_end - (0 if nulls_first else nulls) - \
        (nans if asc else 0)

    start, end = frame.start, frame.end
    a = ctx.part_start if start is None else torch.maximum(
        _seg_searchsorted(w, lo, hi, _sat_add(w, start), left=True), lo)
    b = ctx.part_end if end is None else torch.minimum(
        _seg_searchsorted(w, lo, hi, _sat_add(w, end), left=False) - 1,
        hi)
    # null/NaN current rows: peer group on finite sides
    if start is not None:
        a = torch.where(special, ctx.peer_start, a)
    if end is not None:
        b = torch.where(special, ctx.peer_end, b)
    return a, b


def _frame_bounds(ctx: _WinCtx, frame: ir.WindowFrame):
    """Inclusive sorted-position bounds [a, b] per row."""
    if frame.kind == "rows":
        # offsets are Python ints (Spark longs); one beyond +-cap clamps
        # to the same partition bound as the unclamped value would
        def sat(off):
            return max(min(int(off), ctx.cap), -ctx.cap)
        a = ctx.part_start if frame.start is None else \
            torch.maximum(ctx.part_start, ctx.pos + sat(frame.start))
        b = ctx.part_end if frame.end is None else \
            torch.minimum(ctx.part_end, ctx.pos + sat(frame.end))
        return a, b
    if frame.start is None and frame.end == 0:
        return ctx.part_start, ctx.peer_end
    if frame.start is None and frame.end is None:
        return ctx.part_start, ctx.part_end
    return _range_frame_bounds(ctx, frame)


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums, [0, x0, x0+x1, ...] (cap + 1 entries), in
    the reference's summation order (exec/scans.cumsum)."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      scans.cumsum(x)])


def _log_table(op, x: torch.Tensor, pad, levels: int) -> list:
    """Log-stride table: level ``lvl`` holds op over x[i : i+2^lvl],
    padded past the end with ``pad`` (the op's identity)."""
    cap = x.shape[0]
    tables = [x]
    for lvl in range(1, levels):
        half = 1 << (lvl - 1)
        prev = tables[-1]
        tail = torch.full((min(half, cap),), pad, dtype=prev.dtype,
                          device=prev.device)
        shifted = torch.cat([prev[half:], tail])[:cap]
        tables.append(op(prev, shifted))
    return tables


def _range_sum(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """Subtraction-free per-row range sum over inclusive [a, b].

    A prefix-sum difference cancels catastrophically when huge values
    surround a small frame, so float frames decompose each range into
    O(log cap) power-of-two blocks from a sparse table of pairwise
    partial sums: every block is added, never subtracted.  The adds are
    the reference's, in its order, so the sums equal its bit for bit.
    """
    cap = x.shape[0]
    levels = max(int(np.ceil(np.log2(cap))), 0) + 1 if cap > 1 else 1
    tables = _log_table(torch.add, x, 0, levels)
    end = b.to(torch.int64) + 1
    p = a.to(torch.int64)
    acc = torch.zeros(a.shape, dtype=x.dtype, device=x.device)
    for lvl in range(levels - 1, -1, -1):
        size = 1 << lvl
        take = p + size <= end
        val = tables[lvl][torch.clamp(p, 0, cap - 1)]
        acc = acc + torch.where(take, val, 0)
        p = torch.where(take, p + size, p)
    return acc


def floor_log2(n: torch.Tensor) -> torch.Tensor:
    """floor(log2(n)) of integers 1 <= n < 2^32, exact: a binary search
    over the bit positions (the reference's ``31 - lax.clz(n)``)."""
    k = torch.zeros_like(n)
    for s in (16, 8, 4, 2, 1):
        big = n >= (1 << s)
        k = k + torch.where(big, s, 0)
        n = torch.where(big, n >> s, n)
    return k


def _range_minmax(op, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  fill, max_len: Optional[int] = None) -> torch.Tensor:
    """Per-row range min/max over inclusive sorted positions [a, b].

    Log-stride sparse table: level ``lvl`` holds op over x[i : i+2^lvl].
    Min/max is idempotent, so any range [a, b] is covered exactly by the
    two (overlapping) blocks [a, a+2^k-1] and [b-2^k+1, b] with
    k = floor(log2(len)).  ``max_len`` caps the table depth when the
    frame spec bounds the range length (ROWS k PRECEDING .. m
    FOLLOWING).  Frame bounds are clamped to partition bounds, and both
    query blocks lie inside [a, b], so the table may span partitions.
    """
    cap = x.shape[0]
    limit = cap if max_len is None else max(min(max_len, cap), 1)
    levels = int(np.floor(np.log2(limit))) + 1 if limit > 1 else 1
    flat = torch.stack(_log_table(op, x, fill, levels)).reshape(-1)
    ln = torch.clamp(b - a + 1, min=1)
    k = torch.clamp(floor_log2(ln), max=levels - 1)
    size = torch.ones_like(k) << k
    base = k * cap
    lo = base + torch.clamp(a, 0, cap - 1)
    hi = base + torch.clamp(b + 1 - size, 0, cap - 1)
    return op(flat[lo], flat[hi])


def _window_agg(fn: ir.AggregateExpression, ctx: _WinCtx,
                frame: ir.WindowFrame, batch: DeviceBatch) -> ColVal:
    dev = batch.device
    if fn.child is not None:
        v = ctx.sorted_val(eval_tpu.evaluate(fn.child, batch))
        valid = v.validity & ctx.sorted_exists
        data = v.data
    else:
        valid = ctx.sorted_exists
        data = torch.ones((ctx.cap,), dtype=torch.int64, device=dev)
    a, b = _frame_bounds(ctx, frame)
    a = torch.clamp(a, 0, ctx.cap - 1)
    b = torch.clamp(b, -1, ctx.cap - 1)
    nonempty = b >= a

    def frame_count(mask):
        P = _prefix(mask.to(torch.int32))
        return P[b + 1] - P[a]

    if isinstance(fn, ir.Count):
        out = torch.where(nonempty, frame_count(valid).to(torch.int64), 0)
        return ColVal(dt.INT64, out, torch.ones_like(valid))

    if isinstance(fn, (ir.Sum, ir.Average)):
        is_float = fn.dtype.is_floating or isinstance(fn, ir.Average)
        tgt = torch.float64 if is_float else torch.int64
        x = torch.where(valid, data.to(tgt), 0)
        if is_float and data.is_floating_point():
            # a NaN would poison every block it lies in: sum the non-NaN
            # part and put NaN back per frame
            isnan = torch.isnan(data) & valid
            x = torch.where(isnan, 0.0, x)
            frame_has_nan = frame_count(isnan) > 0
        else:
            frame_has_nan = torch.zeros_like(valid)
        if is_float:
            s = _range_sum(x, a, b)
        else:
            P = _prefix(x)
            s = P[b + 1] - P[a]
        c = torch.clamp(frame_count(valid).to(torch.int64), min=0)
        c = torch.where(nonempty, c, 0)
        if is_float:
            s = torch.where(frame_has_nan, float("nan"), s)
        if isinstance(fn, ir.Average):
            nz = c > 0
            return ColVal(dt.FLOAT64,
                          torch.where(nz, s / torch.where(nz, c, 1), 0.0),
                          nz)
        return ColVal(fn.dtype, s.to(fn.dtype.to_torch()), c > 0)

    if isinstance(fn, (ir.Min, ir.Max)):
        # prefix frames (a == part_start): running segmented scan read at
        # b; bounded-start frames: the sparse table, or a suffix scan
        # when the frame runs to the partition's end
        is_min = isinstance(fn, ir.Min)
        d = fn.dtype
        tgt = d.to_torch()
        bounded = frame.start is not None
        max_len = None
        if bounded and frame.kind == "rows" and frame.end is not None:
            max_len = int(frame.end) - int(frame.start) + 1

        def agg_at_b(op, x, fill):
            if not bounded:
                return scans.seg_scan(op, ctx.part_flags(), x, fill)[b]
            if frame.end is None:
                suf = scans.seg_scan(op, ctx.part_flags(reverse=True),
                                     x.flip(0), fill)
                return suf.flip(0)[a]
            return _range_minmax(op, x, a, b, fill, max_len)

        def any_at_b(mask):
            if bounded:
                return frame_count(mask) > 0
            return scans.seg_scan(torch.logical_or, ctx.part_flags(), mask,
                                  False)[b]

        if d.is_floating:
            isnan = torch.isnan(data)
            fill = float("inf") if is_min else float("-inf")
            x = torch.where(valid & ~isnan, data.to(tgt), fill)
            run_b = agg_at_b(torch.minimum if is_min else torch.maximum, x,
                             fill)
            nonnan_b = any_at_b(valid & ~isnan)
            nan_b = any_at_b(valid & isnan)
            if is_min:
                val = torch.where(nonnan_b, run_b, float("nan"))
            else:
                val = torch.where(nan_b, float("nan"), run_b)
            has = nonnan_b | nan_b
            return ColVal(d, torch.where(has, val, 0.0), has & nonempty)
        if d.is_bool:
            # identity of AND (min) is True, of OR (max) is False
            x = torch.where(valid, data, is_min)
            run_b = agg_at_b(torch.logical_and if is_min else
                             torch.logical_or, x, is_min)
            return ColVal(d, run_b, any_at_b(valid) & nonempty)
        info = np.iinfo(d.to_np())
        fill = int(info.max if is_min else info.min)
        x = torch.where(valid, data.to(tgt), fill)
        out = agg_at_b(torch.minimum if is_min else torch.maximum, x, fill)
        has = any_at_b(valid) & nonempty
        return ColVal(d, torch.where(has, out, 0), has)

    raise NotImplementedError(type(fn).__name__)


def _window_value(we: ir.WindowExpression, ctx: _WinCtx,
                  batch: DeviceBatch) -> ColVal:
    fn = we.function
    if isinstance(fn, ir.RowNumber):
        out = (ctx.pos - ctx.part_start + 1).to(torch.int32)
        return ColVal(dt.INT32, out, ctx.sorted_exists)
    if isinstance(fn, ir.Rank):
        out = (ctx.peer_start - ctx.part_start + 1).to(torch.int32)
        return ColVal(dt.INT32, out, ctx.sorted_exists)
    if isinstance(fn, ir.DenseRank):
        c = torch.cumsum(ctx.new_peer.to(torch.int32), 0, dtype=torch.int32)
        out = c - c[torch.clamp(ctx.part_start, 0, ctx.cap - 1)] + 1
        return ColVal(dt.INT32, out.to(torch.int32), ctx.sorted_exists)
    if isinstance(fn, (ir.Lead, ir.Lag)):
        src = ctx.sorted_val(eval_tpu.evaluate(fn.children[0], batch))
        off = fn.offset if isinstance(fn, ir.Lead) else -fn.offset
        tgt = ctx.pos + off
        in_part = (tgt >= ctx.part_start) & (tgt <= ctx.part_end)
        j = torch.clamp(tgt, 0, ctx.cap - 1)
        col = src.to_column().gather(j, in_part & ctx.sorted_exists)
        if fn.default is not None:
            dflt = eval_tpu._const(batch, fn.default, src.dtype)
            use_d = ~in_part & ctx.sorted_exists
            data, lengths, valid = eval_tpu._merge_branch(
                src.dtype, col.data, col.lengths, col.validity, use_d, dflt)
            return ColVal(src.dtype, data, valid, lengths)
        return ColVal(src.dtype, col.data, col.validity, col.lengths)
    if isinstance(fn, ir.AggregateExpression):
        return _window_agg(fn, ctx, we.frame, batch)
    raise NotImplementedError(type(fn).__name__)


def window_batch(batch: DeviceBatch, out_names: Sequence[str],
                 window_exprs: Sequence[ir.WindowExpression],
                 keys: Sequence[tuple], orders: Sequence[torch.Tensor]
                 ) -> DeviceBatch:
    """``batch`` with one column per window expression, emitted in the
    last spec's sorted order (Spark emits sorted).  ``keys`` and
    ``orders`` are each spec's ``_spec_fields`` triple and sort order,
    in spec-group order."""
    new_cols = {}
    ctx = None
    groups = TpuWindowExec._spec_groups(out_names, window_exprs)
    for gi, items in enumerate(groups):
        ctx = _WinCtx(batch, items[0][1].order_dirs, keys[gi], orders[gi])
        # back to the input's row order: the inverse permutation, a
        # scatter with unique indices
        inv = torch.empty_like(ctx.order)
        inv[ctx.order] = ctx.pos
        for name, we in items:
            v = _window_value(we, ctx, batch)
            new_cols[name] = v.to_column().gather(inv, batch.row_mask())
    cols = [c.gather(ctx.order, ctx.sorted_exists) for c in batch.columns]
    for name in out_names:
        cols.append(new_cols[name].gather(ctx.order, ctx.sorted_exists))
    return DeviceBatch(list(batch.names) + list(out_names), cols,
                       batch.num_rows)


class TpuWindowExec(TpuExec):
    def __init__(self, child: PhysicalPlan,
                 window_exprs: Sequence[ir.WindowExpression],
                 out_names: Sequence[str], schema: Schema,
                 partitionwise: bool = False):
        super().__init__()
        self.children = (child,)
        self.window_exprs = list(window_exprs)
        self.out_names = list(out_names)
        self._schema = schema
        # partitionwise: a hash exchange on the PARTITION BY keys below
        # puts whole window groups in each child partition
        self.partitionwise = partitionwise

    @property
    def schema(self) -> Schema:
        return self._schema

    def children_coalesce_goal(self):
        return [REQUIRE_SINGLE_BATCH]

    @staticmethod
    def _spec_groups(out_names, window_exprs):
        """Window exprs grouped by shared (partition, order) spec, in a
        deterministic order."""
        groups = {}
        order = []
        for name, we in zip(out_names, window_exprs):
            sig = (tuple(e.sql() for e in we.partition_exprs),
                   tuple(e.sql() for e in we.order_exprs), we.order_dirs)
            if sig not in groups:
                groups[sig] = []
                order.append(sig)
            groups[sig].append((name, we))
        return [groups[sig] for sig in order]

    def _keys_impl(self, gi: int, batch: DeviceBatch) -> tuple:
        we0 = self._spec_groups(self.out_names, self.window_exprs)[gi][0][1]
        return _spec_fields(batch, we0.partition_exprs, we0.order_exprs,
                            we0.order_dirs)

    def _impl(self, batch: DeviceBatch, keys, orders) -> DeviceBatch:
        return window_batch(batch, self.out_names, self.window_exprs,
                            keys, orders)

    def execute(self):
        import functools
        import types
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        # detach from self: the cached steps must not pin the exec
        shim = types.SimpleNamespace(window_exprs=self.window_exprs,
                                     out_names=self.out_names,
                                     _spec_groups=type(self)._spec_groups)
        cls = type(self)
        sig = (kc.exprs_sig(self.window_exprs), tuple(self.out_names))
        n_groups = len(self._spec_groups(self.out_names,
                                         self.window_exprs))
        keys_kernels = [
            kc.get_kernel(("win_keys", sig, gi),
                          lambda gi=gi: functools.partial(
                              cls._keys_impl, shim, gi))
            for gi in range(n_groups)]
        apply_kernel = kc.get_kernel(
            ("window_apply", sig),
            lambda: functools.partial(cls._impl, shim))

        def run(iters):
            batches: List[DeviceBatch] = []
            for it in iters:
                batches.extend(it)
            if not batches:
                return
            whole = concat_batches(batches)
            with timed(self.metrics, "window.eval"):
                keys = tuple(k(whole) for k in keys_kernels)
                orders = tuple(sortkeys.shared_digit_sort(k[2])
                               for k in keys)
                out = apply_kernel(whole, keys, orders)
            self.metrics.add_rows(out.num_rows)
            yield out
        if self.partitionwise:
            return [run([it]) for it in self.children[0].execute()]
        return [run(self.children[0].execute())]
