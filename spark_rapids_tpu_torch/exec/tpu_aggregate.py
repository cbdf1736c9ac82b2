"""Device hash-aggregate exec: the sorted-key grouped aggregate.

Ported from ``spark_rapids_tpu/exec/tpu_aggregate.py``.  Per batch an
*update* aggregation, buffered partials, a concat, a *merge* aggregation
and a final projection; every grouping is sort based:

  1. grouping keys encode into bit-packed u32 digits (exec/sortkeys.py)
  2. a stable sort brings equal keys adjacent (one ``torch.sort`` when the
     key packs into one digit, else one stable pass per digit)
  3. group boundaries mark segment starts; every aggregate is one
     segmented scan read at the group ends — the segmented-reduction
     kernel (kernels/segreduce.py) fuses the sorted-order gather into it
  4. the group count stays on the device as the new batch's num_rows

Where the reference's traced row count picks a branch (the capacity
ladder of ``_laddered`` and the fused-filter update), the port reads the
count on the host once, and only there, so it picks the rung the
reference picks; the rung decides the scans' capacities and with them
the float summation order of the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   concat_batches,
                                                   scatter_drop)
from spark_rapids_tpu_torch.exec import kernel_abi, scans, sortkeys
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, TpuExec, timed
from spark_rapids_tpu_torch.expr import eval_tpu, ir
from spark_rapids_tpu_torch.expr.eval_tpu import ColVal
from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.kernels import segreduce as kseg
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.plan.logical import Schema

_BIG = 1 << 62
_INT64_MAX = (1 << 63) - 1   # uint64 max, in signed order

# capacity ladder engages only when cap/4 reaches this rung size (tests
# may lower it to cover both branches)
_LADDER_MIN_RUNG = 1 << 18


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


def _diff_ends(c: torch.Tensor, end_pos: torch.Tensor) -> torch.Tensor:
    """Per-group sums from a global prefix sum: differences at the group
    ends (exact for integers under wraparound)."""
    ce = c[end_pos]
    return ce - torch.cat([ce[:1] * 0, ce[:-1]])


@dataclass
class _SortedCtx:
    """Sorted-space grouping context shared by all aggregate updates of
    one batch: rows in key order (``order``, int32 original indices),
    group starts (``new``), and per group its first and last sorted row.
    Every reduction is a masked gather into sorted order, a segmented
    scan, and one gather at the group ends."""

    order: torch.Tensor        # int32 [cap] sorted row order
    new: torch.Tensor          # bool [cap] sorted row starts a group
    gid_sorted: torch.Tensor   # int64 [cap] group id per sorted row
    start_pos: torch.Tensor    # int64 [cap] first sorted row of group g
    end_pos: torch.Tensor      # int64 [cap] last sorted row of group g
    sorted_mask: torch.Tensor  # bool [cap] sorted row exists
    cap: int
    row_mask: torch.Tensor     # bool original-space "row exists"
    n_groups: torch.Tensor     # 0-d
    # narrow fast path: the packed sorted key, and (single invertibly
    # encoded key) its (vbits, nullable, dtype, column vbits) layout
    sorted_key: Optional[torch.Tensor] = None
    key_inverse: Optional[Tuple] = None

    def take_sorted(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.order.long()]

    def _kernel_op(self, op, dtype, ndim: int = 1) -> Optional[str]:
        """op-key when this reduction runs through the segmented-
        reduction kernel, else None after counting the fallback with its
        reason (kseg.kernel_gate: on the CPU where the reference would
        take its XLA path, on CUDA only for a 2-D payload)."""
        name = kseg.op_name(op)
        ok, reason = kseg.kernel_gate(self.cap, dtype, name, ndim,
                                      self.new.device)
        if kb.choose("agg.segreduce", ok, reason or "unsupported") == kb.XLA:
            return None
        return name

    def seg_sum(self, x: torch.Tensor, mask: torch.Tensor,
                out_np=None, narrow_bits: Optional[int] = None
                ) -> torch.Tensor:
        """Per-group sum over rows where mask (both original space).
        ``x`` stays in its input dtype through the gather and widens to
        ``out_np`` after; a ``narrow_bits`` hint with
        narrow_bits + log2(cap) <= 31 keeps the whole chain in int32.
        Floats widen before the gather."""
        out_t = out_np or x.dtype
        if out_t.is_floating_point:
            xm = torch.where(mask, x.to(out_t), 0.0)
            if self._kernel_op(torch.add, out_t):
                s = kseg.gather_seg_scan(xm, self.order, self.new, "add", 0)
                return s[self.end_pos]
            return scans.seg_scan(torch.add, self.new, self.take_sorted(xm),
                                  0)[self.end_pos]
        narrow = (narrow_bits is not None and
                  narrow_bits + max(self.cap - 1, 1).bit_length() <= 31)
        if narrow:
            xm = torch.where(mask, x, _zero(x)).to(torch.int32)
            if self._kernel_op(torch.add, torch.int32):
                s = kseg.gather_seg_scan(xm, self.order, self.new, "add", 0)
                return s[self.end_pos].to(out_t)
            c = torch.cumsum(self.take_sorted(xm), 0, dtype=torch.int32)
        else:
            xm = torch.where(mask, x, _zero(x))
            if self._kernel_op(torch.add, out_t):
                s = kseg.gather_seg_scan(xm, self.order, self.new, "add", 0,
                                         scan_np=out_t)
                return s[self.end_pos]
            c = scans.cumsum(self.take_sorted(xm).to(out_t))
        return _diff_ends(c, self.end_pos).to(out_t)

    def seg_count(self, mask: torch.Tensor) -> torch.Tensor:
        # counts fit int32 (cap < 2^31); widen at the end
        if mask is self.row_mask:   # COUNT(*): already have it sorted
            xs = self.sorted_mask.to(torch.int32)
            if self._kernel_op(torch.add, torch.int32):
                s = kseg.seg_scan_sorted(self.new, xs, "add", 0)
                return s[self.end_pos].to(torch.int64)
        else:
            if self._kernel_op(torch.add, torch.int32):
                s = kseg.gather_seg_scan(mask, self.order, self.new, "add",
                                         0, scan_np=torch.int32)
                return s[self.end_pos].to(torch.int64)
            xs = self.take_sorted(mask).to(torch.int32)
        c = torch.cumsum(xs, 0, dtype=torch.int32)
        return _diff_ends(c, self.end_pos).to(torch.int64)

    def seg_scan_reduce(self, x_sorted: torch.Tensor, op,
                        identity) -> torch.Tensor:
        """Segmented reduce over sorted rows; the caller pre-fills
        excluded rows with op's identity."""
        name = self._kernel_op(op, x_sorted.dtype, x_sorted.dim())
        if name:
            s = kseg.seg_scan_sorted(self.new, x_sorted, name, identity)
        else:
            s = scans.seg_scan(op, self.new, x_sorted, identity)
        return s[self.end_pos]

    def seg_min_of(self, x: torch.Tensor, mask: torch.Tensor,
                   fill) -> torch.Tensor:
        return self._seg_extreme(x, mask, fill, torch.minimum)

    def seg_max_of(self, x: torch.Tensor, mask: torch.Tensor,
                   fill) -> torch.Tensor:
        return self._seg_extreme(x, mask, fill, torch.maximum)

    def _seg_extreme(self, x, mask, fill, op) -> torch.Tensor:
        xm = torch.where(mask, x, torch.full((), fill, dtype=x.dtype,
                                             device=x.device))
        name = self._kernel_op(op, x.dtype, xm.dim())
        if name:
            s = kseg.gather_seg_scan(xm, self.order, self.new, name, fill)
            return s[self.end_pos]
        return scans.seg_scan(op, self.new, self.take_sorted(xm),
                              fill)[self.end_pos]


class _AggSpec:
    """update/merge/finalize triple for one aggregate function."""

    n_buffers = 1

    def __init__(self, agg: ir.AggregateExpression):
        self.agg = agg

    def update(self, v: Optional[ColVal], ctx: _SortedCtx):
        raise NotImplementedError

    def merge(self, bufs: List[DeviceColumn], ctx: _SortedCtx):
        raise NotImplementedError

    def finalize(self, bufs: List[DeviceColumn]) -> ColVal:
        raise NotImplementedError

    def buffer_dtypes(self) -> List[dt.DType]:
        raise NotImplementedError


def _ones(ctx: _SortedCtx) -> torch.Tensor:
    return torch.ones((ctx.cap,), dtype=torch.bool,
                      device=ctx.new.device)


class _CountSpec(_AggSpec):
    def buffer_dtypes(self):
        return [dt.INT64]

    def update(self, v, ctx):
        if v is None or v.nonnull:  # COUNT(*) / provably null-free
            mask = ctx.row_mask
        else:
            mask = v.validity & ctx.row_mask
        return [(ctx.seg_count(mask), _ones(ctx))]

    def merge(self, bufs, ctx):
        return [(ctx.seg_sum(bufs[0].data, ctx.row_mask), _ones(ctx))]

    def finalize(self, bufs):
        return ColVal(dt.INT64, bufs[0].data,
                      torch.ones_like(bufs[0].validity))


class _SumSpec(_AggSpec):
    n_buffers = 2  # sum, valid-input count

    def buffer_dtypes(self):
        return [self.agg.dtype, dt.INT64]

    def _sum(self, data, validity, ctx, narrow_bits=None):
        tgt = self.agg.dtype.to_torch()
        mask = validity if validity is ctx.row_mask \
            else validity & ctx.row_mask
        s = ctx.seg_sum(data, mask, out_np=tgt, narrow_bits=narrow_bits)
        c = ctx.seg_count(mask)
        return [(s, c > 0), (c, _ones(ctx))]

    def update(self, v, ctx):
        return self._sum(v.data,
                         ctx.row_mask if v.nonnull else v.validity,
                         ctx, narrow_bits=sortkeys.narrow_int_bits(v))

    def merge(self, bufs, ctx):
        tgt = self.agg.dtype.to_torch()
        s = ctx.seg_sum(bufs[0].data, bufs[0].validity & ctx.row_mask,
                        out_np=tgt)
        c = ctx.seg_sum(bufs[1].data, ctx.row_mask, out_np=torch.int64)
        return [(s, c > 0), (c, _ones(ctx))]

    def finalize(self, bufs):
        return ColVal(self.agg.dtype, bufs[0].data, bufs[0].validity)


class _MinMaxSpec(_AggSpec):
    def __init__(self, agg, is_min: bool):
        super().__init__(agg)
        self.is_min = is_min

    def buffer_dtypes(self):
        return [self.agg.dtype]

    def _reduce_string(self, data, validity, lengths, ctx):
        """String min/max: word-wise segmented tie-break — per key word
        (most significant first) keep the rows matching the group's
        extreme, then pick the first survivor.  The words are uint64
        patterns carried in int64, compared in signed order."""
        considered = validity & ctx.row_mask
        sv = ColVal(self.agg.dtype, data, considered, lengths)
        words = sortkeys.encode_keys(sv, True, nulls_first=False)[1:]
        cand_s = ctx.take_sorted(considered)
        for w in words:
            wv_s = sortkeys.signed_order(
                ctx.take_sorted(w if self.is_min else ~w))
            best = ctx.seg_scan_reduce(
                torch.where(cand_s, wv_s, _INT64_MAX), torch.minimum,
                _INT64_MAX)
            cand_s = cand_s & (wv_s == best[ctx.gid_sorted])
        i = torch.arange(ctx.cap, dtype=torch.int64, device=data.device)
        win = ctx.seg_scan_reduce(torch.where(cand_s, i, _BIG),
                                  torch.minimum, _BIG)
        found = ctx.seg_count(considered) > 0
        orig = ctx.order[win.clamp(0, ctx.cap - 1)].long()
        val = torch.where(found[:, None], data[orig], _zero(data))
        lens = torch.where(found, lengths[orig], _zero(lengths))
        return [(val, found, lens)]

    def _reduce(self, data, validity, lengths, ctx):
        d = self.agg.dtype
        considered = validity if validity is ctx.row_mask \
            else validity & ctx.row_mask
        if d.is_string:
            return self._reduce_string(data, validity, lengths, ctx)
        if d.is_floating:
            isnan = torch.isnan(data)
            non_nan = considered & ~isnan
            fill = float("inf") if self.is_min else float("-inf")
            red = ctx.seg_min_of(data, non_nan, fill) if self.is_min \
                else ctx.seg_max_of(data, non_nan, fill)
            has_non_nan = ctx.seg_count(non_nan) > 0
            has_nan = ctx.seg_count(considered & isnan) > 0
            has_any = has_non_nan | has_nan
            nan = torch.full_like(red, float("nan"))
            if self.is_min:
                # Spark: NaN is greatest -> min prefers non-NaN
                val = torch.where(has_non_nan, red, nan)
            else:
                # max: any NaN wins
                val = torch.where(has_nan, nan, red)
            return [(torch.where(has_any, val, _zero(val)), has_any)]
        if d.is_bool:
            x = data.to(torch.int32)
            red = ctx.seg_min_of(x, considered, 1) if self.is_min \
                else ctx.seg_max_of(x, considered, 0)
            has = ctx.seg_count(considered) > 0
            return [(red.to(torch.bool) & has, has)]
        info = np.iinfo(d.to_np())
        x = data.to(d.to_torch())
        red = ctx.seg_min_of(x, considered, int(info.max)) if self.is_min \
            else ctx.seg_max_of(x, considered, int(info.min))
        has = ctx.seg_count(considered) > 0
        return [(torch.where(has, red, _zero(red)), has)]

    def update(self, v, ctx):
        return self._reduce(v.data,
                            ctx.row_mask if v.nonnull else v.validity,
                            v.lengths, ctx)

    def merge(self, bufs, ctx):
        return self._reduce(bufs[0].data, bufs[0].validity,
                            bufs[0].lengths, ctx)

    def finalize(self, bufs):
        return ColVal(self.agg.dtype, bufs[0].data, bufs[0].validity,
                      bufs[0].lengths)


class _AverageSpec(_AggSpec):
    n_buffers = 2  # sum f64, count i64

    def buffer_dtypes(self):
        return [dt.FLOAT64, dt.INT64]

    def update(self, v, ctx):
        considered = ctx.row_mask if v.nonnull \
            else v.validity & ctx.row_mask
        s = ctx.seg_sum(v.data, considered, out_np=torch.float64)
        c = ctx.seg_count(considered)
        return [(s, _ones(ctx)), (c, _ones(ctx))]

    def merge(self, bufs, ctx):
        s = ctx.seg_sum(bufs[0].data, ctx.row_mask, out_np=torch.float64)
        c = ctx.seg_sum(bufs[1].data, ctx.row_mask, out_np=torch.int64)
        return [(s, _ones(ctx)), (c, _ones(ctx))]

    def finalize(self, bufs):
        c = bufs[1].data
        nz = c > 0
        avg = torch.where(nz, bufs[0].data / torch.where(nz, c, 1), 0.0)
        return ColVal(dt.FLOAT64, avg, nz)


class _FirstLastSpec(_AggSpec):
    n_buffers = 2  # value, found-flag

    def __init__(self, agg, is_first: bool):
        super().__init__(agg)
        self.is_first = is_first
        self.ignore_nulls = agg.ignore_nulls

    def buffer_dtypes(self):
        return [self.agg.dtype, dt.BOOL]

    def _pick(self, data, validity, lengths, considered, ctx):
        """In sorted space, pick the first/last considered row per group
        (the stable sort keeps input order within a group)."""
        i = torch.arange(ctx.cap, dtype=torch.int64, device=data.device)
        considered_s = ctx.take_sorted(considered)
        if self.is_first:
            win = ctx.seg_scan_reduce(torch.where(considered_s, i, _BIG),
                                      torch.minimum, _BIG)
            found = win < _BIG
        else:
            win = ctx.seg_scan_reduce(torch.where(considered_s, i, -1),
                                      torch.maximum, -1)
            found = win >= 0
        orig = ctx.order[win.clamp(0, ctx.cap - 1)].long()
        val = data[orig]
        vvalid = validity[orig] & found
        val = torch.where(found[:, None] if data.dim() == 2 else found, val,
                          _zero(val))
        if lengths is not None:
            lens = torch.where(found, lengths[orig], _zero(lengths))
            return [(val, vvalid, lens), (found, torch.ones_like(found))]
        return [(val, vvalid), (found, torch.ones_like(found))]

    def update(self, v, ctx):
        considered = ctx.row_mask & (v.validity if self.ignore_nulls
                                     else torch.ones_like(v.validity))
        return self._pick(v.data, v.validity, v.lengths, considered, ctx)

    def merge(self, bufs, ctx):
        considered = ctx.row_mask & bufs[1].data.to(torch.bool)
        if self.ignore_nulls:
            considered = considered & bufs[0].validity
        return self._pick(bufs[0].data, bufs[0].validity, bufs[0].lengths,
                          considered, ctx)

    def finalize(self, bufs):
        return ColVal(self.agg.dtype, bufs[0].data, bufs[0].validity,
                      bufs[0].lengths)


def make_spec(agg: ir.AggregateExpression) -> _AggSpec:
    if isinstance(agg, ir.Count):
        return _CountSpec(agg)
    if isinstance(agg, ir.Sum):
        return _SumSpec(agg)
    if isinstance(agg, ir.Min):
        return _MinMaxSpec(agg, True)
    if isinstance(agg, ir.Max):
        return _MinMaxSpec(agg, False)
    if isinstance(agg, ir.Average):
        return _AverageSpec(agg)
    if isinstance(agg, ir.First):
        return _FirstLastSpec(agg, True)
    if isinstance(agg, ir.Last):
        return _FirstLastSpec(agg, False)
    raise NotImplementedError(type(agg).__name__)


# ---------------------------------------------------------------------------
# grouping and the three phases
# ---------------------------------------------------------------------------

def normalize_key(v: ColVal) -> ColVal:
    """NaN/-0.0 canonicalization for grouping keys (Spark
    NormalizeFloatingNumbers semantics)."""
    if v.dtype.is_floating:
        x = torch.where(torch.isnan(v.data),
                        torch.full_like(v.data, float("nan")), v.data)
        x = torch.where(x == 0.0, torch.zeros_like(x), x)
        return ColVal(v.dtype, x, v.validity, v.lengths)
    return v


def sorted_group_ctx(key_vals: List[ColVal],
                     batch: DeviceBatch) -> _SortedCtx:
    """Batch-shaped wrapper over _group_ctx (rows are prefix-dense: row i
    exists iff i < num_rows)."""
    return _group_ctx(key_vals, batch.capacity, batch.num_rows,
                      device=batch.device)


def _group_ctx(key_vals: List[ColVal], cap: int, n_rows,
               device=None) -> _SortedCtx:
    """Group rows by key: a stable sort over bit-packed key digits brings
    equal keys adjacent, boundaries mark group starts."""
    if device is None:
        device = key_vals[0].data.device if key_vals else n_rows.device
    row_mask = torch.arange(cap, device=device) < n_rows
    i32 = torch.arange(cap, dtype=torch.int32, device=device)
    if not key_vals:
        # global aggregation: one group spanning the whole capacity, so a
        # fused-filter mask with gaps still sums correctly
        end = torch.zeros((cap,), dtype=torch.int64, device=device)
        end[0] = cap - 1
        zeros = torch.zeros((cap,), dtype=torch.int64, device=device)
        return _SortedCtx(
            order=i32, new=(i32 == 0), gid_sorted=zeros, start_pos=zeros,
            end_pos=end, sorted_mask=row_mask, cap=cap, row_mask=row_mask,
            n_groups=torch.ones((), dtype=torch.int64, device=device))

    fields = [(1, (~row_mask).to(torch.int64))]  # padding sorts last
    total_bits = 1
    eff_nullables = []
    for v in key_vals:
        # drop the null flag only on the propagated no-null hint
        nullable = not v.nonnull
        eff_nullables.append(nullable)
        kf = sortkeys.encode_fields(v, True, True, nullable=nullable)
        fields.extend(kf)
        total_bits += sum(w for w, _ in kf)
    digits = sortkeys.fields_to_digits(fields)

    if digits.shape[0] == 1:
        # narrow-key fast path: one stable sort of the packed key; the
        # padding flag is its most significant bit, so sorted_mask and
        # the group boundaries come from the sorted keys
        ks, order = torch.sort(digits[0], stable=True)
        sorted_mask = (ks >> (total_bits - 1)) == 0
        new = torch.cat([torch.ones((1,), dtype=torch.bool, device=device),
                         ks[1:] != ks[:-1]]) & sorted_mask
        sorted_key = ks
    else:
        order = sortkeys.radix_order_digits(digits)
        sorted_mask = row_mask[order]
        new = i32 == 0
        for di in range(digits.shape[0]):
            ds = digits[di][order]
            new = new | torch.cat([torch.ones((1,), dtype=torch.bool,
                                              device=device),
                                   ds[1:] != ds[:-1]])
        new = new & sorted_mask
        sorted_key = None
    gid_sorted = (torch.cumsum(new.to(torch.int64), 0) - 1).clamp(min=0)
    n_groups = new.sum()

    nxt_real = torch.cat([sorted_mask[1:],
                          torch.zeros((1,), dtype=torch.bool,
                                      device=device)])
    nxt_new = torch.cat([new[1:], torch.ones((1,), dtype=torch.bool,
                                             device=device)])
    is_end = sorted_mask & (nxt_new | ~nxt_real)
    pos = i32.to(torch.int64)
    # unique-index scatters; rows that are not a group start/end drop
    start_pos = scatter_drop(torch.where(new, gid_sorted, cap), pos, cap)
    end_pos = scatter_drop(torch.where(is_end, gid_sorted, cap), pos, cap)
    key_inverse = None
    if sorted_key is not None and len(key_vals) == 1:
        v0 = key_vals[0]
        vb = sortkeys.narrow_int_bits(v0)
        if vb is not None:
            key_inverse = (vb, eff_nullables[0], v0.dtype, v0.vbits)
    return _SortedCtx(order=order.to(torch.int32), new=new,
                      gid_sorted=gid_sorted, start_pos=start_pos,
                      end_pos=end_pos, sorted_mask=sorted_mask, cap=cap,
                      row_mask=row_mask, n_groups=n_groups,
                      sorted_key=sorted_key, key_inverse=key_inverse)


def gather_group_keys(key_vals: List[ColVal],
                      ctx: _SortedCtx) -> List[DeviceColumn]:
    """Representative key row per group (first sorted row)."""
    if not key_vals:
        return []
    group_exists = torch.arange(ctx.cap, device=ctx.new.device) < \
        ctx.n_groups
    if ctx.key_inverse is not None:
        # single narrow int key: unbias the packed sorted key at the
        # group starts
        vb, nullable, kdt, kvbits = ctx.key_inverse
        kg = ctx.sorted_key[ctx.start_pos]
        value = (kg & ((1 << vb) - 1)) - (1 << (vb - 1))
        valid = group_exists
        if nullable:
            valid = valid & (((kg >> vb) & 1) == 1)
        data = torch.where(valid, value, 0).to(kdt.to_torch())
        return [DeviceColumn(kdt, data, valid, vbits=kvbits,
                             nonnull=not nullable)]
    orig = ctx.order[ctx.start_pos]
    return [v.to_column().gather(orig, group_exists) for v in key_vals]


def _append_buffers(cols, names, bufs_per_spec, specs, ctx):
    group_exists = torch.arange(ctx.cap, device=ctx.new.device) < \
        ctx.n_groups
    for ai, (spec, bufs) in enumerate(zip(specs, bufs_per_spec)):
        for bi, (buf, bdt) in enumerate(zip(bufs, spec.buffer_dtypes())):
            data, valid = buf[0], buf[1]
            lengths = buf[2] if len(buf) > 2 else None
            if data.dim() == 1:
                data = data.to(bdt.to_torch())
                data = torch.where(group_exists, data, _zero(data))
            cols.append(DeviceColumn(
                bdt, data, valid & group_exists,
                torch.where(group_exists, lengths, _zero(lengths))
                if lengths is not None else None))
            names.append(f"__a{ai}_{bi}")


def _slice_batch(batch: DeviceBatch, n2: int) -> DeviceBatch:
    cols = [DeviceColumn(
        c.dtype, c.data[:n2], c.validity[:n2],
        None if c.lengths is None else c.lengths[:n2],
        None if c.elem_validity is None else c.elem_validity[:n2],
        c.vbits, c.nonnull)
        for c in batch.columns]
    return DeviceBatch(batch.names, cols, batch.num_rows, batch.device)


def _pad_batch(batch: DeviceBatch, cap: int) -> DeviceBatch:
    def pad(a):
        if a is None or a.shape[0] >= cap:
            return a
        return torch.cat([a, a.new_zeros((cap - a.shape[0],) +
                                         tuple(a.shape[1:]))])
    cols = [DeviceColumn(c.dtype, pad(c.data), pad(c.validity),
                         pad(c.lengths), pad(c.elem_validity),
                         c.vbits, c.nonnull)
            for c in batch.columns]
    return DeviceBatch(batch.names, cols, batch.num_rows, batch.device)


def _laddered(batch: DeviceBatch, fn):
    """Capacity ladder: when the batch's live rows fit in cap/4, run the
    whole aggregation at that smaller capacity (every sort, gather and
    scan scales with capacity), outputs padded back to cap.  The row
    count is read on the host here, once."""
    cap = batch.capacity
    rung = cap // 4
    if rung < _LADDER_MIN_RUNG:
        return fn(batch)
    if int(batch.num_rows) <= rung:
        return _pad_batch(fn(_slice_batch(batch, rung)), cap)
    return fn(batch)


def _gather_val(v: ColVal, sel: torch.Tensor,
                live: torch.Tensor) -> ColVal:
    """Gather a value vector through a selected-row index map (the
    fused-filter permutation compact); rows beyond the live count zero
    out.  Nonnull columns skip the validity gather (sel maps live outputs
    to live source rows)."""
    idx = sel.long()
    data = v.data[idx]
    data = torch.where(live if data.dim() == 1 else live[:, None], data,
                       _zero(data))
    validity = live if v.nonnull else v.validity[idx] & live
    lengths = None if v.lengths is None else \
        torch.where(live, v.lengths[idx], _zero(v.lengths))
    ev = None if v.elem_validity is None else \
        v.elem_validity[idx] & live[:, None]
    return ColVal(v.dtype, data, validity, lengths, ev, vbits=v.vbits,
                  nonnull=v.nonnull)


def update_aggregate(batch: DeviceBatch,
                     groupings: Sequence[ir.Expression],
                     aggregates: Sequence[ir.AggregateExpression],
                     specs: Sequence[_AggSpec],
                     condition: Optional[ir.Expression] = None
                     ) -> DeviceBatch:
    """Per-batch update phase.

    ``condition`` is a fused pre-filter (a Filter directly under the
    aggregate): the filter compacts only the evaluated key/agg value
    vectors, and the prefix-dense survivors let the capacity ladder run
    the grouping at a rung sized to the selected rows."""
    dev = batch.device

    def run(kv, av, cap2, nr, sel_s=None, full_mask=None):
        """One grouped update at capacity cap2.  In the fused-filter path
        ``av`` stays in original row space: the sorted-space value gather
        composes the selection map with the sort order."""
        ctx = _group_ctx(kv, cap2, nr, device=dev)
        cols = gather_group_keys(kv, ctx)
        names = [f"__k{i}" for i in range(len(cols))]
        vctx = ctx
        if sel_s is not None:
            vctx = replace(ctx, order=sel_s[ctx.order.long()],
                           row_mask=full_mask)
        bufs_per_spec = [spec.update(v, vctx)
                         for v, spec in zip(av, specs)]
        _append_buffers(cols, names, bufs_per_spec, specs, ctx)
        return DeviceBatch(names, cols, ctx.n_groups)

    def eval_vals(b: DeviceBatch):
        kv = [normalize_key(eval_tpu.evaluate(g, b)) for g in groupings]
        av = [eval_tpu.evaluate(a.child, b)
              if a.child is not None else None for a in aggregates]
        return kv, av

    if condition is None:
        def run_batch(b: DeviceBatch) -> DeviceBatch:
            kv, av = eval_vals(b)
            return run(kv, av, b.capacity, b.num_rows)
        return _laddered(batch, run_batch)

    # fused filter: the condition sees every row at full capacity; then
    # the PERMUTATION compacts (surviving row positions ascend, so one
    # sort is the stable compaction) and each vector gathers through it
    key_vals, agg_vals = eval_vals(batch)
    cap = batch.capacity
    cv = eval_tpu.evaluate(condition, batch)
    keep = cv.data.to(torch.bool) & cv.validity & batch.row_mask()
    n_rows = keep.sum()
    pos = torch.where(keep, torch.arange(cap, dtype=torch.int64, device=dev),
                      0xFFFFFFFF)
    # the reference's u32 sort: dropped rows carry 0xFFFFFFFF, i.e. -1
    sel = torch.sort(pos).values.to(torch.int32)

    def gather_keys(cap2):
        s = sel[:cap2]
        live = torch.arange(cap2, device=dev) < n_rows
        return [_gather_val(v, s, live) for v in key_vals], s

    rung = cap // 4
    if rung < _LADDER_MIN_RUNG:
        kv, s = gather_keys(cap)
        return run(kv, agg_vals, cap, n_rows, s, keep)
    if int(n_rows) <= rung:       # the rung choice: one host read
        kv, s = gather_keys(rung)
        return _pad_batch(run(kv, agg_vals, rung, n_rows, s, keep), cap)
    kv, s = gather_keys(cap)
    return run(kv, agg_vals, cap, n_rows, s, keep)


def merge_aggregate(batch: DeviceBatch, n_keys: int,
                    specs: Sequence[_AggSpec]) -> DeviceBatch:
    """Merge phase over concatenated partials."""
    def run(b: DeviceBatch) -> DeviceBatch:
        key_vals = [ColVal(c.dtype, c.data, c.validity, c.lengths,
                           vbits=c.vbits, nonnull=c.nonnull)
                    for c in b.columns[:n_keys]]
        ctx = sorted_group_ctx(key_vals, b)
        cols = gather_group_keys(key_vals, ctx)
        names = list(b.names[:n_keys])
        bufs_per_spec = []
        off = n_keys
        for spec in specs:
            bufs = b.columns[off:off + spec.n_buffers]
            off += spec.n_buffers
            bufs_per_spec.append(spec.merge(bufs, ctx))
        _append_buffers(cols, names, bufs_per_spec, specs, ctx)
        return DeviceBatch(names, cols, ctx.n_groups)
    return _laddered(batch, run)


def finalize_aggregate(batch: DeviceBatch, n_keys: int,
                       specs: Sequence[_AggSpec],
                       out_names: Sequence[str]) -> DeviceBatch:
    """Final projection from buffer columns to output columns."""
    cols = list(batch.columns[:n_keys])
    off = n_keys
    for spec in specs:
        bufs = batch.columns[off:off + spec.n_buffers]
        off += spec.n_buffers
        cols.append(spec.finalize(bufs).to_column())
    return DeviceBatch(list(out_names), cols, batch.num_rows, batch.device)


def _plan_device(plan: PhysicalPlan) -> torch.device:
    """The device of the nearest transition below ``plan``."""
    while True:
        dev = getattr(plan, "device", None)
        if dev is not None:
            return dev
        if not plan.children:
            raise ValueError("no device transition below the aggregate")
        plan = plan.children[0]


class TpuHashAggregateExec(TpuExec):
    def __init__(self, child: PhysicalPlan,
                 groupings: Sequence[ir.Expression],
                 aggregates: Sequence[ir.AggregateExpression],
                 schema: Schema, per_partition: bool = False):
        super().__init__()
        self.children = (child,)
        self.groupings = list(groupings)
        self.aggregates = list(aggregates)
        self.specs = [make_spec(a) for a in self.aggregates]
        self._schema = schema
        # aggregate each child partition independently
        self.per_partition = per_partition
        # a Filter that sat directly below this aggregate, fused in: its
        # rows are selected inside the update (see update_aggregate)
        self.fused_condition: Optional[ir.Expression] = None
        # Project/Filter execs the fusion pass inlined into this
        # aggregate (plan/fusion.py R2), and how many of them the plain
        # filter fusion would not have absorbed
        self.fused_prologue_execs = 0
        self.fused_prologue_saved = 0
        self._update_kernel = None
        self._merge_kernel = None
        self._final_kernel = None

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        if self.fused_condition is not None:
            return (f"TpuHashAggregateExec(fusedFilter="
                    f"{self.fused_condition.sql()})")
        return "TpuHashAggregateExec"

    def _update_impl(self, batch: DeviceBatch) -> DeviceBatch:
        return update_aggregate(batch, self.groupings, self.aggregates,
                                self.specs, self.fused_condition)

    def _merge_impl(self, batch: DeviceBatch) -> DeviceBatch:
        return merge_aggregate(batch, len(self.groupings), self.specs)

    def _final_impl(self, batch: DeviceBatch) -> DeviceBatch:
        return finalize_aggregate(batch, len(self.groupings), self.specs,
                                  self._schema.names)

    def _build_kernels(self) -> None:
        """The update/merge/final steps from the process kernel cache,
        under the reference's keys (:911-962)."""
        import functools
        import types
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        # the plan-stamped kernel.backend (the process default for
        # hand-built plans): folded into the keys and passed to
        # get_kernel so dispatches count as kernel.dispatches.agg_*.<bk>.
        # The reference's interpret flag and tile budget ride its keys
        # for its Pallas grids; the port has neither, and keeps their
        # slots as None
        bk = kb.resolve(getattr(self, "_kernel_backend", None))
        # update/merge never read the output names (static __k*/__a*
        # buffer names); only agg_final bakes them in
        sig = (kc.exprs_sig(self.groupings), kc.exprs_sig(self.aggregates),
               bk, None, None)
        # only the UPDATE step evaluates the fused condition
        usig = sig + (kc.expr_sig(self.fused_condition)
                      if self.fused_condition is not None else None,)
        # detach from self: the cached steps must not pin the exec (and
        # through it the plan)
        shim = types.SimpleNamespace(
            groupings=self.groupings, aggregates=self.aggregates,
            specs=self.specs, _schema=self._schema,
            fused_condition=self.fused_condition)
        cls = type(self)
        self._update_kernel = kc.get_kernel(
            ("agg_update", usig),
            lambda: functools.partial(cls._update_impl, shim), backend=bk)
        self._merge_kernel = kc.get_kernel(
            ("agg_merge", sig),
            lambda: functools.partial(cls._merge_impl, shim), backend=bk)
        self._final_kernel = kc.get_kernel(
            ("agg_final", sig, tuple(self._schema.names)),
            lambda: functools.partial(cls._final_impl, shim))

    def execute(self):
        if self._update_kernel is None:
            self._build_kernels()

        def run(its):
            from spark_rapids_tpu_torch.mem.spill import register_or_hold
            # buffered partials stay spillable between update and merge
            partials: List = []
            try:
                for it in its:
                    for b in it:
                        # skip empty batches only when the count is
                        # host-side
                        nr = b.num_rows
                        if isinstance(nr, (int, np.integer)) and nr == 0 \
                                and self.groupings:
                            continue
                        with timed(self.metrics, "agg.update"):
                            partial = self._update_kernel(
                                kernel_abi.erase(b))
                        if self.fused_prologue_saved:
                            obsreg.get_registry().inc(
                                "fusion.dispatchesSaved",
                                self.fused_prologue_saved)
                        partials.append(register_or_hold(partial))
                if not partials:
                    if self.groupings:
                        return  # grouped agg over empty input -> no rows
                    # global agg over empty -> one row (count=0, sum=null)
                    empty = _make_empty_buffer_batch(self,
                                                     _plan_device(self))
                    yield self._final_kernel(empty)
                    return
                if len(partials) == 1:
                    merged = partials[0].get()
                else:
                    whole = concat_batches([p.get() for p in partials])
                    with timed(self.metrics, "agg.merge"):
                        merged = self._merge_kernel(whole)
                out = self._final_kernel(merged)
                self.metrics.add_rows(out.num_rows)
                yield out
            finally:
                for p in partials:
                    p.close()

        if self.per_partition:
            return [run([it]) for it in self.children[0].execute()]
        return [run(self.children[0].execute())]


def _make_empty_buffer_batch(exec_: TpuHashAggregateExec,
                             device) -> DeviceBatch:
    """Buffer-layout batch for a global aggregate over zero rows."""
    cap = 16
    cols, names = [], []

    def z(dtype):
        return torch.zeros((cap,), dtype=dtype, device=device)
    for ai, spec in enumerate(exec_.specs):
        for bi, bdt in enumerate(spec.buffer_dtypes()):
            names.append(f"__a{ai}_{bi}")
            if bdt.is_string:
                cols.append(DeviceColumn(
                    bdt, torch.zeros((cap, 1), dtype=torch.uint8,
                                     device=device),
                    z(torch.bool), z(torch.int32)))
                continue
            # count buffers are valid-0; value buffers are null
            valid = z(torch.bool)
            if bdt == dt.INT64 and isinstance(
                    spec, (_CountSpec, _SumSpec, _AverageSpec)) \
                    and bi == (0 if isinstance(spec, _CountSpec) else 1):
                valid[0] = True
            cols.append(DeviceColumn(bdt, z(bdt.to_torch()), valid, None))
    return DeviceBatch(names, cols, 1)
