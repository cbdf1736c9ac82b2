"""Device columnar expression evaluator on torch tensors.

Ported from ``spark_rapids_tpu/expr/eval_tpu.py`` for the expressions of
the q6 path and ``__graft_entry__.entry``: bound references, literals,
aliases, comparisons (Spark's total order for floats: NaN greatest, NaN ==
NaN),
AND/OR three-valued logic, NOT, ``+ - * /`` with Spark's null rules
(x / 0 is NULL; integer overflow wraps), casts between numeric, boolean
and temporal types, and IS [NOT] NULL.  The planner keeps every other
node on the CPU (:func:`supported_on_tpu`, read by plan/overrides.py), so
a planned query never reaches the ``NotImplementedError(<node name>)``
that evaluating one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.expr import ir


@dataclass
class ColVal:
    """Evaluated column value: data + validity (+ lengths for string/list,
    elem_validity for list)."""

    dtype: dt.DType
    data: torch.Tensor
    validity: torch.Tensor
    lengths: Optional[torch.Tensor] = None
    elem_validity: Optional[torch.Tensor] = None
    # static value-range hint (see DeviceColumn.vbits); survives only
    # range-preserving ops (column refs, gathers, aliases)
    vbits: Optional[int] = None
    # static no-nulls hint (see DeviceColumn.nonnull)
    nonnull: bool = False

    def to_column(self) -> DeviceColumn:
        return DeviceColumn(self.dtype, self.data, self.validity,
                            self.lengths, self.elem_validity, self.vbits,
                            self.nonnull)


def evaluate(e: ir.Expression, batch: DeviceBatch) -> ColVal:
    """Evaluate a bound expression against a DeviceBatch."""
    fn = _DISPATCH.get(type(e))
    if fn is None:
        raise NotImplementedError(type(e).__name__)
    v = fn(e, batch)
    # padding rows are never valid
    return ColVal(v.dtype, v.data, v.validity & batch.row_mask(), v.lengths,
                  v.elem_validity, v.vbits, v.nonnull)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _const(batch: DeviceBatch, value, dtype: dt.DType) -> ColVal:
    cap, dev = batch.capacity, batch.device
    if dtype.is_string:
        b = (value or "").encode("utf-8")
        max_len = max(1, 1 << (len(b) - 1).bit_length() if b else 1)
        data = np.zeros((cap, max_len), dtype=np.uint8)
        if b:
            data[:, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths = torch.full((cap,), len(b), dtype=torch.int32, device=dev)
        valid = torch.full((cap,), value is not None, device=dev)
        return ColVal(dtype, torch.from_numpy(data).to(dev), valid, lengths)
    if value is None:
        t = dtype.to_torch() if dtype != dt.NULL else torch.bool
        return ColVal(dtype, torch.zeros((cap,), dtype=t, device=dev),
                      torch.zeros((cap,), dtype=torch.bool, device=dev))
    if dtype.id == dt.TypeId.DATE32 and \
            not isinstance(value, (int, np.integer)):
        value = int((np.datetime64(value, "D") -
                     np.datetime64(0, "D")).astype(int))
    if dtype.id == dt.TypeId.TIMESTAMP_US and \
            not isinstance(value, (int, np.integer)):
        value = int((np.datetime64(value, "us") -
                     np.datetime64(0, "us")).astype(int))
    data = torch.full((cap,), value, dtype=dtype.to_torch(), device=dev)
    return ColVal(dtype, data,
                  torch.ones((cap,), dtype=torch.bool, device=dev))


def f64_bits(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 bit pattern of a float64, carried in int64 (the uint64
    pattern's bits), NaN canonicalized to the positive quiet pattern.
    Hopper has native 64-bit bitcasts, so this is the reference's CPU
    formulation (its arithmetic TPU variant flushes subnormals)."""
    bits = x.contiguous().view(torch.int64)
    return torch.where(torch.isnan(x), 0x7FF8000000000000, bits)


def _binary_null(l: ColVal, r: ColVal):
    return l.validity & r.validity


def _promote_pair(e, l: ColVal, r: ColVal):
    tgt = e.dtype.to_torch()
    return l.data.to(tgt), r.data.to(tgt)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _eval_literal(e: ir.Literal, batch: DeviceBatch) -> ColVal:
    return _const(batch, e.value, e.dtype)


def _eval_bound(e: ir.BoundReference, batch: DeviceBatch) -> ColVal:
    c = batch.columns[e.ordinal]
    return ColVal(c.dtype, c.data, c.validity, c.lengths, c.elem_validity,
                  c.vbits, c.nonnull)


def _eval_alias(e: ir.Alias, batch: DeviceBatch) -> ColVal:
    return evaluate(e.children[0], batch)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _eval_add(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    a, b = _promote_pair(e, l, r)
    return ColVal(e.dtype, a + b, _binary_null(l, r))


def _eval_sub(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    a, b = _promote_pair(e, l, r)
    return ColVal(e.dtype, a - b, _binary_null(l, r))


def _eval_mul(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    a, b = _promote_pair(e, l, r)
    return ColVal(e.dtype, a * b, _binary_null(l, r))


def _eval_div(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    a = l.data.to(torch.float64)
    b = r.data.to(torch.float64)
    nz = b != 0.0
    out = torch.where(nz, a / torch.where(nz, b, 1.0), 0.0)
    return ColVal(e.dtype, out, _binary_null(l, r) & nz)


# ---------------------------------------------------------------------------
# comparisons (Spark total order for floats: NaN greatest, NaN == NaN)
# ---------------------------------------------------------------------------

def _string_eq(l: ColVal, r: ColVal) -> torch.Tensor:
    wl, wr = l.data.shape[1], r.data.shape[1]
    w = max(wl, wr)
    a = torch.nn.functional.pad(l.data, (0, w - wl))
    b = torch.nn.functional.pad(r.data, (0, w - wr))
    return torch.all(a == b, dim=1) & (l.lengths == r.lengths)


def _string_cmp(l: ColVal, r: ColVal) -> torch.Tensor:
    """Lexicographic compare -> int {-1,0,1} per row."""
    wl, wr = l.data.shape[1], r.data.shape[1]
    w = max(wl, wr)
    a = torch.nn.functional.pad(l.data, (0, w - wl)).to(torch.int32)
    b = torch.nn.functional.pad(r.data, (0, w - wr)).to(torch.int32)
    # bytes beyond each string's length compare as -1: shorter sorts first
    idx = torch.arange(w, device=a.device)[None, :]
    a = torch.where(idx < l.lengths[:, None], a, -1)
    b = torch.where(idx < r.lengths[:, None], b, -1)
    diff = torch.sign(a - b)
    nz = diff != 0
    first = torch.argmax(nz.to(torch.int32), dim=1)
    any_nz = torch.any(nz, dim=1)
    return torch.where(any_nz, torch.gather(diff, 1, first[:, None])[:, 0],
                       0)


def _cmp_vals(l: ColVal, r: ColVal, op: str) -> torch.Tensor:
    if l.dtype.is_string:
        if op == "eq":
            return _string_eq(l, r)
        c = _string_cmp(l, r)
        return {"lt": c < 0, "le": c <= 0, "gt": c > 0, "ge": c >= 0}[op]
    tgt = dt.promote(l.dtype, r.dtype).to_torch() if l.dtype != r.dtype \
        else l.dtype.to_torch()
    a, b = l.data.to(tgt), r.data.to(tgt)
    if l.dtype.is_floating or r.dtype.is_floating:
        an, bn = torch.isnan(a), torch.isnan(b)
        if op == "eq":
            return torch.where(an | bn, an & bn, a == b)
        if op == "lt":
            return torch.where(an, False, torch.where(bn, True, a < b))
        if op == "le":
            return torch.where(bn, True, torch.where(an, False, a <= b))
        if op == "gt":
            return torch.where(bn, False, torch.where(an, True, a > b))
        if op == "ge":
            return torch.where(an, True, torch.where(bn, False, a >= b))
    return {"eq": a == b, "lt": a < b, "le": a <= b,
            "gt": a > b, "ge": a >= b}[op]


def _mk_cmp(op):
    def f(e, batch):
        l, r = evaluate(e.left, batch), evaluate(e.right, batch)
        return ColVal(dt.BOOL, _cmp_vals(l, r, op), _binary_null(l, r))
    return f


def _eval_and(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    val = l.data & r.data
    known_false = (l.validity & ~l.data) | (r.validity & ~r.data)
    valid = (l.validity & r.validity) | known_false
    return ColVal(dt.BOOL, val & ~known_false, valid)


def _eval_or(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    val = l.data | r.data
    known_true = (l.validity & l.data) | (r.validity & r.data)
    valid = (l.validity & r.validity) | known_true
    return ColVal(dt.BOOL, val | known_true, valid)


def _eval_not(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(dt.BOOL, ~c.data, c.validity)


def _eval_isnull(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(dt.BOOL, ~c.validity & batch.row_mask(),
                  torch.ones_like(c.validity))


def _eval_isnotnull(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(dt.BOOL, c.validity, torch.ones_like(c.validity))


# ---------------------------------------------------------------------------
# cast (numeric, boolean and temporal; strings are not ported yet)
# ---------------------------------------------------------------------------

_US_PER_DAY = 86400 * 1000 * 1000


def _float_to_int(x: torch.Tensor, tgt: dt.DType) -> torch.Tensor:
    """Spark non-ANSI float -> integral cast: NaN -> 0, truncate toward
    zero, saturate at the target's bounds (int64's upper bound is not a
    float64, so both ends are masked explicitly)."""
    t = tgt.to_torch()
    info = np.iinfo(tgt.to_np())
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0,
                         posinf=float("inf"), neginf=float("-inf"))
    x = torch.trunc(x)
    hi = x >= float(info.max) + 1.0
    lo = x <= float(info.min)
    inner = torch.where(hi | lo, 0.0, x).to(t)
    return torch.where(hi, torch.full((), int(info.max), dtype=t,
                                      device=x.device),
                       torch.where(lo, torch.full((), int(info.min), dtype=t,
                                                  device=x.device),
                                   inner))


def cast_supported(src: dt.DType, tgt: dt.DType) -> bool:
    """Does :func:`_eval_cast` cover ``src -> tgt``?  The planner keeps
    any other cast on the CPU."""
    if src == tgt or src == dt.NULL:
        return True
    if src.is_string or tgt.is_string:
        return False
    return (src.is_temporal and (tgt.is_temporal or tgt.is_numeric)) or \
        ((src.is_bool or src.is_numeric) and (tgt.is_numeric or
                                              tgt.is_bool))


def _eval_cast(e, batch):
    c = evaluate(e.child, batch)
    src, tgt = c.dtype, e.to
    if e.child.dtype == dt.NULL:
        src = dt.NULL
    if src == tgt:
        return ColVal(tgt, c.data, c.validity, c.lengths)
    if src == dt.NULL:
        return _const(batch, None, tgt)
    if src.is_string or tgt.is_string:
        raise NotImplementedError(f"Cast({src.name}->{tgt.name})")
    if src.id == dt.TypeId.DATE32 and tgt.id == dt.TypeId.TIMESTAMP_US:
        return ColVal(tgt, c.data.to(torch.int64) * _US_PER_DAY, c.validity)
    if src.id == dt.TypeId.TIMESTAMP_US and tgt.id == dt.TypeId.DATE32:
        return ColVal(tgt, torch.div(c.data, _US_PER_DAY,
                                     rounding_mode="floor").to(torch.int32),
                      c.validity)
    if src.is_bool and tgt.is_numeric:
        return ColVal(tgt, c.data.to(tgt.to_torch()), c.validity)
    if src.is_numeric and tgt.is_bool:
        return ColVal(tgt, c.data != 0, c.validity)
    if src.is_floating and tgt.is_integral:
        return ColVal(tgt, _float_to_int(c.data, tgt), c.validity)
    if src.is_numeric and tgt.is_numeric:
        return ColVal(tgt, c.data.to(tgt.to_torch()), c.validity)
    if src.is_temporal and tgt.is_numeric:
        if src.id == dt.TypeId.TIMESTAMP_US and tgt.id == dt.TypeId.INT64:
            return ColVal(tgt, torch.div(c.data, 1000 * 1000,
                                         rounding_mode="floor"), c.validity)
        return ColVal(tgt, c.data.to(tgt.to_torch()), c.validity)
    raise NotImplementedError(f"Cast({src.name}->{tgt.name})")


_DISPATCH = {
    ir.Literal: _eval_literal,
    ir.BoundReference: _eval_bound,
    ir.Alias: _eval_alias,
    ir.Add: _eval_add,
    ir.Subtract: _eval_sub,
    ir.Multiply: _eval_mul,
    ir.Divide: _eval_div,
    ir.EqualTo: _mk_cmp("eq"),
    ir.LessThan: _mk_cmp("lt"),
    ir.LessThanOrEqual: _mk_cmp("le"),
    ir.GreaterThan: _mk_cmp("gt"),
    ir.GreaterThanOrEqual: _mk_cmp("ge"),
    ir.And: _eval_and,
    ir.Or: _eval_or,
    ir.Not: _eval_not,
    ir.IsNull: _eval_isnull,
    ir.IsNotNull: _eval_isnotnull,
    ir.Cast: _eval_cast,
}


def supported_on_tpu(cls) -> bool:
    return cls in _DISPATCH
