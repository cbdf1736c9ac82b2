"""Device columnar expression evaluator on torch tensors.

Ported from ``spark_rapids_tpu/expr/eval_tpu.py``: bound references,
literals, aliases, comparisons (Spark's total order for floats: NaN
greatest, NaN == NaN), AND/OR three-valued logic, NOT, IN (a null in the
list makes a miss NULL), ``+ - * /``, ``div``, ``%``, ``pmod``, unary
minus/plus and ``abs`` with Spark's null rules (x / 0 and x % 0 are
NULL; integer overflow wraps), IS [NOT] NULL, ``isnan``,
``coalesce``, ``nanvl``, ``if`` / ``CASE WHEN``, the double math
functions (``log`` of x <= 0 is NULL; ``ceil``/``floor`` saturate to
int64), the three shifts, casts between numeric, boolean and
temporal types, Spark's murmur3 hash (``hash_colval``, the shuffle
exchange's partition key) and the NaN/-0.0 normalization of float join
keys.  The planner keeps every other node on the CPU
(:func:`supported_on_tpu`, read by plan/overrides.py), so a planned query
never reaches the ``NotImplementedError(<node name>)`` that evaluating
one raises.
"""

from __future__ import annotations

import math
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
        row = np.zeros(max_len, dtype=np.uint8)
        row[:len(b)] = np.frombuffer(b, dtype=np.uint8)
        # one row goes to the device; the matrix is filled there
        data = torch.from_numpy(row).to(dev).expand(cap, max_len)
        lengths = torch.full((cap,), len(b), dtype=torch.int32, device=dev)
        valid = torch.full((cap,), value is not None, device=dev)
        return ColVal(dtype, data.contiguous(), valid, lengths)
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


def _is_nan(v: ColVal) -> torch.Tensor:
    if v.dtype.is_floating:
        return torch.isnan(v.data)
    return torch.zeros_like(v.validity)


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


def _floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer floor division of ``a`` by a nonzero ``b`` that wraps
    MIN // -1 to MIN (as XLA does) instead of trapping."""
    neg1 = b == -1
    q = torch.div(a, torch.where(neg1, 1, b), rounding_mode="floor")
    return torch.where(neg1, -a, q)


def _eval_idiv(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    a = l.data.to(torch.int64)
    b = r.data.to(torch.int64)
    nz = b != 0
    bb = torch.where(nz, b, 1)
    # Spark `div` truncates toward zero; the floor quotient is fixed up
    q = _floor_div(a, bb)
    rem = a - q * bb
    q = torch.where((rem != 0) & ((a < 0) != (b < 0)), q + 1, q)
    return ColVal(e.dtype, torch.where(nz, q, 0), _binary_null(l, r) & nz)


def _trunc_mod(a, b, floating):
    if floating:
        nz = b != 0.0
        bb = torch.where(nz, b, 1.0)
        return torch.fmod(a, bb), nz  # fmod truncates like Spark's %
    nz = b != 0
    bb = torch.where(nz, b, 1)
    q = _floor_div(a, bb)
    rem = a - q * bb
    # floored remainder -> truncated remainder
    fix = (rem != 0) & ((a < 0) != (b < 0))
    return torch.where(fix, rem - b, rem), nz


def _eval_mod(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    a, b = _promote_pair(e, l, r)
    m, nz = _trunc_mod(a, b, e.dtype.is_floating)
    return ColVal(e.dtype, torch.where(nz, m, 0), _binary_null(l, r) & nz)


def _eval_pmod(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    a, b = _promote_pair(e, l, r)
    m, nz = _trunc_mod(a, b, e.dtype.is_floating)
    m = torch.where((m != 0) & ((m < 0) != (b < 0)), m + b, m)
    return ColVal(e.dtype, torch.where(nz, m, 0), _binary_null(l, r) & nz)


def _eval_neg(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(e.dtype, -c.data, c.validity)


def _eval_pos(e, batch):
    return evaluate(e.child, batch)


def _eval_abs(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(e.dtype, torch.abs(c.data), c.validity)


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


def _eval_in(e, batch):
    v = evaluate(e.children[0], batch)
    hit = torch.zeros_like(v.validity)
    has_null_item = any(i is None for i in e.items)
    for item in e.items:
        if item is not None:
            hit = hit | _cmp_vals(v, _const(batch, item, v.dtype), "eq")
    # Spark: no match in a list that holds a null -> NULL
    valid = v.validity & (hit | (not has_null_item))
    return ColVal(dt.BOOL, hit, valid)


def _eval_isnull(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(dt.BOOL, ~c.validity & batch.row_mask(),
                  torch.ones_like(c.validity))


def _eval_isnotnull(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(dt.BOOL, c.validity, torch.ones_like(c.validity))


# ---------------------------------------------------------------------------
# nulls & conditionals
# ---------------------------------------------------------------------------

def _eval_isnan(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(dt.BOOL, _is_nan(c) & c.validity,
                  torch.ones_like(c.validity))


def _eval_at_least_n_non_nulls(e, batch):
    count = torch.zeros((batch.capacity,), dtype=torch.int32,
                        device=batch.device)
    for c in e.children:
        v = evaluate(c, batch)
        count = count + (v.validity & ~_is_nan(v)).to(torch.int32)
    return ColVal(dt.BOOL, count >= e.n, torch.ones_like(count,
                                                        dtype=torch.bool))


def _pad_width(a: torch.Tensor, w: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, w - a.shape[1]))


def _merge_branch(dtype, data, lengths, valid, cond, v: ColVal):
    """where(cond) take branch value v."""
    if dtype.is_string:
        w = max(data.shape[1], v.data.shape[1])
        data = torch.where(cond[:, None], _pad_width(v.data, w),
                           _pad_width(data, w))
        lengths = torch.where(cond, v.lengths, lengths)
    else:
        data = torch.where(cond, v.data.to(data.dtype), data)
    valid = torch.where(cond, v.validity, valid)
    return data, lengths, valid


def _eval_coalesce(e, batch):
    vals = [evaluate(c, batch) for c in e.children]
    out = vals[0]
    data = out.data if e.dtype.is_string else out.data.to(e.dtype.to_torch())
    valid, lengths = out.validity, out.lengths
    for v in vals[1:]:
        data, lengths, _ = _merge_branch(e.dtype, data, lengths, valid,
                                         ~valid & v.validity, v)
        valid = valid | v.validity
    return ColVal(e.dtype, data, valid, lengths)


def _eval_nanvl(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    a, b = _promote_pair(e, l, r)
    use_b = torch.isnan(a)
    return ColVal(e.dtype, torch.where(use_b, b, a),
                  torch.where(use_b, r.validity, l.validity))


def _eval_if(e, batch):
    p = evaluate(e.children[0], batch)
    t = evaluate(e.children[1], batch)
    f = evaluate(e.children[2], batch)
    cond = p.data & p.validity
    if e.dtype.is_string:
        data, lengths, valid = _merge_branch(e.dtype, f.data, f.lengths,
                                             f.validity, cond, t)
        return ColVal(e.dtype, data, valid, lengths)
    tgt = e.dtype.to_torch()
    return ColVal(e.dtype, torch.where(cond, t.data.to(tgt), f.data.to(tgt)),
                  torch.where(cond, t.validity, f.validity))


def _eval_casewhen(e, batch):
    els = e.else_value()
    cur = evaluate(els, batch) if els is not None else \
        _const(batch, None, e.dtype)
    data = cur.data if e.dtype.is_string else cur.data.to(e.dtype.to_torch())
    lengths, valid = cur.lengths, cur.validity
    undecided = torch.ones((batch.capacity,), dtype=torch.bool,
                           device=batch.device)
    # first match wins, walking the branches in order
    for cond_e, val_e in e.branches():
        c = evaluate(cond_e, batch)
        v = evaluate(val_e, batch)
        hit = c.data & c.validity
        data, lengths, valid = _merge_branch(e.dtype, data, lengths, valid,
                                             undecided & hit, v)
        undecided = undecided & ~hit
    return ColVal(e.dtype, data, valid, lengths)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

def _mk_double_unary(fn):
    def f(e, batch):
        c = evaluate(e.child, batch)
        return ColVal(e.dtype, fn(c.data.to(torch.float64)), c.validity)
    return f


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no cbrt): |x|^(1/3) with the sign, one
    Newton step to the last ulps; 0, inf and NaN pass through."""
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    ok = torch.isfinite(y) & (y != 0)
    ys = torch.where(ok, y, 1.0)
    # y - (y^3 - x) / (3 y^2), arranged so that no power of y overflows
    return torch.where(ok, ys + (x / (ys * ys) - ys) / 3.0, x)


def _signum(x: torch.Tensor) -> torch.Tensor:
    """Math.signum: NaN and signed zeros are their own sign (torch.sign
    maps NaN to 0)."""
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


def _mk_log(base_log: float, lower: float, log_fn=torch.log):
    """Spark's log family: NULL outside the domain (x <= ``lower``)."""
    def f(e, batch):
        c = evaluate(e.child, batch)
        x = c.data.to(torch.float64)
        ok = x > lower
        out = log_fn(torch.where(ok, x, lower + 1.0))
        if base_log != 1.0:
            out = out / base_log
        return ColVal(e.dtype, torch.where(ok, out, 0.0), c.validity & ok)
    return f


def _f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """Java (long) cast semantics: NaN -> 0, saturate exactly at the
    int64 bounds (float64 cannot represent INT64_MAX)."""
    imin, imax = int(np.iinfo(np.int64).min), int(np.iinfo(np.int64).max)
    x = torch.nan_to_num(x, nan=0.0, posinf=float("inf"),
                         neginf=float("-inf"))
    hi = x >= 2.0 ** 63
    lo = x <= -(2.0 ** 63)
    safe = torch.clamp(x, -(2.0 ** 63),
                       float(np.nextafter(2.0 ** 63, 0))).to(torch.int64)
    return torch.where(hi, imax, torch.where(lo, imin, safe))


def _mk_round_to_long(fn):
    def f(e, batch):
        c = evaluate(e.child, batch)
        return ColVal(e.dtype, _f64_to_i64(fn(c.data.to(torch.float64))),
                      c.validity)
    return f


def _mk_double_binary(fn):
    def f(e, batch):
        l, r = evaluate(e.left, batch), evaluate(e.right, batch)
        return ColVal(e.dtype, fn(l.data.to(torch.float64),
                                  r.data.to(torch.float64)),
                      _binary_null(l, r))
    return f


def _shift_amount(l: ColVal, r: ColVal) -> torch.Tensor:
    return (r.data.to(torch.int32) % (l.data.element_size() * 8)).to(
        l.data.dtype)


def _eval_shiftleft(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    return ColVal(e.dtype, l.data << _shift_amount(l, r), _binary_null(l, r))


def _eval_shiftright(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    return ColVal(e.dtype, l.data >> _shift_amount(l, r), _binary_null(l, r))


def _eval_shiftright_unsigned(e, batch):
    """Logical right shift: the arithmetic shift with the copies of the
    sign bit masked off (torch has no unsigned 64-bit shift on every
    device)."""
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    nbits = l.data.element_size() * 8
    sh = _shift_amount(l, r)
    # (1 << (nbits - sh)) - 1, wrapping at sh == 1; unused at sh == 0
    mask = (torch.ones_like(sh) << (nbits - sh)) - 1
    out = torch.where(sh == 0, l.data, (l.data >> sh) & mask)
    return ColVal(e.dtype, out, _binary_null(l, r))


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


# ---------------------------------------------------------------------------
# hash: Spark-compatible murmur3_x86_32 (seed 42), vectorized
# ---------------------------------------------------------------------------
#
# The reference computes in wrapping int32 and casts to uint32 for every
# logical shift.  torch's >> on int32 is arithmetic and its uint32 cover
# is thin, so here every 32-bit word is held unsigned in int64: products
# are taken in 16-bit halves (no intermediate leaves int64), shifts are
# logical because the values are non-negative, and the result is folded
# back to signed int32 once.

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c < 2^32."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h = h1 ^ length
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit word of an int32 (or the low word of an int64),
    unsigned, in int64."""
    return x.to(torch.int64) & _M32


def _signed(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def _hash_int(v32: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return _fmix(_mix_h1(seed, _mix_k1(_u32(v32))), 4)


def _hash_long(v64: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v64 = v64.to(torch.int64)
    h1 = _mix_h1(seed, _mix_k1(v64 & _M32))
    h1 = _mix_h1(h1, _mix_k1((v64 >> 32) & _M32))
    return _fmix(h1, 8)


def _hash_bytes(data: torch.Tensor, lengths: torch.Tensor,
                seed: torch.Tensor) -> torch.Tensor:
    """Spark hashUnsafeBytes over each row of a ``[rows, w]`` byte
    matrix: the full 4-byte words little-endian and unsigned, then the
    (at most three) tail bytes one at a time, each SIGN-extended."""
    rows, w = data.shape
    nwords = (w + 3) // 4
    b = torch.nn.functional.pad(data, (0, nwords * 4 - w)).to(torch.int64)
    lengths = lengths.to(torch.int64)
    h1 = seed
    for wi in range(nwords):
        word = (b[:, 4 * wi] | (b[:, 4 * wi + 1] << 8) |
                (b[:, 4 * wi + 2] << 16) | (b[:, 4 * wi + 3] << 24))
        h1 = torch.where(lengths >= 4 * (wi + 1),
                         _mix_h1(h1, _mix_k1(word)), h1)
    # the tail bytes, in ascending position (the reference walks every
    # position and keeps those past the last full word)
    tail0 = (lengths // 4) * 4
    for t in range(3):
        pos = tail0 + t
        in_tail = pos < lengths
        byte = torch.gather(b, 1, torch.clamp(pos, 0, b.shape[1] - 1)
                            .reshape(-1, 1)).reshape(-1) if b.shape[1] \
            else torch.zeros_like(lengths)
        byte = torch.where(byte >= 128, byte | 0xFFFFFF00, byte)
        h1 = torch.where(in_tail, _mix_h1(h1, _mix_k1(byte)), h1)
    return _fmix(h1, lengths & _M32)


def hash_colval(v: ColVal, seed: torch.Tensor) -> torch.Tensor:
    """One murmur3 step for one column over int32 seeds; a null keeps the
    previous seed (Spark skips null columns)."""
    d = v.dtype
    s = _u32(seed)
    if d.is_string:
        h = _hash_bytes(v.data, v.lengths, s)
    elif d.id in (dt.TypeId.INT64, dt.TypeId.TIMESTAMP_US):
        h = _hash_long(v.data, s)
    elif d.id == dt.TypeId.FLOAT64:
        x = torch.where(v.data == 0.0, 0.0, v.data)      # -0.0 -> 0.0
        x = torch.where(torch.isnan(x), math.nan, x)     # canonical NaN
        h = _hash_long(x.view(torch.int64), s)
    elif d.id == dt.TypeId.FLOAT32:
        x = torch.where(v.data == 0.0, 0.0, v.data)
        x = torch.where(torch.isnan(x), math.nan, x)
        h = _hash_int(x.view(torch.int32), s)
    else:  # bool, int8/16/32 and date32 hash as int
        h = _hash_int(v.data.to(torch.int32), s)
    return torch.where(v.validity, _signed(h), seed)


def _eval_murmur3(e: ir.Murmur3Hash, batch):
    h = torch.full((batch.capacity,), e.seed, dtype=torch.int32,
                   device=batch.device)
    for c in e.children:
        h = hash_colval(evaluate(c, batch), h)
    return ColVal(dt.INT32, h, torch.ones(batch.capacity, dtype=torch.bool,
                                          device=batch.device))


def _eval_knownfloat(e, batch):
    c = evaluate(e.child, batch)
    if c.dtype.is_floating:
        x = torch.where(torch.isnan(c.data), math.nan, c.data)
        x = torch.where(x == 0.0, 0.0, x)                # -0.0 -> +0.0
        return ColVal(c.dtype, x.to(c.data.dtype), c.validity)
    return c


_DISPATCH = {
    ir.Literal: _eval_literal,
    ir.BoundReference: _eval_bound,
    ir.Alias: _eval_alias,
    ir.Add: _eval_add,
    ir.Subtract: _eval_sub,
    ir.Multiply: _eval_mul,
    ir.Divide: _eval_div,
    ir.IntegralDivide: _eval_idiv,
    ir.Remainder: _eval_mod,
    ir.Pmod: _eval_pmod,
    ir.UnaryMinus: _eval_neg,
    ir.UnaryPositive: _eval_pos,
    ir.Abs: _eval_abs,
    ir.EqualTo: _mk_cmp("eq"),
    ir.LessThan: _mk_cmp("lt"),
    ir.LessThanOrEqual: _mk_cmp("le"),
    ir.GreaterThan: _mk_cmp("gt"),
    ir.GreaterThanOrEqual: _mk_cmp("ge"),
    ir.And: _eval_and,
    ir.Or: _eval_or,
    ir.Not: _eval_not,
    ir.In: _eval_in,
    ir.IsNull: _eval_isnull,
    ir.IsNotNull: _eval_isnotnull,
    ir.IsNan: _eval_isnan,
    ir.Coalesce: _eval_coalesce,
    ir.AtLeastNNonNulls: _eval_at_least_n_non_nulls,
    ir.NaNvl: _eval_nanvl,
    ir.If: _eval_if,
    ir.CaseWhen: _eval_casewhen,
    ir.Sqrt: _mk_double_unary(torch.sqrt),
    ir.Exp: _mk_double_unary(torch.exp),
    ir.Log: _mk_log(1.0, 0.0),
    ir.Log2: _mk_log(math.log(2.0), 0.0),
    ir.Log10: _mk_log(math.log(10.0), 0.0),
    ir.Log1p: _mk_log(1.0, -1.0, torch.log1p),
    ir.Expm1: _mk_double_unary(torch.expm1),
    ir.Sin: _mk_double_unary(torch.sin),
    ir.Cos: _mk_double_unary(torch.cos),
    ir.Tan: _mk_double_unary(torch.tan),
    ir.Sinh: _mk_double_unary(torch.sinh),
    ir.Cosh: _mk_double_unary(torch.cosh),
    ir.Tanh: _mk_double_unary(torch.tanh),
    ir.Asin: _mk_double_unary(torch.asin),
    ir.Acos: _mk_double_unary(torch.acos),
    ir.Atan: _mk_double_unary(torch.atan),
    ir.Cbrt: _mk_double_unary(_cbrt),
    ir.ToDegrees: _mk_double_unary(torch.rad2deg),
    ir.ToRadians: _mk_double_unary(torch.deg2rad),
    ir.Rint: _mk_double_unary(torch.round),
    ir.Signum: _mk_double_unary(_signum),
    ir.Ceil: _mk_round_to_long(torch.ceil),
    ir.Floor: _mk_round_to_long(torch.floor),
    ir.Pow: _mk_double_binary(torch.pow),
    ir.Atan2: _mk_double_binary(torch.atan2),
    ir.ShiftLeft: _eval_shiftleft,
    ir.ShiftRight: _eval_shiftright,
    ir.ShiftRightUnsigned: _eval_shiftright_unsigned,
    ir.Cast: _eval_cast,
    ir.Murmur3Hash: _eval_murmur3,
    ir.KnownFloatingPointNormalized: _eval_knownfloat,
}


def supported_on_tpu(cls) -> bool:
    return cls in _DISPATCH
