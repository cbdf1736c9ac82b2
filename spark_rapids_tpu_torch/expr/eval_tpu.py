"""Device columnar expression evaluator on torch tensors.

Ported from ``spark_rapids_tpu/expr/eval_tpu.py``: bound references,
literals, aliases, comparisons (Spark's total order for floats: NaN
greatest, NaN == NaN), AND/OR three-valued logic, NOT, IN (a null in the
list makes a miss NULL), ``+ - * /``, ``div``, ``%``, ``pmod``, unary
minus/plus and ``abs`` with Spark's null rules (x / 0 and x % 0 are
NULL; integer overflow wraps), IS [NOT] NULL, ``isnan``,
``coalesce``, ``nanvl``, ``if`` / ``CASE WHEN``, the double math
functions (``log`` of x <= 0 is NULL; ``ceil``/``floor`` saturate to
int64), the three shifts, casts between numeric, boolean, temporal and
string types (string -> int/float/bool/date/timestamp and
int/bool/float/date/timestamp -> string; float -> string is Ryu's
shortest decimal, ``expr/ryu.py``), the string functions (case, length,
reverse, substring, the literal and column-needle searches, LIKE,
concat, the trims, initcap, locate and the pads) over fixed-width byte
matrices, RLIKE and regexp_replace (``expr/device_regex.py``'s bitmask
NFA, or the literal-needle scan), md5, the UTC date/time fields and date
arithmetic, Spark's murmur3 hash (``hash_colval``, the shuffle
exchange's partition key), the NaN/-0.0 normalization of float join
keys, the partition leaves (``spark_partition_id()``,
``monotonically_increasing_id()``, read from exec/context.py), ``rand``
(jax's threefry-2x32 uniform, bit for bit) and the list group (size,
item, contains, element_at, array).  The dispatch table has the
reference's keys.  The planner keeps a node the evaluator cannot run on
the CPU (:func:`supported_on_tpu`, :func:`cast_supported` and the
literal-argument checks of plan/overrides.py), so a planned query never
reaches the ``NotImplementedError`` that evaluating one raises.
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
# byte-matrix helpers
# ---------------------------------------------------------------------------
#
# A string column is a ``[rows, w]`` uint8 matrix, zero past each row's
# length, with int32 lengths.  The reference's ``jnp.argmax`` over a bool
# matrix, ``[:, ::-1]`` views and ``take_along_axis`` become the helpers
# below; a ``[rows]`` position is clipped into the matrix before it is read,
# as the reference clips it.

def _iota(w: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(w, device=like.device)


def longest(lengths: torch.Tensor) -> int:
    """The longest row (one host read).  The per-position loops below
    (md5's blocks, the regex steps, regexp_replace's greedy scans) stop
    there: past it every row is padding, where a step changes nothing,
    so the result is the reference's full-width one, bit for bit."""
    return int(lengths.max()) if lengths.numel() else 0


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Per row, the index of the first True (0 where there is none):
    ``jnp.argmax``'s first-maximum rule, through uint8 (torch's argmax
    takes no bool)."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Per row, the index of the last True (w - 1 where there is none)."""
    return (mask.shape[1] - 1) - _first_true(torch.flip(mask, (1,)))


def _at_many(data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``data[r, clip(pos[r, k], 0, w - 1)]``: a ``[rows, k]`` matrix of
    positions in one gather."""
    p = torch.clamp(pos, 0, data.shape[1] - 1).to(torch.int64)
    return torch.gather(data, 1, p)


def _at(data: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``data[r, clip(pos[r], 0, w - 1)]`` per row."""
    return _at_many(data, pos[:, None])[:, 0]


def _offsets_from(start: torch.Tensor, k: int) -> torch.Tensor:
    """``[rows, k]``: start[r] + 0 .. k - 1."""
    return start[:, None].to(torch.int64) + _iota(k, start)[None, :]


def _word_at(data: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
             words) -> torch.Tensor:
    """Rows whose span [start, end) is one of ``words``, ASCII case
    insensitive (the reference matches each word byte by byte from
    ``start``; here one gather serves every word)."""
    m = max(len(wd) for wd in words)
    got = _at_many(data, _offsets_from(start, m)) | 0x20
    out = torch.zeros_like(start, dtype=torch.bool)
    for wd in words:
        want = torch.tensor([b | 0x20 for b in wd], dtype=torch.uint8,
                            device=data.device)
        out = out | (((end - start) == len(wd)) &
                     torch.all(got[:, :len(wd)] == want, dim=1))
    return out


# ---------------------------------------------------------------------------
# cast (numeric, boolean, temporal and string)
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
    if src.is_string:
        return tgt.is_integral or tgt.is_floating or tgt.is_bool or \
            tgt.id in (dt.TypeId.DATE32, dt.TypeId.TIMESTAMP_US)
    if tgt.is_string:
        return src.is_bool or src.is_integral or src.is_floating or \
            src.id in (dt.TypeId.DATE32, dt.TypeId.TIMESTAMP_US)
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
    if not cast_supported(src, tgt):
        raise NotImplementedError(f"Cast({src.name}->{tgt.name})")
    if src.is_string:
        if tgt.is_integral:
            return _cast_string_to_int(c, tgt)
        if tgt.is_floating:
            return _cast_string_to_float(c, tgt)
        if tgt.is_bool:
            return _cast_string_to_bool(c)
        if tgt.id == dt.TypeId.DATE32:
            return _cast_string_to_date(c)
        return _cast_string_to_timestamp(c)
    if tgt.is_string:
        if src.is_bool:
            return _cast_bool_to_string(c)
        if src.is_integral:
            return _cast_int_to_string(c)
        if src.is_floating:
            return _cast_float_to_string(c)
        if src.id == dt.TypeId.DATE32:
            return _cast_date_to_string(c)
        return _cast_timestamp_to_string(c)
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
    # temporal -> numeric
    if src.id == dt.TypeId.TIMESTAMP_US and tgt.id == dt.TypeId.INT64:
        return ColVal(tgt, torch.div(c.data, 1000 * 1000,
                                     rounding_mode="floor"), c.validity)
    return ColVal(tgt, c.data.to(tgt.to_torch()), c.validity)


def _pow10_table(n: int, like: torch.Tensor) -> torch.Tensor:
    """10^0 .. 10^(n-1) mod 2^64, as int64."""
    vals = [(10 ** k) % (1 << 64) for k in range(n)]
    return torch.tensor([v - (1 << 64) if v >= (1 << 63) else v
                         for v in vals], dtype=torch.int64,
                        device=like.device)


_P10_LO, _P10_HI = -400, 400


def _pow10_f64(like: torch.Tensor) -> torch.Tensor:
    """10^k for k in [-400, 400], correctly rounded to float64 (Python's
    int division and int -> float conversion round exactly): 0 below
    10^-323, inf above 10^308.  A table read gives the same bits on every
    device; a device ``pow`` need not (the reference's XLA pow is an ulp
    off at some exponents, e.g. 10^-5 and 10^23, and flushes 10^-308 and
    below to 0)."""
    vals = [1 / 10 ** -k if k < 0 else
            (float(10 ** k) if k <= 308 else math.inf)
            for k in range(_P10_LO, _P10_HI + 1)]
    return torch.tensor(vals, dtype=torch.float64, device=like.device)


def _cast_string_to_int(c: ColVal, tgt: dt.DType) -> ColVal:
    """Optionally signed decimal integers, trimmed of spaces first (the
    reference trims ' ' only here).  The reference's Horner loop over the
    width is one sum here: its multiply-adds wrap mod 2^64, so
    ``sum(d_j * 10^(end - 1 - j))`` equals it bit for bit, overflow
    included."""
    data, lengths = c.data, c.lengths
    w = data.shape[1]
    idx = _iota(w, data)[None, :]
    non_space = (idx < lengths[:, None]) & (data != ord(" "))
    any_ns = torch.any(non_space, dim=1)
    t_start = torch.where(any_ns, _first_true(non_space), 0)
    t_end = torch.where(any_ns, _last_true(non_space) + 1, 0)
    first = _at(data, t_start)
    neg = first == ord("-")
    start = t_start + ((first == ord("-")) | (first == ord("+"))).to(
        t_start.dtype)
    in_range = (idx >= start[:, None]) & (idx < t_end[:, None])
    digit = data.to(torch.int64) - ord("0")
    is_digit = (digit >= 0) & (digit <= 9)
    ok = torch.all(~in_range | is_digit, dim=1) & (t_end > start)
    power = _pow10_table(w, data)[torch.clamp(t_end[:, None] - 1 - idx, 0)]
    acc = torch.where(in_range, digit * power, 0).sum(dim=1)
    acc = torch.where(neg, -acc, acc)
    return ColVal(tgt, acc.to(tgt.to_torch()), c.validity & ok)


def _trimmed(c: ColVal):
    """(start, end) of the whitespace-trimmed span per row (ASCII
    whitespace set of str.strip(): space, \\t, \\n, \\r, \\v, \\f)."""
    data, lengths = c.data, c.lengths
    idx = _iota(data.shape[1], data)[None, :]
    is_ws = (data == 32) | ((data >= 9) & (data <= 13))
    non_space = (idx < lengths[:, None]) & ~is_ws
    any_ns = torch.any(non_space, dim=1)
    start = torch.where(any_ns, _first_true(non_space), 0)
    end = torch.where(any_ns, _last_true(non_space) + 1, 0)
    return start, end


def _cast_string_to_float(c: ColVal, tgt: dt.DType) -> ColVal:
    """[+-]digits[.digits][eE[+-]digits], plus Infinity/NaN keywords
    (invalid -> null).  The mantissa keeps the reference's Horner order
    (a float sum in another order rounds differently); the fraction's
    digit count and the exponent are sums; the scale is a correctly
    rounded power of ten from a table (:func:`_pow10_f64`), where the
    reference calls pow."""
    data = c.data
    w = data.shape[1]
    idx = _iota(w, data)[None, :]
    t_start, t_end = _trimmed(c)
    first = _at(data, t_start)
    neg = first == ord("-")
    start = t_start + (neg | (first == ord("+"))).to(t_start.dtype)
    is_inf = _word_at(data, start, t_end, (b"infinity", b"inf"))
    is_nan = _word_at(data, t_start, t_end, (b"nan",))

    digit = data.to(torch.int64) - ord("0")
    is_digit = (digit >= 0) & (digit <= 9)
    is_dot = data == ord(".")
    is_e = (data == ord("e")) | (data == ord("E"))
    in_tok = (idx >= start[:, None]) & (idx < t_end[:, None])
    e_pos = torch.where(is_e & in_tok, idx, w).amin(dim=1)
    mant_end = torch.minimum(t_end, e_pos)
    in_mant = in_tok & (idx < mant_end[:, None])
    dot_pos = torch.where(is_dot & in_mant, idx, w).amin(dim=1)
    # exponent part: optional sign then digits
    es = e_pos + 1
    efirst = _at(data, es)
    eneg = efirst == ord("-")
    es = es + ((efirst == ord("-")) | (efirst == ord("+"))).to(es.dtype)
    in_exp = (idx >= es[:, None]) & (idx < t_end[:, None])

    legal = ~in_mant | is_digit | is_dot
    legal_e = ~in_exp | is_digit
    one_dot = torch.sum(is_dot & in_mant, dim=1) <= 1
    has_digit = torch.any(is_digit & in_mant, dim=1)
    has_exp = e_pos < w
    exp_digits = torch.any(is_digit & in_exp, dim=1)
    ok = (torch.all(legal, dim=1) & torch.all(legal_e, dim=1) & one_dot &
          has_digit & (t_end > start) &
          (~has_exp | (exp_digits & (e_pos < t_end))))

    take = is_digit & in_mant
    mant = torch.zeros((data.shape[0],), dtype=torch.float64,
                       device=data.device)
    dig_f = digit.to(torch.float64)
    for j in range(w):
        mant = torch.where(take[:, j], mant * 10 + dig_f[:, j], mant)
    frac_n = torch.sum(take & (idx > dot_pos[:, None]), dim=1)
    # the reference's saturating Horner min(e * 10 + d, 99999) is the
    # exponent's value capped at 99999: a nonzero digit at a power >= 5
    # caps it, the rest fits in int64
    te = is_digit & in_exp
    k = t_end[:, None] - 1 - idx
    big = torch.any(te & (k >= 5) & (digit > 0), dim=1)
    small = torch.where(te & (k < 5),
                        digit * _pow10_table(5, data)[torch.clamp(k, 0, 4)],
                        0).sum(dim=1)
    exp_v = torch.where(big, 99999, torch.clamp(small, max=99999))
    exp_v = torch.where(eneg & has_exp, -exp_v, exp_v)
    p10 = torch.clamp(exp_v - frac_n, _P10_LO, _P10_HI) - _P10_LO
    v = mant * _pow10_f64(mant)[p10]
    v = torch.where(is_inf, math.inf, v)
    v = torch.where(neg, -v, v)
    v = torch.where(is_nan, math.nan, v)
    ok = ok | is_inf | is_nan
    v = torch.where(ok, v, 0.0)
    return ColVal(tgt, v.to(tgt.to_torch()), c.validity & ok)


def _cast_string_to_bool(c: ColVal) -> ColVal:
    """Spark StringUtils: t/true/y/yes/1 and f/false/n/no/0."""
    t_start, t_end = _trimmed(c)
    is_t = _word_at(c.data, t_start, t_end,
                    (b"t", b"true", b"y", b"yes", b"1"))
    is_f = _word_at(c.data, t_start, t_end,
                    (b"f", b"false", b"n", b"no", b"0"))
    return ColVal(dt.BOOL, is_t, c.validity & (is_t | is_f))


def _digits_value(b: torch.Tensor):
    """(value, all digits) of a ``[rows, k]`` byte matrix read as one
    decimal number, in int32 (the reference's Horner loop; k <= 4)."""
    d = b.to(torch.int32) - ord("0")
    ok = torch.all((d >= 0) & (d <= 9), dim=1)
    v = torch.zeros_like(d[:, 0])
    for j in range(d.shape[1]):
        v = v * 10 + d[:, j]
    return v, ok


def _parse_ymd(c: ColVal):
    """'yyyy-MM-dd' (4-2-2 fixed layout) -> (y, m, d, ok, end_pos,
    t_end), int32."""
    t_start, t_end = _trimmed(c)
    b = _at_many(c.data, _offsets_from(t_start, 10))
    y, ok_y = _digits_value(b[:, 0:4])
    m, ok_m = _digits_value(b[:, 5:7])
    d, ok_d = _digits_value(b[:, 8:10])
    ok = (ok_y & ok_m & ok_d & (b[:, 4] == ord("-")) &
          (b[:, 7] == ord("-")) & ((t_end - t_start) >= 10) &
          (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31))
    # calendar-exact day check (Feb 30, Apr 31, non-leap Feb 29, ...):
    # round-trip through the civil-days conversion and compare
    days = _days_from_civil(y, m, d)
    y2, m2, d2 = _civil_from_days(days)
    ok = ok & (y2 == y) & (m2 == m) & (d2 == d)
    return y, m, d, ok, t_start + 10, t_end


def _cast_string_to_date(c: ColVal) -> ColVal:
    y, m, d, ok, end10, t_end = _parse_ymd(c)
    ok = ok & (t_end == end10)    # exact 'yyyy-MM-dd'
    days = torch.where(ok, _days_from_civil(y, m, d), 0)
    return ColVal(dt.DATE32, days.to(torch.int32), c.validity & ok)


def _cast_string_to_timestamp(c: ColVal) -> ColVal:
    """'yyyy-MM-dd[ HH:mm:ss[.f{1..6}]]' in UTC (the incompat UTC-only
    surface gated by castStringToTimestamp.enabled).  The days take their
    seconds in int64: the reference multiplies the int32 days by 86400 in
    int32, which wraps outside 1901-12-14 .. 2038-01-19."""
    y, m, d, ok, pos10, t_end = _parse_ymd(c)
    b = _at_many(c.data, _offsets_from(pos10, 16))
    has_time = t_end > pos10
    sep_ok = (b[:, 0] == ord(" ")) | (b[:, 0] == ord("T"))
    hh, ok_h = _digits_value(b[:, 1:3])
    mm, ok_mi = _digits_value(b[:, 4:6])
    ss, ok_s = _digits_value(b[:, 7:9])
    colon_ok = (b[:, 3] == ord(":")) & (b[:, 6] == ord(":"))
    time_ok = sep_ok & ok_h & ok_mi & ok_s & colon_ok & \
        (hh < 24) & (mm < 60) & (ss < 60) & ((t_end - pos10) >= 9)
    # optional .fraction (1-6 digits): every digit before t_end, in order
    dot_ok = b[:, 9] == ord(".")
    fd = b[:, 10:16].to(torch.int64) - ord("0")
    p = pos10[:, None] + 10 + _iota(6, b)[None, :]
    tk = (p < t_end[:, None]) & (fd >= 0) & (fd <= 9)
    micros = torch.zeros_like(fd[:, 0])
    for k in range(6):
        micros = torch.where(tk[:, k], micros * 10 + fd[:, k], micros)
    fdigits = torch.sum(tk, dim=1)
    has_frac = has_time & (t_end > (pos10 + 9))
    frac_ok = ~has_frac | (dot_ok & (fdigits == (t_end - pos10 - 10)) &
                           (fdigits >= 1) & (fdigits <= 6))
    micros = micros * _pow10_table(7, b)[6 - fdigits]
    hh = torch.where(has_time, hh, 0)
    mm = torch.where(has_time, mm, 0)
    ss = torch.where(has_time, ss, 0)
    micros = torch.where(has_time, micros, 0)
    ok = ok & (~has_time | (time_ok & frac_ok))
    days = _days_from_civil(y, m, d).to(torch.int64)
    us = (days * 86400 + hh.to(torch.int64) * 3600 +
          mm.to(torch.int64) * 60 + ss.to(torch.int64)) * 1000000 + micros
    us = torch.where(ok, us, 0)
    return ColVal(dt.TIMESTAMP_US, us, c.validity & ok)


def _digits_matrix(v: torch.Tensor, width: int):
    """|v| -> right-aligned digit matrix [n, width] + digit count.  The
    reference takes |v| in uint64 to survive INT64_MIN; here each digit
    is |trunc(v / 10^k) fmod 10| in int64, exact at INT64_MIN."""
    powers = _pow10_table(width, v).flip(0)       # 10^(width-1) .. 10^0
    q = torch.div(v[:, None], powers[None, :], rounding_mode="trunc")
    mat = (torch.fmod(q, 10).abs() + ord("0")).to(torch.uint8)
    nz = mat != ord("0")
    ndig = torch.where(torch.any(nz, dim=1), width - _first_true(nz), 1)
    return mat, ndig.to(torch.int32)


def _left_align(mat: torch.Tensor, start: torch.Tensor,
                out_w: int) -> torch.Tensor:
    """Gather columns starting at per-row offset into [n, out_w]."""
    return _at_many(mat, _offsets_from(start, out_w))


def _cast_int_to_string(c: ColVal) -> ColVal:
    v = c.data.to(torch.int64)
    mat, ndig = _digits_matrix(v, 19)   # int64 abs max has 19 digits
    neg = v < 0
    n, out_w = v.shape[0], 20
    body = _left_align(mat, mat.shape[1] - ndig, out_w - 1)
    minus = torch.full((n, 1), ord("-"), dtype=torch.uint8, device=v.device)
    data = torch.where(neg[:, None], torch.cat([minus, body], dim=1),
                       _pad_width(body, out_w))
    lens = ndig + neg.to(torch.int32)
    keep = _iota(out_w, v)[None, :] < lens[:, None]
    data = torch.where(keep & c.validity[:, None], data, 0)
    return ColVal(dt.STRING, data, c.validity,
                  torch.where(c.validity, lens, 0))


def _cast_float_to_string(c: ColVal) -> ColVal:
    """Python's ``repr``: the shortest decimal that reads back to the
    same double (expr/ryu.py).  float32 widens to float64 first: the CPU
    oracle is ``repr(float(x))``, which sees the widened double."""
    from spark_rapids_tpu_torch.expr import ryu
    data, lens = ryu.f64_to_string(c.data.to(torch.float64), c.validity)
    return ColVal(dt.STRING, data, c.validity, lens)


def _cast_bool_to_string(c: ColVal) -> ColVal:
    dev = c.data.device
    t = torch.tensor(list(b"true\0"), dtype=torch.uint8, device=dev)
    f = torch.tensor(list(b"false"), dtype=torch.uint8, device=dev)
    b = c.data.to(torch.bool)
    data = torch.where(b[:, None], t[None, :], f[None, :])
    lens = torch.where(b, 4, 5).to(torch.int32)
    keep = _iota(5, data)[None, :] < lens[:, None]
    data = torch.where(keep & c.validity[:, None], data, 0)
    return ColVal(dt.STRING, data, c.validity,
                  torch.where(c.validity, lens, 0))


def _decimal(v: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` decimal digits of int64 ``v`` (floored, as the
    reference's ``v // 10^k % 10``) as ``[rows, n]`` ASCII bytes."""
    powers = _pow10_table(n, v).flip(0)
    return (v.to(torch.int64)[:, None] // powers[None, :] % 10 +
            ord("0")).to(torch.uint8)


def _cast_date_to_string(c: ColVal) -> ColVal:
    y, m, d = _civil_from_days(c.data)
    n = c.data.shape[0]
    dash = torch.full((n, 1), ord("-"), dtype=torch.uint8,
                      device=c.data.device)
    data = torch.cat([_decimal(y, 4), dash, _decimal(m, 2), dash,
                      _decimal(d, 2)], dim=1)
    data = torch.where(c.validity[:, None], data, 0)
    return ColVal(dt.STRING, data, c.validity,
                  torch.where(c.validity, 10, 0).to(torch.int32))


def _cast_timestamp_to_string(c: ColVal) -> ColVal:
    """'yyyy-MM-dd HH:mm:ss[.ffffff]' with trailing fraction zeros
    trimmed (Spark timestamp formatting, UTC)."""
    us = c.data.to(torch.int64)
    days = torch.where(us >= 0, us // 86400000000,
                       -((-us + 86399999999) // 86400000000))
    rem = us - days * 86400000000
    y, m, d = _civil_from_days(days)
    hh = rem // 3600000000
    mm = rem // 60000000 % 60
    ss = rem // 1000000 % 60
    n = us.shape[0]

    def sep(ch):
        return torch.full((n, 1), ord(ch), dtype=torch.uint8, device=us.device)
    fmat = _decimal(rem % 1000000, 6)
    data = torch.cat([_decimal(y, 4), sep("-"), _decimal(m, 2), sep("-"),
                      _decimal(d, 2), sep(" "), _decimal(hh, 2), sep(":"),
                      _decimal(mm, 2), sep(":"), _decimal(ss, 2), sep("."),
                      fmat], dim=1)
    # trim trailing zeros of the fraction; no fraction -> no dot
    nz = fmat != ord("0")
    flen = torch.where(torch.any(nz, dim=1), _last_true(nz) + 1, 0)
    lens = (19 + torch.where(flen > 0, flen + 1, 0)).to(torch.int32)
    keep = _iota(data.shape[1], data)[None, :] < lens[:, None]
    data = torch.where(keep & c.validity[:, None], data, 0)
    return ColVal(dt.STRING, data, c.validity,
                  torch.where(c.validity, lens, 0))


# ---------------------------------------------------------------------------
# strings (byte-matrix compositions; ASCII case ops like cudf's default)
# ---------------------------------------------------------------------------

def _eval_upper(e, batch):
    c = evaluate(e.child, batch)
    is_lower = (c.data >= ord("a")) & (c.data <= ord("z"))
    return ColVal(dt.STRING, torch.where(is_lower, c.data - 32, c.data),
                  c.validity, c.lengths)


def _eval_lower(e, batch):
    c = evaluate(e.child, batch)
    is_upper = (c.data >= ord("A")) & (c.data <= ord("Z"))
    return ColVal(dt.STRING, torch.where(is_upper, c.data + 32, c.data),
                  c.validity, c.lengths)


def _eval_reverse(e, batch):
    c = evaluate(e.child, batch)
    pos = _iota(c.data.shape[1], c.data)[None, :]
    out = _at_many(c.data, c.lengths[:, None] - 1 - pos)
    out = torch.where(pos < c.lengths[:, None], out, 0)
    return ColVal(dt.STRING, out, c.validity, c.lengths)


def _eval_length(e, batch):
    """The UTF-8 character count: the bytes less the continuation
    bytes."""
    c = evaluate(e.child, batch)
    idx = _iota(c.data.shape[1], c.data)[None, :]
    cont = ((c.data & 0xC0) == 0x80) & (idx < c.lengths[:, None])
    return ColVal(dt.INT32, c.lengths - torch.sum(cont, dim=1,
                                                  dtype=torch.int32),
                  c.validity)


def _eval_substring(e, batch):
    s = evaluate(e.children[0], batch)
    pos = evaluate(e.children[1], batch)
    ln = evaluate(e.children[2], batch)
    w = s.data.shape[1]
    p = pos.data.to(torch.int32)
    n = ln.data.to(torch.int32)
    slen = s.lengths
    # Spark: 1-based; pos 0 behaves like 1; negative counts from the end
    # (int32 throughout, wrapping as the reference's does)
    start = torch.where(p > 0, p - 1, torch.where(p < 0, slen + p, 0))
    start = torch.minimum(torch.clamp(start, min=0), slen)
    end = torch.minimum(torch.clamp(start + torch.clamp(n, min=0), min=0),
                        slen)
    out_len = end - start
    idx = _iota(w, s.data)[None, :]
    gathered = _at_many(s.data, start[:, None] + idx)
    data = torch.where(idx < out_len[:, None], gathered, 0)
    valid = s.validity & pos.validity & ln.validity
    return ColVal(dt.STRING, data, valid, torch.where(valid, out_len, 0))


def _needle_bytes(e_right) -> bytes:
    if not isinstance(e_right, ir.Literal) or e_right.value is None:
        raise NotImplementedError("string search needle must be a literal")
    return e_right.value.encode("utf-8")


def _needle_row(needle: bytes, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(list(needle), dtype=torch.uint8, device=like.device)


def _match_at(l: ColVal, r: ColVal, offs: torch.Tensor) -> torch.Tensor:
    """[n] bool: needle column r matches l starting at per-row offset
    offs (clipped); caller guards length feasibility.  One gather of the
    needle's width, where the reference loops over it."""
    wr = r.data.shape[1]
    got = _at_many(l.data, _offsets_from(offs, wr))
    in_needle = _iota(wr, l.data)[None, :] < r.lengths[:, None]
    return torch.all(~in_needle | (got == r.data), dim=1)


def _literal_needle(e) -> bool:
    return isinstance(e.right, ir.Literal) and e.right.value is not None


def _eval_startswith(e, batch):
    l = evaluate(e.left, batch)
    if _literal_needle(e):
        needle = _needle_bytes(e.right)
        m, w = len(needle), l.data.shape[1]
        ok = l.lengths >= m
        if m > w:
            ok = torch.zeros_like(ok)
        elif m:
            ok = ok & torch.all(l.data[:, :m] == _needle_row(needle, l.data),
                                dim=1)
        return ColVal(dt.BOOL, ok, l.validity)
    r = evaluate(e.right, batch)     # column needle
    ok = (l.lengths >= r.lengths) & _match_at(
        l, r, torch.zeros_like(l.lengths))
    return ColVal(dt.BOOL, ok, l.validity & r.validity)


def _eval_endswith(e, batch):
    l = evaluate(e.left, batch)
    if _literal_needle(e):
        needle = _needle_bytes(e.right)
        m = len(needle)
        ok = l.lengths >= m
        if m:
            # position from the end: lengths - m + j
            got = _at_many(l.data, _offsets_from(l.lengths - m, m))
            ok = ok & torch.all(got == _needle_row(needle, l.data), dim=1)
        return ColVal(dt.BOOL, ok, l.validity)
    r = evaluate(e.right, batch)
    ok = (l.lengths >= r.lengths) & _match_at(
        l, r, l.lengths - r.lengths)
    return ColVal(dt.BOOL, ok, l.validity & r.validity)


def _window_match(l: ColVal, seg: bytes, wildcard=None) -> torch.Tensor:
    """[n, w - m + 1] bool: ``seg`` (a byte equal to ``wildcard`` matches
    any byte) starts at each position p and fits inside the string."""
    m, w = len(seg), l.data.shape[1]
    span = w - m + 1
    match = torch.ones((l.data.shape[0], span), dtype=torch.bool,
                       device=l.data.device)
    for j, byte in enumerate(seg):
        if byte != wildcard:
            match = match & (l.data[:, j:j + span] == byte)
    starts = _iota(span, l.data)[None, :]
    return match & (starts + m <= l.lengths[:, None])


def _contains_mask(l: ColVal, needle: bytes) -> torch.Tensor:
    m, w = len(needle), l.data.shape[1]
    if m == 0:
        return torch.ones_like(l.validity)
    if m > w:
        return torch.zeros_like(l.validity)
    return torch.any(_window_match(l, needle), dim=1)


def _eval_contains(e, batch):
    l = evaluate(e.left, batch)
    if _literal_needle(e):
        return ColVal(dt.BOOL, _contains_mask(l, _needle_bytes(e.right)),
                      l.validity)
    r = evaluate(e.right, batch)     # column needle
    # every start s at once, one needle byte at a time (the reference
    # loops over the starts): a start is feasible only where the needle
    # fits, so the bytes it reads lie inside the string
    wl, wr = l.data.shape[1], r.data.shape[1]
    hay = _pad_width(l.data, wl + wr)
    match = torch.ones((l.data.shape[0], wl), dtype=torch.bool,
                       device=l.data.device)
    for j in range(wr):
        match = match & ((j >= r.lengths[:, None]) |
                         (hay[:, j:j + wl] == r.data[:, j:j + 1]))
    starts = _iota(wl, l.data)[None, :]
    match = match & (starts + r.lengths[:, None] <= l.lengths[:, None])
    ok = (torch.any(match, dim=1) | (r.lengths == 0)) & \
        (r.lengths <= l.lengths)
    return ColVal(dt.BOOL, ok, l.validity & r.validity)


def _seg_match_positions(l: ColVal, seg: bytes) -> torch.Tensor:
    """[n, w] bool: the segment (with '_' single-char wildcards) matches
    starting at byte position p and fits inside the string."""
    m, w = len(seg), l.data.shape[1]
    if m > w:
        return torch.zeros((l.data.shape[0], w), dtype=torch.bool,
                           device=l.data.device)
    return _pad_width(_window_match(l, seg, ord("_")), w)


def _eval_like(e, batch):
    """Full SQL LIKE: literal pattern with '%' multi-char and '_'
    single-char wildcards, evaluated as a greedy leftmost
    segment-placement scan over the byte matrix."""
    l = evaluate(e.left, batch)
    n, w = l.data.shape
    if isinstance(e.right, ir.Literal) and e.right.value is None:
        none = torch.zeros((n,), dtype=torch.bool, device=l.data.device)
        return ColVal(dt.BOOL, none, none)   # LIKE NULL -> NULL
    pat = _needle_bytes(e.right)
    segs = pat.split(b"%")
    lead = not pat.startswith(b"%")
    trail = not pat.endswith(b"%")
    nonempty = [(k, s) for k, s in enumerate(segs) if s]
    if not nonempty:
        # '', '%', '%%', ...: an empty pattern matches only the empty string
        ok = torch.ones_like(l.validity) if b"%" in pat \
            else (l.lengths == 0)
        return ColVal(dt.BOOL, ok, l.validity)
    ok = torch.ones_like(l.validity)
    pos = torch.zeros_like(l.lengths)
    for k, seg in nonempty:
        m = len(seg)
        is_first = k == 0 and lead
        is_last = (k == len(segs) - 1) and trail
        mp = _seg_match_positions(l, seg)
        if is_first and is_last and len(nonempty) == 1:
            ok = ok & mp[:, 0] & (l.lengths == m) if m <= w \
                else torch.zeros_like(ok)
            break
        if is_first:
            ok = ok & (mp[:, 0] if m <= w else torch.zeros_like(ok))
            pos = torch.full_like(l.lengths, m)
            continue
        if is_last:
            p = l.lengths - m
            ok = ok & _at(mp, p) & (p >= pos)
            continue
        # middle (or leading-%%) segment: leftmost occurrence >= pos
        cand = mp & (_iota(w, l.data)[None, :] >= pos[:, None])
        ok = ok & torch.any(cand, dim=1)
        pos = (_first_true(cand) + m).to(pos.dtype)
    return ColVal(dt.BOOL, ok, l.validity)


def _pow2_width(w: int) -> int:
    """The output width the reference gives a composed string: the
    power of two >= w."""
    return 1 << max(0, w - 1).bit_length()


def _eval_concat(e, batch):
    vals = [evaluate(c, batch) for c in e.children]
    out_w = _pow2_width(sum(v.data.shape[1] for v in vals))
    rows, dev = vals[0].data.shape[0], vals[0].data.device
    out = torch.zeros((rows, out_w), dtype=torch.uint8, device=dev)
    out_len = torch.zeros((rows,), dtype=torch.int32, device=dev)
    valid = torch.ones((rows,), dtype=torch.bool, device=dev)
    idx = _iota(out_w, out)[None, :]
    for v in vals:
        # out[i, out_len[i] + j] = v[i, j]
        sv = _at_many(v.data, idx - out_len[:, None])
        write = (idx >= out_len[:, None]) & \
                (idx < (out_len + v.lengths)[:, None])
        out = torch.where(write, sv, out)
        out_len = out_len + v.lengths
        valid = valid & v.validity
    return ColVal(dt.STRING, out, valid, torch.where(valid, out_len, 0))


def _trim_bounds(c: ColVal, left: bool, right: bool):
    """(start, end) of the span trimmed of ' ' on the chosen sides; an
    all-space or empty string trims to (0, 0)."""
    idx = _iota(c.data.shape[1], c.data)[None, :]
    in_str = idx < c.lengths[:, None]
    non_space = in_str & (c.data != ord(" "))
    any_ns = torch.any(non_space, dim=1)
    start = torch.where(any_ns, _first_true(non_space), 0) if left \
        else torch.zeros_like(c.lengths)
    end = _last_true(non_space) + 1 if right else c.lengths
    end = torch.where(any_ns, end, 0)
    return start.to(torch.int32), end.to(torch.int32)


def _mk_trim(left: bool, right: bool):
    def f(e, batch):
        c = evaluate(e.child, batch)
        start, end = _trim_bounds(c, left, right)
        out_len = end - start
        idx = _iota(c.data.shape[1], c.data)[None, :]
        data = _at_many(c.data, start[:, None] + idx)
        data = torch.where(idx < out_len[:, None], data, 0)
        return ColVal(dt.STRING, data, c.validity,
                      torch.where(c.validity, out_len, 0))
    return f


def _eval_initcap(e, batch):
    c = evaluate(e.child, batch)
    prev_is_sep = torch.nn.functional.pad(c.data[:, :-1] == ord(" "),
                                          (1, 0), value=True)
    lower = (c.data >= ord("a")) & (c.data <= ord("z"))
    upper = (c.data >= ord("A")) & (c.data <= ord("Z"))
    data = torch.where(prev_is_sep & lower, c.data - 32,
                       torch.where(~prev_is_sep & upper, c.data + 32,
                                   c.data))
    return ColVal(dt.STRING, data, c.validity, c.lengths)


def _eval_locate(e, batch):
    sub_e, str_e, start_e = e.children
    s = evaluate(str_e, batch)
    needle = _needle_bytes(sub_e)
    if not isinstance(start_e, ir.Literal):
        raise NotImplementedError("locate start must be literal")
    start = int(start_e.value or 1)
    m, w = len(needle), s.data.shape[1]
    if m == 0:
        return ColVal(dt.INT32, torch.full_like(s.lengths, start),
                      s.validity)
    if m > w:
        return ColVal(dt.INT32, torch.zeros_like(s.lengths), s.validity)
    match = _window_match(s, needle)
    match = match & (_iota(w - m + 1, s.data)[None, :] >= start - 1)
    pos = torch.where(torch.any(match, dim=1), _first_true(match) + 1, 0)
    return ColVal(dt.INT32, pos.to(torch.int32), s.validity)


def _mk_pad(left: bool):
    def f(e, batch):
        s = evaluate(e.children[0], batch)
        len_e, pad_e = e.children[1], e.children[2]
        if not isinstance(len_e, ir.Literal) or \
           not isinstance(pad_e, ir.Literal):
            raise NotImplementedError("pad length/fill must be literals")
        target = max(int(len_e.value), 0)  # Spark: len<=0 -> empty string
        pad = (pad_e.value or "").encode("utf-8")
        out_w = _pow2_width(max(target, 1))
        idx = _iota(out_w, s.data)[None, :]
        src = _pad_width(s.data, out_w)     # a negative pad crops
        cur = torch.clamp(s.lengths, max=target)
        if not pad:
            # empty pad string: Spark returns the (possibly truncated) input
            out_len = cur
            data = torch.where(idx < out_len[:, None], src, 0)
        else:
            out_len = torch.full_like(s.lengths, target)
            if left:
                n_pad = torch.clamp(target - s.lengths, min=0)
                body = _at_many(src, idx - n_pad[:, None])
                fill_pos = idx    # the pad cycles from position 0
                in_pad = idx < n_pad[:, None]
            else:
                body = src
                fill_pos = torch.clamp(idx - cur[:, None], min=0)
                in_pad = idx >= cur[:, None]
            fill = _needle_row(pad, src)[fill_pos % len(pad)]
            data = torch.where(in_pad, fill, body)
            data = torch.where(idx < out_len[:, None], data, 0)
        return ColVal(dt.STRING, data, s.validity,
                      torch.where(s.validity, out_len, 0))
    return f


# ---------------------------------------------------------------------------
# date/time (UTC only; civil-calendar math after Howard Hinnant's algorithms)
# ---------------------------------------------------------------------------
#
# The reference defines each conversion twice (:829/:977, then :1417/:1431);
# Python binds the later pair, so the casts run it too.  These are that pair:
# days in int64 to int32 (y, m, d), and (y, m, d) back in their own type,
# both flooring.

def _civil_from_days(days: torch.Tensor):
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(y.dtype)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _to_days(c: ColVal) -> torch.Tensor:
    if c.dtype.id == dt.TypeId.TIMESTAMP_US:
        return c.data // _US_PER_DAY
    return c.data.to(torch.int64)


def _mk_datefield(which: str):
    def f(e, batch):
        c = evaluate(e.child, batch)
        days = _to_days(c)
        y, m, d = _civil_from_days(days)
        if which == "year":
            out = y
        elif which == "month":
            out = m
        elif which == "day":
            out = d
        elif which == "quarter":
            out = (m - 1) // 3 + 1
        elif which == "dayofweek":   # Sun=1..Sat=7
            out = (days + 4) % 7 + 1
        elif which == "dayofyear":
            jan1 = _days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
            out = days - jan1 + 1
        elif which == "weekofyear":  # ISO 8601
            thursday = days - (days + 3) % 7 + 3     # Mon=0..Sun=6
            ty, tm, td = _civil_from_days(thursday)
            jan1 = _days_from_civil(ty, torch.ones_like(tm),
                                    torch.ones_like(td))
            out = (thursday - jan1) // 7 + 1
        else:
            raise AssertionError(which)
        return ColVal(dt.INT32, out.to(torch.int32), c.validity)
    return f


def _mk_timefield(which: str):
    def f(e, batch):
        c = evaluate(e.child, batch)
        us = c.data.to(torch.int64) % _US_PER_DAY
        if which == "hour":
            out = us // (3600 * 1000 * 1000)
        elif which == "minute":
            out = (us // (60 * 1000 * 1000)) % 60
        else:
            out = (us // (1000 * 1000)) % 60
        return ColVal(dt.INT32, out.to(torch.int32), c.validity)
    return f


def _eval_dateadd(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    return ColVal(dt.DATE32, (l.data.to(torch.int64) +
                              r.data.to(torch.int64)).to(torch.int32),
                  _binary_null(l, r))


def _eval_datesub(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    return ColVal(dt.DATE32, (l.data.to(torch.int64) -
                              r.data.to(torch.int64)).to(torch.int32),
                  _binary_null(l, r))


def _eval_datediff(e, batch):
    l, r = evaluate(e.left, batch), evaluate(e.right, batch)
    return ColVal(dt.INT32, (_to_days(l) - _to_days(r)).to(torch.int32),
                  _binary_null(l, r))


def _eval_unix_ts(e, batch):
    c = evaluate(e.child, batch)
    return ColVal(dt.INT64, c.data // (1000 * 1000), c.validity)


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


# ---------------------------------------------------------------------------
# partition leaves and rand
# ---------------------------------------------------------------------------

def _ones(batch: DeviceBatch) -> torch.Tensor:
    return torch.ones(batch.capacity, dtype=torch.bool, device=batch.device)


def _eval_partition_id(e, batch):
    from spark_rapids_tpu_torch.exec import context
    pid, _ = context.get()
    data = torch.full((batch.capacity,), int(pid), dtype=torch.int32,
                      device=batch.device)
    return ColVal(dt.INT32, data, _ones(batch))


def _eval_monotonic_id(e, batch):
    # Spark: (partitionId << 33) + row offset within partition
    from spark_rapids_tpu_torch.exec import context
    pid, off = context.get()
    base = (int(pid) << 33) + int(off)
    data = base + torch.arange(batch.capacity, dtype=torch.int64,
                               device=batch.device)
    return ColVal(dt.INT64, data, _ones(batch))


_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 (20 rounds) over 32-bit words held in int64, as
    jax's ``threefry_2x32`` computes it in uint32."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _uniform_f64(seed: int, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,), float64)``
    bit for bit, under ``jax_threefry_partitionable`` (the default since
    jax 0.5): the key is the seed's two 32-bit halves, row i hashes the
    counter pair (0, i), the 64 random bits are ``hi << 32 | lo``, and
    their top 52 bits become the mantissa of a double in [1, 2) less
    1.0.  Row i's value depends on i alone, not on ``n``."""
    s = seed % (1 << 64)
    k1, k2 = s >> 32, s & _M32
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
    return bits.view(torch.float64) - 1.0


def _eval_rand(e: ir.Rand, batch):
    return ColVal(dt.FLOAT64,
                  _uniform_f64(e.seed, batch.capacity, batch.device),
                  _ones(batch))


# ---------------------------------------------------------------------------
# complex types: list columns are (padded [cap, max_len] payload, lengths,
# elem_validity), the fixed-width layout strings use, so these are masked
# gathers and reductions over the payload
# ---------------------------------------------------------------------------

def _eval_size(e: ir.Size, batch: DeviceBatch) -> ColVal:
    v = evaluate(e.children[0], batch)
    out = torch.where(v.validity, v.lengths.to(torch.int32),
                      -1).to(torch.int32)   # Spark 3.0: size(null) = -1
    return ColVal(dt.INT32, out, _ones(batch))


def _list_item(e, v: ColVal, idx: torch.Tensor,
               in_range: torch.Tensor) -> ColVal:
    """Element ``idx`` of each row's list, null where not ``in_range``
    or where the element is null."""
    data = _at(v.data, idx)
    ev = _at(v.elem_validity, idx) if v.elem_validity is not None \
        else torch.ones_like(in_range)
    valid = in_range & ev
    el = e.dtype
    return ColVal(el, torch.where(valid, data, 0).to(el.to_torch()), valid)


def _eval_get_array_item(e: ir.GetArrayItem, batch: DeviceBatch) -> ColVal:
    v = evaluate(e.children[0], batch)
    o = evaluate(e.children[1], batch)
    idx = o.data.to(torch.int32)
    in_range = (idx >= 0) & (idx < v.lengths) & v.validity & o.validity
    return _list_item(e, v, idx, in_range)


def _eval_array_contains(e: ir.ArrayContains, batch: DeviceBatch) -> ColVal:
    v = evaluate(e.children[0], batch)
    x = evaluate(e.children[1], batch)
    slot = _iota(v.data.shape[1], v.data)[None, :] < v.lengths[:, None]
    ev = v.elem_validity if v.elem_validity is not None else \
        torch.ones(v.data.shape, dtype=torch.bool, device=v.data.device)
    live = slot & ev
    # compare in the promoted type so fractional probes never truncate
    # (as the CPU engine: 2.5 vs array<int> finds nothing)
    el = v.dtype.element
    if el != x.dtype and el.is_numeric and x.dtype.is_numeric:
        cmp_t = dt.promote(el, x.dtype).to_torch()
    else:
        cmp_t = v.data.dtype
    eq = (v.data.to(cmp_t) == x.data.to(cmp_t)[:, None]) & live
    found = torch.any(eq, dim=1)
    has_null_elem = torch.any(slot & ~ev, dim=1)
    valid = v.validity & x.validity & (found | ~has_null_elem)
    return ColVal(dt.BOOL, found & v.validity & x.validity, valid)


def _eval_element_at(e: ir.ElementAt, batch: DeviceBatch) -> ColVal:
    v = evaluate(e.children[0], batch)
    o = evaluate(e.children[1], batch)
    k = o.data.to(torch.int32)
    idx = torch.where(k > 0, k - 1, v.lengths.to(torch.int32) + k)
    in_range = (k != 0) & (idx >= 0) & (idx < v.lengths) & \
        v.validity & o.validity
    return _list_item(e, v, idx, in_range)


def _eval_create_array(e: ir.CreateArray, batch: DeviceBatch) -> ColVal:
    t = e.dtype.element.to_torch()
    vals = [evaluate(c, batch) for c in e.children]
    data = torch.stack([v.data.to(t) for v in vals], dim=1)
    ev = torch.stack([v.validity for v in vals], dim=1)
    lengths = torch.full((batch.capacity,), len(vals), dtype=torch.int32,
                         device=batch.device)
    return ColVal(e.dtype, data, _ones(batch), lengths, ev)


# ---------------------------------------------------------------------------
# md5: the MD5 block function over every row at once, one Python step per
# 64-byte block of the widest row; each 32-bit word is held unsigned in
# int64 (as murmur3's), so ~B is B ^ 0xFFFFFFFF and sums are masked
# ---------------------------------------------------------------------------

_MD5_S = ([7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 +
          [6, 10, 15, 21] * 4)
_MD5_K = [int(abs(np.sin(i + 1)) * (1 << 32)) & _M32 for i in range(64)]
_MD5_G = ([i for i in range(16)] + [(5 * i + 1) % 16 for i in range(16)] +
          [(3 * i + 5) % 16 for i in range(16)] +
          [(7 * i) % 16 for i in range(16)])


def _md5_block(words: torch.Tensor, a0, b0, c0, d0):
    """The 64 rounds over one block's 16 words (``[rows, 16]``)."""
    A, B, C, D = a0, b0, c0, d0
    for i in range(64):
        if i < 16:
            F = (B & C) | ((B ^ _M32) & D)
        elif i < 32:
            F = (D & B) | ((D ^ _M32) & C)
        elif i < 48:
            F = B ^ C ^ D
        else:
            F = C ^ (B | (D ^ _M32))
        F = (F + A + words[:, _MD5_G[i]] + _MD5_K[i]) & _M32
        A, D, C = D, C, B
        B = (B + _rotl(F, _MD5_S[i])) & _M32
    return A, B, C, D


def _eval_md5(e, batch):
    c = evaluate(e.child, batch)
    if not c.dtype.is_string:
        raise NotImplementedError("md5 over a non-string")
    data, lengths = c.data, c.lengths.to(torch.int64)
    n, w = data.shape
    dev = data.device
    # padded message: data, 0x80, zeros, the 8-byte little-endian bit
    # length at the end of the row's last block; blocks past the longest
    # row's last are never active
    n_blocks = (min(longest(lengths), w) + 9 + 63) // 64
    k = min(w, n_blocks * 64)
    msg = torch.zeros((n, n_blocks * 64), dtype=torch.int64, device=dev)
    msg[:, :k] = torch.where(_iota(k, data)[None, :] < lengths[:, None],
                             data[:, :k].to(torch.int64), 0)
    msg.scatter_(1, lengths[:, None], 0x80)
    row_blocks = (lengths + 9 + 63) // 64
    lenpos = row_blocks * 64 - 8
    shifts = 8 * _iota(8, data)
    msg.scatter_(1, lenpos[:, None] + _iota(8, data)[None, :],
                 ((lengths * 8)[:, None] >> shifts[None, :]) & 0xFF)
    # bytes -> 16 little-endian words per block
    words = (msg[:, 0::4] | (msg[:, 1::4] << 8) | (msg[:, 2::4] << 16) |
             (msg[:, 3::4] << 24))
    h = [torch.full((n,), v, dtype=torch.int64, device=dev)
         for v in (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)]
    for bi in range(n_blocks):
        out = _md5_block(words[:, bi * 16:(bi + 1) * 16], *h)
        active = bi < row_blocks
        h = [torch.where(active, (x + y) & _M32, x) for x, y in zip(h, out)]
    # digest: a, b, c, d as little-endian bytes -> 32 hex characters
    by = (torch.stack(h, dim=1)[:, :, None] >> (8 * _iota(4, data))) & 0xFF
    by = by.reshape(n, 16)
    nib = torch.stack([by >> 4, by & 0xF], dim=2).reshape(n, 32)
    hexc = torch.where(nib < 10, nib + ord("0"),
                       nib - 10 + ord("a")).to(torch.uint8)
    out = torch.where(c.validity[:, None], hexc, 0)
    lens = torch.where(c.validity, 32, 0).to(torch.int32)
    return ColVal(dt.STRING, out, c.validity, lens)


# ---------------------------------------------------------------------------
# regex: RLIKE and regexp_replace over the bitmask NFA of
# expr/device_regex.py, and regexp_replace's literal-needle path
# ---------------------------------------------------------------------------

_REGEX_META = set(".^$*+?()[]{}|\\")


def _emit_replaced(s: ColVal, starts, covered, rep_bytes: bytes,
                   w_out: int) -> ColVal:
    """regexp_replace's emission: given per-position start flags (emit
    the replacement) and covered flags (emit nothing; starts take
    precedence), scatter the copied characters and the replacement bytes
    into a fresh byte matrix.  A dropped byte goes to one spare slot past
    the end, which the output slices off."""
    n, w = s.data.shape
    dev = s.data.device
    lr = len(rep_bytes)
    in_str = _iota(w, s.data)[None, :] < s.lengths[:, None]
    emit = torch.where(starts, lr, torch.where(covered, 0, 1)) * \
        in_str.to(torch.int64)
    out_pos = torch.cumsum(emit, dim=1) - emit
    out_len = torch.sum(emit, dim=1).to(torch.int32)
    row = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    spare = n * w_out
    flat = torch.zeros((spare + 1,), dtype=torch.uint8, device=dev)
    # copied characters
    plain = in_str & ~covered & ~starts
    tgt = torch.where(plain, row * w_out + out_pos, spare)
    flat[tgt.reshape(-1)] = s.data.reshape(-1)
    # replacement bytes
    for k, byte in enumerate(rep_bytes):
        tgt = torch.where(starts & in_str, row * w_out + out_pos + k, spare)
        flat[tgt.reshape(-1)] = byte
    data = flat[:spare].reshape(n, w_out)
    keep = _iota(w_out, data)[None, :] < out_len[:, None]
    data = torch.where(keep & s.validity[:, None], data, 0)
    return ColVal(dt.STRING, data, s.validity,
                  torch.where(s.validity, out_len, 0))


def _replace_out_width(w: int, min_match: int, lr: int) -> int:
    from spark_rapids_tpu_torch.columnar.batch import _bucket_strlen
    w_out = w if lr <= min_match else \
        (w // max(min_match, 1)) * lr + w
    return _bucket_strlen(w_out)


def _eval_regexp_replace(e, batch):
    """regexp_replace with a literal pattern: a pattern free of
    metacharacters takes the direct occurrence scan; one in the
    device_regex.py subset (classes, anchors, greedy quantifiers, groups;
    no alternation, which diverges from Java's leftmost-branch pick, and
    no empty-matchable pattern) runs the bitmask NFA and replaces the
    longest match per start.  Greedy leftmost non-overlapping, as
    java.util.regex.  The planner keeps everything else on the CPU."""
    s = evaluate(e.children[0], batch)
    pat = e.children[1]
    rep = e.children[2]
    if not isinstance(pat, ir.Literal) or pat.value is None or \
            not isinstance(rep, ir.Literal) or rep.value is None:
        raise NotImplementedError("regexp_replace pattern/replacement "
                                  "must be literals")
    needle = pat.value.encode("utf-8")
    r = rep.value.encode("utf-8")
    n, w = s.data.shape
    dev = s.data.device
    pos = _iota(w, s.data)[None, :]

    if needle and not any(chr(b) in _REGEX_META for b in needle):
        # literal path: occurrences by shifted equality (the needle fits
        # at p, inside the string)
        m = len(needle)
        occ = torch.zeros((n, w), dtype=torch.bool, device=dev)
        if m <= w:
            span = w - m + 1
            match = torch.ones((n, span), dtype=torch.bool, device=dev)
            for j, byte in enumerate(needle):
                match = match & (s.data[:, j:j + span] == byte)
            occ[:, :span] = match & (
                _iota(span, s.data)[None, :] + m <= s.lengths[:, None])
        # greedy leftmost non-overlap: a start is real if no real start
        # lies in the previous m - 1 positions
        starts = torch.zeros((n, w), dtype=torch.bool, device=dev)
        next_free = torch.zeros((n,), dtype=torch.int64, device=dev)
        for p in range(min(w, longest(s.lengths))):
            here = occ[:, p] & (p >= next_free)
            starts[:, p] = here
            next_free = torch.where(here, p + m, next_free)
        sstart = torch.where(starts, pos, -(1 << 30))
        last = torch.cummax(sstart, dim=1).values
        covered = (pos - last) < m
        return _emit_replaced(s, starts, covered, r,
                              _replace_out_width(w, m, len(r)))

    # NFA subset path
    from spark_rapids_tpu_torch.expr import device_regex as dr
    try:
        cr = dr.compile_pattern(pat.value)
    except dr.Unsupported as ex:
        raise NotImplementedError(f"regex pattern outside the device "
                                  f"subset: {ex}")
    if not cr.replace_safe:
        # Java's greedy backtracking match equals the longest-end table
        # only for single-variable-element patterns (see
        # CompiledRegex.replace_safe)
        raise NotImplementedError("regexp_replace pattern where Java "
                                  "greedy semantics may differ from "
                                  "longest-match")
    if b"$" in r or b"\\" in r:
        raise NotImplementedError("group references in replacement")
    ends = dr.match_ends(cr, s.data, s.lengths)   # [n, w] exclusive, -1
    starts = torch.zeros((n, w), dtype=torch.bool, device=dev)
    covered = torch.zeros((n, w), dtype=torch.bool, device=dev)
    cur_end = torch.zeros((n,), dtype=ends.dtype, device=dev)
    for p in range(min(w, longest(s.lengths))):
        cov_p = p < cur_end
        here = (ends[:, p] >= 0) & ~cov_p
        starts[:, p] = here
        covered[:, p] = cov_p
        cur_end = torch.where(here, ends[:, p], cur_end)
    return _emit_replaced(s, starts, covered, r,
                          _replace_out_width(w, cr.min_len, len(r)))


def _eval_rlike(e, batch):
    """RLIKE (find anywhere) over the bitmask NFA of device_regex.py; the
    pattern is a literal in the device subset."""
    l = evaluate(e.left, batch)
    if isinstance(e.right, ir.Literal) and e.right.value is None:
        n0 = l.data.shape[0]
        z = torch.zeros((n0,), dtype=torch.bool, device=l.data.device)
        return ColVal(dt.BOOL, z, z)             # RLIKE NULL -> NULL
    if not isinstance(e.right, ir.Literal):
        raise NotImplementedError("rlike pattern must be a literal")
    from spark_rapids_tpu_torch.expr import device_regex as dr
    try:
        cr = dr.compile_pattern(e.right.value)
    except dr.Unsupported as ex:
        raise NotImplementedError(f"regex pattern outside the device "
                                  f"subset: {ex}")
    return ColVal(dt.BOOL, dr.rlike(cr, l.data, l.lengths), l.validity)


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
    ir.Upper: _eval_upper,
    ir.Lower: _eval_lower,
    ir.Length: _eval_length,
    ir.Substring: _eval_substring,
    ir.StartsWith: _eval_startswith,
    ir.EndsWith: _eval_endswith,
    ir.Contains: _eval_contains,
    ir.Like: _eval_like,
    ir.Concat: _eval_concat,
    ir.StringTrim: _mk_trim(True, True),
    ir.StringTrimLeft: _mk_trim(True, False),
    ir.StringTrimRight: _mk_trim(False, True),
    ir.InitCap: _eval_initcap,
    ir.StringLocate: _eval_locate,
    ir.LPad: _mk_pad(True),
    ir.RPad: _mk_pad(False),
    ir.StringReverse: _eval_reverse,
    ir.Year: _mk_datefield("year"),
    ir.Month: _mk_datefield("month"),
    ir.DayOfMonth: _mk_datefield("day"),
    ir.DayOfYear: _mk_datefield("dayofyear"),
    ir.DayOfWeek: _mk_datefield("dayofweek"),
    ir.WeekOfYear: _mk_datefield("weekofyear"),
    ir.Quarter: _mk_datefield("quarter"),
    ir.Hour: _mk_timefield("hour"),
    ir.Minute: _mk_timefield("minute"),
    ir.Second: _mk_timefield("second"),
    ir.DateAdd: _eval_dateadd,
    ir.DateSub: _eval_datesub,
    ir.DateDiff: _eval_datediff,
    ir.UnixTimestampFromTs: _eval_unix_ts,
    ir.Murmur3Hash: _eval_murmur3,
    ir.KnownFloatingPointNormalized: _eval_knownfloat,
    ir.SparkPartitionID: _eval_partition_id,
    ir.MonotonicallyIncreasingID: _eval_monotonic_id,
    ir.Rand: _eval_rand,
    ir.Size: _eval_size,
    ir.GetArrayItem: _eval_get_array_item,
    ir.ArrayContains: _eval_array_contains,
    ir.ElementAt: _eval_element_at,
    ir.CreateArray: _eval_create_array,
    ir.Md5: _eval_md5,
    ir.RLike: _eval_rlike,
    ir.RegExpReplace: _eval_regexp_replace,
}


def supported_on_tpu(cls) -> bool:
    return cls in _DISPATCH
