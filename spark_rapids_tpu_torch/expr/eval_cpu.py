"""CPU columnar expression evaluator — the fallback path and parity oracle.

Role analog: in the reference, anything not on the GPU runs on stock Spark
CPU execution (reference: README.md:28-31, RapidsMeta convertIfNeeded keeps
original CPU nodes).  We are standalone, so this module *is* our "stock CPU
Spark": an independent implementation of the same SQL semantics used both as
the CPU fallback execution path and as the oracle in the dual-session parity
test harness (reference: SparkQueryCompareTestSuite.scala:153-161).

Deliberately different algorithms from eval_tpu (Python str ops instead of
byte matrices, numpy datetime64 instead of civil-day math, scalar murmur3) so
shared bugs between the two paths are unlikely.

The port's copy of ``spark_rapids_tpu/expr/eval_cpu.py`` (numpy and
pyarrow only), with its imports retargeted: it is the port's CPU
fallback engine and the parity oracle of its CPU sessions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.expr import ir


@dataclass
class CpuVal:
    dtype: dt.DType
    data: np.ndarray      # numeric np array, or object array of str for STRING
    valid: np.ndarray     # bool

    def masked(self) -> np.ndarray:
        return self.data


def evaluate(e: ir.Expression, table: pa.Table) -> CpuVal:
    fn = _DISPATCH.get(type(e))
    if fn is None:
        raise NotImplementedError(f"CPU eval for {type(e).__name__}")
    return fn(e, table)


def to_arrow_array(v: CpuVal) -> pa.Array:
    mask = ~v.valid
    if v.dtype.is_nested:
        py = [None if not v.valid[i] else v.data[i]
              for i in range(len(v.data))]
        return pa.array(py, type=v.dtype.to_arrow())
    if v.dtype.is_string:
        py = [None if mask[i] else v.data[i] for i in range(len(v.data))]
        return pa.array(py, type=pa.string())
    if v.dtype.id == dt.TypeId.TIMESTAMP_US:
        return pa.array(v.data.astype("datetime64[us]"),
                        type=pa.timestamp("us", tz="UTC"), mask=mask)
    if v.dtype.id == dt.TypeId.DATE32:
        return pa.array(v.data.astype(np.int32).astype("datetime64[D]"),
                        type=pa.date32(), mask=mask)
    return pa.array(v.data, type=v.dtype.to_arrow(), mask=mask)


def from_arrow_array(arr, dtype: dt.DType) -> CpuVal:
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    valid = ~np.asarray(arr.is_null())
    if dtype.is_nested:
        py = arr.to_pylist()
        data = np.empty(n, dtype=object)
        for i, v in enumerate(py):
            data[i] = v
        return CpuVal(dtype, data, valid)
    if dtype.is_string:
        data = np.array([s if s is not None else "" for s in arr.to_pylist()],
                        dtype=object)
        return CpuVal(dtype, data, valid)
    if pa.types.is_timestamp(arr.type):
        vals = arr.cast(pa.timestamp("us")).to_numpy(zero_copy_only=False)
        data = vals.astype("datetime64[us]").astype(np.int64)
        data = np.where(valid, data, 0)
        return CpuVal(dtype, data, valid)
    if pa.types.is_date32(arr.type):
        vals = arr.to_numpy(zero_copy_only=False)
        data = vals.astype("datetime64[D]").astype(np.int64).astype(np.int32)
        data = np.where(valid, data, 0)
        return CpuVal(dtype, data, valid)
    filled = arr.fill_null(False if dtype.is_bool else 0)
    data = filled.to_numpy(zero_copy_only=False).astype(dtype.to_np())
    return CpuVal(dtype, data, valid)


# ---------------------------------------------------------------------------

def _lit(e: ir.Literal, table: pa.Table) -> CpuVal:
    n = table.num_rows
    d = e.dtype
    if e.value is None:
        dtype = d if d != dt.NULL else dt.BOOL
        data = np.array([""] * n, dtype=object) if dtype.is_string else \
            np.zeros(n, dtype=dtype.to_np())
        return CpuVal(dtype, data, np.zeros(n, dtype=bool))
    if d.is_string:
        return CpuVal(d, np.array([e.value] * n, dtype=object),
                      np.ones(n, dtype=bool))
    v = e.value
    if d.id == dt.TypeId.DATE32 and not isinstance(v, (int, np.integer)):
        v = (np.datetime64(v, "D") - np.datetime64(0, "D")).astype(int)
    if d.id == dt.TypeId.TIMESTAMP_US and not isinstance(v, (int, np.integer)):
        v = (np.datetime64(v, "us") - np.datetime64(0, "us")).astype(int)
    return CpuVal(d, np.full(n, v, dtype=d.to_np()), np.ones(n, dtype=bool))


def _bound(e: ir.BoundReference, table: pa.Table) -> CpuVal:
    return from_arrow_array(table.column(e.ordinal), e.dtype)


def _alias(e, table):
    return evaluate(e.children[0], table)


def _bin_arith(op):
    def f(e, table):
        l, r = evaluate(e.left, table), evaluate(e.right, table)
        tgt = e.dtype.to_np()
        with np.errstate(all="ignore"):
            out = op(l.data.astype(tgt), r.data.astype(tgt)).astype(tgt)
        return CpuVal(e.dtype, out, l.valid & r.valid)
    return f


def _div(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    a, b = l.data.astype(np.float64), r.data.astype(np.float64)
    nz = b != 0
    with np.errstate(all="ignore"):
        out = np.where(nz, a / np.where(nz, b, 1), 0.0)
    return CpuVal(e.dtype, out, l.valid & r.valid & nz)


def _idiv(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    a, b = l.data.astype(np.int64), r.data.astype(np.int64)
    nz = b != 0
    bb = np.where(nz, b, 1)
    q = np.trunc(a / bb).astype(np.int64)  # trunc toward zero like Java
    # large int64 precision: redo exactly with floor then fix
    qf = a // bb
    rem = a - qf * bb
    qf = np.where((rem != 0) & ((a < 0) != (b < 0)), qf + 1, qf)
    return CpuVal(e.dtype, np.where(nz, qf, 0), l.valid & r.valid & nz)


def _mod(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    tgt = e.dtype.to_np()
    a, b = l.data.astype(tgt), r.data.astype(tgt)
    if e.dtype.is_floating:
        nz = b != 0
        with np.errstate(all="ignore"):
            m = np.fmod(a, np.where(nz, b, 1))
    else:
        nz = b != 0
        bb = np.where(nz, b, 1)
        m = np.where(nz, np.fmod(a, bb), 0)
    return CpuVal(e.dtype, np.where(nz, m, 0), l.valid & r.valid & nz)


def _pmod(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    tgt = e.dtype.to_np()
    a, b = l.data.astype(tgt), r.data.astype(tgt)
    nz = b != 0
    bb = np.where(nz, b, 1)
    with np.errstate(all="ignore"):
        m = np.fmod(a, bb)
        m = np.where((m != 0) & ((m < 0) != (bb < 0)), m + bb, m)
    return CpuVal(e.dtype, np.where(nz, m, 0), l.valid & r.valid & nz)


def _neg(e, table):
    c = evaluate(e.child, table)
    return CpuVal(e.dtype, -c.data, c.valid)


def _abs(e, table):
    c = evaluate(e.child, table)
    return CpuVal(e.dtype, np.abs(c.data), c.valid)


def _cmp(op_name):
    def f(e, table):
        l, r = evaluate(e.left, table), evaluate(e.right, table)
        if l.dtype.is_string:
            a, b = l.data, r.data
            if op_name == "eq":
                out = np.array([x == y for x, y in zip(a, b)])
            elif op_name == "lt":
                out = np.array([x < y for x, y in zip(a, b)])
            elif op_name == "le":
                out = np.array([x <= y for x, y in zip(a, b)])
            elif op_name == "gt":
                out = np.array([x > y for x, y in zip(a, b)])
            else:
                out = np.array([x >= y for x, y in zip(a, b)])
            if len(out) == 0:
                out = np.zeros(0, dtype=bool)
            return CpuVal(dt.BOOL, out, l.valid & r.valid)
        tgt = dt.promote(l.dtype, r.dtype).to_np() if l.dtype != r.dtype \
            else l.dtype.to_np()
        a, b = l.data.astype(tgt), r.data.astype(tgt)
        if np.issubdtype(tgt, np.floating):
            an, bn = np.isnan(a), np.isnan(b)
            with np.errstate(invalid="ignore"):
                if op_name == "eq":
                    out = np.where(an | bn, an & bn, a == b)
                elif op_name == "lt":
                    out = np.where(an, False, np.where(bn, True, a < b))
                elif op_name == "le":
                    out = np.where(bn, True, np.where(an, False, a <= b))
                elif op_name == "gt":
                    out = np.where(bn, False, np.where(an, True, a > b))
                else:
                    out = np.where(an, True, np.where(bn, False, a >= b))
        else:
            ops = {"eq": np.equal, "lt": np.less, "le": np.less_equal,
                   "gt": np.greater, "ge": np.greater_equal}
            out = ops[op_name](a, b)
        return CpuVal(dt.BOOL, out, l.valid & r.valid)
    return f


def _and(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    known_false = (l.valid & ~l.data.astype(bool)) | \
                  (r.valid & ~r.data.astype(bool))
    valid = (l.valid & r.valid) | known_false
    val = l.data.astype(bool) & r.data.astype(bool) & ~known_false
    return CpuVal(dt.BOOL, val, valid)


def _or(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    known_true = (l.valid & l.data.astype(bool)) | \
                 (r.valid & r.data.astype(bool))
    valid = (l.valid & r.valid) | known_true
    val = (l.data.astype(bool) | r.data.astype(bool)) | known_true
    return CpuVal(dt.BOOL, val, valid)


def _not(e, table):
    c = evaluate(e.child, table)
    return CpuVal(dt.BOOL, ~c.data.astype(bool), c.valid)


def _in(e, table):
    v = evaluate(e.children[0], table)
    n = len(v.data)
    hit = np.zeros(n, dtype=bool)
    has_null = any(i is None for i in e.items)
    for item in e.items:
        if item is None:
            continue
        if v.dtype.is_string:
            hit |= np.array([x == item for x in v.data], dtype=bool) \
                if n else np.zeros(0, bool)
        elif v.dtype.is_floating and isinstance(item, float) and \
                math.isnan(item):
            hit |= np.isnan(v.data)
        else:
            if v.dtype.id == dt.TypeId.DATE32 and \
                    not isinstance(item, (int, np.integer)):
                item = int((np.datetime64(item, "D") -
                            np.datetime64(0, "D")).astype(int))
            elif v.dtype.id == dt.TypeId.TIMESTAMP_US and \
                    not isinstance(item, (int, np.integer)):
                item = int((np.datetime64(item, "us") -
                            np.datetime64(0, "us")).astype(int))
            hit |= (v.data == np.array(item).astype(v.data.dtype))
    valid = v.valid & (hit | (not has_null))
    return CpuVal(dt.BOOL, hit, valid)


def _isnull(e, table):
    c = evaluate(e.child, table)
    return CpuVal(dt.BOOL, ~c.valid, np.ones_like(c.valid))


def _isnotnull(e, table):
    c = evaluate(e.child, table)
    return CpuVal(dt.BOOL, c.valid.copy(), np.ones_like(c.valid))


def _isnan(e, table):
    c = evaluate(e.child, table)
    out = np.isnan(c.data) if c.dtype.is_floating else \
        np.zeros_like(c.valid)
    return CpuVal(dt.BOOL, out & c.valid, np.ones_like(c.valid))


def _coalesce(e, table):
    vals = [evaluate(c, table) for c in e.children]
    out = vals[0]
    if e.dtype.is_string:
        data = out.data.copy()
    else:
        data = out.data.astype(e.dtype.to_np())
    valid = out.valid.copy()
    for v in vals[1:]:
        take = ~valid & v.valid
        if e.dtype.is_string:
            data[take] = v.data[take]
        else:
            data = np.where(take, v.data.astype(data.dtype), data)
        valid |= v.valid
    return CpuVal(e.dtype, data, valid)


def _nanvl(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    tgt = e.dtype.to_np()
    a, b = l.data.astype(tgt), r.data.astype(tgt)
    use_b = np.isnan(a)
    return CpuVal(e.dtype, np.where(use_b, b, a),
                  np.where(use_b, r.valid, l.valid))


def _if(e, table):
    p = evaluate(e.children[0], table)
    t = evaluate(e.children[1], table)
    f = evaluate(e.children[2], table)
    cond = p.data.astype(bool) & p.valid
    if e.dtype.is_string:
        data = np.where(cond, t.data, f.data).astype(object)
    else:
        tgt = e.dtype.to_np()
        data = np.where(cond, t.data.astype(tgt), f.data.astype(tgt))
    return CpuVal(e.dtype, data, np.where(cond, t.valid, f.valid))


def _casewhen(e, table):
    n = table.num_rows
    els = e.else_value()
    if els is not None:
        cur = evaluate(els, table)
        data, valid = cur.data.copy(), cur.valid.copy()
        if not e.dtype.is_string:
            data = data.astype(e.dtype.to_np())
    else:
        data = np.array([""] * n, dtype=object) if e.dtype.is_string \
            else np.zeros(n, dtype=e.dtype.to_np())
        valid = np.zeros(n, dtype=bool)
    undecided = np.ones(n, dtype=bool)
    for cond_e, val_e in e.branches():
        c = evaluate(cond_e, table)
        v = evaluate(val_e, table)
        take = undecided & c.data.astype(bool) & c.valid
        if e.dtype.is_string:
            data[take] = v.data[take]
        else:
            data = np.where(take, v.data.astype(data.dtype), data)
        valid = np.where(take, v.valid, valid)
        undecided &= ~(c.data.astype(bool) & c.valid)
    return CpuVal(e.dtype, data, valid)


def _dunary(fn):
    def f(e, table):
        c = evaluate(e.child, table)
        with np.errstate(all="ignore"):
            out = fn(c.data.astype(np.float64))
        return CpuVal(e.dtype, out, c.valid)
    return f


def _log(e, table):
    c = evaluate(e.child, table)
    x = c.data.astype(np.float64)
    ok = x > 0
    with np.errstate(all="ignore"):
        out = np.where(ok, np.log(np.where(ok, x, 1)), 0.0)
    return CpuVal(e.dtype, out, c.valid & ok)


def _logbase(base):
    def f(e, table):
        c = evaluate(e.child, table)
        x = c.data.astype(np.float64)
        ok = x > 0
        with np.errstate(all="ignore"):
            out = np.where(ok, np.log(np.where(ok, x, 1)) / math.log(base),
                           0.0)
        return CpuVal(e.dtype, out, c.valid & ok)
    return f


def _log1p(e, table):
    c = evaluate(e.child, table)
    x = c.data.astype(np.float64)
    ok = x > -1
    with np.errstate(all="ignore"):
        out = np.where(ok, np.log1p(np.where(ok, x, 0)), 0.0)
    return CpuVal(e.dtype, out, c.valid & ok)


def _java_long_cast(x: np.ndarray) -> np.ndarray:
    """Java (long) cast: NaN->0, saturate exactly at int64 bounds.

    float64 cannot represent INT64_MAX (rounds up to 2^63), so the
    saturation must be done with explicit masks, not clip+astype.
    """
    imin, imax = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    x = np.nan_to_num(x, nan=0.0, posinf=np.inf, neginf=-np.inf)
    hi = x >= 2.0 ** 63
    lo = x <= -(2.0 ** 63)
    safe = np.clip(x, -(2.0 ** 63), np.nextafter(2.0 ** 63, 0))
    with np.errstate(invalid="ignore"):
        out = safe.astype(np.int64)
    return np.where(hi, imax, np.where(lo, imin, out))


def _ceil(e, table):
    c = evaluate(e.child, table)
    return CpuVal(e.dtype,
                  _java_long_cast(np.ceil(c.data.astype(np.float64))),
                  c.valid)


def _floor(e, table):
    c = evaluate(e.child, table)
    return CpuVal(e.dtype,
                  _java_long_cast(np.floor(c.data.astype(np.float64))),
                  c.valid)


def _pow(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    with np.errstate(all="ignore"):
        out = np.power(l.data.astype(np.float64), r.data.astype(np.float64))
    return CpuVal(e.dtype, out, l.valid & r.valid)


def _atan2(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)
    return CpuVal(e.dtype, np.arctan2(l.data.astype(np.float64),
                                      r.data.astype(np.float64)),
                  l.valid & r.valid)


def _shift(kind):
    def f(e, table):
        l, r = evaluate(e.left, table), evaluate(e.right, table)
        nbits = l.data.dtype.itemsize * 8
        sh = (r.data.astype(np.int64) % nbits)
        if kind == "left":
            out = np.left_shift(l.data, sh.astype(l.data.dtype))
        elif kind == "right":
            out = np.right_shift(l.data, sh.astype(l.data.dtype))
        else:
            u = l.data.view(np.uint32 if nbits == 32 else np.uint64)
            out = np.right_shift(u, sh.astype(u.dtype)).view(l.data.dtype)
        return CpuVal(e.dtype, out, l.valid & r.valid)
    return f


_US_PER_DAY = 86400 * 1000 * 1000


def _cast(e, table):
    c = evaluate(e.child, table)
    src, tgt = c.dtype, e.to
    if e.child.dtype == dt.NULL:
        # a void child materializes as an all-null placeholder column
        # whose runtime dtype is arbitrary — the STATIC type is the truth
        src = dt.NULL
    if src == tgt:
        return CpuVal(tgt, c.data, c.valid)
    if src == dt.NULL:
        n = len(c.data)
        data = np.array([""] * n, dtype=object) if tgt.is_string \
            else np.zeros(n, dtype=tgt.to_np())
        return CpuVal(tgt, data, np.zeros(n, dtype=bool))
    if src.is_string and tgt.is_integral:
        n = len(c.data)
        out = np.zeros(n, dtype=tgt.to_np())
        valid = c.valid.copy()
        for i in range(n):
            if not valid[i]:
                continue
            s = c.data[i].strip()
            try:
                out[i] = np.array(int(s)).astype(tgt.to_np())
            except (ValueError, OverflowError):
                valid[i] = False
        return CpuVal(tgt, out, valid)
    if src.is_string and tgt.is_floating:
        n = len(c.data)
        out = np.zeros(n, dtype=tgt.to_np())
        valid = c.valid.copy()
        for i in range(n):
            if not valid[i]:
                continue
            s = c.data[i].strip()
            # Python float() accepts '_' separators; Spark does not
            if "_" in s:
                valid[i] = False
                continue
            try:
                out[i] = float(s)
            except ValueError:
                valid[i] = False
        return CpuVal(tgt, out, valid)
    if src.is_string and tgt.is_bool:
        n = len(c.data)
        out = np.zeros(n, dtype=bool)
        valid = c.valid.copy()
        for i in range(n):
            if not valid[i]:
                continue
            s = c.data[i].strip().lower()
            if s in ("t", "true", "y", "yes", "1"):
                out[i] = True
            elif s in ("f", "false", "n", "no", "0"):
                out[i] = False
            else:
                valid[i] = False
        return CpuVal(tgt, out, valid)
    if src.is_string and tgt.id == dt.TypeId.DATE32:
        import datetime as _dtm
        n = len(c.data)
        out = np.zeros(n, dtype=np.int32)
        valid = c.valid.copy()
        for i in range(n):
            if not valid[i]:
                continue
            s = c.data[i].strip()
            try:
                d = _dtm.date.fromisoformat(s)
                if len(s) != 10:
                    raise ValueError(s)  # Spark needs zero-padded
                out[i] = (d - _dtm.date(1970, 1, 1)).days
            except ValueError:
                valid[i] = False
        return CpuVal(tgt, out, valid)
    if src.is_string and tgt.id == dt.TypeId.TIMESTAMP_US:
        # the engine's documented (incompat-gated) surface:
        # 'yyyy-MM-dd[ HH:mm:ss[.f{1,6}]]', UTC only — the oracle
        # implements EXACTLY that grammar so CPU/TPU agree
        import datetime as _dtm
        import re as _re
        pat = _re.compile(
            r"(\d{4})-(\d{2})-(\d{2})"
            r"(?:[ T](\d{2}):(\d{2}):(\d{2})(?:\.(\d{1,6}))?)?")
        n = len(c.data)
        out = np.zeros(n, dtype=np.int64)
        valid = c.valid.copy()
        epoch = _dtm.datetime(1970, 1, 1, tzinfo=_dtm.timezone.utc)
        us_td = _dtm.timedelta(microseconds=1)
        for i in range(n):
            if not valid[i]:
                continue
            s = c.data[i].strip()
            mo = pat.fullmatch(s)
            if not mo:
                valid[i] = False
                continue
            try:
                frac = (mo.group(7) or "").ljust(6, "0")
                ts = _dtm.datetime(
                    int(mo.group(1)), int(mo.group(2)),
                    int(mo.group(3)), int(mo.group(4) or 0),
                    int(mo.group(5) or 0), int(mo.group(6) or 0),
                    int(frac or 0), tzinfo=_dtm.timezone.utc)
                out[i] = (ts - epoch) // us_td
            except ValueError:
                valid[i] = False
        return CpuVal(tgt, out, valid)
    if tgt.is_string:
        out = np.array([_spark_str(x, src) for x in
                        (c.data if not src.is_string else c.data)],
                       dtype=object)
        return CpuVal(tgt, out, c.valid)
    if src.id == dt.TypeId.DATE32 and tgt.id == dt.TypeId.TIMESTAMP_US:
        return CpuVal(tgt, c.data.astype(np.int64) * _US_PER_DAY, c.valid)
    if src.id == dt.TypeId.TIMESTAMP_US and tgt.id == dt.TypeId.DATE32:
        return CpuVal(tgt, (c.data // _US_PER_DAY).astype(np.int32), c.valid)
    if src.is_bool and tgt.is_numeric:
        return CpuVal(tgt, c.data.astype(tgt.to_np()), c.valid)
    if src.is_numeric and tgt.is_bool:
        return CpuVal(tgt, c.data != 0, c.valid)
    if src.is_floating and tgt.is_integral:
        x = np.nan_to_num(c.data, nan=0.0)
        info = np.iinfo(tgt.to_np())
        x = np.clip(np.trunc(x), float(info.min), float(info.max))
        return CpuVal(tgt, x.astype(tgt.to_np()), c.valid)
    if src.is_numeric and tgt.is_numeric:
        return CpuVal(tgt, c.data.astype(tgt.to_np()), c.valid)
    if src.id == dt.TypeId.TIMESTAMP_US and tgt.id == dt.TypeId.INT64:
        return CpuVal(tgt, c.data // (1000 * 1000), c.valid)
    raise NotImplementedError(f"CPU cast {src.name}->{tgt.name}")


def _spark_str(x, src: dt.DType) -> str:
    if src.is_bool:
        return "true" if x else "false"
    if src.is_floating:
        if math.isnan(x):
            return "NaN"
        if math.isinf(x):
            return "Infinity" if x > 0 else "-Infinity"
        return repr(float(x))
    if src.id == dt.TypeId.DATE32:
        return str(np.datetime64(int(x), "D"))
    if src.id == dt.TypeId.TIMESTAMP_US:
        # Spark: space separator, fraction trimmed of trailing zeros
        s = str(np.datetime64(int(x), "us")).replace("T", " ")
        if "." in s:
            s = s.rstrip("0").rstrip(".")
        return s
    return str(x)


# strings — Python str ops (independent of the byte-matrix kernels)

def _str_unary(fn):
    def f(e, table):
        c = evaluate(e.child, table)
        out = np.array([fn(s) for s in c.data], dtype=object)
        return CpuVal(dt.STRING, out, c.valid)
    return f


def _ascii_upper(s: str) -> str:
    return "".join(chr(ord(ch) - 32) if "a" <= ch <= "z" else ch
                   for ch in s)


def _ascii_lower(s: str) -> str:
    return "".join(chr(ord(ch) + 32) if "A" <= ch <= "Z" else ch
                   for ch in s)


def _length(e, table):
    c = evaluate(e.child, table)
    out = np.array([len(s) for s in c.data], dtype=np.int32) \
        if len(c.data) else np.zeros(0, np.int32)
    return CpuVal(dt.INT32, out, c.valid)


def _substring(e, table):
    s = evaluate(e.children[0], table)
    pos = evaluate(e.children[1], table)
    ln = evaluate(e.children[2], table)
    n = len(s.data)
    out = np.empty(n, dtype=object)
    for i in range(n):
        st, p, L = s.data[i], int(pos.data[i]), int(ln.data[i])
        if p > 0:
            start = p - 1
        elif p < 0:
            start = max(len(st) + p, 0)
        else:
            start = 0
        out[i] = st[start:start + max(L, 0)]
    return CpuVal(dt.STRING, out, s.valid & pos.valid & ln.valid)


def _str_pred(fn):
    def f(e, table):
        l, r = evaluate(e.left, table), evaluate(e.right, table)
        n = len(l.data)
        valid = l.valid & r.valid
        out = np.array(
            [fn(a, b) if valid[i] else False
             for i, (a, b) in enumerate(zip(l.data, r.data))],
            dtype=bool) if n else np.zeros(0, bool)
        return CpuVal(dt.BOOL, out, valid)
    return f


def _like_match(s: str, pat: str) -> bool:
    import re
    rx = re.escape(pat).replace("%", ".*").replace("_", ".")
    # re.escape escapes % as %, _ as _ in py3.7+: they are not escaped
    return re.fullmatch(rx, s, flags=re.DOTALL) is not None


def _rlike_match(s: str, pat: str) -> bool:
    import re
    return re.search(pat, s) is not None


def _concat(e, table):
    vals = [evaluate(c, table) for c in e.children]
    n = len(vals[0].data)
    out = np.array(["".join(v.data[i] for v in vals) for i in range(n)],
                   dtype=object) if n else np.zeros(0, object)
    valid = np.ones(n, dtype=bool)
    for v in vals:
        valid &= v.valid
    return CpuVal(dt.STRING, out, valid)


def _locate(e, table):
    sub = evaluate(e.children[0], table)
    s = evaluate(e.children[1], table)
    start = evaluate(e.children[2], table)
    n = len(s.data)
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        st = int(start.data[i])
        if sub.data[i] == "":
            out[i] = st
        else:
            out[i] = s.data[i].find(sub.data[i], max(st - 1, 0)) + 1
    return CpuVal(dt.INT32, out, sub.valid & s.valid & start.valid)


def _pad(left: bool):
    def f(e, table):
        s = evaluate(e.children[0], table)
        ln = evaluate(e.children[1], table)
        pad = evaluate(e.children[2], table)
        n = len(s.data)
        out = np.empty(n, dtype=object)
        for i in range(n):
            st, L, p = s.data[i], max(int(ln.data[i]), 0), pad.data[i]
            if len(st) >= L:
                out[i] = st[:L]
            elif not p:
                out[i] = st
            else:
                fill = (p * ((L - len(st)) // len(p) + 1))[:L - len(st)]
                out[i] = fill + st if left else st + fill
        return CpuVal(dt.STRING, out, s.valid & ln.valid & pad.valid)
    return f


def _str_replace(e, table):
    s = evaluate(e.children[0], table)
    search = evaluate(e.children[1], table)
    repl = evaluate(e.children[2], table)
    n = len(s.data)
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = s.data[i].replace(search.data[i], repl.data[i]) \
            if search.data[i] else s.data[i]
    return CpuVal(dt.STRING, out, s.valid & search.valid & repl.valid)


def _substring_index(e, table):
    s = evaluate(e.children[0], table)
    delim = e.children[1].value
    count = int(e.children[2].value)
    n = len(s.data)
    out = np.empty(n, dtype=object)
    for i in range(n):
        st = s.data[i]
        if not delim or count == 0:
            out[i] = ""
        elif count > 0:
            out[i] = delim.join(st.split(delim)[:count])
        else:
            out[i] = delim.join(st.split(delim)[count:])
    return CpuVal(dt.STRING, out, s.valid.copy())


def _string_split(e, table):
    import re as _re
    s = evaluate(e.children[0], table)
    pattern = e.children[1].value
    limit = int(e.children[2].value)
    rx = _re.compile(pattern)
    n = len(s.data)
    out = np.empty(n, dtype=object)
    for i in range(n):
        # Spark: limit<=0 keeps all (dropping no trailing empties for
        # limit<0, dropping them for limit=0); limit>0 caps the count
        # (note limit=1 = no split; re.split's maxsplit=0 means unlimited)
        if limit == 1:
            parts = [s.data[i]]
        else:
            parts = rx.split(s.data[i], maxsplit=limit - 1 if limit > 0
                             else 0)
        if limit == 0:
            while parts and parts[-1] == "":
                parts.pop()
        out[i] = parts
    return CpuVal(e.dtype, out, s.valid.copy())


def _java_replacement(template: str):
    """Parse a Java Matcher-style replacement ($N group refs, backslash
    escapes the next char) into a function(match) -> str, so Python's
    template rules (octal escapes, bad-escape errors) never apply."""
    segments = []   # str literal | int group index
    i, buf = 0, []
    while i < len(template):
        ch = template[i]
        if ch == "\\" and i + 1 < len(template):
            buf.append(template[i + 1])
            i += 2
        elif ch == "$" and i + 1 < len(template) \
                and template[i + 1].isdigit():
            if buf:
                segments.append("".join(buf))
                buf = []
            j = i + 1
            while j < len(template) and template[j].isdigit():
                j += 1
            segments.append(int(template[i + 1:j]))
            i = j
        else:
            buf.append(ch)
            i += 1
    if buf:
        segments.append("".join(buf))

    def expand(m):
        return "".join(seg if isinstance(seg, str)
                       else (m.group(seg) or "") for seg in segments)
    return expand


def _regexp_replace(e, table):
    import re as _re
    s = evaluate(e.children[0], table)
    rx = _re.compile(e.children[1].value)
    repl = evaluate(e.children[2], table)
    n = len(s.data)
    out = np.empty(n, dtype=object)
    if isinstance(e.children[2], ir.Literal):
        fn = _java_replacement(e.children[2].value)
        for i in range(n):
            out[i] = rx.sub(fn, s.data[i])
    else:
        for i in range(n):
            out[i] = rx.sub(_java_replacement(repl.data[i]), s.data[i])
    return CpuVal(dt.STRING, out, s.valid & repl.valid)


def _md5(e, table):
    import hashlib
    s = evaluate(e.child, table)
    n = len(s.data)
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = hashlib.md5(
            s.data[i].encode("utf-8")).hexdigest()
    return CpuVal(dt.STRING, out, s.valid.copy())


def _at_least_n_non_nulls(e, table):
    n = table.num_rows
    count = np.zeros(n, dtype=np.int32)
    for c in e.children:
        v = evaluate(c, table)
        ok = v.valid.copy()
        if v.dtype.id in (dt.TypeId.FLOAT32, dt.TypeId.FLOAT64):
            ok &= ~np.isnan(np.where(v.valid, v.data, 0.0))
        count += ok.astype(np.int32)
    return CpuVal(dt.BOOL, count >= e.n, np.ones(n, dtype=bool))


def _from_unixtime(e, table):
    v = evaluate(e.child, table)
    secs = v.data.astype(np.int64)
    days = secs // 86400
    rem = secs - days * 86400
    dates = days.astype("datetime64[D]")
    n = len(secs)
    out = np.empty(n, dtype=object)
    for i in range(n):
        r = int(rem[i])
        out[i] = (f"{str(dates[i])} "
                  f"{r // 3600:02d}:{(r // 60) % 60:02d}:{r % 60:02d}")
    return CpuVal(dt.STRING, out, v.valid.copy())


def _input_file_name(e, table):
    from spark_rapids_tpu_torch.exec import context
    n = table.num_rows
    return CpuVal(dt.STRING,
                  np.full(n, context.input_file(), dtype=object),
                  np.ones(n, dtype=bool))


def _initcap(e, table):
    def cap(s: str) -> str:
        out = []
        prev_sep = True
        for ch in s:
            if prev_sep and "a" <= ch <= "z":
                out.append(chr(ord(ch) - 32))
            elif not prev_sep and "A" <= ch <= "Z":
                out.append(chr(ord(ch) + 32))
            else:
                out.append(ch)
            prev_sep = ch == " "
        return "".join(out)
    return _str_unary(cap)(e, table)


# temporal via numpy datetime64 (independent of civil-day math)

def _datefield(which):
    def f(e, table):
        c = evaluate(e.child, table)
        if c.dtype.id == dt.TypeId.TIMESTAMP_US:
            days = (c.data // _US_PER_DAY).astype("datetime64[D]")
        else:
            days = c.data.astype(np.int64).astype("datetime64[D]")
        Y = days.astype("datetime64[Y]")
        M = days.astype("datetime64[M]")
        if which == "year":
            out = Y.astype(int) + 1970
        elif which == "month":
            out = (M - Y).astype(int) + 1
        elif which == "day":
            out = (days - M).astype(int) + 1
        elif which == "quarter":
            out = ((M - Y).astype(int)) // 3 + 1
        elif which == "dayofweek":
            # numpy: 1970-01-01 is Thursday
            out = ((days.astype(int) + 4) % 7) + 1
        elif which == "dayofyear":
            out = (days - Y).astype(int) + 1
        elif which == "weekofyear":
            di = days.astype(int)
            wd = (di + 3) % 7
            thursday = di - wd + 3
            td = thursday.astype("datetime64[D]")
            ty = td.astype("datetime64[Y]")
            jan1 = ty.astype("datetime64[D]").astype(int)
            out = (thursday - jan1) // 7 + 1
        else:
            raise AssertionError(which)
        return CpuVal(dt.INT32, out.astype(np.int32), c.valid)
    return f


def _timefield(which):
    def f(e, table):
        c = evaluate(e.child, table)
        us = np.mod(c.data, _US_PER_DAY)
        if which == "hour":
            out = us // (3600 * 1000 * 1000)
        elif which == "minute":
            out = (us // (60 * 1000 * 1000)) % 60
        else:
            out = (us // (1000 * 1000)) % 60
        return CpuVal(dt.INT32, out.astype(np.int32), c.valid)
    return f


def _dateadd(sign):
    def f(e, table):
        l, r = evaluate(e.left, table), evaluate(e.right, table)
        out = (l.data.astype(np.int64) +
               sign * r.data.astype(np.int64)).astype(np.int32)
        return CpuVal(dt.DATE32, out, l.valid & r.valid)
    return f


def _datediff(e, table):
    l, r = evaluate(e.left, table), evaluate(e.right, table)

    def days(v):
        if v.dtype.id == dt.TypeId.TIMESTAMP_US:
            return v.data // _US_PER_DAY
        return v.data.astype(np.int64)
    return CpuVal(dt.INT32, (days(l) - days(r)).astype(np.int32),
                  l.valid & r.valid)


def _unix_ts(e, table):
    c = evaluate(e.child, table)
    return CpuVal(dt.INT64, c.data // (1000 * 1000), c.valid)


# scalar Spark murmur3 (independent reference implementation)

def _m3_mix_k1(k1: int) -> int:
    k1 = (k1 * 0xCC9E2D51) & 0xFFFFFFFF
    k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
    return (k1 * 0x1B873593) & 0xFFFFFFFF


def _m3_mix_h1(h1: int, k1: int) -> int:
    h1 ^= k1
    h1 = ((h1 << 13) | (h1 >> 19)) & 0xFFFFFFFF
    return (h1 * 5 + 0xE6546B64) & 0xFFFFFFFF


def _m3_fmix(h1: int, length: int) -> int:
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & 0xFFFFFFFF
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & 0xFFFFFFFF
    h1 ^= h1 >> 16
    return h1


def murmur3_int(v: int, seed: int) -> int:
    return _m3_fmix(_m3_mix_h1(seed & 0xFFFFFFFF,
                               _m3_mix_k1(v & 0xFFFFFFFF)), 4)


def murmur3_long(v: int, seed: int) -> int:
    lo = v & 0xFFFFFFFF
    hi = (v >> 32) & 0xFFFFFFFF
    h1 = _m3_mix_h1(seed & 0xFFFFFFFF, _m3_mix_k1(lo))
    h1 = _m3_mix_h1(h1, _m3_mix_k1(hi))
    return _m3_fmix(h1, 8)


def murmur3_bytes(b: bytes, seed: int) -> int:
    h1 = seed & 0xFFFFFFFF
    nfull = len(b) // 4
    for i in range(nfull):
        word = int.from_bytes(b[i * 4:i * 4 + 4], "little")
        h1 = _m3_mix_h1(h1, _m3_mix_k1(word))
    for i in range(nfull * 4, len(b)):
        byte = b[i]
        if byte >= 128:
            byte -= 256  # sign extension like the JVM byte
        h1 = _m3_mix_h1(h1, _m3_mix_k1(byte & 0xFFFFFFFF))
    return _m3_fmix(h1, len(b))


def _to_signed32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _murmur3(e: ir.Murmur3Hash, table):
    import struct
    n = table.num_rows
    out = np.zeros(n, dtype=np.int32)
    vals = [evaluate(c, table) for c in e.children]
    for i in range(n):
        h = e.seed
        for v in vals:
            if not v.valid[i]:
                continue
            d = v.dtype
            if d.is_string:
                h = murmur3_bytes(v.data[i].encode("utf-8"), h)
            elif d.id in (dt.TypeId.INT64, dt.TypeId.TIMESTAMP_US):
                h = murmur3_long(int(v.data[i]), h)
            elif d.id == dt.TypeId.FLOAT64:
                x = float(v.data[i])
                if x == 0.0:
                    x = 0.0
                bits = struct.unpack("<q", struct.pack("<d", x))[0]
                h = murmur3_long(bits, h)
            elif d.id == dt.TypeId.FLOAT32:
                x = np.float32(v.data[i])
                if x == 0.0:
                    x = np.float32(0.0)
                bits = struct.unpack("<i", struct.pack("<f", x))[0]
                h = murmur3_int(bits, h)
            elif d.is_bool:
                h = murmur3_int(1 if v.data[i] else 0, h)
            else:
                h = murmur3_int(int(v.data[i]), h)
        out[i] = _to_signed32(h)
    return CpuVal(dt.INT32, out, np.ones(n, dtype=bool))


def _knownfloat(e, table):
    c = evaluate(e.child, table)
    if c.dtype.is_floating:
        x = np.where(np.isnan(c.data), np.nan, c.data)
        x = np.where(x == 0.0, 0.0, x)
        return CpuVal(c.dtype, x.astype(c.data.dtype), c.valid)
    return c


def _partition_id(e, table):
    from spark_rapids_tpu_torch.exec import context
    pid, _ = context.get()
    n = table.num_rows
    return CpuVal(dt.INT32, np.full(n, int(pid), dtype=np.int32),
                  np.ones(n, dtype=bool))


def _monotonic_id(e, table):
    from spark_rapids_tpu_torch.exec import context
    pid, off = context.get()
    n = table.num_rows
    base = (int(pid) << 33) + int(off)
    return CpuVal(dt.INT64, base + np.arange(n, dtype=np.int64),
                  np.ones(n, dtype=bool))


def _rand(e: ir.Rand, table):
    # parity with the TPU path is impossible (different RNG); Rand is tagged
    # nondeterministic and excluded from parity comparisons
    rng = np.random.default_rng(e.seed)
    return CpuVal(dt.FLOAT64, rng.random(table.num_rows),
                  np.ones(table.num_rows, dtype=bool))


def _py_value(v: CpuVal, i: int) -> Any:
    """Row i of a CpuVal as the Python value a UDF would receive."""
    if not v.valid[i]:
        return None
    if v.dtype.is_string:
        return str(v.data[i])
    if v.dtype.id == dt.TypeId.DATE32:
        return (np.datetime64(0, "D") +
                np.timedelta64(int(v.data[i]), "D")).astype(object)
    if v.dtype.id == dt.TypeId.TIMESTAMP_US:
        return (np.datetime64(0, "us") +
                np.timedelta64(int(v.data[i]), "us")).astype(object)
    if v.dtype.is_bool:
        return bool(v.data[i])
    if v.dtype.is_floating:
        return float(v.data[i])
    return int(v.data[i])


def _python_udf(e: "ir.PythonUDF", table):
    if getattr(e, "vectorized", False):
        # a pandas UDF must be extracted into an ArrowEvalPython exec by
        # the planner; evaluating it row-wise would hand scalars to a
        # function expecting Series — fail loudly instead of silently
        raise NotImplementedError(
            f"pandas UDF {e.udf_name!r} in an unsupported position "
            "(supported: projections, filters, sort keys, aggregate args)")
    args = [evaluate(c, table) for c in e.children]
    n = table.num_rows
    rt = e.return_type
    valid = np.ones(n, dtype=bool)
    if rt.is_string:
        data: np.ndarray = np.empty(n, dtype=object)
    else:
        data = np.zeros(n, dtype=rt.to_np())
    for i in range(n):
        # PySpark semantics: null inputs are passed to the function as None
        # (so None-aware UDFs behave identically here and when compiled to
        # IR `is None` checks); a UDF that cannot handle None raises, as it
        # would under PySpark
        out = e.func(*[_py_value(a, i) for a in args])
        if out is None:
            valid[i] = False
            if rt.is_string:
                data[i] = ""
        elif rt.is_string:
            data[i] = str(out)
        else:
            # a result that does not fit the declared type becomes null,
            # matching PySpark's per-row coercion behavior rather than
            # failing the job
            try:
                if rt.id == dt.TypeId.DATE32:
                    data[i] = (np.datetime64(out, "D") -
                               np.datetime64(0, "D")).astype(np.int64)
                elif rt.id == dt.TypeId.TIMESTAMP_US:
                    data[i] = (np.datetime64(out, "us") -
                               np.datetime64(0, "us")).astype(np.int64)
                else:
                    data[i] = out
            except (OverflowError, ValueError, TypeError):
                valid[i] = False
    return CpuVal(rt, data, valid)



# ---------------------------------------------------------------------------
# complex types (reference: complexTypeExtractors.scala, collectionOps)
# ---------------------------------------------------------------------------

def _size(e: ir.Size, table):
    v = evaluate(e.children[0], table)
    n = len(v.data)
    out = np.full(n, -1, dtype=np.int32)   # Spark 3.0 legacy: size(null)=-1
    for i in range(n):
        if v.valid[i]:
            out[i] = len(v.data[i])
    return CpuVal(dt.INT32, out, np.ones(n, dtype=bool))


def _get_array_item(e: ir.GetArrayItem, table):
    v = evaluate(e.children[0], table)
    o = evaluate(e.children[1], table)
    el = e.dtype
    n = len(v.data)
    valid = np.zeros(n, dtype=bool)
    if el.is_string or el.is_nested:
        data = np.empty(n, dtype=object)
        data[:] = "" if el.is_string else None
    else:
        data = np.zeros(n, dtype=el.to_np())
    for i in range(n):
        if not (v.valid[i] and o.valid[i]):
            continue
        idx = int(o.data[i])
        lst = v.data[i]
        if 0 <= idx < len(lst) and lst[idx] is not None:
            x = lst[idx]
            if el.id == dt.TypeId.DATE32 and not isinstance(x, (int, np.integer)):
                x = (np.datetime64(x, "D") - np.datetime64(0, "D")).astype(int)
            if el.id == dt.TypeId.TIMESTAMP_US and not isinstance(x, (int, np.integer)):
                x = (np.datetime64(x, "us") - np.datetime64(0, "us")).astype(int)
            data[i] = x
            valid[i] = True
    return CpuVal(el, data, valid)


def _get_map_value(e: ir.GetMapValue, table):
    v = evaluate(e.children[0], table)
    k = evaluate(e.children[1], table)
    val_t = e.dtype
    n = len(v.data)
    valid = np.zeros(n, dtype=bool)
    if val_t.is_string or val_t.is_nested:
        data = np.empty(n, dtype=object)
        data[:] = "" if val_t.is_string else None
    else:
        data = np.zeros(n, dtype=val_t.to_np())
    for i in range(n):
        if not (v.valid[i] and k.valid[i]):
            continue
        for kk, vv in (v.data[i] or []):
            if kk == k.data[i] and vv is not None:
                data[i] = vv
                valid[i] = True
                break
    return CpuVal(val_t, data, valid)


def _element_at(e: ir.ElementAt, table):
    v = evaluate(e.children[0], table)
    o = evaluate(e.children[1], table)
    el = e.dtype
    n = len(v.data)
    valid = np.zeros(n, dtype=bool)
    if el.is_string or el.is_nested:
        data = np.empty(n, dtype=object)
        data[:] = "" if el.is_string else None
    else:
        data = np.zeros(n, dtype=el.to_np())
    for i in range(n):
        if not (v.valid[i] and o.valid[i]):
            continue
        k = int(o.data[i])
        lst = v.data[i]
        idx = k - 1 if k > 0 else (len(lst) + k if k < 0 else -1)
        if 0 <= idx < len(lst) and lst[idx] is not None:
            data[i] = lst[idx]
            valid[i] = True
    return CpuVal(el, data, valid)


def _array_contains(e: ir.ArrayContains, table):
    v = evaluate(e.children[0], table)
    x = evaluate(e.children[1], table)
    n = len(v.data)
    data = np.zeros(n, dtype=bool)
    valid = np.zeros(n, dtype=bool)
    for i in range(n):
        if not (v.valid[i] and x.valid[i]):
            continue
        lst = v.data[i]
        if x.data[i] in [y for y in lst if y is not None]:
            data[i] = True
            valid[i] = True
        elif any(y is None for y in lst):
            valid[i] = False   # 3-valued: unknown
        else:
            valid[i] = True
    return CpuVal(dt.BOOL, data, valid)


def _create_array(e: ir.CreateArray, table):
    vals = [evaluate(c, table) for c in e.children]
    n = table.num_rows
    el = e.dtype.element
    data = np.empty(n, dtype=object)
    for i in range(n):
        row = []
        for v in vals:
            if not v.valid[i]:
                row.append(None)
            else:
                x = v.data[i]
                row.append(x.item() if isinstance(x, np.generic) else x)
        data[i] = row
    return CpuVal(e.dtype, data, np.ones(n, dtype=bool))


def _sort_array(e: ir.SortArray, table):
    v = evaluate(e.children[0], table)
    n = len(v.data)
    data = np.empty(n, dtype=object)
    for i in range(n):
        if not v.valid[i]:
            data[i] = None
            continue
        lst = v.data[i]
        nulls = [x for x in lst if x is None]
        rest = sorted([x for x in lst if x is not None],
                      reverse=not e.ascending)
        data[i] = (nulls + rest) if e.ascending else (rest + nulls)
    return CpuVal(v.dtype, data, v.valid.copy())


_DISPATCH = {
    ir.Literal: _lit,
    ir.BoundReference: _bound,
    ir.Alias: _alias,
    ir.Add: _bin_arith(np.add),
    ir.Subtract: _bin_arith(np.subtract),
    ir.Multiply: _bin_arith(np.multiply),
    ir.Divide: _div,
    ir.IntegralDivide: _idiv,
    ir.Remainder: _mod,
    ir.Pmod: _pmod,
    ir.UnaryMinus: _neg,
    ir.UnaryPositive: lambda e, t: evaluate(e.child, t),
    ir.Abs: _abs,
    ir.EqualTo: _cmp("eq"),
    ir.LessThan: _cmp("lt"),
    ir.LessThanOrEqual: _cmp("le"),
    ir.GreaterThan: _cmp("gt"),
    ir.GreaterThanOrEqual: _cmp("ge"),
    ir.And: _and,
    ir.Or: _or,
    ir.Not: _not,
    ir.In: _in,
    ir.IsNull: _isnull,
    ir.IsNotNull: _isnotnull,
    ir.IsNan: _isnan,
    ir.Coalesce: _coalesce,
    ir.NaNvl: _nanvl,
    ir.If: _if,
    ir.CaseWhen: _casewhen,
    ir.Sqrt: _dunary(np.sqrt),
    ir.Exp: _dunary(np.exp),
    ir.Log: _log,
    ir.Log2: _logbase(2.0),
    ir.Log10: _logbase(10.0),
    ir.Log1p: _log1p,
    ir.Expm1: _dunary(np.expm1),
    ir.Sin: _dunary(np.sin),
    ir.Cos: _dunary(np.cos),
    ir.Tan: _dunary(np.tan),
    ir.Sinh: _dunary(np.sinh),
    ir.Cosh: _dunary(np.cosh),
    ir.Tanh: _dunary(np.tanh),
    ir.Asin: _dunary(np.arcsin),
    ir.Acos: _dunary(np.arccos),
    ir.Atan: _dunary(np.arctan),
    ir.Cbrt: _dunary(np.cbrt),
    ir.ToDegrees: _dunary(np.degrees),
    ir.ToRadians: _dunary(np.radians),
    ir.Rint: _dunary(np.round),
    ir.Signum: _dunary(np.sign),
    ir.Ceil: _ceil,
    ir.Floor: _floor,
    ir.Pow: _pow,
    ir.Atan2: _atan2,
    ir.ShiftLeft: _shift("left"),
    ir.ShiftRight: _shift("right"),
    ir.ShiftRightUnsigned: _shift("unsigned"),
    ir.Cast: _cast,
    ir.Upper: _str_unary(_ascii_upper),
    ir.Lower: _str_unary(_ascii_lower),
    ir.Length: _length,
    ir.Substring: _substring,
    ir.StartsWith: _str_pred(lambda a, b: a.startswith(b)),
    ir.EndsWith: _str_pred(lambda a, b: a.endswith(b)),
    ir.Contains: _str_pred(lambda a, b: b in a),
    ir.Like: _str_pred(_like_match),
    ir.RLike: _str_pred(_rlike_match),
    ir.Concat: _concat,
    ir.StringTrim: _str_unary(lambda s: s.strip(" ")),
    ir.StringTrimLeft: _str_unary(lambda s: s.lstrip(" ")),
    ir.StringTrimRight: _str_unary(lambda s: s.rstrip(" ")),
    ir.InitCap: _initcap,
    ir.StringReverse: _str_unary(lambda s: s[::-1]),
    ir.StringReplace: _str_replace,
    ir.SubstringIndex: _substring_index,
    ir.StringSplit: _string_split,
    ir.RegExpReplace: _regexp_replace,
    ir.Md5: _md5,
    ir.AtLeastNNonNulls: _at_least_n_non_nulls,
    ir.FromUnixTime: _from_unixtime,
    ir.InputFileName: _input_file_name,
    ir.StringLocate: _locate,
    ir.LPad: _pad(True),
    ir.RPad: _pad(False),
    ir.Year: _datefield("year"),
    ir.Month: _datefield("month"),
    ir.DayOfMonth: _datefield("day"),
    ir.DayOfYear: _datefield("dayofyear"),
    ir.DayOfWeek: _datefield("dayofweek"),
    ir.WeekOfYear: _datefield("weekofyear"),
    ir.Quarter: _datefield("quarter"),
    ir.Hour: _timefield("hour"),
    ir.Minute: _timefield("minute"),
    ir.Second: _timefield("second"),
    ir.DateAdd: _dateadd(1),
    ir.DateSub: _dateadd(-1),
    ir.DateDiff: _datediff,
    ir.UnixTimestampFromTs: _unix_ts,
    ir.Murmur3Hash: _murmur3,
    ir.PythonUDF: _python_udf,
    ir.KnownFloatingPointNormalized: _knownfloat,
    ir.SparkPartitionID: _partition_id,
    ir.MonotonicallyIncreasingID: _monotonic_id,
    ir.Rand: _rand,
    ir.Size: _size,
    ir.GetArrayItem: _get_array_item,
    ir.GetMapValue: _get_map_value,
    ir.ArrayContains: _array_contains,
    ir.ElementAt: _element_at,
    ir.CreateArray: _create_array,
    ir.SortArray: _sort_array,
}
