"""The port's date/time device expressions vs the reference's.

Each expression of ``expr/eval_tpu.py``'s date/time group, and the casts
between dates, timestamps and strings, goes through
``eval_tpu.evaluate`` in both packages over the same seeded batch:
validity, integers and string bytes exactly.  The dates run from before
the Gregorian switch and year 0 through 9999-12-31 and past it, with
dates before 1970; the timestamps include negative ones and INT64_MIN.
The civil-calendar conversions (the reference defines each twice; the
later pair runs) are held at their edges.  One divergence is pinned:
the reference's string -> timestamp multiplies int32 days by 86400 in
int32 and wraps outside 1901-12-14 .. 2038-01-19, where the port
computes in int64 and equals numpy's datetime64.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.expr import eval_tpu as jev
from spark_rapids_tpu.expr import ir as jir

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar.batch import from_arrow as tfrom_arrow
from spark_rapids_tpu_torch.expr import eval_tpu as tev
from spark_rapids_tpu_torch.expr import ir as tir

from tests.test_torch_strings import assert_same
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 192
I64_MIN = -2 ** 63
US_PER_DAY = 86_400_000_000


def _days(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


# year 0, a negative year, the Gregorian switch, 1900, the epoch and the
# day before it, leap days, 2038, 9999-12-31 and past it
EDGE_DAYS = [_days(s) for s in (
    "0000-01-01", "0000-02-29", "-0001-12-31", "-0400-03-01", "1582-10-15",
    "1582-10-04", "1900-01-01", "1900-03-01", "1969-12-31", "1970-01-01",
    "2000-02-29", "2024-12-31", "2038-01-19", "2100-03-01", "9999-12-31",
    "10000-01-01")] + [-10 ** 7, 10 ** 7, -1, 0]
# the calendar overflow of the reference's test_expressions.py, and the
# layout's edges
DATE_TEXT = ["2024-02-29", "2023-02-29", "2024-02-30", "2024-04-31",
             "2024-12-31", "2100-02-29", "2000-02-29", "1582-10-15",
             "1969-12-31", "0001-01-01", "9999-12-31", "1900-02-29",
             " 2024-03-05 ", "2024-03-05x", "2024-1-1", "bad", ""]
# years 1902-2037: where the reference's int32 day seconds do not wrap
TS_TEXT = ["2024-03-05 12:34:56", "2024-03-05", "1970-01-01 00:00:00",
           "2024-03-05 12:34:56.123", "2024-03-05 12:34:56.123456",
           "2024-03-05 12:34:56.1234567", "2024-03-05 12:34:56.",
           "bad", "", "2024-02-30 01:02:03", "2024-03-05T07:08:09",
           "1969-12-31 23:59:59.999999", "1902-01-01 00:00:01",
           "2037-12-31 23:59:59", "2024-03-05 24:00:00",
           "2024-03-05 12:60:00", "2024-03-05 12:34", " 2024-03-05 01:02:03",
           "2024-03-05 01:02:03 ", "2024-03-05 1:02:03"]


def _nullify(rng, vals, p=0.1):
    return [None if rng.random() < p else v for v in vals]


def _table() -> pa.Table:
    rng = np.random.default_rng(29)
    d = EDGE_DAYS + [int(v) for v in rng.integers(
        _days("1582-01-01"), _days("9999-12-31"), N - len(EDGE_DAYS))]
    d2 = [int(v) for v in rng.integers(-200_000, 200_000, N)]
    t = [I64_MIN, -1, 0, 1, -US_PER_DAY, -US_PER_DAY - 1, 999_999,
         -999_999, 253402300799999999] + [
        int(v) for v in rng.integers(-2 ** 62, 2 ** 62, N - 9)]
    t2 = [int(v) for v in rng.integers(-US_PER_DAY * 10 ** 5,
                                       US_PER_DAY * 10 ** 5, N)]
    return pa.table({
        "d": pa.array(_nullify(rng, d), pa.int32()).cast(pa.date32()),
        "d2": pa.array(_nullify(rng, d2), pa.int32()).cast(pa.date32()),
        "t": pa.array(_nullify(rng, t), pa.int64()).cast(
            pa.timestamp("us")),
        "t2": pa.array(_nullify(rng, t2), pa.int64()).cast(
            pa.timestamp("us")),
        "n": pa.array(_nullify(rng, [int(v) for v in rng.integers(
            -100_000, 100_000, N)]), pa.int32()),
        "dt": pa.array(_nullify(rng, [DATE_TEXT[i] for i in rng.integers(
            0, len(DATE_TEXT), N)])),
        "tt": pa.array(_nullify(rng, [TS_TEXT[i] for i in rng.integers(
            0, len(TS_TEXT), N)])),
    })


TABLE = _table()
TYPES = {"d": "DATE32", "d2": "DATE32", "t": "TIMESTAMP_US",
         "t2": "TIMESTAMP_US", "n": "INT32", "dt": "STRING",
         "tt": "STRING"}


def _bind(ir, dt, e):
    return ir.bind(e, TABLE.column_names,
                   [getattr(dt, TYPES[n]) for n in TABLE.column_names])


FIELDS = ("Year", "Month", "DayOfMonth", "DayOfYear", "DayOfWeek",
          "WeekOfYear", "Quarter")

# name -> builder(ir, dt) -> expression
EXPRS = {}
for _f in FIELDS:
    for _c in ("d", "t2"):
        EXPRS[f"{_f.lower()}({_c})"] = (
            lambda f, c: lambda ir, dt: getattr(ir, f)(
                ir.UnresolvedAttribute(c)))(_f, _c)
for _f in ("Hour", "Minute", "Second"):
    for _c in ("t", "t2"):
        EXPRS[f"{_f.lower()}({_c})"] = (
            lambda f, c: lambda ir, dt: getattr(ir, f)(
                ir.UnresolvedAttribute(c)))(_f, _c)
EXPRS.update({
    "date_add": lambda ir, dt: ir.DateAdd(ir.UnresolvedAttribute("d"),
                                          ir.UnresolvedAttribute("n")),
    "date_add_literal": lambda ir, dt: ir.DateAdd(
        ir.UnresolvedAttribute("d2"), ir.Literal(30)),
    "date_sub": lambda ir, dt: ir.DateSub(ir.UnresolvedAttribute("d"),
                                          ir.UnresolvedAttribute("n")),
    "date_diff": lambda ir, dt: ir.DateDiff(ir.UnresolvedAttribute("d"),
                                            ir.UnresolvedAttribute("d2")),
    "date_diff_of_added": lambda ir, dt: ir.DateDiff(
        ir.UnresolvedAttribute("d2"),
        ir.DateAdd(ir.UnresolvedAttribute("d2"),
                   ir.UnresolvedAttribute("n"))),
    "date_diff_timestamps": lambda ir, dt: ir.DateDiff(
        ir.UnresolvedAttribute("t2"), ir.UnresolvedAttribute("t")),
    "unix_timestamp": lambda ir, dt: ir.UnixTimestampFromTs(
        ir.UnresolvedAttribute("t")),
    "cast_date_to_string": lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("d"), dt.STRING),
    "cast_timestamp_to_string": lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("t"), dt.STRING),
    "cast_near_timestamp_to_string": lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("t2"), dt.STRING),
    "cast_string_to_date": lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("dt"), dt.DATE32),
    "cast_string_to_timestamp": lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("tt"), dt.TIMESTAMP_US),
    "cast_date_to_timestamp": lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("d"), dt.TIMESTAMP_US),
    "cast_timestamp_to_date": lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("t"), dt.DATE32),
    "cast_timestamp_to_bigint": lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("t2"), dt.INT64),
})


@pytest.fixture(scope="module")
def batches():
    return jfrom_arrow(TABLE), tfrom_arrow(TABLE, device="cpu")


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(name, batches):
    jb, tb = batches
    je = _bind(jir, jdt, EXPRS[name](jir, jdt))
    te = _bind(tir, tdt, EXPRS[name](tir, tdt))
    assert tev.supported_on_tpu(type(te)) and jev.supported_on_tpu(type(je))
    assert_same(jev.evaluate(je, jb), tev.evaluate(te, tb))


def test_civil_conversions_at_the_edges():
    """Days -> (y, m, d) -> days round-trips at the edges, the fields
    equal numpy's calendar, and both equal the reference's conversions
    (its later definitions, the ones its casts run)."""
    days = np.array(EDGE_DAYS + list(range(-800, 800, 7)), dtype=np.int64)
    y, m, d = tev._civil_from_days(torch.from_numpy(days))
    jy, jm, jd = (np.asarray(a) for a in jev._civil_from_days(days))
    np.testing.assert_array_equal(y.numpy(), jy)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(d.numpy(), jd)
    back = tev._days_from_civil(y, m, d)
    np.testing.assert_array_equal(back.numpy(), days)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jev._days_from_civil(jy, jm, jd)))
    dt64 = days.astype("datetime64[D]")
    years = dt64.astype("datetime64[Y]").astype(np.int64) + 1970
    months = dt64.astype("datetime64[M]").astype(np.int64) % 12 + 1
    doms = (dt64 - dt64.astype("datetime64[M]")).astype(np.int64) + 1
    np.testing.assert_array_equal(y.numpy(), years)
    np.testing.assert_array_equal(m.numpy(), months)
    np.testing.assert_array_equal(d.numpy(), doms)


def test_string_to_timestamp_outside_the_int32_day_seconds():
    """Pinned divergence: outside 1901-12-14 .. 2038-01-19 the
    reference's int32 ``days * 86400`` wraps; the port's int64 equals
    numpy's datetime64, and equals the reference inside the range."""
    text = ["2040-01-01 00:00:00", "1800-01-01 01:02:03", "9999-12-31",
            "1582-10-15 12:00:00.5", "0001-01-01", "2024-03-05 12:34:56"]
    t = pa.table({"s": pa.array(text)})
    jv = jev.evaluate(jir.bind(jir.Cast(jir.UnresolvedAttribute("s"),
                                        jdt.TIMESTAMP_US), ["s"],
                               [jdt.STRING]), jfrom_arrow(t))
    tv = tev.evaluate(tir.bind(tir.Cast(tir.UnresolvedAttribute("s"),
                                        tdt.TIMESTAMP_US), ["s"],
                               [tdt.STRING]), tfrom_arrow(t, device="cpu"))
    want = np.array([s.replace(" ", "T") for s in text],
                    dtype="datetime64[us]").astype(np.int64)
    got, ref = tv.data.numpy()[:len(text)], np.asarray(jv.data)[:len(text)]
    assert tv.validity.numpy()[:len(text)].all()
    np.testing.assert_array_equal(got, want)
    assert got[-1] == ref[-1]
    assert (got[:-1] != ref[:-1]).all()
