"""The port's string and string-cast device expressions vs the reference's.

Each expression of ``expr/eval_tpu.py``'s string group and each cast to
or from a string goes through ``eval_tpu.evaluate`` in both packages
over the same seeded batch: validity exactly, string bytes and lengths
exactly, integers and bools exactly.  String -> float is held to
``tests/parity.py``'s tolerance: the port keeps the reference's Horner
order for the mantissa but scales it by a correctly rounded power of ten
from a table, the same bits on the CPU and the card, where the
reference's XLA pow is an ulp off at some exponents (10^-5, 10^23) and
flushes 10^-308 and below to zero; a test pins that the port's scale is
the correctly rounded one.  The cases follow the reference's
``tests/test_expressions.py``: string basics, predicates, substring and
concat, pad and locate, general LIKE, column needles and every string
cast.  The planner keeps a non-literal LIKE pattern, locate argument or
pad argument, and a float -> string cast, on the CPU with the
reference's reasons.  A ``startswith`` filter over a fused Parquet scan
is pushed into the scan and counts the reference's
``scan.filterDecode.condition_column`` fallbacks.
"""

import math
from fractions import Fraction

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.config import RapidsTpuConf as JConf
from spark_rapids_tpu.expr import eval_tpu as jev
from spark_rapids_tpu.expr import ir as jir
from spark_rapids_tpu.obs import registry as jreg
from spark_rapids_tpu.plan import overrides as jov

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.columnar.batch import from_arrow as tfrom_arrow
from spark_rapids_tpu_torch.config import RapidsTpuConf as TConf
from spark_rapids_tpu_torch.expr import eval_tpu as tev
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.plan import overrides as tov

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 160
I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1
# bytes the random strings draw from: LIKE's wildcards as plain bytes,
# spaces, both cases and a two-byte character
ALPHABET = list("abcAB _%") + ["é"]


def _nullify(rng, vals, p=0.12):
    return [None if rng.random() < p else v for v in vals]


def _words(rng, n, max_len, fixed):
    out = list(fixed)
    while len(out) < n:
        k = int(rng.integers(0, max_len + 1))
        out.append("".join(ALPHABET[i] for i in
                           rng.integers(0, len(ALPHABET), k)))
    return out


def _pick(rng, pool, n):
    return [pool[i] for i in rng.integers(0, len(pool), n)]


INT_TEXT = ["1", "-42", " 12 ", "+7", "x", "", "999999999999", "1.5",
            "-0", "00012", "9223372036854775807", "-9223372036854775808",
            "99999999999999999999", "+", "-", " ", "12a", "\t3"]
FLOAT_TEXT = ["1.5", "-2.25", " 42 ", "1e3", "-4.5E-2", "0.0", "", "abc",
              "1.2.3", "Infinity", "-Infinity", "NaN", "+7.125",
              "123456789.5", "00012", "inf", "-INF", "nan", "1e", "e5",
              ".5", "5.", "1e-400", "1e400", "2.5e+3", "1e999999",
              "123456789012345678901234567890", "0.1", "\t7.5\n", "-.0",
              "1e-5", "1e23", "2.5e-310"]
BOOL_TEXT = ["true", "FALSE", "y", "N", "1", "0", "maybe", "", " t ",
             "Yes", "no", "tr", "\ttrue", "f"]
DATE_TEXT = ["2024-02-29", "1999-12-31", "2024-13-01", "bad", "",
             "1970-01-01", "2024-1-1", " 2024-03-05 ", "2024-03-05x",
             "2023-02-29", "2024-02-30", "2024-04-31", "2100-02-29",
             "2000-02-29", "0001-01-01", "9999-12-31", "1582-10-15",
             "1900-02-29", "2024-00-10", "2024-01-00"]


def _table() -> pa.Table:
    rng = np.random.default_rng(23)
    s = _words(rng, N, 13, ["", "abc", " a b ", "ABC abc", "a_c", "a%c",
                            "ab", "ba", "aéb", "  ", "héllo wörld",
                            "abcabcabc"])
    needle = _words(rng, N, 3, ["", "a", "bc", "abcd", "é", " "])
    i64 = list(rng.integers(-10 ** 6, 10 ** 6, N))
    i64[:8] = [0, 1, -1, I64_MAX, I64_MIN, 10, -100, 1234567890123]
    return pa.table({
        "s": pa.array(_nullify(rng, s)),
        "n": pa.array(_nullify(rng, needle)),
        "pos": pa.array(_nullify(rng, [int(v) for v in
                                       rng.integers(-6, 8, N)]), pa.int32()),
        "it": pa.array(_nullify(rng, _pick(rng, INT_TEXT, N))),
        "ft": pa.array(_nullify(rng, _pick(rng, FLOAT_TEXT, N))),
        "bt": pa.array(_nullify(rng, _pick(rng, BOOL_TEXT, N))),
        "dtx": pa.array(_nullify(rng, _pick(rng, DATE_TEXT, N))),
        "i64": pa.array(_nullify(rng, [int(v) for v in i64]), pa.int64()),
        "i32": pa.array(_nullify(rng, [int(v) for v in
                                       rng.integers(-2 ** 31, 2 ** 31, N)]),
                        pa.int32()),
        "i8": pa.array(_nullify(rng, [int(v) for v in
                                      rng.integers(-128, 128, N)]),
                       pa.int8()),
        "b": pa.array(_nullify(rng, [bool(v) for v in
                                     rng.integers(0, 2, N)]), pa.bool_()),
    })


TABLE = _table()
TYPES = {"s": "STRING", "n": "STRING", "pos": "INT32", "it": "STRING",
         "ft": "STRING", "bt": "STRING", "dtx": "STRING", "i64": "INT64",
         "i32": "INT32", "i8": "INT8", "b": "BOOL"}


class _Side:
    """An expression builder over one package's ``ir`` and ``dtypes``."""

    def __init__(self, ir, dt):
        self.ir, self.dt = ir, dt

    def c(self, name):
        return self.ir.UnresolvedAttribute(name)

    def bind(self, e):
        return self.ir.bind(e, TABLE.column_names,
                            [getattr(self.dt, TYPES[n])
                             for n in TABLE.column_names])

    def lit(self, v, dtype=None):
        return self.ir.Literal(v, getattr(self.dt, dtype) if dtype else None)

    def cast(self, name, to):
        return self.ir.Cast(self.c(name), getattr(self.dt, to))


def _sub(pos, length):
    return lambda x: x.ir.Substring(x.c("s"), x.lit(pos), x.lit(length))


def _pad(kind, length, fill):
    return lambda x: getattr(x.ir, kind)(x.c("s"), x.lit(length),
                                         x.lit(fill))


def _locate(needle, start):
    return lambda x: x.ir.StringLocate(x.lit(needle), x.c("s"),
                                       x.lit(start))


LIKE_PATTERNS = ["a%", "%z", "%mid%", "a_c", "_bc", "ab_", "a%c", "a_%_c",
                 "%a_b%", "", "%", "abc", "a%b%c", "%%x%%", "%b", "_",
                 "%é%", "a%%", "%_%", "__"]

# name -> builder(side) -> expression
EXPRS = {
    "upper": lambda x: x.ir.Upper(x.c("s")),
    "lower": lambda x: x.ir.Lower(x.c("s")),
    "length_utf8": lambda x: x.ir.Length(x.c("s")),
    "reverse": lambda x: x.ir.StringReverse(x.c("s")),
    "trim": lambda x: x.ir.StringTrim(x.c("s")),
    "ltrim": lambda x: x.ir.StringTrimLeft(x.c("s")),
    "rtrim": lambda x: x.ir.StringTrimRight(x.c("s")),
    "initcap": lambda x: x.ir.InitCap(x.c("s")),
    "substr_2_3": _sub(2, 3),
    "substr_neg_2_2": _sub(-2, 2),
    "substr_0_4": _sub(0, 4),
    "substr_neg_past_start": _sub(-20, 5),
    "substr_zero_length": _sub(3, 0),
    "substr_negative_length": _sub(1, -3),
    "substr_past_the_end": _sub(30, 2),
    "substr_column_pos": lambda x: x.ir.Substring(x.c("s"), x.c("pos"),
                                                  x.lit(3)),
    "startswith": lambda x: x.ir.StartsWith(x.c("s"), x.lit("a")),
    "startswith_multibyte": lambda x: x.ir.StartsWith(x.c("s"),
                                                      x.lit("aé")),
    "startswith_empty": lambda x: x.ir.StartsWith(x.c("s"), x.lit("")),
    "startswith_wider_than_column":
        lambda x: x.ir.StartsWith(x.c("s"), x.lit("a" * 40)),
    "endswith": lambda x: x.ir.EndsWith(x.c("s"), x.lit("b")),
    "endswith_two": lambda x: x.ir.EndsWith(x.c("s"), x.lit("bc")),
    "endswith_empty": lambda x: x.ir.EndsWith(x.c("s"), x.lit("")),
    "contains": lambda x: x.ir.Contains(x.c("s"), x.lit("ab")),
    "contains_empty": lambda x: x.ir.Contains(x.c("s"), x.lit("")),
    "contains_wider_than_column":
        lambda x: x.ir.Contains(x.c("s"), x.lit("b" * 40)),
    "startswith_column": lambda x: x.ir.StartsWith(x.c("s"), x.c("n")),
    "endswith_column": lambda x: x.ir.EndsWith(x.c("s"), x.c("n")),
    "contains_column": lambda x: x.ir.Contains(x.c("s"), x.c("n")),
    "like_null": lambda x: x.ir.Like(x.c("s"), x.lit(None, "STRING")),
    "concat": lambda x: x.ir.Concat(x.c("s"), x.lit("-"), x.c("s")),
    "concat_nullable_parts": lambda x: x.ir.Concat(x.c("n"), x.c("s"),
                                                   x.c("n")),
    "concat_one": lambda x: x.ir.Concat(x.c("n")),
    "lpad_longer": _pad("LPad", 5, "*"),
    "rpad_cycles": _pad("RPad", 5, "xy"),
    "lpad_cycles": _pad("LPad", 9, "xyz"),
    "lpad_shorter": _pad("LPad", 2, "*"),
    "lpad_negative": _pad("LPad", -1, "*"),
    "rpad_zero": _pad("RPad", 0, "z"),
    "rpad_empty_fill": _pad("RPad", 4, ""),
    "lpad_empty_fill": _pad("LPad", 20, ""),
    "rpad_wide": _pad("RPad", 33, "ab"),
    "locate": _locate("b", 1),
    "locate_from_3": _locate("a", 3),
    "locate_two_bytes": _locate("bc", 1),
    "locate_empty": _locate("", 2),
    "locate_wider_than_column": _locate("a" * 40, 1),
    "cast_string_to_bigint": lambda x: x.cast("it", "INT64"),
    "cast_string_to_int": lambda x: x.cast("it", "INT32"),
    "cast_string_to_tinyint": lambda x: x.cast("it", "INT8"),
    "cast_string_to_double": lambda x: x.cast("ft", "FLOAT64"),
    "cast_string_to_float": lambda x: x.cast("ft", "FLOAT32"),
    "cast_int_text_to_double": lambda x: x.cast("it", "FLOAT64"),
    "cast_string_to_bool": lambda x: x.cast("bt", "BOOL"),
    "cast_string_to_date": lambda x: x.cast("dtx", "DATE32"),
    "cast_words_to_int": lambda x: x.cast("s", "INT64"),
    "cast_bigint_to_string": lambda x: x.cast("i64", "STRING"),
    "cast_int_to_string": lambda x: x.cast("i32", "STRING"),
    "cast_tinyint_to_string": lambda x: x.cast("i8", "STRING"),
    "cast_bool_to_string": lambda x: x.cast("b", "STRING"),
}
for _p in LIKE_PATTERNS:
    EXPRS[f"like[{_p}]"] = (lambda p: lambda x: x.ir.Like(x.c("s"),
                                                          x.lit(p)))(_p)


@pytest.fixture(scope="module")
def batches():
    return jfrom_arrow(TABLE), tfrom_arrow(TABLE, device="cpu")


# the string -> float casts, held to tests/parity.py's tolerance
FLOAT_PARSES = ("cast_string_to_double", "cast_string_to_float",
                "cast_int_text_to_double")


def assert_same(jv, tv, approx_float=False):
    """Validity exactly; string bytes and lengths, integers, bools and
    floats (by their bit patterns, or to tests/parity.py's tolerance with
    ``approx_float``) exactly at every valid row."""
    assert tv.dtype.name == jv.dtype.name
    valid = np.asarray(jv.validity)
    np.testing.assert_array_equal(tv.validity.numpy(), valid)
    jd, td = np.asarray(jv.data), tv.data.numpy()
    if jv.dtype.is_string:
        jl, tl = np.asarray(jv.lengths), tv.lengths.numpy()
        np.testing.assert_array_equal(tl[valid], jl[valid])
        assert td.shape[1] == jd.shape[1]
        for i in np.flatnonzero(valid):
            assert bytes(td[i, :tl[i]]) == bytes(jd[i, :jl[i]]), i
            assert not td[i, tl[i]:].any(), i
        return
    if jv.dtype.is_floating and approx_float:
        bad = [i for i in np.flatnonzero(valid) if not math.isclose(
            float(td[i]), float(jd[i]), rel_tol=1e-9, abs_tol=1e-11) and
            not (math.isnan(td[i]) and math.isnan(jd[i]))]
        assert not bad, [(float(td[i]), float(jd[i])) for i in bad]
        return
    if jv.dtype.is_floating:
        jd = jd.astype(td.dtype)
        np.testing.assert_array_equal(
            td[valid].view(f"i{td.itemsize}"),
            jd[valid].view(f"i{td.itemsize}"))
        return
    np.testing.assert_array_equal(td[valid], jd[valid].astype(td.dtype))


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(name, batches):
    jb, tb = batches
    jside, tside = _Side(jir, jdt), _Side(tir, tdt)
    je = jside.bind(EXPRS[name](jside))
    te = tside.bind(EXPRS[name](tside))
    assert tev.supported_on_tpu(type(te)) and jev.supported_on_tpu(type(je))
    if isinstance(te, tir.Cast):
        assert tev.cast_supported(te.child.dtype, te.to)
    assert_same(jev.evaluate(je, jb), tev.evaluate(te, tb),
                approx_float=name in FLOAT_PARSES)


def test_string_to_float_scales_by_correctly_rounded_powers():
    """Every power of ten in the table is the correctly rounded one, and
    a mantissa of 1 (or one whose product with a normal power is exact)
    scaled by it parses as Python's float()."""
    table = tev._pow10_f64(torch.zeros(0)).numpy()
    for k in range(tev._P10_LO, tev._P10_HI + 1):
        want = float(Fraction(10) ** k) if k <= 308 else math.inf
        assert table[k - tev._P10_LO] == want, k
    text = ["1e-5", "1e23", "1e-310", "1e-320", "1e308", "1e309",
            "0.000001", "3e22", "1e-300"]
    t = pa.table({"s": pa.array(text)})
    e = tir.bind(tir.Cast(tir.UnresolvedAttribute("s"), tdt.FLOAT64), ["s"],
                 [tdt.STRING])
    got = tev.evaluate(e, tfrom_arrow(t, device="cpu")).data.numpy()
    assert got[:len(text)].tolist() == [float(x) for x in text]


def test_string_group_dispatch_is_the_references():
    """Every dispatch key of the reference's string group, StringReverse
    and the date/time group is in the port's table."""
    names = ("Upper Lower Length Substring StartsWith EndsWith Contains Like "
             "Concat StringTrim StringTrimLeft StringTrimRight InitCap "
             "StringLocate LPad RPad StringReverse Year Month DayOfMonth "
             "DayOfYear DayOfWeek WeekOfYear Quarter Hour Minute Second "
             "DateAdd DateSub DateDiff UnixTimestampFromTs").split()
    for n in names:
        assert jev.supported_on_tpu(getattr(jir, n)), n
        assert tev.supported_on_tpu(getattr(tir, n)), n


@pytest.mark.parametrize("src,to,covered", [
    ("STRING", "INT64", True), ("STRING", "INT32", True),
    ("STRING", "INT16", True), ("STRING", "INT8", True),
    ("STRING", "FLOAT64", True), ("STRING", "FLOAT32", True),
    ("STRING", "BOOL", True), ("STRING", "DATE32", True),
    ("STRING", "TIMESTAMP_US", True), ("INT64", "STRING", True),
    ("INT32", "STRING", True), ("INT16", "STRING", True),
    ("INT8", "STRING", True), ("BOOL", "STRING", True),
    ("DATE32", "STRING", True), ("TIMESTAMP_US", "STRING", True),
    ("FLOAT64", "STRING", True), ("FLOAT32", "STRING", True),
    ("STRING", "STRING", True)])
def test_cast_supported_names_exactly_the_ported_pairs(src, to, covered):
    assert tev.cast_supported(getattr(tdt, src), getattr(tdt, to)) is covered


def _reason(ov, ir, dt, conf, e):
    e = ir.bind(e, ["s", "t", "f"], [dt.STRING, dt.STRING, dt.FLOAT64])
    reasons = []

    def walk(n):
        r = ov._check_expr_node(n, conf)
        if r:
            reasons.append(r)
        for c in n.children:
            walk(c)
    walk(e)
    return reasons


# name -> (builder(ir, dt), conf) of an expression the planner keeps on
# the CPU
FALLBACKS = {
    "like_column_pattern": (lambda ir, dt: ir.Like(
        ir.UnresolvedAttribute("s"), ir.UnresolvedAttribute("t")), {}),
    "locate_column_needle": (lambda ir, dt: ir.StringLocate(
        ir.UnresolvedAttribute("t"), ir.UnresolvedAttribute("s"),
        ir.Literal(1)), {}),
    "lpad_column_fill": (lambda ir, dt: ir.LPad(
        ir.UnresolvedAttribute("s"), ir.Literal(5),
        ir.UnresolvedAttribute("t")), {}),
    "rpad_column_fill": (lambda ir, dt: ir.RPad(
        ir.UnresolvedAttribute("s"), ir.Literal(5),
        ir.UnresolvedAttribute("t")), {}),
    "float_to_string_disabled": (lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("f"), dt.STRING),
        {"spark.rapids.tpu.sql.castFloatToString.enabled": False}),
    "string_to_float_disabled": (lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("s"), dt.FLOAT64), {}),
    "string_to_timestamp_utc": (lambda ir, dt: ir.Cast(
        ir.UnresolvedAttribute("s"), dt.TIMESTAMP_US), {}),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_planner_keeps_the_references_fallback_reason(name):
    build, conf = FALLBACKS[name]
    want = _reason(jov, jir, jdt, JConf(conf), build(jir, jdt))
    got = _reason(tov, tir, tdt, TConf(conf), build(tir, tdt))
    assert want and got == want


def test_float_to_string_waits_for_ryu():
    """With the cast enabled (the default) both packages print floats on
    the device (each package's expr/ryu.py): neither planner gives a
    reason to keep the cast on the CPU."""
    conf = {}
    e = tir.Cast(tir.UnresolvedAttribute("f"), tdt.STRING)
    assert _reason(tov, tir, tdt, TConf(conf), e) == []
    assert _reason(jov, jir, jdt, JConf(conf),
                   jir.Cast(jir.UnresolvedAttribute("f"), jdt.STRING)) == []


@pytest.fixture(scope="module")
def reason_files(tmp_path_factory):
    """A reason-like table with a dictionary string description."""
    d = tmp_path_factory.mktemp("startswith")
    rng = np.random.default_rng(7)
    descs = np.array([f"reason {k}" for k in range(35)])
    n = 2000
    for i in range(2):
        t = pa.table({
            "r_reason_sk": pa.array(np.arange(i * n, (i + 1) * n,
                                              dtype=np.int64)),
            "r_reason_desc": pa.array(descs[rng.integers(0, 35, n)]),
            "r_code": pa.array(np.array(["c%d" % k for k in range(30)])[
                rng.integers(0, 30, n)]),
            "r_weight": pa.array(rng.uniform(0, 10, n))})
        papq.write_table(t, str(d / f"part-{i}.parquet"))
    return str(d)


def _startswith_query(s, col, root):
    return (s.read.parquet(root)
            .filter(col("r_reason_desc").startswith("reason 2"))
            .select("r_reason_sk", "r_reason_desc", "r_code", "r_weight"))


def test_startswith_filter_is_pushed_into_the_fused_scan(reason_files):
    conf = {"spark.rapids.tpu.sql.test.enabled": True}
    reg = jreg.get_registry()
    key = "kernel.backend.pallas.fallbacks.scan.filterDecode." \
        "condition_column"
    before = reg.counter(key)
    ref = _startswith_query(JSession(conf), jcol, reason_files).collect()
    ref_fallbacks = reg.counter(key) - before

    s = TSession(conf, device="cpu")
    df = _startswith_query(s, tcol, reason_files)
    nodes = []
    s._plan_physical(df.plan).plan.foreach(nodes.append)
    (scan,) = [n for n in nodes if type(n).__name__ == "TpuParquetScanExec"]
    assert isinstance(scan._pushed_filter, tir.StartsWith)
    assert not [n for n in nodes if type(n).__name__.startswith("Cpu")
                and type(n).__name__ != "CpuScanExec"]
    kb.reset_counts()
    got = df.collect()
    assert_tables_equal(ref, got)
    assert ref.num_rows > 0 and ref_fallbacks >= 1
    assert kb.fallbacks == {"scan.filterDecode.condition_column":
                            ref_fallbacks}
