"""The port's numeric and conditional device expressions vs the reference's.

Each expression of ``expr/eval_tpu.py``'s numeric and conditional group
goes through ``eval_tpu.evaluate`` in both packages over the same
seeded batch of nullable int32, int64, float64, bool and string columns:
validity exactly, integers, bools and string bytes exactly, floats to
``tests/parity.py``'s tolerance.  A filter with ``isin`` over a fused
Parquet scan is pushed into the scan, and counts the reference's
``scan.filterDecode.condition_column`` fallbacks.
"""

import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.expr import eval_tpu as jev
from spark_rapids_tpu.expr import ir as jir
from spark_rapids_tpu.obs import registry as jreg

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.columnar.batch import from_arrow as tfrom_arrow
from spark_rapids_tpu_torch.expr import eval_tpu as tev
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.kernels import backend as kb

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 96
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1


def _nullify(rng, vals, p=0.15):
    return [None if rng.random() < p else v for v in vals]


def _table() -> pa.Table:
    rng = np.random.default_rng(11)
    i32 = list(rng.integers(-9, 10, N))
    i32[:6] = [I32_MIN, I32_MAX, 0, -1, 1, -7]
    i64 = list(rng.integers(-12, 13, N))
    i64[:6] = [I64_MIN, I64_MAX, 0, -1, 3, I64_MIN]
    j64 = list(rng.integers(-4, 5, N))       # divisors: zeros, negatives
    j64[:6] = [-1, -1, 0, 2, 0, 1]
    f64 = list(rng.normal(0, 20, N))
    f64[:10] = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0,
                -3.5, 2.5, -1.0, 1e300, -0.5]
    g64 = list(rng.normal(0, 3, N))
    g64[:4] = [0.0, float("nan"), -2.0, 0.5]
    sh = list(rng.integers(-70, 70, N))
    sh[:6] = [31, 63, 32, 64, -1, 0]
    words = ["ab", "", "abc", "zz", "Sports", "Books", "a b"]
    return pa.table({
        "i32": pa.array(_nullify(rng, [int(v) for v in i32]), pa.int32()),
        "i64": pa.array(_nullify(rng, [int(v) for v in i64]), pa.int64()),
        "j64": pa.array(_nullify(rng, [int(v) for v in j64]), pa.int64()),
        "f64": pa.array(_nullify(rng, [float(v) for v in f64]),
                        pa.float64()),
        "g64": pa.array(_nullify(rng, [float(v) for v in g64]),
                        pa.float64()),
        "b": pa.array(_nullify(rng, [bool(v) for v in
                                     rng.integers(0, 2, N)]), pa.bool_()),
        "s": pa.array(_nullify(rng, [words[i] for i in
                                     rng.integers(0, len(words), N)])),
        "t": pa.array(_nullify(rng, [words[i] for i in
                                     rng.integers(0, len(words), N)], 0.5)),
        "sh": pa.array(_nullify(rng, [int(v) for v in sh]), pa.int32()),
    })


TABLE = _table()
TYPES = {"i32": "INT32", "i64": "INT64", "j64": "INT64", "f64": "FLOAT64",
         "g64": "FLOAT64", "b": "BOOL", "s": "STRING", "t": "STRING",
         "sh": "INT32"}


class _Side:
    """An expression builder over one package's ``ir`` and ``dtypes``."""

    def __init__(self, ir, dt):
        self.ir, self.dt = ir, dt

    def c(self, name):
        return self.ir.UnresolvedAttribute(name)

    def bind(self, e):
        """Bound to the table's columns, types resolved bottom-up."""
        return self.ir.bind(e, TABLE.column_names,
                            [getattr(self.dt, TYPES[n])
                             for n in TABLE.column_names])

    def lit(self, v, dtype=None):
        return self.ir.Literal(v, getattr(self.dt, dtype) if dtype else None)


# name -> builder(side) -> expression
EXPRS = {
    "in_int_null_in_list": lambda x: x.ir.In(x.c("i32"), [1, None, -7]),
    "in_int_no_null": lambda x: x.ir.In(x.c("i64"), [0, -1, I64_MIN]),
    "in_float": lambda x: x.ir.In(x.c("f64"), [0.0, 2.5, float("inf")]),
    "in_string_null_in_list":
        lambda x: x.ir.In(x.c("s"), ["ab", None, ""]),
    "in_string": lambda x: x.ir.In(x.c("s"), ["Sports", "Books", "Home"]),
    "idiv": lambda x: x.ir.IntegralDivide(x.c("i64"), x.c("j64")),
    "idiv_by_zero_literal":
        lambda x: x.ir.IntegralDivide(x.c("i32"), x.lit(0)),
    "idiv_by_minus_one": lambda x: x.ir.IntegralDivide(x.c("i64"),
                                                       x.lit(-1, "INT64")),
    "mod": lambda x: x.ir.Remainder(x.c("i64"), x.c("j64")),
    "mod_int32": lambda x: x.ir.Remainder(x.c("i32"), x.lit(-4)),
    "mod_float": lambda x: x.ir.Remainder(x.c("f64"), x.c("g64")),
    "pmod": lambda x: x.ir.Pmod(x.c("i64"), x.c("j64")),
    "pmod_float": lambda x: x.ir.Pmod(x.c("f64"), x.c("g64")),
    "neg": lambda x: x.ir.UnaryMinus(x.c("i64")),
    "neg_float": lambda x: x.ir.UnaryMinus(x.c("f64")),
    "pos": lambda x: x.ir.UnaryPositive(x.c("i32")),
    "abs_int64_min": lambda x: x.ir.Abs(x.c("i64")),
    "abs_int32": lambda x: x.ir.Abs(x.c("i32")),
    "abs_float": lambda x: x.ir.Abs(x.c("f64")),
    "isnan": lambda x: x.ir.IsNan(x.c("f64")),
    "at_least_2_non_nulls":
        lambda x: x.ir.AtLeastNNonNulls(2, [x.c("i32"), x.c("f64"),
                                            x.c("s")]),
    "coalesce_mixed_nullability":
        lambda x: x.ir.Coalesce(x.c("i64"), x.c("j64"),
                                x.lit(7, "INT64")),
    "coalesce_all_nullable": lambda x: x.ir.Coalesce(x.c("f64"),
                                                     x.c("g64")),
    "coalesce_string": lambda x: x.ir.Coalesce(x.c("t"), x.c("s"),
                                               x.lit("none")),
    "nanvl": lambda x: x.ir.NaNvl(x.c("f64"), x.c("g64")),
    "if": lambda x: x.ir.If(x.c("b"), x.c("i64"), x.c("j64")),
    "if_string": lambda x: x.ir.If(x.c("b"), x.c("s"), x.lit("no")),
    "case_when_else": lambda x: x.ir.CaseWhen(
        [(x.ir.GreaterThan(x.c("i32"), x.lit(0)), x.c("f64")),
         (x.ir.IsNull(x.c("i32")), x.lit(-1.0))], x.c("g64")),
    "case_when_no_else": lambda x: x.ir.CaseWhen(
        [(x.c("b"), x.c("i64")),
         (x.ir.LessThan(x.c("j64"), x.lit(0, "INT64")), x.c("j64"))]),
    "case_when_string": lambda x: x.ir.CaseWhen(
        [(x.ir.In(x.c("s"), ["ab", "zz"]), x.lit("short")),
         (x.c("b"), x.c("t"))], x.c("s")),
    "sqrt": lambda x: x.ir.Sqrt(x.c("f64")),
    "exp": lambda x: x.ir.Exp(x.c("g64")),
    "log_le_zero": lambda x: x.ir.Log(x.c("f64")),
    "log_int": lambda x: x.ir.Log(x.c("i32")),
    "log2": lambda x: x.ir.Log2(x.c("f64")),
    "log10": lambda x: x.ir.Log10(x.c("g64")),
    "log1p": lambda x: x.ir.Log1p(x.c("g64")),
    "expm1": lambda x: x.ir.Expm1(x.c("g64")),
    "sin": lambda x: x.ir.Sin(x.c("f64")),
    "cos": lambda x: x.ir.Cos(x.c("g64")),
    "tan": lambda x: x.ir.Tan(x.c("g64")),
    "sinh": lambda x: x.ir.Sinh(x.c("g64")),
    "cosh": lambda x: x.ir.Cosh(x.c("g64")),
    "tanh": lambda x: x.ir.Tanh(x.c("f64")),
    "asin": lambda x: x.ir.Asin(x.c("g64")),
    "acos": lambda x: x.ir.Acos(x.c("g64")),
    "atan": lambda x: x.ir.Atan(x.c("f64")),
    "cbrt": lambda x: x.ir.Cbrt(x.c("f64")),
    "degrees": lambda x: x.ir.ToDegrees(x.c("f64")),
    "radians": lambda x: x.ir.ToRadians(x.c("f64")),
    "rint": lambda x: x.ir.Rint(x.c("f64")),
    "signum": lambda x: x.ir.Signum(x.c("f64")),
    "ceil_inf_nan": lambda x: x.ir.Ceil(x.c("f64")),
    "floor_inf_nan": lambda x: x.ir.Floor(x.c("f64")),
    "pow": lambda x: x.ir.Pow(x.c("g64"), x.c("i32")),
    "atan2": lambda x: x.ir.Atan2(x.c("f64"), x.c("g64")),
    "shiftleft_31": lambda x: x.ir.ShiftLeft(x.c("i32"), x.lit(31)),
    "shiftleft_63": lambda x: x.ir.ShiftLeft(x.c("i64"), x.lit(63)),
    "shiftright_31": lambda x: x.ir.ShiftRight(x.c("i32"), x.lit(31)),
    "shiftright_63": lambda x: x.ir.ShiftRight(x.c("i64"), x.lit(63)),
    "shiftrightunsigned_31":
        lambda x: x.ir.ShiftRightUnsigned(x.c("i32"), x.lit(31)),
    "shiftrightunsigned_63":
        lambda x: x.ir.ShiftRightUnsigned(x.c("i64"), x.lit(63)),
    "shiftleft_by_column": lambda x: x.ir.ShiftLeft(x.c("i64"), x.c("sh")),
    "shiftright_by_column": lambda x: x.ir.ShiftRight(x.c("i32"),
                                                      x.c("sh")),
    "shiftrightunsigned_by_column":
        lambda x: x.ir.ShiftRightUnsigned(x.c("i64"), x.c("sh")),
}


@pytest.fixture(scope="module")
def batches():
    return jfrom_arrow(TABLE), tfrom_arrow(TABLE, device="cpu")


def _float_equal(a: float, b: float) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-11)


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(name, batches):
    jb, tb = batches
    jside, tside = _Side(jir, jdt), _Side(tir, tdt)
    je = jside.bind(EXPRS[name](jside))
    te = tside.bind(EXPRS[name](tside))
    assert tev.supported_on_tpu(type(te)) and jev.supported_on_tpu(type(je))
    jv, tv = jev.evaluate(je, jb), tev.evaluate(te, tb)
    assert tv.dtype.name == jv.dtype.name
    valid = np.asarray(jv.validity)
    np.testing.assert_array_equal(tv.validity.numpy(), valid)
    jd, td = np.asarray(jv.data), tv.data.numpy()
    if jv.dtype.is_string:
        jl, tl = np.asarray(jv.lengths), tv.lengths.numpy()
        for i in np.flatnonzero(valid):
            assert bytes(td[i, :tl[i]]) == bytes(jd[i, :jl[i]]), i
        return
    if jv.dtype.is_floating:
        bad = [i for i in np.flatnonzero(valid)
               if not _float_equal(float(td[i]), float(jd[i]))]
        assert not bad, [(float(td[i]), float(jd[i])) for i in bad]
        return
    np.testing.assert_array_equal(td[valid], jd[valid])


def test_the_in_list_null_rules():
    """SQL's three-valued IN: a hit is TRUE; a miss is FALSE, or NULL
    when the list holds a null; a null probe is NULL."""
    t = pa.table({"v": pa.array([1, 2, None], pa.int32())})
    b = tfrom_arrow(t, device="cpu")
    ref = tir.BoundReference(0, tdt.INT32)
    for items, data, valid in (([1, None], [True, False, False],
                                [True, False, False]),
                               ([1, 5], [True, False, False],
                                [True, True, False])):
        v = tev.evaluate(tir.In(ref, items), b)
        assert v.data[:3].tolist() == data and \
            v.validity[:3].tolist() == valid


@pytest.fixture(scope="module")
def item_files(tmp_path_factory):
    """An item-like table with dictionary string and int columns."""
    d = tmp_path_factory.mktemp("isin")
    rng = np.random.default_rng(5)
    cats = np.array(["Sports", "Books", "Home", "Music", "Shoes"])
    n = 3000
    for i in range(2):
        t = pa.table({
            "i_item_sk": pa.array(np.arange(i * n, (i + 1) * n,
                                            dtype=np.int32)),
            "i_category": pa.array(cats[rng.integers(0, 5, n)]),
            "i_class_id": pa.array(rng.integers(1, 9, n).astype(np.int32)),
            "i_brand": pa.array(np.array(["b%d" % k for k in range(40)])[
                rng.integers(0, 40, n)]),
            "i_current_price": pa.array(rng.uniform(0, 100, n))})
        papq.write_table(t, str(d / f"part-{i}.parquet"))
    return str(d)


def _isin_query(s, col, root):
    return (s.read.parquet(root)
            .filter(col("i_category").isin("Sports", "Books", "Home"))
            .select("i_item_sk", "i_category", "i_class_id", "i_brand"))


def test_isin_filter_is_pushed_into_the_fused_scan(item_files):
    conf = {"spark.rapids.tpu.sql.test.enabled": True}
    reg = jreg.get_registry()
    key = "kernel.backend.pallas.fallbacks.scan.filterDecode." \
        "condition_column"
    before = reg.counter(key)
    ref = _isin_query(JSession(conf), jcol, item_files).collect()
    ref_fallbacks = reg.counter(key) - before

    s = TSession(conf, device="cpu")
    df = _isin_query(s, tcol, item_files)
    nodes = []
    s._plan_physical(df.plan).plan.foreach(nodes.append)
    (scan,) = [n for n in nodes if type(n).__name__ == "TpuParquetScanExec"]
    assert isinstance(scan._pushed_filter, tir.In)
    assert not [n for n in nodes if type(n).__name__.startswith("Cpu")
                and type(n).__name__ != "CpuScanExec"]
    kb.reset_counts()
    got = df.collect()
    assert_tables_equal(ref, got)
    assert ref_fallbacks >= 1
    assert kb.fallbacks == {"scan.filterDecode.condition_column":
                            ref_fallbacks}
