"""``pyspark.sql.functions``-style builder API over the expression IR.

The port's copy of ``spark_rapids_tpu/api/functions.py``, with its
imports retargeted.
"""

from __future__ import annotations

from typing import Any, Optional, Union

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.api.column import Column, _to_expr, col, lit  # noqa
from spark_rapids_tpu_torch.expr import ir


def _c(v) -> ir.Expression:
    if isinstance(v, str):
        return ir.UnresolvedAttribute(v)
    return _to_expr(v)


# -- conditionals -----------------------------------------------------------

def when(cond, value) -> "CaseWhenBuilder":
    return CaseWhenBuilder([(cond, value)])


class CaseWhenBuilder(Column):
    def __init__(self, branches):
        self.branches = branches
        super().__init__(self._build(None))

    def _build(self, else_value):
        return ir.CaseWhen(
            [(_to_expr(c), _to_expr(v)) for c, v in self.branches],
            _to_expr(else_value) if else_value is not None else None)

    def when(self, cond, value) -> "CaseWhenBuilder":
        return CaseWhenBuilder(self.branches + [(cond, value)])

    def otherwise(self, value) -> Column:
        return Column(self._build(value))


def if_(cond, t, f) -> Column:
    return Column(ir.If(_to_expr(cond), _to_expr(t), _to_expr(f)))


def coalesce(*cols) -> Column:
    return Column(ir.Coalesce(*[_c(c) for c in cols]))


def isnull(c) -> Column:
    return Column(ir.IsNull(_c(c)))


def isnan(c) -> Column:
    return Column(ir.IsNan(_c(c)))


def nanvl(a, b) -> Column:
    return Column(ir.NaNvl(_c(a), _c(b)))


# -- math -------------------------------------------------------------------

def _u(cls):
    def f(c) -> Column:
        return Column(cls(_c(c)))
    return f


abs = _u(ir.Abs)  # noqa: A001
sqrt = _u(ir.Sqrt)
exp = _u(ir.Exp)
log = _u(ir.Log)
log2 = _u(ir.Log2)
log10 = _u(ir.Log10)
log1p = _u(ir.Log1p)
expm1 = _u(ir.Expm1)
sin = _u(ir.Sin)
cos = _u(ir.Cos)
tan = _u(ir.Tan)
sinh = _u(ir.Sinh)
cosh = _u(ir.Cosh)
tanh = _u(ir.Tanh)
asin = _u(ir.Asin)
acos = _u(ir.Acos)
atan = _u(ir.Atan)
cbrt = _u(ir.Cbrt)
degrees = _u(ir.ToDegrees)
radians = _u(ir.ToRadians)
rint = _u(ir.Rint)
signum = _u(ir.Signum)
ceil = _u(ir.Ceil)
floor = _u(ir.Floor)


def pow(a, b) -> Column:  # noqa: A001
    return Column(ir.Pow(_c(a), _c(b)))


def atan2(a, b) -> Column:
    return Column(ir.Atan2(_c(a), _c(b)))


def shiftleft(c, n) -> Column:
    return Column(ir.ShiftLeft(_c(c), _to_expr(n)))


def shiftright(c, n) -> Column:
    return Column(ir.ShiftRight(_c(c), _to_expr(n)))


def shiftrightunsigned(c, n) -> Column:
    return Column(ir.ShiftRightUnsigned(_c(c), _to_expr(n)))


def pmod(a, b) -> Column:
    return Column(ir.Pmod(_c(a), _c(b)))


def rand(seed: Optional[int] = None) -> Column:
    return Column(ir.Rand(seed))


# -- strings ----------------------------------------------------------------

upper = _u(ir.Upper)
lower = _u(ir.Lower)
length = _u(ir.Length)
trim = _u(ir.StringTrim)
ltrim = _u(ir.StringTrimLeft)
rtrim = _u(ir.StringTrimRight)
initcap = _u(ir.InitCap)
reverse = _u(ir.StringReverse)


def substring(c, pos, length_) -> Column:
    return Column(ir.Substring(_c(c), _to_expr(pos), _to_expr(length_)))


def concat(*cols) -> Column:
    return Column(ir.Concat(*[_c(c) for c in cols]))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(ir.StringLocate(ir.Literal(substr), _c(c),
                                  ir.Literal(pos)))


def lpad(c, length_: int, pad: str) -> Column:
    return Column(ir.LPad(_c(c), ir.Literal(length_), ir.Literal(pad)))


def rpad(c, length_: int, pad: str) -> Column:
    return Column(ir.RPad(_c(c), ir.Literal(length_), ir.Literal(pad)))


def replace(c, search: str, replacement: str) -> Column:
    return Column(ir.StringReplace(_c(c), ir.Literal(search),
                                   ir.Literal(replacement)))


def substring_index(c, delim: str, count: int) -> Column:
    return Column(ir.SubstringIndex(_c(c), ir.Literal(delim),
                                    ir.Literal(count)))


def split(c, pattern: str, limit: int = -1) -> Column:
    return Column(ir.StringSplit(_c(c), ir.Literal(pattern),
                                 ir.Literal(limit)))


def regexp_replace(c, pattern: str, replacement) -> Column:
    return Column(ir.RegExpReplace(_c(c), ir.Literal(pattern),
                                   _c(replacement) if isinstance(
                                       replacement, Column)
                                   else ir.Literal(replacement)))


def md5(c) -> Column:
    return Column(ir.Md5(_c(c)))


def atleast_n_nonnulls(n: int, *cols) -> Column:
    return Column(ir.AtLeastNNonNulls(n, [_c(c) for c in cols]))


def from_unixtime(c) -> Column:
    return Column(ir.FromUnixTime(_c(c)))


def input_file_name() -> Column:
    return Column(ir.InputFileName())


# -- temporal ---------------------------------------------------------------

year = _u(ir.Year)
month = _u(ir.Month)
dayofmonth = _u(ir.DayOfMonth)
dayofyear = _u(ir.DayOfYear)
dayofweek = _u(ir.DayOfWeek)
weekofyear = _u(ir.WeekOfYear)
quarter = _u(ir.Quarter)
hour = _u(ir.Hour)
minute = _u(ir.Minute)
second = _u(ir.Second)


def date_add(c, days) -> Column:
    return Column(ir.DateAdd(_c(c), _to_expr(days)))


def date_sub(c, days) -> Column:
    return Column(ir.DateSub(_c(c), _to_expr(days)))


def datediff(end, start) -> Column:
    return Column(ir.DateDiff(_c(end), _c(start)))


def unix_timestamp(c) -> Column:
    return Column(ir.UnixTimestampFromTs(_c(c)))


# -- hash / ids -------------------------------------------------------------

def hash(*cols) -> Column:  # noqa: A001
    return Column(ir.Murmur3Hash([_c(c) for c in cols]))


def spark_partition_id() -> Column:
    return Column(ir.SparkPartitionID())


def monotonically_increasing_id() -> Column:
    return Column(ir.MonotonicallyIncreasingID())


# -- aggregates -------------------------------------------------------------

def count(c="*") -> Column:
    if isinstance(c, str) and c == "*":
        return Column(ir.Count(None))
    return Column(ir.Count(_c(c)))


def sum(c) -> Column:  # noqa: A001
    return Column(ir.Sum(_c(c)))


def min(c) -> Column:  # noqa: A001
    return Column(ir.Min(_c(c)))


def max(c) -> Column:  # noqa: A001
    return Column(ir.Max(_c(c)))


def avg(c) -> Column:
    return Column(ir.Average(_c(c)))


mean = avg


def count_distinct(c) -> Column:
    return Column(ir.Count(_c(c), distinct=True))


countDistinct = count_distinct


def sum_distinct(c) -> Column:
    return Column(ir.Sum(_c(c), distinct=True))


sumDistinct = sum_distinct


def avg_distinct(c) -> Column:
    return Column(ir.Average(_c(c), distinct=True))


# -- UDFs -------------------------------------------------------------------

def udf(f=None, returnType="string"):
    """Create a user-defined function.

    The function's bytecode is translated to the expression IR when possible
    (so it runs on TPU like any built-in expression); otherwise it becomes a
    row-wise ``PythonUDF`` that executes on CPU — mirroring the reference's
    udf-compiler with CPU-UDF fallback (udf-compiler/.../Plugin.scala:36-94).
    The result is cast to ``returnType`` in both paths, like PySpark.

    Supports all PySpark call forms: ``udf(f)``, ``udf(f, "long")``,
    ``@udf``, ``@udf("long")``, ``@udf(returnType="long")``.
    """
    from spark_rapids_tpu_torch.api.column import _TYPE_NAMES
    if isinstance(f, (str, dt.DType)):  # @udf("long") decorator form
        return lambda fn: udf(fn, f)
    if f is None:
        return lambda fn: udf(fn, returnType)
    rt = _TYPE_NAMES[returnType] if isinstance(returnType, str) \
        else returnType

    def wrapper(*cols) -> Column:
        # compilation is attempted at bind time, when argument dtypes are
        # known (ir._try_compile_python_udf); until then this is a row-wise
        # Python UDF node
        return Column(ir.PythonUDF(f, [_c(c) for c in cols], rt,
                                   try_compile=True))
    wrapper.__name__ = getattr(f, "__name__", "udf")
    return wrapper


def pandas_udf(f=None, returnType="double"):
    """Create a vectorized (series -> series) pandas UDF.

    Evaluated in a Python worker process over Arrow IPC — the
    GpuArrowEvalPythonExec path (reference:
    GpuArrowEvalPythonExec.scala:422-435, python/rapids/worker.py).
    Supports ``pandas_udf(f)``, ``pandas_udf(f, "long")``, ``@pandas_udf``,
    ``@pandas_udf("long")`` call forms like PySpark.
    """
    from spark_rapids_tpu_torch.api.column import _TYPE_NAMES
    if isinstance(f, (str, dt.DType)):
        return lambda fn: pandas_udf(fn, f)
    if f is None:
        return lambda fn: pandas_udf(fn, returnType)
    rt = _TYPE_NAMES[returnType] if isinstance(returnType, str) \
        else returnType

    def wrapper(*cols) -> Column:
        return Column(ir.PythonUDF(f, [_c(c) for c in cols], rt,
                                   vectorized=True))
    wrapper.__name__ = getattr(f, "__name__", "pandas_udf")
    return wrapper


# -- window functions -------------------------------------------------------

def row_number() -> Column:
    return Column(ir.RowNumber())


def rank() -> Column:
    return Column(ir.Rank())


def dense_rank() -> Column:
    return Column(ir.DenseRank())


def lead(c, offset: int = 1, default=None) -> Column:
    return Column(ir.Lead(_c(c), offset, default))


def lag(c, offset: int = 1, default=None) -> Column:
    return Column(ir.Lag(_c(c), offset, default))


def first(c, ignorenulls: bool = False) -> Column:
    return Column(ir.First(_c(c), ignorenulls))


def last(c, ignorenulls: bool = False) -> Column:
    return Column(ir.Last(_c(c), ignorenulls))


def broadcast(df):
    """Broadcast hint: mark df as the build side of its next join
    (pyspark functions.broadcast analog; drives BroadcastHashJoinExec
    selection like Spark's ResolvedHint)."""
    out = df.__class__(df.plan, df.session)
    out._broadcast_hint = True
    return out


# -- complex types -----------------------------------------------------------

def explode(c) -> Column:
    return Column(ir.Explode(_c(c)))


def explode_outer(c) -> Column:
    return Column(ir.Explode(_c(c), outer=True))


def posexplode(c) -> Column:
    return Column(ir.PosExplode(_c(c)))


def posexplode_outer(c) -> Column:
    return Column(ir.PosExplode(_c(c), outer=True))


def size(c) -> Column:
    return Column(ir.Size(_c(c)))


def array(*cols) -> Column:
    return Column(ir.CreateArray(*[_c(c) for c in cols]))


def array_contains(c, value) -> Column:
    return Column(ir.ArrayContains(_c(c), _to_expr(value)))


def sort_array(c, asc: bool = True) -> Column:
    return Column(ir.SortArray(_c(c), asc))


def element_at(c, extraction) -> Column:
    """Arrays: 1-based index, negative counts from the end (Spark
    element_at); maps: key lookup."""
    return Column(ir.ElementAt(_c(c), _to_expr(extraction)))
