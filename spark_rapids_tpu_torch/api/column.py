"""Column expression builder — the PySpark ``Column`` analog.

The reference sits under Spark SQL's DataFrame API; standalone, we provide
the same user surface so "a user of the reference can switch".

The port's copy of ``spark_rapids_tpu/api/column.py``, with its imports
retargeted.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.expr import ir


def _to_expr(v: Any) -> ir.Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, ir.Expression):
        return v
    return ir.Literal(v)


class Column:
    def __init__(self, expr: ir.Expression):
        self.expr = expr

    # naming ---------------------------------------------------------------
    def getItem(self, key) -> "Column":
        """col[key]: array ordinal (0-based) or map key lookup."""
        return Column(ir.GetItem(self.expr, _to_expr(key)))

    get_item = getItem
    __getitem__ = getItem

    def alias(self, name: str) -> "Column":
        return Column(ir.Alias(self.expr, name))

    name = alias

    # arithmetic -----------------------------------------------------------
    def __add__(self, o):
        return Column(ir.Add(self.expr, _to_expr(o)))

    def __radd__(self, o):
        return Column(ir.Add(_to_expr(o), self.expr))

    def __sub__(self, o):
        return Column(ir.Subtract(self.expr, _to_expr(o)))

    def __rsub__(self, o):
        return Column(ir.Subtract(_to_expr(o), self.expr))

    def __mul__(self, o):
        return Column(ir.Multiply(self.expr, _to_expr(o)))

    def __rmul__(self, o):
        return Column(ir.Multiply(_to_expr(o), self.expr))

    def __truediv__(self, o):
        return Column(ir.Divide(self.expr, _to_expr(o)))

    def __rtruediv__(self, o):
        return Column(ir.Divide(_to_expr(o), self.expr))

    def __mod__(self, o):
        return Column(ir.Remainder(self.expr, _to_expr(o)))

    def __neg__(self):
        return Column(ir.UnaryMinus(self.expr))

    # comparisons ----------------------------------------------------------
    def __eq__(self, o):  # type: ignore[override]
        return Column(ir.EqualTo(self.expr, _to_expr(o)))

    def __ne__(self, o):  # type: ignore[override]
        return Column(ir.Not(ir.EqualTo(self.expr, _to_expr(o))))

    def __lt__(self, o):
        return Column(ir.LessThan(self.expr, _to_expr(o)))

    def __le__(self, o):
        return Column(ir.LessThanOrEqual(self.expr, _to_expr(o)))

    def __gt__(self, o):
        return Column(ir.GreaterThan(self.expr, _to_expr(o)))

    def __ge__(self, o):
        return Column(ir.GreaterThanOrEqual(self.expr, _to_expr(o)))

    # logic ----------------------------------------------------------------
    def __and__(self, o):
        return Column(ir.And(self.expr, _to_expr(o)))

    def __or__(self, o):
        return Column(ir.Or(self.expr, _to_expr(o)))

    def __invert__(self):
        return Column(ir.Not(self.expr))

    # null / membership ----------------------------------------------------
    def is_null(self):
        return Column(ir.IsNull(self.expr))

    isNull = is_null

    def is_not_null(self):
        return Column(ir.IsNotNull(self.expr))

    isNotNull = is_not_null

    def isin(self, *items):
        if len(items) == 1 and isinstance(items[0], (list, tuple, set)):
            items = tuple(items[0])
        return Column(ir.In(self.expr, items))

    # strings --------------------------------------------------------------
    def startswith(self, o):
        return Column(ir.StartsWith(self.expr, _to_expr(o)))

    def endswith(self, o):
        return Column(ir.EndsWith(self.expr, _to_expr(o)))

    def contains(self, o):
        return Column(ir.Contains(self.expr, _to_expr(o)))

    def like(self, pattern: str):
        return Column(ir.Like(self.expr, ir.Literal(pattern)))

    def rlike(self, pattern: str):
        return Column(ir.RLike(self.expr, ir.Literal(pattern)))

    def substr(self, start, length):
        return Column(ir.Substring(self.expr, _to_expr(start),
                                   _to_expr(length)))

    # cast -----------------------------------------------------------------
    def cast(self, to) -> "Column":
        if isinstance(to, str):
            to = _TYPE_NAMES[to]
        return Column(ir.Cast(self.expr, to))

    astype = cast

    # windowing ------------------------------------------------------------
    def over(self, spec) -> "Column":
        return Column(ir.WindowExpression(
            self.expr, spec._partition_by, spec._order_by, spec._frame))

    # sort orders ----------------------------------------------------------
    def asc(self):
        from spark_rapids_tpu_torch.plan.logical import SortOrder
        return SortOrder(self.expr, True, None)

    def desc(self):
        from spark_rapids_tpu_torch.plan.logical import SortOrder
        return SortOrder(self.expr, False, None)

    def asc_nulls_last(self):
        from spark_rapids_tpu_torch.plan.logical import SortOrder
        return SortOrder(self.expr, True, False)

    def desc_nulls_first(self):
        from spark_rapids_tpu_torch.plan.logical import SortOrder
        return SortOrder(self.expr, False, True)

    def __repr__(self):
        return f"Column<{self.expr.sql()}>"

    def __hash__(self):
        return id(self)


_TYPE_NAMES = {
    "boolean": dt.BOOL, "bool": dt.BOOL,
    "tinyint": dt.INT8, "byte": dt.INT8,
    "smallint": dt.INT16, "short": dt.INT16,
    "int": dt.INT32, "integer": dt.INT32,
    "bigint": dt.INT64, "long": dt.INT64,
    "float": dt.FLOAT32, "double": dt.FLOAT64,
    "string": dt.STRING, "date": dt.DATE32, "timestamp": dt.TIMESTAMP_US,
}


def col(name: str) -> Column:
    return Column(ir.UnresolvedAttribute(name))


def lit(value: Any) -> Column:
    return Column(ir.Literal(value))
