"""Window specification API (pyspark.sql.Window analog).

The port's copy of ``spark_rapids_tpu/api/window.py``, with its imports
retargeted.  Windows plan as ``exec/tpu_window.py``'s ``TpuWindowExec``, or
``exec/cpu_window.py``'s ``CpuWindowExec`` where the window rule refuses.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.api.column import _to_expr
from spark_rapids_tpu_torch.expr import ir


class WindowSpec:
    def __init__(self, partition_by=(), order_by=(), frame=None):
        self._partition_by = tuple(partition_by)
        self._order_by = tuple(order_by)
        self._frame = frame

    def partition_by(self, *cols) -> "WindowSpec":
        return WindowSpec(tuple(_as_expr(c) for c in cols),
                          self._order_by, self._frame)

    partitionBy = partition_by

    def order_by(self, *cols) -> "WindowSpec":
        from spark_rapids_tpu_torch.plan.logical import SortOrder
        orders = []
        for c in cols:
            if isinstance(c, SortOrder):
                orders.append(c)
            else:
                orders.append(SortOrder(_as_expr(c), True, None))
        return WindowSpec(self._partition_by, tuple(orders), self._frame)

    orderBy = order_by

    def rows_between(self, start, end) -> "WindowSpec":
        return WindowSpec(self._partition_by, self._order_by,
                          ir.WindowFrame("rows", _bound(start), _bound(end)))

    rowsBetween = rows_between

    def range_between(self, start, end) -> "WindowSpec":
        return WindowSpec(self._partition_by, self._order_by,
                          ir.WindowFrame("range", _bound(start),
                                         _bound(end)))

    rangeBetween = range_between


def _as_expr(c):
    if isinstance(c, str):
        return ir.UnresolvedAttribute(c)
    return _to_expr(c)


def _bound(v):
    if v is None or (isinstance(v, int) and abs(v) >= (1 << 62)):
        return None  # unbounded
    return int(v)


class Window:
    unbounded_preceding = -(1 << 63)
    unbounded_following = (1 << 63)
    current_row = 0
    unboundedPreceding = unbounded_preceding
    unboundedFollowing = unbounded_following
    currentRow = current_row

    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols) -> WindowSpec:
        return WindowSpec().order_by(*cols)

    orderBy = order_by
