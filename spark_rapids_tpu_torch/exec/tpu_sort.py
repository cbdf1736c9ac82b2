"""Device sort exec.

Ported from ``spark_rapids_tpu/exec/tpu_sort.py`` (the reference's
analog of ``GpuSortExec``: ``Table.orderBy`` on a single coalesced batch
with ``RequireSingleBatch`` for a total sort).  Each sort column encodes
into bit-width-aware key fields (exec/sortkeys.py), the fields pack into
u32 digits, one stable sort per digit gives the order, then a row gather
applies it.  As in the reference (:80-115) the three steps are three
dispatches through the process kernel cache: the ``sort_keys`` encode
(keyed by the sort orders), the shared ``shared_digit_sort`` (keyed by
the digit matrix's shape, exec/sortkeys.py) and the ``sort_apply``
gather (keyed by the erased layout).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, concat_batches
from spark_rapids_tpu_torch.exec import kernel_abi, sortkeys
from spark_rapids_tpu_torch.exec.base import (PhysicalPlan,
                                              REQUIRE_SINGLE_BATCH, TpuExec,
                                              timed)
from spark_rapids_tpu_torch.expr import eval_tpu
from spark_rapids_tpu_torch.plan.logical import Schema, SortOrder


def _field_groups(batch: DeviceBatch, orders: Sequence[SortOrder]):
    groups = []
    for o in orders:
        v = eval_tpu.evaluate(o.expr, batch)
        # only the PROPAGATED no-null hint drops the null field: schema
        # nullability is metadata and can be stale
        groups.append(sortkeys.encode_fields(
            v, o.ascending, o.nulls_first_resolved,
            nullable=not v.nonnull))
    return groups


def _keys_impl(orders: Sequence[SortOrder], batch: DeviceBatch
               ) -> torch.Tensor:
    return sortkeys.stack_sort_digits(_field_groups(batch, orders),
                                      batch.row_mask())


def _apply_impl(batch: DeviceBatch, order: torch.Tensor) -> DeviceBatch:
    valid = torch.arange(batch.capacity, device=batch.device) < \
        batch.num_rows
    cols = [c.gather(order, valid) for c in batch.columns]
    return DeviceBatch(batch.names, cols, batch.num_rows, batch.device)


def sort_keys_kernel(orders: Sequence[SortOrder]):
    """The cached key-encode step of ``orders`` (the reference's
    ``sort_keys`` family)."""
    import functools
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    orders = list(orders)
    return kc.get_kernel(
        ("sort_keys", tuple((kc.expr_sig(o.expr), o.ascending,
                             o.nulls_first_resolved) for o in orders)),
        lambda: functools.partial(_keys_impl, orders))


def sort_batch(batch: DeviceBatch, orders: Sequence[SortOrder],
               keys_kernel=None) -> DeviceBatch:
    """``batch`` in the total order of ``orders``.  One erased view feeds
    the key encode and the gather, so the order indexes the erased
    capacity; the batch's names are restamped after."""
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    keys_kernel = keys_kernel or sort_keys_kernel(orders)
    ew = kernel_abi.erase(batch)
    digits = keys_kernel(ew)
    order = sortkeys.shared_digit_sort(digits)
    apply_kernel = kc.get_kernel(("sort_apply", kernel_abi.erased_key(ew)),
                                 lambda: _apply_impl)
    out = apply_kernel(ew, order)
    return DeviceBatch(batch.names, out.columns, out.num_rows, out.device)


class TpuSortExec(TpuExec):
    """Total sort: requires its whole input as one batch."""

    def __init__(self, child: PhysicalPlan, orders: Sequence[SortOrder],
                 partitionwise: bool = False):
        super().__init__()
        self.children = (child,)
        self.orders = list(orders)
        # partitionwise: sort each child partition on its own (a range
        # exchange below makes the partition-ordered concatenation the
        # total order)
        self.partitionwise = partitionwise

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def children_coalesce_goal(self):
        return [REQUIRE_SINGLE_BATCH]

    def execute(self):
        keys_kernel = sort_keys_kernel(self.orders)

        def run(iters):
            from spark_rapids_tpu_torch.mem.spill import register_or_hold
            # every input batch is held until the concat
            handles: List = []
            for it in iters:
                for b in it:
                    handles.append(register_or_hold(b))
            if not handles:
                return
            try:
                whole = concat_batches([h.get() for h in handles])
            finally:
                for h in handles:
                    h.close()
            with timed(self.metrics, "sort.exec"):
                out = sort_batch(whole, self.orders, keys_kernel)
            self.metrics.add_rows(out.num_rows)
            yield out
        if self.partitionwise:
            return [run([it]) for it in self.children[0].execute()]
        return [run(self.children[0].execute())]
