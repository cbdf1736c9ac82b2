"""Device sort exec.

Ported from ``spark_rapids_tpu/exec/tpu_sort.py`` (the reference's
analog of ``GpuSortExec``: ``Table.orderBy`` on a single coalesced batch
with ``RequireSingleBatch`` for a total sort).  Each sort column encodes
into bit-width-aware key fields (exec/sortkeys.py), the fields pack into
u32 digits, one stable sort per digit gives the order, then a row gather
applies it.  The reference splits this into an encode kernel, a shared
sort kernel and an apply kernel to bound XLA compiles; here the three
steps run eagerly in sequence.
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


def sort_batch(batch: DeviceBatch, orders: Sequence[SortOrder]
               ) -> DeviceBatch:
    """``batch`` in the total order of ``orders``.  One erased view feeds
    the key encode and the gather, so the order indexes the erased
    capacity; the batch's names are restamped after."""
    ew = kernel_abi.erase(batch)
    digits = sortkeys.stack_sort_digits(_field_groups(ew, orders),
                                        ew.row_mask())
    order = sortkeys.shared_digit_sort(digits)
    valid = torch.arange(ew.capacity, device=ew.device) < ew.num_rows
    cols = [c.gather(order, valid) for c in ew.columns]
    return DeviceBatch(batch.names, cols, ew.num_rows, ew.device)


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
                out = sort_batch(whole, self.orders)
            self.metrics.add_rows(out.num_rows)
            yield out
        if self.partitionwise:
            return [run([it]) for it in self.children[0].execute()]
        return [run(self.children[0].execute())]
