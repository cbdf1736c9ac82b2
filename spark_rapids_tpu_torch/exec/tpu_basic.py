"""Basic device execs: transitions, project, filter, ``compact``, range,
union, global limit, batch coalescing and expand.

Ported from ``spark_rapids_tpu/exec/tpu_basic.py`` (HostToDeviceExec :44,
DeviceToHostExec :99, TpuProjectExec :118, compact :191, TpuFilterExec
:209, TpuRangeExec :272, TpuUnionExec :310, TpuGlobalLimitExec :333,
TpuCoalesceBatchesExec :360, TpuExpandExec :413).  The project, filter
and expand steps run once per batch through the process kernel cache
(``exec/kernel_cache.get_kernel``) under the reference's keys
(``project`` :153-160, ``filter`` :236-241, ``expand`` :429-443); the
port never donates an input, so the donate flag in the first two keys is
always False.
"""

from __future__ import annotations

from typing import List, Sequence

import pyarrow as pa
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   _bucket_strlen,
                                                   bucket_rows,
                                                   compact_arrays,
                                                   concat_batches,
                                                   from_arrow,
                                                   resolve_device, to_arrow_all)
from spark_rapids_tpu_torch.exec import context
from spark_rapids_tpu_torch.exec.base import (CoalesceGoal, PhysicalPlan,
                                              RequireSingleBatch, TargetSize,
                                              TpuExec, timed)
from spark_rapids_tpu_torch.expr import eval_tpu, ir
from spark_rapids_tpu_torch.plan.logical import Field, Schema


class HostToDeviceExec(TpuExec):
    """Upload host Arrow batches into padded DeviceBatches on ``device``.

    String-outlier guard: the padded byte matrix costs capacity x max_len
    bytes, so when a batch's padded string payload would exceed
    ``string_budget`` the table splits into row slices, each measuring
    its own max_len.

    On the card the copies go through pinned memory on ``copy_stream``
    (the session's ``columnar/transfer.CopyStream``; the exec makes its
    own when none is set)."""

    def __init__(self, child: PhysicalPlan, min_bucket: int = 16,
                 string_budget: int = 256 << 20, device="cuda"):
        super().__init__()
        self.children = (child,)
        self.min_bucket = min_bucket
        self.string_budget = string_budget
        self.device = resolve_device(device)
        self.copy_stream = None

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def _split_for_strings(self, t):
        import pyarrow.compute as pc
        if t.num_rows <= self.min_bucket:
            return [t]
        padded = 0
        for col, field_ in zip(t.columns, t.schema):
            if pa.types.is_string(field_.type) or \
                    pa.types.is_large_string(field_.type):
                ml = pc.max(pc.binary_length(col)).as_py() or 0
                padded += _bucket_strlen(int(ml)) * \
                    bucket_rows(t.num_rows, self.min_bucket)
        if padded <= self.string_budget:
            return [t]
        half = t.num_rows // 2
        return (self._split_for_strings(t.slice(0, half)) +
                self._split_for_strings(t.slice(half)))

    def execute(self):
        if self.device.type == "cuda" and self.copy_stream is None:
            from spark_rapids_tpu_torch.columnar.transfer import CopyStream
            self.copy_stream = CopyStream(self.device)

        def run(it):
            for t in it:
                for piece in self._split_for_strings(t):
                    with timed(self.metrics, "transition.upload"):
                        b = from_arrow(piece, self.min_bucket,
                                       device=self.device,
                                       copy_stream=self.copy_stream)
                    self.metrics.add_rows(piece.num_rows)
                    self.metrics.add_batches()
                    yield b
        return [run(it) for it in self.children[0].execute()]


class DeviceToHostExec(PhysicalPlan):
    """Download DeviceBatches to host Arrow (the terminal transition).

    Each partition's batches download together through
    ``columnar/batch.to_arrow_all``: one packed copy per wire dtype, on
    ``copy_stream`` (the session's; a fresh one when None)."""

    def __init__(self, child: PhysicalPlan):
        super().__init__()
        self.children = (child,)
        self.copy_stream = None

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        def run(it):
            batches = list(it)
            with timed(self.metrics, "transition.download"):
                tables = to_arrow_all(batches, self.copy_stream)
            yield from tables
        return [run(it) for it in self.children[0].execute()]


class TpuProjectExec(TpuExec):
    def __init__(self, child: PhysicalPlan, exprs: Sequence[ir.Expression],
                 schema: Schema):
        super().__init__()
        self.children = (child,)
        self.exprs = list(exprs)
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def _impl(self, batch: DeviceBatch, pid: int, offset: int
              ) -> DeviceBatch:
        """One batch's projection with positional output names (aliases
        share one kernel; execute() restamps the schema's names)."""
        from spark_rapids_tpu_torch.exec.fused_stage import canonical_names
        with context.task_context(pid, offset):
            cols = [eval_tpu.evaluate(e, batch).to_column()
                    for e in self.exprs]
        return DeviceBatch(canonical_names(len(cols)), cols,
                           batch.num_rows, batch.device)

    def execute(self):
        import functools
        import types
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        # detach from self: the cached step must not pin the exec (and
        # through it the child plan)
        shim = types.SimpleNamespace(exprs=self.exprs)
        kernel = kc.get_kernel(
            ("project", kc.exprs_sig(self.exprs), False),
            lambda: functools.partial(type(self)._impl, shim))
        names = self._schema.names
        needs_ctx = any(_partition_dependent(e) for e in self.exprs)

        def run(pid, it):
            offset = 0
            for b in it:
                if needs_ctx:
                    # row-offset tracking costs one host read per batch;
                    # only paid when a partition-dependent expr exists
                    nr = int(b.num_rows)
                with timed(self.metrics, "project.eval"):
                    out = kernel(b, pid, offset)
                if needs_ctx:
                    offset += nr
                self.metrics.add_batches()
                yield DeviceBatch(names, out.columns, out.num_rows,
                                  out.device)
        return [run(pid, it) for pid, it in
                enumerate(self.children[0].execute())]


def _partition_dependent(e: ir.Expression) -> bool:
    """Does ``e`` read the task context (partition id, row offset)?"""
    return bool(ir.collect(e, lambda n: isinstance(
        n, (ir.SparkPartitionID, ir.MonotonicallyIncreasingID))))


def compact(batch: DeviceBatch, keep: torch.Tensor) -> DeviceBatch:
    """Stream compaction: stable-partition kept rows to the front —
    cumsum the mask for destination slots, then scatter kept rows
    (dropped rows scatter out of bounds).  The row count stays on the
    device."""
    cap = batch.capacity
    keep = keep & batch.row_mask()
    count = keep.to(torch.int64).sum()
    dest = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0) - 1, cap)
    cols = [DeviceColumn(c.dtype, *compact_arrays(
        keep, dest, c.data, c.validity, c.lengths, c.elem_validity))
        for c in batch.columns]
    return DeviceBatch(batch.names, cols, count, batch.device)


class TpuFilterExec(TpuExec):
    def __init__(self, child: PhysicalPlan, condition: ir.Expression):
        super().__init__()
        self.children = (child,)
        self.condition = condition

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def _impl(self, batch: DeviceBatch, pid: int, offset: int
              ) -> DeviceBatch:
        with context.task_context(pid, offset):
            v = eval_tpu.evaluate(self.condition, batch)
        return compact(batch, v.data.to(torch.bool) & v.validity)

    def execute(self):
        import functools
        import types
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        shim = types.SimpleNamespace(condition=self.condition)
        kernel = kc.get_kernel(
            ("filter", kc.expr_sig(self.condition), False),
            lambda: functools.partial(type(self)._impl, shim))
        needs_ctx = _partition_dependent(self.condition)

        def run(pid, it):
            offset = 0
            for b in it:
                if needs_ctx:
                    # the offset counts INPUT rows: the condition sees
                    # pre-compaction positions
                    nr = int(b.num_rows)
                with timed(self.metrics, "filter.eval"):
                    out = kernel(b, pid, offset)
                if needs_ctx:
                    offset += nr
                yield out
        return [run(pid, it) for pid, it in
                enumerate(self.children[0].execute())]


class TpuRangeExec(TpuExec):
    def __init__(self, start: int, end: int, step: int, num_partitions: int,
                 max_batch_rows: int = 1 << 22, device="cuda"):
        super().__init__()
        self.start, self.end, self.step = start, end, step
        self.num_partitions = max(1, num_partitions)
        self.max_batch_rows = max_batch_rows
        self.device = resolve_device(device)
        self._schema = Schema([Field("id", dt.INT64, False)])

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self):
        total = max(0, -(-(self.end - self.start) // self.step)
                    if self.step != 0 else 0)
        per = (total + self.num_partitions - 1) // self.num_partitions or 1
        dev = self.device

        def part(i):
            lo = min(i * per, total)
            hi = min(lo + per, total)
            for off in range(lo, max(hi, lo + 1), self.max_batch_rows):
                n = min(self.max_batch_rows, hi - off)
                if n <= 0 and off != lo:
                    break
                n = max(n, 0)
                cap = bucket_rows(n)
                first = self.start + off * self.step
                valid = torch.arange(cap, device=dev) < n
                data = first + torch.arange(cap, dtype=torch.int64,
                                            device=dev) * self.step
                data = torch.where(valid, data, 0)
                yield DeviceBatch(["id"], [DeviceColumn(dt.INT64, data,
                                                        valid)], n)
                if hi == lo:
                    break
        return [part(i) for i in range(self.num_partitions)]


class TpuUnionExec(TpuExec):
    def __init__(self, children: Sequence[PhysicalPlan]):
        super().__init__()
        self.children = tuple(children)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        names = self.schema.names

        def run(it):
            # unify column names to the union schema
            for b in it:
                yield DeviceBatch(names, b.columns, b.num_rows, b.device)
        return [run(it) for c in self.children for it in c.execute()]


class TpuGlobalLimitExec(TpuExec):
    def __init__(self, child: PhysicalPlan, n: int):
        super().__init__()
        self.children = (child,)
        self.n = n

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        def run():
            remaining = self.n
            for it in self.children[0].execute():
                for b in it:
                    if remaining <= 0:
                        return
                    rows = int(b.num_rows)
                    take = min(remaining, rows)
                    remaining -= take
                    if take == rows:
                        yield b
                    else:
                        yield DeviceBatch(b.names, b.columns, take, b.device)
        return [run()]


class TpuCoalesceBatchesExec(TpuExec):
    """Goal-driven batch concatenation: batches of one partition up to a
    byte target (``TargetSize``), or every partition into one batch
    (``RequireSingleBatch``)."""

    def __init__(self, child: PhysicalPlan, goal: CoalesceGoal):
        super().__init__()
        self.children = (child,)
        self.goal = goal

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        target = self.goal.bytes if isinstance(self.goal, TargetSize) \
            else None

        def run(it):
            pending: List[DeviceBatch] = []
            pending_bytes = 0
            for b in it:
                if int(b.num_rows) == 0 and pending:
                    continue
                pending.append(b)
                pending_bytes += b.nbytes()
                if target is not None and pending_bytes >= target:
                    self.metrics.add_batches()
                    yield concat_batches(pending)
                    pending, pending_bytes = [], 0
            if pending:
                self.metrics.add_batches()
                yield concat_batches(pending)
        if isinstance(self.goal, RequireSingleBatch):
            def run_all():
                batches = [b for it in self.children[0].execute()
                           for b in it]
                if batches:
                    yield concat_batches(batches)
            return [run_all()]
        return [run(it) for it in self.children[0].execute()]


class TpuExpandExec(TpuExec):
    """N projections per input row: each batch yields one output batch per
    projection."""

    def __init__(self, child: PhysicalPlan,
                 projections: Sequence[Sequence[ir.Expression]],
                 schema: Schema):
        super().__init__()
        self.children = (child,)
        self.projections = projections
        self._schema = schema
        self._kernels = None

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self):
        if self._kernels is None:
            from spark_rapids_tpu_torch.exec import kernel_cache as kc
            from spark_rapids_tpu_torch.exec.fused_stage import \
                canonical_names

            def mk(proj):
                n_out = len(proj)

                def impl(batch):
                    cols = [eval_tpu.evaluate(e, batch).to_column()
                            for e in proj]
                    # positional output names; run() restamps the schema
                    return DeviceBatch(canonical_names(n_out), cols,
                                       batch.num_rows, batch.device)
                return kc.get_kernel(("expand", kc.exprs_sig(proj)),
                                     lambda: impl)
            self._kernels = [mk(p) for p in self.projections]
        names = self._schema.names

        def run(it):
            for b in it:
                for k in self._kernels:
                    out = k(b)
                    yield DeviceBatch(names, out.columns, out.num_rows,
                                      out.device)
        return [run(it) for it in self.children[0].execute()]
