"""Generate execs: explode/posexplode (and their outer forms) over list
columns.

Ported from ``spark_rapids_tpu/exec/generate.py`` (``CpuGenerateExec``
:29, ``_generate_kernel`` :86, ``TpuGenerateExec`` :136).  The device
exec takes the reference's two passes: the count pass evaluates the list
and sums each row's emission count, with one host read of the total per
batch; the emit pass runs at ``bucket_rows(total)``, maps each output
slot back to its source row and element ordinal by a binary search of
the inclusive count sums (``torch.searchsorted(incl, k, right=True)``),
and gathers.  Both passes dispatch through the process kernel cache
under the reference's keys (``gen_count``, ``gen_emit``, :158-171).  The
reference evaluates the list once per pass; here the count step returns
the evaluated list with its counts, and the emit step takes them.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   bucket_rows)
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, TpuExec, timed
from spark_rapids_tpu_torch.expr import eval_cpu, eval_tpu, ir
from spark_rapids_tpu_torch.expr.eval_tpu import ColVal
from spark_rapids_tpu_torch.plan.logical import Schema


class CpuGenerateExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, generator: ir.Generator,
                 schema: Schema):
        super().__init__()
        self.children = (child,)
        self.generator = generator
        self._schema = schema

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self):
        gen = self.generator
        outer = gen.outer
        with_pos = isinstance(gen, ir.PosExplode)
        el = gen.children[0].dtype.element

        def run(it) -> Iterator[pa.Table]:
            for t in it:
                v = eval_cpu.evaluate(gen.children[0], t)
                n = t.num_rows
                counts = np.zeros(n, dtype=np.int64)
                for i in range(n):
                    c = len(v.data[i]) if v.valid[i] else 0
                    counts[i] = max(c, 1) if outer else c
                base = t.take(pa.array(np.repeat(np.arange(n), counts)))
                pos: List[Optional[int]] = []
                elems: List = []
                for i in range(n):
                    lst = v.data[i] if v.valid[i] else None
                    c = len(lst) if lst is not None else 0
                    if c == 0:
                        if outer:
                            pos.append(None)
                            elems.append(None)
                        continue
                    for j in range(c):
                        pos.append(j)
                        elems.append(lst[j])
                arrays = list(base.columns)
                names = list(base.column_names)
                if with_pos:
                    arrays.append(pa.array(pos, type=pa.int32()))
                    names.append(self._schema.names[len(names)])
                arrays.append(pa.array(elems, type=el.to_arrow()))
                names.append(self._schema.names[len(names)])
                out = pa.Table.from_arrays(arrays, names=names)
                self.metrics.add_rows(out.num_rows)
                yield out

        return [run(it) for it in self.children[0].execute()]


def _counts(v: ColVal, batch: DeviceBatch, outer: bool) -> torch.Tensor:
    """Rows emitted per input row: the list's length (0 for a null list);
    the outer forms emit one row for an empty or null list."""
    counts = torch.where(v.validity, v.lengths, 0).to(torch.int64)
    if outer:
        counts = torch.where(batch.row_mask(),
                             torch.clamp(counts, min=1), 0)
    return counts


def _generate_kernel(batch: DeviceBatch, v: ColVal, counts: torch.Tensor,
                     total: int, out_cap: int, gen: ir.Generator,
                     schema: Schema, with_pos: bool,
                     outer: bool) -> DeviceBatch:
    dev = batch.device
    incl = torch.cumsum(counts, 0)
    k = torch.arange(out_cap, dtype=torch.int64, device=dev)
    r = torch.clamp(torch.searchsorted(incl, k, right=True), 0,
                    batch.capacity - 1)
    j = k - (incl[r] - counts[r])
    valid_out = k < total

    cols = [c.gather(r, valid_out) for c in batch.columns]
    names = list(batch.names)

    eff_len = torch.where(v.validity, v.lengths, 0)[r]
    if with_pos:
        # outer rows emitted for an empty or null list carry a null pos
        pos_valid = valid_out & (eff_len != 0) if outer else valid_out
        pos = torch.where(pos_valid, j, 0).to(torch.int32)
        cols.append(DeviceColumn(dt.INT32, pos, pos_valid))
        names.append(schema.names[len(names)])

    # element (r, j) read from the flat payload: no [out_cap, max_len]
    # copy of the source rows
    max_len = v.data.shape[1]
    flat = r * max_len + torch.clamp(j, 0, max_len - 1)
    elem = v.data.reshape(-1)[flat]
    elem_ok = v.elem_validity.reshape(-1)[flat] \
        if v.elem_validity is not None else torch.ones_like(valid_out)
    elem_valid = valid_out & (j < eff_len) & elem_ok
    el = gen.children[0].dtype.element
    cols.append(DeviceColumn(
        el, torch.where(elem_valid, elem, 0).to(el.to_torch()), elem_valid))
    names.append(schema.names[len(names)])
    return DeviceBatch(names, cols, total, dev)


class TpuGenerateExec(TpuExec):
    """Two-pass explode: count on the device (one host read per batch),
    emit at the bucketed capacity."""

    def __init__(self, child: PhysicalPlan, generator: ir.Generator,
                 schema: Schema):
        super().__init__()
        self.children = (child,)
        self.generator = generator
        self._schema = schema
        self._kernels = {}

    @property
    def schema(self) -> Schema:
        return self._schema

    def execute(self):
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        gen = self.generator
        with_pos = isinstance(gen, ir.PosExplode)
        outer = gen.outer
        schema = self._schema

        def count_fn(b):
            v = eval_tpu.evaluate(gen.children[0], b)
            counts = _counts(v, b, outer)
            return v, counts, counts.sum()

        def run(it) -> Iterator[DeviceBatch]:
            gsig = kc.expr_sig(gen)
            for b in it:
                ckey = ("gen_count", gsig, outer, b.schema_key())
                if ckey not in self._kernels:
                    self._kernels[ckey] = kc.get_kernel(
                        ckey, lambda: count_fn)
                with timed(self.metrics, "generate.count"):
                    v, counts, total = self._kernels[ckey](b)
                    total = int(total)
                out_cap = bucket_rows(total)
                ekey = ("gen_emit", gsig, out_cap, with_pos, outer,
                        tuple(schema.names), b.schema_key())
                if ekey not in self._kernels:
                    # out_cap bound now: the step outlives this loop
                    self._kernels[ekey] = kc.get_kernel(
                        ekey, lambda oc=out_cap: lambda bb, vv, cc, tt:
                        _generate_kernel(bb, vv, cc, tt, oc, gen, schema,
                                         with_pos, outer))
                with timed(self.metrics, "generate.emit"):
                    out = self._kernels[ekey](b, v, counts, total)
                self.metrics.add_rows(total)
                self.metrics.add_batches()
                yield out

        return [run(it) for it in self.children[0].execute()]
