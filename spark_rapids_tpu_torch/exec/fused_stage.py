"""Whole-stage fused exec: one collapsed Project/Filter chain.

Ported from ``spark_rapids_tpu/exec/fused_stage.py`` (``TpuFusedStageExec``
:259, ``_impl`` :296, ``execute`` :340).  The planner pass in
:mod:`spark_rapids_tpu_torch.plan.fusion` collapses a maximal chain of
Project/Filter execs into one node that

  1. evaluates the AND of every filter condition in the chain (each
     rewritten over the stage INPUT schema),
  2. performs at most ONE stream compaction, and
  3. evaluates the composed output projection, so the chain's
     intermediate columns are never materialized.  When the output is at
     least as wide as the input the stage compacts first, else it
     projects first and compacts only the output columns.

A stage whose composed projection is pure column selection runs in
**passthrough** mode: a host-side column pick, no device work.

Here the stage runs as an eager torch composition of those three steps,
dispatched once per batch through the process kernel cache
(``exec/kernel_cache.get_kernel``) under the reference's key
``("fused_stage", out_exprs, condition, donate)`` (:216-219, :345-354),
so it is counted, observed and OOM-retried like every device step.  The
port never donates an input (``donate`` is always False), so the
reference's donation gate and its shared-scan check (:111-252) have no
counterpart.  The stage counts the dispatches it saves
(``fusion.dispatchesSaved``) per batch as the reference does: the chain
would have cost one per fused exec, the stage one (a passthrough none).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.exec import context
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, TpuExec, timed
from spark_rapids_tpu_torch.expr import eval_tpu, ir
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.plan.logical import Schema


def canonical_names(n: int):
    """Positional output names of a stage's step (``_c0``, ``_c1``, ...):
    output aliases never reach a kernel-cache key, and the exec restamps
    its schema's names after the dispatch."""
    return [f"_c{i}" for i in range(n)]


class TpuFusedStageExec(TpuExec):
    """One collapsed Project/Filter chain (see module docstring)."""

    def __init__(self, child: PhysicalPlan,
                 out_exprs: Sequence[ir.Expression], schema: Schema,
                 condition: Optional[ir.Expression] = None,
                 fused: Sequence[str] = ()):
        super().__init__()
        self.children = (child,)
        self.out_exprs = list(out_exprs)
        self._schema = schema
        self.condition = condition
        # display names of the execs this stage replaced (top-down)
        self.fused = tuple(fused)
        self._kernel = None

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def is_passthrough(self) -> bool:
        """Pure column selection: no condition and every output a plain
        BoundReference."""
        return self.condition is None and all(
            isinstance(e, ir.BoundReference) for e in self.out_exprs)

    def n_fused(self) -> int:
        return len(self.fused)

    def simple_string(self) -> str:
        mode = "passthrough" if self.is_passthrough else (
            "filter+project" if self.condition is not None else "project")
        return (f"TpuFusedStageExec({mode}, fused={len(self.fused)}: "
                f"{'+'.join(self.fused)})")

    def _impl(self, batch: DeviceBatch, pid: int = 0) -> DeviceBatch:
        """One batch through the stage, with positional output names
        (the caller restamps the schema's)."""
        from spark_rapids_tpu_torch.exec.tpu_basic import compact
        keep = None
        # the row offset stays 0, as in the reference: the planner keeps
        # monotonically_increasing_id() out of fused stages
        with context.task_context(pid, 0):
            if self.condition is not None:
                v = eval_tpu.evaluate(self.condition, batch)
                keep = v.data.to(torch.bool) & v.validity
                if len(self.out_exprs) >= len(batch.columns):
                    batch = compact(batch, keep)
                    keep = None
            cols = [eval_tpu.evaluate(e, batch).to_column()
                    for e in self.out_exprs]
        out = DeviceBatch(canonical_names(len(cols)), cols, batch.num_rows,
                          batch.device)
        return compact(out, keep) if keep is not None else out

    def execute(self):
        passthrough = self.is_passthrough
        names = self._schema.names
        ords = [e.ordinal for e in self.out_exprs] if passthrough else None
        saved = len(self.fused) if passthrough else \
            max(0, len(self.fused) - 1)
        if not passthrough and self._kernel is None:
            import functools
            import types
            from spark_rapids_tpu_torch.exec import kernel_cache as kc
            # detach from self: the cached step must not pin the exec
            # (and through it the child plan)
            shim = types.SimpleNamespace(out_exprs=self.out_exprs,
                                         condition=self.condition)
            key = ("fused_stage", kc.exprs_sig(self.out_exprs),
                   kc.expr_sig(self.condition), False)
            self._kernel = kc.get_kernel(
                key, lambda: functools.partial(type(self)._impl, shim))
        kernel = self._kernel

        def run(pid, it):
            reg = obsreg.get_registry()
            for b in it:
                if passthrough:
                    with timed(self.metrics, "fused.passthrough"):
                        out = DeviceBatch(names,
                                          [b.columns[i] for i in ords],
                                          b.num_rows, b.device)
                else:
                    with timed(self.metrics, "fused.eval"):
                        out = kernel(b, pid)
                    out = DeviceBatch(names, out.columns, out.num_rows,
                                      out.device)
                if saved:
                    reg.inc("fusion.dispatchesSaved", saved)
                self.metrics.add_batches()
                self.metrics.add_rows(out.num_rows)
                yield out
        return [run(pid, it) for pid, it in
                enumerate(self.children[0].execute())]
