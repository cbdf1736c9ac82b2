"""spark-rapids-tpu on PyTorch and CUDA: the port of ``spark_rapids_tpu``.

The JAX package beside this one is the reference.  This package keeps its
module paths and public names (``spark_rapids_tpu.exec.tpu_aggregate.
update_aggregate`` is ``spark_rapids_tpu_torch.exec.tpu_aggregate.
update_aggregate`` here) and runs them as eager torch code on an explicit
device; every Pallas kernel of the reference becomes a hand-written
Hopper kernel under ``csrc/``.  It imports neither jax nor the reference
package.

Ported so far: the DataFrame API and session
(:mod:`spark_rapids_tpu_torch.api`), the planner (column pruning, CPU
planning, the overrides with their fallbacks, whole-stage fusion), the
CPU engine, the Parquet scan with both readers, and the sorted-key hash
aggregate; the q6 forms of :mod:`spark_rapids_tpu_torch.entry` run
through them.
"""
