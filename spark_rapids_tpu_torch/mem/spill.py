"""Spill handles: the get()/close() holders that operators buffer batches
through.

Ported from ``spark_rapids_tpu/mem/spill.py``'s handle API
(``PlainBatchHandle`` :402, ``register_or_hold`` :427).  The reference
registers a batch with its spill catalog when
``spark.rapids.tpu.memory.spill.enabled`` is on, so a buffered batch can
move device -> host -> disk under memory pressure.  The port has no spill
catalog yet (ROADMAP A7): :func:`register_or_hold` returns a
:class:`PlainBatchHandle` whatever that key says, and a held batch stays
on the device until its handle closes.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch


class PlainBatchHandle:
    """SpillableBatch-shaped holder (get/close) of a device batch."""

    def __init__(self, batch: DeviceBatch):
        self._batch = batch

    def get(self) -> DeviceBatch:
        return self._batch

    def close(self) -> None:
        self._batch = None

    def __enter__(self) -> "PlainBatchHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def register_or_hold(batch: DeviceBatch) -> PlainBatchHandle:
    """A get()/close() handle for ``batch``.  The reference registers the
    batch in its spill catalog when spilling is on; the port has no
    catalog yet, so this is always a plain handle."""
    return PlainBatchHandle(batch)
