"""Per-task evaluation context: partition id + running row offset, and
the file slot of ``input_file_name()``.

Ported from ``spark_rapids_tpu/exec/context.py``.  The (partition id, row
offset) pair is what ``spark_partition_id()`` and
``monotonically_increasing_id()`` read; execs set it around each
``evaluate()`` call.

The file slot is a thread-local last-writer-wins slot that a scan sets immediately before
each batch is yielded -- not a generator-scoped contextvar, whose set and
reset straddle yield suspensions and so mis-attribute paths when two
scans are consumed interleaved (both sides of a join).  Thread-local
matches Spark's per-task InputFileBlockHolder: when partitions run on a
thread pool, each task thread sees only its own scan's path.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Any, Tuple

_CTX: contextvars.ContextVar[Tuple[Any, Any]] = contextvars.ContextVar(
    "spark_rapids_tpu_torch_eval_ctx", default=(0, 0))


def get() -> Tuple[Any, Any]:
    """(partition_id, row_offset)."""
    return _CTX.get()


@contextlib.contextmanager
def task_context(partition_id, row_offset):
    token = _CTX.set((partition_id, row_offset))
    try:
        yield
    finally:
        _CTX.reset(token)


_FILE_SLOT = threading.local()


def input_file() -> str:
    return getattr(_FILE_SLOT, "path", "")


def set_input_file(path: str) -> None:
    """Mark ``path`` as the source of the batch about to be yielded.

    Scans call ``set_input_file("")`` when exhausted, so a later query
    that reads no files sees Spark's empty-string default rather than a
    stale path."""
    _FILE_SLOT.path = path
