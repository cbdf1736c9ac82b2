"""Per-task evaluation context: the file slot of ``input_file_name()``.

Ported from ``spark_rapids_tpu/exec/context.py`` (:38-60): the file-scan
slot only (the partition id / row offset context is not ported yet).

A thread-local last-writer-wins slot that a scan sets immediately before
each batch is yielded -- not a generator-scoped contextvar, whose set and
reset straddle yield suspensions and so mis-attribute paths when two
scans are consumed interleaved (both sides of a join).  Thread-local
matches Spark's per-task InputFileBlockHolder: when partitions run on a
thread pool, each task thread sees only its own scan's path.
"""

from __future__ import annotations

import threading

_FILE_SLOT = threading.local()


def input_file() -> str:
    return getattr(_FILE_SLOT, "path", "")


def set_input_file(path: str) -> None:
    """Mark ``path`` as the source of the batch about to be yielded.

    Scans call ``set_input_file("")`` when exhausted, so a later query
    that reads no files sees Spark's empty-string default rather than a
    stale path."""
    _FILE_SLOT.path = path
