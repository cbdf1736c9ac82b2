"""Size-rotated JSONL appends, shared by the slow-query log and the
drift sentinel's breach stream.

Copied whole from ``spark_rapids_tpu/obs/jsonl.py``.

An append-forever JSONL file on a long-lived serving engine grows
unbounded; the rotation contract here is deliberately minimal (the
logrotate keep-1 shape): when an append would push the file past
``max_bytes``, the current file is atomically renamed to
``<path>.1`` (replacing any previous ``.1``) and the append starts a
fresh file.  At most ``2 x max_bytes`` ever sits on disk per log, the
newest records are always in ``<path>``, and a crash mid-rotation
loses nothing — ``os.replace`` is atomic on POSIX.

``max_bytes <= 0`` disables rotation (the pre-rotation append-only
behaviour).  Concurrent appenders within one process serialize on a
module lock; rotation across processes is last-writer-wins, which is
the slow-query log's existing multi-session semantics.
"""

from __future__ import annotations

import os
import threading

_LOCK = threading.Lock()


def rotating_append(path: str, line: str, max_bytes: int = 0) -> None:
    """Append ``line`` (newline added) to ``path``, rotating first when
    the append would exceed ``max_bytes``."""
    data = line + "\n"
    with _LOCK:
        if max_bytes and max_bytes > 0:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
            if size and size + len(data) > max_bytes:
                try:
                    os.replace(path, path + ".1")
                except OSError:
                    pass     # rotation failure must not drop the record
        with open(path, "a") as f:
            f.write(data)
