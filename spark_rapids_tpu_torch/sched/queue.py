"""Priority + FIFO-within-priority wait queue for query admission.

Copied whole from ``spark_rapids_tpu/sched/queue.py``.

A small lazy-deletion binary heap: entries order by (-priority, seq) so
a higher ``priority`` value runs first and equal priorities keep strict
submit order (the seq is a process-wide monotonic counter).  Removal
(cancel / timeout while queued) marks the entry dead; dead heads pop
lazily on the next ``peek``.  The admission controller serves strictly
from the head — no smaller-query bypass — so a large query at the head
of its priority band cannot be starved by a stream of small ones
(head-of-line admission, the trade the reference's bare semaphore also
makes, just without the priority bands).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Any, Optional

_seq = itertools.count()


class WaitEntry:
    """One queued admission request."""

    __slots__ = ("priority", "seq", "payload", "removed")

    def __init__(self, priority: int, payload: Any = None):
        self.priority = int(priority)
        self.seq = next(_seq)
        self.payload = payload
        self.removed = False

    def __lt__(self, other: "WaitEntry") -> bool:
        # heapq ordering: higher priority first, then FIFO
        if self.priority != other.priority:
            return self.priority > other.priority
        return self.seq < other.seq


class WaitQueue:
    """Thread-compatible (caller holds the admission lock) wait queue."""

    def __init__(self):
        self._heap: list = []

    def push(self, entry: WaitEntry) -> None:
        heapq.heappush(self._heap, entry)

    def peek(self) -> Optional[WaitEntry]:
        """The live head (dead entries pop lazily)."""
        while self._heap and self._heap[0].removed:
            heapq.heappop(self._heap)
        return self._heap[0] if self._heap else None

    def pop_head(self) -> Optional[WaitEntry]:
        head = self.peek()
        if head is not None:
            heapq.heappop(self._heap)
        return head

    def remove(self, entry: WaitEntry) -> None:
        """Lazy removal: O(1) now, reclaimed at the next peek."""
        entry.removed = True

    def __len__(self) -> int:
        return sum(1 for e in self._heap if not e.removed)

    def __bool__(self) -> bool:
        return self.peek() is not None
