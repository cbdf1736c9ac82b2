"""The device task gate.

Ported from ``spark_rapids_tpu/sched/admission.py``: only
:class:`TaskGate` (:49), the re-entrant slot source behind
``mem/device.tpu_semaphore``.  The reference's admission controller, its
estimate book and the wait queue it serves from (``sched/queue.py``)
belong to the query scheduler, which the port has not taken yet; the
gate needs none of them.
"""

from __future__ import annotations

import threading
import time

from spark_rapids_tpu_torch.sched import cancel as _cancel


class TaskGate:
    """Re-entrant-aware device-concurrency gate.

    A thread that already holds a slot re-enters for free (scan
    prefetch finishing under an exchange used to take a SECOND slot —
    deadlocking at 1 slot and double-counting blocked-ns under
    contention); only the outermost acquire touches the semaphore.
    Blocking acquires poll in short slices so a cancelled query stops
    waiting for a device slot instead of parking on it."""

    def __init__(self, slots: int):
        self.slots = max(1, int(slots))
        self._sem = threading.BoundedSemaphore(self.slots)
        self._tls = threading.local()

    def acquire(self) -> tuple:
        """Returns ``(wait_ns, reentrant)``; raises the cancellation
        exception instead of blocking when this query's token fires."""
        depth = getattr(self._tls, "depth", 0)
        if depth:
            self._tls.depth = depth + 1
            return 0, True
        wait_ns = 0
        if not self._sem.acquire(blocking=False):
            t0 = time.perf_counter_ns()
            while not self._sem.acquire(timeout=0.05):
                _cancel.check_current()
            wait_ns = time.perf_counter_ns() - t0
        self._tls.depth = 1
        return wait_ns, False

    def release(self) -> None:
        depth = getattr(self._tls, "depth", 0)
        if depth > 1:
            self._tls.depth = depth - 1
            return
        self._tls.depth = 0
        self._sem.release()

    @property
    def held_by_current_thread(self) -> bool:
        return getattr(self._tls, "depth", 0) > 0

    def available(self) -> int:
        """Free slots right now (test/diagnostic surface)."""
        return self._sem._value
