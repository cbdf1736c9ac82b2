"""Helpers of the port's scheduler tests: the reference's ``Parker``
(``tests/test_scheduler.py``) and its leak check, for a port session.

``Parker`` is a plan listener that holds each query at plan time,
inside its admitted window, until ``release`` is set (at most 30 s).  It
records the admission order by each plan's last output name, and a
fired ``CancelToken`` unparks at once so the query unwinds at its next
checkpoint.  ``join_query_threads`` is an autouse module fixture of the
files that import it.
"""

import threading
import time

import pytest

from spark_rapids_tpu_torch.mem import device as devmgr
from spark_rapids_tpu_torch.sched import cancel as sched_cancel


class Parker:
    def __init__(self, park=True):
        self.park = park
        self.order = []
        self.release = threading.Event()
        self.parked = threading.Semaphore(0)
        self._lock = threading.Lock()

    def __call__(self, result):
        with self._lock:
            self.order.append(result.plan.schema.names[-1])
        if not self.park:
            return
        self.parked.release()
        tok = sched_cancel.current()
        deadline = time.time() + 30
        while not self.release.is_set() and time.time() < deadline:
            if tok is not None and tok.is_cancelled:
                return
            time.sleep(0.005)


def assert_clean(s):
    """No leaked admission slots, queue entries or device-gate slots."""
    stats = s.scheduler.controller.stats()
    assert stats["running"] == 0, stats
    assert stats["queued"] == 0, stats
    assert stats["admitted_bytes"] == 0, stats
    gate = devmgr._get()
    assert gate.available() == gate.slots


def wait_until(cond, timeout=20.0):
    """Poll ``cond`` every 10 ms for at most ``timeout`` seconds."""
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.fixture(scope="module", autouse=True)
def join_query_threads():
    """After a module, wait (at most 60 s) for every query thread of the
    service: a query still running torch code when the worker process
    exits would take the process down with it."""
    yield
    deadline = time.time() + 60
    for t in threading.enumerate():
        if t.name.startswith("sched-q"):
            t.join(max(0.0, deadline - time.time()))
