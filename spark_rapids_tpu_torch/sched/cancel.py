"""Cooperative query cancellation: tokens + checkpoints.

Copied whole from ``spark_rapids_tpu/sched/cancel.py``, its module
paths retargeted.

A :class:`CancelToken` is created per submitted query by the
:mod:`spark_rapids_tpu_torch.sched.service` layer and *installed* on every
thread that does work for that query — the service worker itself, the
session task pool (``_drain_partitions``), scan prefetch threads, and
exchange map-stage submit threads.  Hot paths call
:func:`check_current` (one thread-local read + one bool check when no
cancellation is pending) and unwind with :class:`QueryCancelledError`
/ :class:`QueryTimeoutError` when the token fires, so a cancelled or
timed-out query releases its admission slot, drains its prefetcher,
cancels in-flight shuffle fetches, and frees spill-catalog entries
through the same ``finally`` paths an ordinary failure takes.

Reference analog: Spark's ``TaskContext.isInterrupted`` checked by
long-running task loops (the reference plugin inherits it); on this
engine queries are thread trees in one process, so the token is the task
kill flag.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional


class QueryCancelledError(RuntimeError):
    """The query's CancelToken fired (user cancel() or unwind)."""


class QueryTimeoutError(QueryCancelledError):
    """The query's deadline elapsed (``sched.defaultTimeoutMs`` or the
    per-submit override); subclasses :class:`QueryCancelledError` so
    every cancellation checkpoint raises the precise type without
    knowing why the token fired."""


class CancelToken:
    """Per-query cancellation flag with wake-up callbacks.

    ``cancel()`` is idempotent (first caller wins, returns True);
    callbacks registered via :meth:`add_callback` run exactly once —
    on the cancelling thread, or immediately at registration when the
    token already fired — so blocked waiters (admission condition
    variables, shuffle completion queues) can be woken event-driven
    instead of polled.  Callback exceptions are swallowed: a broken
    waker must not mask the cancellation itself.
    """

    __slots__ = ("query_id", "reason", "_cancelled", "_timed_out",
                 "_lock", "_callbacks")

    def __init__(self, query_id: Optional[int] = None):
        self.query_id = query_id
        self.reason: Optional[str] = None
        self._cancelled = False
        self._timed_out = False
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[], None]] = []

    def cancel(self, reason: str = "cancelled",
               timed_out: bool = False) -> bool:
        with self._lock:
            if self._cancelled:
                return False
            self._cancelled = True
            self._timed_out = timed_out
            self.reason = reason
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn()
            except Exception:
                pass
        return True

    @property
    def is_cancelled(self) -> bool:
        return self._cancelled

    @property
    def timed_out(self) -> bool:
        return self._timed_out

    def add_callback(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if not self._cancelled:
                self._callbacks.append(fn)
                return
        try:
            fn()
        except Exception:
            pass

    def remove_callback(self, fn: Callable[[], None]) -> None:
        with self._lock:
            with contextlib.suppress(ValueError):
                self._callbacks.remove(fn)

    def check(self) -> None:
        """Raise the precise cancellation exception if fired."""
        if self._cancelled:
            qid = f"query {self.query_id}: " if self.query_id else ""
            if self._timed_out:
                raise QueryTimeoutError(qid + (self.reason or "timed out"))
            raise QueryCancelledError(qid + (self.reason or "cancelled"))


# ---------------------------------------------------------------------------
# Thread-local current token (explicit capture/install, because the
# engine's thread pools — task pool, scan prefetcher, map-stage submit
# threads — do not propagate contextvars automatically)
# ---------------------------------------------------------------------------

_TLS = threading.local()


def current() -> Optional[CancelToken]:
    """The token installed on this thread (None outside any query)."""
    return getattr(_TLS, "token", None)


@contextlib.contextmanager
def install(token: Optional[CancelToken]):
    """Install ``token`` as this thread's current query token.  Pool
    workers capture ``current()`` on the submitting thread and install
    it in the worker (the explicit-capture idiom)."""
    prev = getattr(_TLS, "token", None)
    _TLS.token = token
    try:
        yield token
    finally:
        _TLS.token = prev


def check_current() -> None:
    """The cancellation checkpoint the exec hot paths call per batch:
    one thread-local read + one bool check when nothing is cancelled."""
    tok = getattr(_TLS, "token", None)
    if tok is not None and tok._cancelled:
        tok.check()
