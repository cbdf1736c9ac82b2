"""Memory-budget-aware query admission control + the device task gate.

Copied whole from ``spark_rapids_tpu/sched/admission.py``, its module
paths retargeted.  The port's budget is the card's: ``sched.memoryBudget``
or 0.9 of the session's CUDA device memory (8 GiB on the CPU), and the
pressure callback is the port's ``mem/spill.handle_memory_pressure``.
One repair: ``acquire`` does not bump ``sched.queueWaitNs`` (the query
service does, with the ledger's charge), so the counter equals the sum
over tenants where the reference's counts each wait twice.

Replaces the bare ``concurrentGpuTasks`` counting semaphore as the
engine's concurrency authority (reference: GpuSemaphore.scala:27-161),
split into the two layers the reference conflates:

* :class:`AdmissionController` — **inter-query**: each submitted query
  declares an HBM working-set estimate; the controller admits from a
  priority + FIFO wait queue while ``sum(estimates) <= memory_budget``
  with ``max_concurrent`` as a hard cap, and degrades gracefully by
  queueing (never by letting an over-committed fleet OOM).  Theseus
  (arXiv:2508.05029) and the Presto-GPU port both gate multi-query
  throughput this way: memory-aware admission + cross-query overlap of
  host prep with device dispatch, not per-query kernel speed.
* :class:`TaskGate` — **intra-query**: how many tasks of admitted
  queries may concurrently build device working sets (the original
  ``tpu_semaphore`` role, now re-entrant-aware:
  ``mem/device.tpu_semaphore`` keeps its surface and delegates here).

Estimates refine across runs: :class:`EstimateBook` keys the observed
device-bytes peak GROWTH over the query's run (the spill catalog's
arena accounting, ``HighWaterTracker.delta``) by *plan shape*, so the
second run of a query shape is admitted on what it actually added
rather than the conservative ``batchSize x concurrent scan/shuffle
depth`` derivation.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.obs import trace as obstrace
from spark_rapids_tpu_torch.sched import cancel as _cancel
from spark_rapids_tpu_torch.sched.queue import WaitEntry, WaitQueue


class QueryRejectedError(RuntimeError):
    """Submission refused outright (wait queue at ``sched.maxQueued``)."""


# ---------------------------------------------------------------------------
# Intra-query device task gate (the tpu_semaphore backing store)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Plan-shape keyed estimate refinement
# ---------------------------------------------------------------------------

def plan_shape_key(plan) -> Any:
    """Structural signature of a logical plan: node class names +
    output column names, recursively.  Two queries with the same shape
    share an estimate-book entry (literal values intentionally ignored
    — a changed filter constant rarely changes the working set
    class)."""
    try:
        names = tuple(plan.schema.names)
    except Exception:
        names = ()
    return (type(plan).__name__, names,
            tuple(plan_shape_key(c) for c in plan.children))


class EstimateBook:
    """Bounded map of plan shape -> observed device-bytes high water.

    ``record`` takes a new high observation as-is but DECAYS toward
    lower ones (halfway per run) instead of keeping the max forever —
    one run that overlapped a heavyweight neighbour must not
    permanently serialize a cheap shape; ``estimate`` returns the
    observation padded with headroom.  LRU eviction at
    ``max_entries``."""

    HEADROOM = 1.25
    FLOOR = 16 << 20

    def __init__(self, max_entries: int = 256):
        from collections import OrderedDict
        self._max = max_entries
        self._book: "OrderedDict[Any, int]" = OrderedDict()
        self._lock = threading.Lock()

    def estimate(self, shape_key: Any) -> Optional[int]:
        with self._lock:
            obs = self._book.get(shape_key)
            if obs is None:
                return None
            self._book.move_to_end(shape_key)
            return max(int(obs * self.HEADROOM), self.FLOOR)

    def record(self, shape_key: Any, observed_bytes: int) -> None:
        if observed_bytes <= 0:
            return
        with self._lock:
            old = self._book.get(shape_key)
            obs = int(observed_bytes)
            self._book[shape_key] = obs if old is None or obs >= old \
                else (old + obs) // 2
            self._book.move_to_end(shape_key)
            while len(self._book) > self._max:
                self._book.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._book)


# ---------------------------------------------------------------------------
# Admission controller
# ---------------------------------------------------------------------------

class AdmissionRequest:
    """One query's admission claim."""

    __slots__ = ("query_id", "estimate", "priority", "token",
                 "enqueue_ns", "queue_wait_ns")

    def __init__(self, query_id: int, estimate: int, priority: int = 0,
                 token: Optional[_cancel.CancelToken] = None):
        self.query_id = query_id
        self.estimate = max(0, int(estimate))
        self.priority = int(priority)
        self.token = token
        self.enqueue_ns = 0
        self.queue_wait_ns = 0


class AdmissionSlot:
    """Held admission: release exactly once (context-manager friendly)."""

    __slots__ = ("_controller", "_request", "_released")

    def __init__(self, controller: "AdmissionController",
                 request: AdmissionRequest):
        self._controller = controller
        self._request = request
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._controller._release(self._request)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.release()


class AdmissionController:
    """Priority wait queue + memory-budget admission (module docstring).

    Invariants:
      * at most ``max_concurrent`` queries admitted;
      * ``admitted_bytes + estimate <= memory_budget`` — EXCEPT when
        nothing is running, where the head always admits (progress
        guarantee: a query estimated over the whole budget still runs,
        alone, leaning on the spill catalog instead of deadlocking);
      * strict head-of-line order within the priority bands.

    ``pressure_cb(bytes_needed)`` (wired to
    ``mem/spill.handle_memory_pressure``) fires when an admission lands
    in the top of the budget, proactively spilling registered batches so
    the admitted query's working set has real HBM behind its estimate.
    """

    # admissions that leave less than this fraction of the budget free
    # trigger the memory-pressure callback
    PRESSURE_FRACTION = 0.2

    def __init__(self, memory_budget: int, max_concurrent: int,
                 max_queued: int = 1024,
                 pressure_cb: Optional[Callable[[int], int]] = None):
        self.memory_budget = max(1, int(memory_budget))
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_queued = max(1, int(max_queued))
        self._pressure_cb = pressure_cb
        self._cond = threading.Condition()
        self._queue = WaitQueue()
        self._running: Dict[int, int] = {}       # query_id -> estimate
        self.admitted_bytes = 0

    # -- introspection (tests, gauges) --------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {"queued": len(self._queue),
                    "running": len(self._running),
                    "admitted_bytes": self.admitted_bytes}

    def _publish_locked(self) -> None:
        reg = obsreg.get_registry()
        reg.set_gauge("sched.queued", len(self._queue))
        reg.set_gauge("sched.running", len(self._running))
        reg.set_gauge("sched.admittedBytes", self.admitted_bytes)
        reg.gauge_max("sched.runningHwm", len(self._running))

    def _can_admit_locked(self, estimate: int) -> bool:
        if len(self._running) >= self.max_concurrent:
            return False
        if not self._running:
            return True   # progress guarantee (see class docstring)
        return self.admitted_bytes + estimate <= self.memory_budget

    # -- the blocking acquire ------------------------------------------------
    def acquire(self, req: AdmissionRequest) -> AdmissionSlot:
        """Block until admitted; raises QueryRejectedError (queue full),
        QueryCancelledError / QueryTimeoutError (token fired while
        queued — the deadline timer cancels the token)."""
        reg = obsreg.get_registry()
        entry = WaitEntry(req.priority, req)
        req.enqueue_ns = time.perf_counter_ns()

        def wake() -> None:
            with self._cond:
                self._cond.notify_all()

        with self._cond:
            if len(self._queue) >= self.max_queued:
                reg.inc("sched.rejected")
                obsrec.record_event("sched.rejected",
                                    query=req.query_id,
                                    queued=len(self._queue))
                raise QueryRejectedError(
                    f"query {req.query_id}: wait queue full "
                    f"({self.max_queued} queued)")
            self._queue.push(entry)
            self._publish_locked()
        if req.token is not None:
            req.token.add_callback(wake)
        blocked = False
        try:
            with self._cond:
                while True:
                    if req.token is not None and req.token.is_cancelled:
                        raise self._queued_cancel_exc(req, reg)
                    if (self._queue.peek() is entry and
                            self._can_admit_locked(req.estimate)):
                        self._queue.pop_head()
                        self._running[req.query_id] = req.estimate
                        self.admitted_bytes += req.estimate
                        reg.inc("sched.admitted")
                        obsrec.record_event(
                            "sched.admitted", query=req.query_id,
                            estimate_bytes=req.estimate,
                            priority=req.priority,
                            running=len(self._running),
                            admitted_bytes=self.admitted_bytes)
                        self._publish_locked()
                        # wake the NEW head: budget may fit it too —
                        # without this, back-to-back admissions staircase
                        # on the defensive wait timeout
                        self._cond.notify_all()
                        break
                    # defensive timeout: a lost notify must not park the
                    # query forever (cancel/release both notify_all)
                    blocked = True
                    self._cond.wait(timeout=0.25)
        except BaseException:
            with self._cond:
                self._queue.remove(entry)
                self._publish_locked()
                self._cond.notify_all()
            raise
        finally:
            if req.token is not None:
                req.token.remove_callback(wake)
        # wait is attributed only when admission actually blocked — an
        # instantly admitted query reports 0 instead of clock-read noise
        # (keeps the ci smoke's `any(wait > 0)` assertion meaningful and
        # uncontended queries out of the queueWait span/histogram)
        req.queue_wait_ns = (time.perf_counter_ns() - req.enqueue_ns
                             if blocked else 0)
        if req.queue_wait_ns:
            # the sched.queueWaitNs counter is bumped once, by the query
            # service beside the ledger's charge of the same n (the
            # reference bumps it here as well, counting each wait twice)
            reg.observe("sched.queueWait", req.queue_wait_ns)
            obstrace.record("sched.queueWait", req.enqueue_ns,
                            req.queue_wait_ns, cat="sched",
                            args={"query": req.query_id,
                                  "priority": req.priority})
        self._maybe_pressure(req.estimate)
        return AdmissionSlot(self, req)

    def _queued_cancel_exc(self, req: AdmissionRequest, reg):
        if req.token.timed_out:
            reg.inc("sched.timedOut")
        else:
            reg.inc("sched.cancelled")
        obsrec.record_event(
            "sched.cancelledWhileQueued", query=req.query_id,
            timed_out=bool(req.token.timed_out))
        try:
            req.token.check()
        except _cancel.QueryCancelledError as e:
            return e
        return _cancel.QueryCancelledError(
            f"query {req.query_id}: cancelled while queued")

    def _maybe_pressure(self, estimate: int) -> None:
        """Outside the lock: when the admission lands in the top of the
        budget, ask the spill catalog to free real HBM up front."""
        if self._pressure_cb is None:
            return
        with self._cond:
            headroom = self.memory_budget - self.admitted_bytes
        if headroom < self.memory_budget * self.PRESSURE_FRACTION:
            try:
                freed = self._pressure_cb(max(estimate, -headroom))
            except Exception:
                return
            if freed:
                obsreg.get_registry().inc("sched.pressureSpillBytes",
                                          freed)
                obsrec.record_event("sched.pressureSpill",
                                    freed_bytes=freed,
                                    headroom_bytes=headroom)

    def _release(self, req: AdmissionRequest) -> None:
        with self._cond:
            est = self._running.pop(req.query_id, None)
            if est is not None:
                self.admitted_bytes -= est
            self._publish_locked()
            self._cond.notify_all()
        if est is not None:
            obsrec.record_event("sched.released", query=req.query_id,
                                estimate_bytes=est)
