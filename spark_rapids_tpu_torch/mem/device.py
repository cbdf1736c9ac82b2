"""The device check and the task concurrency gate.

Ported from ``spark_rapids_tpu/mem/device.py``:

  * ``tpu_semaphore`` (:47) — bounds how many tasks concurrently build
    device working sets, with the reference's counters, its re-entrance
    and its cancellation check; ``initialize`` (:30) sizes it from
    ``concurrentTpuTasks``.
  * The reference's ``TpuDeviceManager`` sizes a memory pool over the
    device XLA owns.  The caching allocator owns the card's memory here,
    so what is left of it is :func:`check_device`: the session's device
    must exist, and its name is what the session reports; and
    :func:`memory_budget`, the pool size the reference's ``hbm_budget``
    gives the admission controller and the grace join.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch

from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.obs import trace as obstrace
from spark_rapids_tpu_torch.sched import cancel as _cancel
from spark_rapids_tpu_torch.sched.admission import TaskGate

_LOCK = threading.Lock()
_GATE: Optional[TaskGate] = None
_SLOTS = 2
_CPU_BUDGET = 8 << 30   # the reference's budget when no pool is known


def memory_budget(device=None) -> int:
    """The device byte budget when ``sched.memoryBudget`` is 0: 0.9 of a
    CUDA device's memory (the reference's pool fraction of its HBM
    limit), else the reference's 8 GiB."""
    if device is not None and torch.device(device).type == "cuda":
        return int(0.9 * torch.cuda.get_device_properties(
            torch.device(device)).total_memory)
    return _CPU_BUDGET


def initialize(concurrent_tasks: int) -> None:
    global _GATE, _SLOTS
    with _LOCK:
        _SLOTS = max(1, int(concurrent_tasks))
        _GATE = TaskGate(_SLOTS)


def _get() -> TaskGate:
    global _GATE
    with _LOCK:
        if _GATE is None:
            _GATE = TaskGate(_SLOTS)
        return _GATE


@contextlib.contextmanager
def tpu_semaphore(metrics=None):
    """Acquire one device-concurrency slot, measuring acquisition count
    and acquire-blocked nanoseconds so concurrency-limit starvation is
    visible per query: process-wide into the metrics registry
    (``semaphore.acquires`` / ``semaphore.waitNs``), per-exec into
    ``metrics.extra`` when the caller passes its Metrics, and as a
    ``semaphore.wait`` span when tracing is on.

    The slot source is the re-entrant
    :class:`~spark_rapids_tpu_torch.sched.admission.TaskGate`: a thread
    that already holds a slot re-enters for free (no second slot, which
    deadlocked at 1 slot, and no double-counted blocked-ns); re-entries
    count into ``semaphore.reentries`` instead of ``semaphore.acquires``.
    A cancelled query raises at the acquire instead of taking (or
    waiting on) a slot."""
    _cancel.check_current()
    gate = _get()
    wait_ns, reentrant = gate.acquire()
    reg = obsreg.get_registry()
    if reentrant:
        reg.inc("semaphore.reentries")
        if metrics is not None:
            metrics.add_extra("semaphore.reentries", 1)
        try:
            yield
        finally:
            gate.release()
        return
    if wait_ns:
        obstrace.record("semaphore.wait",
                        time.perf_counter_ns() - wait_ns, wait_ns,
                        cat="semaphore")
        reg.inc_many(("semaphore.acquires", 1),
                     ("semaphore.waitNs", wait_ns))
    else:
        reg.inc("semaphore.acquires")
    if metrics is not None:
        metrics.add_extra("semaphore.acquires", 1)
        if wait_ns:
            metrics.add_extra("semaphore.waitNs", wait_ns)
    try:
        yield
    finally:
        gate.release()


def check_device(device: torch.device) -> str:
    """The name of ``device``, which must exist: a CUDA index past the
    cards this process sees raises (``resolve_device`` has already
    refused ``cuda`` without a card)."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {device} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) are visible")
    return torch.cuda.get_device_name(index)
