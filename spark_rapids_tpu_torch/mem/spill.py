"""Spill framework: device -> host -> disk tiered batch storage.

Ported from ``spark_rapids_tpu/mem/spill.py``: ``StorageTier``,
``BufferCatalog`` (:110) with its device, host and disk tiers, spill
priorities, ``spill_to_fit``, ``acquire``, ``release`` and the
``HighWaterTracker``; ``SpillableBatch``; ``register_or_hold`` (:427);
``init_catalog`` / ``disable_catalog`` / ``is_enabled``; the pressure
spillers and ``handle_memory_pressure`` (:575); ``hbm_oom_recover``
(:509).

The catalog enforces a *budget*, as the reference's does: every
registered batch counts toward a device-bytes ceiling
(``spark.rapids.tpu.memory.device.batchStorageSize``), and crossing it
(or an explicit ``spill_to_fit``) synchronously spills the
lowest-priority buffers device -> host -> disk.  The host tier stages its
copies in a :class:`~spark_rapids_tpu_torch.mem.host_arena.HostArena`,
pinned when the catalog's device is a CUDA card and made at the first
spill (``min(host budget, 1 GiB)``); a buffer the arena cannot hold gets
plain host memory.  Overflowing the host budget falls through to disk
(``.npz`` files under the spill dir, made at the first disk spill).

A spilled batch comes back with its columns' value-range and no-null
hints (``vbits``, ``nonnull``) and list element validity; the
reference's round trip drops the hints, which changes no row.

A freed device tensor goes back to PyTorch's caching allocator, which
the retry after ``hbm_oom_recover`` reuses, so the bytes freed are the
catalog's own accounting, not ``torch.cuda.memory_reserved()``.  Each
spill and OOM retry counts in the registry (``spill.*``,
``mem.oomRetries``) and records the reference's flight-recorder event
(``spill.deviceToHost``, ``spill.hostToDisk``, ``mem.oomRetry``).
"""

from __future__ import annotations

import enum
import itertools
import os
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, DeviceColumn
from spark_rapids_tpu_torch.mem.host_arena import HostArena
from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg


class StorageTier(enum.IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


# spill priorities (reference: SpillPriorities.scala)
ACTIVE_ON_DECK_PRIORITY = 1 << 40
ACTIVE_BATCHING_PRIORITY = 1 << 30
INPUT_FROM_SHUFFLE_PRIORITY = 0
OUTPUT_FOR_SHUFFLE_PRIORITY = -(1 << 30)
# grace-join build/probe partitions parked while another partition is
# being joined: the coldest data in the process, they spill first
GRACE_JOIN_PARTITION_PRIORITY = -(1 << 31)

_PARTS = ("data", "validity", "lengths", "elem_validity")


@dataclass
class _HostPayload:
    """Host copy of a batch: per column the CPU tensors of its buffers
    (``_PARTS``, None where the column has none), arena-backed where a
    block fits."""

    arrays: List[Tuple[Optional[torch.Tensor], ...]]
    allocations: List = field(default_factory=list)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for col in self.arrays for t in col if t is not None)

    def close(self):
        self.arrays = []
        for a in self.allocations:
            a.close()
        self.allocations = []


class _Buffer:
    def __init__(self, buffer_id: int, batch: DeviceBatch, priority: int):
        self.id = buffer_id
        self.priority = priority
        self.tier = StorageTier.DEVICE
        self.device_batch: Optional[DeviceBatch] = batch
        self.host: Optional[_HostPayload] = None
        self.disk_path: Optional[str] = None
        self.size = batch.nbytes()
        self.device = batch.device
        # num_rows may be a device scalar: reading it here would make a
        # host sync per registered batch, so the read waits for a spill,
        # which downloads the data anyway
        self._meta = (list(batch.names),
                      [(c.dtype, c.vbits, c.nonnull) for c in batch.columns],
                      batch.num_rows)
        self.lock = threading.Lock()
        self.closed = False

    @property
    def meta(self):
        names, cols, nr = self._meta
        if not isinstance(nr, (int, np.integer)):
            nr = int(nr)
            self._meta = (names, cols, nr)
        return (names, cols, nr)


class BufferCatalog:
    """The process's catalog of registered spillable batches."""

    def __init__(self, device_budget: int = 4 << 30,
                 host_budget: int = 8 << 30,
                 spill_dir: Optional[str] = None,
                 host_arena: Optional[HostArena] = None,
                 device=None):
        self.device_budget = device_budget
        self.host_budget = host_budget
        self._spill_dir = spill_dir
        self._host_arena = host_arena
        self.device = torch.device(device) if device is not None else None
        self._buffers: Dict[int, _Buffer] = {}
        self._ids = itertools.count()
        # RLock: SpillableBatch.__del__ may fire during a GC triggered
        # inside a catalog method that already holds the lock
        self._lock = threading.RLock()
        self.device_bytes = 0
        self.host_bytes = 0
        self.spilled_device_bytes = 0  # memoryBytesSpilled analog
        self.spilled_disk_bytes = 0
        self._hwm_trackers: List["HighWaterTracker"] = []

    @property
    def host_arena(self) -> HostArena:
        """The host tier's arena, made at the first spill: pinned when
        the catalog's device is a CUDA card."""
        with self._lock:
            if self._host_arena is None:
                self._host_arena = HostArena(
                    min(self.host_budget, 1 << 30),
                    pin_memory=self.device is not None and
                    self.device.type == "cuda")
            return self._host_arena

    @property
    def arena_peak(self) -> int:
        """The host arena's high-water mark in bytes: 0 before the first
        spill made the arena (reading it makes none)."""
        arena = self._host_arena
        return arena.peak if arena is not None else 0

    @property
    def spill_dir(self) -> str:
        with self._lock:
            if not self._spill_dir:
                self._spill_dir = tempfile.mkdtemp(prefix="rapids_tpu_spill_")
            os.makedirs(self._spill_dir, exist_ok=True)
            return self._spill_dir

    # -- registration ------------------------------------------------------
    def register(self, batch: DeviceBatch,
                 priority: int = ACTIVE_BATCHING_PRIORITY
                 ) -> "SpillableBatch":
        with self._lock:
            bid = next(self._ids)
            buf = _Buffer(bid, batch, priority)
            self._buffers[bid] = buf
            self.device_bytes += buf.size
            self._note_device_bytes_locked()
        obsreg.get_registry().gauge_max("spill.deviceBytesHwm",
                                        self.device_bytes)
        self._maybe_spill()
        return SpillableBatch(self, bid)

    # -- per-window device-bytes high water --------------------------------
    def _note_device_bytes_locked(self) -> None:
        for t in self._hwm_trackers:
            t._note(self.device_bytes)

    def track_high_water(self) -> "HighWaterTracker":
        """Open a device-bytes high-water window (one per running query;
        under concurrency it also sees other queries' bytes)."""
        with self._lock:
            t = HighWaterTracker(self, self.device_bytes)
            self._hwm_trackers.append(t)
            return t

    def _end_high_water(self, t: "HighWaterTracker") -> None:
        with self._lock:
            if t in self._hwm_trackers:
                self._hwm_trackers.remove(t)

    # -- spill logic -------------------------------------------------------
    def _spill_candidates(self) -> List[_Buffer]:
        with self._lock:
            cands = [b for b in self._buffers.values()
                     if b.tier == StorageTier.DEVICE and not b.closed]
        # lowest priority spills first
        return sorted(cands, key=lambda b: b.priority)

    def _maybe_spill(self) -> None:
        if self.device_bytes <= self.device_budget:
            return
        self.spill_to_fit(self.device_bytes - self.device_budget)

    def spill_to_fit(self, bytes_needed: int) -> int:
        """Synchronously spill device buffers until ``bytes_needed`` are
        freed; returns the bytes freed."""
        freed = 0
        for buf in self._spill_candidates():
            if freed >= bytes_needed:
                break
            freed += self._spill_one(buf)
        return freed

    def _spill_one(self, buf: _Buffer) -> int:
        with buf.lock:
            if buf.tier != StorageTier.DEVICE or buf.closed:
                return 0
            buf.meta  # the row count, read while the data downloads
            payload = _device_to_host(buf.device_batch, self.host_arena)
            buf.host = payload
            buf.device_batch = None
            buf.tier = StorageTier.HOST
            size = buf.size
        with self._lock:
            self.device_bytes -= size
            self.host_bytes += payload.nbytes()
            self.spilled_device_bytes += size
        reg = obsreg.get_registry()
        reg.inc("spill.events")
        reg.inc("spill.deviceToHostBytes", size)
        reg.gauge_max("spill.hostBytesHwm", self.host_bytes)
        obsrec.record_event("spill.deviceToHost", buffer=buf.id,
                            bytes=size, host_bytes=self.host_bytes)
        self._maybe_spill_host()
        return size

    def _maybe_spill_host(self) -> None:
        while self.host_bytes > self.host_budget:
            with self._lock:
                cands = [b for b in self._buffers.values()
                         if b.tier == StorageTier.HOST and not b.closed]
            if not cands:
                return
            victim = min(cands, key=lambda b: b.priority)
            self._spill_to_disk(victim)

    def _spill_to_disk(self, buf: _Buffer) -> None:
        with buf.lock:
            if buf.tier != StorageTier.HOST or buf.closed:
                return
            path = os.path.join(self.spill_dir, f"buf_{buf.id}.npz")
            arrays = {}
            for i, col in enumerate(buf.host.arrays):
                for part, t in zip(_PARTS, col):
                    if t is not None:
                        arrays[f"{part}{i}"] = t.numpy()
            np.savez(path, **arrays)
            nbytes = buf.host.nbytes()
            buf.host.close()
            buf.host = None
            buf.disk_path = path
            buf.tier = StorageTier.DISK
        with self._lock:
            self.host_bytes -= nbytes
            self.spilled_disk_bytes += nbytes
        reg = obsreg.get_registry()
        reg.inc("spill.events")
        reg.inc("spill.hostToDiskBytes", nbytes)
        obsrec.record_event("spill.hostToDisk", buffer=buf.id,
                            bytes=nbytes)

    # -- access ------------------------------------------------------------
    def acquire(self, buffer_id: int) -> DeviceBatch:
        """Materialize the batch on its device (unspilling as needed)."""
        buf = self._buffers[buffer_id]
        with buf.lock:
            assert not buf.closed, "buffer already closed"
            if buf.tier == StorageTier.DEVICE:
                return buf.device_batch
            if buf.tier == StorageTier.DISK:
                self._disk_to_host_locked(buf)
            obsreg.get_registry().inc("spill.unspills")
            batch = _host_to_device(buf.host, buf.meta, buf.device)
            # promote back to the device tier
            nbytes = buf.host.nbytes()
            buf.host.close()
            buf.host = None
            buf.device_batch = batch
            buf.tier = StorageTier.DEVICE
        with self._lock:
            self.host_bytes -= nbytes
            self.device_bytes += buf.size
            self._note_device_bytes_locked()
        self._maybe_spill()
        return batch

    def _disk_to_host_locked(self, buf: _Buffer) -> None:
        names, cols, _nr = buf.meta
        with np.load(buf.disk_path) as loaded:
            arrays = [tuple(torch.from_numpy(loaded[f"{part}{i}"])
                            if f"{part}{i}" in loaded else None
                            for part in _PARTS)
                      for i in range(len(cols))]
        buf.host = _HostPayload(arrays)
        os.unlink(buf.disk_path)
        buf.disk_path = None
        buf.tier = StorageTier.HOST
        with self._lock:
            self.host_bytes += buf.host.nbytes()

    def tier_of(self, buffer_id: int) -> StorageTier:
        return self._buffers[buffer_id].tier

    def spill_buffer(self, buffer_id: int) -> int:
        """Targeted spill of ONE registered buffer device -> host (grace
        join partitions demote themselves while parked).  Returns the
        device bytes freed (0 when already off the device or closed)."""
        buf = self._buffers.get(buffer_id)
        if buf is None:
            return 0
        return self._spill_one(buf)

    def release(self, buffer_id: int) -> None:
        buf = self._buffers.pop(buffer_id, None)
        if buf is None:
            return
        with buf.lock:
            buf.closed = True
            if buf.tier == StorageTier.DEVICE:
                with self._lock:
                    self.device_bytes -= buf.size
            elif buf.tier == StorageTier.HOST:
                with self._lock:
                    self.host_bytes -= buf.host.nbytes()
                buf.host.close()
            elif buf.disk_path and os.path.exists(buf.disk_path):
                os.unlink(buf.disk_path)
            buf.device_batch = None

    def num_buffers(self) -> int:
        with self._lock:
            return len(self._buffers)


class HighWaterTracker:
    """One device-bytes high-water window over the catalog (see
    :meth:`BufferCatalog.track_high_water`)."""

    __slots__ = ("_catalog", "_start", "_peak", "_closed")

    def __init__(self, catalog: "BufferCatalog", start_bytes: int):
        self._catalog = catalog
        self._start = start_bytes
        self._peak = start_bytes
        self._closed = False

    def _note(self, device_bytes: int) -> None:
        if device_bytes > self._peak:
            self._peak = device_bytes

    def peak(self) -> int:
        return self._peak

    def delta(self) -> int:
        """Peak growth over the window (peak - start)."""
        return self._peak - self._start

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._catalog._end_high_water(self)


class SpillableBatch:
    """Operator-held handle to a batch that remains spillable."""

    def __init__(self, catalog: BufferCatalog, buffer_id: int):
        self._catalog = catalog
        self._id = buffer_id
        self._closed = False

    def get(self) -> DeviceBatch:
        return self._catalog.acquire(self._id)

    @property
    def tier(self) -> StorageTier:
        return self._catalog.tier_of(self._id)

    def spill(self) -> int:
        """Demote this batch off the device tier now."""
        if self._closed:
            return 0
        return self._catalog.spill_buffer(self._id)

    def close(self) -> None:
        if not self._closed:
            self._catalog.release(self._id)
            self._closed = True

    def __del__(self):
        # an abandoned handle must not pin its catalog entry forever
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class PlainBatchHandle:
    """SpillableBatch-shaped holder (get/close) used by operators that
    buffer batches when the spill catalog is disabled."""

    def __init__(self, batch: DeviceBatch):
        self._batch = batch

    def get(self) -> DeviceBatch:
        return self._batch

    @property
    def tier(self) -> StorageTier:
        return StorageTier.DEVICE

    def spill(self) -> int:
        return 0  # nowhere to go with the catalog disabled

    def close(self) -> None:
        self._batch = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def register_or_hold(batch: DeviceBatch, priority: Optional[int] = None):
    """Register ``batch`` in the global spill catalog when enabled, else
    wrap it in a :class:`PlainBatchHandle`; either way the caller gets a
    get()/close() handle.  ``priority`` overrides the catalog's default
    spill priority."""
    if not is_enabled():
        return PlainBatchHandle(batch)
    if priority is None:
        return get_catalog().register(batch)
    return get_catalog().register(batch, priority=priority)


# ---------------------------------------------------------------------------
# device <-> host payload conversion
# ---------------------------------------------------------------------------

def _device_to_host(batch: DeviceBatch, arena: HostArena) -> _HostPayload:
    """Copy every buffer of ``batch`` to the host, into the arena where a
    block fits; the copies are queued on the current stream and waited
    for once, before the device tensors are dropped."""
    arrays = []
    allocations = []
    for c in batch.columns:
        col = []
        for t in (c.data, c.validity, c.lengths, c.elem_validity):
            if t is None:
                col.append(None)
                continue
            nbytes = t.numel() * t.element_size()
            alloc = arena.alloc(nbytes)
            if alloc is not None:
                host = alloc.as_tensor()[:nbytes].view(t.dtype).view(t.shape)
                allocations.append(alloc)
            else:
                host = torch.empty(t.shape, dtype=t.dtype)
            host.copy_(t, non_blocking=t.device.type == "cuda")
            col.append(host)
        arrays.append(tuple(col))
    if batch.device.type == "cuda":
        torch.cuda.current_stream(batch.device).synchronize()
    return _HostPayload(arrays, allocations)


def _host_to_device(payload: _HostPayload, meta, device) -> DeviceBatch:
    """Upload a host payload on ``device``; returns once the copies are
    done, so the caller may free the host buffers."""
    names, cols_meta, num_rows = meta
    cuda = device.type == "cuda"
    cols = []
    for parts, (dty, vbits, nonnull) in zip(payload.arrays, cols_meta):
        # copy=True: on the CPU ``to`` would alias the arena block the
        # caller frees next
        d, v, ln, ev = (None if t is None else
                        t.to(device, non_blocking=cuda, copy=True)
                        for t in parts)
        cols.append(DeviceColumn(dty, d, v, ln, ev, vbits, nonnull))
    if cuda:
        torch.cuda.current_stream(device).synchronize()
    return DeviceBatch(names, cols, num_rows, device)


# ---------------------------------------------------------------------------
# process-wide catalog
# ---------------------------------------------------------------------------

_GLOBAL: Optional[BufferCatalog] = None
_GLOBAL_ENABLED = True
_GLOBAL_LOCK = threading.Lock()


def init_catalog(device_budget: int, host_budget: int,
                 spill_dir: Optional[str] = None,
                 device=None) -> BufferCatalog:
    """A fresh process-wide catalog (the session does this at start);
    ``device`` is the session's, which decides whether the host arena is
    pinned."""
    global _GLOBAL, _GLOBAL_ENABLED
    with _GLOBAL_LOCK:
        _GLOBAL = BufferCatalog(device_budget, host_budget,
                                spill_dir or None, device=device)
        _GLOBAL_ENABLED = True
        return _GLOBAL


def disable_catalog() -> None:
    """spark.rapids.tpu.memory.spill.enabled=false: operators hold batches
    directly, nothing is registered or spilled."""
    global _GLOBAL_ENABLED
    with _GLOBAL_LOCK:
        _GLOBAL_ENABLED = False


def is_enabled() -> bool:
    with _GLOBAL_LOCK:
        return _GLOBAL_ENABLED


def _is_oom(e: BaseException) -> bool:
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e)
    return "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()


def hbm_oom_recover(e: BaseException) -> bool:
    """Alloc-failure-driven spill (DeviceMemoryEventHandler.onAllocFailure
    analog): on a device out-of-memory error (``torch.cuda.
    OutOfMemoryError``, or the reference's message test) spill EVERY
    device-tier registered buffer to the host and tell the caller to
    retry.  Returns True when the error is an out-of-memory and bytes
    were actually freed."""
    if not _is_oom(e):
        return False
    freed = get_catalog().spill_to_fit(1 << 62)   # the whole device tier
    if freed > 0:
        # the flight recorder bundles a SUCCESSFUL query whose window
        # moved this counter
        obsreg.get_registry().inc("mem.oomRetries")
        obsrec.record_event("mem.oomRetry", freed_bytes=freed,
                            error=str(e)[:200])
    return freed > 0


# ---------------------------------------------------------------------------
# Auxiliary pressure spillers (in-flight join state, etc.)
# ---------------------------------------------------------------------------

_PRESSURE_SPILLERS: List = []   # weakref.ref to objects w/ pressure_spill
_PRESSURE_LOCK = threading.Lock()


def register_pressure_spiller(obj) -> None:
    """Register an object exposing ``pressure_spill(bytes_needed) ->
    bytes_freed`` with the memory-pressure hook.  Held by weakref: the
    spiller drops out when its owner releases it."""
    import weakref
    with _PRESSURE_LOCK:
        _PRESSURE_SPILLERS[:] = [r for r in _PRESSURE_SPILLERS
                                 if r() is not None]
        _PRESSURE_SPILLERS.append(weakref.ref(obj))


def _aux_pressure_spill(bytes_needed: int) -> int:
    freed = 0
    with _PRESSURE_LOCK:
        refs = list(_PRESSURE_SPILLERS)
    for r in refs:
        if freed >= bytes_needed:
            break
        obj = r()
        if obj is None:
            continue
        try:
            freed += int(obj.pressure_spill(bytes_needed - freed))
        except Exception:
            # a broken spiller must not fail the caller, but it is
            # counted: 0 aux bytes with errors ticking is "spiller
            # broken", not "nothing pending"
            obsreg.get_registry().inc("spill.pressureAuxErrors")
    return freed


def handle_memory_pressure(bytes_needed: int) -> int:
    """Memory-pressure hook: spill the lowest-priority registered device
    batches, then, when the device tier alone cannot cover
    ``bytes_needed``, the auxiliary spillers.  Returns the bytes freed;
    a no-op while spill is disabled."""
    if not is_enabled() or bytes_needed <= 0:
        return 0
    device_freed = get_catalog().spill_to_fit(int(bytes_needed))
    aux_freed = 0
    if device_freed < bytes_needed:
        aux_freed = _aux_pressure_spill(int(bytes_needed) - device_freed)
    reg = obsreg.get_registry()
    if device_freed:
        reg.inc("spill.pressureDeviceBytes", device_freed)
    if aux_freed:
        reg.inc("spill.pressureAuxBytes", aux_freed)
    if device_freed or aux_freed:
        reg.inc("spill.pressureSpills")
    return device_freed + aux_freed


def get_catalog() -> BufferCatalog:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = BufferCatalog()
        return _GLOBAL
