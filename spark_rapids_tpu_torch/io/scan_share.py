"""Shared-scan multicast: one device decode feeds every concurrent
subscriber of the same (file, row-group, column-set, stamp) work.

Ported from ``spark_rapids_tpu/io/scan_share.py``, imports retargeted.

The scan-plan cache (io/scan_cache.py) already dedups the HOST half of
a warm scan — footer parses and page-header walks.  This module is the
missing device half: when N concurrent queries decode the SAME fused
scan group, exactly one of them (the *leader*) runs host prep + the
device decode, and the decoded ``DeviceBatch`` is multicast to every
*subscriber* that claimed the key while the flight was open.  A
subscriber pays zero page walks and zero decode dispatches — the
walk-count probe (io/parquet_meta.walk_count) and ``kernel.dispatches``
both prove it.

Identity is content-addressed, not connection-addressed::

    (sorted file_key stamps, (path, row-group) tuple, output schema
     signature, pushed-filter signature, partition values, backend)

``file_key`` is the scan-plan cache's (path, mtime_ns, size) stamp, so
a rewritten file can never serve another query's stale bytes — its key
simply never matches again and the old entry ages out of the window.

Lifecycle of one key::

    claim -> ("lead", e)   first claimant; runs prepare()+finish()
          -> ("join", e)   anyone else while the flight is open OR the
                           batch is still inside the retention window
    lead:  publish(e, batch)  settles the flight, enters the window
           fail(e, err)       (error/cancel/abandon) wakes subscribers
    join:  wait(e)            batch, or None when the leader failed --
                              the subscriber then decodes locally under
                              a FRESH claim (so a third query can still
                              share ITS decode)
    all:   release(e)         refcounted; the batch's device memory frees when the
                              last reference drops AND the retention
                              window has let go

The retention window is a byte-budget LRU (``scan.shared.windowBytes``)
over published batches, so a query arriving a moment after the flight
settled still shares the decode.  It registers as an auxiliary
pressure spiller (mem/spill.register_pressure_spiller): admission
pressure drops retained batches oldest-first before any query is made
to wait.  Refcounted release means a slow subscriber can never pin the
window — eviction only drops the WINDOW's pin; in-flight subscribers
keep their own reference until their stream drains.

Subscribers holding references to one batch is why input-buffer
donation must never see a shared scan batch.  The reference bars it in
``exec/fused_stage.donate_ok`` and withdraws a solo batch from sharing
with :meth:`ScanShare.try_steal`; the port never donates an input
buffer (exec/fused_stage.py), so nothing more is needed there and
``try_steal`` has no caller yet.  One-knob revert:
``scan.shared.enabled`` off restores the private decode path.

Counters (registry -> /metrics): ``scan.shared.subscribers`` (claims
that joined another query's flight or window entry),
``scan.shared.dedupedDecodes`` (joined claims actually served from the
shared batch), ``scan.shared.multicastBatches`` (published batches that
served more than one consumer).  Final release of a multicast batch
records a ``scan.multicastRelease`` event with its fan-out and size.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple

from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.sched import cancel as _cancel


class _Entry:
    """One keyed decode flight / retained batch."""

    __slots__ = ("key", "event", "batch", "error", "nbytes", "refs",
                 "joined", "served", "settled", "in_window",
                 "multicast_counted", "released")

    def __init__(self, key: Tuple):
        self.key = key
        self.event = threading.Event()
        self.batch = None
        self.error: Optional[BaseException] = None
        self.nbytes = 0
        self.refs = 1            # the leader's claim
        self.joined = 0          # subscribers beyond the leader
        self.served = 0          # joined claims actually delivered
        self.settled = False
        self.in_window = False
        self.multicast_counted = False
        self.released = False


class ScanShare:
    """Process-wide keyed single-flight + retention window (one
    instance, via :func:`get_share`)."""

    def __init__(self, window_bytes: int):
        self._lock = threading.Lock()
        self._window_bytes = int(window_bytes)
        self._inflight: dict = {}
        # key -> _Entry, LRU order (oldest first)
        self._window: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self._window_total = 0

    def set_window_bytes(self, window_bytes: int) -> None:
        with self._lock:
            self._window_bytes = int(window_bytes)
            self._evict_locked()

    # -- claim / settle ----------------------------------------------------
    def claim(self, key: Tuple):
        """("lead", entry) for the first claimant of an open key,
        ("join", entry) for everyone arriving while the flight is open
        or the batch is retained.  Every claim (either role) owns one
        reference and MUST release it."""
        with self._lock:
            e = self._inflight.get(key)
            if e is None:
                e = self._window.get(key)
                if e is not None:
                    self._window.move_to_end(key)
            if e is None:
                e = _Entry(key)
                self._inflight[key] = e
                return "lead", e
            e.refs += 1
            e.joined += 1
        obsreg.get_registry().inc("scan.shared.subscribers")
        return "join", e

    def publish(self, e: _Entry, batch) -> None:
        """Leader settle: the decoded batch enters the retention window
        and every waiting subscriber wakes."""
        try:
            # DeviceBatch exposes nbytes(); pa.Table exposes the
            # property — the host-scan sharing path publishes Tables
            nb = batch.nbytes
            nb = int(nb() if callable(nb) else nb)
        except Exception:
            nb = 1 << 20
        with self._lock:
            e.batch = batch
            e.nbytes = nb
            e.settled = True
            if self._inflight.get(e.key) is e:
                del self._inflight[e.key]
            self._window[e.key] = e
            e.in_window = True
            self._window_total += nb
            self._evict_locked()
        e.event.set()

    def fail(self, e: _Entry, error: BaseException) -> None:
        """Leader settle on error/cancel/abandonment: subscribers wake
        and fall back to a local decode (no error propagation — the
        leader's cancellation is not the follower's failure)."""
        with self._lock:
            if e.settled:
                return
            e.error = error
            e.settled = True
            if self._inflight.get(e.key) is e:
                del self._inflight[e.key]
        e.event.set()

    # -- subscriber side ---------------------------------------------------
    def wait(self, e: _Entry):
        """Block (cancellably) until the flight settles.  Returns the
        shared batch, or None when the leader failed — the caller then
        decodes locally.  Never call while holding the device semaphore:
        the leader's decode needs a slot."""
        while not e.event.wait(0.05):
            _cancel.check_current()
        if e.batch is None:
            return None
        reg = obsreg.get_registry()
        reg.inc("scan.shared.dedupedDecodes")
        with self._lock:
            e.served += 1
            first_fanout = not e.multicast_counted
            e.multicast_counted = True
        if first_fanout:
            reg.inc("scan.shared.multicastBatches")
        return e.batch

    def release(self, e: _Entry) -> None:
        """Drop one claim's reference; the batch's memory frees once
        the last reference is gone and the window evicted the entry."""
        with self._lock:
            e.refs -= 1
            self._maybe_release_locked(e)

    def try_steal(self, e: _Entry) -> bool:
        """Withdraw a published batch from sharing so its ONLY holder
        may donate its buffers (the reference's refcount-aware donation
        bar, called per batch at dispatch time by its fused stage; the
        port never donates, so nothing calls it yet).  Succeeds only when no other query ever received the
        batch (``joined == 0`` — a subscriber's pipeline may hold the
        object long after its claim released) and no claim is live
        (``refs == 0``): the entry leaves the window and the key
        re-opens, so a later claimant simply leads a fresh decode.
        False means the batch is (or was) multicast and must never be
        donated."""
        with self._lock:
            if e.joined > 0 or e.refs > 0 or e.released \
                    or not e.settled:
                return False
            if e.in_window:
                self._window.pop(e.key, None)
                self._window_total -= e.nbytes
                e.in_window = False
            # mark released WITHOUT dropping e.batch: the caller owns
            # the only reference and is about to consume it
            e.released = True
        obsreg.get_registry().inc("scan.shared.donationSteals")
        return True

    # -- retention window --------------------------------------------------
    def _evict_locked(self) -> None:
        while self._window_total > self._window_bytes and self._window:
            _key, e = self._window.popitem(last=False)
            self._window_total -= e.nbytes
            e.in_window = False
            self._maybe_release_locked(e)

    def _maybe_release_locked(self, e: _Entry) -> None:
        if e.refs > 0 or e.in_window or e.released:
            return
        e.released = True
        if e.batch is not None:
            nb, fanout = e.nbytes, e.served
            e.batch = None   # frees the decoded columns' device memory now
            obsrec.record_event("scan.multicastRelease",
                                subscribers=fanout, nbytes=nb)

    def pressure_spill(self, bytes_needed: int) -> int:
        """Admission-pressure hook (mem/spill): drop retained batches
        oldest-first.  In-flight subscribers keep their own references;
        only the window's pin releases here."""
        freed = 0
        with self._lock:
            for key in list(self._window.keys()):
                if freed >= bytes_needed:
                    break
                e = self._window[key]
                if e.refs > 0:
                    # live subscribers hold the batch: dropping the
                    # window's pin would free nothing, only lose the
                    # share point
                    continue
                del self._window[key]
                self._window_total -= e.nbytes
                e.in_window = False
                freed += e.nbytes
                self._maybe_release_locked(e)
        return freed

    def stats(self) -> dict:
        with self._lock:
            return {"inflight": len(self._inflight),
                    "window_entries": len(self._window),
                    "window_bytes": self._window_total}

    def clear(self) -> None:
        """Test hook: drop every retained batch (open flights keep
        settling through their leaders)."""
        with self._lock:
            while self._window:
                _key, e = self._window.popitem(last=False)
                self._window_total -= e.nbytes
                e.in_window = False
                self._maybe_release_locked(e)


_SHARE_LOCK = threading.Lock()
_SHARE: Optional[ScanShare] = None


def get_share(window_bytes: int) -> ScanShare:
    """The process-wide ScanShare, created on first use and registered
    as a pressure spiller; the byte budget follows the latest caller's
    conf (the scan_cache.configure last-caller-wins idiom)."""
    global _SHARE
    with _SHARE_LOCK:
        if _SHARE is None:
            _SHARE = ScanShare(window_bytes)
            from spark_rapids_tpu_torch.mem import spill
            spill.register_pressure_spiller(_SHARE)
        else:
            _SHARE.set_window_bytes(window_bytes)
        return _SHARE


def peek_share() -> Optional[ScanShare]:
    """The singleton if one exists (tests / inspection), else None."""
    return _SHARE


def share_key(path_rgs, pv, schema_sig, pushed_sig,
              backend: str, device=None) -> Optional[Tuple]:
    """Content identity of one fused scan group, or None when any
    source can't be stamped (unstampable work is never shared).  The
    port adds the scan's device: a CPU session and a CUDA session in one
    process must not hand each other their batches."""
    from spark_rapids_tpu_torch.io import scan_cache as sc
    stamps = []
    for p in sorted({p for p, _rg in path_rgs}):
        k = sc.file_key(p)
        if k is None:
            return None
        stamps.append(k)
    return (tuple(stamps), tuple(path_rgs), tuple(schema_sig),
            pushed_sig, tuple(sorted(pv.items())), str(backend),
            str(device))
