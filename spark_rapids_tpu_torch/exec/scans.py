"""Prefix scans in plain torch (``cumsum``, the segmented ``seg_scan``)
and the pipelined scan prefetcher (:class:`ScanPrefetcher`).

Ported from ``spark_rapids_tpu/exec/scans.py``.  The prefetcher
(:74-252, with its span and counter names :class:`PrefetchKeys` :46) is
copied whole: the fused Parquet reader prepares and uploads batch k+1 on
it while batch k decodes (io/device_scan.py).  The scans are the
plain versions the segmented-reduction kernel is held against
(kernels/segreduce.py), so they reproduce the reference's reduction tree
exactly: ``_associative_scan`` is the recursion of
``jax.lax.associative_scan``, and values of 8 bytes or more at more than
2^15 elements scan in 2^15-element blocks with a (flag, value) carry
folded from block to block, as the reference's ``lax.scan`` does.  On
the CPU this gives the reference's float sums bit for bit.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.obs import trace as obstrace
from spark_rapids_tpu_torch.sched import cancel as _cancel

_BLOCK = 1 << 15          # per-step scan length, as in the reference


@dataclass(frozen=True)
class PrefetchKeys:
    """Span/registry names one ScanPrefetcher instance emits under (the
    reference's shuffle pipeline reuses the prefetcher under its own set;
    the port has no shuffle yet)."""

    span_prefetch: str = "scan.prefetch"
    span_stall: str = "scan.prefetchStall"
    prefetch_ns: str = "scan.prefetchNs"
    stalls: str = "scan.prefetchStalls"
    stall_ns: str = "scan.prefetchStallNs"
    overlap_ns: str = "scan.prefetchOverlapNs"
    cat: str = "scan"


class ScanPrefetcher:
    """Bounded look-ahead runner for scan host prep.

    Given one thunk per scan batch (each performing host-side prep +
    device upload — e.g. ``io/parquet_fused.prepare_fused`` — and NO
    device->host read, per PERF.md's no-mid-stream-read discipline),
    runs up to ``depth`` of them ahead of the consumer on a small
    thread pool, so batch k+1's footer/page walks and packed-page
    uploads overlap batch k's dispatch-only device decode.

    ``get(i)`` returns thunk i's result exactly once, blocking if it
    isn't ready (counted into ``metrics.extra['scan.prefetchStalls']``
    — a stall means the consumer outran the prepared window).
    Consumers may arrive out of order (partition iterators drain on a
    task pool); an index past the submitted window forces submission
    so no ``get`` can deadlock.  A thunk's exception is re-raised at
    its ``get``.  In-flight prepared-but-unconsumed batches — and so
    the held host artifacts and uploaded page buffers — are bounded by
    ``max(depth, concurrent consumers)``: the forced submissions mean
    a task pool wider than ``depth`` raises the bound to its own
    width (the engine's pool is ``concurrentTpuTasks``, default 2).

    Abandonment safety: if the consumer never drains every index (an
    error mid-query, a short-circuiting collect), ``close()`` — also
    wired as a GC finalizer — cancels undispatched thunks and runs
    ``cleanup`` on every prepared-but-unconsumed result (e.g. closing
    file handles), then shuts the pool down."""

    def __init__(self, thunks: Sequence[Callable[[], object]],
                 depth: int, metrics=None,
                 cleanup: Optional[Callable[[object], None]] = None,
                 labels: Optional[Sequence[str]] = None,
                 keys: Optional[PrefetchKeys] = None,
                 thread_name: str = "scan-prefetch"):
        import concurrent.futures as cf
        import weakref
        self._thunks: List[Callable[[], object]] = list(thunks)
        # per-thunk source labels (file/row-group ids) so stall spans
        # name WHAT stalled — an anonymous stall count makes prefetch
        # tuning guesswork
        self._labels: List[str] = list(labels or ())
        self._depth = max(1, int(depth))
        self._metrics = metrics
        self._keys = keys or PrefetchKeys()
        self._lock = threading.Lock()
        self._futures = {}
        # per-thunk prefetch wall (ns), consumed by get()'s overlap
        # accounting: background work that completed before (or ran
        # beyond) the consumer's arrival is genuinely overlapped time
        self._durs = {}
        self._next = 0
        self._consumed = 0
        self._parts_done = 0
        self._pool: Optional[object] = None
        # cancellation: capture the submitting query's token here (the
        # prefetch pool's threads don't inherit thread-locals) and
        # install it around every thunk — a cancelled query stops
        # prepping/uploading look-ahead batches at the next checkpoint
        self._token = _cancel.current()
        if self._thunks:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=self._depth,
                thread_name_prefix=thread_name)
            # args must not reference self (that would pin it forever)
            self._finalizer = weakref.finalize(
                self, ScanPrefetcher._close_impl, self._lock,
                self._futures, self._pool, cleanup)
            with self._lock:
                self._fill_locked()

    def _span_args(self, i: int) -> dict:
        args = {"batch": i}
        if i < len(self._labels):
            args["src"] = self._labels[i]
        return args

    def _run_thunk(self, i: int):
        """Thunk wrapper: the thread inherits the query's CancelToken,
        and the prefetch work itself shows up in the trace (prep+upload
        of batch i on the prefetch thread) and in the registry's
        prefetch histogram."""
        t0 = time.perf_counter_ns()
        try:
            with _cancel.install(self._token):
                _cancel.check_current()
                return self._thunks[i]()
        finally:
            dur = time.perf_counter_ns() - t0
            with self._lock:
                self._durs[i] = dur
            obstrace.record(self._keys.span_prefetch, t0, dur,
                            cat=self._keys.cat,
                            args=self._span_args(i))
            obsreg.get_registry().observe(self._keys.prefetch_ns, dur)

    def _fill_locked(self) -> None:
        while (self._next < len(self._thunks) and
               len(self._futures) < self._depth):
            i = self._next
            self._next += 1
            self._futures[i] = self._pool.submit(self._run_thunk, i)

    def part_done(self) -> None:
        """Consumer-side completion mark, called once per index from
        the partition iterator's ``finally`` (success OR failure).
        Once every consumer has finished, prepared-but-unconsumed
        results are released deterministically — without waiting for
        the GC finalizer — covering queries that die mid-drain."""
        with self._lock:
            self._parts_done += 1
            done = self._parts_done >= len(self._thunks)
        if done:
            self.close()

    def get(self, i: int):
        _cancel.check_current()   # don't block on a cancelled query
        with self._lock:
            # out-of-order consumer past the window: submit through i
            while self._next <= i:
                j = self._next
                self._next += 1
                self._futures[j] = self._pool.submit(self._run_thunk, j)
            fut = self._futures.pop(i)
        stalled = not fut.done()
        t0 = 0
        if stalled:
            # the consumer outran the prepared window: a stall, timed
            # so the profile shows where the pipeline starved (same
            # name in Metrics.extra and the registry: PrefetchKeys
            # owns it once)
            if self._metrics is not None:
                self._metrics.add_extra(self._keys.stalls, 1)
            obsreg.get_registry().inc(self._keys.stalls)
            t0 = time.perf_counter_ns()
        try:
            return fut.result()
        finally:
            stall_ns = 0
            if stalled:
                stall_ns = time.perf_counter_ns() - t0
                # the stall span names its source (path#rg), so a trace
                # shows WHICH batch the consumer starved on
                obstrace.record(self._keys.span_stall, t0, stall_ns,
                                cat=self._keys.cat,
                                args=self._span_args(i))
                obsreg.get_registry().inc(self._keys.stall_ns, stall_ns)
            with self._lock:
                self._consumed += 1
                dur = self._durs.pop(i, 0)
                self._fill_locked()
                if self._consumed >= len(self._thunks):
                    self._pool.shutdown(wait=False)
            # overlapped time = background prefetch wall the consumer
            # did NOT wait out: a thunk that was ready at get() overlaps
            # in full; a stalled get overlaps only the head start.  This
            # is the pipeline's headline (overlapNs == 0 means the
            # look-ahead bought nothing).
            overlap = dur - stall_ns
            if overlap > 0:
                obsreg.get_registry().inc(self._keys.overlap_ns, overlap)

    @staticmethod
    def _close_impl(lock, futures, pool, cleanup) -> None:
        with lock:
            pending = list(futures.values())
            futures.clear()
        for fut in pending:
            if not fut.cancel() and cleanup is not None:
                try:
                    cleanup(fut.result())
                except Exception:
                    pass   # the thunk itself failed: nothing to clean
        pool.shutdown(wait=False)

    def close(self) -> None:
        """Release prepared-but-unconsumed results (idempotent)."""
        if self._pool is not None:
            self._finalizer()



def _sl(x: torch.Tensor, start, stop, step, dim: int) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """out[0::2] = a, out[1::2] = b along ``dim`` (len(a) - len(b) in
    {0, 1})."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def _associative_scan(combine: Callable, elems: List[torch.Tensor],
                      dim: int = 0) -> List[torch.Tensor]:
    """Inclusive scan with the reduction tree of jax.lax.associative_scan:
    combine adjacent pairs, recurse on the half, then fix up the even
    positions."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = combine([_sl(e, 0, -1, 2, dim) for e in elems],
                      [_sl(e, 1, None, 2, dim) for e in elems])
    odd = _associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([_sl(e, 0, -1, 1, dim) for e in odd],
                       [_sl(e, 2, None, 2, dim) for e in elems])
    else:
        even = combine(odd, [_sl(e, 2, None, 2, dim) for e in elems])
    even = [torch.cat([_sl(e, 0, 1, 1, dim), r], dim=dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _to_blocks(x: torch.Tensor, fill) -> torch.Tensor:
    n = x.shape[0]
    g = -(-n // _BLOCK)
    pad = g * _BLOCK - n
    if pad:
        x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(g, _BLOCK)


def _fold_carries(op, tail_f: torch.Tensor, tail_v: torch.Tensor,
                  identity):
    """Carry into each block, folded block by block from (False,
    identity) exactly as the reference's lax.scan threads it.  The fold
    runs over one value per block, on the values' device, with no host
    read."""
    cf = torch.empty_like(tail_f)
    cv = torch.empty_like(tail_v)
    c_f = torch.zeros((), dtype=torch.bool, device=tail_f.device)
    c_v = torch.full((), identity, dtype=tail_v.dtype,
                     device=tail_v.device)
    for i in range(tail_v.shape[0]):
        cf[i], cv[i] = c_f, c_v
        c_v = torch.where(tail_f[i], tail_v[i], op(c_v, tail_v[i]))
        c_f = c_f | tail_f[i]
    return cf, cv


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive 1-D cumsum with the reference's summation order."""
    if x.element_size() < 8:
        return torch.cumsum(x, 0, dtype=x.dtype)
    n = x.shape[0]
    if n <= _BLOCK:
        return _associative_scan(lambda a, b: [a[0] + b[0]], [x])[0]
    flags = torch.zeros(n, dtype=torch.bool, device=x.device)
    return seg_scan(torch.add, flags, x, 0)


def seg_scan(op, flags: torch.Tensor, vals: torch.Tensor, identity
             ) -> torch.Tensor:
    """Inclusive SEGMENTED scan: within each run started where ``flags``
    is True, accumulate ``vals`` with the associative ``op`` (whose
    identity element is ``identity`` — callers pre-fill excluded
    positions with it, and block padding uses it).  The value at a
    segment's last position is the segment reduction."""

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return [fa | fb, torch.where(fb, vb, op(va, vb))]

    n = vals.shape[0]
    if vals.element_size() < 8 or n <= _BLOCK:
        return _associative_scan(combine, [flags, vals])[1]
    fb_ = _to_blocks(flags, True)          # padding starts a new run
    vb_ = _to_blocks(vals, identity)
    pf, pv = _associative_scan(combine, [fb_, vb_], dim=1)
    cf, cv = _fold_carries(op, pf[:, -1], pv[:, -1], identity)
    _of, ov = combine([cf[:, None].expand_as(pf), cv[:, None].expand_as(pv)],
                      [pf, pv])
    return ov.reshape(-1)[:n]
