"""Process-wide scan-plan cache: memoized host-prep artifacts.

Ported from ``spark_rapids_tpu/io/scan_cache.py``: file sources, and the
in-memory blobs of ``df.cache()`` keyed by content (:func:`blob_key`), so a
re-collected cached relation skips its page walks.  The reference's
result-cache stamps are not ported.
The CPU half of the device parquet scan — footer parse, Thrift
page-header walks, RLE run-boundary tables (``ChunkPlan``) — is pure
O(pages+runs) host work that would otherwise be redone on every query:

  * entries key on ``(path, mtime_ns, size)`` — any rewrite of the file
    changes the stamp and invalidates every cached artifact for it;
  * per file the cache holds the parsed footer (``FooterInfo``) and
    every ``ChunkPlan`` walked so far, keyed by
    ``(row_group, leaf_index, out_dtype, allow_mixed)``;
  * unsupported chunks cache NEGATIVELY (the ``UnsupportedChunk`` is
    replayed) so a warm scan doesn't re-walk pages only to fall back
    to host Arrow again;
  * eviction is LRU at file granularity under a byte budget
    (:func:`configure`) — run tables and packed buffers are the
    dominant cost and are accounted per plan.

Hits and misses count into :func:`stats` and, when the caller passes an
exec's ``Metrics``, into its ``scan.planCacheHits``/``Misses``.  All entry
points are thread-safe; plan computation runs OUTSIDE the lock (two
threads may race to walk the same chunk; last insert wins, which is
benign because plans are immutable after construction).
"""

from __future__ import annotations

import hashlib
import io
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import pyarrow.parquet as papq

_LOCK = threading.RLock()
_ENABLED = True
_MAX_BYTES = 256 << 20

# skey -> _FileEntry, LRU order (oldest first)
_FILES: "OrderedDict[Tuple, _FileEntry]" = OrderedDict()
# abspath -> last skey (so a rewritten file's stale entry purges
# immediately instead of lingering until eviction)
_PATH_KEY: Dict[str, Tuple] = {}
_TOTAL_BYTES = 0

_HITS = 0
_MISSES = 0
_EVICTIONS = 0
_INVALIDATIONS = 0


class FooterInfo:
    """Cached parquet footer: standalone metadata + Arrow schema.

    Duck-types the slice of ``pyarrow.parquet.ParquetFile`` the scan
    paths use (``.metadata``, ``.schema_arrow``, ``.read_row_group``,
    ``.close``) WITHOUT holding an open file descriptor — a scan over
    thousands of files must not pin thousands of fds."""

    __slots__ = ("path", "metadata", "schema_arrow", "cache_key",
                 "_leaf_of")

    def __init__(self, path: str, metadata, schema_arrow,
                 cache_key: Optional[Tuple] = None):
        self.path = path
        self.metadata = metadata
        self.schema_arrow = schema_arrow
        # the (path, mtime, size) stamp this footer was parsed under —
        # chunk plans derived THROUGH this footer must key on it (a
        # re-stat at plan time could pick up a newer stamp and cache
        # plans built from stale byte offsets under the new key)
        self.cache_key = cache_key
        self._leaf_of: Optional[dict] = None

    @property
    def num_row_groups(self) -> int:
        return self.metadata.num_row_groups

    def leaf_of(self) -> dict:
        if self._leaf_of is None:
            from spark_rapids_tpu_torch.io.device_parquet import leaf_index_map
            self._leaf_of = leaf_index_map(self)
        return self._leaf_of

    def read_row_group(self, rg: int, columns=None):
        """Host Arrow read for fallback columns (transient open)."""
        pf = papq.ParquetFile(self.path)
        try:
            return pf.read_row_group(rg, columns=columns)
        finally:
            pf.close()

    def close(self) -> None:  # ParquetFile-compatible no-op
        pass

    def nbytes(self) -> int:
        try:
            return int(self.metadata.serialized_size) + 4096
        except Exception:
            return 1 << 16


class _FileEntry:
    __slots__ = ("footer", "plans", "nbytes")

    def __init__(self):
        self.footer: Optional[FooterInfo] = None
        # (rg, leaf_idx, dtype_name, allow_mixed) -> ChunkPlan | Exception
        self.plans: Dict[Tuple, Any] = {}
        self.nbytes = 0


# ---------------------------------------------------------------------------
# Configuration / stats
# ---------------------------------------------------------------------------

def configure(enabled: bool, max_bytes: int) -> None:
    """Turn the cache on or off and set its byte budget (the reference
    session reads both from ``sql.scan.metadataCache.*``)."""
    global _ENABLED, _MAX_BYTES
    with _LOCK:
        _ENABLED = bool(enabled)
        _MAX_BYTES = int(max_bytes)
        if not _ENABLED:
            _clear_locked()
        else:
            _evict_locked()


def enabled() -> bool:
    return _ENABLED


def stats() -> Dict[str, int]:
    with _LOCK:
        return {"hits": _HITS, "misses": _MISSES,
                "evictions": _EVICTIONS,
                "invalidations": _INVALIDATIONS,
                "entries": len(_FILES), "bytes": _TOTAL_BYTES}


def clear() -> None:
    with _LOCK:
        _clear_locked()


def _clear_locked() -> None:
    global _TOTAL_BYTES
    _FILES.clear()
    _PATH_KEY.clear()
    _TOTAL_BYTES = 0


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def file_key(path: str) -> Optional[Tuple]:
    """Cache key of an on-disk file: (abspath, mtime_ns, size) — the
    spark-rapids footer-cache invalidation contract.  None when the
    path can't be stat'ed (the caller skips caching)."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return ("file", os.path.abspath(path), st.st_mtime_ns, st.st_size)


def blob_key(blob) -> Optional[Tuple]:
    """Cache key of an in-memory parquet blob (the df.cache() path): its
    content digest, so a re-materialized relation with identical bytes
    still hits and freed-and-reused ids can never alias."""
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        return None
    return ("blob", hashlib.sha1(blob).hexdigest(), len(blob))


def handle_key(pf, src) -> Optional[Tuple]:
    """Plan-cache key for chunks walked through the open handle ``pf``:
    the stamp captured when the footer was parsed (FooterInfo), NOT a
    fresh stat — so a file rewritten mid-scan can never get plans built
    from the stale footer's offsets cached under the new file's key.
    Handles without a pinned stamp (a plain ParquetFile, an uncached
    FooterInfo) return None: their open-time stamp is unknowable, and
    caching under a fresh stat could poison a newer stamp with plans
    derived from the handle's older footer."""
    return getattr(pf, "cache_key", None)


# ---------------------------------------------------------------------------
# Entry management
# ---------------------------------------------------------------------------

def _purge_stale_locked(skey: Tuple) -> None:
    """Drop a previous-stamp entry for the same path (file rewritten).

    Only a FRESHER stamp may purge/repoint: a scan still pinned to an
    older footer (handle_key) must not evict the rewritten file's new
    entry — old- and new-stamp entries coexist until the old one ages
    out of the LRU."""
    global _TOTAL_BYTES, _INVALIDATIONS
    if skey[0] != "file":
        return
    prev = _PATH_KEY.get(skey[1])
    if prev is None or prev == skey:
        _PATH_KEY[skey[1]] = skey
        return
    if skey[2] < prev[2]:     # incoming mtime_ns older than recorded
        return
    entry = _FILES.pop(prev, None)
    if entry is not None:
        _TOTAL_BYTES -= entry.nbytes
        _INVALIDATIONS += 1
    _PATH_KEY[skey[1]] = skey


def _probe_locked(skey: Tuple) -> Optional["_FileEntry"]:
    """Lookup WITHOUT creating: a miss that then fails to parse/walk
    must leave no empty entry behind (they would accumulate for every
    corrupt/vanished file stamp)."""
    _purge_stale_locked(skey)
    entry = _FILES.get(skey)
    if entry is not None:
        _FILES.move_to_end(skey)
    return entry


def _entry_locked(skey: Tuple) -> "_FileEntry":
    entry = _probe_locked(skey)
    if entry is None:
        entry = _FileEntry()
        _FILES[skey] = entry
    return entry


def _evict_locked() -> None:
    global _TOTAL_BYTES, _EVICTIONS
    while _TOTAL_BYTES > _MAX_BYTES and len(_FILES) > 1:
        old_key, old = _FILES.popitem(last=False)
        _TOTAL_BYTES -= old.nbytes
        _EVICTIONS += 1
        if old_key[0] == "file" and _PATH_KEY.get(old_key[1]) == old_key:
            del _PATH_KEY[old_key[1]]


def _account_locked(entry: "_FileEntry", delta: int) -> None:
    global _TOTAL_BYTES
    entry.nbytes += delta
    _TOTAL_BYTES += delta
    _evict_locked()


def _plan_nbytes(plan) -> int:
    """Byte cost of one cached ChunkPlan: packed streams, value buffers
    and the run tables' arrays."""
    if isinstance(plan, Exception):
        return 256
    n = 512
    for b in (plan.def_packed, plan.val_packed):
        n += len(b or b"")
    for a in (plan.plain_np, plan.dict_np, plan.dict_lens):
        if a is not None:
            n += int(a.nbytes)
    for rt in (plan.def_runs, plan.val_runs):
        if rt is not None:
            n += sum(int(a.nbytes) for a in (rt.counts, rt.is_rle, rt.values,
                                             rt.bit_bases, rt.widths))
    return n


# ---------------------------------------------------------------------------
# Public lookups
# ---------------------------------------------------------------------------

def _count(metrics, key: str) -> None:
    if metrics is not None:
        metrics.add_extra(key, 1)


def get_footer(path: str, metrics=None) -> FooterInfo:
    """Parsed footer for ``path``, cached on (path, mtime, size).

    Falls through to a direct parse (uncached) when the cache is off
    or the file can't be stat'ed."""
    skey = file_key(path) if _ENABLED else None
    if skey is not None:
        with _LOCK:
            entry = _probe_locked(skey)
            if entry is not None and entry.footer is not None:
                _bump_hits(metrics)
                return entry.footer
    md = papq.read_metadata(path)
    footer = FooterInfo(path, md, md.schema.to_arrow_schema(),
                        cache_key=skey)
    if skey is not None:
        _bump_misses(metrics)
        with _LOCK:
            entry = _entry_locked(skey)
            if entry.footer is None:
                entry.footer = footer
                _account_locked(entry, footer.nbytes())
            else:
                footer = entry.footer
    return footer


def get_chunk_plan(skey: Optional[Tuple], src, rg: int, leaf_idx: int,
                   out_dtype, allow_mixed: bool, pf, metrics=None):
    """ChunkPlan for one (source, row_group, leaf column), cached.

    ``src`` is a path or parquet blob; ``pf`` anything exposing
    ``.metadata`` (a ParquetFile or FooterInfo).  Re-raises a cached
    ``UnsupportedChunk`` without re-walking pages.  With the cache off
    or ``skey`` None the walk runs uncached."""
    from spark_rapids_tpu_torch.io import parquet_meta as pm
    from spark_rapids_tpu_torch.io.device_parquet import (
        UnsupportedChunk, plan_chunk)

    pkey = (rg, leaf_idx, out_dtype.name, bool(allow_mixed))
    use_cache = _ENABLED and skey is not None
    if use_cache:
        with _LOCK:
            entry = _probe_locked(skey)
            cached = entry.plans.get(pkey) if entry is not None else None
        if cached is not None:
            _bump_hits(metrics)
            if isinstance(cached, Exception):
                # fresh instance per raise: the cached one is shared
                raise type(cached)(*cached.args)
            return cached
        _bump_misses(metrics)
    try:
        chunk = pm.read_chunk_pages(src, rg, leaf_idx, parquet_file=pf)
        plan = plan_chunk(chunk, out_dtype, allow_mixed=allow_mixed)
    except UnsupportedChunk as e:
        # negative-cache ONLY the deterministic verdict, stripped of
        # its traceback (frames pin the whole compressed chunk bytes,
        # and concurrent re-raises would race on __traceback__);
        # transient IO/parse errors must stay uncached and retryable
        if use_cache:
            neg = UnsupportedChunk(*e.args)
            with _LOCK:
                entry = _entry_locked(skey)
                if pkey not in entry.plans:
                    entry.plans[pkey] = neg
                    _account_locked(entry, _plan_nbytes(neg))
        raise
    if use_cache:
        with _LOCK:
            entry = _entry_locked(skey)
            if pkey not in entry.plans:
                entry.plans[pkey] = plan
                _account_locked(entry, _plan_nbytes(plan))
            else:
                got = entry.plans[pkey]
                if not isinstance(got, Exception):
                    plan = got
    return plan


def _bump_hits(metrics) -> None:
    global _HITS
    with _LOCK:
        _HITS += 1
    _count(metrics, "scan.planCacheHits")


def _bump_misses(metrics) -> None:
    global _MISSES
    with _LOCK:
        _MISSES += 1
    _count(metrics, "scan.planCacheMisses")


def open_source(path: str, metrics=None):
    """Footer-backed handle for a scan source: the cached FooterInfo
    when the cache is on, else a real ParquetFile (caller must close)."""
    if _ENABLED and file_key(path) is not None:
        return get_footer(path, metrics=metrics)
    return papq.ParquetFile(path)


def blob_footer(blob) -> papq.ParquetFile:
    """ParquetFile over an in-memory Parquet blob."""
    return papq.ParquetFile(io.BytesIO(blob))
