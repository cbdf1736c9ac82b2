"""Fused multi-row-group Parquet decode: one pass per scan batch.

Ported from ``spark_rapids_tpu/io/parquet_fused.py``.  The HOST walks
pages for every column of every row group in the batch (O(pages + runs),
io/device_parquet.plan_chunk, cached by io/scan_cache.py) and
:func:`assemble` packs what they found into one upload set; the DEVICE
half (:func:`_make_kernel`) then expands runs, applies definition levels,
gathers dictionaries and stitches row groups for the whole batch, in six
phases:

  phase 0  bit unpack: the bit-packed regions of one width concatenate
           into one byte buffer, unpacked by ``kernels/decode.unpack_bits``
           (csrc/decode.cu on the card) in place into that width's slice
           of one dense value array (:func:`unpack_dense`);
  phase 1  run expansion: streams with few runs copy slices of the dense
           array per run; many-run streams broadcast per-run metadata
           (A = dense index - run start, C = RLE value * 2 + is_rle) to
           elements with a delta scatter + cumsum, then gather once per
           element;
  phase 2  definition levels: segments whose levels are all valid (known
           on the host) skip the level expansion and the null compaction;
  phase 3  dictionary gather (eager) or, for columns deferred by a
           pushed filter, dictionary codes;
  phase 4  row-group stitching: segment k's padding tail is overwritten
           by segment k+1's write;
  phase 5  with a pushed filter: the condition's mask over the decoded
           columns, then the predicated dictionary gathers of
           ``kernels/filter_decode`` (csrc/filter_decode.cu on the card)
           for the deferred columns.

The reference compiles one XLA program per static spec and keeps row
counts and offsets as traced operands so that program is reused.  The
port runs the phases eagerly: row counts, run starts and buffer offsets
are host ints known at prepare time, and only bulk data lives on the
device.  The reference's JAX ``dynamic_slice`` / ``dynamic_update_slice``
clamp their start so the slice fits; the port clamps the same starts
explicitly (``_clamp_start``) and writes the stitched segments in the
same order.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   _VBIT_BUCKETS,
                                                   _bucket_strlen,
                                                   bits_for_range,
                                                   bucket_rows,
                                                   concat_batches,
                                                   from_arrow,
                                                   resolve_device)
from spark_rapids_tpu_torch.columnar.interop import fused_arrays_to_torch
from spark_rapids_tpu_torch.columnar.transfer import (PinnedStage,
                                                      PinnedUpload)
from spark_rapids_tpu_torch.exec.base import timed_extra
from spark_rapids_tpu_torch.expr import ir
from spark_rapids_tpu_torch.io import parquet_meta as pm
from spark_rapids_tpu_torch.io.device_parquet import (ChunkPlan, RunTable,
                                                      UnsupportedChunk,
                                                      _cast_one,
                                                      _decode_list_plan,
                                                      _plan_list_chunk,
                                                      leaf_map)
from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.kernels import decode as kdec
from spark_rapids_tpu_torch.plan.logical import Schema

_BIG = np.int32(1 << 30)
# streams with at most this many hybrid runs expand per run as masked
# slices of the dense array; above it, the delta-scatter + cumsum general
# path with one gather per element takes over
_SLICE_MAX_RUNS = 8


# ---------------------------------------------------------------------------
# Host assembly
# ---------------------------------------------------------------------------

@dataclass
class _SegSpec:
    """Decode recipe for one (column, row-group) segment."""
    mode: str             # 'dict' | 'dict_str' | 'plain' | 'bool' | 'null'
    nullable: bool        # EFFECTIVE: False when def levels are all-valid
    def_stream: int = -1  # global stream index, -1 = none
    val_stream: int = -1
    plain_key: str = ""   # wire dtype of the plain buffer
    dcap: int = 0         # bucketed dictionary rows
    dlen: int = 0         # bucketed string dict max_len
    # slots in the meta vector
    m_plain_off: int = -1
    m_dict_off: int = -1
    m_dict_size: int = -1
    m_dlen_off: int = -1
    # deferral: keep this dict segment as CODES through stitching; the
    # dictionary gather runs predicated on the pushed filter's mask
    # after the condition is evaluated (kernels/filter_decode)
    defer: bool = False


@dataclass(slots=True)
class _FusedPlan:
    """Everything :func:`assemble` packed on the host.  Slotted: the
    kernel cache's argument walk sees it as one opaque value (its content
    is in ``key``), as the reference's jitted decode closes over it."""
    specs: List[List[_SegSpec]]      # [col][rg]
    out_dtypes: List[dt.DType]
    names: List[str]
    arrays: Dict[str, np.ndarray]    # upload set
    n_rows: List[int]
    cap: int
    vcap: int
    # per global stream: ('slice', row in sruns) | ('general', row in gruns)
    stream_path: List[Tuple[str, int]] = field(default_factory=list)
    nslcap: int = 1       # runs per row of sruns
    widths: Tuple[Tuple[int, int], ...] = ()   # (width, Ncap) sorted
    # per-column value-range hint (DeviceColumn.vbits) computed from
    # host-known dictionary pages / PLAIN buffers; None = unknown
    col_vbits: Tuple[Optional[int], ...] = ()
    # (condition, scan output-name order, deferred column names) when
    # the pushed filter is active, else None
    pushed: Optional[Tuple] = None
    # the kernel-cache key of the decode (the reference's "pq_fused6"
    # key) and the kernel backend in effect
    key: Tuple = ()
    backend: str = kb.PALLAS


def _column_vbits(out_dtype: dt.DType,
                  col_plans: List[Optional[ChunkPlan]]) -> Optional[int]:
    """Host-known value range of one fused column: dictionary pages hold
    every referenceable value, PLAIN buffers every stored value — min/max
    over them bounds all VALID decoded values.  Re-bucketed to the kernel
    ABI's coarse hint table (exec/kernel_abi)."""
    if out_dtype.is_string or out_dtype.is_floating or out_dtype.is_bool:
        return None
    if not np.issubdtype(np.dtype(out_dtype.to_np()), np.integer):
        return None
    lo, hi = 0, 0
    seen = False
    for p in col_plans:
        if p is None or p.mode == "null":
            continue   # all-null segment: no value constraint
        if p.mode == "dict":
            buf = p.dict_np
        elif p.mode == "plain":
            buf = p.plain_np
        else:
            return None
        if buf is None or not np.issubdtype(buf.dtype, np.integer):
            return None
        if buf.shape[0]:
            lo = min(lo, int(buf.min())) if seen else int(buf.min())
            hi = max(hi, int(buf.max())) if seen else int(buf.max())
            seen = True
    from spark_rapids_tpu_torch.exec import kernel_abi
    if not seen:
        return kernel_abi.bucket_vbits(_VBIT_BUCKETS[0])
    return kernel_abi.bucket_vbits(bits_for_range(lo, hi))


def _all_valid(runs: RunTable) -> bool:
    """True when a def-level stream encodes zero nulls (every run is an
    RLE run of 1) — pyarrow writes exactly this for null-free pages."""
    return bool((runs.is_rle & (runs.values == 1)).all())


def _int32(a: np.ndarray, what: str) -> np.ndarray:
    """``a`` as int32; a value outside int32 raises, as the reference's
    assignment of a Python int into its int32 matrix does."""
    if a.size and (a.min() < -(1 << 31) or a.max() >= (1 << 31)):
        raise OverflowError(f"fused stream {what} out of bounds for int32")
    return a.astype(np.int32)


def _resolve_streams(streams: List[Tuple[RunTable, bytes]], vcap: int,
                     alloc=np.empty):
    """Phase 1's host tables for every stream of a batch, over the run
    tables' arrays (the reference's ``_stream_quads``, its region
    bookkeeping, the run resolution and the matrix fill, with no Python
    loop over runs).

    Each bit-packed run's byte region reaches to the next bit-packed run
    of its stream (or the stream's end); a width's regions concatenate,
    in stream order, into that width's buffer, so a run's value offset
    there is a cumulative sum of ``len(region) * 8 // w`` per width.  The
    buffers lie in one dense array, widths ascending, after a front pad
    of vcap.  A run's A (dense index of its first value minus its start)
    is set by its bit-packed runs and carried forward through RLE runs; C
    packs an RLE value and flag as value*2+1.  Streams of at most
    ``_SLICE_MAX_RUNS`` runs take the slice path, one (start, end, A, C)
    row per run; the others take the general path, one (start, dA, dC)
    row per run.  The width buffers are ``alloc``-ated.

    Returns (w_caps, bits arrays, stream_path, nslcap, sruns, gruns)."""
    ns = np.array([rt.counts.shape[0] for rt, _ in streams], dtype=np.int64)
    n_streams = len(streams)
    first = np.zeros(n_streams, dtype=np.int64)
    np.cumsum(ns[:-1], out=first[1:])
    sid = np.repeat(np.arange(n_streams), ns)
    local = np.arange(int(ns.sum())) - np.repeat(first, ns)

    def cat(field, dtype):
        parts = [getattr(rt, field) for rt, _ in streams]
        return np.concatenate(parts) if parts else np.zeros(0, dtype)
    counts = cat("counts", np.int64)
    is_rle = cat("is_rle", bool)
    values = cat("values", np.int64)
    bit_bases = cat("bit_bases", np.int64)
    widths = cat("widths", np.int32).astype(np.int64)

    # run starts within their stream
    ends = np.cumsum(counts)
    starts = ends - counts
    base = np.zeros(n_streams, dtype=np.int64)
    has = ns > 0
    base[has] = starts[first[has]]
    starts -= np.repeat(base, ns)
    ends = starts + counts

    # bit-packed runs: byte regions, value counts, per-width offsets
    bp = np.flatnonzero(~is_rle)
    w_bp = widths[bp]
    if (w_bp == 0).any():
        raise UnsupportedChunk("fused decode: bit-packed run of width 0")
    plen = np.array([len(pk) for _, pk in streams], dtype=np.int64)
    s_bp = sid[bp]
    b0 = np.minimum(bit_bases[bp] // 8, plen[s_bp])
    b1 = np.empty_like(b0)
    b1[:-1] = b0[1:]
    last_of_stream = np.ones(bp.shape[0], dtype=bool)
    last_of_stream[:-1] = s_bp[1:] != s_bp[:-1]
    b1[last_of_stream] = plen[s_bp[last_of_stream]]
    region = np.maximum(np.minimum(b1, plen[s_bp]) - b0, 0)
    nvals = region * 8 // np.maximum(w_bp, 1)
    voff = np.zeros(bp.shape[0], dtype=np.int64)
    width_vals: Dict[int, int] = {}
    for w in np.unique(w_bp).tolist():
        m = np.flatnonzero(w_bp == w)
        c = np.cumsum(nvals[m])
        voff[m] = c - nvals[m]
        width_vals[w] = int(c[-1])

    # width layout: one dense value array, front-padded by vcap so a
    # run's slice start is never negative, and tail-padded by vcap so a
    # slice near the end of the last width section fits without clamping
    w_caps = []
    dense_off: Dict[int, int] = {}
    off = vcap
    for w in sorted(width_vals):
        ncap = bucket_rows(width_vals[w], 16)   # multiple of 8
        dense_off[w] = off
        off += ncap
        w_caps.append((w, ncap))
    if off + vcap > int(_BIG):
        raise UnsupportedChunk("packed streams too long for fused decode")

    # each width's buffer: its regions in stream order, copied in spans
    # of regions that lie back to back in one stream's packed bytes
    bits: Dict[str, np.ndarray] = {}
    for w, ncap in w_caps:
        m = np.flatnonzero(w_bp == w)
        new = np.ones(m.shape[0], dtype=bool)
        new[1:] = (s_bp[m][1:] != s_bp[m][:-1]) | \
            (b0[m][1:] != b0[m][:-1] + region[m][:-1])
        span = np.cumsum(new) - 1
        span_len = np.bincount(span, weights=region[m]).astype(np.int64)
        span_first = m[new]
        buf = alloc(ncap * w // 8, np.uint8)
        dst = 0
        for j, ln in zip(span_first.tolist(), span_len.tolist()):
            if ln:
                buf[dst:dst + ln] = np.frombuffer(
                    streams[int(s_bp[j])][1], dtype=np.uint8, count=ln,
                    offset=int(b0[j]))
            dst += ln
        buf[dst:] = 0
        bits[f"bits_{w}"] = buf

    # A: set by bit-packed runs, carried through RLE runs from 0 at each
    # stream's start; C: value*2+1 for RLE runs, 0 for bit-packed ones
    a_own = np.zeros(counts.shape[0], dtype=np.int64)
    dense_bp = np.zeros(bp.shape[0], dtype=np.int64)
    for w, o in dense_off.items():
        dense_bp[w_bp == w] = o
    a_own[bp] = dense_bp + voff - starts[bp]
    anchor = ~is_rle
    anchor[first[has]] = True
    last = np.maximum.accumulate(
        np.where(anchor, np.arange(counts.shape[0]), -1))
    a = a_own[np.maximum(last, 0)]
    c = np.where(is_rle, (values << 1) | 1, 0)

    # slice path vs general path, and each stream's row in its matrix
    is_slice = ns <= _SLICE_MAX_RUNS
    rank = np.where(is_slice, np.cumsum(is_slice) - 1,
                    np.cumsum(~is_slice) - 1)
    stream_path = [("slice" if sl else "general", int(r))
                   for sl, r in zip(is_slice.tolist(), rank.tolist())]
    nslcap = _bucket_strlen(int(np.maximum(ns[is_slice], 1).max(initial=1)))
    rcap = bucket_rows(int(ns[~is_slice].max(initial=1)), 8)

    run_slice = is_slice[sid]
    n_slice = int(is_slice.sum())
    if n_slice:
        sruns = np.zeros((n_slice, nslcap, 4), dtype=np.int32)
        sruns[:, :, :2] = _BIG   # empty range: start == end == BIG
        r = np.flatnonzero(run_slice)
        sruns[rank[sid[r]], local[r]] = np.stack(
            [_int32(starts[r], "start"), _int32(ends[r], "end"),
             _int32(a[r], "A"), _int32(c[r], "C")], axis=1)
    else:
        sruns = np.zeros((1, nslcap, 4), dtype=np.int32)
    n_general = n_streams - n_slice
    if n_general:
        gruns = np.zeros((n_general, rcap, 3), dtype=np.int32)
        gruns[:, :, 0] = _BIG    # scatter target past vcap: dropped
        prev_a = np.zeros_like(a)
        prev_c = np.zeros_like(c)
        prev_a[1:], prev_c[1:] = a[:-1], c[:-1]
        prev_a[local == 0] = 0
        prev_c[local == 0] = 0
        r = np.flatnonzero(~run_slice)
        gruns[rank[sid[r]], local[r]] = np.stack(
            [_int32(starts[r], "start"), _int32(a[r] - prev_a[r], "dA"),
             _int32(c[r] - prev_c[r], "dC")], axis=1)
    else:
        gruns = np.zeros((1, rcap, 3), dtype=np.int32)
    return tuple(w_caps), bits, stream_path, nslcap, sruns, gruns


def _defer_candidates(plans, names, pushed_filter, scan_names) -> set:
    """Dictionary columns (int or string) the pushed condition does not
    read, each with one dictionary wire dtype, can defer their gather."""
    ref_names = {scan_names[b.ordinal] for b in ir.collect(
        pushed_filter, lambda e: isinstance(e, ir.BoundReference))}
    defer_cols: set = set()
    for ci, col_plans in enumerate(plans):
        modes = {p.mode for p in col_plans if p is not None}
        if modes not in ({"dict"}, {"dict_str"}):
            continue
        if names[ci] in ref_names:
            kb.record_fallback("scan.filterDecode", "condition_column")
            continue
        if modes == {"dict"}:
            # phase 5 gathers one column from ONE dictionary buffer:
            # segments whose dictionaries have different wire dtypes
            # live in different buffers
            pkeys = {str(p.dict_np.dtype) for p in col_plans
                     if p is not None}
            if len(pkeys) != 1:
                kb.record_fallback("scan.filterDecode", "mixed_dict_dtypes")
                continue
        defer_cols.add(ci)
    if not defer_cols:
        kb.record_fallback("scan.filterDecode", "no_dict_columns")
    return defer_cols


def _packed(parts: List[np.ndarray], size: int, alloc) -> np.ndarray:
    """``parts`` back to back in one ``alloc``-ated buffer of ``size``
    elements, zero past them: the one host copy of the values."""
    buf = alloc(size, parts[0].dtype)
    off = 0
    for a in parts:
        buf[off:off + a.shape[0]] = a
        off += a.shape[0]
    buf[off:] = 0
    return buf


def assemble(plans: List[List[Optional[ChunkPlan]]],
             out_dtypes: List[dt.DType], names: List[str],
             n_rows: List[int], pushed_filter=None,
             scan_names: Optional[List[str]] = None,
             device="cuda", alloc=np.empty,
             backend: str = kb.PALLAS) -> _FusedPlan:
    """Pack every segment's host structures into the fused upload set.

    plans[col][rg] is a ChunkPlan, or None for a column missing from
    that file (emitted as all-null rows for that segment).

    ``pushed_filter`` (with ``scan_names``, the scan's full output-name
    order the condition's ordinals index) arms the deferral: dictionary
    columns NOT referenced by the condition keep codes until the mask is
    known.  ``device`` is where the batch will decode: for CPU tensors
    the reference's kernel gates (kernels/filter_decode.supported,
    str_supported) decide the deferral as the reference decides it; on
    the card every deferrable column defers.

    The large buffers of the upload set (packed bits, plain and dictionary
    values) are ``alloc``-ated (``np.empty``'s signature) and filled in
    place: on the card ``prepare_fused`` passes pinned memory, so the
    page bytes are copied once on the host."""
    from spark_rapids_tpu_torch.kernels import filter_decode as kfd
    vcap = bucket_rows(max(max(n_rows, default=1), 1))
    total = sum(n_rows)
    cap = bucket_rows(max(total, 1))

    defer_cols = _defer_candidates(plans, names, pushed_filter,
                                   scan_names) \
        if pushed_filter is not None else set()

    streams: List[Tuple[RunTable, bytes]] = []
    meta: List[int] = []
    specs: List[List[_SegSpec]] = []

    def add_meta(v: int) -> int:
        meta.append(int(v))
        return len(meta) - 1

    plain_parts: Dict[str, List[np.ndarray]] = {}
    plain_sizes: Dict[str, int] = {}
    dict_parts: Dict[str, List[np.ndarray]] = {}
    dict_sizes: Dict[str, int] = {}

    for ci, col_plans in enumerate(plans):
        col_specs: List[_SegSpec] = []
        for p in col_plans:
            if p is None:
                col_specs.append(_SegSpec(mode="null", nullable=True))
                continue
            nullable = p.nullable and not _all_valid(p.def_runs)
            s = _SegSpec(mode=p.mode, nullable=nullable,
                         defer=(ci in defer_cols and
                                p.mode in ("dict", "dict_str")))
            if nullable:
                s.def_stream = len(streams)
                streams.append((p.def_runs, p.def_packed))
            if p.mode in ("dict", "dict_str", "bool"):
                s.val_stream = len(streams)
                streams.append((p.val_runs, p.val_packed))
            if p.mode == "plain":
                key = str(p.plain_np.dtype)
                s.plain_key = key
                off = plain_sizes.get(key, 0)
                s.m_plain_off = add_meta(off)
                plain_parts.setdefault(key, []).append(p.plain_np)
                plain_sizes[key] = off + p.plain_np.shape[0]
            if p.mode == "dict":
                d = p.dict_np
                key = str(d.dtype)
                s.plain_key = key
                off = dict_sizes.get(key, 0)
                s.m_dict_off = add_meta(off)
                s.m_dict_size = add_meta(d.shape[0])
                s.dcap = bucket_rows(d.shape[0], 8)
                dict_parts.setdefault(key, []).append(d)
                dict_sizes[key] = off + d.shape[0]
            if p.mode == "dict_str":
                mat, lens = p.dict_np, p.dict_lens
                s.dlen = _bucket_strlen(mat.shape[1])
                s.dcap = bucket_rows(mat.shape[0], 8)
                off = dict_sizes.get("u8str", 0)
                s.m_dict_off = add_meta(off)
                s.m_dict_size = add_meta(mat.shape[0])
                dict_parts.setdefault("u8str", []).append(
                    mat.reshape(-1).astype(np.uint8))
                dict_sizes["u8str"] = off + mat.size
                loff = dict_sizes.get("strlens", 0)
                s.m_dlen_off = add_meta(loff)
                dict_parts.setdefault("strlens", []).append(
                    lens.astype(np.int32))
                dict_sizes["strlens"] = loff + lens.shape[0]
                # the un-bucketed row stride of the flat matrix
                s.plain_key = str(mat.shape[1])
            col_specs.append(s)
        specs.append(col_specs)

    w_caps, bits, stream_path, nslcap, sruns, gruns = _resolve_streams(
        streams, vcap, alloc)
    arrays: Dict[str, np.ndarray] = {
        "nrows": np.asarray(n_rows, dtype=np.int32),
        "meta": np.asarray(meta or [0], dtype=np.int32),
        "sruns": sruns,
        "gruns": gruns,
        **bits,
    }
    for key, parts in plain_parts.items():
        # slack so a slice of vcap values never walks off the end
        arrays["plain_" + key] = _packed(
            parts, bucket_rows(plain_sizes[key] + vcap, 64), alloc)
    for key, parts in dict_parts.items():
        pad = max((s.dcap * max(s.dlen, 1)
                   for row in specs for s in row), default=64)
        arrays["dict_" + key] = _packed(
            parts, bucket_rows(dict_sizes[key] + pad, 64), alloc)

    # -- the reference's kernel gates, for batches decoding on the CPU
    if torch.device(device).type == "cpu":
        for ci in sorted(defer_cols):
            s0 = next(s for s in specs[ci]
                      if s.mode in ("dict", "dict_str"))
            if s0.mode == "dict":
                ok, reason = kfd.supported(cap)
            else:
                col_L = max(s.dlen for s in specs[ci]
                            if s.mode == "dict_str")
                ok, reason = kfd.str_supported(cap, col_L)
                if ok:
                    # the lengths recover through the 1-D gather
                    ok, reason = kfd.supported(cap)
            if not ok:
                kb.record_fallback("scan.filterDecode", reason)
                for s in specs[ci]:
                    s.defer = False
    defer_names = tuple(
        names[ci] for ci in range(len(specs))
        if any(s.defer for s in specs[ci]))
    pushed = (pushed_filter, tuple(scan_names), defer_names) \
        if defer_names else None

    col_vbits = tuple(_column_vbits(out_dtypes[ci], plans[ci])
                      for ci in range(len(plans)))
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    pushed_sig = (kc.expr_sig(pushed_filter), tuple(scan_names),
                  defer_names) if pushed is not None else None
    # the reference's key field for field; its Pallas interpret flag and
    # tile budget have no counterpart (None)
    key = ("pq_fused6", tuple(names),
           tuple(d.name for d in out_dtypes), len(n_rows), vcap, cap,
           nslcap, int(arrays["gruns"].shape[1]), tuple(stream_path),
           tuple(w_caps), col_vbits, backend, None, None, pushed_sig,
           tuple((a, arrays[a].shape, str(arrays[a].dtype))
                 for a in sorted(arrays)),
           tuple(tuple((s.mode, s.nullable, s.def_stream, s.val_stream,
                        s.plain_key, s.dcap, s.dlen, s.m_plain_off,
                        s.m_dict_off, s.m_dict_size, s.m_dlen_off,
                        s.defer)
                       for s in row) for row in specs))
    return _FusedPlan(specs=specs, out_dtypes=out_dtypes,
                      names=names, arrays=arrays, n_rows=list(n_rows),
                      cap=cap, vcap=vcap, stream_path=stream_path,
                      nslcap=nslcap, widths=w_caps,
                      col_vbits=col_vbits, pushed=pushed, key=key,
                      backend=backend)


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

def _clamp_start(start: int, length: int, size: int) -> int:
    """The start JAX's dynamic_slice / dynamic_update_slice use: clamped
    so that ``size`` elements from it fit in ``length``."""
    return min(max(start, 0), max(length - size, 0))


def _expand_slice_stream(sruns_row: np.ndarray, dense_all: torch.Tensor,
                         vcap: int) -> torch.Tensor:
    """Phase 1, few-runs path: per run, the values of
    ``dense_all[clip(A) + i]`` (a bit-packed run) or the RLE value, on
    the run's rows [start, end) — dense copies, no gathers.  The run
    table is host-known."""
    out = torch.zeros(vcap, dtype=torch.int32, device=dense_all.device)
    hi = dense_all.shape[0] - vcap
    for start, end, a, c in sruns_row.tolist():
        lo_i, hi_i = max(start, 0), min(end, vcap)
        if lo_i >= hi_i:
            continue
        if c & 1:
            out[lo_i:hi_i] = c >> 1
        else:
            base = min(max(a, 0), hi)
            out[lo_i:hi_i] = dense_all[base + lo_i:base + hi_i]
    return out


def _expand_general(gruns: torch.Tensor, dense_all: torch.Tensor,
                    vcap: int) -> torch.Tensor:
    """Phase 1, many-runs path, for every general stream at once:
    broadcast per-run metadata to elements with a delta scatter + cumsum
    (the A and C step functions), then ONE gather per element into
    dense_all.  Padding rows (start ``_BIG``) scatter into slot vcap of
    an n+1 buffer and drop."""
    g = gruns.shape[0]
    dev = gruns.device
    starts = torch.clamp(gruns[:, :, 0], max=vcap).long()

    def step(delta: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros((g, vcap + 1), dtype=torch.int32, device=dev)
        acc.scatter_add_(1, starts, delta)
        return torch.cumsum(acc[:, :vcap], 1, dtype=torch.int32)

    a = step(gruns[:, :, 1].contiguous())
    c = step(gruns[:, :, 2].contiguous())
    i = torch.arange(vcap, dtype=torch.int32, device=dev)
    idx = torch.clamp(a + i, 0, dense_all.shape[0] - 1)
    vals = dense_all[idx.long()]
    return torch.where((c & 1) != 0, c >> 1, vals)


def _def_apply(levels: Optional[torch.Tensor], values: torch.Tensor,
               n_r: int, vcap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Definition levels -> (per-row values, validity) for one segment.
    Segments with no nulls pass levels=None and skip the compaction."""
    row = torch.arange(vcap, device=values.device)
    if levels is None:
        return values, row < n_r
    valid = (levels == 1) & (row < n_r)
    vidx = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    vidx = torch.clamp(vidx, 0, values.shape[0] - 1)
    return values[vidx.long()], valid


def unpack_dense(fp: _FusedPlan,
                 arrays: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Phase 0: the one dense value array, a zero pad of vcap, each width's
    unpacked values in ``fp.widths`` order, a zero pad of vcap.  It is
    allocated once; only the pads are zeroed, and each width's unpack
    writes into its own slice."""
    vcap = fp.vcap
    total = sum(ncap for _, ncap in fp.widths)
    dense_all = torch.empty(2 * vcap + total, dtype=torch.int32,
                            device=arrays["meta"].device)
    dense_all[:vcap].zero_()                                 # front pad
    dense_all[vcap + total:].zero_()                         # tail pad
    off = vcap
    for w, ncap in fp.widths:
        kdec.unpack_bits(arrays[f"bits_{w}"], w, ncap,
                         out=dense_all[off:off + ncap])
        off += ncap
    return dense_all


def _decode_fused(fp: _FusedPlan, arrays: Dict[str, torch.Tensor]):
    """The fused decode of one assembled batch (the kernel-cache step)."""
    return _make_kernel(fp)(arrays)


def _make_kernel(fp: _FusedPlan):
    """The fused decode of one assembled batch, as an eager function of
    the uploaded arrays: ``kernel(arrays) -> (columns, total)``, one
    DeviceColumn per fused column."""
    specs = fp.specs
    out_dtypes = fp.out_dtypes
    vcap, cap = fp.vcap, fp.cap
    n_rows = list(fp.n_rows)
    K = len(n_rows)
    total = sum(n_rows)
    prevs = [sum(n_rows[:k]) for k in range(K)]
    meta = fp.arrays["meta"].tolist()
    sruns = fp.arrays["sruns"]

    def kernel(arrays: Dict[str, torch.Tensor]):
        dev = arrays["meta"].device

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # -- phase 0: dense per-width unpack -> one value array ----------
        dense_all = unpack_dense(fp, arrays)

        # -- phase 1: expand every stream to [vcap] -----------------------
        gen_out = _expand_general(arrays["gruns"], dense_all, vcap) \
            if any(p == "general" for p, _ in fp.stream_path) else None
        expanded = [_expand_slice_stream(sruns[idx], dense_all, vcap)
                    if path == "slice" else gen_out[idx]
                    for path, idx in fp.stream_path]

        # -- phases 2-3: one segment at a time ----------------------------
        def segment(s: _SegSpec, n_r: int):
            lv = expanded[s.def_stream] if s.nullable else None
            if s.mode in ("dict", "dict_str"):
                idx, valid = _def_apply(lv, expanded[s.val_stream], n_r,
                                        vcap)
                doff = meta[s.m_dict_off]
                idx = torch.clamp(idx, 0, max(meta[s.m_dict_size] - 1, 0))
                if s.mode == "dict" and s.defer:
                    # keep CODES (global dictionary index) for phase 5
                    return doff + idx, valid
                if s.mode == "dict":
                    vals = arrays["dict_" + s.plain_key][(doff + idx).long()]
                    return torch.where(valid, vals, 0), valid
                L = int(s.plain_key)
                loff = meta[s.m_dlen_off]
                if s.defer:
                    # byte base into the shared u8 matrix buffer, index
                    # into the lengths buffer, and the row stride
                    lw = torch.where(valid, L, 0).to(torch.int32)
                    return doff + idx * L, loff + idx, lw, valid
                dbuf = arrays["dict_u8str"]
                col = torch.arange(s.dlen, device=dev)
                byte_idx = (doff + idx * L)[:, None] + col[None, :]
                mat = dbuf[torch.clamp(byte_idx, 0, dbuf.shape[0] - 1)]
                mat = torch.where(valid[:, None] & (col[None, :] < L),
                                  mat, 0)
                lens = arrays["dict_strlens"][(loff + idx).long()]
                return mat, valid, torch.where(valid, lens, 0).to(
                    torch.int32)
            if s.mode == "bool":
                data, valid = _def_apply(lv, expanded[s.val_stream] != 0,
                                         n_r, vcap)
                return data & valid, valid
            pbuf = arrays["plain_" + s.plain_key]
            o = _clamp_start(meta[s.m_plain_off], pbuf.shape[0], vcap)
            data, valid = _def_apply(lv, pbuf[o:o + vcap], n_r, vcap)
            return torch.where(valid, data, 0), valid

        # -- phase 4: stitch row groups per column ------------------------
        # sequential writes per segment: write k's padding tail lands in
        # [prevs[k]+n_k, prevs[k]+vcap), which write k+1 (starting at
        # prevs[k]+n_k) overwrites; the last tail is zeros by design
        cap_pad = cap + vcap

        def stitch(parts, fill=0):
            out = torch.full((cap_pad,) + tuple(parts[0].shape[1:]), fill,
                             dtype=parts[0].dtype, device=dev)
            for k in range(K):
                st = _clamp_start(prevs[k], cap_pad, vcap)
                out[st:st + vcap] = parts[k]
            return out[:cap]

        cols: List[Optional[DeviceColumn]] = []
        # ci -> ('int', codes, valid) | ('str', bb, li, lw, valid, L)
        deferred: Dict[int, Tuple] = {}
        for ci, col_specs in enumerate(specs):
            odt = out_dtypes[ci]
            t_t = None if odt.is_string else odt.to_torch()
            col_defer = any(s.defer for s in col_specs)
            str_defer = col_defer and odt.is_string
            col_L = max((s.dlen for s in col_specs), default=1) \
                if odt.is_string else 0
            seg_data, seg_valid, seg_lens = [], [], []
            seg_li, seg_lw = [], []      # string-defer code streams
            for r, s in enumerate(col_specs):
                if s.mode == "null":
                    if col_defer:
                        seg_data.append(zeros(vcap, torch.int32))
                        if str_defer:
                            seg_li.append(zeros(vcap, torch.int32))
                            seg_lw.append(zeros(vcap, torch.int32))
                    elif odt.is_string:
                        seg_data.append(zeros((vcap, col_L), torch.uint8))
                        seg_lens.append(zeros(vcap, torch.int32))
                    else:
                        seg_data.append(zeros(vcap, t_t))
                    seg_valid.append(zeros(vcap, torch.bool))
                    continue
                out = segment(s, n_rows[r])
                if str_defer:
                    seg_data.append(out[0].to(torch.int32))   # byte base
                    seg_li.append(out[1].to(torch.int32))
                    seg_lw.append(out[2])
                    seg_valid.append(out[3])
                elif col_defer:
                    seg_data.append(out[0].to(torch.int32))
                    seg_valid.append(out[1])
                elif odt.is_string:
                    d = out[0]
                    if d.shape[1] < col_L:
                        d = torch.nn.functional.pad(
                            d, (0, col_L - d.shape[1]))
                    seg_data.append(d)
                    seg_valid.append(out[1])
                    seg_lens.append(out[2])
                else:
                    seg_data.append(out[0].to(t_t))
                    seg_valid.append(out[1])

            valid = stitch(seg_valid, False)
            nn = all(not s.nullable and s.mode != "null" for s in col_specs)
            if str_defer:
                deferred[ci] = ("str", stitch(seg_data), stitch(seg_li),
                                stitch(seg_lw), valid, col_L)
                cols.append(None)
            elif col_defer:
                deferred[ci] = ("int", stitch(seg_data), valid)
                cols.append(None)
            elif odt.is_string:
                cols.append(DeviceColumn(odt, stitch(seg_data), valid,
                                         stitch(seg_lens), nonnull=nn))
            else:
                cols.append(DeviceColumn(odt, stitch(seg_data), valid,
                                         vbits=fp.col_vbits[ci],
                                         nonnull=nn))

        # -- phase 5: the pushed filter's mask, then the PREDICATED
        # -- dictionary gathers of the deferred columns ------------------
        if deferred:
            from spark_rapids_tpu_torch.expr import eval_tpu
            from spark_rapids_tpu_torch.kernels import filter_decode as kfd
            cond, scan_names, _names = fp.pushed
            by_name = {nm: c for nm, c in zip(fp.names, cols)
                       if c is not None}
            # placeholder for names the condition cannot reference
            # (deferred, partition and fallback columns: barred by the
            # prepare-time gates)
            ph = DeviceColumn(dt.INT32, zeros(cap, torch.int32),
                              zeros(cap, torch.bool))
            cv = eval_tpu.evaluate(cond, DeviceBatch(
                list(scan_names), [by_name.get(nm, ph) for nm in scan_names],
                total, dev))
            keep = cv.data.to(torch.bool) & cv.validity & \
                (torch.arange(cap, device=dev) < total)
            for ci, info in deferred.items():
                odt = out_dtypes[ci]
                nn = all(not s.nullable and s.mode != "null"
                         for s in specs[ci])
                if info[0] == "str":
                    _k, bb, li, lw, valid, col_L = info
                    keepv = keep & valid
                    mat = kfd.decode_str(arrays["dict_u8str"], bb, lw, keepv,
                                         col_L)
                    lens = kfd.decode(arrays["dict_strlens"], li, keepv)
                    cols[ci] = DeviceColumn(odt, mat, valid, lens,
                                            nonnull=nn)
                    continue
                _k, codes, valid = info
                s0 = next(s for s in specs[ci] if s.defer)
                vals = kfd.decode(arrays["dict_" + s0.plain_key], codes,
                                  keep & valid)
                cols[ci] = DeviceColumn(odt, vals.to(odt.to_torch()), valid,
                                        vbits=fp.col_vbits[ci], nonnull=nn)
        return tuple(cols), total

    return kernel


# ---------------------------------------------------------------------------
# Public entry: host prep (prepare) split from the device decode (finish)
# ---------------------------------------------------------------------------

def _fused_list_column(sources, f, n_rows: List[int],
                       dev: torch.device) -> Optional[DeviceColumn]:
    """A list column of the fused batch: the per-column list decode of
    every row group, concatenated on the device; None when a chunk's
    host walk fails (the column then takes the host fallback)."""
    plans = []
    try:
        for pf, path, rg in sources:
            leaf_of = leaf_map(pf)
            if f.name not in leaf_of:
                return None
            chunk = pm.read_chunk_pages(path, rg, leaf_of[f.name],
                                        parquet_file=pf)
            plans.append(_plan_list_chunk(chunk, f.dtype, f.nullable))
    except Exception:
        return None
    per = [DeviceBatch([f.name], [_decode_list_plan(
        lp, bucket_rows(max(nr, 1)), dev)], nr, dev)
        for lp, nr in zip(plans, n_rows)]
    return concat_batches(per).columns[0]


@dataclass
class PreparedScan:
    """Everything a fused scan batch needs except the device decode: the
    assembled plan, its upload set on the device, the list columns
    (already decoded) and the host-decoded fallback columns (already
    uploaded).  On the card the upload set is a
    :class:`~spark_rapids_tpu_torch.columnar.transfer.PinnedUpload`: its
    copies may still be in flight on the scan's copy stream, and it
    carries their event and the pinned buffers they read."""
    wanted: List[str]
    total: int
    cap: int
    fp: Optional[_FusedPlan]
    dev_arrays: Optional[Dict[str, torch.Tensor]]
    dev_cols: List[str]
    extra_cols: Dict[str, DeviceColumn]
    fallbacks: List[str]
    device: torch.device


def _collect_plans(sources, schema, wanted, host_threads: int,
                   metrics=None, device="cuda"
                   ) -> Tuple[List, List[str], Dict[str, DeviceColumn]]:
    """Walk (or cache-fetch) every flat column chunk's ChunkPlan: a
    thread pool of ``host_threads`` walks page headers and run
    boundaries across (column, row-group) pairs concurrently (page reads
    and codec decompression release the GIL).  List columns decode per
    row group through the list decode and concatenate on ``device``.
    Returns per wanted column its plans (None for a list column and for
    a column that falls back to host Arrow), the fallback column names
    and the decoded list columns."""
    from spark_rapids_tpu_torch.io import scan_cache as sc

    # key on the stamp each footer was PARSED under (handle_key), not a
    # fresh stat: a file rewritten mid-scan must never cache plans built
    # from the stale footer's offsets under its new key
    skeys = {path: sc.handle_key(pf, path) for pf, path, _ in sources}
    flat_cols = [c for c in wanted if not schema.field(c).dtype.is_list]

    def run(item):
        c, si = item
        pf, path, rg = sources[si]
        try:
            leaf_of = leaf_map(pf)
            if c not in leaf_of:
                return None
            return sc.get_chunk_plan(skeys[path], path, rg, leaf_of[c],
                                     schema.field(c).dtype, False, pf,
                                     metrics=metrics)
        except Exception as e:
            # UnsupportedChunk or a malformed page: this column decodes
            # on the host; the rest of the batch stays on the device
            return e

    tasks = [(c, si) for c in flat_cols for si in range(len(sources))]
    if host_threads > 1 and len(tasks) > 1:
        with cf.ThreadPoolExecutor(
                max_workers=min(host_threads, len(tasks)),
                thread_name_prefix="scan-hostprep") as pool:
            outs = list(pool.map(run, tasks))
    else:
        outs = [run(t) for t in tasks]
    results = dict(zip(tasks, outs))

    n_rows = [pf.metadata.row_group(rg).num_rows for pf, _, rg in sources]
    plans: List[Optional[List[Optional[ChunkPlan]]]] = []
    fallbacks: List[str] = []
    list_cols: Dict[str, DeviceColumn] = {}
    for c in wanted:
        f = schema.field(c)
        if f.dtype.is_list:
            col = _fused_list_column(sources, f, n_rows, device)
            if col is not None:
                list_cols[c] = col
            else:
                fallbacks.append(c)
            plans.append(None)
            continue
        col_plans = [results[(c, si)] for si in range(len(sources))]
        if any(isinstance(p, Exception) for p in col_plans):
            fallbacks.append(c)
            plans.append(None)
        else:
            plans.append(col_plans)
    return plans, fallbacks, list_cols


def _host_fallback(sources, schema, fallbacks: List[str], cap: int,
                   dev: torch.device, copy_stream=None
                   ) -> Dict[str, DeviceColumn]:
    """Host Arrow decode of the fallback columns of every row group,
    uploaded at the batch capacity."""
    import pyarrow.parquet as papq
    from spark_rapids_tpu_torch.io import scan_cache as sc
    opened: Dict[str, Any] = {}

    def reader(pf, path):
        # one transient open per path for the whole fallback merge
        if isinstance(pf, sc.FooterInfo):
            if path not in opened:
                opened[path] = papq.ParquetFile(path)
            return opened[path]
        return pf
    try:
        tables = []
        for pf, path, rg in sources:
            leaf_of = leaf_map(pf)
            present = [c for c in fallbacks if c in leaf_of]
            t = reader(pf, path).read_row_group(
                rg, columns=present) if present else pa.table({})
            arrs = []
            for c in fallbacks:
                f = schema.field(c)
                if c in present:
                    arrs.append(_cast_one(t.select([c]), f).column(0))
                else:
                    arrs.append(pa.nulls(
                        t.num_rows if present
                        else pf.metadata.row_group(rg).num_rows,
                        type=f.dtype.to_arrow()))
            tables.append(pa.Table.from_arrays(arrs, names=list(fallbacks)))
    finally:
        for f in opened.values():
            f.close()
    fb = from_arrow(pa.concat_tables(tables), capacity=cap, device=dev,
                    copy_stream=copy_stream)
    return dict(zip(fb.names, fb.columns))


def prepare_fused(sources: Sequence[Tuple[Any, str, int]],
                  schema: Schema,
                  columns: Optional[List[str]] = None,
                  host_threads: int = 1,
                  metrics=None,
                  pushed_filter=None,
                  scan_names: Optional[List[str]] = None,
                  device="cuda", copy_stream=None,
                  backend: Optional[str] = None) -> PreparedScan:
    """Host half of the fused decode: page walks (through the scan-plan
    cache), fused-plan assembly, the upload to ``device`` (on the card
    through pinned memory on ``copy_stream``, without waiting for the
    copies), and the host-Arrow fallback decode.  It never reads device
    memory, so it may run on a prefetch thread.

    ``pushed_filter``/``scan_names`` arm the deferred dictionary decode
    (see :func:`assemble`): a hint checked per batch, never a contract —
    an ineligible batch decodes everything.  ``backend`` is the plan's
    ``kernel.backend`` stamp (the process default when None); it tags the
    decode's kernel-cache key and dispatch counter."""
    dev = resolve_device(device)
    backend = kb.resolve(backend)

    def phase(key):
        # the phases may overlap the consumer's decode on a prefetch
        # thread: sections only, not the exec's total time
        return timed_extra(metrics, key) if metrics is not None \
            else contextlib.nullcontext()

    wanted = columns or [f.name for f in schema.fields]
    out_dtypes = [schema.field(c).dtype for c in wanted]
    n_rows = [pf.metadata.row_group(rg).num_rows for pf, _, rg in sources]
    total = sum(n_rows)
    cap = bucket_rows(max(total, 1))

    with phase("scan.hostPrepTime"):
        plans, fallbacks, list_cols = _collect_plans(
            sources, schema, wanted, host_threads, metrics=metrics,
            device=dev)
        dev_cols = [c for c, p in zip(wanted, plans) if p is not None]
        dev_dtypes = [d for d, p in zip(out_dtypes, plans) if p is not None]
        dev_plans = [p for p in plans if p is not None]

        pushed = None
        if pushed_filter is not None:
            # every column the condition reads must be device-decoded in
            # THIS batch (a fallback or partition operand would evaluate
            # against a placeholder)
            ref_names = {scan_names[b.ordinal] for b in ir.collect(
                pushed_filter, lambda e: isinstance(e, ir.BoundReference))}
            if ref_names <= set(dev_cols):
                pushed = pushed_filter
            else:
                kb.record_fallback("scan.filterDecode", "condition_columns")

        # on the card the upload set is packed straight into pinned memory
        stage = PinnedStage() if dev.type == "cuda" else None
        fp = assemble(dev_plans, dev_dtypes, dev_cols, n_rows,
                      pushed_filter=pushed, scan_names=scan_names,
                      device=dev, backend=backend,
                      alloc=stage.empty if stage is not None else np.empty
                      ) if dev_plans else None

    with phase("scan.uploadTime"):
        dev_arrays = None
        if fp is not None:
            dev_arrays = fused_arrays_to_torch(fp.arrays, dev, copy_stream,
                                               stage)
            up = sum(int(v.nbytes) for v in fp.arrays.values())
            if metrics is not None:
                metrics.add_extra("scan.bytesUploaded", up)
            if up:
                # upload-byte accounting: global counter + tenant
                # ledger, same n (the exactness invariant)
                from spark_rapids_tpu_torch.obs import accounting as _acct
                from spark_rapids_tpu_torch.obs import registry as _obsreg
                _obsreg.get_registry().inc("scan.bytesUploaded", up)
                _acct.charge("scan.bytesUploaded", up)
        extra_cols = dict(list_cols)
        if fallbacks:
            extra_cols.update(_host_fallback(sources, schema, fallbacks, cap,
                                             dev, copy_stream))

    return PreparedScan(wanted=wanted, total=total, cap=cap, fp=fp,
                        dev_arrays=dev_arrays, dev_cols=dev_cols,
                        extra_cols=extra_cols, fallbacks=fallbacks,
                        device=dev)


def finish_fused(prep: PreparedScan) -> Tuple[DeviceBatch, List[str]]:
    """Device half: the fused decode over the prepared upload set.
    Returns (batch, fallback column names)."""
    cols_by_name: Dict[str, DeviceColumn] = dict(prep.extra_cols)
    if prep.fp is not None:
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        if isinstance(prep.dev_arrays, PinnedUpload):
            prep.dev_arrays.wait()     # the decode reads the copies
        # the cached step takes the plan as an argument: its host arrays
        # (the meta values, the slice runs) differ between batches of
        # one key, where the reference's are traced operands
        kern = kc.get_kernel(prep.fp.key, lambda: _decode_fused,
                             backend=prep.fp.backend)
        out_cols, _ = kern(prep.fp, prep.dev_arrays)
        cols_by_name.update(zip(prep.dev_cols, out_cols))
    out = DeviceBatch(prep.wanted, [cols_by_name[c] for c in prep.wanted],
                      prep.total, prep.device)
    return out, prep.fallbacks


def decode_row_groups_fused(sources: Sequence[Tuple[Any, str, int]],
                            schema: Schema,
                            columns: Optional[List[str]] = None,
                            host_threads: int = 1,
                            metrics=None,
                            device="cuda"
                            ) -> Tuple[DeviceBatch, List[str]]:
    """Decode several (parquet_file, path, row_group) sources into ONE
    DeviceBatch on ``device`` (plus a host-decoded merge of any column
    the device path cannot cover).  Returns (batch, fallback column
    names)."""
    return finish_fused(prepare_fused(sources, schema, columns=columns,
                                      host_threads=host_threads,
                                      metrics=metrics, device=device))
