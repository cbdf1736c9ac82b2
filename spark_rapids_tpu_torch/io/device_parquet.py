"""Parquet decode: page runs walked on the host, values expanded on device.

Ported from ``spark_rapids_tpu/io/device_parquet.py``.  The CPU walks page
headers and RLE/bit-packed run boundaries — O(pages + runs), not
O(values) — into a :class:`ChunkPlan` per column chunk; the device then
does the O(values) work.  Two readers consume the plans: the fused
whole-batch decode (io/parquet_fused.py) and the per-column decode here,
which the scan's PERFILE reader (io/device_scan.py) runs per row group:

  * hybrid RLE/bit-pack expansion, one stream at a time:
    ``kernels/decode.expand_stream`` (csrc/decode.cu on the card), or for
    a stream that mixes bit widths and for list indices the window-gather
    composition :func:`expand_runs_matrix` in plain torch;
  * definition levels -> validity, then the non-null values scattered by
    ``cumsum(validity)`` (:func:`_def_expand`);
  * dictionary gathers on the device, string dictionaries as padded byte
    matrices (:func:`_dict_gather`);
  * ``list<primitive>`` columns (:func:`decode_list_chunk`): repetition and
    definition levels decode on the host with vectorised numpy, element
    values on the device, then one scatter places them in the
    ``[cap, L]`` list matrix.

Coverage: PLAIN + PLAIN_/RLE_DICTIONARY for INT32/INT64/FLOAT/DOUBLE/
BOOLEAN, dictionary-encoded BYTE_ARRAY (strings), flat schemas
(max_rep == 0, max_def <= 1) and lists of primitives, data pages v1 + v2,
any Arrow-supported page codec (host decompress).  Anything else raises
:class:`UnsupportedChunk` and the column falls back to Arrow host decode
*per column*.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   _bucket_strlen,
                                                   bucket_rows, from_arrow,
                                                   resolve_device,
                                                   scatter_drop)
from spark_rapids_tpu_torch.columnar.transfer import upload_arrays
from spark_rapids_tpu_torch.io import parquet_meta as pm
from spark_rapids_tpu_torch.kernels.decode import _as_int32
from spark_rapids_tpu_torch.plan.logical import Schema

_MAX_W = 24  # the window-gather composition reads shift (<= 7) + w bits
# the dense paths (io/parquet_fused.py and kernels/decode.expand_stream)
# unpack any width up to a full 32-bit index word
_MAX_W_DENSE = 32

# ---------------------------------------------------------------------------
# Host side: run walking (O(runs), not O(values))
# ---------------------------------------------------------------------------

@dataclass
class RunTable:
    """Hybrid RLE/bit-pack runs, concatenated across pages of a chunk, as
    numpy arrays: int64 ``counts``, ``values`` and ``bit_bases``, bool
    ``is_rle``, int32 ``widths``.  The page walk builds them once
    (:class:`RunBuilder`), so a cached plan converts nothing.

    `bit_bases` index into the shared `packed` byte buffer for bit-packed
    runs; `values` hold the repeated value for RLE runs."""

    counts: np.ndarray
    is_rle: np.ndarray
    values: np.ndarray
    bit_bases: np.ndarray
    widths: np.ndarray

    def __post_init__(self):
        self.counts = np.asarray(self.counts, dtype=np.int64)
        self.is_rle = np.asarray(self.is_rle, dtype=bool)
        self.values = np.asarray(self.values, dtype=np.int64)
        self.bit_bases = np.asarray(self.bit_bases, dtype=np.int64)
        self.widths = np.asarray(self.widths, dtype=np.int32)

    @staticmethod
    def empty() -> "RunTable":
        return RunTable([], [], [], [], [])

    @property
    def total(self) -> int:
        return int(self.counts.sum())


class RunBuilder:
    """The runs of a page walk as they are found (Python lists, appended
    once per run; the reference's list-backed ``RunTable``), frozen into
    a :class:`RunTable` by :meth:`table`."""

    __slots__ = ("counts", "is_rle", "values", "bit_bases", "widths")

    def __init__(self):
        self.counts: List[int] = []
        self.is_rle: List[bool] = []
        self.values: List[int] = []
        self.bit_bases: List[int] = []
        self.widths: List[int] = []

    @property
    def total(self) -> int:
        return sum(self.counts)

    def trim_to(self, n: int) -> None:
        """Drop bit-pack padding so total == n (last runs clamp)."""
        excess = self.total - n
        while excess > 0 and self.counts:
            take = min(excess, self.counts[-1])
            self.counts[-1] -= take
            excess -= take
            if self.counts[-1] == 0:
                for lst in (self.counts, self.is_rle, self.values,
                            self.bit_bases, self.widths):
                    lst.pop()

    def table(self) -> RunTable:
        return RunTable(self.counts, self.is_rle, self.values,
                        self.bit_bases, self.widths)


def walk_hybrid(buf: bytes, start: int, end: int, w: int,
                packed: bytearray, runs: RunBuilder,
                max_values: Optional[int] = None) -> int:
    """Walk one page's hybrid stream appending runs; returns values seen.

    Bit-packed byte regions are appended to `packed` so the device sees one
    contiguous buffer per chunk."""
    pos = start
    vbytes = (w + 7) // 8
    seen = 0
    while pos < end and (max_values is None or seen < max_values):
        h = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            h |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if h & 1:  # bit-packed groups
            groups = h >> 1
            count = groups * 8
            nbytes = groups * w
            runs.counts.append(count)
            runs.is_rle.append(False)
            runs.values.append(0)
            runs.bit_bases.append(len(packed) * 8)
            runs.widths.append(w)
            packed += buf[pos:pos + nbytes]
            pos += nbytes
        else:  # RLE run
            count = h >> 1
            val = int.from_bytes(buf[pos:pos + vbytes], "little") \
                if vbytes else 0
            pos += vbytes
            runs.counts.append(count)
            runs.is_rle.append(True)
            runs.values.append(val)
            runs.bit_bases.append(0)
            runs.widths.append(w)
        seen += count
    return seen


def nonnull_count(runs: RunBuilder, packed: bytes, lo_run: int, hi_run: int,
                  n: int) -> int:
    """Host count of def-level==1 entries among the first n values of the
    run range [lo_run, hi_run) — popcount over bit-packed regions only."""
    remaining = n
    nn = 0
    for i in range(lo_run, hi_run):
        c = min(runs.counts[i], remaining)
        if c <= 0:
            break
        if runs.is_rle[i]:
            nn += c if runs.values[i] == 1 else 0
        else:
            base = runs.bit_bases[i] // 8
            nbytes = (c + 7) // 8
            bits = np.unpackbits(
                np.frombuffer(packed, dtype=np.uint8,
                              count=nbytes, offset=base),
                bitorder="little")[:c]
            nn += int(bits.sum())
        remaining -= c
    return nn


def _pad_np(a: np.ndarray, cap: int, fill=0) -> np.ndarray:
    if a.shape[0] >= cap:
        return a[:cap]
    pad = np.full((cap - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


# ---------------------------------------------------------------------------
# Device side: the window-gather run expansion
# ---------------------------------------------------------------------------

def expand_runs_matrix(runs_mat: torch.Tensor, packed: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """Expand one hybrid-run stream to ``[cap]`` values (int32 bit
    patterns of the reference's uint32).  ``runs_mat`` is ``[rcap, 5]``
    int64 with columns (cumulative end, is_rle, value, bit_base, width);
    ``packed`` the stream's bit-packed bytes.

    Each element finds its run by a bump scatter at the run ends plus a
    cumsum, then reads a 4-byte window at its bit position: any width up
    to ``_MAX_W``.  The 2^62 end of a padding row clamps to ``cap`` before
    the scatter and drops there."""
    dev = runs_mat.device
    ends = runs_mat[:, 0]
    i = torch.arange(cap, dtype=ends.dtype, device=dev)
    bump = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    bump.index_add_(0, torch.clamp(ends, max=cap),
                    torch.ones(ends.shape[0], dtype=torch.int32, device=dev))
    rid = torch.cumsum(bump[:cap], 0, dtype=torch.int32)
    rid = torch.clamp(rid, 0, ends.shape[0] - 1).long()
    prev_end = torch.where(rid > 0, ends[torch.clamp(rid - 1, min=0)], 0)
    local = i - prev_end
    w = runs_mat[rid, 4]
    bitpos = runs_mat[rid, 3] + local * w
    byte0 = bitpos >> 3
    sh = bitpos & 7
    nb = packed.shape[0]

    def g(k: int) -> torch.Tensor:
        return packed[torch.clamp(byte0 + k, 0, nb - 1)].to(torch.int64)

    window = g(0) | (g(1) << 8) | (g(2) << 16) | (g(3) << 24)
    mask = (torch.ones_like(w) << w) - 1
    unpacked = (window >> sh) & mask
    return _as_int32(torch.where(runs_mat[rid, 1] != 0, runs_mat[rid, 2],
                                 unpacked) & 0xFFFFFFFF)


def _runs_arrays(runs: "RunTable", packed: bytes) -> dict:
    """A run table as two host arrays: the ``[rcap, 5]`` int64 run matrix
    (padding rows end at 2^62) and the packed bytes, padded to a
    64-byte-tier length.  The matrix fills column by column from the
    table's arrays."""
    n = runs.counts.shape[0]
    rcap = bucket_rows(max(n, 1), 8)
    mat = np.zeros((rcap, 5), dtype=np.int64)
    mat[:, 0] = np.int64(1) << 62
    np.cumsum(runs.counts, out=mat[:n, 0])
    mat[:n, 1] = runs.is_rle
    mat[:n, 2] = runs.values
    mat[:n, 3] = runs.bit_bases
    mat[:n, 4] = runs.widths
    if n == 0:
        mat[0, 0] = 0      # the cumulative end of the empty table
    pk = np.zeros(bucket_rows(max(len(packed), 4), 64), dtype=np.uint8)
    pk[:len(packed)] = np.frombuffer(packed, dtype=np.uint8)
    return dict(runs_mat=mat, packed=pk)


def expand_runs_arrays(runs: "RunTable", packed: bytes) -> dict:
    """The arrays the window-gather expansion (:func:`expand_runs_matrix`,
    the reference's XLA path of ``expand_stream``) uploads for one
    stream; raises :class:`UnsupportedChunk` for a bit-packed width past
    ``_MAX_W``, so the column takes the host fallback as in the
    reference."""
    wmax = int(runs.widths[~runs.is_rle].max(initial=0))
    if wmax > _MAX_W:
        raise UnsupportedChunk(f"dict bit width {wmax}")
    return _runs_arrays(runs, packed)


def _def_expand(levels: torch.Tensor, values: torch.Tensor, n_rows: int,
                cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validity + per-row values from definition levels and the
    non-null-compacted values (cumsum two-pass scatter; values 1-D or
    2-D)."""
    row = torch.arange(cap, device=levels.device)
    valid = (levels == 1) & (row < n_rows)
    vidx = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    vidx = torch.clamp(vidx, 0, values.shape[0] - 1)
    out = values[vidx.long()]
    keep = valid[:, None] if out.dim() == 2 else valid
    return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device)), valid


def _dict_gather(indices: torch.Tensor, dictionary: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp(indices.to(torch.int32), 0, dictionary.shape[0] - 1)
    out = dictionary[idx.long()]
    keep = valid[:, None] if out.dim() == 2 else valid
    return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


# ---------------------------------------------------------------------------
# Per-chunk host plan
# ---------------------------------------------------------------------------

_PLAIN_NP = {"INT32": np.dtype("<i4"), "INT64": np.dtype("<i8"),
             "FLOAT": np.dtype("<f4"), "DOUBLE": np.dtype("<f8")}


class UnsupportedChunk(Exception):
    pass


def _parse_plain_byte_array(buf: bytes, n: int) -> List[bytes]:
    out = []
    pos = 0
    for _ in range(n):
        ln = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        out.append(buf[pos:pos + ln])
        pos += ln
    return out


def _string_dict_matrix(vals: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    from spark_rapids_tpu_torch.columnar.batch import _bucket_strlen
    max_len = _bucket_strlen(max((len(v) for v in vals), default=1))
    mat = np.zeros((max(len(vals), 1), max_len), dtype=np.uint8)
    lens = np.zeros((max(len(vals), 1),), dtype=np.int32)
    for i, v in enumerate(vals):
        mat[i, :len(v)] = np.frombuffer(v, dtype=np.uint8)
        lens[i] = len(v)
    return mat, lens


@dataclass
class ChunkPlan:
    """Host-side decode plan for one flat column chunk: run tables,
    packed bit regions, raw PLAIN bytes and dictionaries — everything
    the device expansion needs, produced by one O(pages+runs) host walk.
    Shared by the per-column decode (:func:`decode_plan`) and the fused
    whole-batch decode (io/parquet_fused.py)."""
    n_rows: int
    nullable: bool
    out_dtype: dt.DType
    mode: str          # 'dict' | 'dict_str' | 'plain' | 'bool' | 'mixed'
    def_runs: RunTable = None
    def_packed: bytes = b""
    val_runs: RunTable = None      # dict indices or bool bits
    val_packed: bytes = b""
    plain_np: np.ndarray = None    # PLAIN values (raw, non-null only)
    dict_np: np.ndarray = None
    dict_lens: np.ndarray = None
    page_segs: list = None         # per-page ('dict'|'plain', n_values)


def plan_chunk(chunk: pm.ChunkPages, out_dtype: dt.DType,
               allow_mixed: bool = False) -> ChunkPlan:
    """Host walk of one chunk's pages -> ChunkPlan (raises
    UnsupportedChunk for anything the device path doesn't cover).

    ``allow_mixed`` permits chunks whose dictionary overflowed mid-chunk
    (dict pages then PLAIN pages — pyarrow does this for high-cardinality
    columns); the fused path doesn't take them."""
    if chunk.max_rep > 0 or chunk.max_def > 1:
        raise UnsupportedChunk("nested column")
    ptype = chunk.physical_type
    if ptype not in _PLAIN_NP and ptype != "BOOLEAN" and \
            ptype != "BYTE_ARRAY":
        raise UnsupportedChunk(f"physical type {ptype}")
    lt = chunk.logical_type
    if "Decimal" in lt or "Time(" in lt or "isSigned=false" in lt or \
            ("Timestamp" in lt and "micro" not in lt):
        # value transforms the device path doesn't do (unit scaling,
        # unsigned reinterpretation, decimal) — host Arrow handles them
        raise UnsupportedChunk(f"logical type {lt}")

    # -- dictionary page (host parse; dictionaries are small) --------------
    dict_np = None
    dict_lens = None
    if chunk.dict_page is not None:
        dp = chunk.dict_page
        payload = pm.decompress(
            chunk.codec, chunk.data[dp.payload_off:
                                    dp.payload_off + dp.compressed_size],
            dp.uncompressed_size)
        if ptype == "BYTE_ARRAY":
            vals = _parse_plain_byte_array(payload, dp.num_values)
            dict_np, dict_lens = _string_dict_matrix(vals)
        else:
            dict_np = np.frombuffer(payload, dtype=_PLAIN_NP[ptype],
                                    count=dp.num_values).copy()
            if dict_np.shape[0] == 0:  # all-null chunk: empty dictionary
                dict_np = np.zeros((1,), dtype=_PLAIN_NP[ptype])

    nullable = chunk.max_def == 1
    def_runs = RunBuilder()
    def_packed = bytearray()
    idx_runs = RunBuilder()
    idx_packed = bytearray()
    plain_parts: List[bytes] = []   # PLAIN value byte regions
    bool_runs = RunBuilder()        # BOOLEAN PLAIN == w=1 bit-pack runs
    bool_packed = bytearray()
    n_rows = 0
    n_nonnull_plain = 0
    idx_target = 0   # expected cumulative values in the index stream
    bool_target = 0
    any_dict = False
    any_plain = False
    page_segs: List[Tuple[str, int]] = []

    for page in chunk.data_pages:
        raw = chunk.data[page.payload_off:
                         page.payload_off + page.compressed_size]
        if page.page_type == pm.DATA_PAGE_V2:
            lvl = page.v2_rep_bytes + page.v2_def_bytes
            levels_buf = raw[:lvl]
            if page.v2_is_compressed:
                vals_buf = pm.decompress(chunk.codec, raw[lvl:],
                                         page.uncompressed_size - lvl)
            else:
                vals_buf = raw[lvl:]
            def_start, def_end = page.v2_rep_bytes, lvl
        else:
            payload = pm.decompress(chunk.codec, raw,
                                    page.uncompressed_size)
            levels_buf = payload
            if nullable:
                dlen = struct.unpack_from("<I", payload, 0)[0]
                def_start, def_end = 4, 4 + dlen
                vals_buf = payload[def_end:]
            else:
                def_start = def_end = 0
                vals_buf = payload

        lo = len(def_runs.counts)
        if nullable:
            walk_hybrid(levels_buf, def_start, def_end, 1,
                        def_packed, def_runs)
            def_runs.trim_to(n_rows + page.num_values)
            nn = nonnull_count(def_runs, bytes(def_packed), lo,
                               len(def_runs.counts), page.num_values)
        else:
            nn = page.num_values
        n_rows += page.num_values

        enc = page.encoding
        if enc in (pm.PLAIN_DICTIONARY, pm.RLE_DICTIONARY):
            if dict_np is None:
                raise UnsupportedChunk("dict-encoded page w/o dictionary")
            any_dict = True
            w = vals_buf[0]
            if w > _MAX_W_DENSE:
                raise UnsupportedChunk(f"dict bit width {w}")
            walk_hybrid(vals_buf, 1, len(vals_buf), w, idx_packed,
                        idx_runs)
            # trim this page's bit-pack group-of-8 padding
            idx_target += nn
            idx_runs.trim_to(idx_target)
            page_segs.append(("dict", nn))
        elif enc == pm.PLAIN:
            any_plain = True
            page_segs.append(("plain", nn))
            if ptype == "BOOLEAN":
                groups = (nn + 7) // 8
                bool_runs.counts.append(groups * 8)
                bool_runs.is_rle.append(False)
                bool_runs.values.append(0)
                bool_runs.bit_bases.append(len(bool_packed) * 8)
                bool_runs.widths.append(1)
                bool_packed += vals_buf[:groups]
                bool_target += nn
                bool_runs.trim_to(bool_target)
            elif ptype == "BYTE_ARRAY":
                raise UnsupportedChunk("PLAIN byte_array page")
            else:
                itemsize = _PLAIN_NP[ptype].itemsize
                plain_parts.append(vals_buf[:nn * itemsize])
            n_nonnull_plain += nn
        else:
            raise UnsupportedChunk(f"encoding {enc}")

    if any_dict and any_plain:
        # dictionary overflowed mid-chunk (pyarrow does this for
        # high-cardinality columns): dict-coded pages then PLAIN pages
        if not allow_mixed or out_dtype.is_string or \
                ptype == "BOOLEAN":
            raise UnsupportedChunk("mixed dict+plain pages")
        mode = "mixed"
    elif any_dict:
        mode = "dict_str" if out_dtype.is_string else "dict"
    elif ptype == "BOOLEAN":
        mode = "bool"
    else:
        mode = "plain"
    plain_np = None
    if mode in ("plain", "mixed"):
        raw = b"".join(plain_parts)
        plain_np = np.frombuffer(raw, dtype=_PLAIN_NP[ptype],
                                 count=n_nonnull_plain)
    return ChunkPlan(
        n_rows=n_rows, nullable=nullable, out_dtype=out_dtype, mode=mode,
        def_runs=def_runs.table(), def_packed=bytes(def_packed),
        val_runs=(idx_runs if any_dict else bool_runs).table(),
        val_packed=bytes(idx_packed) if any_dict else bytes(bool_packed),
        plain_np=plain_np, dict_np=dict_np, dict_lens=dict_lens,
        page_segs=page_segs)


def decode_chunk(chunk: pm.ChunkPages, out_dtype: dt.DType, cap: int,
                 device="cuda") -> DeviceColumn:
    """Decode one flat column chunk into a DeviceColumn of capacity cap
    on ``device``."""
    return decode_plan(plan_chunk(chunk, out_dtype, allow_mixed=True), cap,
                       device=device)


def decode_plan(p: ChunkPlan, cap: int, device="cuda",
                copy_stream=None) -> DeviceColumn:
    """Decode one host-walked ChunkPlan (possibly from the scan-plan
    cache, io/scan_cache.py) into a DeviceColumn of capacity cap on
    ``device``: its host arrays upload together (on the card through one
    pinned stage on ``copy_stream``).  The plan is shared across queries
    and threads and is not modified."""
    dev = resolve_device(device)
    preps, arrays = _plan_host(p, dev)
    return _plan_device(p, preps, upload_arrays(arrays, dev, copy_stream),
                        cap, dev)


def _sub(tensors: dict, prefix: str) -> dict:
    """The entries of ``tensors`` under ``prefix.``, without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tensors.items()
            if k.startswith(prefix + ".")}


def _plan_host(p: ChunkPlan, dev: torch.device):
    """The host half of :func:`decode_plan`: the stream preps
    (kernels/decode.stream_prep) and every array the decode uploads,
    keyed ``<stream>.<array>`` for the streams."""
    from spark_rapids_tpu_torch.kernels import decode as kdec
    out_dtype = p.out_dtype
    vcap = bucket_rows(max(p.n_rows, 1))
    preps, arrays = {}, {}

    def stream(name, runs, packed):
        preps[name] = kdec.stream_prep(runs, packed, vcap, dev)
        arrays.update({f"{name}.{k}": a
                       for k, a in preps[name][2].items()})

    if p.nullable:
        stream("def", p.def_runs, p.def_packed)
    np_t = out_dtype.to_np() if not out_dtype.is_string else None
    if p.mode in ("dict", "dict_str"):
        stream("idx", p.val_runs, p.val_packed)
        if out_dtype.is_string:
            arrays["dict"] = p.dict_np
            arrays["dict_lens"] = p.dict_lens
        else:
            arrays["dict"] = p.dict_np.astype(np_t, copy=False)
    elif p.mode == "bool":
        stream("val", p.val_runs, p.val_packed)
    elif p.mode == "mixed":
        # dict-coded and PLAIN page segments merge in page order through
        # per-value source selectors built on the host
        stream("idx", p.val_runs, p.val_packed)
        arrays["dict"] = p.dict_np.astype(np_t, copy=False)
        arrays["plain"] = _pad_np(p.plain_np.astype(np_t, copy=False), vcap)
        kinds = np.array([k == "dict" for k, _ in p.page_segs])
        counts = np.array([c for _, c in p.page_segs], dtype=np.int64)
        sel = np.repeat(kinds, counts)
        arrays["sel"] = _pad_np(sel, vcap)
        arrays["di"] = _pad_np((np.cumsum(sel) - 1).astype(np.int32), vcap)
        arrays["pi"] = _pad_np((np.cumsum(~sel) - 1).astype(np.int32), vcap)
    else:
        arrays["plain"] = _pad_np(p.plain_np, vcap)
    return preps, arrays


def _plan_device(p: ChunkPlan, preps: dict, t: dict, cap: int,
                 dev: torch.device) -> DeviceColumn:
    """The device half of :func:`decode_plan`, over the uploaded arrays
    ``t``."""
    from spark_rapids_tpu_torch.kernels import decode as kdec
    out_dtype = p.out_dtype
    n_rows = p.n_rows
    vcap = bucket_rows(max(n_rows, 1))

    def expand(name):
        return kdec.stream_expand(preps[name], _sub(t, name), vcap)

    levels = expand("def") if p.nullable else None
    live = torch.arange(vcap, device=dev) < n_rows

    if p.mode in ("dict", "dict_str"):
        indices = expand("idx")
        valid = live
        if p.nullable:
            indices, valid = _def_expand(levels, indices, n_rows, vcap)
        if out_dtype.is_string:
            data = _dict_gather(indices, t["dict"], valid)
            lengths = _dict_gather(indices, t["dict_lens"], valid)
            return _to_cap(DeviceColumn(out_dtype, data, valid,
                                        lengths.to(torch.int32)), cap)
        data = _dict_gather(indices, t["dict"], valid)
        return _to_cap(DeviceColumn(out_dtype, data, valid), cap)

    if p.mode == "bool":
        vals = expand("val") != 0
    elif p.mode == "mixed":
        indices = expand("idx")
        dvals = t["dict"]
        d_vals = dvals[torch.clamp(indices, 0, dvals.shape[0] - 1).long()]
        vals = torch.where(
            t["sel"],
            d_vals[torch.clamp(t["di"], 0, vcap - 1).long()],
            t["plain"][torch.clamp(t["pi"], 0, vcap - 1).long()])
    else:
        vals = t["plain"]

    if p.nullable:
        data, valid = _def_expand(levels, vals, n_rows, vcap)
    else:
        data, valid = torch.where(live, vals, torch.zeros(
            (), dtype=vals.dtype, device=dev)), live
    data = data.to(out_dtype.to_torch())
    return _to_cap(DeviceColumn(out_dtype, data, valid), cap)


def _to_cap(col: DeviceColumn, cap: int) -> DeviceColumn:
    """Re-bucket a column to the batch capacity."""
    if col.capacity == cap:
        return col
    idx = torch.arange(cap, device=col.data.device)
    return col.gather(torch.clamp(idx, 0, col.capacity - 1),
                      idx < col.capacity)


# ---------------------------------------------------------------------------
# File-level API
# ---------------------------------------------------------------------------


def leaf_index_map(pf) -> dict:
    """Top-level column name -> first leaf-column index.

    Leaf PATHS are ambiguous (a column literally named "a.b" collides
    with struct a.b), so map by walking the Arrow schema and counting
    leaves per top-level field instead."""
    def n_leaves(t):
        if pa.types.is_struct(t):
            return sum(n_leaves(f.type) for f in t)
        if pa.types.is_list(t) or pa.types.is_large_list(t):
            return n_leaves(t.value_type)
        if pa.types.is_map(t):
            return n_leaves(t.key_type) + n_leaves(t.item_type)
        return 1
    out = {}
    leaf = 0
    for f in pf.schema_arrow:
        out[f.name] = leaf
        leaf += n_leaves(f.type)
    return out


def leaf_map(pf) -> dict:
    """leaf_index_map with the cached-footer fast path (FooterInfo
    memoizes its map; a plain ParquetFile recomputes)."""
    if hasattr(pf, "leaf_of"):
        return pf.leaf_of()
    return leaf_index_map(pf)


def _null_column(dtype: dt.DType, cap: int,
                 dev: torch.device) -> DeviceColumn:
    """All-null column for a partition or missing column."""
    def zeros(shape, t):
        return torch.zeros(shape, dtype=t, device=dev)
    invalid = zeros((cap,), torch.bool)
    if dtype.is_string:
        return DeviceColumn(dtype, zeros((cap, 1), torch.uint8), invalid,
                            zeros((cap,), torch.int32))
    if dtype.is_list:
        return DeviceColumn(dtype, zeros((cap, 1), dtype.element.to_torch()),
                            invalid, zeros((cap,), torch.int32),
                            zeros((cap, 1), torch.bool))
    return DeviceColumn(dtype, zeros((cap,), dtype.to_torch()), invalid)


def decode_row_group(path, row_group: int, schema: Schema,
                     columns: Optional[List[str]] = None,
                     parquet_file=None,
                     source_key: Optional[tuple] = None,
                     metrics=None,
                     device="cuda",
                     copy_stream=None) -> Tuple[DeviceBatch, List[str]]:
    """Decode one row group to a DeviceBatch on ``device``.  The host
    arrays of every device-decoded column upload together: on the card
    through one pinned stage on ``copy_stream`` (a
    ``columnar/transfer.CopyStream``; a fresh one when None).

    Returns (batch, fallback_columns): fallback columns were decoded on
    the host by Arrow because their chunks use encodings or types the
    device path does not cover.  The host walk of a chunk may fail in any
    way (an unsupported chunk, a malformed page) and its column falls
    back alone; preparing its arrays raises only ``UnsupportedChunk``
    for a fallback (a stream past 24 bits), and the device half lets
    every error through.

    ``path`` may also be an in-memory Parquet blob (bytes).
    ``source_key`` (io/scan_cache.handle_key) enables the scan-plan cache
    for the flat columns' page walks; None walks fresh.  ``parquet_file``
    may be a ParquetFile or a cached ``scan_cache.FooterInfo``."""
    from spark_rapids_tpu_torch.io import scan_cache as sc
    dev = resolve_device(device)
    opened = parquet_file is None
    if opened and isinstance(path, (bytes, bytearray, memoryview)):
        parquet_file = sc.blob_footer(path)
    pf = parquet_file or papq.ParquetFile(path)
    md = pf.metadata
    leaf_of = leaf_map(pf)
    wanted = columns or [f.name for f in schema.fields]
    n_rows = md.row_group(row_group).num_rows
    cap = bucket_rows(max(n_rows, 1))

    cols: List[Optional[DeviceColumn]] = []
    fallbacks: List[str] = []
    fb_pf = None    # one transient open shared by all fallback columns
    # (column index, plan, stream preps) of each device-decoded column;
    # their host arrays upload together, keyed "<column index>.<array>"
    decodes = []
    arrays = {}

    def fb_reader():
        nonlocal fb_pf
        if fb_pf is None:
            fb_pf = papq.ParquetFile(path) \
                if isinstance(pf, sc.FooterInfo) else pf
        return fb_pf

    try:
        for name in wanted:
            f = schema.field(name)
            if name not in leaf_of:
                cols.append(_null_column(f.dtype, cap, dev))
                continue
            ci = leaf_of[name]
            try:
                if f.dtype.is_list:
                    # nested chunks are not plan-cached: walk fresh
                    chunk = pm.read_chunk_pages(path, row_group, ci,
                                                parquet_file=pf)
                    plan = _plan_list_chunk(chunk, f.dtype, f.nullable)
                else:
                    plan = sc.get_chunk_plan(source_key, path, row_group,
                                             ci, f.dtype, True, pf,
                                             metrics=metrics)
            except Exception:
                plan = None
            host = None
            if plan is not None:
                try:
                    host = (None, _list_host(plan, cap)) \
                        if f.dtype.is_list else _plan_host(plan, dev)
                except UnsupportedChunk:
                    host = None
            if host is None:
                fallbacks.append(name)
                t = fb_reader().read_row_group(row_group, columns=[name])
                cols.append(from_arrow(_cast_one(t, f), capacity=cap,
                                       device=dev,
                                       copy_stream=copy_stream).columns[0])
                continue
            k = len(cols)
            decodes.append((k, plan, host[0]))
            arrays.update({f"{k}.{a}": v for a, v in host[1].items()})
            cols.append(None)
    finally:
        if fb_pf is not None and fb_pf is not pf:
            fb_pf.close()
        if opened:
            pf.close()
    if decodes:
        t = upload_arrays(arrays, dev, copy_stream)
        for k, plan, preps in decodes:
            mine = _sub(t, str(k))
            cols[k] = _list_device(plan, mine, cap, dev) if preps is None \
                else _plan_device(plan, preps, mine, cap, dev)
    return DeviceBatch(list(wanted), cols, n_rows, dev), fallbacks


def _cast_one(t: pa.Table, f) -> pa.Table:
    col = t.column(0).cast(f.dtype.to_arrow())
    return pa.Table.from_arrays(
        [col], schema=pa.schema([pa.field(f.name, f.dtype.to_arrow(),
                                          f.nullable)]))


# ---------------------------------------------------------------------------
# Nested (list) decode: max_rep == 1.  Repetition / definition level
# structure decodes with vectorised host numpy in O(levels); element values
# decode on the device, then one scatter places them in the [cap, L] list
# matrix.
# ---------------------------------------------------------------------------

def _expand_levels_host(runs: RunBuilder, packed: bytes) -> np.ndarray:
    """Hybrid runs -> numpy int32 levels (np.repeat / unpackbits per run:
    O(runs) Python, O(levels) vectorised)."""
    parts = []
    pk = np.frombuffer(packed, np.uint8)
    for i in range(len(runs.counts)):
        c = runs.counts[i]
        if c <= 0:
            continue
        if runs.is_rle[i]:
            parts.append(np.full(c, runs.values[i], np.int32))
        else:
            w = runs.widths[i]
            base = runs.bit_bases[i]
            nbits = c * w
            b0 = base // 8
            off = base % 8
            nb = (off + nbits + 7) // 8
            bits = np.unpackbits(pk[b0:b0 + nb], bitorder="little")
            bits = bits[off:off + nbits].reshape(c, w)
            parts.append(
                (bits.astype(np.int32) *
                 (1 << np.arange(w, dtype=np.int32))).sum(axis=1))
    return np.concatenate(parts) if parts else np.zeros(0, np.int32)


@dataclass
class ListPlan:
    """Host half of one list chunk's decode: the element values' source
    (dictionary index runs or PLAIN bytes) and the level structure,
    reduced to flat slot positions in the ``[cap, L]`` matrix."""
    out_dtype: dt.DType
    outer_nullable: bool
    n_rows: int
    n_vals: int
    L: int
    flat_val: np.ndarray       # slot of each non-null element
    flat_all: np.ndarray       # slot of each element, null ones too
    has_val_slot: np.ndarray   # per element: not null
    row_valid: np.ndarray      # per row: not a null list
    lengths: np.ndarray        # per row: elements
    idx_runs: Optional[RunTable]
    idx_packed: bytes
    dict_np: Optional[np.ndarray]
    plain_np: Optional[np.ndarray]


def _plan_list_chunk(chunk: pm.ChunkPages, out_dtype: dt.DType,
                     outer_nullable: bool) -> ListPlan:
    """Host walk of a list<primitive> column chunk (max_rep == 1)."""
    if chunk.max_rep != 1:
        raise UnsupportedChunk("max_rep > 1")
    if not out_dtype.is_list or out_dtype.element is None or \
            out_dtype.element.is_string or out_dtype.element.is_nested:
        raise UnsupportedChunk("list element type")
    ptype = chunk.physical_type
    if ptype not in _PLAIN_NP and ptype != "BOOLEAN":
        raise UnsupportedChunk(f"list physical type {ptype}")
    max_def = chunk.max_def
    elem_nullable = (max_def - (1 if outer_nullable else 0)) == 2
    null_row_def = 0 if outer_nullable else -1
    slot_def = max_def - (1 if elem_nullable else 0)

    def_w = max(max_def.bit_length(), 1)
    rep_w = 1

    dict_np = None
    if chunk.dict_page is not None:
        dpg = chunk.dict_page
        payload = pm.decompress(
            chunk.codec,
            chunk.data[dpg.payload_off:dpg.payload_off +
                       dpg.compressed_size], dpg.uncompressed_size)
        dict_np = np.frombuffer(payload, dtype=_PLAIN_NP[ptype],
                                count=dpg.num_values).copy()
        if dict_np.shape[0] == 0:
            dict_np = np.zeros((1,), dtype=_PLAIN_NP[ptype])

    reps, defs = [], []
    idx_runs = RunBuilder()
    idx_packed = bytearray()
    plain_parts: List[bytes] = []
    idx_target = 0
    any_dict = any_plain = False
    for page in chunk.data_pages:
        raw = chunk.data[page.payload_off:
                         page.payload_off + page.compressed_size]
        if page.page_type == pm.DATA_PAGE_V2:
            lvl = page.v2_rep_bytes + page.v2_def_bytes
            rep_buf = raw[:page.v2_rep_bytes]
            def_buf = raw[page.v2_rep_bytes:lvl]
            rep_s, rep_e = 0, len(rep_buf)
            def_s, def_e = 0, len(def_buf)
            if page.v2_is_compressed:
                vals_buf = pm.decompress(chunk.codec, raw[lvl:],
                                         page.uncompressed_size - lvl)
            else:
                vals_buf = raw[lvl:]
        else:
            payload = pm.decompress(chunk.codec, raw,
                                    page.uncompressed_size)
            rlen = struct.unpack_from("<I", payload, 0)[0]
            rep_buf = payload
            rep_s, rep_e = 4, 4 + rlen
            dlen = struct.unpack_from("<I", payload, rep_e)[0]
            def_buf = payload
            def_s, def_e = rep_e + 4, rep_e + 4 + dlen
            vals_buf = payload[def_e:]
        rt = RunBuilder()
        rpk = bytearray()
        walk_hybrid(rep_buf, rep_s, rep_e, rep_w, rpk, rt)
        rt.trim_to(page.num_values)
        reps.append(_expand_levels_host(rt, bytes(rpk)))
        dtab = RunBuilder()
        dpk = bytearray()
        walk_hybrid(def_buf, def_s, def_e, def_w, dpk, dtab)
        dtab.trim_to(page.num_values)
        page_defs = _expand_levels_host(dtab, bytes(dpk))
        defs.append(page_defs)
        nn = int((page_defs == max_def).sum())

        enc = page.encoding
        if enc in (pm.PLAIN_DICTIONARY, pm.RLE_DICTIONARY):
            if dict_np is None:
                raise UnsupportedChunk("dict page w/o dictionary")
            any_dict = True
            w = vals_buf[0]
            if w > _MAX_W:
                raise UnsupportedChunk(f"dict bit width {w}")
            walk_hybrid(vals_buf, 1, len(vals_buf), w, idx_packed,
                        idx_runs)
            idx_target += nn
            idx_runs.trim_to(idx_target)
        elif enc == pm.PLAIN:
            any_plain = True
            if ptype == "BOOLEAN":
                raise UnsupportedChunk("PLAIN boolean list")
            itemsize = _PLAIN_NP[ptype].itemsize
            plain_parts.append(vals_buf[:nn * itemsize])
        else:
            raise UnsupportedChunk(f"list encoding {enc}")
    if any_dict and any_plain:
        raise UnsupportedChunk("mixed dict+plain pages")

    rep = np.concatenate(reps) if reps else np.zeros(0, np.int32)
    dfl = np.concatenate(defs) if defs else np.zeros(0, np.int32)
    is_row = rep == 0
    n_rows = int(is_row.sum())
    row_id = np.cumsum(is_row) - 1
    is_slot = dfl >= slot_def
    has_val = dfl == max_def
    null_row = is_row & (dfl == null_row_def) if outer_nullable else \
        np.zeros_like(is_row)

    lengths = np.bincount(row_id[is_slot],
                          minlength=max(n_rows, 1)).astype(np.int32)
    if n_rows == 0:
        lengths = np.zeros(1, np.int32)
    L = _bucket_strlen(int(lengths.max()) if lengths.size else 0)
    slot_rows = row_id[is_slot]
    prev = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    cols = np.arange(slot_rows.shape[0], dtype=np.int64) - \
        np.repeat(prev[:n_rows], lengths[:n_rows])
    flat_all = slot_rows.astype(np.int64) * L + cols
    has_val_slot = has_val[is_slot]
    n_vals = int(has_val.sum())
    plain_np = None
    if not any_dict:
        npd = _PLAIN_NP[ptype] if ptype != "BOOLEAN" else np.dtype(bool)
        plain_np = np.frombuffer(b"".join(plain_parts), dtype=npd,
                                 count=n_vals)
    row_valid = ~null_row[is_row] if outer_nullable else \
        np.ones(n_rows, dtype=bool)
    return ListPlan(
        out_dtype=out_dtype, outer_nullable=outer_nullable, n_rows=n_rows,
        n_vals=n_vals, L=L, flat_val=flat_all[has_val_slot],
        flat_all=flat_all, has_val_slot=has_val_slot, row_valid=row_valid,
        lengths=lengths, idx_runs=idx_runs.table() if any_dict else None,
        idx_packed=bytes(idx_packed), dict_np=dict_np if any_dict else None,
        plain_np=plain_np)


def _decode_list_plan(lp: ListPlan, cap: int, device,
                      copy_stream=None) -> DeviceColumn:
    """Decode a list plan: its host arrays upload together (on the card
    through one pinned stage on ``copy_stream``), then the device half."""
    dev = torch.device(device)
    arrays = _list_host(lp, cap)
    return _list_device(lp, upload_arrays(arrays, dev, copy_stream), cap,
                        dev)


def _list_host(lp: ListPlan, cap: int) -> dict:
    """The host arrays of a list decode: the dictionary indices' run
    matrix and bytes (or the PLAIN values), the element scatter targets
    and the row validity and lengths."""
    L = lp.L
    el_np = lp.out_dtype.element.to_np()
    arrays = {}
    if lp.idx_runs is not None:
        arrays.update({f"idx.{k}": a for k, a in
                       _runs_arrays(lp.idx_runs, lp.idx_packed).items()})
        arrays["dict"] = lp.dict_np.astype(el_np)
    else:
        arrays["plain"] = _pad_np(lp.plain_np.astype(el_np),
                                  bucket_rows(max(lp.n_vals, 1)))
    fcap = bucket_rows(max(lp.flat_val.shape[0], 1))
    arrays["fidx"] = _pad_np(lp.flat_val.astype(np.int64), fcap,
                             fill=cap * L)
    acap = bucket_rows(max(lp.flat_all.shape[0], 1))
    arrays["aidx"] = _pad_np(lp.flat_all.astype(np.int64), acap,
                             fill=cap * L)
    arrays["ev_src"] = _pad_np(lp.has_val_slot.astype(bool), acap)
    n_rows = lp.n_rows
    validity = np.zeros(cap, dtype=bool)
    validity[:n_rows] = lp.row_valid
    lens_full = np.zeros(cap, dtype=np.int32)
    lens_full[:n_rows] = np.where(lp.row_valid, lp.lengths[:n_rows], 0)
    arrays["validity"] = validity
    arrays["lengths"] = lens_full
    return arrays


def _list_device(lp: ListPlan, t: dict, cap: int,
                 dev: torch.device) -> DeviceColumn:
    """Device half of the list decode: element values (dictionary
    indices through the window-gather expansion, as in the reference),
    then the scatters into the ``[cap, L]`` data and element-validity
    matrices."""
    L = lp.L
    el_t = lp.out_dtype.element.to_torch()
    vcap = bucket_rows(max(lp.n_vals, 1))
    if lp.idx_runs is not None:
        d = _sub(t, "idx")
        indices = expand_runs_matrix(d["runs_mat"], d["packed"], vcap)
        d_vals = t["dict"]
        vals = d_vals[torch.clamp(indices, 0, d_vals.shape[0] - 1).long()]
    else:
        vals = t["plain"]

    nv = lp.flat_val.shape[0]
    fcap = t["fidx"].shape[0]
    src = vals[:fcap] if vals.shape[0] >= fcap else torch.cat(
        [vals, vals.new_zeros(fcap - vals.shape[0])])
    src = torch.where(torch.arange(fcap, device=dev) < nv, src,
                      torch.zeros((), dtype=el_t, device=dev))
    data = scatter_drop(t["fidx"], src, cap * L).reshape(cap, L)
    ev = scatter_drop(t["aidx"], t["ev_src"], cap * L).reshape(cap, L)
    return DeviceColumn(lp.out_dtype, data, t["validity"], t["lengths"], ev)


def decode_list_chunk(chunk: pm.ChunkPages, out_dtype: dt.DType, cap: int,
                      outer_nullable: bool, device="cuda") -> DeviceColumn:
    """Decode a list<primitive> column chunk (max_rep == 1) on
    ``device``."""
    return _decode_list_plan(_plan_list_chunk(chunk, out_dtype,
                                              outer_nullable),
                             cap, resolve_device(device))
