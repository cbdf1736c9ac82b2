"""Parquet host planning: page runs walked on the host, decoded on device.

Ported from ``spark_rapids_tpu/io/device_parquet.py``, the host half only:
the CPU walks page headers and RLE/bit-packed run boundaries — O(pages +
runs), not O(values) — into a :class:`ChunkPlan` per column chunk, which
the fused whole-batch decode (io/parquet_fused.py) uploads packed and
expands on the device.

Coverage: PLAIN + PLAIN_/RLE_DICTIONARY for INT32/INT64/FLOAT/DOUBLE/
BOOLEAN, dictionary-encoded BYTE_ARRAY (strings), flat schemas
(max_rep == 0, max_def <= 1), data pages v1 + v2, any Arrow-supported page
codec (host decompress).  Anything else raises :class:`UnsupportedChunk`
and the column falls back to Arrow host decode *per column*.

The reference's per-column device decode (``expand_runs_matrix``,
``decode_plan``, ``decode_row_group``) and the list decode are not ported
yet: they need the ``expand_stream`` kernel.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.io import parquet_meta as pm

# the fused decode (io/parquet_fused.py and kernels/decode.py) unpacks any
# width up to a full 32-bit index word
_MAX_W_DENSE = 32

# ---------------------------------------------------------------------------
# Host side: run walking (O(runs), not O(values))
# ---------------------------------------------------------------------------

@dataclass
class RunTable:
    """Hybrid RLE/bit-pack runs, concatenated across pages of a chunk.

    `bit_base` indexes into the shared `packed` byte buffer for bit-packed
    runs; `value` holds the repeated value for RLE runs."""

    counts: List[int]
    is_rle: List[bool]
    values: List[int]
    bit_bases: List[int]
    widths: List[int]

    @staticmethod
    def empty() -> "RunTable":
        return RunTable([], [], [], [], [])

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


def walk_hybrid(buf: bytes, start: int, end: int, w: int,
                packed: bytearray, runs: RunTable,
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


def nonnull_count(runs: RunTable, packed: bytes, lo_run: int, hi_run: int,
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
    the device expansion kernels need, produced by one O(pages+runs)
    host walk, consumed by the fused whole-batch decode
    (io/parquet_fused.py)."""
    n_rows: int
    nullable: bool
    out_dtype: dt.DType
    mode: str                      # 'dict' | 'dict_str' | 'plain' | 'bool'
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
    def_runs = RunTable.empty()
    def_packed = bytearray()
    idx_runs = RunTable.empty()
    idx_packed = bytearray()
    plain_parts: List[bytes] = []   # PLAIN value byte regions
    bool_runs = RunTable.empty()    # BOOLEAN PLAIN == w=1 bit-pack runs
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
        def_runs=def_runs, def_packed=bytes(def_packed),
        val_runs=idx_runs if any_dict else bool_runs,
        val_packed=bytes(idx_packed) if any_dict else bytes(bool_packed),
        plain_np=plain_np, dict_np=dict_np, dict_lens=dict_lens,
        page_segs=page_segs)


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



def _cast_one(t: pa.Table, f) -> pa.Table:
    col = t.column(0).cast(f.dtype.to_arrow())
    return pa.Table.from_arrays(
        [col], schema=pa.schema([pa.field(f.name, f.dtype.to_arrow(),
                                          f.nullable)]))
