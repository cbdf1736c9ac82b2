"""Device-side Parquet write encode: the mirror image of the device decode.

Ported from ``spark_rapids_tpu/io/parquet_encode.py``.  The O(rows) data
movement -- per-column null compaction of the values to the front --
runs on the device as composed torch ops (:func:`_compact_for_encode`;
the reference composes XLA ops there and has no Pallas kernel), and the
whole result crosses to the host in the engine's packed download
(columnar/batch._dispatch_pack).  The byte work (bit-packed levels,
varint/thrift headers, page compression) runs in vectorized numpy and
Arrow's codecs on the host.  The output is a standard Parquet v1 file:
one row group per batch, one PLAIN data page per column, RLE/bit-packed
definition levels, snappy/zstd/uncompressed codecs, byte for byte the
reference's blob for the same batch and codec.

Coverage: BOOLEAN/INT32/INT64/FLOAT/DOUBLE/BYTE_ARRAY (strings), DATE32
and TIMESTAMP_US logical annotations.  Lists and structs fall back to
the host Arrow writer (io/writers.py).
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   _dispatch_pack,
                                                   _download_all,
                                                   _download_batch,
                                                   scatter_drop)

# parquet.thrift enums
_TYPE = {"BOOLEAN": 0, "INT32": 1, "INT64": 2, "FLOAT": 4, "DOUBLE": 5,
         "BYTE_ARRAY": 6}
_ENC_PLAIN = 0
_ENC_RLE = 3
_CODEC = {"none": 0, "uncompressed": 0, "snappy": 1, "gzip": 2,
          "zstd": 6}
_CT_UTF8 = 0
_CT_DATE = 6
_CT_TS_MICROS = 10


# ---------------------------------------------------------------------------
# Thrift compact-protocol writer (mirror of parquet_meta._Reader)
# ---------------------------------------------------------------------------

_CT_BOOL_TRUE = 1
_CT_BOOL_FALSE = 2
_CT_I32 = 5
_CT_I64 = 6
_CT_BINARY = 8
_CT_LIST = 9
_CT_STRUCT = 12


class _TW:
    """Just enough TCompactProtocol writing for Parquet metadata."""

    def __init__(self):
        self.out = bytearray()
        self._last_fid = [0]

    def _varint(self, v: int) -> None:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def _zigzag(self, v: int) -> None:
        self._varint((v << 1) ^ (v >> 63))

    def _field(self, fid: int, ctype: int) -> None:
        delta = fid - self._last_fid[-1]
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ctype)
        else:
            self.out.append(ctype)
            self._varint((fid << 1) ^ (fid >> 15))
        self._last_fid[-1] = fid

    def i32(self, fid: int, v: int) -> None:
        self._field(fid, _CT_I32)
        self._zigzag(v)

    def i64(self, fid: int, v: int) -> None:
        self._field(fid, _CT_I64)
        self._zigzag(v)

    def string(self, fid: int, s: str) -> None:
        self._field(fid, _CT_BINARY)
        b = s.encode("utf-8")
        self._varint(len(b))
        self.out += b

    def struct_begin(self, fid: int) -> None:
        self._field(fid, _CT_STRUCT)
        self._last_fid.append(0)

    def struct_end(self) -> None:
        self.out.append(0)
        self._last_fid.pop()

    def list_begin(self, fid: int, size: int, elem_ctype: int) -> None:
        self._field(fid, _CT_LIST)
        if size < 15:
            self.out.append((size << 4) | elem_ctype)
        else:
            self.out.append(0xF0 | elem_ctype)
            self._varint(size)

    def elem_i32(self, v: int) -> None:
        self._zigzag(v)

    def elem_string(self, s: str) -> None:
        b = s.encode("utf-8")
        self._varint(len(b))
        self.out += b

    def elem_struct_begin(self) -> None:
        self._last_fid.append(0)

    def elem_struct_end(self) -> None:
        self.out.append(0)
        self._last_fid.pop()


def _page_header(n_values: int, uncompressed: int,
                 compressed: int) -> bytes:
    w = _TW()
    w.i32(1, 0)                  # type = DATA_PAGE
    w.i32(2, uncompressed)
    w.i32(3, compressed)
    w.struct_begin(5)            # data_page_header
    w.i32(1, n_values)
    w.i32(2, _ENC_PLAIN)         # encoding
    w.i32(3, _ENC_RLE)           # definition_level_encoding
    w.i32(4, _ENC_RLE)           # repetition_level_encoding
    w.struct_end()
    w.out.append(0)              # end PageHeader struct
    return bytes(w.out)


def _schema_elements(w: _TW, fields: Sequence[Tuple[str, dt.DType]]
                     ) -> None:
    w.list_begin(2, len(fields) + 1, _CT_STRUCT)
    # root
    w.elem_struct_begin()
    w.string(4, "schema")
    w.i32(5, len(fields))
    w.elem_struct_end()
    for name, d in fields:
        w.elem_struct_begin()
        w.i32(1, _TYPE[_physical(d)])
        w.i32(3, 1)              # repetition = OPTIONAL
        w.string(4, name)
        ct = _converted(d)
        if ct is not None:
            w.i32(6, ct)
        w.elem_struct_end()


def _physical(d: dt.DType) -> str:
    if d.is_string:
        return "BYTE_ARRAY"
    if d.is_bool:
        return "BOOLEAN"
    if d.id == dt.TypeId.DATE32:
        return "INT32"
    if d.id == dt.TypeId.TIMESTAMP_US:
        return "INT64"
    npd = d.to_np()
    return {np.dtype("int32"): "INT32", np.dtype("int64"): "INT64",
            np.dtype("float32"): "FLOAT",
            np.dtype("float64"): "DOUBLE"}[np.dtype(npd)]


def _converted(d: dt.DType) -> Optional[int]:
    if d.is_string:
        return _CT_UTF8
    if d.id == dt.TypeId.DATE32:
        return _CT_DATE
    if d.id == dt.TypeId.TIMESTAMP_US:
        return _CT_TS_MICROS
    return None


def supported(schema_fields) -> bool:
    try:
        for f in schema_fields:
            _physical(f.dtype)
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# Device kernel: per-column null compaction
# ---------------------------------------------------------------------------

def _compact_for_encode(batch: DeviceBatch) -> DeviceBatch:
    """Per column: move the non-null values to the front (cumsum and a
    scatter whose dropped rows land past the capacity), keeping the
    ORIGINAL validity (the host derives the def levels from it).  String
    columns scatter whole ``[cap, width]`` rows with their lengths.  The
    result rides the engine's packed download."""
    cap = batch.capacity
    exists = batch.row_mask()
    cols = []
    for c in batch.columns:
        keep = c.validity & exists
        dest = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0) - 1,
                           cap)
        data = scatter_drop(dest, c.data, cap)
        lengths = None
        if c.lengths is not None:
            lengths = scatter_drop(
                dest, torch.where(keep, c.lengths, 0).to(c.lengths.dtype),
                cap)
        cols.append(DeviceColumn(c.dtype, data, keep, lengths,
                                 c.elem_validity))
    return DeviceBatch(batch.names, cols, batch.num_rows, batch.device)


def _download_compacted(batch: DeviceBatch, copy_stream=None):
    """(num_rows, host columns) of the compacted batch: one packed copy
    per wire dtype (columnar/batch._dispatch_pack), one wait."""
    comp = _compact_for_encode(batch)
    layout, packed = _dispatch_pack(comp)
    (host,) = _download_all([packed], copy_stream)
    return _download_batch(comp, layout, host)


# ---------------------------------------------------------------------------
# Host assembly
# ---------------------------------------------------------------------------

def _rle_def_levels(valid: np.ndarray) -> bytes:
    """max_def=1 definition levels, RLE/bit-packed hybrid, with the
    4-byte length prefix of DataPage v1."""
    n = valid.shape[0]
    if n and valid.all():
        # one RLE run covering all n values (varint header + level byte)
        out = bytearray()
        h = n << 1
        while True:
            b = h & 0x7F
            h >>= 7
            if h:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        out.append(1)            # the repeated level value (1 byte, w=1)
        body = bytes(out)
    else:
        groups = (n + 7) // 8
        out = bytearray()
        h = (groups << 1) | 1
        while True:
            b = h & 0x7F
            h >>= 7
            if h:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        out += np.packbits(valid, bitorder="little").tobytes()
        body = bytes(out)
    return struct.pack("<I", len(body)) + body


def _plain_values(d: dt.DType, data: np.ndarray, lengths, n_valid: int
                  ) -> bytes:
    if d.is_string:
        # each value: its 4-byte little-endian length, then its bytes.  One
        # row of a [n, 4 + width] matrix per value, read out through the
        # mask of its 4 + len leading bytes (the reference scatters every
        # byte through an index array; the bytes are the same)
        lens = lengths[:n_valid].astype(np.int64)
        width = data.shape[1]
        mat = np.empty((n_valid, 4 + width), dtype=np.uint8)
        mat[:, :4] = lens.astype("<u4").view(np.uint8).reshape(n_valid, 4)
        mat[:, 4:] = data[:n_valid]
        mask = np.arange(4 + width)[None, :] < (lens + 4)[:, None]
        return mat[mask].tobytes()
    if d.is_bool:
        return np.packbits(data[:n_valid].astype(bool),
                           bitorder="little").tobytes()
    npd = np.dtype(d.to_np()).newbyteorder("<")
    return np.ascontiguousarray(data[:n_valid]).astype(
        npd, copy=False).tobytes()


def _compress(codec: str, payload: bytes) -> bytes:
    if codec in ("none", "uncompressed"):
        return payload
    return pa.Codec(codec if codec != "gzip" else "gzip"
                    ).compress(payload, asbytes=True)


# rows from which a batch's columns assemble on a pool of threads (numpy's
# large copies and Arrow's codecs release the GIL)
_THREADED_ROWS = 1 << 16


def map_columns(fn, dtypes, host_cols, n: int) -> list:
    """``[fn(dtype, host column) ...]`` in column order, on up to 8
    threads when the batch holds ``_THREADED_ROWS`` rows or more."""
    if n < _THREADED_ROWS or len(host_cols) < 2:
        return [fn(d, c) for d, c in zip(dtypes, host_cols)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, len(host_cols))) as pool:
        return list(pool.map(fn, dtypes, host_cols))


def encode_batch(batch: DeviceBatch, codec: str = "snappy",
                 copy_stream=None) -> bytes:
    """Encode one DeviceBatch into a complete single-row-group Parquet
    file blob (device compaction + one packed download + host page
    assembly).  ``copy_stream`` is the session's
    ``columnar/transfer.CopyStream`` on the card (a fresh one when
    None)."""
    n, host_cols = _download_compacted(batch, copy_stream)

    fields = [(name, c.dtype) for name, c in zip(batch.names,
                                                 batch.columns)]

    def page(d, col):
        data, validity, lengths, _ev = col
        valid = validity[:n]
        n_valid = int(valid.sum())
        payload = _rle_def_levels(valid) + \
            _plain_values(d, data, lengths, n_valid)
        return payload, _compress(codec, payload)

    pages = map_columns(page, [d for _, d in fields], host_cols, n)
    out = bytearray(b"PAR1")
    col_meta = []
    for (name, d), (payload, compressed) in zip(fields, pages):
        header = _page_header(n, len(payload), len(compressed))
        offset = len(out)
        out += header
        out += compressed
        col_meta.append(dict(
            name=name, dtype=d, offset=offset, num_values=n,
            uncompressed=len(payload) + len(header),
            compressed=len(compressed) + len(header)))

    # footer
    w = _TW()
    w.elem_struct_begin()
    w.i32(1, 1)                               # version
    _schema_elements(w, fields)
    w.i64(3, n)                               # num_rows
    w.list_begin(4, 1, _CT_STRUCT)            # row_groups
    w.elem_struct_begin()
    w.list_begin(1, len(col_meta), _CT_STRUCT)   # columns
    for cm in col_meta:
        w.elem_struct_begin()
        w.i64(2, cm["offset"])                # file_offset
        w.struct_begin(3)                     # meta_data
        w.i32(1, _TYPE[_physical(cm["dtype"])])
        w.list_begin(2, 2, _CT_I32)           # encodings
        w.elem_i32(_ENC_PLAIN)
        w.elem_i32(_ENC_RLE)
        w.list_begin(3, 1, _CT_BINARY)        # path_in_schema
        w.elem_string(cm["name"])
        w.i32(4, _CODEC[codec])
        w.i64(5, cm["num_values"])
        w.i64(6, cm["uncompressed"])
        w.i64(7, cm["compressed"])
        w.i64(9, cm["offset"])                # data_page_offset
        w.struct_end()
        w.elem_struct_end()
    w.i64(2, sum(cm["uncompressed"] for cm in col_meta))
    w.i64(3, n)                               # row group num_rows
    w.elem_struct_end()
    w.string(6, "spark-rapids-tpu parquet encoder")
    w.elem_struct_end()

    footer = bytes(w.out)
    out += footer
    out += struct.pack("<I", len(footer))
    out += b"PAR1"
    return bytes(out)
