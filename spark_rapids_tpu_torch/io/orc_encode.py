"""Device-side ORC write encode.

Ported from ``spark_rapids_tpu/io/orc_encode.py``, with the same split as
the Parquet encoder (io/parquet_encode.py): the per-column null
compaction runs on the device (``parquet_encode._compact_for_encode``)
and crosses to the host in the engine's packed download; the RLEv1
varints and the protobuf metadata are assembled in vectorized numpy on
the host, byte for byte the reference's blob for the same batch.

The output is a standard ORC file (version 0.12, compression NONE,
rowIndexStride=0 so no row-index streams are required): one stripe per
batch, DIRECT column encodings, PRESENT byte-RLE bitmaps, RLEv1 integer
streams.

Coverage: BOOLEAN/INT/LONG/FLOAT/DOUBLE/STRING/DATE.  Timestamps, lists
and structs fall back to the host Arrow writer (io/writers.py).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
from spark_rapids_tpu_torch.io.parquet_encode import (_download_compacted,
                                                     map_columns)

# orc_proto.proto enums
_KIND = {"boolean": 0, "byte": 1, "short": 2, "int": 3, "long": 4,
         "float": 5, "double": 6, "string": 7, "date": 15,
         "struct": 12}
_STREAM_PRESENT = 0
_STREAM_DATA = 1
_STREAM_LENGTH = 2
_ENC_DIRECT = 0
_COMP_NONE = 0


def _orc_kind(d: dt.DType) -> str:
    if d.is_string:
        return "string"
    if d.is_bool:
        return "boolean"
    if d.id == dt.TypeId.DATE32:
        return "date"
    if d.id == dt.TypeId.TIMESTAMP_US:
        # ORC timestamps are (seconds-from-2015, nanos) stream pairs —
        # host Arrow writer handles them
        raise ValueError("timestamp: host fallback")
    npd = np.dtype(d.to_np())
    return {np.dtype("int32"): "int", np.dtype("int64"): "long",
            np.dtype("float32"): "float",
            np.dtype("float64"): "double"}[npd]


def supported(schema_fields) -> bool:
    try:
        for f in schema_fields:
            _orc_kind(f.dtype)
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# Protobuf writer (wire format: varint tags, length-delimited messages)
# ---------------------------------------------------------------------------

class _PB:
    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> "_PB":
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return self

    def field_varint(self, fid: int, v: int) -> "_PB":
        self.varint((fid << 3) | 0)
        self.varint(v)
        return self

    def field_bytes(self, fid: int, b: bytes) -> "_PB":
        self.varint((fid << 3) | 2)
        self.varint(len(b))
        self.out += b
        return self

    def field_msg(self, fid: int, msg: "_PB") -> "_PB":
        return self.field_bytes(fid, bytes(msg.out))

    def field_packed_u32(self, fid: int, vals: Sequence[int]) -> "_PB":
        body = _PB()
        for v in vals:
            body.varint(v)
        return self.field_bytes(fid, bytes(body.out))


# ---------------------------------------------------------------------------
# ORC stream encoders (vectorized numpy)
# ---------------------------------------------------------------------------

def _byte_rle_literal(data: bytes) -> bytes:
    """Byte-RLE, literal runs only: header (256 - n) then n raw bytes,
    n <= 128.  Used for PRESENT bitmaps and boolean DATA."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        take = min(128, n - pos)
        out.append(256 - take)
        out += data[pos:pos + take]
        pos += take
    return bytes(out)


def _zigzag64(v: np.ndarray) -> np.ndarray:
    x = v.astype(np.int64)
    return ((x << 1) ^ (x >> 63)).astype(np.uint64)


def _varint_matrix(v: np.ndarray, lead: int = 0):
    """Vectorized base-128 varint encoding of uint64 values: a
    [n, lead + max bytes] uint8 matrix whose row i holds value i's groups
    of 7 bits from column ``lead`` on, and the mask of the bytes to read
    out of it in order (each row's ``nb`` bytes; the ``lead`` columns are
    left to the caller, masked out)."""
    nb = np.ones(v.shape, dtype=np.int64)
    for k in range(1, 10):
        ge = v >= np.uint64(1 << (7 * k))
        if not ge.any():
            break
        nb += ge
    max_nb = int(nb.max())
    mat = np.zeros((v.shape[0], lead + max_nb), dtype=np.uint8)
    for k in range(max_nb):
        mat[:, lead + k] = (((v >> np.uint64(7 * k)) & np.uint64(0x7F))
                            .astype(np.uint8) |
                            ((nb > k + 1).astype(np.uint8) << 7))
    mask = np.zeros(mat.shape, dtype=bool)
    mask[:, lead:] = np.arange(max_nb)[None, :] < nb[:, None]
    return mat, mask


def _varints(vals: np.ndarray) -> bytes:
    """Vectorized base-128 varint encoding of uint64 values."""
    if vals.size == 0:
        return b""
    mat, mask = _varint_matrix(vals.astype(np.uint64))
    return mat[mask].tobytes()


def _rle_v1_literal(vals: np.ndarray, signed: bool) -> bytes:
    """RLEv1, literal runs only: header byte -(n) then n varints, n <=
    128.  One vectorized pass: each run's header rides in a leading
    column of its first value's row (the reference loops over the runs;
    the bytes are the same)."""
    if vals.size == 0:
        return b""
    u = _zigzag64(vals) if signed else vals.astype(np.uint64)
    mat, mask = _varint_matrix(u, lead=1)
    n = u.shape[0]
    firsts = np.arange(0, n, 128)
    mat[firsts, 0] = (256 - np.minimum(128, n - firsts)).astype(np.uint8)
    mask[firsts, 0] = True
    return mat[mask].tobytes()


def _present_stream(valid: np.ndarray) -> bytes:
    bits = np.packbits(valid.astype(bool))      # MSB-first per ORC spec
    return _byte_rle_literal(bits.tobytes())


# ---------------------------------------------------------------------------
# File assembly
# ---------------------------------------------------------------------------

def encode_batch(batch: DeviceBatch, copy_stream=None) -> bytes:
    """Encode one DeviceBatch into a complete one-stripe ORC file blob
    (device compaction + one packed download + host stream/protobuf
    assembly)."""
    n, host_cols = _download_compacted(batch, copy_stream)

    fields = [(name, c.dtype) for name, c in zip(batch.names,
                                                 batch.columns)]
    out = bytearray(b"ORC")
    stripe_start = len(out)

    def column_streams(d, col):
        """[(stream kind, bytes), ...] of one column."""
        col_data, validity, lengths, _ev = col
        valid = validity[:n].astype(bool)
        n_valid = int(valid.sum())
        got = []
        if n_valid < n:
            got.append((_STREAM_PRESENT, _present_stream(valid)))
        kind = _orc_kind(d)
        if kind == "string":
            lens = lengths[:n_valid].astype(np.int64)
            mask = np.arange(col_data.shape[1])[None, :] < lens[:, None]
            got.append((_STREAM_DATA, np.ascontiguousarray(
                col_data[:n_valid])[mask].tobytes()))
            got.append((_STREAM_LENGTH, _rle_v1_literal(lens,
                                                         signed=False)))
        elif kind == "boolean":
            bits = np.packbits(col_data[:n_valid].astype(bool))
            got.append((_STREAM_DATA, _byte_rle_literal(bits.tobytes())))
        elif kind in ("int", "long", "date"):
            got.append((_STREAM_DATA, _rle_v1_literal(
                col_data[:n_valid].astype(np.int64), signed=True)))
        else:   # float / double: IEEE little-endian raw
            npd = np.dtype(d.to_np()).newbyteorder("<")
            got.append((_STREAM_DATA, np.ascontiguousarray(
                col_data[:n_valid]).astype(npd, copy=False).tobytes()))
        return got

    streams: List[Tuple[int, int, int]] = []   # (column_id, kind, length)
    data = bytearray()
    per_column = map_columns(column_streams, [d for _, d in fields],
                             host_cols, n)
    for ci, got in enumerate(per_column):
        for skind, b in got:
            streams.append((ci + 1, skind, len(b)))  # 0 is the root
            data += b

    out += data

    # stripe footer
    sf = _PB()
    for col, skind, length in streams:
        s = _PB()
        s.field_varint(1, skind)
        s.field_varint(2, col)
        s.field_varint(3, length)
        sf.field_msg(1, s)
    for _ in range(len(fields) + 1):           # root + each column
        enc = _PB()
        enc.field_varint(1, _ENC_DIRECT)
        sf.field_msg(2, enc)
    sf_bytes = bytes(sf.out)
    out += sf_bytes

    data_len = len(data)
    stripe_footer_len = len(sf_bytes)

    # file footer
    ft = _PB()
    ft.field_varint(1, 3)                      # headerLength ("ORC")
    ft.field_varint(2, len(out))               # contentLength
    stripe = _PB()
    stripe.field_varint(1, stripe_start)       # offset
    stripe.field_varint(2, 0)                  # indexLength
    stripe.field_varint(3, data_len)
    stripe.field_varint(4, stripe_footer_len)
    stripe.field_varint(5, n)                  # numberOfRows
    ft.field_msg(3, stripe)
    # types: root struct + children
    root = _PB()
    root.field_varint(1, _KIND["struct"])
    root.field_packed_u32(2, list(range(1, len(fields) + 1)))
    for name, _d in fields:
        root.field_bytes(3, name.encode("utf-8"))
    ft.field_msg(4, root)
    for _name, d in fields:
        tp = _PB()
        tp.field_varint(1, _KIND[_orc_kind(d)])
        ft.field_msg(4, tp)
    ft.field_varint(6, n)                      # numberOfRows
    ft.field_varint(8, 0)                      # rowIndexStride: no index
    ft_bytes = bytes(ft.out)
    out += ft_bytes

    # postscript
    ps = _PB()
    ps.field_varint(1, len(ft_bytes))          # footerLength
    ps.field_varint(2, _COMP_NONE)
    ps.field_varint(3, 0)                      # compressionBlockSize
    ps.field_packed_u32(4, [0, 12])            # version
    ps.field_varint(5, 0)                      # metadataLength
    ps.field_varint(6, 1)                      # writerVersion
    ps.field_bytes(8000, b"ORC")               # magic
    ps_bytes = bytes(ps.out)
    out += ps_bytes
    out.append(len(ps_bytes))
    return bytes(out)
