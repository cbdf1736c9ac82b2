"""CPU-side Parquet page metadata: footers via Arrow, page headers via a
minimal Thrift compact-protocol reader.

Ported from ``spark_rapids_tpu/io/parquet_meta.py``, which imports no JAX;
the port keeps its own copy.  The reference bills walked bytes to its
``obs`` registry; here they are the plain module counter
:func:`bytes_walked`.

Reference analog: the reference parses footers and clips row groups on CPU
(`GpuParquetFileFilterHandler`, reference: GpuParquetScan.scala:239,456-620),
then hands raw page bytes to the device decoder (`Table.readParquet`,
GpuParquetScan.scala:1022).  This module is that CPU half for the TPU build:
it walks each column chunk's page stream and returns page descriptors +
payload byte ranges that `io/device_parquet.py` decodes in HBM.

Only the PageHeader struct needs Thrift parsing (chunk offsets, types,
codecs all come from pyarrow's footer metadata), so the reader below
implements just enough of TCompactProtocol: varints, zigzag, field headers,
and recursive skip of unknown fields.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import pyarrow.parquet as papq

# page-walk probe: every chunk whose page headers are actually walked
# bumps this counter, so tests (and the scan-plan cache acceptance
# criterion) can assert a warm scan performs ZERO walks
_WALK_LOCK = threading.Lock()
_WALK_COUNT = 0
_BYTES_WALKED = 0


def walk_count() -> int:
    with _WALK_LOCK:
        return _WALK_COUNT


def bytes_walked() -> int:
    """Column-chunk bytes read by page walks in this process."""
    with _WALK_LOCK:
        return _BYTES_WALKED


def _note_walk(nbytes: int) -> None:
    global _WALK_COUNT, _BYTES_WALKED
    with _WALK_LOCK:
        _WALK_COUNT += 1
        _BYTES_WALKED += nbytes

# Thrift compact type nibbles
_T_BOOL_TRUE = 1
_T_BOOL_FALSE = 2
_T_BYTE = 3
_T_I16 = 4
_T_I32 = 5
_T_I64 = 6
_T_DOUBLE = 7
_T_BINARY = 8
_T_LIST = 9
_T_SET = 10
_T_MAP = 11
_T_STRUCT = 12

# Parquet page types
DATA_PAGE = 0
DICTIONARY_PAGE = 2
DATA_PAGE_V2 = 3

# Parquet encodings
PLAIN = 0
PLAIN_DICTIONARY = 2
RLE = 3
BIT_PACKED = 4
DELTA_BINARY_PACKED = 5
RLE_DICTIONARY = 8
BYTE_STREAM_SPLIT = 9


class _Reader:
    """Cursor over a bytes buffer with Thrift compact primitives."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        result = 0
        shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def skip(self, ttype: int) -> None:
        if ttype in (_T_BOOL_TRUE, _T_BOOL_FALSE):
            return
        if ttype == _T_BYTE:
            self.pos += 1
        elif ttype in (_T_I16, _T_I32, _T_I64):
            self.varint()
        elif ttype == _T_DOUBLE:
            self.pos += 8
        elif ttype == _T_BINARY:
            n = self.varint()
            self.pos += n
        elif ttype in (_T_LIST, _T_SET):
            h = self.byte()
            size = h >> 4
            etype = h & 0x0F
            if size == 15:
                size = self.varint()
            for _ in range(size):
                self.skip(etype)
        elif ttype == _T_MAP:
            size = self.varint()
            if size > 0:
                kv = self.byte()
                for _ in range(size):
                    self.skip(kv >> 4)
                    self.skip(kv & 0x0F)
        elif ttype == _T_STRUCT:
            self.read_struct()
        else:
            raise ValueError(f"unknown thrift type {ttype}")

    def read_struct(self) -> Dict[int, object]:
        """Parse a struct into {field_id: value}; unknown types skipped.

        Values: bools, ints, bytes, nested dicts for structs."""
        out: Dict[int, object] = {}
        fid = 0
        while True:
            b = self.byte()
            if b == 0:
                return out
            delta = b >> 4
            ttype = b & 0x0F
            if delta == 0:
                fid = self.zigzag()
            else:
                fid += delta
            if ttype == _T_BOOL_TRUE:
                out[fid] = True
            elif ttype == _T_BOOL_FALSE:
                out[fid] = False
            elif ttype == _T_BYTE:
                out[fid] = self.byte()
            elif ttype in (_T_I16, _T_I32, _T_I64):
                out[fid] = self.zigzag()
            elif ttype == _T_DOUBLE:
                out[fid] = struct.unpack("<d", self.buf[self.pos:
                                                        self.pos + 8])[0]
                self.pos += 8
            elif ttype == _T_BINARY:
                n = self.varint()
                out[fid] = self.buf[self.pos:self.pos + n]
                self.pos += n
            elif ttype == _T_STRUCT:
                out[fid] = self.read_struct()
            else:
                self.skip(ttype)
        return out


@dataclass
class PageInfo:
    """One page inside a column chunk (offsets relative to chunk bytes)."""

    page_type: int
    num_values: int
    encoding: int
    payload_off: int              # start of (possibly compressed) payload
    compressed_size: int
    uncompressed_size: int
    # v2-only: def levels live *outside* the compressed region
    v2_def_bytes: int = 0
    v2_rep_bytes: int = 0
    v2_num_nulls: int = 0
    v2_num_rows: int = 0
    v2_is_compressed: bool = True


@dataclass
class ChunkPages:
    """All pages of one column chunk + the raw chunk bytes."""

    column: str
    physical_type: str            # INT32/INT64/FLOAT/DOUBLE/BOOLEAN/...
    logical_type: str             # pyarrow's logical-type repr ("" if none)
    codec: str                    # UNCOMPRESSED/SNAPPY/...
    max_def: int                  # 0 = required, 1 = flat optional
    max_rep: int
    num_values: int
    data: bytes                   # raw chunk bytes (headers + payloads)
    dict_page: Optional[PageInfo]
    data_pages: List[PageInfo] = field(default_factory=list)


def parse_page_header(buf: bytes, pos: int) -> Tuple[PageInfo, int]:
    """Parse one PageHeader at `pos`; returns (info, payload_start)."""
    r = _Reader(buf, pos)
    h = r.read_struct()
    ptype = h.get(1)
    uncomp = h.get(2, 0)
    comp = h.get(3, 0)
    if ptype == DATA_PAGE:
        dph = h.get(5) or {}
        info = PageInfo(DATA_PAGE, dph.get(1, 0), dph.get(2, PLAIN),
                        r.pos, comp, uncomp)
    elif ptype == DICTIONARY_PAGE:
        dph = h.get(7) or {}
        info = PageInfo(DICTIONARY_PAGE, dph.get(1, 0),
                        dph.get(2, PLAIN), r.pos, comp, uncomp)
    elif ptype == DATA_PAGE_V2:
        dph = h.get(8) or {}
        info = PageInfo(DATA_PAGE_V2, dph.get(1, 0), dph.get(4, PLAIN),
                        r.pos, comp, uncomp,
                        v2_def_bytes=dph.get(5, 0),
                        v2_rep_bytes=dph.get(6, 0),
                        v2_num_nulls=dph.get(2, 0),
                        v2_num_rows=dph.get(3, 0),
                        v2_is_compressed=dph.get(7, True))
    else:
        # index page etc. — record and let the caller skip it
        info = PageInfo(int(ptype or -1), 0, PLAIN, r.pos, comp, uncomp)
    return info, r.pos


def read_chunk_pages(path: str, row_group: int, col_idx: int,
                    parquet_file: Optional[papq.ParquetFile] = None
                    ) -> ChunkPages:
    """Read one column chunk's raw bytes and index its pages on CPU."""
    pf = parquet_file or papq.ParquetFile(path)
    md = pf.metadata
    cc = md.row_group(row_group).column(col_idx)
    start = cc.dictionary_page_offset
    if start is None or (cc.data_page_offset and
                         cc.data_page_offset < start):
        start = cc.data_page_offset
    total = cc.total_compressed_size
    _note_walk(int(total))
    # byte-walk accounting: global counter + tenant ledger with the
    # same n (prefetch threads carry no token and bill unattributed)
    from spark_rapids_tpu_torch.obs import accounting as _acct
    from spark_rapids_tpu_torch.obs import registry as _obsreg
    _obsreg.get_registry().inc("scan.bytesWalked", int(total))
    _acct.charge("scan.bytesWalked", int(total))
    if isinstance(path, (bytes, bytearray, memoryview)):
        # in-memory parquet blob (cached-batch path)
        data = bytes(path[start:start + total])
    else:
        with open(path, "rb") as f:
            f.seek(start)
            data = f.read(total)

    pq_schema = md.schema
    col_schema = pq_schema.column(col_idx)
    max_def = 1 if col_schema.max_definition_level is None else \
        col_schema.max_definition_level
    max_rep = 0 if col_schema.max_repetition_level is None else \
        col_schema.max_repetition_level

    chunk = ChunkPages(
        column=cc.path_in_schema,
        physical_type=cc.physical_type,
        logical_type=str(col_schema.logical_type or ""),
        codec=cc.compression,
        max_def=max_def,
        max_rep=max_rep,
        num_values=cc.num_values,
        data=data,
        dict_page=None,
    )
    pos = 0
    seen = 0
    while pos < len(data) and seen < cc.num_values:
        info, payload_start = parse_page_header(data, pos)
        pos = payload_start + info.compressed_size
        if info.page_type == DICTIONARY_PAGE:
            chunk.dict_page = info
        elif info.page_type in (DATA_PAGE, DATA_PAGE_V2):
            chunk.data_pages.append(info)
            seen += info.num_values
        # anything else (index pages): skip
    return chunk


def decompress(codec: str, payload: bytes, uncompressed_size: int) -> bytes:
    """Host decompression of one page payload (nvcomp-role on host; device
    codecs aren't available on TPU — see SURVEY.md §2h nvcomp row)."""
    codec = codec.upper()
    if codec == "UNCOMPRESSED":
        return payload
    import pyarrow as pa
    return pa.Codec(codec.lower()).decompress(
        payload, decompressed_size=uncompressed_size).to_pybytes()
