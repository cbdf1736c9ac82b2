"""Host shuffle serialization: Arrow IPC stream + compression codec SPI.

This is the default-path shuffle currency — the role the reference's
``GpuColumnarBatchSerializer`` over ``JCudfSerialization`` plays for its
stock sort-shuffle data plane (reference:
GpuColumnarBatchSerializer.scala:95-265, ShuffleCoalesceExec.scala:199),
with the JCudf host wire format replaced by Arrow IPC (SURVEY.md §2h).

The codec SPI mirrors the reference's ``TableCompressionCodec`` registry
(reference: TableCompressionCodec.scala:41-372) with its nvcomp GPU-LZ4
implementation (NvcompLZ4CompressionCodec.scala) replaced by Arrow-native
buffer compression: shuffle bytes move host-side here, so the codec runs
where the data is. "copy" (no-op) matches the reference's
CopyCompressionCodec test codec.

The port's copy of ``spark_rapids_tpu/shuffle/serializer.py``: it imports
nothing of the engine, so only this note differs.
"""

from __future__ import annotations

import io
from typing import Dict, Optional

import pyarrow as pa


class TableCompressionCodec:
    """SPI: compress/decompress a serialized table partition."""

    name: str = "copy"

    def ipc_compression(self) -> Optional[str]:
        """Arrow IPC body-buffer compression name, or None."""
        return None


class CopyCompressionCodec(TableCompressionCodec):
    name = "copy"


class Lz4CompressionCodec(TableCompressionCodec):
    name = "lz4"

    def ipc_compression(self) -> Optional[str]:
        return "lz4"


class ZstdCompressionCodec(TableCompressionCodec):
    name = "zstd"

    def ipc_compression(self) -> Optional[str]:
        return "zstd"


class ZlibCompressionCodec(TableCompressionCodec):
    """Accepted everywhere the conf reaches so ``codec=zlib`` (the
    TCP wire leg's stdlib-only option) never crashes the block-store
    or CPU-fallback paths — but Arrow IPC has no zlib buffer
    compression, so blocks serialize uncompressed here; only the
    per-frame DATA wire leg (tcp.wire_codec) actually deflates."""

    name = "zlib"


_CODECS: Dict[str, TableCompressionCodec] = {}


def register_codec(codec: TableCompressionCodec) -> None:
    _CODECS[codec.name] = codec


def get_codec(name: str) -> TableCompressionCodec:
    try:
        return _CODECS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown shuffle compression codec '{name}'; "
            f"known: {sorted(_CODECS)}") from None


register_codec(CopyCompressionCodec())
_CODECS["none"] = _CODECS["copy"]  # conf alias
register_codec(Lz4CompressionCodec())
register_codec(ZstdCompressionCodec())
register_codec(ZlibCompressionCodec())


def serialize_table(table: pa.Table, codec: TableCompressionCodec) -> bytes:
    """One shuffle block: an Arrow IPC stream holding the partition slice."""
    sink = io.BytesIO()
    opts = pa.ipc.IpcWriteOptions(compression=codec.ipc_compression())
    with pa.ipc.new_stream(sink, table.schema, options=opts) as w:
        w.write_table(table)
    return sink.getvalue()


def deserialize_table(data: bytes) -> pa.Table:
    with pa.ipc.open_stream(pa.py_buffer(data)) as r:
        return r.read_all()
