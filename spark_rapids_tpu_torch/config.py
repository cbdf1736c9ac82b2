"""Typed configuration registry: the keys the port reads so far.

Ported from ``spark_rapids_tpu/config.py``.  Keys keep their reference
names (``spark.rapids.tpu.*``), defaults and types, so one conf dict
drives both packages in a parity test.  Keys the port does not read yet
are absent from this registry and pass through unread.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

_REGISTRY: Dict[str, "ConfEntry"] = {}
_REGISTRY_LOCK = threading.Lock()


@dataclass(frozen=True)
class ConfEntry:
    """One typed configuration key with default + documentation."""

    key: str
    default: Any
    doc: str
    value_type: type

    def get(self, conf: "RapidsTpuConf") -> Any:
        raw = conf._settings.get(self.key, self.default)
        if raw is None:
            return None
        if self.value_type is bool and isinstance(raw, str):
            return raw.strip().lower() in ("true", "1", "yes")
        if self.value_type in (int, float) and isinstance(raw, str):
            return self.value_type(raw)
        return raw


def _register(entry: ConfEntry) -> ConfEntry:
    with _REGISTRY_LOCK:
        if entry.key in _REGISTRY:
            raise ValueError(f"duplicate conf key {entry.key}")
        _REGISTRY[entry.key] = entry
    return entry


def conf(key: str, default: Any, doc: str,
         value_type: type = str) -> ConfEntry:
    return _register(ConfEntry(key=key, default=default, doc=doc,
                               value_type=value_type))


KERNEL_BACKEND = conf(
    "spark.rapids.tpu.kernel.backend", "pallas",
    "Kernel backend of the reference ('pallas' or 'xla').  The port "
    "validates the value and does not act on it: a CUDA tensor always "
    "runs the hand-written kernel, a CPU tensor its plain torch "
    "version.")

KERNEL_ABI_ENABLED = conf(
    "spark.rapids.tpu.kernel.abi.enabled", True,
    "Shape-erased kernel ABI (exec/kernel_abi.py): canonical positional "
    "column names, coarse vbits hint buckets and capacity tiers.", bool)

KERNEL_ABI_TIER_STRIDE = conf(
    "spark.rapids.tpu.kernel.abi.tierStride", 2,
    "Row-capacity tier ladder stride: capacities quantize to every "
    "2^stride-th power-of-two rung (default tiers 16, 64, 256, ...).", int)

KERNEL_ABI_WIDTH_STRIDE = conf(
    "spark.rapids.tpu.kernel.abi.widthStride", 2,
    "String/list max-width tier ladder stride (default tiers 1, 4, 16, "
    "64, ...).", int)

KERNEL_ABI_BUCKET_HINTS = conf(
    "spark.rapids.tpu.kernel.abi.bucketHints", True,
    "Re-bucket DeviceColumn.vbits value-range hints to {16, 32, 56}.",
    bool)

MAX_READER_BATCH_SIZE_ROWS = conf(
    "spark.rapids.tpu.sql.reader.batchSizeRows", 1 << 21,
    "Max rows a file reader emits per batch. (reference: RapidsConf.scala:378)",
    int)

MAX_READER_BATCH_SIZE_BYTES = conf(
    "spark.rapids.tpu.sql.reader.batchSizeBytes", 2 << 30,
    "Max bytes a file reader emits per batch.", int)

PARQUET_FUSED_DECODE = conf(
    "spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled", True,
    "Decode all columns of all coalesced row groups of a scan batch in "
    "one fused pass (io/parquet_fused.py).  The port has no per-column "
    "decode yet: with this off, the Parquet scan raises "
    "NotImplementedError.", bool)

SCAN_HOST_PREP_THREADS = conf(
    "spark.rapids.tpu.sql.scan.hostPrep.threads", 4,
    "Thread-pool size for parallel scan host prep: page-header and RLE "
    "run-boundary walks across (column, row-group) pairs run "
    "concurrently instead of sequentially (page reads and codec "
    "decompression release the GIL). 1 disables the pool.", int)


class RapidsTpuConf:
    """Accessor over a settings map."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings: Dict[str, Any] = dict(settings or {})

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self)


def configure(settings) -> RapidsTpuConf:
    """Apply a conf (dict or :class:`RapidsTpuConf`) to the process-wide
    knobs the port reads: the kernel-backend validation and the kernel
    ABI ladders.  Last call wins, as with the reference's session init."""
    from spark_rapids_tpu_torch.exec import kernel_abi
    from spark_rapids_tpu_torch.kernels import backend
    c = settings if isinstance(settings, RapidsTpuConf) \
        else RapidsTpuConf(settings)
    backend.configure(c)
    kernel_abi.configure(c)
    return c
