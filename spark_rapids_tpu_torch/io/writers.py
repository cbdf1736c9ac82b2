"""File write layer: Parquet / CSV / ORC writers with Hive-style
partitioned output.

Ported from ``spark_rapids_tpu/io/writers.py``.  A write plans the
DataFrame with its session; when the planned root is the terminal
``DeviceToHostExec`` over a device plan, the write is not partitioned,
the format's ``deviceEncode`` key is on and the encoder covers every
column type, each output partition is concatenated on the device and
encoded by io/parquet_encode.py or io/orc_encode.py (the device
compaction and one packed download, then the host byte assembly).
Otherwise the host Arrow writers encode the collected tables, with
per-partition part files, the Hive ``key=value`` layout for
``partition_by``, a ``_SUCCESS`` marker and :class:`WriteStats`.
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from typing import Dict, List

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as papq


@dataclass
class WriteStats:
    """numFiles/numBytes/numRows (reference: BasicColumnarWriteStatsTracker)."""

    num_files: int = 0
    num_bytes: int = 0
    num_rows: int = 0
    partitions: List[str] = field(default_factory=list)


class DataFrameWriter:
    def __init__(self, df):
        self.df = df
        self._mode = "errorifexists"
        self._partition_by: List[str] = []
        self._options: Dict[str, str] = {}

    def mode(self, m: str) -> "DataFrameWriter":
        self._mode = m.lower()
        return self

    def option(self, k: str, v) -> "DataFrameWriter":
        self._options[k] = v
        return self

    def partition_by(self, *cols) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    partitionBy = partition_by

    # -- formats -----------------------------------------------------------
    def parquet(self, path: str) -> WriteStats:
        return self._write(path, "parquet")

    def csv(self, path: str, header: bool = True) -> WriteStats:
        self._options.setdefault("header", header)
        return self._write(path, "csv")

    def orc(self, path: str) -> WriteStats:
        return self._write(path, "orc")

    # -- core --------------------------------------------------------------
    def _prepare_dir(self, path: str) -> None:
        if os.path.exists(path):
            if self._mode == "overwrite":
                import shutil
                shutil.rmtree(path)
            elif self._mode in ("errorifexists", "error"):
                raise FileExistsError(
                    f"path {path} already exists (mode=errorifexists)")
            elif self._mode == "ignore":
                return
        os.makedirs(path, exist_ok=True)

    def _write_one(self, table: pa.Table, path: str, fmt: str) -> int:
        if fmt == "parquet":
            papq.write_table(table, path,
                             compression=self._options.get(
                                 "compression", "snappy"))
        elif fmt == "csv":
            opts = pacsv.WriteOptions(
                include_header=bool(self._options.get("header", True)))
            pacsv.write_csv(table, path, opts)
        elif fmt == "orc":
            paorc.write_table(table, path)
        return os.path.getsize(path)

    def _write(self, path: str, fmt: str) -> WriteStats:
        if self._mode == "ignore" and os.path.exists(path):
            return WriteStats()
        self._prepare_dir(path)
        stats = WriteStats()
        job_id = uuid.uuid4().hex[:8]
        ext = {"parquet": "parquet", "csv": "csv", "orc": "orc"}[fmt]

        result = self.df.session._plan_physical(self.df.plan)
        if fmt in ("parquet", "orc") and \
                self._device_encode_ok(result.plan, fmt):
            return self._write_device(result.plan, path, job_id, stats,
                                      fmt)
        part_iters = result.plan.execute()
        for pid, it in enumerate(part_iters):
            tables = [t for t in it if t.num_rows > 0]
            if not tables:
                continue
            table = pa.concat_tables(tables)
            if self._partition_by:
                self._write_partitioned(table, path, fmt, pid, job_id, ext,
                                        stats)
            else:
                fname = os.path.join(
                    path, f"part-{pid:05d}-{job_id}.{ext}")
                stats.num_bytes += self._write_one(table, fname, fmt)
                stats.num_files += 1
                stats.num_rows += table.num_rows
        # _SUCCESS marker like Hadoop committers
        open(os.path.join(path, "_SUCCESS"), "w").close()
        return stats

    # -- device encode (parquet + ORC) ------------------------------------
    def _device_encode_ok(self, plan, fmt: str) -> bool:
        from spark_rapids_tpu_torch import config as cfg
        from spark_rapids_tpu_torch.exec.tpu_basic import DeviceToHostExec
        if self._partition_by:
            return False
        if fmt == "parquet":
            from spark_rapids_tpu_torch.io import parquet_encode as enc
            key = cfg.PARQUET_DEVICE_ENCODE
        else:
            from spark_rapids_tpu_torch.io import orc_encode as enc
            key = cfg.ORC_DEVICE_ENCODE
        if not self.df.session.conf.get(key):
            return False
        return isinstance(plan, DeviceToHostExec) and \
            enc.supported(plan.schema.fields)

    def _write_device(self, plan, path: str, job_id: str,
                      stats: WriteStats, fmt: str) -> WriteStats:
        """Device-encode path: per-column null compaction on the device,
        one packed download per partition on the session's copy stream,
        host page/stripe assembly (io/parquet_encode.py,
        io/orc_encode.py)."""
        from spark_rapids_tpu_torch.columnar.batch import concat_batches
        stream = self.df.session.copy_stream
        if fmt == "parquet":
            from spark_rapids_tpu_torch.io import parquet_encode as pqe
            codec = self._options.get("compression", "snappy")
            encode = lambda b: pqe.encode_batch(  # noqa: E731
                b, codec=codec, copy_stream=stream)
        else:
            from spark_rapids_tpu_torch.io import orc_encode as oce
            encode = lambda b: oce.encode_batch(  # noqa: E731
                b, copy_stream=stream)
        inner = plan.children[0]
        for pid, it in enumerate(inner.execute()):
            batches = [b for b in it if int(b.num_rows)]
            if not batches:
                continue
            whole = concat_batches(batches) if len(batches) > 1 \
                else batches[0]
            blob = encode(whole)
            fname = os.path.join(path,
                                 f"part-{pid:05d}-{job_id}.{fmt}")
            with open(fname, "wb") as f:
                f.write(blob)
            stats.num_bytes += len(blob)
            stats.num_files += 1
            stats.num_rows += int(whole.num_rows)
        open(os.path.join(path, "_SUCCESS"), "w").close()
        return stats

    def _write_partitioned(self, table: pa.Table, path: str, fmt: str,
                           pid: int, job_id: str, ext: str,
                           stats: WriteStats) -> None:
        """Hive key=value layout (dynamic partitioning analog,
        reference: GpuFileFormatDataWriter dynamic partition writer)."""
        import pyarrow.compute as pc
        keys = self._partition_by
        data_cols = [c for c in table.column_names if c not in keys]
        combos = table.select(keys).group_by(keys).aggregate([])
        for row in range(combos.num_rows):
            mask = None
            parts = []
            for k in keys:
                v = combos.column(k)[row]
                cond = pc.is_null(table.column(k)) if not v.is_valid else \
                    pc.equal(table.column(k), v)
                mask = cond if mask is None else pc.and_(mask, cond)
                sval = "__HIVE_DEFAULT_PARTITION__" if not v.is_valid \
                    else str(v.as_py())
                parts.append(f"{k}={sval}")
            sub = table.filter(mask).select(data_cols)
            subdir = os.path.join(path, *parts)
            os.makedirs(subdir, exist_ok=True)
            fname = os.path.join(subdir,
                                 f"part-{pid:05d}-{job_id}.{ext}")
            stats.num_bytes += self._write_one(sub, fname, fmt)
            stats.num_files += 1
            stats.num_rows += sub.num_rows
            pdir = "/".join(parts)
            if pdir not in stats.partitions:
                stats.partitions.append(pdir)
