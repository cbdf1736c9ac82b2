"""File scan layer: the host Parquet / CSV / ORC readers behind the scans.

Ported from ``spark_rapids_tpu/io/readers.py``: ``expand_paths`` (directory
expansion and Hive partition values), ``infer_schema``,
``scan_file_indices`` and ``CpuFileScanExec``, the host file scan the
planner emits and the overrides convert to ``TpuParquetScanExec`` (or keep
on the host, as the CPU fallback).  The reader strategies are the
reference's: PERFILE (one partition per file), COALESCING and
MULTITHREADED.  Each file decode goes through ``_read_one``, which
multicasts it through the shared-scan window (``io/scan_share.py``)
under ``sql.scan.shared.enabled``: concurrent queries reading the same
stamped file with the same projection and options share one decode.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Iterator, List, Optional
from urllib.parse import urlparse

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as papq

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.config import RapidsTpuConf
from spark_rapids_tpu_torch.exec.base import PhysicalPlan
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.plan.logical import FileScan, Schema


_EXTS = {"parquet": (".parquet", ".parq"), "csv": (".csv",),
         "orc": (".orc",)}


def expand_paths(fmt: str, paths: List[str]):
    """Expand directories into part files + Hive partition values.

    Reference analog: partition discovery + partition-value columns
    appended by ColumnarPartitionReaderWithPartitionValues.
    """
    import glob
    exts = _EXTS[fmt]
    files: List[str] = []
    part_values: List[dict] = []
    for p in paths:
        if os.path.isdir(p):
            hits = sorted(
                f for f in glob.glob(
                    os.path.join(glob.escape(p), "**", "*"),
                    recursive=True)
                if os.path.isfile(f) and (
                    f.endswith(exts) or "part-" in os.path.basename(f))
                and not os.path.basename(f).startswith(("_", ".")))
            for f in hits:
                files.append(f)
                part_values.append(dir_part_values(p, f))
        else:
            files.append(p)
            part_values.append({})
    return files, part_values


def dir_part_values(root: str, f: str) -> dict:
    """Hive partition values encoded in ``f``'s path below ``root`` —
    the ONE parser for `key=value` path segments, shared by
    ``expand_paths`` and the incremental maintainer's stamp-derived
    file lists (exec/incremental.py) so the two can't drift."""
    rel = os.path.relpath(os.path.dirname(f), root)
    pv: dict = {}
    if rel != ".":
        for seg in rel.split(os.sep):
            if "=" in seg:
                k, v = seg.split("=", 1)
                pv[k] = None if v == "__HIVE_DEFAULT_PARTITION__" else v
    return pv


def scan_file_indices(scan) -> List[int]:
    """File indices a scan should actually read: all of them, unless a
    ``file_subset`` restriction is stamped in the scan options (the
    incremental delta path, exec/incremental.py).  Index-based so
    ``part_values``/``part_fields`` alignment survives the
    restriction."""
    subset = scan.options.get("file_subset")
    if subset is None:
        return list(range(len(scan.paths)))
    keep = {os.path.abspath(p) for p in subset}
    return [i for i, p in enumerate(scan.paths)
            if os.path.abspath(p) in keep]


def _partition_fields(part_values: List[dict]):
    """Infer partition column types (int64 if every value parses)."""
    from spark_rapids_tpu_torch import dtypes as dt
    keys: List[str] = []
    for pv in part_values:
        for k in pv:
            if k not in keys:
                keys.append(k)
    fields = []
    for k in keys:
        vals = [pv.get(k) for pv in part_values]
        all_int = all(v is None or _is_int(v) for v in vals) and \
            any(v is not None for v in vals)
        fields.append((k, dt.INT64 if all_int else dt.STRING))
    return fields


def _is_int(s: str) -> bool:
    # strict digits only: int() would also accept '1_2' and ' 7 ', which
    # must stay strings lest the partition value silently change
    import re
    return isinstance(s, str) and re.fullmatch(r"[+-]?\d+", s) is not None


def infer_schema(fmt: str, paths: List[str],
                 options: Optional[dict] = None) -> Schema:
    options = options or {}
    if fmt == "parquet":
        # one footer parse serves schema inference AND the scan: the
        # cached FooterInfo is what TpuParquetScanExec re-opens
        from spark_rapids_tpu_torch.io import scan_cache as sc
        return Schema.from_arrow(sc.get_footer(paths[0]).schema_arrow)
    if fmt == "orc":
        import pyarrow.orc as paorc
        return Schema.from_arrow(paorc.ORCFile(paths[0]).schema)
    if fmt == "csv":
        t = _read_csv(paths[0], options)
        return Schema.from_arrow(t.schema)
    raise ValueError(f"unknown format {fmt}")


def _read_csv(path: str, options: dict) -> pa.Table:
    read_opts = pacsv.ReadOptions(
        autogenerate_column_names=not options.get("header", True))
    parse_opts = pacsv.ParseOptions(
        delimiter=options.get("sep", ","))
    convert_opts = pacsv.ConvertOptions(
        null_values=[options.get("nullValue", "")],
        strings_can_be_null=True)
    return pacsv.read_csv(path, read_options=read_opts,
                          parse_options=parse_opts,
                          convert_options=convert_opts)


def _normalize(t: pa.Table, schema: Schema,
               permissive: bool = False) -> pa.Table:
    """Cast to the scan schema (timestamps to us/UTC etc.).

    ``permissive`` applies Spark's permissive-CSV semantics to numeric
    narrowing: values an integer column cannot hold become null instead
    of raising — used by every CSV path so the per-column device
    fallback, the whole-file fallback and the CPU scan agree."""
    target = pa.schema([pa.field(f.name, f.dtype.to_arrow(), f.nullable)
                        for f in schema.fields])
    cols = []
    for f in target:
        col = t.column(f.name) if f.name in t.column_names else None
        if col is None:
            cols.append(pa.nulls(t.num_rows, f.type))
        elif permissive:
            cols.append(_permissive_cast(col, f.type))
        else:
            cols.append(col.cast(f.type))
    return pa.Table.from_arrays(cols, schema=target)


def _permissive_cast(col: pa.ChunkedArray, typ: pa.DataType):
    """Arrow cast with Spark's permissive-CSV overflow semantics:
    integer-column values out of range (int source) or out of
    range/non-integral (float source) become null rather than raising
    (stock safe cast) or wrapping (unsafe cast)."""
    import numpy as np
    import pyarrow.compute as pc
    try:
        return col.cast(typ)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        if not pa.types.is_integer(typ):
            raise
        info = np.iinfo(typ.to_pandas_dtype())
        if pa.types.is_floating(col.type):
            # float(int64.max) rounds UP to 2^63, which is NOT a valid
            # int64 — use a strict compare when the bound rounded so the
            # boundary value nulls out instead of raising in the cast
            hi = float(info.max)
            hi_cmp = pc.less if int(hi) > info.max else pc.less_equal
            ok = pc.and_kleene(
                pc.equal(col, pc.trunc(col)),
                pc.and_kleene(
                    pc.greater_equal(col, pa.scalar(float(info.min),
                                                    type=col.type)),
                    hi_cmp(col, pa.scalar(hi, type=col.type))))
        elif pa.types.is_integer(col.type):
            ok = pc.and_kleene(
                pc.greater_equal(col, pa.scalar(int(info.min),
                                                type=col.type)),
                pc.less_equal(col, pa.scalar(int(info.max),
                                             type=col.type)))
        else:
            raise
        return pc.if_else(ok, col,
                          pa.scalar(None, type=col.type)).cast(typ)


class CpuFileScanExec(PhysicalPlan):
    """v1-style file scan exec (GpuFileSourceScanExec analog)."""

    def __init__(self, scan: FileScan, conf: RapidsTpuConf):
        super().__init__()
        self.scan = scan
        self.conf = conf
        self._schema = scan.schema
        self.columns = scan.options.get("columns")
        self.reader_type = self._select_reader_type()
        self.max_rows = conf.get(cfg.MAX_READER_BATCH_SIZE_ROWS)

    def _select_reader_type(self) -> str:
        rt = str(self.conf.get(cfg.PARQUET_READER_TYPE)).upper()
        if rt != "AUTO":
            return rt
        cloud = {s.strip() for s in
                 str(self.conf.get(cfg.CLOUD_SCHEMES)).split(",")}
        schemes = {urlparse(p).scheme for p in self.scan.paths}
        if schemes & cloud:
            return "MULTITHREADED"
        if len(self.scan.paths) > 4:
            return "COALESCING"
        return "PERFILE"

    @property
    def schema(self) -> Schema:
        return self._schema

    def _read_one(self, file_index: int) -> pa.Table:
        """Decode one file, multicast through the shared-scan window
        when enabled: concurrent queries decoding the same stampable
        file (same projection/options) share one decode, the host
        analog of device_scan's fused-scan sharing.  A file that can't
        be stamped (vanished between plan and decode, non-local path) is
        never shared and counts ``scan.shared.ineligible.legacy``."""
        key = self._share_key(file_index)
        if key is None:
            return self._decode_one(file_index)
        from spark_rapids_tpu_torch.io import scan_share
        share = scan_share.get_share(
            int(self.conf.get(cfg.SCAN_SHARED_WINDOW_BYTES)))
        role, entry = share.claim(key)
        if role == "join":
            try:
                t = share.wait(entry)
            finally:
                share.release(entry)
            if t is not None:   # wait() counted the deduped decode
                return t
            # the leader failed or was cancelled: decode locally
            return self._decode_one(file_index)
        try:
            t = self._decode_one(file_index)
        except BaseException as e:
            share.fail(entry, e)
            share.release(entry)
            raise
        share.publish(entry, t)
        share.release(entry)
        return t

    def _share_key(self, file_index: int):
        """Content identity of one host-scan file decode, or None when
        sharing is off or the file can't be stamped."""
        if not bool(self.conf.get(cfg.SCAN_SHARED_ENABLED)):
            return None
        from spark_rapids_tpu_torch.io import scan_cache as sc
        path = self.scan.paths[file_index]
        stamp = sc.file_key(path)
        if stamp is None:
            obsreg.get_registry().inc("scan.shared.ineligible.legacy")
            return None
        pv_list = self.scan.options.get("part_values") or []
        pv = pv_list[file_index] if file_index < len(pv_list) else {}
        opts = {k: v for k, v in self.scan.options.items()
                if k not in ("part_values",)}
        return ("cpu", stamp, self.scan.fmt,
                tuple(self.columns or ()),
                tuple(sorted((str(k), str(v)) for k, v in pv.items())),
                repr(sorted(opts.items(), key=lambda kv: str(kv[0]))),
                repr(self._schema))

    def _decode_one(self, file_index: int) -> pa.Table:
        path = self.scan.paths[file_index]
        fmt = self.scan.fmt
        part_fields = dict(self.scan.options.get("part_fields") or [])
        if self.columns:
            # only materialize partition columns the projection keeps
            part_fields = {k: d for k, d in part_fields.items()
                           if k in self.columns}
        file_cols = self.columns
        if file_cols:
            file_cols = [c for c in file_cols if c not in part_fields]
        if fmt == "parquet":
            t = papq.read_table(path, columns=file_cols)
        elif fmt == "orc":
            import pyarrow.orc as paorc
            t = paorc.ORCFile(path).read(columns=file_cols)
        elif fmt == "csv":
            t = _read_csv(path, self.scan.options)
            if file_cols:
                t = t.select(file_cols)
        else:
            raise ValueError(fmt)
        # append Hive partition-value columns for this file
        # (ColumnarPartitionReaderWithPartitionValues analog)
        pv_list = self.scan.options.get("part_values") or []
        pv = pv_list[file_index] if file_index < len(pv_list) else {}
        for k, d in part_fields.items():
            if k in t.column_names:
                # the partition value wins over a same-named file column
                t = t.drop_columns([k])
            raw = pv.get(k)
            if raw is None:
                col = pa.nulls(t.num_rows, d.to_arrow())
            else:
                val = int(raw) if d.to_arrow() == pa.int64() else raw
                col = pa.array([val] * t.num_rows, type=d.to_arrow())
            t = t.append_column(k, col)
        schema = self._schema if not self.columns else Schema(
            [self._schema.field(c) for c in self.columns])
        return _normalize(t, schema, permissive=(fmt == "csv"))

    def _batches(self, t: pa.Table) -> Iterator[pa.Table]:
        for off in range(0, max(t.num_rows, 1), self.max_rows):
            yield t.slice(off, self.max_rows)
            if t.num_rows == 0:
                break

    def execute(self) -> List[Iterator[pa.Table]]:
        indices = scan_file_indices(self.scan)
        if self.reader_type == "MULTITHREADED":
            nthreads = self.conf.get(
                cfg.PARQUET_MULTITHREAD_READ_NUM_THREADS)

            def run_all():
                with cf.ThreadPoolExecutor(max_workers=nthreads) as pool:
                    for fut in [pool.submit(self._read_one, i)
                                for i in indices]:
                        yield from self._batches(fut.result())
            return [run_all()]
        if self.reader_type == "COALESCING":
            def run_all():
                pending: List[pa.Table] = []
                pending_rows = 0
                for i in indices:
                    t = self._read_one(i)
                    pending.append(t)
                    pending_rows += t.num_rows
                    if pending_rows >= self.max_rows:
                        yield from self._batches(
                            pa.concat_tables(pending))
                        pending, pending_rows = [], 0
                if pending:
                    yield from self._batches(pa.concat_tables(pending))
            return [run_all()]

        # PERFILE: one partition per file
        def part(i):
            from spark_rapids_tpu_torch.exec.context import set_input_file
            path = self.scan.paths[i]
            try:
                for b in self._batches(self._read_one(i)):
                    # set right before the yield so the consumer
                    # evaluates input_file_name() against THIS batch's
                    # file even when two scans are drained interleaved
                    set_input_file(path)
                    yield b
            finally:
                set_input_file("")
        return [part(i) for i in indices]

    def simple_string(self) -> str:
        return (f"CpuFileScanExec({self.scan.fmt}, "
                f"files={len(self.scan.paths)}, {self.reader_type})")
