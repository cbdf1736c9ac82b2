"""File scan execs whose decode runs on the device.

Ported from ``spark_rapids_tpu/io/device_scan.py``: ``TpuParquetScanExec``
(:73) with its two readers, ``TpuOrcScanExec`` (:419) and
``TpuCsvScanExec`` (:443).

  * The fused coalescing reader (``_execute_fused``, reference :213-412):
    row groups of the scan's files group greedily into batches bounded
    by ``sql.reader.batchSizeRows`` / ``batchSizeBytes``; each batch is
    one ``prepare`` (host prep and the upload, io/parquet_fused.
    prepare_fused, no device read) and one ``finish`` (the fused decode,
    finish_fused) under the device semaphore (mem/device.tpu_semaphore).
    With ``sql.scan.prefetch.depth`` > 0 and two or more batches, a
    ``ScanPrefetcher`` (exec/scans.py) prepares the next batches on its
    threads while the consumer decodes: on the card the upload goes
    through pinned memory on the scan's copy stream, and the decode's
    stream waits on its event.
  * The PERFILE reader, taken when
    ``spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled`` is false
    or the plan reads ``input_file_name()`` (``allow_fused`` cleared): one
    partition per file and one batch per row group, each decoded column
    by column (io/device_parquet.decode_row_group, the ``scan.decode``
    section) under the device semaphore.  It sets the
    ``input_file_name()`` slot (exec/context.py) right before each batch
    is yielded and clears it when the file is done.  It ignores a pushed
    filter: the consumer applies its condition.

``TpuOrcScanExec`` is the PERFILE reader over ORC: one batch per
stripe (io/device_orc.decode_stripe), never the fused reader, and it
ignores a pushed filter (the planner stamps none on it).
``TpuCsvScanExec`` decodes each file in one pass on the device
(io/device_csv.decode_csv, the ``scan.csvDecode`` section) and falls
back to the whole-file Arrow read for a dialect the device parse does
not cover, counting it in ``fallbackFiles``.

Hive partition-value columns are appended as constant columns (not by
the CSV scan: the planner keeps a partitioned CSV scan on the host, as
the reference does).

Shared scans (reference :232-370, ``sql.scan.shared.enabled``, on by
default): each fused batch claims its content key in the process-wide
``io/scan_share.ScanShare`` (file stamps, row groups, output columns,
the pushed filter's signature, partition values, backend and device).
The first claimant leads: it prepares and decodes as above and
publishes the batch.  A query that claims the key while the flight is
open, or while the batch is in the retention window, subscribes: it
skips the host prep (and so the page walks) and the decode, and waits
for the leader's batch outside the device semaphore.  When the leader
fails or is cancelled, the subscriber decodes under a fresh claim, so a
third query can still share its decode.  The reference also bars input
donation for shared batches (its ``exec/fused_stage.py:155-170``); the
port never donates an input buffer (port ``exec/fused_stage.py``), so
nothing more is needed there.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   _bucket_strlen,
                                                   resolve_device)
from spark_rapids_tpu_torch.exec.base import TpuExec, timed
from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.mem.device import tpu_semaphore
from spark_rapids_tpu_torch.plan.logical import FileScan, Schema


def _const_column(dtype: dt.DType, raw: Optional[str], cap: int,
                  n_rows: int, device: torch.device) -> DeviceColumn:
    """Device constant column for one partition value."""
    row_valid = torch.arange(cap, device=device) < n_rows
    if raw is None:
        if dtype.is_string:
            return DeviceColumn(
                dtype, torch.zeros((cap, 1), dtype=torch.uint8,
                                   device=device),
                torch.zeros(cap, dtype=torch.bool, device=device),
                torch.zeros(cap, dtype=torch.int32, device=device))
        return DeviceColumn(
            dtype, torch.zeros(cap, dtype=dtype.to_torch(), device=device),
            torch.zeros(cap, dtype=torch.bool, device=device))
    if dtype.is_string:
        b = raw.encode("utf-8")
        row = np.zeros((_bucket_strlen(len(b)),), dtype=np.uint8)
        row[:len(b)] = np.frombuffer(b, dtype=np.uint8)
        data = torch.from_numpy(row).to(device).expand(cap, -1)
        lens = torch.where(row_valid, len(b), 0).to(torch.int32)
        return DeviceColumn(dtype, data, row_valid, lens)
    val = np.asarray(raw, dtype=dtype.to_np()) if dtype.to_np().kind != "i" \
        else np.asarray(int(raw), dtype=dtype.to_np())
    data = torch.where(row_valid, torch.from_numpy(val).to(device),
                       torch.zeros((), dtype=dtype.to_torch(),
                                   device=device))
    return DeviceColumn(dtype, data, row_valid)


def _group_label(srcs) -> str:
    """Short source id for one coalesced scan group — the prefetcher
    stamps it into prefetch/stall span args so a trace names WHICH
    file/row-group the consumer starved on."""
    import os as _os
    if not srcs:
        return ""
    path, rg = srcs[0]
    label = f"{_os.path.basename(str(path))}#rg{rg}"
    if len(srcs) > 1:
        label += f"+{len(srcs) - 1}"
    return label


class TpuParquetScanExec(TpuExec):
    """Device-decoding Parquet scan (yields DeviceBatch on ``device``).

    ``_pushed_filter`` is the consumer's condition, bound over this
    scan's output names, which the planner pushes into the scan (the
    reference's ``plan/overrides._push_scan_filters``): dictionary
    columns it does not read then decode only for the rows it keeps.
    ``copy_stream`` is the session's ``columnar/transfer.CopyStream``
    on the card; the scan makes its own when none is set."""

    fmt = "parquet"

    def __init__(self, scan: FileScan, conf, device="cuda"):
        super().__init__()
        self.scan = scan
        self.conf = conf
        self.device = resolve_device(device)
        self.columns = scan.options.get("columns")
        self._schema = scan.schema if not self.columns else Schema(
            [scan.schema.field(c) for c in self.columns])
        self.part_fields = dict(scan.options.get("part_fields") or [])
        # cleared when the plan reads input_file_name() (the reference's
        # coalescing reader bails out the same way)
        self.allow_fused = True
        self._pushed_filter = None
        self.copy_stream = None
        self.metrics.extra["fallbackColumns"] = 0

    @property
    def schema(self) -> Schema:
        return self._schema

    def simple_string(self) -> str:
        return (f"{type(self).__name__}"
                f"(files={len(self.scan.paths)}, deviceDecode)")

    def execute(self) -> List[Iterator[DeviceBatch]]:
        if (self.fmt == "parquet" and self.allow_fused and
                self.conf.get(cfg.PARQUET_FUSED_DECODE)):
            return self._execute_fused()
        from spark_rapids_tpu_torch.io.readers import scan_file_indices
        return [self._file_part(i) for i in scan_file_indices(self.scan)]

    # -- PERFILE reader: one partition per file, one batch per row group --
    def _file_part(self, file_index: int) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.exec.context import set_input_file
        path = self.scan.paths[file_index]
        try:
            for b in self._file_part_inner(file_index):
                # set right before the yield so the consumer evaluates
                # input_file_name() against THIS batch's file even when
                # two scans are drained interleaved
                set_input_file(path)
                yield b
        finally:
            set_input_file("")

    def _file_part_inner(self, file_index: int) -> Iterator[DeviceBatch]:
        path = self.scan.paths[file_index]
        pv_list = self.scan.options.get("part_values") or []
        pv = pv_list[file_index] if file_index < len(pv_list) else {}
        wanted = [f.name for f in self._schema.fields]
        part_cols = [c for c in wanted if c in self.part_fields]
        file_cols = [c for c in wanted if c not in self.part_fields]
        file_schema = Schema([self._schema.field(c) for c in file_cols])
        fctx = self._open(path)  # one open / footer parse per file
        try:
            for rg in range(self._num_chunks(fctx)):
                with tpu_semaphore(self.metrics):
                    with timed(self.metrics, "scan.decode"):
                        batch, fallbacks = self._decode_chunk(
                            fctx, rg, file_schema, file_cols)
                    self.metrics.add_extra("fallbackColumns", len(fallbacks))
                    names = list(batch.names)
                    cols = list(batch.columns)
                    for c in part_cols:
                        names.append(c)
                        cols.append(_const_column(
                            self.part_fields[c], pv.get(c), batch.capacity,
                            int(batch.num_rows), self.device))
                    # restore the requested column order
                    order = [names.index(c) for c in wanted]
                    out = DeviceBatch([names[i] for i in order],
                                      [cols[i] for i in order],
                                      batch.num_rows, self.device)
                    self.metrics.add_rows(int(out.num_rows))
                    self.metrics.add_batches()
                    yield out
        finally:
            self._close(fctx)

    def _open(self, path: str):
        from spark_rapids_tpu_torch.io import scan_cache as sc
        return path, sc.open_source(path, metrics=self.metrics)

    def _close(self, fctx) -> None:
        fctx[1].close()

    def _num_chunks(self, fctx) -> int:
        return fctx[1].metadata.num_row_groups

    def _decode_chunk(self, fctx, idx: int, file_schema: Schema, file_cols):
        from spark_rapids_tpu_torch.io import device_parquet as devpq
        from spark_rapids_tpu_torch.io import scan_cache as sc
        path, pf = fctx
        if self.device.type == "cuda" and self.copy_stream is None:
            from spark_rapids_tpu_torch.columnar.transfer import CopyStream
            self.copy_stream = CopyStream(self.device)
        return devpq.decode_row_group(
            path, idx, file_schema, columns=file_cols, parquet_file=pf,
            source_key=sc.handle_key(pf, path), metrics=self.metrics,
            device=self.device, copy_stream=self.copy_stream)

    # -- fused coalescing reader -------------------------------------------

    def _fused_groups(self):
        """Greedy grouping of (file, row-group) pairs: same partition
        values, bounded by reader batchSizeRows/Bytes.  Files open only
        transiently here (footer metadata, through the scan cache)."""
        from spark_rapids_tpu_torch.io import scan_cache as sc
        from spark_rapids_tpu_torch.io.readers import scan_file_indices
        max_rows = int(self.conf.get(cfg.MAX_READER_BATCH_SIZE_ROWS))
        max_bytes = int(self.conf.get(cfg.MAX_READER_BATCH_SIZE_BYTES))
        pv_list = self.scan.options.get("part_values") or []
        groups = []
        cur, cur_rows, cur_bytes, cur_pv = [], 0, 0, None
        for fi in scan_file_indices(self.scan):
            path = self.scan.paths[fi]
            pf = sc.open_source(path, metrics=self.metrics)
            pv = pv_list[fi] if fi < len(pv_list) else {}
            pv_key = tuple(sorted(pv.items()))
            md = pf.metadata
            sizes = [(md.row_group(rg).num_rows,
                      md.row_group(rg).total_byte_size)
                     for rg in range(md.num_row_groups)]
            pf.close()
            for rg, (rows, nbytes) in enumerate(sizes):
                if cur and (pv_key != cur_pv or
                            cur_rows + rows > max_rows or
                            cur_bytes + nbytes > max_bytes):
                    groups.append((cur, dict(cur_pv)))
                    cur, cur_rows, cur_bytes = [], 0, 0
                cur_pv = pv_key
                cur.append((path, rg))
                cur_rows += rows
                cur_bytes += nbytes
        if cur:
            groups.append((cur, dict(cur_pv)))
        return groups

    def _execute_fused(self) -> List[Iterator[DeviceBatch]]:
        from spark_rapids_tpu_torch.exec.scans import ScanPrefetcher
        from spark_rapids_tpu_torch.io import parquet_fused as pqf
        from spark_rapids_tpu_torch.io import scan_cache as sc

        wanted = [f.name for f in self._schema.fields]
        part_cols = [c for c in wanted if c in self.part_fields]
        file_cols = [c for c in wanted if c not in self.part_fields]
        file_schema = Schema([self._schema.field(c) for c in file_cols])
        host_threads = max(1, int(self.conf.get(
            cfg.SCAN_HOST_PREP_THREADS)))
        depth = max(0, int(self.conf.get(cfg.SCAN_PREFETCH_DEPTH)))
        # ordinals of the pushed condition index `wanted`
        pushed = self._pushed_filter
        backend = kb.resolve(getattr(self, "_kernel_backend", None))
        groups = self._fused_groups()
        if self.device.type == "cuda" and self.copy_stream is None:
            from spark_rapids_tpu_torch.columnar.transfer import CopyStream
            self.copy_stream = CopyStream(self.device)
        copy_stream = self.copy_stream

        # shared-scan multicast (io/scan_share): concurrent queries
        # decoding the same (stamps, row groups, columns, filter) group
        # share ONE host prep + device decode
        share = None
        share_keys: List = []
        if bool(self.conf.get(cfg.SCAN_SHARED_ENABLED)):
            from spark_rapids_tpu_torch.exec import kernel_cache as kc
            from spark_rapids_tpu_torch.io import scan_share
            share = scan_share.get_share(
                int(self.conf.get(cfg.SCAN_SHARED_WINDOW_BYTES)))
            schema_sig = tuple((f.name, f.dtype.name)
                               for f in self._schema.fields)
            pushed_sig = kc.expr_sig(pushed)
            share_keys = [scan_share.share_key(srcs, pv, schema_sig,
                                               pushed_sig, backend,
                                               self.device)
                          for srcs, pv in groups]

        def prepare(path_rgs):
            """Host prep + packed-page upload for one batch (no device
            read: safe on the prefetch thread)."""
            handles = {p: sc.open_source(p, metrics=self.metrics)
                       for p in {p for p, _ in path_rgs}}
            try:
                return pqf.prepare_fused(
                    [(handles[p], p, rg) for p, rg in path_rgs],
                    file_schema, columns=file_cols,
                    host_threads=host_threads, metrics=self.metrics,
                    pushed_filter=pushed, scan_names=wanted,
                    device=self.device, copy_stream=copy_stream,
                    backend=backend), handles
            except BaseException:
                for h in handles.values():
                    h.close()
                raise

        def finish(prepared, pv) -> DeviceBatch:
            """Dispatch the prepared batch (the caller holds the device
            semaphore)."""
            prep, handles = prepared
            try:
                with timed(self.metrics, "scan.dispatch"):
                    batch, fallbacks = pqf.finish_fused(prep)
                self.metrics.add_extra("fallbackColumns", len(fallbacks))
                names = list(batch.names)
                cols = list(batch.columns)
                for c in part_cols:
                    names.append(c)
                    cols.append(_const_column(
                        self.part_fields[c], pv.get(c), batch.capacity,
                        int(batch.num_rows), self.device))
                order = [names.index(c) for c in wanted]
                out = DeviceBatch([names[i] for i in order],
                                  [cols[i] for i in order], batch.num_rows,
                                  self.device)
                # the reference reads the row count here too: the one
                # device read per batch, where the consumer waits
                self.metrics.add_rows(int(out.num_rows))
                self.metrics.add_batches()
                return out
            finally:
                for h in handles.values():
                    h.close()

        def _prep(idx, path_rgs):
            """Prepare with a sharing claim: markers are ("solo"/"lead"/
            "join", entry, prepared).  A joined claim skips the host
            prep (and so the page walks) entirely."""
            if share is None or share_keys[idx] is None:
                return ("solo", None, prepare(path_rgs))
            role, entry = share.claim(share_keys[idx])
            if role == "join":
                return ("join", entry, None)
            try:
                return ("lead", entry, prepare(path_rgs))
            except BaseException as e:
                share.fail(entry, e)
                share.release(entry)
                raise

        def _finish_marker(marker, pv) -> DeviceBatch:
            """Dispatch one marker's decode that is not a join (the
            caller holds the device semaphore); a lead marker settles
            its flight."""
            kind, entry, prepared = marker
            if kind == "solo":
                return finish(prepared, pv)
            try:
                out = finish(prepared, pv)
            except BaseException as e:
                share.fail(entry, e)
                share.release(entry)
                raise
            share.publish(entry, out)
            share.release(entry)
            return out

        def _resolve(marker, idx, path_rgs, pv) -> DeviceBatch:
            """Marker -> decoded batch.  Takes the semaphore only for
            real decode work, never while waiting on another query's
            flight (the leader's decode needs a slot)."""
            while True:
                kind, entry, _prepared = marker
                if kind != "join":
                    with tpu_semaphore(self.metrics):
                        return _finish_marker(marker, pv)
                try:
                    out = share.wait(entry)
                finally:
                    share.release(entry)
                if out is not None:
                    # decode skipped: account this exec's output so the
                    # query profile still shows the rows it consumed
                    self.metrics.add_rows(int(out.num_rows))
                    self.metrics.add_batches()
                    return out
                # the leader failed or abandoned its flight: decode
                # locally under a FRESH claim, so a later subscriber
                # can still share this decode
                marker = _prep(idx, path_rgs)

        def _cleanup(marker) -> None:
            kind, entry, prepared = marker
            if prepared is not None:
                for h in prepared[1].values():
                    h.close()
            if kind == "lead":
                share.fail(entry, RuntimeError("scan flight abandoned"))
                share.release(entry)
            elif kind == "join":
                share.release(entry)

        prefetcher = None
        if depth > 0 and len(groups) > 1:
            # bounded look-ahead: host prep + upload of batch k+1
            # overlaps the dispatch-only decode of batch k
            prefetcher = ScanPrefetcher(
                [(lambda i=i, prgs=srcs: _prep(i, prgs))
                 for i, (srcs, _pv) in enumerate(groups)],
                depth=depth, metrics=self.metrics, cleanup=_cleanup,
                labels=[_group_label(srcs) for srcs, _pv in groups])

        def group_part(idx, path_rgs, pv) -> Iterator[DeviceBatch]:
            from spark_rapids_tpu_torch.exec.context import set_input_file
            try:
                if prefetcher is not None:
                    out = _resolve(prefetcher.get(idx), idx, path_rgs, pv)
                else:
                    # no pipelining: the whole prep + upload + dispatch
                    # runs under the semaphore (a joined claim waits
                    # OUTSIDE it instead)
                    out = None
                    with tpu_semaphore(self.metrics):
                        marker = _prep(idx, path_rgs)
                        if marker[0] != "join":
                            out = _finish_marker(marker, pv)
                    if out is None:
                        out = _resolve(marker, idx, path_rgs, pv)
                paths = {p for p, _ in path_rgs}
                # set right before the yield so the consumer evaluates
                # input_file_name() against THIS batch's file
                set_input_file(paths.pop() if len(paths) == 1 else "")
                yield out
            finally:
                set_input_file("")
                if prefetcher is not None:
                    # once every partition has finished (or failed),
                    # unconsumed prepared batches release immediately
                    prefetcher.part_done()

        return [group_part(i, srcs, pv)
                for i, (srcs, pv) in enumerate(groups)]


class TpuOrcScanExec(TpuParquetScanExec):
    """Device-decoding ORC scan (reference :419): one batch per stripe
    through the PERFILE machinery (io/device_orc.decode_stripe), never
    the fused reader; shares the partition-column and fallback
    machinery."""

    fmt = "orc"

    def _open(self, path: str):
        from spark_rapids_tpu_torch.io import device_orc as dorc
        with open(path, "rb") as f:
            raw = f.read()
        return path, raw, dorc.read_meta(raw)

    def _close(self, fctx) -> None:
        pass

    def _num_chunks(self, fctx) -> int:
        return len(fctx[2].stripes)

    def _decode_chunk(self, fctx, idx: int, file_schema: Schema, file_cols):
        from spark_rapids_tpu_torch.io import device_orc as dorc
        path, raw, meta = fctx
        if self.device.type == "cuda" and self.copy_stream is None:
            from spark_rapids_tpu_torch.columnar.transfer import CopyStream
            self.copy_stream = CopyStream(self.device)
        return dorc.decode_stripe(
            path, idx, file_schema, columns=file_cols, raw=raw, meta=meta,
            device=self.device, copy_stream=self.copy_stream,
            host_threads=max(1, int(self.conf.get(
                cfg.SCAN_HOST_PREP_THREADS))), metrics=self.metrics)


class TpuCsvScanExec(TpuExec):
    """Device-decoding CSV scan (reference :443): one device decode per
    file (io/device_csv.decode_csv) under the device semaphore, timed as
    ``scan.csvDecode``.  A dialect the device parse does not cover
    (quotes, ragged rows, a type outside its set) falls back to the
    whole-file Arrow read with permissive casts, counted in
    ``fallbackFiles``; columns with exotic numerics are re-read on the
    host, counted in ``fallbackColumns``.  A pruned scan decodes each
    file against its unpruned schema (the scan option ``file_schema``,
    plan/optimizer.py), where the reference passes the pruned one and
    falls back whole-file."""

    def __init__(self, scan: FileScan, conf, device="cuda"):
        super().__init__()
        self.scan = scan
        self.conf = conf
        self.device = resolve_device(device)
        self.columns = scan.options.get("columns")
        self._schema = scan.schema if not self.columns else Schema(
            [scan.schema.field(c) for c in self.columns])
        self.copy_stream = None
        self.metrics.extra["fallbackColumns"] = 0
        self.metrics.extra["fallbackFiles"] = 0

    @property
    def schema(self) -> Schema:
        return self._schema

    def _file_part(self, path: str) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.columnar.batch import from_arrow
        from spark_rapids_tpu_torch.exec.context import set_input_file
        from spark_rapids_tpu_torch.io import device_csv as dcsv
        from spark_rapids_tpu_torch.io.readers import _normalize, _read_csv
        wanted = [f.name for f in self._schema.fields]
        opts = self.scan.options
        if self.device.type == "cuda" and self.copy_stream is None:
            from spark_rapids_tpu_torch.columnar.transfer import CopyStream
            self.copy_stream = CopyStream(self.device)
        try:
            with tpu_semaphore(self.metrics):
                with timed(self.metrics, "scan.csvDecode"):
                    try:
                        batch, fallbacks = dcsv.decode_csv(
                            path, opts.get("file_schema", self.scan.schema),
                            columns=wanted,
                            sep=opts.get("sep", ","),
                            header=bool(opts.get("header", True)),
                            device=self.device,
                            copy_stream=self.copy_stream)
                        self.metrics.add_extra("fallbackColumns",
                                               len(fallbacks))
                    except dcsv.UnsupportedCsv:
                        # whole-file host fallback
                        self.metrics.add_extra("fallbackFiles", 1)
                        t = _normalize(_read_csv(path, opts),
                                       self.scan.schema, permissive=True)
                        batch = from_arrow(t.select(wanted),
                                           device=self.device,
                                           copy_stream=self.copy_stream)
                self.metrics.add_rows(int(batch.num_rows))
                self.metrics.add_batches()
                set_input_file(path)
                yield batch
        finally:
            set_input_file("")

    def execute(self) -> List[Iterator[DeviceBatch]]:
        from spark_rapids_tpu_torch.io.readers import scan_file_indices
        return [self._file_part(self.scan.paths[i])
                for i in scan_file_indices(self.scan)]

    def simple_string(self) -> str:
        return (f"{type(self).__name__}"
                f"(files={len(self.scan.paths)}, deviceDecode)")
