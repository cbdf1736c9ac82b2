"""In-memory table scan over cached parquet blobs (df.cache()).

Ported from ``spark_rapids_tpu/exec/cache.py``:

  * :func:`materialize` runs the child plan through the override pipeline
    once, on the device of the session that collects it, and encodes each
    output partition as one parquet blob: by the device encoder
    (io/parquet_encode.py) when the plan ends on the device, else by host
    Arrow;
  * ``TpuInMemoryTableScanExec`` decodes the blobs on the device through
    the PERFILE reader of file scans (``io/device_parquet.
    decode_row_group``, per-column host fallback included);
  * ``CpuInMemoryTableScanExec`` is the host read, used when the device
    plan is off or the cached scan is kill-switched.
"""

from __future__ import annotations

import io
from typing import Iterator, List

import pyarrow as pa
import pyarrow.parquet as papq

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.batch import resolve_device
from spark_rapids_tpu_torch.columnar.transfer import stamp_copy_stream
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, TpuExec, timed
from spark_rapids_tpu_torch.mem.device import tpu_semaphore
from spark_rapids_tpu_torch.plan.logical import CachedRelation, Schema


def materialize(relation: CachedRelation, conf, device="cuda",
                copy_stream=None) -> None:
    """Build the cache: run the child plan once on ``device``, encode
    each partition as one parquet blob (a single row group, so the device
    decode sees the same page layout as a file scan).

    When the child plan ends on the device, the partitions are encoded by
    the DEVICE parquet encoder; otherwise host Arrow encodes them."""
    if relation.materialized:
        return
    relation._blob_keys = None   # content digests memoized per build
    from spark_rapids_tpu_torch.exec.cpu import _empty_table, concat_tables
    from spark_rapids_tpu_torch.exec.tpu_basic import DeviceToHostExec
    from spark_rapids_tpu_torch.io import parquet_encode as pqe
    from spark_rapids_tpu_torch.plan.overrides import TpuOverrides
    from spark_rapids_tpu_torch.plan.planner import plan_cpu

    child = relation.children[0]
    if conf.get(cfg.COLUMN_PRUNING):
        # the session's pruning stops at the relation (plan/optimizer.py)
        from spark_rapids_tpu_torch.plan.optimizer import prune_columns
        child = prune_columns(child)
    cpu_plan = plan_cpu(child, conf)
    result = TpuOverrides.apply(cpu_plan, conf, device=device)
    stamp_copy_stream(result.plan, copy_stream)
    codec = str(conf.get(cfg.CACHE_COMPRESSION))
    relation.device_encoded = False

    if (conf.get(cfg.CACHE_DEVICE_ENCODE) and
            isinstance(result.plan, DeviceToHostExec) and
            pqe.supported(result.plan.schema.fields) and
            codec in ("snappy", "zstd", "none", "uncompressed")):
        from spark_rapids_tpu_torch.columnar.batch import concat_batches
        blobs: List[bytes] = []
        for it in result.plan.children[0].execute():
            batches = [b for b in it if int(b.num_rows)]
            if batches:
                whole = concat_batches(batches) if len(batches) > 1 \
                    else batches[0]
                blobs.append(pqe.encode_batch(whole, codec=codec,
                                              copy_stream=copy_stream))
            else:
                buf = io.BytesIO()
                papq.write_table(_empty_table(relation.schema), buf,
                                 compression=codec)
                blobs.append(buf.getvalue())
        if blobs:
            relation.blobs = blobs
            relation.device_encoded = True
            return

    blobs = []
    for it in result.plan.execute():
        tables = [t for t in it]
        # empty partitions cache as empty blobs so the cached relation
        # keeps the child's partition count (spark_partition_id /
        # monotonically_increasing_id stay cache-transparent)
        t = concat_tables(tables, result.plan.schema) if tables \
            else _empty_table(relation.schema)
        buf = io.BytesIO()
        papq.write_table(t, buf, compression=codec,
                         row_group_size=max(t.num_rows, 1))
        blobs.append(buf.getvalue())
    if not blobs:
        t = _empty_table(relation.schema)
        buf = io.BytesIO()
        papq.write_table(t, buf, compression=codec)
        blobs.append(buf.getvalue())
    relation.blobs = blobs


class CpuInMemoryTableScanExec(PhysicalPlan):
    """Host-side cached read.  ``device`` is the device the cache
    materializes on (``TpuOverrides.apply`` stamps the session's)."""

    is_tpu = False

    def __init__(self, relation: CachedRelation, conf, device="cuda"):
        super().__init__()
        self.relation = relation
        self.conf = conf
        self.device = device
        self.copy_stream = None

    @property
    def schema(self) -> Schema:
        return self.relation.schema

    def execute(self):
        materialize(self.relation, self.conf, self.device, self.copy_stream)

        def part(blob: bytes) -> Iterator[pa.Table]:
            yield papq.read_table(io.BytesIO(blob))

        return [part(b) for b in self.relation.blobs]

    def simple_string(self) -> str:
        return (f"CpuInMemoryTableScanExec("
                f"partitions={len(self.relation.blobs or [])})")


class TpuInMemoryTableScanExec(TpuExec):
    """Device-decoding cached read: each blob's row groups through the
    PERFILE reader on the session's device."""

    def __init__(self, relation: CachedRelation, conf, device="cuda"):
        super().__init__()
        self.relation = relation
        self.conf = conf
        self.device = resolve_device(device)
        self.copy_stream = None
        self.metrics.extra["fallbackColumns"] = 0

    @property
    def schema(self) -> Schema:
        return self.relation.schema

    def execute(self):
        from spark_rapids_tpu_torch.io import device_parquet as devpq
        from spark_rapids_tpu_torch.io import scan_cache as sc
        materialize(self.relation, self.conf, self.device, self.copy_stream)
        schema = self.schema
        # blob decodes reuse the scan-plan cache (content-keyed): a
        # re-collected cached relation skips the page walks.  The digests
        # memoize on the relation: the blobs are immutable, so K collects
        # must not pay K full-blob sha1 passes
        keys = getattr(self.relation, "_blob_keys", None)
        if keys is None or len(keys) != len(self.relation.blobs):
            keys = [sc.blob_key(b) for b in self.relation.blobs]
            self.relation._blob_keys = keys

        def part(blob: bytes, skey):
            pf = sc.blob_footer(blob)
            if not sc.enabled():
                skey = None
            for rg in range(pf.metadata.num_row_groups):
                with tpu_semaphore(self.metrics):
                    with timed(self.metrics, "cache.decode"):
                        batch, fallbacks = devpq.decode_row_group(
                            blob, rg, schema, parquet_file=pf,
                            source_key=skey, metrics=self.metrics,
                            device=self.device,
                            copy_stream=self.copy_stream)
                    self.metrics.extra["fallbackColumns"] += \
                        len(fallbacks)
                    self.metrics.add_rows(batch.num_rows)
                    self.metrics.add_batches()
                    yield batch

        return [part(b, k) for b, k in zip(self.relation.blobs, keys)]

    def simple_string(self) -> str:
        return (f"TpuInMemoryTableScanExec("
                f"partitions={len(self.relation.blobs or [])})")
