"""Entry points of the port.

``entry(device)``      — the counterpart of ``__graft_entry__.entry``: the
                         same 1024-row table and the same filter ->
                         compact -> update -> finalize step, as
                         ``(step, (batch,))`` with the batch on ``device``.
``q6_query(df)``       — the TPC-DS q6-class query of the reference's
                         bench (``bench.py:_query``) as DataFrame code:
                         filter ss_sales_price > 150.0, group by
                         ss_item_sk, count(*), sum(ss_quantity),
                         avg(ss_ext_sales_price).
``q6_plan(table, ...)`` — q6 over an in-memory table, planned by a port
                         session (api/session.py): CpuScanExec (pruned to
                         four columns) -> HostToDeviceExec ->
                         TpuHashAggregateExec(fused filter) ->
                         DeviceToHostExec.
``gen_store_sales``    — the bench's q6-class fact table, from a seed.
``write_store_sales(root, n, files)`` — the same table as the bench's
                         Parquet files (``bench.py:_write_dataset``).
``q6_parquet_plan(root, ...)`` — q6 over those files: TpuParquetScanExec
                         (fused decode, with the filter the planner
                         pushes into it) -> TpuHashAggregateExec ->
                         DeviceToHostExec.
``q6_perfile_plan(root, ...)`` — the same q6 with fused decode off (the
                         reference's key ``spark.rapids.tpu.sql.format.
                         parquet.fusedDecode.enabled`` false): the scan's
                         PERFILE reader, one batch per row group, decoded
                         column by column through ``expand_stream``.
``q6s_parquet_plan(root, ...)`` — the same filter grouped by the string
                         column ``ss_item_id`` (files written with
                         ``item_id=True``): count(*), sum(ss_quantity).

Each q6 form is DataFrame code on a port session with the bench's conf
(float aggregates allowed) plus the caller's ``conf``; the function
returns the planned physical plan, which :func:`collect` runs.  The
planner, not this module, fuses the filter and pushes it into the scan.
All of them run the port's kernels on ``cuda`` (the default, which raises
without a GPU) and their plain torch versions on ``cpu``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import torch

from spark_rapids_tpu_torch.columnar.batch import from_arrow, resolve_device
from spark_rapids_tpu_torch.config import RapidsTpuConf
from spark_rapids_tpu_torch.exec.tpu_aggregate import (finalize_aggregate,
                                                       make_spec,
                                                       update_aggregate)
from spark_rapids_tpu_torch.exec.tpu_basic import compact
from spark_rapids_tpu_torch.expr import eval_tpu, ir
from spark_rapids_tpu_torch.plan.logical import Schema


def _example_table(n: int = 1024) -> pa.Table:
    rng = np.random.default_rng(0)
    return pa.table({
        "k": pa.array(rng.integers(0, 32, n), type=pa.int32()),
        "price": pa.array(rng.uniform(0, 100, n)),
        "qty": pa.array(rng.integers(1, 10, n), type=pa.int64()),
    })


def _bind(schema: Schema, e: ir.Expression) -> ir.Expression:
    return ir.bind(e, schema.names, schema.dtypes, schema.nullables)


def _resolved(aggs) -> List[ir.AggregateExpression]:
    for a in aggs:
        a.resolve()
    return list(aggs)


def entry(device="cuda"):
    """Return (step, example_args): the filter + hash-aggregate step."""
    dev = resolve_device(device)
    table = _example_table()
    schema = Schema.from_arrow(table.schema)
    cond = _bind(schema, ir.GreaterThan(ir.UnresolvedAttribute("price"),
                                        ir.Literal(50.0)))
    groupings = [_bind(schema, ir.UnresolvedAttribute("k"))]
    aggregates = _resolved([
        ir.Count(None),
        ir.Sum(_bind(schema, ir.UnresolvedAttribute("qty"))),
        ir.Average(_bind(schema, ir.UnresolvedAttribute("price")))])
    specs = [make_spec(a) for a in aggregates]
    out_names = ["k", "cnt", "qty_sum", "price_avg"]

    def step(batch):
        v = eval_tpu.evaluate(cond, batch)
        filtered = compact(batch, v.data.to(torch.bool) & v.validity)
        partial = update_aggregate(filtered, groupings, aggregates, specs)
        return finalize_aggregate(partial, len(groupings), specs, out_names)

    return step, (from_arrow(table, device=dev),)


def gen_store_sales(n: int, seed: int = 42) -> pa.Table:
    """q6-class fact slice (the reference bench's generator): sold date
    fk, item fk, quantity, list / sales / extended sales price."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "ss_sold_date_sk": pa.array(
            rng.integers(1, 1827, n).astype(np.int64)),
        "ss_item_sk": pa.array(
            rng.integers(1, 18001, n).astype(np.int64)),
        "ss_quantity": pa.array(rng.integers(1, 101, n).astype(np.int32)),
        "ss_list_price": np.round(rng.uniform(1.0, 200.0, n), 2),
        "ss_sales_price": np.round(rng.uniform(0.2, 200.0, n), 2),
        "ss_ext_sales_price": np.round(rng.uniform(1.0, 20000.0, n), 2),
    })


Q6_OUT = ["ss_item_sk", "cnt", "qty", "aesp"]


def q6_plan(table: pa.Table, partitions: int = 8, device="cuda",
            max_batch_rows: int = 1 << 20, conf=None):
    """The q6 plan over ``table`` cut into ``partitions`` partitions of
    ``max_batch_rows``-row batches, planned by a port session: the
    planner prunes the upload to the four columns q6 reads and fuses the
    filter into the aggregate.  Run it with :func:`collect`."""
    session = _session(device, conf, **{
        "spark.rapids.tpu.sql.reader.batchSizeRows": max_batch_rows})
    return _planned(q6_query(session.create_dataframe(
        table, num_partitions=partitions)))


ITEM_ID_LEN = 16


def item_ids(item_sk: np.ndarray) -> pa.Array:
    """TPC-DS ``i_item_id``-style business keys: the item key as 16
    letters A-P, one per 4-bit digit, least significant first."""
    keys = np.arange(int(item_sk.max(initial=0)) + 1, dtype=np.int64)
    digits = (keys[:, None] >> (4 * np.arange(ITEM_ID_LEN))) & 15
    table = (digits + ord("A")).astype(np.uint8)
    ids = np.array([r.tobytes().decode("ascii") for r in table],
                   dtype=object)
    return pa.array(ids[item_sk], type=pa.string())


def write_store_sales(root: str, n: int, files: int = 8, seed: int = 100,
                      item_id: bool = False) -> List[str]:
    """Write ``n`` rows of :func:`gen_store_sales` as ``files`` Parquet
    files under ``root``, file i from seed ``seed + i`` — the reference
    bench's ``_write_dataset``: dictionary pages on ss_sold_date_sk,
    ss_item_sk and ss_quantity (and on ss_item_id, the string key of
    :func:`item_ids`, with ``item_id``).  The remainder of ``n // files``
    goes to the first files.  Returns the paths."""
    os.makedirs(root, exist_ok=True)
    dict_cols = ["ss_sold_date_sk", "ss_item_sk", "ss_quantity"]
    if item_id:
        dict_cols.append("ss_item_id")
    paths = []
    for i in range(files):
        rows = n // files + (1 if i < n % files else 0)
        t = gen_store_sales(rows, seed=seed + i)
        if item_id:
            t = t.append_column("ss_item_id", item_ids(
                t["ss_item_sk"].to_numpy()))
        path = os.path.join(root, f"part-{i:04d}.parquet")
        papq.write_table(t, path, use_dictionary=dict_cols)
        paths.append(path)
    return paths


def _session(device, conf=None, **settings):
    """A port session on ``device`` for one q6 form: the reference bench's
    conf (float aggregates allowed), the form's ``settings`` and then the
    caller's ``conf`` (a dict or :class:`RapidsTpuConf`) on top."""
    from spark_rapids_tpu_torch.api.session import TpuSparkSession
    merged = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    merged.update(settings)
    merged.update(conf._settings if isinstance(conf, RapidsTpuConf)
                  else conf or {})
    return TpuSparkSession(merged, device=device)


def q6_query(df):
    """The reference bench's q6 (``bench.py:_query``) over DataFrame
    ``df``: filter ss_sales_price > 150.0, group by ss_item_sk,
    count(*), sum(ss_quantity), avg(ss_ext_sales_price)."""
    from spark_rapids_tpu_torch.api import col, functions as F
    return (df.filter(col("ss_sales_price") > 150.0)
            .group_by("ss_item_sk")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_quantity").alias("qty"),
                 F.avg("ss_ext_sales_price").alias("aesp")))


def _planned(df):
    return df.session._plan_physical(df.plan).plan


def q6_parquet_plan(root: str, device="cuda", conf=None):
    """q6 over the Parquet files under ``root`` (:func:`write_store_sales`),
    planned by a port session: the planner prunes the scan to four
    columns, fuses the filter into the aggregate and pushes it into the
    fused scan.  Run it with :func:`collect`."""
    session = _session(device, conf)
    return _planned(q6_query(session.read.parquet(root)))


def q6_perfile_plan(root: str, device="cuda", conf=None):
    """q6 over the Parquet files under ``root`` through the scan's
    PERFILE reader (fused decode off).  Run it with :func:`collect`."""
    session = _session(device, conf, **{
        "spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled": False})
    return _planned(q6_query(session.read.parquet(root)))


Q6S_OUT = ["ss_item_id", "cnt", "qty"]


def q6s_parquet_plan(root: str, device="cuda", conf=None):
    """q6's filter grouped by the string key ``ss_item_id`` — count(*),
    sum(ss_quantity) — over files written with ``item_id=True``."""
    from spark_rapids_tpu_torch.api import col, functions as F
    session = _session(device, conf)
    df = (session.read.parquet(root)
          .filter(col("ss_sales_price") > 150.0)
          .group_by("ss_item_id")
          .agg(F.count("*").alias("cnt"),
               F.sum("ss_quantity").alias("qty")))
    return _planned(df)


def collect(plan) -> pa.Table:
    """Run a plan whose root yields Arrow tables; concatenate them."""
    tables = [t for it in plan.execute() for t in it]
    if not tables:
        return pa.Table.from_arrays(
            [pa.array([], type=f.dtype.to_arrow())
             for f in plan.schema.fields], names=plan.schema.names)
    return pa.concat_tables(tables)

