"""Whole-stage fusion in the port against the reference.

``bench.py::_probe_query`` (a q6 with its expression prologue: two
computed columns and a filter between the scan and the aggregate) must
fuse to the same shape as in the reference: the aggregate inlines the
same prologue (R2) and the plans hold the same fused stages (R1).  A
Project/Filter chain with no aggregate above it collapses into one stage
(R1), and a pure column selection into a passthrough stage.  In every
case the rows equal those with fusion off, and the reference's.
"""

import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.entry import write_store_sales

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True}
FUSION_OFF = {"spark.rapids.tpu.sql.fusion.enabled": False}
SIDES = {"ref": (JSession, jcol, JF), "port": (TSession, tcol, TF)}


def _probe(s, col, F, root):
    """``bench.py::_probe_query``'s expression."""
    return (s.read.parquet(root)
            .with_column("net", col("ss_ext_sales_price") -
                         col("ss_list_price"))
            .filter(col("ss_sales_price") > 150.0)
            .with_column("net_qty", col("net") * col("ss_quantity"))
            .group_by("ss_item_sk")
            .agg(F.count("*").alias("cnt"),
                 F.sum("net_qty").alias("nq")))


def _chain(s, col, F, root):
    return (s.read.parquet(root)
            .with_column("net", col("ss_ext_sales_price") -
                         col("ss_list_price"))
            .filter(col("ss_sales_price") > 150.0)
            .filter(col("net") > 0.0)
            .select("ss_item_sk", (col("net") * 2.0).alias("net2")))


def _passthrough(s, col, F, root):
    return s.read.parquet(root).select("ss_quantity", "ss_item_sk")


QUERIES = {"probe": _probe, "chain": _chain, "passthrough": _passthrough}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fusion_ss"))
    write_store_sales(d, 8000, files=2)
    return d


def _shape(plan):
    """Node names, each fused stage's (mode, fused execs) and each
    aggregate's inlined prologue and fused condition."""
    names, stages, aggs = [], [], []

    def one(n):
        name = type(n).__name__
        names.append(name)
        if name == "TpuFusedStageExec":
            stages.append((n.is_passthrough, n.condition is not None,
                           tuple(n.fused)))
        if name == "TpuHashAggregateExec":
            aggs.append((n.fused_prologue_execs, n.fused_prologue_saved,
                         None if n.fused_condition is None
                         else n.fused_condition.sql(),
                         [g.sql() for g in n.groupings],
                         [a.sql() for a in n.aggregates]))
    plan.foreach(one)
    return names, stages, aggs


@pytest.fixture(scope="module")
def runs(root):
    """(shape, rows) per (side, query, fusion on)."""
    out = {}
    for side, (cls, col, F) in SIDES.items():
        for q in QUERIES:
            for on in (True, False):
                conf = dict(CONF) if on else dict(CONF, **FUSION_OFF)
                s = cls(conf) if side == "ref" else cls(conf, device="cpu")
                df = QUERIES[q](s, col, F, root)
                out[(side, q, on)] = (_shape(s._plan_physical(df.plan).plan),
                                      df.collect())
    return out


@pytest.mark.parametrize("on", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("query", list(QUERIES))
def test_fusion_shape_matches_reference(runs, query, on):
    assert runs[("port", query, on)][0] == runs[("ref", query, on)][0]


def test_probe_query_inlines_its_prologue(runs):
    names, stages, aggs = runs[("port", "probe", True)][0]
    assert names == ["DeviceToHostExec", "TpuHashAggregateExec",
                     "TpuParquetScanExec"]
    ((execs, saved, cond, groupings, aggregates),) = aggs
    assert (execs, saved) == (3, 3) and cond is not None
    assert not stages


@pytest.mark.parametrize("query", ["chain", "passthrough"])
def test_chain_collapses_into_one_stage(runs, query):
    names, stages, _ = runs[("port", query, True)][0]
    assert names.count("TpuFusedStageExec") == 1
    (passthrough, has_cond, fused), = stages
    assert passthrough == (query == "passthrough")
    assert has_cond == (query == "chain")
    assert "TpuProjectExec" not in names and "TpuFilterExec" not in names


@pytest.mark.parametrize("query", list(QUERIES))
def test_fused_rows_equal_unfused_and_reference(runs, query):
    fused = runs[("port", query, True)][1]
    assert fused.num_rows > 0
    assert_tables_equal(runs[("port", query, False)][1], fused,
                        ignore_order=True)
    assert_tables_equal(runs[("ref", query, True)][1], fused,
                        ignore_order=True)
