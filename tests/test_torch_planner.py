"""The port's optimizer and overrides against the reference's.

``prune_columns`` narrows the scans of the plans of
``tests/test_column_pruning.py`` to the same schemas as the reference's;
the per-exec kill switch keeps a filter on the CPU; the gates of
``_push_scan_filters`` (a shared scan with two consumers, a
``spark_partition_id()`` barrier, ``kernel.backend=xla``) leave no
stamp; and a plan that reads ``input_file_name()`` turns the scan's
fused reader off.  Everything runs on CPU tensors.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.plan import logical as jlp
from spark_rapids_tpu.plan.optimizer import prune_columns as jprune

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.window import Window as TWindow
from spark_rapids_tpu_torch.entry import write_store_sales
from spark_rapids_tpu_torch.exec.tpu_basic import TpuFilterExec, TpuUnionExec
from spark_rapids_tpu_torch.plan import logical as tlp
from spark_rapids_tpu_torch.plan import overrides as tov
from spark_rapids_tpu_torch.plan.optimizer import prune_columns as tprune

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
# side -> (session class, col, functions, Window, logical module, prune)
SIDES = {"ref": (JSession, jcol, JF, JWindow, jlp, jprune),
         "port": (TSession, tcol, TF, TWindow, tlp, tprune)}


def session(side: str, conf: dict):
    cls = SIDES[side][0]
    return cls(conf) if side == "ref" else cls(conf, device="cpu")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The tables of tests/test_column_pruning.py."""
    d = tmp_path_factory.mktemp("prune")
    rng = np.random.default_rng(0)
    a = pa.table({"x": pa.array(rng.integers(0, 100, 500)),
                  "k": pa.array(rng.integers(0, 20, 500)),
                  "z": pa.array(rng.uniform(0, 1, 500))})
    b = pa.table({"y": pa.array(rng.integers(100, 200, 20)),
                  "k2": pa.array(np.arange(20)),
                  "w": pa.array(rng.uniform(0, 1, 20))})
    (d / "a").mkdir()
    (d / "b").mkdir()
    papq.write_table(a, str(d / "a" / "a.parquet"))
    papq.write_table(b, str(d / "b" / "b.parquet"))
    return str(d / "a"), str(d / "b")


def _filter_agg(s, col, F, W, a, b):
    return (s.read.parquet(a).filter(col("z") > 0.5)
            .group_by("k").agg(F.sum("x").alias("sx")))


def _count_star(s, col, F, W, a, b):
    return s.read.parquet(a).group_by("k").agg(F.count("*").alias("c"))


def _join(s, col, F, W, a, b):
    return (s.read.parquet(a).join(s.read.parquet(b),
                                   on=(col("k") == col("k2")), how="inner")
            .select("x", "y"))


def _window(s, col, F, W, a, b):
    w = W.partition_by("k").order_by("x")
    return s.read.parquet(a).select("k", "x",
                                    F.row_number().over(w).alias("rn"))


def _union(s, col, F, W, a, b):
    lo = s.read.parquet(a).filter(col("x") < 50).select("k")
    hi = s.read.parquet(a).filter(col("x") >= 50).select("k")
    return lo.union(hi).group_by("k").agg(F.count("*").alias("c"))


PLANS = {"filter_agg": _filter_agg, "count_star": _count_star,
         "join": _join, "window": _window, "union": _union}


def _scan_schemas(side, plan):
    lp = SIDES[side][4]
    out = []

    def walk(n):
        if isinstance(n, lp.FileScan):
            out.append(n.schema.names)
        for c in n.children:
            walk(c)
    walk(plan)
    return out


@pytest.mark.parametrize("name", list(PLANS))
def test_prune_columns_matches_reference(roots, name):
    got = {}
    for side, (_, col, F, W, _lp, prune) in SIDES.items():
        df = PLANS[name](session(side, CONF), col, F, W, *roots)
        got[side] = _scan_schemas(side, prune(df.plan))
    assert got["port"] == got["ref"]
    assert all("z" not in s and "w" not in s for s in got["port"]) or \
        name == "filter_agg"


@pytest.mark.parametrize("name", ["filter_agg", "count_star", "join",
                                  "window", "union"])
def test_pruned_plans_match_reference_rows(roots, name):
    outs = {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        outs[side] = PLANS[name](session(side, CONF), col, F, W,
                                 *roots).collect()
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)


def test_unported_exec_raises_naming_its_module(roots):
    """A pandas UDF waits for pyworker/execs.py; the two-stage aggregate
    (``agg.exchange.enabled``) plans as the reference's, a hash exchange
    under a per-partition aggregate, and gives its rows."""
    a = session("port", CONF).read.parquet(roots[0])
    plus_one = TF.pandas_udf(lambda x: x + 1, "long")
    df = a.select("k", plus_one(tcol("x")).alias("e"))
    with pytest.raises(NotImplementedError, match="pyworker/execs.py"):
        df.collect()
    conf = dict(CONF, **{"spark.rapids.tpu.sql.agg.exchange.enabled": True,
                         "spark.rapids.tpu.sql.adaptive.enabled": False})
    names, outs = {}, {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, conf)
        agg = _count_star(s, col, F, W, *roots)
        names[side] = [type(n).__name__ for n in _nodes(s, agg)]
        outs[side] = agg.collect()
    assert names["port"] == names["ref"]
    assert "TpuShuffleExchangeExec" in names["port"]
    assert_tables_equal(outs["ref"], outs["port"])


def test_two_stage_aggregate_at_default_adaptive(roots):
    """The two-stage aggregate's hash exchange is not a join exchange:
    with adaptive reads on (the default) it stays bare in both packages,
    node for node, and gives the reference's rows."""
    conf = dict(CONF, **{"spark.rapids.tpu.sql.agg.exchange.enabled": True})
    names, outs = {}, {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, conf)
        agg = _count_star(s, col, F, W, *roots)
        names[side] = [type(n).__name__ for n in _nodes(s, agg)]
        outs[side] = agg.collect()
    assert names["port"] == names["ref"]
    assert "TpuAdaptiveJoinReaderExec" not in names["port"]
    assert_tables_equal(outs["ref"], outs["port"])


def _nodes(s, df):
    out = []
    s._plan_physical(df.plan).plan.foreach(out.append)
    return out


def _write_small(tmp_path, fmt: str, name: str = "t") -> str:
    import pyarrow.csv as pacsv
    import pyarrow.orc as paorc
    t = pa.table({"k": pa.array(np.arange(40) % 7),
                  "v": pa.array(np.arange(40) * 0.5)})
    path = str(tmp_path / f"{name}.{fmt}")
    (pacsv.write_csv if fmt == "csv" else paorc.write_table)(t, path)
    return path


def _scan_agg(s, fmt, path, col, F):
    return getattr(s.read, fmt)(path).filter(col("k") > 2) \
        .group_by("k").agg(F.sum("v").alias("sv"))


@pytest.mark.parametrize("fmt", ["csv", "orc"])
def test_csv_and_orc_scans_plan_on_the_device(tmp_path, fmt):
    """A CSV or ORC scan plans as TpuCsvScanExec / TpuOrcScanExec, the
    reference's plan node for node, and gives the reference's rows."""
    path = _write_small(tmp_path, fmt)
    names, outs = {}, {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, CONF)
        df = _scan_agg(s, fmt, path, col, F)
        names[side] = [type(n).__name__ for n in _nodes(s, df)]
        if side == "port":
            outs[side] = df.collect()
        else:
            outs[side] = _scan_agg(
                session(side, {"spark.rapids.tpu.sql.enabled": False}),
                fmt, path, col, F).collect()
    assert names["port"] == names["ref"]
    want = "TpuCsvScanExec" if fmt == "csv" else "TpuOrcScanExec"
    assert names["port"][-1] == want
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)


@pytest.mark.parametrize("fmt", ["csv", "orc"])
def test_csv_and_orc_scans_stay_on_the_host(tmp_path, fmt):
    """Under the format's device-decode kill switch a CSV or ORC scan
    plans as a host CpuFileScanExec with the reference's reason, under an
    upload, and gives the reference's rows."""
    path = _write_small(tmp_path, fmt)
    key = f"spark.rapids.tpu.sql.format.{fmt}.deviceDecode.enabled"
    outs = {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, dict(CONF, **{key: False}) if side == "port" else
                    {"spark.rapids.tpu.sql.enabled": False})
        df = _scan_agg(s, fmt, path, col, F)
        outs[side] = df.collect()
        if side == "port":
            names = [type(n).__name__ for n in _nodes(s, df)]
            assert names[-2:] == ["HostToDeviceExec", "CpuFileScanExec"]
            assert f"{fmt} device decode disabled by {key}" in \
                df.explain_string("tpu")
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)


def test_csv_scan_with_hive_partitions_stays_on_the_host(tmp_path):
    """A CSV scan with Hive partition columns stays on the host with the
    reference's reason (the device CSV scan appends none), node for node
    the reference's plan."""
    for part in (0, 1):
        (tmp_path / f"p={part}").mkdir()
        _write_small(tmp_path / f"p={part}", "csv")
    names, outs, why = {}, {}, {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, CONF)
        df = s.read.csv(str(tmp_path)).group_by("p").agg(
            F.sum("v").alias("sv"))
        names[side] = [type(n).__name__ for n in _nodes(s, df)]
        why[side] = df.explain_string("tpu")
        outs[side] = df.collect() if side == "port" else \
            s.read.csv(str(tmp_path)).group_by("p").agg(
                F.sum("v").alias("sv")).collect()
    assert names["port"] == names["ref"]
    assert names["port"][-1] == "CpuFileScanExec"
    for w in why.values():
        assert "csv device decode does not yet append Hive partition " \
            "columns" in w
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)


def test_filter_kill_switch(roots):
    conf = dict(CONF, **{"spark.rapids.tpu.sql.exec.FilterExec": False})
    names, outs = {}, {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, conf)
        df = s.read.parquet(roots[0]).filter(col("z") > 0.5).select(
            (col("x") + col("k")).alias("xk"))
        names[side] = [type(n).__name__ for n in _nodes(s, df)]
        outs[side] = df.collect()
        if side == "port":
            why = df.explain_string("tpu")
    assert names["port"] == names["ref"]
    assert "CpuFilterExec" in names["port"]
    assert "TpuFilterExec" not in names["port"]
    assert ("cannot run on TPU because disabled by "
            "spark.rapids.tpu.sql.exec.FilterExec") in why
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)


@pytest.fixture(scope="module")
def store_sales(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("planner_ss"))
    write_store_sales(d, 6000, files=2)
    return d


def _q6(df, col, F):
    return (df.filter(col("ss_sales_price") > 150.0)
            .group_by("ss_item_sk")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_quantity").alias("qty")))


def _scan(nodes):
    """The one device Parquet scan of either package's plan."""
    (scan,) = [n for n in nodes
               if type(n).__name__ == "TpuParquetScanExec"]
    return scan


def _stamp(scan):
    """The pushed condition (the reference's scan has the attribute only
    once stamped)."""
    return getattr(scan, "_pushed_filter", None)


def test_filter_is_pushed_into_a_single_consumer_scan(store_sales):
    s = session("port", CONF)
    nodes = _nodes(s, _q6(s.read.parquet(store_sales), tcol, TF))
    scan = _scan(nodes)
    assert scan._pushed_filter is not None and scan.allow_fused
    assert {n._kernel_backend for n in nodes} == {"pallas"}


def test_shared_scan_keeps_no_stamp(store_sales):
    """A scan feeding two consumers must keep real values."""
    s = session("port", CONF)
    nodes = _nodes(s, s.read.parquet(store_sales).filter(
        tcol("ss_sales_price") > 150.0))
    (filt,) = [n for n in nodes if isinstance(n, TpuFilterExec)]
    scan = _scan(nodes)
    assert scan._pushed_filter is filt.condition   # the planner's stamp
    scan._pushed_filter = None
    other = TpuFilterExec(scan, filt.condition)
    tov._push_scan_filters(TpuUnionExec([filt, other]))
    assert scan._pushed_filter is None
    tov._push_scan_filters(filt)           # one consumer: stamped
    assert scan._pushed_filter is filt.condition


def test_partition_id_barrier_keeps_no_stamp(store_sales):
    outs = {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, CONF)
        df = (s.read.parquet(store_sales)
              .filter((col("ss_sales_price") > 150.0) &
                      (F.spark_partition_id() >= 0))
              .group_by("ss_item_sk").agg(F.count("*").alias("cnt")))
        assert _stamp(_scan(_nodes(s, df))) is None
        outs[side] = df.collect()
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)


def test_xla_backend_keeps_no_stamp(store_sales):
    conf = dict(CONF, **{"spark.rapids.tpu.kernel.backend": "xla"})
    outs = {}
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, conf)
        df = _q6(s.read.parquet(store_sales), col, F)
        nodes = _nodes(s, df)
        assert _stamp(_scan(nodes)) is None
        assert {n._kernel_backend for n in nodes} == {"xla"}
        outs[side] = df.collect()
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)


def test_input_file_name_turns_the_fused_reader_off(store_sales):
    for side, (_, col, F, W, _lp, _p) in SIDES.items():
        s = session(side, CONF)
        scan = _scan(_nodes(s, _q6(s.read.parquet(store_sales), col, F)
                            .with_column("f", F.input_file_name())))
        assert scan.allow_fused is False
        # the push ran before the gate: the PERFILE scan carries a stamp
        # it ignores
        assert _stamp(scan) is not None
