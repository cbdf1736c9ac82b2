"""The port's session and planner against the reference session.

Each q6 form (in memory, over Parquet through the fused reader, through
the PERFILE reader by conf and by ``input_file_name()``, and q6s) is the
same DataFrame code run on a port ``TpuSparkSession`` (``device="cpu"``)
and on a reference ``TpuSparkSession`` with the same conf dict, over the
same files made with numpy from a seed.  Integers, nulls and row sets
must match exactly; floats to ``tests/parity.py``'s tolerance (rel 1e-9,
abs 1e-11).  The planned physical plans must have the same node names in
the same order.  Also: the CPU engine (``sql.enabled=false``) against the
reference's, an expression the port lacks falling back with the
reference's reason text, and test mode rejecting an unexpected CPU node.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.csv  # noqa: F401  (pa.csv)
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.entry import gen_store_sales, write_store_sales

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

ROWS = 12_000
FILES = 2
BASE = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True}
PERFILE_OFF = {"spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled":
               False}
IFN_OK = {"spark.rapids.tpu.sql.test.allowedNonTpu": "CpuProjectExec"}
# (reference or port session class, col, functions)
SIDES = {"ref": (JSession, jcol, JF), "port": (TSession, tcol, TF)}


def session(side: str, conf: dict):
    cls = SIDES[side][0]
    return cls(conf) if side == "ref" else cls(conf, device="cpu")


def q6(df, col, F):
    """``bench.py::_query``'s expression over ``df``."""
    return (df.filter(col("ss_sales_price") > 150.0)
            .group_by("ss_item_sk")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_quantity").alias("qty"),
                 F.avg("ss_ext_sales_price").alias("aesp")))


def _memory(s, col, F, root):
    return q6(s.create_dataframe(gen_store_sales(ROWS, seed=7),
                                 num_partitions=3), col, F)


def _parquet(s, col, F, root):
    return q6(s.read.parquet(root), col, F)


def _input_file(s, col, F, root):
    return q6(s.read.parquet(root), col, F).with_column(
        "file", F.input_file_name())


def _q6s(s, col, F, root):
    return (s.read.parquet(root)
            .filter(col("ss_sales_price") > 150.0)
            .group_by("ss_item_id")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_quantity").alias("qty")))


# form -> (DataFrame maker, extra conf)
FORMS = {
    "memory": (_memory, {"spark.rapids.tpu.sql.reader.batchSizeRows":
                         4096}),
    "fused": (_parquet, {}),
    "perfile_conf": (_parquet, PERFILE_OFF),
    "perfile_input_file": (_input_file, IFN_OK),
    "q6s": (_q6s, {}),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("session_ss"))
    write_store_sales(d, ROWS, files=FILES, item_id=True)
    return d


def _run(side: str, form: str, root: str, conf: dict):
    build, extra = FORMS[form]
    s = session(side, dict(conf, **extra))
    _, col, F = SIDES[side]
    df = build(s, col, F, root)
    names = []
    s._plan_physical(df.plan).plan.foreach(
        lambda n: names.append(type(n).__name__))
    return df.collect(), names


@pytest.fixture(scope="module")
def results(root):
    """(table, plan node names) per (side, form), each run once."""
    return {(side, form): _run(side, form, root, BASE)
            for form in FORMS for side in SIDES}


def _pyarrow_q6(root, key="ss_item_sk"):
    t = papq.read_table(root)
    f = t.filter(pc.greater(t["ss_sales_price"], 150.0))
    aggs = [(key, "count"), ("ss_quantity", "sum")]
    if key == "ss_item_sk":
        aggs.append(("ss_ext_sales_price", "mean"))
    return f.group_by(key).aggregate(aggs).sort_by(key)


@pytest.mark.parametrize("form", list(FORMS))
def test_q6_form_matches_reference_session(results, form):
    ref, port = results[("ref", form)][0], results[("port", form)][0]
    assert port.num_rows > 100
    assert_tables_equal(ref, port, ignore_order=True)


@pytest.mark.parametrize("form", list(FORMS))
def test_q6_form_plan_matches_reference_session(results, form):
    ref, port = results[("ref", form)][1], results[("port", form)][1]
    assert port == ref
    assert "TpuHashAggregateExec" in port


@pytest.mark.parametrize("form", ["fused", "perfile_conf",
                                  "perfile_input_file", "q6s"])
def test_q6_form_matches_pyarrow(results, root, form):
    out = results[("port", form)][0]
    key = "ss_item_id" if form == "q6s" else "ss_item_sk"
    want = _pyarrow_q6(root, key)
    out = out.sort_by(key)
    assert out[key].to_pylist() == want[key].to_pylist()
    assert out["cnt"].to_pylist() == want[f"{key}_count"].to_pylist()
    assert out["qty"].to_pylist() == want["ss_quantity_sum"].to_pylist()
    if key == "ss_item_sk":
        a = out["aesp"].to_numpy()
        r = want["ss_ext_sales_price_mean"].to_numpy()
        assert np.all(np.abs(a - r) <= 1e-9 * np.abs(r))
    if form == "perfile_input_file":
        # the scan is exhausted when the projection above the aggregate
        # runs: Spark's empty-string default
        assert set(out["file"].to_pylist()) == {""}


def test_in_memory_upload_is_pruned_to_the_four_q6_columns():
    s = session("port", BASE)
    df = _memory(s, tcol, TF, None)
    scans = []
    s._plan_physical(df.plan).plan.foreach(
        lambda n: scans.append(n) if type(n).__name__ == "CpuScanExec"
        else None)
    assert [sc.table.column_names for sc in scans] == [
        ["ss_item_sk", "ss_quantity", "ss_sales_price",
         "ss_ext_sales_price"]]


@pytest.mark.parametrize("form", ["memory", "fused"])
def test_sql_disabled_matches_reference_cpu_engine(root, form):
    conf = {"spark.rapids.tpu.sql.enabled": False}
    (ref, ref_names), (port, port_names) = (
        _run(side, form, root, conf) for side in ("ref", "port"))
    assert_tables_equal(ref, port, ignore_order=True)
    assert port_names == ref_names
    assert not any(n.startswith("Tpu") for n in port_names)


def _strings(s):
    rng = np.random.default_rng(3)
    words = np.array(["alpha", "Beta", "gamma", None, "DELTA", "eps"],
                     dtype=object)
    t = pa.table({"s": pa.array(words[rng.integers(0, 6, 300)],
                                type=pa.string()),
                  "v": pa.array(rng.integers(0, 100, 300))})
    return s.create_dataframe(t)


def test_unported_expression_falls_back_with_reference_reason():
    conf = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    outs = {}
    for side, (_, col, F) in SIDES.items():
        df = _strings(session(side, conf)).select(
            F.substring_index(col("s"), "a", 1).alias("u"),
            (col("v") + 1).alias("w"))
        outs[side] = df.collect()
        if side == "port":
            why = df.explain_string("tpu")
    assert ("!Exec <ProjectExec> cannot run on TPU because expression "
            "SubstringIndex is not supported on TPU") in why
    assert_tables_equal(outs["ref"], outs["port"])


def test_test_mode_rejects_an_unexpected_cpu_node():
    df = _strings(session("port", BASE)).select(
        TF.substring_index(tcol("s"), "a", 1).alias("u"))
    with pytest.raises(AssertionError, match="CpuProjectExec"):
        df.collect()
    allowed = _strings(session("port", dict(BASE, **{
        "spark.rapids.tpu.sql.test.allowedNonTpu": "CpuProjectExec"})))
    out = allowed.select(
        TF.substring_index(tcol("s"), "a", 1).alias("u")).collect()
    assert "Bet" in out["u"].to_pylist()


def test_session_needs_a_device():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError):
        TSession(BASE)


# -- the other device execs the overrides convert to -------------------------

def _keyed(s, n=3000):
    rng = np.random.default_rng(5)
    return s.create_dataframe(pa.table({
        "k": pa.array(rng.integers(0, 12, n)),
        "v": pa.array(rng.integers(-50, 50, n)),
    }), num_partitions=3)


# name -> (make(session, col, F), device exec the port must plan)
BASIC = {
    "range": (lambda s, col, F: s.range(0, 5000, 3, num_partitions=3)
              .filter(col("id") > 2000), "TpuRangeExec"),
    "union": (lambda s, col, F: _keyed(s).filter(col("v") > 0).union(
        _keyed(s).filter(col("v") < -40)), "TpuUnionExec"),
    "limit": (lambda s, col, F: _keyed(s).select(
        (col("k") * 10 + col("v")).alias("kv")).limit(1234),
        "TpuGlobalLimitExec"),
    "rollup": (lambda s, col, F: _keyed(s).rollup("k").agg(
        F.sum("v").alias("sv"), F.count("*").alias("c")), "TpuExpandExec"),
}


@pytest.mark.parametrize("name", list(BASIC))
def test_basic_exec_matches_reference(name):
    build, exec_name = BASIC[name]
    outs, names = {}, {}
    for side, (_, col, F) in SIDES.items():
        s = session(side, BASE)
        df = build(s, col, F)
        names[side] = []
        s._plan_physical(df.plan).plan.foreach(
            lambda n: names[side].append(type(n).__name__))
        outs[side] = df.collect()
    assert exec_name in names["port"]
    assert names["port"] == names["ref"]
    assert outs["port"].num_rows > 0
    assert_tables_equal(outs["ref"], outs["port"],
                        ignore_order=(name != "limit"))


@pytest.mark.parametrize("goal", ["target", "single"])
def test_coalesce_batches(goal):
    from spark_rapids_tpu_torch.entry import collect
    from spark_rapids_tpu_torch.exec.base import (REQUIRE_SINGLE_BATCH,
                                                  TargetSize)
    from spark_rapids_tpu_torch.exec.cpu import CpuScanExec
    from spark_rapids_tpu_torch.exec.tpu_basic import (
        DeviceToHostExec, HostToDeviceExec, TpuCoalesceBatchesExec)
    t = gen_store_sales(3000, seed=9)
    up = HostToDeviceExec(CpuScanExec(t, 2, 256), device="cpu")
    node = TpuCoalesceBatchesExec(
        up, TargetSize(1 << 30) if goal == "target" else REQUIRE_SINGLE_BATCH)
    parts = [list(it) for it in node.execute()]
    assert [len(p) for p in parts] == ([1, 1] if goal == "target" else [1])
    out = collect(DeviceToHostExec(TpuCoalesceBatchesExec(
        HostToDeviceExec(CpuScanExec(t, 2, 256), device="cpu"),
        node.goal)))
    assert out.equals(t)


def test_partitions_drain_on_threads_in_order():
    """concurrentTpuTasks threads, one device: the same rows, in
    partition order, as one thread."""
    outs = []
    for tasks in (1, 4):
        s = session("port", dict(BASE, **{
            "spark.rapids.tpu.sql.concurrentTpuTasks": tasks}))
        df = s.create_dataframe(gen_store_sales(4000, seed=2),
                                num_partitions=6).select(
            tcol("ss_item_sk"), (tcol("ss_quantity") * 2).alias("q2"))
        outs.append(df.collect())
    assert outs[0].equals(outs[1])
    assert outs[0].num_rows == 4000


def test_kernel_counters_lose_no_update_across_threads():
    import sys
    import threading
    from spark_rapids_tpu_torch.kernels import backend as kb
    kb.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                kb.record_launch("stress.launch")
                kb.record_fallback("stress", "reason")
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kb.launches == {"stress.launch": 16000}
    assert kb.fallbacks == {"stress.reason": 16000}
    kb.reset_counts()


def test_csv_scan_decodes_on_the_host_and_matches_reference(tmp_path):
    """Under the CSV kill switch the scan decodes on the host with the
    reference's reason (the device CSV scan has its own tests,
    tests/test_torch_device_csv.py)."""
    path = str(tmp_path / "t.csv")
    pa.csv.write_csv(gen_store_sales(2000, seed=4), path)
    outs = {}
    for side, (_, col, F) in SIDES.items():
        s = session(side, {
            "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
            "spark.rapids.tpu.sql.format.csv.deviceDecode.enabled": False})
        df = q6(s.read.csv(path), col, F)
        outs[side] = df.collect()
        if side == "port":
            why = df.explain_string("tpu")
    assert ("csv device decode disabled by "
            "spark.rapids.tpu.sql.format.csv.deviceDecode.enabled") in why
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "perfile"])
def test_parquet_partitions_drain_on_threads(root, fused):
    """A filter+project over the Parquet scan (one fused stage, the
    filter pushed into the scan) drained on four threads: the rows of one
    thread, in partition order, and the reference's."""
    conf = dict(BASE, **{
        "spark.rapids.tpu.sql.reader.batchSizeRows": 2048,
        "spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled": fused})
    outs = {}
    for side, tasks in (("ref", 1), ("port", 1), ("port", 4)):
        _, col, F = SIDES[side]
        s = session(side, dict(conf, **{
            "spark.rapids.tpu.sql.concurrentTpuTasks": tasks}))
        df = (s.read.parquet(root).filter(col("ss_sales_price") > 100.0)
              .select("ss_item_id", "ss_quantity", "ss_item_sk"))
        outs[(side, tasks)] = df.collect()
    assert outs[("port", 4)].equals(outs[("port", 1)])
    assert_tables_equal(outs[("ref", 1)], outs[("port", 4)])
