"""The port's TPC-H workload (``bench/tpch.py``, ``bench/runner.py``)
against the reference's.

  * ``generate(sf, seed)`` builds its string columns with numpy and Arrow
    but draws in the reference's order: ``Table.equals`` against the
    reference's tables at SF 0.002 and 0.01;
  * the eight SQL texts (``SQL_QUERIES``) through ``session.sql`` over
    temp views equal their DataFrame forms on the port, plan with no host
    node but the transitions, and plan the reference's device nodes;
  * q1-q11 (DataFrame forms) against the reference's device session
    (q12-q22 in ``tests/test_torch_tpch_b.py``);
  * ``BenchmarkRunner``'s report and ``CompareResults`` against the
    reference's.
"""

import json

import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu.bench import runner as jrunner
from spark_rapids_tpu.bench import tpch as jtpch

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.bench import runner as trunner
from spark_rapids_tpu_torch.bench import tpch as ttpch

from tests.parity import assert_tables_equal
from tests.tpch_parity import (CONF, check_query, data,  # noqa: F401
                               port_tables, ref_tables)
from tests.torch_threads import one_torch_thread  # noqa: F401

SQL_NAMES = sorted(ttpch.SQL_QUERIES, key=lambda q: int(q[1:]))
TRANSITIONS = {"HostToDeviceExec", "DeviceToHostExec", "CpuScanExec"}


@pytest.mark.parametrize("sf", [0.002, 0.01])
def test_generate_equals_reference(sf):
    ref = jtpch.generate(sf, seed=3)
    port = ttpch.generate(sf, seed=3)
    assert list(port) == list(ref) == ttpch.TPCH_TABLES
    for name in ref:
        assert port[name].equals(ref[name]), name
    assert ttpch.scale_counts(sf) == jtpch.scale_counts(sf)


def test_the_module_surface_matches_reference():
    assert sorted(ttpch.QUERIES) == sorted(jtpch.QUERIES)
    assert ttpch.SQL_QUERIES == jtpch.SQL_QUERIES
    assert ttpch.TPCH_TABLES == jtpch.TPCH_TABLES


@pytest.fixture(scope="module")
def sql_session(data):
    s = TSession(dict(CONF, **{"spark.rapids.tpu.sql.test.enabled": True}),
                 device="cpu")
    ttpch.setup_views(s, data)
    return s


@pytest.mark.parametrize("name", SQL_NAMES)
def test_sql_query_equals_dataframe_form(name, sql_session, port_tables):
    df = sql_session.sql(ttpch.SQL_QUERIES[name])
    nodes = []
    sql_session._plan_physical(df.plan).plan.foreach(
        lambda n: nodes.append(type(n).__name__))
    assert not [n for n in nodes if not n.startswith("Tpu")
                and n not in TRANSITIONS], nodes
    sql_out = df.collect()
    df_out = ttpch.QUERIES[name](port_tables).collect()
    assert sql_out.column_names == df_out.column_names
    assert_tables_equal(df_out, sql_out)


@pytest.mark.parametrize("name", SQL_NAMES)
def test_sql_query_plans_like_reference(name, data):
    names = {}
    for side, cls in (("ref", JSession), ("port", TSession)):
        s = cls(CONF) if side == "ref" else cls(CONF, device="cpu")
        (jtpch if side == "ref" else ttpch).setup_views(s, data)
        nodes = []
        s._plan_physical(s.sql(jtpch.SQL_QUERIES[name]).plan).plan.foreach(
            lambda n: nodes.append(type(n).__name__))
        names[side] = nodes
    assert names["port"] == names["ref"]


@pytest.mark.parametrize("name", [f"q{i}" for i in range(1, 12)])
def test_tpch_query_matches_reference_device_session(name, ref_tables,
                                                     port_tables):
    check_query(name, ref_tables, port_tables)


def test_setup_from_dir_reads_the_written_tables(data, tmp_path):
    small = {k: data[k] for k in ("region", "nation", "supplier")}
    ttpch.write_parquet(small, str(tmp_path))
    for name in ("lineitem", "orders", "customer", "part", "partsupp"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "part-00000.parquet").write_bytes(
            (tmp_path / "region" / "part-00000.parquet").read_bytes())
    s = TSession(CONF, device="cpu")
    tables = ttpch.setup_from_dir(s, str(tmp_path))
    assert sorted(tables) == sorted(ttpch.TPCH_TABLES)
    assert tables["supplier"].collect().equals(data["supplier"])


def test_benchmark_runner_report_matches_reference(data, tmp_path):
    reports = {}
    for side, cls, tp, rn in (("ref", JSession, jtpch, jrunner),
                              ("port", TSession, ttpch, trunner)):
        s = cls({"spark.rapids.tpu.sql.enabled": False}) if side == "ref" \
            else cls(CONF, device="cpu")
        r = rn.BenchmarkRunner(s, tp.setup(s, data), tp.QUERIES,
                               mode="cpu" if side == "ref" else "tpu")
        rep = r.run(names=["q6", "q1"], iterations=2, warmup=1)
        out = tmp_path / f"{side}.json"
        rep.write(str(out))
        parsed = json.loads(out.read_text())
        reports[side] = [(q["query"], len(q["iterations"]), q["rows"],
                          q["error"]) for q in parsed["queries"]]
        assert parsed["suite"] == "tpch"
        assert all(q.best <= q.mean for q in rep.queries)
    assert reports["port"] == reports["ref"] == [
        ("q6", 2, 1, None), ("q1", 2, 4, None)]
    bad = trunner.BenchmarkRunner(None, {}, {"q1": lambda t: t["x"]}).run()
    assert bad.queries[0].error == "KeyError('x')"
    assert bad.queries[0].iterations == []


def test_compare_results_matches_reference(data):
    t = data["nation"]
    shuffled = t.take(list(reversed(range(t.num_rows))))
    for ignore in (False, True):
        for a, b in ((t, t), (t, shuffled), (t, t.slice(1))):
            assert trunner.CompareResults(ignore_ordering=ignore) \
                .compare(a, b) == \
                jrunner.CompareResults(ignore_ordering=ignore).compare(a, b)
