"""The windowed TPC-DS queries and the 99-query census of the port.

The 14 extended queries that use ``Window`` (from
``bench/tpcds_queries_a/b/c.py``) run on a port session (``device="cpu"``,
test mode: no host node but the transitions) and on the reference's CPU
session over the same SF 0.002 tables: rows and their order exactly,
floats to ``tests/parity.py``'s tolerance; each plans its windows as
``TpuWindowExec``.  The census plans all 99 queries on the port without
running them: all 99 plan, and none keeps a host node besides the
transitions.
"""

import re

import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu.bench import tpcds as jtpcds

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.bench import tpcds as ttpcds

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

SF = 0.002
CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
WINDOWED = ("q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53", "q57",
            "q63", "q67", "q70", "q86", "q89")
# the queries the port cannot plan at SF 0.002, and the module each waits
# for: none (q97's full outer join plans as a shuffled hash join)
NOT_PLANNED = {}
# the queries that plan with a host node besides the transitions: none
# (q8, q15, q19, q45, q84 and q93 evaluate their substring, startswith and
# concat on the device)
HOST_NODES = {}


@pytest.fixture(scope="module")
def data():
    return jtpcds.generate(SF, seed=13)


@pytest.fixture(scope="module")
def ref_tables(data):
    return jtpcds.setup(JSession(dict(
        CONF, **{"spark.rapids.tpu.sql.enabled": False})), data)


@pytest.fixture(scope="module")
def port(data):
    s = TSession(dict(CONF, **{"spark.rapids.tpu.sql.test.enabled": True}),
                 device="cpu")
    return s, ttpcds.setup(s, data)


@pytest.mark.parametrize("name", WINDOWED)
def test_windowed_query_matches_reference(name, ref_tables, port):
    s, tables = port
    df = ttpcds.QUERIES[name](tables)
    nodes = []
    s._plan_physical(df.plan).plan.foreach(
        lambda n: nodes.append(type(n).__name__))
    assert "TpuWindowExec" in nodes and "CpuWindowExec" not in nodes, nodes
    ref = jtpcds.QUERIES[name](ref_tables).collect()
    got = df.collect()
    assert ref.num_rows > 0
    assert_tables_equal(ref, got)


def _census(s, tables):
    planned, waits, hosts = [], {}, {}
    for name, fn in ttpcds.QUERIES.items():
        try:
            plan = s._plan_physical(fn(tables).plan).plan
        except NotImplementedError as e:
            m = re.search(r"spark_rapids_tpu/(\S+?\.py)", str(e))
            waits[name] = m.group(1) if m else str(e)
            continue
        planned.append(name)
        names = []
        plan.foreach(lambda n: names.append(type(n).__name__))
        host = [n for n in names if n.startswith("Cpu")
                and n not in ("CpuScanExec", "CpuFileScanExec")]
        if host:
            hosts[name] = host
    return planned, waits, hosts


def test_census_of_the_99_queries(data):
    s = TSession(CONF, device="cpu")
    planned, waits, hosts = _census(s, ttpcds.setup(s, data))
    assert len(planned) + len(waits) == 99
    assert waits == NOT_PLANNED
    assert hosts == HOST_NODES
