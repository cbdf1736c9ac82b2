"""Shared fixtures of the port's TPC-H parity files
(``tests/test_torch_tpch.py``, ``tests/test_torch_tpch_b.py``).

The 22 DataFrame queries run at SF 0.002 (seed 7) on a port session
(``device="cpu"``) and on the reference's device session on the JAX CPU
backend; the reference's side is computed once per module, query by
query, and the two files split the queries so that neither holds all of
the reference's compiles.
"""

import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu.bench import tpch as jtpch

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.bench import tpch as ttpch

from tests.parity import assert_tables_equal

SF = 0.002
SEED = 7
CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
# queries whose final sort key can tie (or that have no total order),
# compared order-independently as the reference's tests/test_tpch.py does
IGNORE_ORDER = {"q2", "q10", "q16", "q18", "q21"}


@pytest.fixture(scope="module")
def data():
    return jtpch.generate(SF, seed=SEED)


@pytest.fixture(scope="module")
def ref_tables(data):
    return jtpch.setup(JSession(CONF), data)


@pytest.fixture(scope="module")
def port_tables(data):
    return ttpch.setup(TSession(CONF, device="cpu"), data)


def check_query(name, ref_tables, port_tables):
    ref = jtpch.QUERIES[name](ref_tables).collect()
    port = ttpch.QUERIES[name](port_tables).collect()
    assert_tables_equal(ref, port, ignore_order=name in IGNORE_ORDER)
    return port
