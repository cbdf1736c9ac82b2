"""Shared set-up of the port's TPC-DS parity modules
(``tests/test_torch_tpcds_all_a.py`` and ``_b.py``).

Every query of ``bench/tpcds.QUERIES`` that ``tests/test_torch_tpcds.py``
(the module's own ten) and ``tests/test_torch_tpcds_windows.py`` (the 14
windowed ones) do not run is run here on a port session
(``device="cpu"``, test mode) and on the reference's CPU session over the
same ``generate(0.002, seed=13)`` tables: rows and their order exactly,
floats to ``tests/parity.py``'s tolerance.  The remaining queries split
in two halves, one per module, so each file stays well inside its time
budget under the suite's workers.
"""

import re

import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu.bench import tpcds as jtpcds

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.bench import tpcds as ttpcds

from tests.parity import assert_tables_equal

SF = 0.002
CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
# the queries the other two modules run
OWN = ("q3", "q7", "q19", "q42", "q52", "q55", "q68", "q73", "q96", "q98")
WINDOWED = ("q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53", "q57",
            "q63", "q67", "q70", "q86", "q89")
REST = sorted((q for q in ttpcds.QUERIES if q not in OWN + WINDOWED),
              key=lambda q: int(re.sub(r"\D", "", q)))
HALVES = (REST[:len(REST) // 2], REST[len(REST) // 2:])


@pytest.fixture(scope="module")
def data():
    return jtpcds.generate(SF, seed=13)


@pytest.fixture(scope="module")
def ref_tables(data):
    return jtpcds.setup(JSession(dict(
        CONF, **{"spark.rapids.tpu.sql.enabled": False})), data)


@pytest.fixture(scope="module")
def port_tables(data):
    """The tables on a port session in test mode: no host node but the
    transitions."""
    test = dict(CONF, **{"spark.rapids.tpu.sql.test.enabled": True})
    return ttpcds.setup(TSession(test, device="cpu"), data)


def check_query(name, ref_tables, port_tables):
    ref = jtpcds.QUERIES[name](ref_tables).collect()
    got = ttpcds.QUERIES[name](port_tables).collect()
    assert_tables_equal(ref, got)
    return got
