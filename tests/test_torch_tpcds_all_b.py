"""The second half of the TPC-DS queries no other port module runs, each
against the reference's CPU session at SF 0.002 (``tests/tpcds_parity.py``
says how), and q97's plan: the full outer join of its two channels is a
shuffled hash join over two exchanges, each read through the adaptive
reader (``sql.adaptive.enabled``, on by default in both packages)."""

import pytest

from spark_rapids_tpu_torch.bench import tpcds as ttpcds

from tests.tpcds_parity import (HALVES, check_query, data,  # noqa: F401
                                port_tables, ref_tables)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", HALVES[1])
def test_query_matches_reference(name, ref_tables, port_tables):
    check_query(name, ref_tables, port_tables)


def test_q97_plans_a_full_shuffled_join(port_tables):
    df = ttpcds.QUERIES["q97"](port_tables)
    nodes = []
    df.session._plan_physical(df.plan).plan.foreach(nodes.append)
    names = [type(n).__name__ for n in nodes]
    (join,) = [n for n in nodes if type(n).__name__ ==
               "TpuShuffledHashJoinExec"]
    assert join.how == "full"
    assert [type(c).__name__ for c in join.children] == \
        ["TpuAdaptiveJoinReaderExec"] * 2
    assert [type(c.children[0]).__name__ for c in join.children] == \
        ["TpuShuffleExchangeExec"] * 2
    assert not [n for n in names if n.startswith("Cpu") and
                n not in ("CpuScanExec", "CpuFileScanExec")], names
    (row,) = df.collect().to_pylist()
    assert sum(row.values()) > 0, row
