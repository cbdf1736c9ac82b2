"""The first half of the TPC-DS queries no other port module runs, each
against the reference's CPU session at SF 0.002 (``tests/tpcds_parity.py``
says how)."""

import pytest

from tests.tpcds_parity import (HALVES, check_query, data,  # noqa: F401
                                port_tables, ref_tables)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", HALVES[0])
def test_query_matches_reference(name, ref_tables, port_tables):
    check_query(name, ref_tables, port_tables)
