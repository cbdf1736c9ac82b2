"""TPC-H q12-q22 (DataFrame forms) on the port against the reference's
device session; q1-q11 and the rest of the TPC-H checks are in
``tests/test_torch_tpch.py``, the fixtures in ``tests/tpch_parity.py``."""

import pytest

from tests.tpch_parity import (check_query, data, port_tables,  # noqa: F401
                               ref_tables)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", [f"q{i}" for i in range(12, 23)])
def test_tpch_query_matches_reference_device_session(name, ref_tables,
                                                     port_tables):
    check_query(name, ref_tables, port_tables)
