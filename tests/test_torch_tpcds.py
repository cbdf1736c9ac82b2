"""The port's TPC-DS-like module and its queries vs the reference's.

``generate`` must equal the reference's table for table.  Every query of
the module's own ten (``OWN``) runs on a port session (``device="cpu"``)
and a reference session over the same tables and is compared as
``tests/test_tpcds.py`` compares the reference's sessions (the 89
merged in from ``tpcds_queries_a/b/c.py`` are in
``tests/test_torch_tpcds_windows.py``, the windowed ones, and
``tests/test_torch_tpcds_all_a.py`` / ``_b.py``, the rest).  The star queries
(q3/q42/q52/q55) are compared row for row, must plan with no host node
but the transitions, and each of their joins must take the reference's
route.
"""

import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu.bench import tpcds as jtpcds
from spark_rapids_tpu.bench.runner import CompareResults
from spark_rapids_tpu.exec import tpu_join as jjoin

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.bench import tpcds as ttpcds
from spark_rapids_tpu_torch.obs import registry as obsreg

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

SF = 0.002
STAR = ("q3", "q42", "q52", "q55")
# the reference module's own queries (its QUERIES literal, before it
# merges in tpcds_queries_a/b/c.py)
OWN = ("q3", "q7", "q19", "q42", "q52", "q55", "q68", "q73", "q96", "q98")
CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True}


@pytest.fixture(scope="module")
def data():
    return jtpcds.generate(SF, seed=13)


@pytest.fixture(scope="module")
def sessions(data):
    js, ts = JSession(CONF), TSession(CONF, device="cpu")
    return (jtpcds.setup(js, data), ttpcds.setup(ts, data))


@pytest.fixture(scope="module")
def ref_routes(sessions):
    """Each star query's reference result and its joins' routes, read by
    wrapping the reference's two route entry points."""
    jt, _ = sessions
    routes = []
    probe, sort = jjoin._HashJoinBase._probe_pair, \
        jjoin._HashJoinBase._sort_order

    def spy_probe(self, *a, **k):
        routes.append("probe")
        return probe(self, *a, **k)

    def spy_sort(self, *a, **k):
        routes.append("sort")
        return sort(self, *a, **k)

    out = {}
    jjoin._HashJoinBase._probe_pair = spy_probe
    jjoin._HashJoinBase._sort_order = spy_sort
    try:
        for q in STAR:
            routes.clear()
            out[q] = (jtpcds.QUERIES[q](jt).collect(), sorted(routes))
    finally:
        jjoin._HashJoinBase._probe_pair = probe
        jjoin._HashJoinBase._sort_order = sort
    return out


@pytest.mark.parametrize("sf,seed", [(SF, 13), (0.001, 0)])
def test_generate_matches_reference(sf, seed, data):
    ref = data if (sf, seed) == (SF, 13) else jtpcds.generate(sf, seed)
    got = ttpcds.generate(sf, seed)
    assert list(got) == list(ref)
    for name in ref:
        assert got[name].equals(ref[name]), name


def test_build_tables_runs_only_the_named_builders():
    t = ttpcds.build_tables(["date_dim", "item", "store_sales"], SF, 5)
    assert sorted(t) == ["date_dim", "item", "store_sales"]
    full = ttpcds.generate(SF, 5)
    # date_dim and item come first in the reference's order of draws
    assert t["date_dim"].equals(full["date_dim"])
    assert t["item"].equals(full["item"])
    assert t["store_sales"].schema == full["store_sales"].schema
    assert t["store_sales"].num_rows == full["store_sales"].num_rows


def test_queries_are_the_reference_modules():
    """All 99 of the reference's queries: the module's own ten first, in
    its order, then those of tpcds_queries_a/b/c.py."""
    assert list(ttpcds.QUERIES)[:len(OWN)] == list(OWN)
    assert list(ttpcds.QUERIES) == list(jtpcds.QUERIES)
    assert len(ttpcds.QUERIES) == 99
    for name, fn in ttpcds.QUERIES.items():
        assert jtpcds.QUERIES[name].__doc__ == fn.__doc__


def _route_counts(fn):
    reg = obsreg.get_registry()
    before = {k: reg.counter(k) for k in ("join.route.probe",
                                          "join.route.sort")}
    out = fn()
    return out, sorted(
        ["probe"] * int(reg.counter("join.route.probe") -
                        before["join.route.probe"]) +
        ["sort"] * int(reg.counter("join.route.sort") -
                       before["join.route.sort"]))


@pytest.mark.parametrize("name", STAR)
def test_star_query_row_for_row(name, sessions, ref_routes):
    _, tt = sessions
    df = ttpcds.QUERIES[name](tt)
    got, routes = _route_counts(df.collect)
    ref, jroutes = ref_routes[name]
    assert_tables_equal(ref, got)
    assert routes == jroutes
    plan = df.explain_string("physical")
    assert plan.count("TpuBroadcastHashJoinExec") == 2, plan
    assert "TpuSortExec" in plan and "TpuGlobalLimitExec" in plan, plan
    hosts = [ln.strip() for ln in plan.splitlines()
             if not ln.lstrip().startswith("*")]
    assert all(h.startswith(("DeviceToHostExec", "CpuScanExec"))
               for h in hosts), plan


@pytest.mark.parametrize("name", [q for q in OWN if q not in STAR])
def test_query_matches_reference(name, sessions):
    jt, tt = sessions
    ref = jtpcds.QUERIES[name](jt).collect()
    got = ttpcds.QUERIES[name](tt).collect()
    problems = CompareResults(epsilon=1e-4,
                              ignore_ordering=True).compare(ref, got)
    assert not problems, f"{name}: {problems}"
