"""The port's broadcast joins vs the reference's, on both routes.

``tests/test_joins.py``'s cases run on a port session (``device="cpu"``)
and a reference session over the same tables.  The outputs are compared
row for row (the emit order is the reference's, so an aggregate above a
join adds floats in the same order), and each join's route is the
reference's: the probe route when both sides' keys carry value-range
hints (in-memory uploads do), the sort route when a filter in front of
the join has dropped them ("unhinted"), when the packed code is too wide
for the direct table, or for float and string keys.  A full outer join,
and any equi-join with broadcasts off, plans as a shuffled hash join
(``tests/test_torch_exchange.py`` holds those joins in every form).
"""

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu as jpkg
from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu.exec import tpu_join as jjoin

from spark_rapids_tpu_torch import api as tapi
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.exec import tpu_join as tjoin
from spark_rapids_tpu_torch.obs import registry as obsreg

from tests.data_gen import gen_table, int_key_gen, long_gen, string_key_gen
from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True}
ROUTES = ("join.route.probe", "join.route.sort")


def _sessions(conf=None):
    c = dict(CONF, **(conf or {}))
    return (JSession(c), jpkg), (TSession(c, device="cpu"), tapi)


def _ref_run(fn, session, api):
    """(result, routes) of the reference: each pair's route is the probe
    route exactly when ``_probe_code_bits`` fits the direct table."""
    routes = []
    orig = jjoin._probe_code_bits

    def spy(*a, **k):
        bits = orig(*a, **k)
        routes.append("probe" if bits is not None and
                      bits <= jjoin._PROBE_MAX_BITS else "sort")
        return bits

    jjoin._probe_code_bits = spy
    try:
        return fn(session, api).collect(), sorted(routes)
    finally:
        jjoin._probe_code_bits = orig


def _port_run(fn, session, api):
    reg = obsreg.get_registry()
    before = [reg.counter(k) for k in ROUTES]
    out = fn(session, api).collect()
    n = [int(reg.counter(k) - b) for k, b in zip(ROUTES, before)]
    return out, sorted(["probe"] * n[0] + ["sort"] * n[1])


def assert_port_matches(fn, conf=None, route=None):
    """Row for row and route for route; ``route`` pins the route of
    every join pair."""
    (js, japi), (ts, tapi_) = _sessions(conf)
    ref, jroutes = _ref_run(fn, js, japi)
    got, troutes = _port_run(fn, ts, tapi_)
    assert_tables_equal(ref, got)
    assert troutes == jroutes
    if route is not None:
        assert troutes and set(troutes) == {route}, troutes
    return got


def _unhinted(df, api, key):
    """``df`` behind a filter that keeps every row: the compaction drops
    the upload's value-range hints, as a real filter does."""
    c = api.col(key)
    return df.filter(c.isNull() | c.isNotNull())


def _sides(s, api, hinted):
    left = s.create_dataframe(gen_table([int_key_gen, long_gen],
                                        ["k", "lv"], n=60, seed=1))
    right = s.create_dataframe(gen_table([int_key_gen, long_gen],
                                         ["j", "rv"], n=40, seed=2))
    right = right.select(api.col("j").alias("k"), "rv")
    if not hinted:
        left, right = _unhinted(left, api, "k"), _unhinted(right, api, "k")
    return left, right


@pytest.mark.parametrize("hinted", [True, False], ids=["probe", "sort"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "semi", "anti"])
def test_join_parity(how, hinted):
    def q(s, api):
        left, right = _sides(s, api, hinted)
        return left.join(right, on="k", how=how)
    assert_port_matches(q, route="probe" if hinted else "sort")


# the shuffled joins' partitions and row order are compared with the
# reference's with the adaptive readers off (they regroup partitions)
NO_ADAPTIVE = {"spark.rapids.tpu.sql.adaptive.enabled": False}


def test_full_outer_raises_naming_the_exchange():
    """A full outer join never broadcasts: it plans as a shuffled hash
    join over two exchanges and matches the reference row for row.  It
    takes the sort route on every pair, where the reference's rule would
    allow the probe route to inner and left joins only."""
    def q(s, api):
        left, right = _sides(s, api, True)
        return left.join(right, on="k", how="full")
    (js, japi), (ts, tapi_) = _sessions(NO_ADAPTIVE)
    ref, jroutes = _ref_run(q, js, japi)
    plan = q(ts, tapi_).explain_string("physical")
    assert "TpuShuffledHashJoinExec" in plan, plan
    got, troutes = _port_run(q, ts, tapi_)
    assert_tables_equal(ref, got)
    assert troutes == ["sort"] * len(jroutes)


def test_shuffled_join_raises_naming_the_exchange():
    """With broadcasts off, an inner join plans as a shuffled hash join
    and matches the reference row for row and route for route."""
    def q(s, api):
        left, right = _sides(s, api, True)
        return left.join(right, on="k")
    conf = dict(NO_ADAPTIVE,
                **{"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1})
    (_, _), (ts, api) = _sessions(conf)
    plan = q(ts, api).explain_string("physical")
    assert "TpuShuffledHashJoinExec" in plan, plan
    assert_port_matches(q, conf, route="probe")


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_shuffled_join_at_default_adaptive(how):
    """With broadcasts off and no adaptive key, both packages read the
    join's exchanges through the adaptive readers, which regroup the
    partitions the same way; the rows and the routes equal the
    reference's."""
    def q(s, api):
        left, right = _sides(s, api, True)
        return left.join(right, on="k", how=how)
    conf = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    (js, japi), (ts, tapi_) = _sessions(conf)
    plan = q(ts, tapi_).explain_string("physical")
    assert plan.count("TpuAdaptiveJoinReaderExec") == 2, plan
    ref, jroutes = _ref_run(q, js, japi)
    got, troutes = _port_run(q, ts, tapi_)
    assert_tables_equal(ref, got, ignore_order=True)
    if how == "full":
        assert set(troutes) == {"sort"}, troutes
    else:
        assert troutes == jroutes


@pytest.mark.parametrize("hinted", [True, False], ids=["probe", "sort"])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_unique_build_keys(how, hinted):
    """A dimension-like build side (unique keys): the probe route's
    unique emit, in place when every stream row matches (a foreign-key
    join) and compacted when some do not."""
    def q(s, api):
        rng = np.random.default_rng(3)
        dim = s.create_dataframe(pa.table({
            "d": np.arange(0, 30, dtype=np.int64),
            "name": [f"n{i}" for i in range(30)]}))
        fact = s.create_dataframe(pa.table({
            "fk": rng.integers(0, 40 if how == "left" else 30, 200),
            "x": rng.normal(size=200)}))
        if not hinted:
            dim, fact = _unhinted(dim, api, "d"), _unhinted(fact, api, "fk")
        return fact.join(dim, api.col("fk") == api.col("d"), how=how)
    assert_port_matches(q, route="probe" if hinted else "sort")


def test_build_left_inner():
    """A smaller left side is the broadcast (build) side of an inner
    join; the output keeps the left side's columns first."""
    def q(s, api):
        left, right = _sides(s, api, True)
        return right.join(left.limit(7), on="k")
    assert_port_matches(q, route="probe")


def test_wide_keys_take_the_sort_route_on_narrow_codes():
    """Hinted keys whose packed code is wider than the direct table (24
    value bits) group by the code itself on the sort route."""
    def q(s, api):
        rng = np.random.default_rng(4)
        keys = rng.integers(0, 1 << 23, 50)
        left = s.create_dataframe(pa.table({
            "k": rng.choice(keys, 120), "v": np.arange(120)}))
        right = s.create_dataframe(pa.table({
            "k": rng.choice(keys, 60), "w": np.arange(60)}))
        return left.join(right, on="k")
    assert_port_matches(q, route="sort")


def test_cross_join():
    def q(s, api):
        left = s.create_dataframe({"a": [1, 2, 3]})
        right = s.create_dataframe({"b": [10, 20]})
        return left.join(right, how="cross")
    got = assert_port_matches(q)
    assert got.num_rows == 6


def test_cartesian_product():
    """Neither side under the broadcast threshold: the partition-pairwise
    cartesian product.  Its pairs run on concurrent task threads, where
    the reference's unlocked partition cache can drain one iterator from
    two threads at once (ROADMAP Queue C), so the port is held against
    the cross product's rows computed here."""
    conf = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
    (_, _), (ts, api) = _sessions(conf)
    left = ts.create_dataframe({"a": [1, 2, 3, 4]}, num_partitions=2)
    right = ts.create_dataframe({"b": [10, 20, 30]}, num_partitions=2)
    df = left.join(right, how="cross")
    plan = df.explain_string("physical")
    assert "TpuCartesianProductExec" in plan, plan
    got, routes = _port_run(lambda s, a: df, ts, api)
    assert routes == []
    # partition (i, j) crosses left partition i with right partition j
    lparts, rparts = ([1, 2], [3, 4]), ([10, 20], [30])
    want = [(a, b) for la in lparts for rb in rparts
            for a in la for b in rb]
    assert list(zip(got.column("a").to_pylist(),
                    got.column("b").to_pylist())) == want


def test_inner_join_result():
    (_, _), (ts, _api) = _sessions()
    left = ts.create_dataframe({"k": [1, 2, 3], "v": [10, 20, 30]})
    right = ts.create_dataframe({"k": [2, 3, 4], "w": [200, 300, 400]})
    out = left.join(right, on="k").sort("k").collect()
    assert out.column_names == ["k", "v", "k", "w"]
    assert out.column(1).to_pylist() == [20, 30]
    assert out.column(3).to_pylist() == [200, 300]


def test_join_runs_on_device():
    (_, _), (ts, _api) = _sessions()
    left = ts.create_dataframe({"k": [1, 2], "v": [10, 20]})
    right = ts.create_dataframe({"k": [2, 3], "w": [1, 2]})
    plan = left.join(right, on="k").explain_string("physical")
    assert "TpuBroadcastHashJoinExec" in plan, plan
    plan = left.join(right, how="cross").explain_string("physical")
    assert "TpuBroadcastNestedLoopJoinExec" in plan, plan


@pytest.mark.parametrize("hinted", [True, False], ids=["probe", "sort"])
def test_join_with_condition(hinted):
    def q(s, api):
        left = s.create_dataframe({"k": [1, 1, 2], "v": [5, 30, 20]})
        right = s.create_dataframe({"k": [1, 2], "w": [10, 15]})
        if not hinted:
            left, right = (_unhinted(left, api, "k"),
                           _unhinted(right, api, "k"))
        return left.join(right, on="k").filter(api.col("v") > api.col("w"))
    assert_port_matches(q, route="probe" if hinted else "sort")


def test_join_float_keys_nan():
    def q(s, api):
        nan = float("nan")
        left = s.create_dataframe({"k": [1.0, nan, -0.0, 2.0],
                                   "v": [1, 2, 3, 4]})
        right = s.create_dataframe({"k": [nan, 0.0, 2.0], "w": [10, 20, 30]})
        return left.join(right, on="k")
    # Spark joins NaN==NaN and -0.0==0.0 after normalization
    got = assert_port_matches(q, route="sort")
    assert got.num_rows == 3


def test_join_mixed_numeric_key_dtypes():
    """int/double key pairs promote to double; 1.5 must not match 1."""
    def q(s, api):
        left = s.create_dataframe({"k": [1.5, 2.0], "v": [1, 2]})
        right = s.create_dataframe({"k": [1, 2], "w": [10, 20]})
        return left.join(right, on="k")
    got = assert_port_matches(q, route="sort")
    assert got.num_rows == 1


def test_join_incompatible_key_dtypes_error():
    (_, _), (ts, _api) = _sessions()
    left = ts.create_dataframe({"k": ["a"], "v": [1]})
    right = ts.create_dataframe({"k": [1], "w": [2]})
    with pytest.raises(TypeError):
        left.join(right, on="k")


@pytest.mark.parametrize("hinted", [True, False], ids=["probe", "sort"])
def test_join_null_keys_dont_match(hinted):
    def q(s, api):
        left = s.create_dataframe({"k": [1, None], "v": [10, 20]})
        right = s.create_dataframe({"k": [1, None], "w": [100, 200]})
        if not hinted:
            left, right = (_unhinted(left, api, "k"),
                           _unhinted(right, api, "k"))
        return left.join(right, on="k")
    got = assert_port_matches(q, route="probe" if hinted else "sort")
    assert got.num_rows == 1  # SQL: null keys never equal


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_string_key_join(how):
    """String keys take the sort route through the hash grouping."""
    def q(s, api):
        left = s.create_dataframe(gen_table([string_key_gen, long_gen],
                                            ["k", "lv"], n=50, seed=3))
        right = s.create_dataframe(gen_table([string_key_gen, long_gen],
                                             ["j", "rv"], n=50, seed=4))
        right = right.select(api.col("j").alias("k"), "rv")
        return left.join(right, on="k", how=how)
    assert_port_matches(q, route="sort")


def test_ici_transport_raises_naming_its_module():
    j = tjoin.TpuBroadcastHashJoinExec(
        None, None, ["k"], ["k"], "inner", None, None, transport="ici")
    with pytest.raises(NotImplementedError, match="shuffle/ici.py"):
        j._build_for()
