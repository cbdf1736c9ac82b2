"""The port's out-of-core grace join and shuffle-boundary skew split
against the reference's.

Grace joins at a small build-side budget for every join type give the
rows of the unpartitioned join (``buildSideBudgetBytes=-1``) and of the
reference's CPU session; a recursion level, the hot-key fallback, a
mid-join ``close()`` that leaves the catalog empty, the planner's
``_oocore`` stamps (equal to the reference's ``resolve_oocore`` for the
same confs) and the two one-key reverts (``tests/test_join_oocore.py``'s
grace half).  The grace join also runs under the adaptive readers at
the default ``sql.adaptive.enabled``.

The skew half (``tests/test_join_oocore.py:273-405``): under
``sql.join.skew.enabled`` the plan reads both exchanges through
``TpuSkewJoinReaderExec``; the ``shuffle.skew.*`` counters equal the
reference's on the same input; every join type the split takes gives
the unsplit rows; full outer falls through to the adaptive reader; the
``shuffle.exchange.bucketBytes`` histogram and the profile's ``join``
section carry the split; the split composes with the grace join; and a
skew join below another skew join's exchange runs (the reference holds
one module-wide lock across a map side, so it waits there for ever).
Everything runs on a port session with ``device="cpu"``.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu.obs import registry as jreg
from spark_rapids_tpu.config import RapidsTpuConf as JConf
from spark_rapids_tpu.exec.join_partition import resolve_oocore as jresolve

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.config import RapidsTpuConf as TConf
from spark_rapids_tpu_torch.exec.adaptive import (TpuAdaptiveJoinReaderExec,
                                                  TpuSkewJoinReaderExec)
from spark_rapids_tpu_torch.exec import join_partition as jp
from spark_rapids_tpu_torch.exec.tpu_join import TpuShuffledHashJoinExec
from spark_rapids_tpu_torch.mem import spill
from spark_rapids_tpu_torch.obs import registry as obsreg

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

_NO_BCAST = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
             "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
             "spark.rapids.tpu.sql.shuffle.partitions": 4,
             "spark.rapids.tpu.sql.adaptive.enabled": False}
_ORACLE = dict(_NO_BCAST,
               **{"spark.rapids.tpu.sql.join.buildSideBudgetBytes": -1})
_BUDGET = "spark.rapids.tpu.sql.join.buildSideBudgetBytes"
HOWS = ["inner", "left", "right", "semi", "anti", "full"]


def _zipf_tables(n=1200, n_keys=200, seed=7):
    """A few heavy keys and a long tail; some keys only on one side."""
    rng = np.random.default_rng(seed)
    z = np.minimum(rng.zipf(1.3, n), n_keys).astype(np.int64)
    left = pa.table({"k": z, "lv": rng.integers(0, 1000, n)})
    rk = np.minimum(rng.zipf(1.3, n // 2), n_keys).astype(np.int64) + 3
    right = pa.table({"k2": rk, "rv": rng.integers(0, 1000, n // 2)})
    return left, right


def _join(s, col, left, right, how="inner", parts=4):
    l_ = s.create_dataframe(left, num_partitions=parts)
    r_ = s.create_dataframe(right, num_partitions=parts)
    df = l_.join(r_, col("k") == col("k2"), how=how)
    if how in ("semi", "anti"):
        return df.select(col("k").alias("a"), col("lv").alias("b"))
    return df.select(col("k").alias("a"), col("lv").alias("b"),
                     col("rv").alias("c"))


def _grace():
    snap = obsreg.get_registry().snapshot()
    c = dict(snap["counters"], **snap.get("gauges", {}))
    return {k: v for k, v in c.items() if k.startswith("join.grace.")}


def _port(conf, q):
    obsreg.reset_registry()
    out = q(TSession(conf, device="cpu"), tcol)
    return out, _grace()


@pytest.fixture(scope="module")
def zipf():
    left, right = _zipf_tables()
    oracle = {}
    ref = {}
    for how in HOWS:
        oracle[how], counters = _port(
            _ORACLE, lambda s, col: _join(s, col, left, right, how)
            .collect())
        assert not counters
        ref[how] = _join(JSession({"spark.rapids.tpu.sql.enabled": False}),
                         jcol, left, right, how).collect()
    return left, right, oracle, ref


@pytest.mark.parametrize("how", HOWS)
def test_grace_join_rows_equal_the_unpartitioned_join(zipf, how):
    left, right, oracle, ref = zipf
    got, counters = _port(
        dict(_NO_BCAST, **{_BUDGET: 2 << 10}),
        lambda s, col: _join(s, col, left, right, how).collect())
    assert counters.get("join.grace.activations", 0) >= 1, counters
    assert counters.get("join.grace.restreams", 0) >= 2, counters
    assert counters.get("join.grace.spilledBuildBytes", 0) > 0, counters
    assert_tables_equal(oracle[how], got, ignore_order=True,
                        approx_float=False)
    assert_tables_equal(ref[how], got, ignore_order=True,
                        approx_float=False)
    assert spill.get_catalog().num_buffers() == 0


def test_grace_join_recurses(zipf):
    """A 2-way first level leaves each partition over budget: the next
    level splits it again with its own seed."""
    left, right, oracle, _ = zipf
    got, counters = _port(
        dict(_NO_BCAST, **{_BUDGET: 3 << 10,
                           "spark.rapids.tpu.sql.join.oocore.partitionsLog2":
                               1}),
        lambda s, col: _join(s, col, left, right).collect())
    assert counters.get("join.grace.maxRecursionDepth", 0) >= 1, counters
    assert_tables_equal(oracle["inner"], got, ignore_order=True,
                        approx_float=False)


def test_single_hot_key_falls_back():
    """Every build row shares ONE key: no seed can split it, so the
    recursion stops at the no-shrink guard and the probe slices stream
    against the whole partition."""
    n = 300
    left = pa.table({"k": np.full(n, 42, dtype=np.int64),
                     "lv": np.arange(n, dtype=np.int64)})
    right = pa.table({"k2": np.full(n // 2, 42, dtype=np.int64),
                      "rv": np.arange(n // 2, dtype=np.int64)})

    def q(s, col):
        return _join(s, col, left, right).collect()

    want, _ = _port(_ORACLE, q)
    got, counters = _port(dict(_NO_BCAST, **{_BUDGET: 1 << 10}), q)
    assert counters.get("join.grace.activations", 0) >= 1, counters
    assert counters.get("join.grace.fallbacks", 0) >= 1, counters
    assert got.num_rows == n * (n // 2)
    assert_tables_equal(want, got, ignore_order=True, approx_float=False)


def test_mid_join_close_leaves_the_catalog_empty(zipf):
    left, right, _, _ = zipf
    s = TSession(dict(_NO_BCAST, **{_BUDGET: 2 << 10}), device="cpu")
    df = _join(s, tcol, left, right)
    joins = []
    s._plan_physical(df.plan).plan.foreach(
        lambda n: joins.append(n)
        if isinstance(n, TpuShuffledHashJoinExec) else None)
    parts = joins[0].execute()
    obsreg.reset_registry()
    started = 0
    for it in parts:
        if next(it, None) is not None:
            started += 1
            # grace partitions are parked right now
            assert spill.get_catalog().num_buffers() > 0
        it.close()
    assert started >= 1
    assert _grace().get("join.grace.activations", 0) >= 1
    assert spill.get_catalog().num_buffers() == 0


def test_pressure_spiller_reaches_parked_partitions():
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    TSession({}, device="cpu")
    state = jp.GraceJoinState()
    spill.register_pressure_spiller(state)
    h = spill.register_or_hold(
        from_arrow(pa.table({"a": np.arange(4096, dtype=np.int64)}),
                   device="cpu"),
        priority=spill.GRACE_JOIN_PARTITION_PRIORITY)
    state.track(h)
    try:
        assert h.tier == spill.StorageTier.DEVICE
        assert state.pressure_spill(1) > 0
        assert h.tier != spill.StorageTier.DEVICE
        assert h.get().num_rows == 4096
    finally:
        state.close_all()
    assert spill.get_catalog().num_buffers() == 0


_STAMP_CONFS = [
    {},
    {_BUDGET: -1},
    {_BUDGET: 12345},
    {"spark.rapids.tpu.sql.join.oocore.enabled": False},
    {"spark.rapids.tpu.sched.memoryBudget": 1 << 30},
    {"spark.rapids.tpu.sched.maxConcurrent": 3,
     "spark.rapids.tpu.sql.join.oocore.partitionsLog2": 9,
     "spark.rapids.tpu.sql.join.oocore.maxRecursion": -2},
]


@pytest.mark.parametrize("conf", _STAMP_CONFS,
                         ids=["default", "off_budget", "explicit",
                              "off_key", "sched_budget", "knobs"])
def test_planner_stamps_the_references_oocore(conf):
    want = jresolve(JConf(conf))
    assert jp.resolve_oocore(TConf(conf), "cpu") == want
    s = TSession(dict(_NO_BCAST, **conf), device="cpu")
    left, right = _zipf_tables(64, 8)
    joins = []
    s._plan_physical(_join(s, tcol, left, right).plan).plan.foreach(
        lambda n: joins.append(n)
        if isinstance(n, TpuShuffledHashJoinExec) else None)
    assert joins and joins[0]._oocore == want


def test_one_key_reverts_take_the_unpartitioned_path(zipf):
    left, right, oracle, _ = zipf
    for off in ({"spark.rapids.tpu.sql.join.oocore.enabled": False,
                 _BUDGET: 1},
                {_BUDGET: -1}):
        got, counters = _port(dict(_NO_BCAST, **off),
                              lambda s, col: _join(s, col, left, right)
                              .collect())
        assert not counters, off
        assert_tables_equal(oracle["inner"], got, ignore_order=True,
                            approx_float=False)


def test_grace_join_under_the_default_adaptive_readers(zipf):
    """No adaptive key: the readers coalesce the exchanges' partitions
    before the join, and the grace join still activates under its
    budget and gives the unpartitioned rows."""
    left, right, oracle, ref = zipf
    conf = {k: v for k, v in _NO_BCAST.items()
            if k != "spark.rapids.tpu.sql.adaptive.enabled"}
    s = TSession(dict(conf, **{_BUDGET: 2 << 10}), device="cpu")
    readers = []
    s._plan_physical(_join(s, tcol, left, right).plan).plan.foreach(
        lambda n: readers.append(n)
        if isinstance(n, TpuAdaptiveJoinReaderExec) else None)
    assert len(readers) == 2
    got, counters = _port(dict(conf, **{_BUDGET: 2 << 10}),
                          lambda s, col: _join(s, col, left, right)
                          .collect())
    assert counters.get("join.grace.activations", 0) >= 1, counters
    assert_tables_equal(oracle["inner"], got, ignore_order=True,
                        approx_float=False)
    assert_tables_equal(ref["inner"], got, ignore_order=True,
                        approx_float=False)
    assert spill.get_catalog().num_buffers() == 0


# ---------------------------------------------------------------------------
# shuffle-boundary skew splitting
# ---------------------------------------------------------------------------

def _skew_tables(n=8000, seed=3):
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(n) < 0.6, 7,
                    rng.integers(0, 500, n)).astype(np.int64)
    left = pa.table({"k": keys, "lv": rng.integers(0, 1000, n)})
    right = pa.table({"k2": np.arange(500, dtype=np.int64),
                      "rv": rng.integers(0, 1000, 500)})
    return left, right


_SKEW_CONF = dict(_NO_BCAST, **{
    "spark.rapids.tpu.sql.shuffle.partitions": 16,
    "spark.rapids.tpu.sql.join.skew.enabled": True,
    "spark.rapids.tpu.sql.join.skew.minBucketBytes": 1024,
})


def _skew(reg):
    c = reg.get_registry().snapshot()["counters"]
    return {k: v for k, v in c.items() if k.startswith("shuffle.skew.")}


def _both(conf, left, right, how="inner"):
    """(port rows, port skew counters, reference rows, reference skew
    counters) of one join under ``conf``."""
    obsreg.reset_registry()
    jreg.reset_registry()
    port = _join(TSession(conf, device="cpu"), tcol, left, right,
                 how).collect()
    ref = _join(JSession(conf), jcol, left, right, how).collect()
    return port, _skew(obsreg), ref, _skew(jreg)


def test_skew_split_parity_and_counters():
    left, right = _skew_tables()
    base, off, _, _ = _both(_NO_BCAST, left, right)
    assert not off, "knob off must not touch the skew plane"
    s = TSession(_SKEW_CONF, device="cpu")
    readers = []
    s._plan_physical(_join(s, tcol, left, right).plan).plan.foreach(
        lambda n: readers.append(n)
        if isinstance(n, TpuSkewJoinReaderExec) else None)
    assert len(readers) == 2
    split, got, ref, ref_counters = _both(_SKEW_CONF, left, right)
    assert got.get("shuffle.skew.detected", 0) >= 1, got
    assert got.get("shuffle.skew.splits", 0) >= 2, got
    # the 500-row build bucket is tiny: broadcast, not replicate
    assert got.get("shuffle.skew.broadcasts", 0) >= 1, got
    assert got == ref_counters
    assert_tables_equal(base, split, ignore_order=True, approx_float=False)
    assert_tables_equal(ref, split, ignore_order=True, approx_float=False)


@pytest.mark.parametrize("how", ["left", "right", "semi", "anti"])
@pytest.mark.parametrize("transport", ["local", "device"])
def test_skew_join_types_parity(how, transport):
    """Sparse build side: preserved-side rows with no match exercise the
    one-sided emission argument that makes replication safe."""
    left, right = _skew_tables(n=5000)
    right = right.filter(pa.compute.less(right["k2"], 40))
    if how == "right":
        # the probe side of a right join is the RIGHT input: swap the
        # tables so the hot key sits on the probe side there too
        left, right = (pa.table({"k": right["k2"], "lv": right["rv"]}),
                       pa.table({"k2": left["k"], "rv": left["lv"]}))
    tconf = {"spark.rapids.tpu.shuffle.transport": transport}
    base, _ = _port(dict(_NO_BCAST, **tconf),
                    lambda s, col: _join(s, col, left, right, how)
                    .collect())
    split, got, ref, ref_counters = _both(dict(_SKEW_CONF, **tconf), left,
                                          right, how)
    assert got.get("shuffle.skew.detected", 0) >= 1, got
    assert got == ref_counters
    assert_tables_equal(base, split, ignore_order=True, approx_float=False)
    assert_tables_equal(ref, split, ignore_order=True, approx_float=False)


def test_skew_full_outer_ineligible_falls_through():
    """Full outer preserves BOTH sides: replication would duplicate
    null-extended build rows, so the skew plane declines and the
    adaptive reader takes the join."""
    left, right = _skew_tables(n=4000)
    right = right.filter(pa.compute.less(right["k2"], 40))
    base, _ = _port(_NO_BCAST, lambda s, col: _join(s, col, left, right,
                                                    "full").collect())
    conf = {k: v for k, v in _SKEW_CONF.items()
            if k != "spark.rapids.tpu.sql.adaptive.enabled"}
    s = TSession(conf, device="cpu")
    names = []
    s._plan_physical(_join(s, tcol, left, right, "full").plan).plan \
        .foreach(lambda n: names.append(type(n).__name__))
    assert "TpuSkewJoinReaderExec" not in names
    assert names.count("TpuAdaptiveJoinReaderExec") == 2
    got, counters, ref, ref_counters = _both(conf, left, right, "full")
    assert not counters and not ref_counters
    assert_tables_equal(base, got, ignore_order=True, approx_float=False)
    assert_tables_equal(ref, got, ignore_order=True, approx_float=False)


def test_skew_bucket_histogram_and_profile_section():
    """The per-exchange bucket-size distribution lands in the registry,
    and the profile's ``join`` section carries the skew counters beside
    the grace join's, in both packages."""
    left, right = _skew_tables(n=5000)
    secs = {}
    for side, (S, col, kw) in {"port": (TSession, tcol, {"device": "cpu"}),
                               "ref": (JSession, jcol, {})}.items():
        s = S(_SKEW_CONF, **kw)
        _join(s, col, left, right).collect()
        secs[side] = s.last_query_profile().metrics
    joinsec = secs["port"]["join"]
    assert any(k.startswith("shuffle.skew.") for k in joinsec), joinsec
    assert sorted(k for k in joinsec if k.startswith("shuffle.skew.")) == \
        sorted(k for k in secs["ref"]["join"]
               if k.startswith("shuffle.skew."))
    hist = obsreg.get_registry().snapshot().get(
        "bucket_histograms", {}).get("shuffle.exchange.bucketBytes")
    assert hist and hist["count"] >= 16, hist


def test_join_profile_section_always_present():
    """An un-skewed, under-budget join still carries the (empty) join
    section: the contract is section presence, not activity."""
    s = TSession({}, device="cpu")
    lt = s.create_dataframe({"k": [1, 2, 3], "lv": [1, 2, 3]})
    rt = s.create_dataframe({"k2": [2, 3], "rv": [5, 6]})
    lt.join(rt, tcol("k") == tcol("k2")).collect()
    assert "join" in s.last_query_profile().metrics


def test_skew_and_grace_compose():
    """Skewed probe AND an over-budget build: the split sub-joins run
    under the grace budget; rows equal the unconstrained oracle."""
    left, right = _skew_tables(n=6000)
    base, _ = _port(_ORACLE, lambda s, col: _join(s, col, left, right)
                    .collect())
    # the build side is the 500-row dim (~500 B per shuffle bucket):
    # the budget must sit below that for grace to engage at all
    got, _ = _port(dict(_SKEW_CONF, **{_BUDGET: 256}),
                   lambda s, col: _join(s, col, left, right).collect())
    sc = _skew(obsreg)
    assert sc.get("shuffle.skew.detected", 0) >= 1, sc
    assert _grace().get("join.grace.activations", 0) >= 1
    assert_tables_equal(base, got, ignore_order=True, approx_float=False)
    assert spill.get_catalog().num_buffers() == 0


def test_skew_join_below_a_skew_join_runs():
    """Two shuffled joins, the first below the second's exchange: each
    exchange's map side holds only its own lock."""
    left, right = _skew_tables(n=3000)
    third = pa.table({"k3": np.arange(500, dtype=np.int64),
                      "tv": np.arange(500, dtype=np.int64) * 3})

    def q(s, col):
        a = s.create_dataframe(left, num_partitions=2)
        b = s.create_dataframe(right, num_partitions=2)
        c = s.create_dataframe(third, num_partitions=2)
        j = a.join(b, col("k") == col("k2"))
        return (j.join(c, col("lv") == col("k3"))
                .select(col("k"), col("lv"), col("rv"), col("tv"))
                .collect())

    base, _ = _port(_NO_BCAST, q)
    got, _ = _port(_SKEW_CONF, q)
    assert _skew(obsreg).get("shuffle.skew.detected", 0) >= 1
    assert_tables_equal(base, got, ignore_order=True, approx_float=False)

