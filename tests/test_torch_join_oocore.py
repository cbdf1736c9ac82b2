"""The port's out-of-core grace join against the reference's.

Grace joins at a small build-side budget for every join type give the
rows of the unpartitioned join (``buildSideBudgetBytes=-1``) and of the
reference's CPU session; a recursion level, the hot-key fallback, a
mid-join ``close()`` that leaves the catalog empty, the planner's
``_oocore`` stamps (equal to the reference's ``resolve_oocore`` for the
same confs) and the two one-key reverts (``tests/test_join_oocore.py``'s
grace half).  Everything runs on a port session with ``device="cpu"``.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu.config import RapidsTpuConf as JConf
from spark_rapids_tpu.exec.join_partition import resolve_oocore as jresolve

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.config import RapidsTpuConf as TConf
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
