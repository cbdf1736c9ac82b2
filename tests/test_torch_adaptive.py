"""The port's adaptive join reads (``exec/adaptive.py``) against the
reference's.

``tests/test_adaptive.py``'s cases: the spec planners as pure functions
(each case's output equal to the reference function's and to the value
the reference test pins), and end to end on a port session
(``device="cpu"``) against a reference session on the same numpy-seeded
tables: the readers the planner puts on both sides of a shuffled join,
the spec list they coordinate (skew chunks and coalesced runs), the
rows of the inner and left joins, a user repartition left bare and
``sql.adaptive.enabled=false``.  With no conf at all (adaptive on by
default in both packages) the plan shows ``TpuAdaptiveJoinReaderExec``
on both sides under each ported transport and the rows equal the
reference session's.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.exec import adaptive as jad

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.exec import adaptive as tad
from spark_rapids_tpu_torch.shuffle.exchange import TpuShuffleExchangeExec

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

SIDES = {"ref": (JSession, jcol, JF, {}),
         "port": (TSession, tcol, TF, {"device": "cpu"})}

_ADAPTIVE_CONF = {
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
    "spark.rapids.tpu.sql.shuffle.partitions": 8,
    "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes": 64 << 10,
    "spark.rapids.tpu.sql.adaptive.skewJoin."
    "skewedPartitionThresholdInBytes": 32 << 10,
}


# ---------------------------------------------------------------------------
# the spec planners as pure functions
# ---------------------------------------------------------------------------

def _norm(x):
    """A spec structure with the dataclasses of either package replaced
    by (class name, fields)."""
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, set):
        return {_norm(v) for v in x}
    if type(x).__name__ in ("CoalescedSpec", "SkewSplitSpec"):
        return (type(x).__name__,) + tuple(vars(x).values())
    return x


PLANNER_CASES = {
    "coalesce_small": ("coalesce_runs", ([30, 30, 30, 30, 30],),
                       {"advisory": 100, "skew": set()},
                       [("CoalescedSpec", 0, 4), ("CoalescedSpec", 4, 5)]),
    "no_coalesce_when_large": (
        "coalesce_runs", ([60, 70, 80],), {"advisory": 50, "skew": set()},
        [("CoalescedSpec", 0, 1), ("CoalescedSpec", 1, 2),
         ("CoalescedSpec", 2, 3)]),
    "empty_fold_into_neighbors": (
        "coalesce_runs", ([0, 0, 150, 0, 0],),
        {"advisory": 100, "skew": set()},
        [("CoalescedSpec", 0, 3), ("CoalescedSpec", 3, 5)]),
    "skew_marker": ("coalesce_runs", ([10, 400, 10, 10],),
                    {"advisory": 30, "skew": {1}}, None),
    "skew_detection": ("skewed_indices", ([10, 200, 10, 10],),
                       {"factor": 5, "threshold": 0}, {1}),
    "skew_threshold_not_met": ("skewed_indices", ([10, 200, 10, 10],),
                               {"factor": 5, "threshold": 10_000}, set()),
    "join_coalesced_identically": (
        "plan_join_specs",
        ([30, 30, 30], [5, 5, 5], [3, 3, 3], [1, 1, 1], "inner"),
        {"advisory": 200, "factor": 5, "threshold": 1 << 40,
         "min_parts": 1},
        [(("CoalescedSpec", 0, 3), ("CoalescedSpec", 0, 3))]),
    "join_skew_split_inner": (
        "plan_join_specs",
        ([10, 400, 10], [10, 10, 10], [10, 400, 10], [10, 10, 10],
         "inner"),
        {"advisory": 100, "factor": 5, "threshold": 0, "min_parts": 1},
        None),
    "join_full_outer_never_splits": (
        "plan_join_specs",
        ([10, 400, 10], [10, 10, 10], [10, 400, 10], [10, 10, 10],
         "full"),
        {"advisory": 100, "factor": 5, "threshold": 0, "min_parts": 1},
        None),
    "join_right_splits_right_only": (
        "plan_join_specs",
        ([10, 400, 10], [10, 300, 10], [10, 400, 10], [10, 300, 10],
         "right"),
        {"advisory": 100, "factor": 5, "threshold": 0, "min_parts": 1},
        None),
    "min_parts_limits_coalescing_keeps_skew": (
        "plan_join_specs",
        ([10, 400, 10, 10], [1, 1, 1, 1], [10, 400, 10, 10], [1, 1, 1, 1],
         "inner"),
        {"advisory": 10_000, "factor": 5, "threshold": 0, "min_parts": 4},
        None),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_spec_planner_equals_reference(case):
    fn, args, kw, pinned = PLANNER_CASES[case]
    port = _norm(getattr(tad, fn)(*args, **kw))
    assert port == _norm(getattr(jad, fn)(*args, **kw))
    if pinned is not None:
        assert port == pinned


def test_skew_split_replicates_other_side():
    """tests/test_adaptive.py:53-68: the skewed left partition splits
    into row chunks covering all 400 rows once, each paired with the
    whole right partition."""
    specs = tad.plan_join_specs([10, 400, 10], [10, 10, 10],
                                [10, 400, 10], [10, 10, 10], "inner",
                                advisory=100, factor=5, threshold=0,
                                min_parts=1)
    pairs = [s for s in specs if isinstance(s[0], tad.SkewSplitSpec)]
    assert len(pairs) >= 2
    for ls, rs in pairs:
        assert ls.partition == 1 and rs.partition == 1
        assert (rs.row_start, rs.row_end) == (0, 10)
    covered = sorted((s[0].row_start, s[0].row_end) for s in pairs)
    assert covered[0][0] == 0 and covered[-1][1] == 400
    for (_a, b), (c, _d) in zip(covered, covered[1:]):
        assert b == c
    full = tad.plan_join_specs([10, 400, 10], [10, 10, 10],
                               [10, 400, 10], [10, 10, 10], "full",
                               advisory=100, factor=5, threshold=0,
                               min_parts=1)
    assert all(isinstance(s[0], tad.CoalescedSpec) for s in full)
    right = tad.plan_join_specs([10, 400, 10], [10, 300, 10],
                                [10, 400, 10], [10, 300, 10], "right",
                                advisory=100, factor=5, threshold=0,
                                min_parts=1)
    assert [s for s in right if isinstance(s[1], tad.SkewSplitSpec)
            and s[1].row_end - s[1].row_start < 300]
    assert not [s for s in right if isinstance(s[0], tad.SkewSplitSpec)
                and s[0].row_end - s[0].row_start < 400]


# ---------------------------------------------------------------------------
# end to end against a reference session
# ---------------------------------------------------------------------------

def _tables(n=30_000):
    rng = np.random.default_rng(3)
    # one hot key (~60% of fact rows) + long tail; dim has unique keys
    keys = np.where(rng.random(n) < 0.6, 7,
                    rng.integers(0, 500, n)).astype(np.int64)
    fact = pa.table({"k": keys, "v": rng.uniform(0, 100, n)})
    dim = pa.table({"k2": np.arange(500, dtype=np.int64),
                    "w": rng.uniform(0, 10, 500)})
    return fact, dim


def _find(node, cls):
    hits = []

    def visit(n):
        if isinstance(n, cls):
            hits.append(n)
        for c in getattr(n, "children", ()):
            visit(c)
    visit(node)
    return hits


def _names(phys):
    return [type(n).__name__ for n in _find(phys, object)]


def _join_df(side, s, n=30_000, how="inner", dim_rows=500):
    _S, col, _F, _kw = SIDES[side]
    fact, dim = _tables(n)
    f = s.create_dataframe(fact, num_partitions=4)
    d = s.create_dataframe(dim.slice(0, dim_rows))
    return f.join(d, col("k") == col("k2"), how)


def _agg(side, df):
    _S, col, F, _kw = SIDES[side]
    return df.group_by("k").agg(F.sum(col("v") * col("w")).alias("s"),
                                F.count("*").alias("c"))


@pytest.fixture(scope="module")
def in_plan():
    """side -> (reader specs, rows driven through that plan's own
    readers, reader count, aggregate result)."""
    out = {}
    for side, (S, _col, _F, kw) in SIDES.items():
        s = S(_ADAPTIVE_CONF, **kw)
        df = _join_df(side, s)
        phys = s._plan_physical(df.plan).plan
        readers = [n for n in _find(phys, object)
                   if type(n).__name__ == "TpuAdaptiveJoinReaderExec"]
        # drive THIS plan instance (collect() would re-plan and execute
        # fresh reader nodes)
        rows = sum(int(b.num_rows) for it in phys.execute() for b in it)
        out[side] = (readers[0].state.specs if readers else None, rows,
                     len(readers), _agg(side, df).collect())
    return out


def test_reader_in_plan_with_skew_and_coalesce(in_plan):
    specs, rows, n_readers, _ = in_plan["port"]
    assert n_readers == 2
    assert any(isinstance(s[0], tad.SkewSplitSpec) for s in specs), specs
    assert any(isinstance(s[0], tad.CoalescedSpec)
               and s[0].end > s[0].start + 1 for s in specs), specs
    # every fact row joins (dim covers keys 0..499)
    assert rows == 30_000
    assert _norm(specs) == _norm(in_plan["ref"][0])
    assert rows == in_plan["ref"][1] and n_readers == in_plan["ref"][2]


def test_adaptive_join_parity(in_plan):
    ref, port = in_plan["ref"][3], in_plan["port"][3]
    assert_tables_equal(ref.sort_by("k"), port.sort_by("k"))


def test_adaptive_outer_join_parity():
    out = {}
    for side, (S, _col, _F, kw) in SIDES.items():
        s = S(_ADAPTIVE_CONF, **kw)
        # drop half the dim keys so the outer join produces nulls
        out[side] = (_join_df(side, s, n=8000, how="left", dim_rows=250)
                     .sort("k", "v").collect())
    assert_tables_equal(out["ref"], out["port"])


def test_user_repartition_not_wrapped():
    s = TSession(_ADAPTIVE_CONF, device="cpu")
    fact, _ = _tables(2000)
    df = s.create_dataframe(fact).repartition(4, tcol("k"))
    names = _names(s._plan_physical(df.plan).plan)
    assert "TpuAdaptiveJoinReaderExec" not in names
    assert "TpuShuffleExchangeExec" in names


def test_adaptive_off_keeps_plain_exchanges():
    s = TSession({**_ADAPTIVE_CONF,
                  "spark.rapids.tpu.sql.adaptive.enabled": False},
                 device="cpu")
    phys = s._plan_physical(_join_df("port", s, n=2000).plan).plan
    names = _names(phys)
    assert "TpuAdaptiveJoinReaderExec" not in names
    join = _find(phys, object)
    j = [n for n in join if type(n).__name__ == "TpuShuffledHashJoinExec"]
    assert all(isinstance(c, TpuShuffleExchangeExec)
               for c in j[0].children)


@pytest.mark.parametrize("transport", ["local", "device"])
def test_default_conf_wraps_both_sides(transport):
    """No adaptive key at all: adaptive reads are on by default in both
    packages, so a shuffled equi-join reads its exchanges through
    ``TpuAdaptiveJoinReaderExec`` on both sides and its rows equal the
    reference session's."""
    conf = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
            "spark.rapids.tpu.shuffle.transport": transport}
    out = {}
    for side, (S, _col, _F, kw) in SIDES.items():
        s = S(conf, **kw)
        df = _join_df(side, s, n=3000)
        phys = s._plan_physical(df.plan).plan
        joins = [n for n in _find(phys, object)
                 if type(n).__name__ == "TpuShuffledHashJoinExec"]
        assert len(joins) == 1, side
        assert [type(c).__name__ for c in joins[0].children] == \
            ["TpuAdaptiveJoinReaderExec"] * 2, side
        out[side] = _agg(side, df).collect().sort_by("k")
    assert_tables_equal(out["ref"], out["port"])
