"""The port's plan digest (plan/digest.py) against the reference's.

``tests/test_plan_digest.py``'s ten cases on port sessions
(``device="cpu"``), then the cross-package identity: the same plan,
built through each package's own DataFrame, SQL and reader surfaces,
has the same ``plan_digest`` hex string and the same
``plan_fingerprint`` (digest, sources, cacheable) in both.  The plans
cover DataFrame chains, SQL texts (TPC-H's and a stacked CTE), in-memory
scans, Parquet and CSV file scans and non-deterministic expressions.
The reference runs its CPU engine (``sql.enabled=false``), which plans
and digests without compiling.
"""

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import lit as jlit
from spark_rapids_tpu.bench import tpch as jtpch
from spark_rapids_tpu.plan import digest as jdigest

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col, functions as F, lit
from spark_rapids_tpu_torch.bench import tpch as ttpch
from spark_rapids_tpu_torch.exec.kernel_cache import expr_sig
from spark_rapids_tpu_torch.plan import digest as tdigest
from spark_rapids_tpu_torch.plan import logical as lp
from spark_rapids_tpu_torch.plan.digest import (plan_digest,
                                                plan_fingerprint,
                                                safe_plan_digest)

from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


def _session(extra=None):
    return TSession(dict(CONF, **(extra or {})), device="cpu")


def _df(s, n=200):
    return s.create_dataframe(
        {"k": [i % 5 for i in range(n)],
         "x": [float(i % 40) for i in range(n)]})


# ---------------------------------------------------------------------------
# canonical identity (tests/test_plan_digest.py)
# ---------------------------------------------------------------------------

def test_alias_and_rename_insensitive():
    s = _session()
    df = _df(s)
    a = (df.with_column("y", col("x") * 2.0 + 1.0)
           .filter(col("y") > 20.0)
           .group_by("k").agg(F.sum("y").alias("s1")))
    b = (df.with_column("zz", col("x") * 2.0 + 1.0)
           .filter(col("zz") > 20.0)
           .group_by("k").agg(F.sum("zz").alias("other_name")))
    assert plan_digest(a.plan) == plan_digest(b.plan)


def test_sql_alias_insensitive_and_shared_with_kernel_cache():
    s = _session()
    s.register_view("t", _df(s))
    p1 = s.sql("select k, x * 2.0 as a from t where x > 3.0").plan
    p2 = s.sql("select k, x * 2.0 as b from t where x > 3.0").plan
    assert plan_digest(p1) == plan_digest(p2)
    assert [expr_sig(e) for e in p1.exprs] == \
        [expr_sig(e) for e in p2.exprs]


def test_result_relevant_changes_move_the_digest():
    s = _session()
    df = _df(s)
    base = df.filter(col("x") > 3.0).group_by("k").agg(
        F.sum("x").alias("s"))
    d0 = plan_digest(base.plan)
    assert plan_digest(df.filter(col("x") > 4.0).group_by("k").agg(
        F.sum("x").alias("s")).plan) != d0                  # literal
    assert plan_digest(df.group_by("k").agg(
        F.sum("x").alias("s")).plan) != d0                  # structure
    assert plan_digest(df.filter(col("x") > 3.0).group_by("k").agg(
        F.max("x").alias("s")).plan) != d0                  # function
    assert plan_digest(base.sort("k").plan) != plan_digest(
        base.sort(col("k").desc()).plan)                    # direction


def test_identical_plans_built_twice_share_a_digest():
    s = _session()
    q1 = _df(s).filter(col("x") > 3.0).select("k")
    q2 = _df(s).filter(col("x") > 3.0).select("k")
    assert q1.plan is not q2.plan
    assert plan_digest(q1.plan) == plan_digest(q2.plan)


def test_inmemory_scan_is_content_keyed():
    s = _session()
    t1 = s.create_dataframe({"a": [1, 2, 3]})
    t2 = s.create_dataframe({"a": [1, 2, 3]})
    t3 = s.create_dataframe({"a": [1, 2, 4]})
    assert plan_digest(t1.plan) == plan_digest(t2.plan)
    assert plan_digest(t1.plan) != plan_digest(t3.plan)


def test_filescan_fingerprint_sources(tmp_path):
    p = str(tmp_path / "f.parquet")
    papq.write_table(pa.table({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]}), p)
    q = _session().read.parquet(p).filter(col("a") > 1)
    fp = plan_fingerprint(q.plan)
    assert fp.cacheable
    assert len(fp.sources) == 1 and fp.sources[0].endswith("f.parquet")
    assert fp.digest == plan_digest(q.plan)


def test_nondeterministic_plans_not_cacheable():
    df = _df(_session())
    assert plan_fingerprint(df.select("k").plan).cacheable
    assert not plan_fingerprint(df.with_column("r", F.rand(42)).plan
                                ).cacheable
    assert not plan_fingerprint(
        df.with_column("m", F.monotonically_increasing_id()).plan
    ).cacheable


def test_udf_plans_not_cacheable():
    """The port's DataFrame has no map_in_pandas yet (pyworker/ is not
    ported): the logical node, which the port has, is built directly."""
    def fn(pdf):
        return pdf

    plan = lp.MapInPandas(_df(_session()).plan, fn,
                          [("k", dt.INT64), ("x", dt.FLOAT64)])
    assert not plan_fingerprint(plan).cacheable


def test_safe_plan_digest_never_raises():
    assert safe_plan_digest(object()) is None


def test_profile_and_query_table_carry_plan_digest():
    s = _session()
    q = _df(s).filter(col("x") > 3.0).group_by("k").agg(
        F.count("*").alias("c")).sort("k")
    expected = plan_digest(q.plan)
    q.collect()
    prof = s.last_query_profile()
    assert prof.plan_digest == expected
    assert prof.to_dict()["plan_digest"] == expected
    rows = [r for r in s.scheduler.query_table()
            if r["query_id"] == prof.query_id]
    assert rows and rows[0]["plan_digest"] == expected
    assert rows[0]["session_id"] is None


# ---------------------------------------------------------------------------
# the same plans in both packages
# ---------------------------------------------------------------------------

SIDES = {"ref": (jcol, JF, jlit, jtpch), "port": (col, F, lit, ttpch)}


def _sales(s, n=300):
    return s.create_dataframe(
        {"k": [i % 7 for i in range(n)],
         "x": [float(i % 50) for i in range(n)],
         "q": [i % 13 for i in range(n)],
         "s": [("abc", "de", None, "fgh")[i % 4] for i in range(n)]},
        num_partitions=2)


def _dim(s):
    return s.create_dataframe({"k": list(range(7)),
                               "name": [f"n{i}" for i in range(7)]})


def _dataframe_plans(s, c, f, lit):
    d = _sales(s)
    return {
        "scan": d,
        "filter_agg": d.filter(c("x") > 3.0).group_by("k").agg(
            f.sum("x").alias("sx"), f.count("*").alias("n"),
            f.avg("q").alias("aq")),
        "project_exprs": d.select((c("x") * 2.0 + 1.0).alias("a"),
                                  (c("q") % 5).alias("b"),
                                  c("s").is_null().alias("c")),
        "cast_case": d.select(c("x").cast("int").alias("i"),
                              f.when(c("q") > 6, 1).otherwise(0)
                              .alias("w")),
        "strings": d.filter(c("s").is_not_null()).select(
            f.upper(c("s")).alias("u"), f.length(c("s")).alias("l"),
            f.substring(c("s"), 1, 2).alias("p")),
        "isin": d.filter(c("k").isin(1, 2, 3)).select("k", "x"),
        "sort_limit": d.sort(c("x").desc(), "k").limit(10),
        "distinct": d.select("k").distinct(),
        "join": d.join(_dim(s), on="k").select("k", "name", "x"),
        "left_join": d.join(_dim(s), on="k", how="left"),
        "union": d.select("k").union(_dim(s).select("k")),
        "repartition": d.repartition(3, "k").group_by("k").agg(
            f.max("x").alias("m")),
        "range": s.range(0, 100, 3).filter(c("id") > 10),
        "coalesce_lit": d.select(f.coalesce(c("s"), lit("z")).alias("s")),
        "rand": d.with_column("r", f.rand(7)),
        "mono_id": d.with_column("m", f.monotonically_increasing_id()),
    }


SQL_TEXTS = {
    "sql_where": "select k, x * 2.0 as y from sales where x > 5.0",
    "sql_group": ("select k, sum(x) as sx, count(*) as n from sales "
                  "group by k order by k"),
    "sql_join": ("select s.k, d.name, s.x from sales s join dim d "
                 "on s.k = d.dk where s.q < 6"),
    # each CTE reads the one before; b is read twice (a shared subtree)
    "sql_stacked_cte": (
        "with a as (select k, x from sales where x > 1.0), "
        "b as (select k, sum(x) as sx from a group by k), "
        "c as (select k, sx from b where sx > 100.0 union all "
        "select k, sx from b where sx <= 100.0) "
        "select k, sx from c order by k"),
}


def _all_plans(s, side, t, tmp):
    c, f, lit, tpch = SIDES[side]
    plans = {k: df.plan for k, df in _dataframe_plans(s, c, f, lit).items()}
    s.register_view("sales", _sales(s))
    s.register_view("dim", s.create_dataframe(
        {"dk": list(range(7)), "name": [f"n{i}" for i in range(7)]}))
    plans.update({k: s.sql(q).plan for k, q in SQL_TEXTS.items()})
    tpch.setup_views(s, t)
    for q in ("q1", "q3", "q5", "q6", "q10", "q12", "q14", "q19"):
        plans[f"tpch_sql_{q}"] = s.sql(tpch.SQL_QUERIES[q]).plan
    dfs = tpch.setup(s, t)
    for q in ("q1", "q3", "q6", "q10", "q12"):
        plans[f"tpch_df_{q}"] = tpch.QUERIES[q](dfs).plan
    pq = s.read.parquet(str(tmp / "pq"))
    plans["parquet_scan"] = pq.plan
    plans["parquet_filter_agg"] = pq.filter(c("a") > 2).group_by("a").agg(
        f.sum("b").alias("sb")).plan
    plans["csv_scan"] = s.read.csv(str(tmp / "t.csv")).filter(
        c("a") > 1).plan
    return plans


@pytest.fixture(scope="module")
def both_plans(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("digest")
    (tmp / "pq").mkdir()
    for i in range(2):
        papq.write_table(
            pa.table({"a": [1, 2, 3, 4], "b": [i, 2.0, 3.0, 4.0]}),
            str(tmp / "pq" / f"part-{i}.parquet"))
    pacsv.write_csv(pa.table({"a": [1, 2, 3], "b": ["x", "y", "z"]}),
                    str(tmp / "t.csv"))
    t = ttpch.generate(0.001, seed=7)   # one set of tables for both
    j = JSession(dict(CONF, **{"spark.rapids.tpu.sql.enabled": False}))
    return _all_plans(j, "ref", t, tmp), _all_plans(_session(), "port", t,
                                                    tmp)


def test_digest_and_fingerprint_equal_reference(both_plans):
    ref, port = both_plans
    assert set(ref) == set(port) and len(port) >= 20
    diffs = [k for k in port
             if tdigest.plan_digest(port[k]) != jdigest.plan_digest(ref[k])]
    assert not diffs, diffs
    for k in port:
        a = tdigest.plan_fingerprint(port[k])
        b = jdigest.plan_fingerprint(ref[k])
        assert (a.digest, a.sources, a.cacheable) == \
            (b.digest, b.sources, b.cacheable), k
    assert not tdigest.plan_fingerprint(port["rand"]).cacheable
    assert tdigest.plan_fingerprint(port["parquet_scan"]).sources
    # distinct plans, distinct digests
    assert len({tdigest.plan_digest(p) for p in port.values()}) == len(port)
