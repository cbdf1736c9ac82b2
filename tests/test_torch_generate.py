"""The port's generate execs and the mortgage ETL vs the reference's.

explode, posexplode and their outer forms (over list columns with null
and empty lists and null elements) plan as ``TpuGenerateExec`` on a port
session, and their rows equal the reference's CPU engine's; the planned
plans have the reference device session's node names in the same order
(planned, not run).  The mortgage module's ``generate`` equals the
reference's table for table, and its three pieces (the ETL with its
explode of 0..11, ``simple_aggregates`` and ``delinquency_rate``) at SF
0.002 equal the reference's session, as the reference's
``tests/test_tpcxbb_mortgage.py::test_mortgage_parity`` holds its own
device session to its CPU engine.  Integers, nulls and row sets exactly;
floats to ``tests/parity.py``'s tolerance.
"""

import pyarrow as pa
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.bench import mortgage as jmort

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.bench import mortgage as tmort

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

BASE = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True}
SIDES = {"ref": (jcol, JF), "port": (tcol, TF)}


def _arr_table():
    return pa.table({
        "id": [1, 2, 3, 4, 5, 6, 7],
        "arr": pa.array([[1, 2, 3], [], None, [4, None, 6], [7], [None],
                         [8, 9]], type=pa.list_(pa.int64())),
        "farr": pa.array([[1.5, 2.5], None, [0.0], [], [3.25, None],
                          [-1.0], None], type=pa.list_(pa.float64())),
    })


def _names(s, df):
    out = []
    s._plan_physical(df.plan).plan.foreach(
        lambda n: out.append(type(n).__name__))
    return out


def _both(fn, conf=None, ignore_order=True):
    """``fn(session, col, F)`` on the reference's CPU engine and on a port
    session on the CPU (test mode: no unexpected host node); the rows
    must be equal and the port's plan must have the reference device
    session's node names.  Returns the port's node names."""
    conf = dict(BASE, **(conf or {}))
    want = fn(JSession({"spark.rapids.tpu.sql.enabled": False}), jcol,
              JF).collect()
    ts = TSession(conf, device="cpu")
    df = fn(ts, tcol, TF)
    assert_tables_equal(want, df.collect(), ignore_order=ignore_order)
    js = JSession(conf)
    names = _names(ts, df)
    assert names == _names(js, fn(js, jcol, JF))
    return names


@pytest.mark.parametrize("outer", [False, True])
def test_explode_parity(outer):
    names = _both(lambda s, col, F: s.create_dataframe(_arr_table()).select(
        "id", (F.explode_outer if outer else F.explode)("arr").alias("x")))
    assert "TpuGenerateExec" in names


@pytest.mark.parametrize("outer", [False, True])
def test_posexplode_parity(outer):
    names = _both(lambda s, col, F: s.create_dataframe(_arr_table()).select(
        "id", (F.posexplode_outer if outer else F.posexplode)("farr")))
    assert "TpuGenerateExec" in names


def test_explode_then_aggregate():
    names = _both(lambda s, col, F: (
        s.create_dataframe(_arr_table(), num_partitions=2)
        .select("id", F.explode("arr").alias("x"))
        .group_by("id").agg(F.count("*").alias("cnt"),
                            F.sum("x").alias("sx"))))
    assert "TpuGenerateExec" in names


def test_explode_of_created_array():
    """explode(array(lit(0..3))) per row, the mortgage ETL's form, over
    several batches."""
    t = pa.table({"k": list(range(100)), "v": [i % 7 for i in range(100)]})

    def fn(s, col, F):
        from_ = s.create_dataframe(t, num_partitions=3)
        return from_.with_column(
            "m", F.explode(F.array(*[F.lit(i) for i in range(4)]))).filter(
            col("m") != col("v"))
    names = _both(fn, {"spark.rapids.tpu.sql.reader.batchSizeRows": 16})
    assert "TpuGenerateExec" in names


def test_generate_matches_reference():
    """``generate`` draws as the reference's does, table for table."""
    want, got = jmort.generate(0.002, 13), tmort.generate(0.002, 13)
    assert set(got) == set(want)
    for k in want:
        assert got[k].schema == want[k].schema, k
        assert got[k].equals(want[k]), k


@pytest.fixture(scope="module")
def mort_data():
    return jmort.generate(0.002, seed=13)


@pytest.mark.parametrize("piece", ["etl", "simple_aggregates",
                                   "delinquency_rate"])
def test_mortgage_parity(piece, mort_data):
    outs = {}
    for side, mod in (("ref", jmort), ("port", tmort)):
        s = JSession({"spark.rapids.tpu.sql.enabled": False}) \
            if side == "ref" else TSession(BASE, device="cpu")
        t = mod.setup(s, mort_data)
        df = mod.run(t, s) if piece == "etl" else getattr(mod, piece)(t)
        outs[side] = df.collect()
        if side == "port":
            names = _names(s, df)
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)
    assert outs["port"].num_rows > 0
    assert not [n for n in names if n.startswith("Cpu") and
                n != "CpuScanExec"], names
    if piece == "etl":
        assert "TpuGenerateExec" in names
