"""The port's last device expressions vs the reference's: md5, the
partition leaves, rand, the cast float -> string and the list group.

Each expression goes through ``eval_tpu.evaluate`` in both packages over
the same seeded batch: validity exactly, string bytes and lengths
exactly, integers and bools exactly, floats bit for bit (rand and ryu's
output must equal the reference's bits).  md5 is also held to
``hashlib`` at the block edges (0, 55, 56, 63, 64, 119 and 120 bytes) and
over multi-byte UTF-8; ryu to ``repr(float(x))`` at its edges.  A few
rand values are pinned as constants beside the comparison with jax, so a
change of jax's default generator shows by name.  The port's dispatch
table has the reference's keys by class name.  The device project and
filter execs evaluate inside the task context (partition id and running
row offset), which the leaves read: a DataFrame over four partitions of
several batches each equals the reference's CPU engine.  The cases mirror
the reference's ``tests/test_expr_longtail.py`` (md5),
``tests/test_float_to_string.py`` and ``tests/test_complex_types.py``.
"""

import hashlib

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.columnar.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.exec import context as jctx
from spark_rapids_tpu.expr import eval_tpu as jev
from spark_rapids_tpu.expr import ir as jir

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.columnar.batch import from_arrow as tfrom_arrow
from spark_rapids_tpu_torch.exec import context as tctx
from spark_rapids_tpu_torch.expr import eval_tpu as tev
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.expr import ryu

from tests.parity import assert_tables_equal
from tests.test_torch_strings import assert_same
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 96
# md5's block edges: the padding's 0x80 and the 8-byte length fit in the
# block up to 55 bytes, spill into a second block at 56, and so on
MD5_EDGES = [0, 1, 55, 56, 63, 64, 119, 120, 127, 128, 183, 184]
FLOAT_EDGES = [0.0, -0.0, float("nan"), float("inf"), float("-inf"),
               5e-324, 2.2250738585072014e-308, 1.7976931348623157e308,
               1e16, 9999999999999998.0, 1e-4, 1e-5, 0.5, 2.5, 4.35, 1.005,
               2.675, 0.1, 0.3, 1 / 3, 123.456, -1.5e-7, 1e22, 1e23,
               6.02214076e23, 1.2345678901234567e16, 9.999999999999999e15]
BASE = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True}


def _md5_strings(rng):
    out = ["a" * k for k in MD5_EDGES]
    out += ["é" * 28, "é" * 27 + "x", "中文字" * 10, "\U0001f600" * 16, ""]
    while len(out) < N:
        k = int(rng.integers(0, 130))
        out.append("".join("abé中 "[i] for i in rng.integers(0, 5, k)))
    return out


def _lists(rng, n, dtype):
    out = [[1, 2, 3], [], None, [4, None, 6], [7]]
    while len(out) < n:
        k = int(rng.integers(0, 6))
        out.append(None if rng.random() < 0.1 else
                   [None if rng.random() < 0.15 else int(v)
                    for v in rng.integers(-5, 9, k)])
    if dtype == "f":
        return [None if v is None else [None if x is None else x + 0.5
                                        for x in v] for v in out]
    return out


def _table() -> pa.Table:
    rng = np.random.default_rng(31)
    floats = np.concatenate([FLOAT_EDGES, rng.normal(0, 1, N) *
                             10.0 ** rng.integers(-30, 30, N)])[:N]
    return pa.table({
        "s": pa.array(_md5_strings(rng)[:N]),
        "f": pa.array(floats, mask=np.arange(N) % 17 == 5),
        "f32": pa.array(np.clip(floats, -3e38, 3e38).astype(np.float32),
                        pa.float32()),
        "arr": pa.array(_lists(rng, N, "i"), pa.list_(pa.int64())),
        "farr": pa.array(_lists(rng, N, "f"), pa.list_(pa.float64())),
        "k": pa.array(rng.integers(-7, 8, N).astype(np.int32),
                      mask=np.arange(N) % 11 == 3),
        "x": pa.array(rng.integers(-5, 9, N).astype(np.int64)),
        "y": pa.array(rng.normal(0, 3, N), mask=np.arange(N) % 13 == 1),
    })


TABLE = _table()
TYPES = {"s": "STRING", "f": "FLOAT64", "f32": "FLOAT32", "k": "INT32",
         "x": "INT64", "y": "FLOAT64"}


class _Side:
    def __init__(self, ir, dt):
        self.ir, self.dt = ir, dt

    def c(self, name):
        return self.ir.UnresolvedAttribute(name)

    def bind(self, e):
        dts = [getattr(self.dt, TYPES[n]) if n in TYPES else
               self.dt.list_of(self.dt.INT64 if n == "arr" else
                               self.dt.FLOAT64)
               for n in TABLE.column_names]
        return self.ir.bind(e, TABLE.column_names, dts)

    def lit(self, v):
        return self.ir.Literal(v)


EXPRS = {
    "md5": lambda x: x.ir.Md5(x.c("s")),
    "cast_double_to_string": lambda x: x.ir.Cast(x.c("f"), x.dt.STRING),
    "cast_float_to_string": lambda x: x.ir.Cast(x.c("f32"), x.dt.STRING),
    "rand_42": lambda x: x.ir.Rand(42),
    "rand_negative_seed": lambda x: x.ir.Rand(-3),
    "rand_wide_seed": lambda x: x.ir.Rand(2 ** 40 + 5),
    "size": lambda x: x.ir.Size(x.c("arr")),
    "get_item_0": lambda x: x.ir.GetArrayItem(x.c("arr"), x.lit(0)),
    "get_item_column": lambda x: x.ir.GetArrayItem(x.c("arr"), x.c("k")),
    "get_item_past_end": lambda x: x.ir.GetArrayItem(x.c("farr"),
                                                     x.lit(9)),
    "contains_2": lambda x: x.ir.ArrayContains(x.c("arr"), x.lit(2)),
    "contains_column": lambda x: x.ir.ArrayContains(x.c("arr"), x.c("x")),
    "contains_fraction": lambda x: x.ir.ArrayContains(x.c("arr"),
                                                      x.lit(2.5)),
    "contains_double": lambda x: x.ir.ArrayContains(x.c("farr"),
                                                    x.lit(1.5)),
    "element_at_1": lambda x: x.ir.ElementAt(x.c("arr"), x.lit(1)),
    "element_at_neg": lambda x: x.ir.ElementAt(x.c("arr"), x.lit(-1)),
    "element_at_0": lambda x: x.ir.ElementAt(x.c("arr"), x.lit(0)),
    "element_at_column": lambda x: x.ir.ElementAt(x.c("farr"), x.c("k")),
    "create_array": lambda x: x.ir.CreateArray(x.c("x"), x.c("k"),
                                               x.lit(3)),
    "create_array_double": lambda x: x.ir.CreateArray(x.c("y"), x.c("x")),
}


@pytest.fixture(scope="module")
def batches():
    return jfrom_arrow(TABLE), tfrom_arrow(TABLE, device="cpu")


def _assert_list_same(jv, tv):
    """A list value: validity, lengths, element validity at live slots,
    and elements at valid slots, exactly."""
    valid = np.asarray(jv.validity)
    np.testing.assert_array_equal(tv.validity.numpy(), valid)
    jl, tl = np.asarray(jv.lengths), tv.lengths.numpy()
    np.testing.assert_array_equal(tl[valid], jl[valid])
    jev_, tev_ = np.asarray(jv.elem_validity), tv.elem_validity.numpy()
    jd, td = np.asarray(jv.data), tv.data.numpy()
    for i in np.flatnonzero(valid):
        live = slice(0, jl[i])
        np.testing.assert_array_equal(tev_[i, live], jev_[i, live])
        ok = jev_[i, live]
        np.testing.assert_array_equal(td[i, live][ok], jd[i, live][ok])


@pytest.mark.parametrize("name", list(EXPRS))
def test_expression_matches_reference(name, batches):
    jb, tb = batches
    jside, tside = _Side(jir, jdt), _Side(tir, tdt)
    je = jside.bind(EXPRS[name](jside))
    te = tside.bind(EXPRS[name](tside))
    assert tev.supported_on_tpu(type(te)) and jev.supported_on_tpu(type(je))
    jv, tv = jev.evaluate(je, jb), tev.evaluate(te, tb)
    if jv.dtype.is_list:
        assert tv.dtype.name == jv.dtype.name
        _assert_list_same(jv, tv)
    else:
        assert_same(jv, tv)


@pytest.mark.parametrize("pid,offset", [(0, 0), (3, 1000), (511, 2 ** 32)])
def test_partition_leaves_match_reference(pid, offset, batches):
    jb, tb = batches
    for build in (lambda ir: ir.SparkPartitionID(),
                  lambda ir: ir.MonotonicallyIncreasingID()):
        je, te = build(jir), build(tir)
        je.resolve()
        te.resolve()
        with jctx.task_context(pid, offset):
            jv = jev.evaluate(je, jb)
        with tctx.task_context(pid, offset):
            tv = tev.evaluate(te, tb)
        assert_same(jv, tv)
        assert int(tv.data[0]) == (pid if isinstance(te, tir.SparkPartitionID)
                                   else (pid << 33) + offset)


def test_dispatch_keys_are_the_references():
    """The two evaluators cover the same expression classes, by name."""
    j = {c.__name__ for c in jev._DISPATCH}
    t = {c.__name__ for c in tev._DISPATCH}
    assert t == j
    for name in j:
        assert tev.supported_on_tpu(getattr(tir, name)), name


def test_md5_matches_hashlib(batches):
    _, tb = batches
    e = _Side(tir, tdt).bind(tir.Md5(tir.UnresolvedAttribute("s")))
    v = tev.evaluate(e, tb)
    strings = TABLE["s"].to_pylist()
    got = [bytes(v.data[i, :v.lengths[i]].tolist()).decode()
           for i in range(N)]
    assert got == [hashlib.md5(s.encode()).hexdigest() for s in strings]
    widths = {len(s.encode()) for s in strings}
    assert set(MD5_EDGES) <= widths


# rand(42) rows 0-3 as jax 0.9.0 draws them (threefry-2x32, partitionable)
RAND_42 = [0.4267275666499091, 0.015010069515314584, 0.5741444178995352,
           0.7298188969046309]


def test_rand_is_jax_uniform_bit_for_bit():
    got = tev._uniform_f64(42, 1 << 12, "cpu").numpy()
    assert got[:4].tolist() == RAND_42
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(42), (1 << 12,),
                                         dtype=np.float64))
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    # row i's value depends on i alone, not on the batch's capacity
    np.testing.assert_array_equal(tev._uniform_f64(42, 16, "cpu").numpy(),
                                  got[:16])


def _ryu(vals):
    import torch
    a = torch.tensor(np.asarray(vals, dtype=np.float64))
    ch, ln = ryu.f64_to_string(a, torch.ones(len(vals), dtype=torch.bool))
    return [bytes(ch[i, :ln[i]].tolist()).decode() for i in range(len(vals))]


def _repr(vals):
    return [("NaN" if np.isnan(v) else "Infinity" if v == np.inf else
             "-Infinity" if v == -np.inf else repr(float(v))) for v in vals]


def test_ryu_explicit_cases():
    cases = FLOAT_EDGES + [1.0, -1.0, 1.5, 2.0, 100.0, 500.0, 1e-7, 1e15,
                           3.141592653589793, 1e100, 1e-100, -123.75, 0.07,
                           float(np.float32(0.1)), float(np.float32(3.4e38))]
    assert _ryu(cases) == _repr(cases)


def test_ryu_bit_patterns():
    rng = np.random.default_rng(17)
    r = np.frombuffer(rng.integers(0, 2 ** 64, 3000, dtype=np.uint64)
                      .tobytes(), dtype=np.float64)
    r = r[np.isfinite(r)]
    assert _ryu(r) == _repr(r)


def test_ryu_log_uniform():
    rng = np.random.default_rng(23)
    r = rng.uniform(-1, 1, 1500) * 10.0 ** rng.integers(-320, 309, 1500)
    assert _ryu(r) == _repr(r)


def _pair(conf=None, ref_device=False):
    """(reference session, port session on the CPU).  The reference runs
    its CPU engine unless ``ref_device``: its device session is the
    oracle where the CPU engine differs (a filter's task context, rand's
    generator)."""
    conf = dict(BASE, **(conf or {}))
    return (JSession(conf if ref_device else
                     {"spark.rapids.tpu.sql.enabled": False}),
            TSession(conf, device="cpu"))


def _both(fn, conf=None, ignore_order=False, ref_device=False):
    """Run ``fn(session, col, F)`` on both; the port's plan must hold no
    host node (test mode) and its rows equal the reference's."""
    js, ts = _pair(conf, ref_device)
    want = fn(js, jcol, JF).collect()
    got_df = fn(ts, tcol, TF)
    got = got_df.collect()
    assert_tables_equal(want, got, ignore_order=ignore_order)
    return got_df, got


def test_cast_float_to_string_device_plan():
    rng = np.random.default_rng(31)
    vals = np.concatenate([rng.uniform(-1e6, 1e6, 200), FLOAT_EDGES])
    t = pa.table({"x": vals,
                  "y": np.float32(rng.uniform(-10, 10, len(vals)))})
    df, out = _both(lambda s, col, F: s.create_dataframe(t).select(
        col("x").cast("string").alias("sx"),
        col("y").cast("string").alias("sy")))
    assert "TpuProjectExec" in df.explain_string("physical")
    assert out.column("sx").to_pylist() == _repr(vals)
    ts = TSession({"spark.rapids.tpu.sql.castFloatToString.enabled": False},
                  device="cpu")
    df2 = ts.create_dataframe(t).select(tcol("x").cast("string").alias("sx"))
    assert "TpuProjectExec" not in df2.explain_string("physical")
    assert df2.collect().column("sx").to_pylist() == _repr(vals)


def test_cast_float_to_string_nulls():
    t = pa.table({"x": pa.array([1.5, None, float("nan"), None])})
    _, out = _both(lambda s, col, F: s.create_dataframe(t).select(
        col("x").cast("string").alias("sx")))
    assert out.column("sx").to_pylist() == ["1.5", None, "NaN", None]


def test_md5_query_matches_hashlib():
    t = pa.table({"s": ["www.apache.org", "a.b.c.d", "no-dots", "", "x..y",
                        "trailing.", None, "é" * 40]})
    _, out = _both(lambda s, col, F: s.create_dataframe(t).select(
        F.md5(col("s")).alias("h")))
    assert out.column("h").to_pylist() == [
        None if v is None else hashlib.md5(v.encode()).hexdigest()
        for v in t.column("s").to_pylist()]


def _leaf_table():
    rng = np.random.default_rng(5)
    return pa.table({"v": rng.integers(0, 100, 1000).astype(np.int64)})


def test_task_context_reaches_the_device_execs():
    """spark_partition_id() and monotonically_increasing_id() in a device
    projection and a device filter over 4 partitions of several batches
    each: every row sees its own partition and running row offset, as in
    the reference's CPU engine (the execs evaluate inside
    ``context.task_context(pid, offset)``)."""
    conf = {"spark.rapids.tpu.sql.reader.batchSizeRows": 64}
    t = _leaf_table()

    def fn(s, col, F):
        df = s.create_dataframe(t, num_partitions=4)
        return df.select(col("v"), F.spark_partition_id().alias("p"),
                         F.monotonically_increasing_id().alias("m"))

    df, out = _both(fn, conf)
    names = df.explain_string("physical")
    assert "TpuProjectExec" in names and "Cpu" not in names.replace(
        "CpuScanExec", "")
    m = np.array(out["m"].to_pylist())
    p = np.array(out["p"].to_pylist())
    assert sorted(set(p.tolist())) == [0, 1, 2, 3]
    assert (m >> 33 == p).all() and (m & ((1 << 33) - 1)).max() >= 64

    def filt(s, col, F):
        df = s.create_dataframe(t, num_partitions=4)
        return df.filter(F.monotonically_increasing_id() % 7 == 3).select(
            "v", F.spark_partition_id().alias("p"))
    # the reference's CPU filter sets no task context: its device
    # session is the oracle
    df, out = _both(filt, conf, ref_device=True)
    assert "TpuFilterExec" in df.explain_string("physical")
    assert out.num_rows > 4


def test_rand_matches_the_reference_session():
    """rand(seed) draws the same sequence for every batch and partition
    (the reference's behaviour, a divergence from Spark recorded in
    ROADMAP): the port's device session equals the reference's device
    session bit for bit (its CPU engine draws from another generator)."""
    t = _leaf_table()
    conf = {"spark.rapids.tpu.sql.reader.batchSizeRows": 128}
    df, out = _both(lambda s, col, F: s.create_dataframe(
        t, num_partitions=2).select(col("v"), F.rand(7).alias("r")), conf,
        ref_device=True)
    r = np.array(out["r"].to_pylist())
    np.testing.assert_array_equal(r[:128], r[128:256])
    assert "Cpu" not in df.explain_string("physical").replace(
        "CpuScanExec", "")


def _arr_table():
    return pa.table({
        "id": [1, 2, 3, 4, 5],
        "arr": pa.array([[1, 2, 3], [], None, [4, None, 6], [7]],
                        type=pa.list_(pa.int64())),
        "farr": pa.array([[1.5, 2.5], None, [0.0], [], [3.25, None]],
                         type=pa.list_(pa.float64())),
    })


def test_size_get_contains_parity():
    _both(lambda s, col, F: s.create_dataframe(_arr_table()).select(
        F.size("arr").alias("n"), col("arr")[0].alias("first"),
        col("arr")[2].alias("third"), col("arr")[-1].alias("neg"),
        F.array_contains("arr", 2).alias("has2"),
        F.array_contains("arr", 99).alias("has99")))


def test_create_array_parity():
    _both(lambda s, col, F: s.create_dataframe(
        pa.table({"a": [1, 2, None], "b": [10, 20, 30]})).select(
        F.array(col("a"), col("b"), col("b") * 2).alias("arr")))


def test_element_at_parity():
    _both(lambda s, col, F: s.create_dataframe(_arr_table()).select(
        F.element_at("arr", 1).alias("e1"),
        F.element_at("arr", 3).alias("e3"),
        F.element_at("farr", -1).alias("last")))
