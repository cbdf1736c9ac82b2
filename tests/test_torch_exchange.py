"""The port's shuffle exchange, shuffled joins and partitionwise plans
against the reference's.

The murmur3 group (``expr/eval_tpu.hash_colval``) and the partition ids
(``hash_targets``, ``_range_spans``, ``round_robin_targets``) are held
against the reference's functions on the same Arrow input, bit for bit
and id for id.  ``tests/test_exchange.py``'s cases and the shuffled and
outer cases of ``tests/test_joins.py`` run on a port session
(``device="cpu"``) under both ported transports (``local``, ``device``)
and on a reference session: each partition's rows and their order for
the repartitions, the joins row for row (and route for route where the
reference's rule decides one).  ``sql.adaptive.enabled`` is false on
both sessions wherever partitions or row order are compared, as
``tests/test_exchange.py`` sets it; the shuffled joins also run at the
default, where both packages' adaptive readers regroup the partitions.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

import spark_rapids_tpu as jpkg
from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.exec import sortkeys as jsk
from spark_rapids_tpu.exec import tpu_join as jjoin
from spark_rapids_tpu.expr import eval_tpu as jev
from spark_rapids_tpu.expr import ir as jir
from spark_rapids_tpu.plan import logical as jlp
from spark_rapids_tpu.shuffle import exchange as jex
from spark_rapids_tpu.shuffle import serializer as jser

from spark_rapids_tpu_torch import api as tapi
from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api.window import Window as TWindow
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.config import RapidsTpuConf
from spark_rapids_tpu_torch.exec import cpu as tcpu
from spark_rapids_tpu_torch.exec import sortkeys as tsk
from spark_rapids_tpu_torch.expr import eval_tpu as tev
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.plan import logical as tlp
from spark_rapids_tpu_torch.plan import planner as tplanner
from spark_rapids_tpu_torch.shuffle import exchange as tex
from spark_rapids_tpu_torch.shuffle import serializer as tser

from tests.data_gen import (BoolGen, DateGen, FloatGen, IntGen,
                            TimestampGen, double_gen, gen_table, int_key_gen,
                            long_gen, string_key_gen)
from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

SHUF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.test.enabled": True,
        "spark.rapids.tpu.sql.shuffle.partitions": 4,
        "spark.rapids.tpu.sql.adaptive.enabled": False}
NO_BCAST = dict(SHUF, **{"spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                         -1})
TRANSPORTS = ("local", "device")
ROUTES = ("join.route.probe", "join.route.sort")


def _conf(base, transport, **extra):
    return dict(base, **{"spark.rapids.tpu.shuffle.transport": transport},
                **extra)


# ---------------------------------------------------------------------------
# Serializer / codec SPI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["none", "copy", "lz4", "zstd", "zlib"])
def test_serializer_roundtrip(codec):
    """Each codec round-trips, and the two packages read each other's
    blocks."""
    t = pa.table({"a": [1, 2, None, 4], "s": ["x", None, "zzz", ""],
                  "f": [0.5, float("nan"), -0.0, None]})
    data = tser.serialize_table(t, tser.get_codec(codec))
    ref = jser.serialize_table(t, jser.get_codec(codec))
    for out in (tser.deserialize_table(data), jser.deserialize_table(data),
                tser.deserialize_table(ref)):
        assert out.schema.equals(t.schema)
        assert_tables_equal(t, out, approx_float=False)


def test_unknown_codec_raises():
    with pytest.raises(ValueError, match="snappy"):
        tser.get_codec("snappy")


# ---------------------------------------------------------------------------
# murmur3 and the partition ids, against the reference's functions
# ---------------------------------------------------------------------------

def _utf8_strings(rng, n):
    """Strings of every byte length 0-33, many ending in multi-byte
    characters (tail bytes >= 0x80), with about 10% nulls."""
    wide = ["é", "中", "\U0001f600", "ÿ"]
    out = []
    for i in range(n):
        length = i % 34
        c = wide[rng.integers(len(wide))] if rng.random() < 0.7 else ""
        k = len(c.encode())
        if k > length:
            c, k = "", 0
        ascii_ = "".join(chr(int(x)) for x in
                         rng.integers(32, 127, length - k))
        out.append(None if rng.random() < 0.1 else ascii_ + c)
    return pa.array(out, type=pa.string())


def _hash_column(kind, rng, n):
    if kind == "string":
        return _utf8_strings(rng, n)
    gen = {"int8": IntGen(8), "int16": IntGen(16), "int32": IntGen(32),
           "int64": IntGen(64), "float32": FloatGen(32),
           "float64": FloatGen(64), "bool": BoolGen(), "date": DateGen(),
           "timestamp": TimestampGen()}[kind]
    return gen.generate(rng, n)


def _both_batches(table):
    return (jbatch.from_arrow(table),
            tbatch.from_arrow(table, device="cpu"))


def _bound(pkg_ir, pkg_dt, table, i):
    f = table.schema.field(i)
    return pkg_ir.BoundReference(i, pkg_dt.from_arrow(f.type), True,
                                 name_=f.name)


HASH_TYPES = ["int8", "int16", "int32", "int64", "float32", "float64",
              "bool", "date", "timestamp", "string"]


@pytest.mark.parametrize("kind", HASH_TYPES)
def test_hash_colval_matches_reference(kind):
    """One murmur3 step per row, from random int32 seeds, bit for bit:
    nulls keep the seed; NaN and -0.0 are folded; a string's tail bytes
    sign-extend."""
    rng = np.random.default_rng(HASH_TYPES.index(kind))
    n = 600
    table = pa.table({"c": _hash_column(kind, rng, n)})
    if kind.startswith("float"):
        vals = table["c"].to_pylist()
        for i, v in enumerate([float("nan"), -0.0, 0.0, float("-nan")]):
            vals[i] = v
        table = pa.table({"c": pa.array(vals, type=table["c"].type)})
    jb, tb = _both_batches(table)
    seed = rng.integers(-2**31, 2**31, jb.capacity).astype(np.int32)
    jv = jev.evaluate(_bound(jir, jdt, table, 0), jb)
    tv = tev.evaluate(_bound(tir, tdt, table, 0), tb)
    want = np.asarray(jev.hash_colval(jv, jnp.asarray(seed)))
    got = tev.hash_colval(tv, torch.from_numpy(seed)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[:n], want[:n])


def _key_table(n=500, seed=21):
    rng = np.random.default_rng(seed)
    return pa.table({"i": _hash_column("int32", rng, n),
                     "l": _hash_column("int64", rng, n),
                     "d": _hash_column("float64", rng, n),
                     "s": _utf8_strings(rng, n),
                     "b": _hash_column("bool", rng, n)})


@pytest.mark.parametrize("n_parts", [1, 4, 7])
def test_hash_targets_match_reference(n_parts):
    """Murmur3 over five key columns, pmod n_parts: the same id for
    every row."""
    table = _key_table()
    jb, tb = _both_batches(table)
    jkeys = [_bound(jir, jdt, table, i) for i in range(table.num_columns)]
    tkeys = [_bound(tir, tdt, table, i) for i in range(table.num_columns)]
    want = np.asarray(jex.hash_targets(jb, jkeys, n_parts))
    got = tex.hash_targets(tb, tkeys, n_parts).numpy()
    n = table.num_rows
    np.testing.assert_array_equal(got[:n], want[:n])
    assert got.min() >= 0 and got.max() < n_parts


def test_murmur3_expression_matches_the_cpu_engine():
    """The device Murmur3Hash expression equals the port's (and so the
    reference's) host evaluator on the same rows."""
    from spark_rapids_tpu.expr import eval_cpu as jcpu
    from spark_rapids_tpu_torch.expr import eval_cpu as tcpu_eval
    table = _key_table(seed=22)
    tb = tbatch.from_arrow(table, device="cpu")
    keys = [_bound(tir, tdt, table, i) for i in range(table.num_columns)]
    got = tev.evaluate(tir.Murmur3Hash(keys, 42), tb).data.numpy()
    host = tcpu_eval.evaluate(tir.Murmur3Hash(keys, 42), table).data
    ref = jcpu.evaluate(jir.Murmur3Hash(
        [_bound(jir, jdt, table, i) for i in range(table.num_columns)],
        42), table).data
    n = table.num_rows
    np.testing.assert_array_equal(got[:n], np.asarray(host))
    np.testing.assert_array_equal(got[:n], np.asarray(ref))


@pytest.mark.parametrize("kind", ["float32", "float64", "int64"])
def test_known_float_normalized_matches_reference(kind):
    """NaN canonical and -0.0 folded to +0.0, bit for bit; other types
    pass through."""
    rng = np.random.default_rng(7)
    vals = _hash_column(kind, rng, 200).to_pylist()
    if kind != "int64":
        vals[:4] = [float("nan"), -0.0, 0.0, float("-nan")]
    table = pa.table({"c": pa.array(vals, type=_hash_column(
        kind, rng, 1).type)})
    jb, tb = _both_batches(table)
    want = jev.evaluate(jir.KnownFloatingPointNormalized(
        _bound(jir, jdt, table, 0)), jb)
    got = tev.evaluate(tir.KnownFloatingPointNormalized(
        _bound(tir, tdt, table, 0)), tb)
    w, g = np.asarray(want.data)[:200], got.data.numpy()[:200]
    assert g.dtype == w.dtype
    if kind != "int64":
        w, g = w.view(f"i{w.itemsize}"), g.view(f"i{g.itemsize}")
    valid = np.asarray(want.validity)[:200]
    np.testing.assert_array_equal(got.validity.numpy()[:200], valid)
    np.testing.assert_array_equal(g[valid], w[valid])

RANGE_ORDERS = [((0, True, None),), ((0, False, None),),
                ((0, True, False), (2, False, True)), ((3, True, None),)]


@pytest.mark.parametrize("spec", RANGE_ORDERS,
                         ids=["int_asc", "int_desc", "int_double", "str"])
@pytest.mark.parametrize("n_parts", [3, 8])
def test_range_spans_match_reference(spec, n_parts):
    """Exact-rank range ids with equal keys held in one span (ties,
    nulls, NaN): the same id for every row."""
    rng = np.random.default_rng(n_parts)
    n = 300
    table = pa.table({"k": IntGen(32, lo=0, hi=30).generate(rng, n),
                      "v": long_gen.generate(rng, n),
                      "d": FloatGen(64).generate(rng, n),
                      "s": string_key_gen.generate(rng, n)})
    jb, tb = _both_batches(table)

    def ids(pkg_ir, pkg_dt, pkg_lp, sk, ex, b):
        orders = [pkg_lp.SortOrder(_bound(pkg_ir, pkg_dt, table, c), asc,
                                   nf) for c, asc, nf in spec]
        groups = [sk.encode_keys(ex.eval_tpu.evaluate(o.expr, b),
                                 o.ascending, o.nulls_first_resolved)
                  for o in orders]
        order = sk.shared_lexsort(sk.stack_sort_words(groups, b.row_mask()))
        return np.asarray(ex.range_targets_from_order(b, orders, order,
                                                      n_parts))
    want = ids(jir, jdt, jlp, jsk, jex, jb)
    got = ids(tir, tdt, tlp, tsk, tex, tb)
    np.testing.assert_array_equal(got[:n], want[:n])


@pytest.mark.parametrize("start", [0, 5, 2**31 - 3])
def test_round_robin_targets_match_reference(start):
    table = pa.table({"x": np.arange(100, dtype=np.int64)})
    jb, tb = _both_batches(table)
    want = np.asarray(jex.round_robin_targets(jb, 7, jnp.asarray(start)))
    got = tex.round_robin_targets(tb, 7, start).numpy()
    np.testing.assert_array_equal(got, want)


def test_partition_order_is_stable():
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.integers(0, 5, 1000).astype(np.int32))
    order, counts = tex.partition_order(t, 4)
    assert counts.tolist() == [int((t == p).sum()) for p in range(4)]
    want = np.argsort(t.numpy(), kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)


# ---------------------------------------------------------------------------
# Repartition: each partition's rows and order, both transports
# ---------------------------------------------------------------------------

def _parts_of(session, df):
    """Per output partition, its rows as one table (None when empty); the
    root of a planned device query is its download, so both packages'
    plans yield Arrow tables."""
    out = []
    for it in session._plan_physical(df.plan).plan.execute():
        tables = [t for t in it if t.num_rows]
        out.append(pa.concat_tables(tables) if tables else None)
    return out


def _same_partitions(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        if r is None or g is None:
            assert (r is None or r.num_rows == 0) and \
                (g is None or g.num_rows == 0)
            continue
        assert_tables_equal(r, g, approx_float=False)


REPARTITIONS = {
    "hash": lambda df, api: df.repartition(4, "k", "s"),
    "range": lambda df, api: df.repartition_by_range(4, "k",
                                                     api.col("d").desc()),
    "round_robin": lambda df, api: df.repartition(5),
    "single": lambda df, api: df.repartition(1),
    "coalesce": lambda df, api: df.repartition(6, "v").coalesce(4),
}


def _repart_table():
    return gen_table([int_key_gen, long_gen, string_key_gen, double_gen,
                      DateGen(), BoolGen()],
                     ["k", "v", "s", "d", "dt", "b"], n=150, seed=3)


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("kind", list(REPARTITIONS))
def test_repartition_partitions_match_reference(kind, transport):
    """Partition by partition: the same rows in the same order as the
    reference's device exchange on the same transport, over 3 input
    partitions."""
    table = _repart_table()
    conf = _conf(SHUF, transport)
    js, ts = JSession(conf), TSession(conf, device="cpu")
    ref = _parts_of(js, REPARTITIONS[kind](
        js.create_dataframe(table, num_partitions=3), jpkg))
    df = REPARTITIONS[kind](ts.create_dataframe(table, num_partitions=3),
                            tapi)
    plan = df.explain_string("physical")
    want = "TpuCoalescePartitionsExec" if kind == "coalesce" else \
        "TpuShuffleExchangeExec"
    assert want in plan, plan
    _same_partitions(ref, _parts_of(ts, df))


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_repartition_codec_parity(codec):
    table = gen_table([int_key_gen, long_gen], ["k", "v"], n=80, seed=4)
    conf = _conf(SHUF, "local", **{
        "spark.rapids.tpu.shuffle.compression.codec": codec})
    js, ts = JSession(conf), TSession(conf, device="cpu")
    ref = _parts_of(js, js.create_dataframe(table).repartition(3, "k"))
    df = ts.create_dataframe(table).repartition(3, "k")
    _same_partitions(ref, _parts_of(ts, df))
    (ex,) = [n for n in _nodes(ts, df)
             if isinstance(n, tex.TpuShuffleExchangeExec)]
    assert ex.codec_name == codec


def _nodes(s, df):
    out = []
    s._plan_physical(df.plan).plan.foreach(out.append)
    return out


def test_local_transport_counts_bytes_written():
    table = gen_table([int_key_gen, long_gen], ["k", "v"], n=120, seed=8)
    ts = TSession(_conf(SHUF, "local"), device="cpu")
    reg = obsreg.get_registry()
    before = reg.counter("shuffle.bytesWritten")
    df = ts.create_dataframe(table).repartition(4, "k")
    plans = []
    ts.add_plan_listener(lambda r: plans.append(r.plan))
    assert df.collect().num_rows == 120
    (ex,) = [n for n in _plan_list(plans[-1])
             if isinstance(n, tex.TpuShuffleExchangeExec)]
    written = ex.metrics.extra["bytes_written"]
    assert written > 0
    assert reg.counter("shuffle.bytesWritten") - before == written
    assert ex.metrics.extra["exchange.upload"] > 0
    assert ex.metrics.extra["exchange.partition"] > 0


def _plan_list(plan):
    out = []
    plan.foreach(out.append)
    return out


def test_hash_partition_colocation():
    ts = TSession(SHUF, device="cpu")
    table = gen_table([int_key_gen, long_gen], ["k", "v"], n=120, seed=8)
    parts = _parts_of(ts, ts.create_dataframe(table).repartition(4, "k"))
    seen, total = {}, 0
    for pidx, t in enumerate(parts):
        if t is None:
            continue
        total += t.num_rows
        for k in t.column("k").to_pylist():
            assert seen.setdefault(k, pidx) == pidx, k
    assert total == 120


def test_range_partition_ordering():
    ts = TSession(SHUF, device="cpu")
    table = gen_table([int_key_gen, long_gen], ["k", "v"], n=100, seed=9)
    parts = _parts_of(ts, ts.create_dataframe(table)
                      .repartition_by_range(4, "k"))
    prev_max, seen = None, {}
    for pidx, t in enumerate(parts):
        if t is None:
            continue
        vals = t.column("k").to_pylist()
        for k in vals:
            assert seen.setdefault(k, pidx) == pidx, k
        vals = [k for k in vals if k is not None]
        if vals and prev_max is not None:
            assert min(vals) >= prev_max
        if vals:
            prev_max = max(vals)


# ---------------------------------------------------------------------------
# Shuffled joins, row for row against the reference's device session
# ---------------------------------------------------------------------------

def _ref_rows_and_routes(fn, conf):
    """The reference device session's result and, for inner/left/semi/
    anti, each pair's route by its rule (tpu_join._probe_code_bits)."""
    routes = []
    orig = jjoin._probe_code_bits

    def spy(*a, **k):
        bits = orig(*a, **k)
        routes.append("probe" if bits is not None and
                      bits <= jjoin._PROBE_MAX_BITS else "sort")
        return bits
    jjoin._probe_code_bits = spy
    try:
        return fn(JSession(conf), jpkg).collect(), sorted(routes)
    finally:
        jjoin._probe_code_bits = orig


def _port_rows_and_routes(fn, conf):
    reg = obsreg.get_registry()
    before = [reg.counter(k) for k in ROUTES]
    s = TSession(conf, device="cpu")
    df = fn(s, tapi)
    names = [type(n).__name__ for n in _nodes(s, df)]
    out = df.collect()
    n = [int(reg.counter(k) - b) for k, b in zip(ROUTES, before)]
    return out, sorted(["probe"] * n[0] + ["sort"] * n[1]), names


def _join_sides(s, api, seed=11):
    left = s.create_dataframe(gen_table([int_key_gen, long_gen],
                                        ["k", "lv"], n=70, seed=seed),
                              num_partitions=2)
    right = s.create_dataframe(gen_table([int_key_gen, long_gen],
                                         ["j", "rv"], n=50, seed=seed + 1))
    return left, right.select(api.col("j").alias("k"), "rv")


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_shuffled_join_parity(how, transport):
    """Row for row against the reference's device session with the same
    confs; the full outer join takes the sort route (the reference's
    probe route serves inner and left only), every other pair the route
    the reference's rule gives it."""
    def q(s, api):
        left, right = _join_sides(s, api)
        return left.join(right, on="k", how=how)
    conf = _conf(NO_BCAST, transport)
    ref, jroutes = _ref_rows_and_routes(q, conf)
    got, troutes, names = _port_rows_and_routes(q, conf)
    assert "TpuShuffledHashJoinExec" in names, names
    assert names.count("TpuShuffleExchangeExec") == 2, names
    assert_tables_equal(ref, got)
    if how == "full":
        assert set(troutes) == {"sort"}, troutes
    else:
        assert troutes == jroutes


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("how", ["inner", "left", "full", "semi"])
def test_shuffled_join_parity_at_default_adaptive(how, transport):
    """No adaptive key: both packages wrap the join's two exchanges in
    adaptive readers; the rows equal the reference's and so do the
    routes (full outer takes the sort route)."""
    def q(s, api):
        left, right = _join_sides(s, api)
        return left.join(right, on="k", how=how)
    conf = {k: v for k, v in _conf(NO_BCAST, transport).items()
            if k != "spark.rapids.tpu.sql.adaptive.enabled"}
    ref, jroutes = _ref_rows_and_routes(q, conf)
    got, troutes, names = _port_rows_and_routes(q, conf)
    assert names.count("TpuAdaptiveJoinReaderExec") == 2, names
    assert names.count("TpuShuffleExchangeExec") == 2, names
    assert_tables_equal(ref, got, ignore_order=True)
    if how == "full":
        assert set(troutes) == {"sort"}, troutes
    else:
        assert sorted(troutes) == sorted(jroutes)


@pytest.mark.parametrize("how", ["inner", "left", "full", "anti"])
def test_shuffled_join_over_string_keys(how):
    def q(s, api):
        left = s.create_dataframe(gen_table([string_key_gen, long_gen],
                                            ["k", "lv"], n=50, seed=3))
        right = s.create_dataframe(gen_table([string_key_gen, long_gen],
                                             ["j", "rv"], n=50, seed=4))
        return left.join(right.select(api.col("j").alias("k"), "rv"),
                         on="k", how=how)
    conf = _conf(NO_BCAST, "device")
    ref, _ = _ref_rows_and_routes(q, conf)
    got, troutes, _names = _port_rows_and_routes(q, conf)
    assert_tables_equal(ref, got)
    assert set(troutes) == {"sort"}


def test_mismatched_key_types_shuffled():
    """int32 against int64 keys with nulls, full outer: both sides hash
    the promoted type, so matching keys meet in one partition."""
    def q(s, api):
        left = s.create_dataframe(pa.table(
            {"k": pa.array([1, 2, 3, 4, None], type=pa.int32()),
             "v": [1.0, 2.0, 3.0, 4.0, 5.0]}))
        right = s.create_dataframe(pa.table(
            {"k": pa.array([2, 3, 5, None], type=pa.int64()),
             "w": ["a", "b", "c", "d"]}))
        return left.join(right, on="k", how="full")
    conf = _conf(NO_BCAST, "local")
    ref, _ = _ref_rows_and_routes(q, conf)
    got, _, _ = _port_rows_and_routes(q, conf)
    assert_tables_equal(ref, got)
    assert got.num_rows == 7


def test_full_outer_join_with_condition_and_empty_partitions():
    """A full outer join whose sides share few keys (most partitions
    have one side empty), with a condition over the pair."""
    def q(s, api):
        left = s.create_dataframe(pa.table({"k": [1, 2, 2, None],
                                            "v": [5, 30, 20, 7]}))
        right = s.create_dataframe(pa.table({"k": [2, 9], "w": [10, 15]}))
        return left.join(right, on="k", how="full").filter(
            api.col("v").isNull() | api.col("w").isNull() |
            (api.col("v") > api.col("w")))
    conf = _conf(NO_BCAST, "device")
    ref, _ = _ref_rows_and_routes(q, conf)
    got, _, _ = _port_rows_and_routes(q, conf)
    assert_tables_equal(ref, got)


def test_join_strategy_selection():
    s = TSession(SHUF, device="cpu")
    big = s.create_dataframe(pa.table({"k": list(range(100)),
                                       "v": list(range(100))}))
    small = s.create_dataframe(pa.table({"k": [1, 2], "w": [7, 8]}))
    conf = RapidsTpuConf(SHUF)
    p = tplanner.plan_cpu(big.join(small, on="k").plan, conf)
    assert isinstance(p, tcpu.CpuBroadcastHashJoinExec)
    conf_nb = RapidsTpuConf(NO_BCAST)
    p = tplanner.plan_cpu(big.join(small, on="k").plan, conf_nb)
    assert isinstance(p, tcpu.CpuShuffledHashJoinExec)
    assert all(isinstance(c, tex.CpuShuffleExchangeExec)
               for c in p.children)
    # full outer never broadcasts
    p = tplanner.plan_cpu(big.join(small, on="k", how="full").plan, conf)
    assert isinstance(p, tcpu.CpuShuffledHashJoinExec)


# ---------------------------------------------------------------------------
# The partitionwise aggregate, window and sort
# ---------------------------------------------------------------------------

def _agg(s, api):
    df = s.create_dataframe(_repart_table(), num_partitions=3)
    F = api.functions
    return df.group_by("k", "s").agg(F.sum("v").alias("sv"),
                                     F.count("*").alias("c"),
                                     F.max("d").alias("md"))


def _window(s, api):
    W = TWindow if api is tapi else JWindow
    df = s.create_dataframe(_repart_table(), num_partitions=3)
    w = W.partition_by("k").order_by("v")
    return df.select("k", "v", "d", api.functions.row_number().over(w)
                     .alias("rn"),
                     api.functions.sum("d").over(w).alias("sd"))


def _sort(s, api):
    df = s.create_dataframe(_repart_table(), num_partitions=3)
    return df.sort(api.col("k").asc(), api.col("v").desc())


PARTITIONWISE = {
    "aggregate": (_agg, "spark.rapids.tpu.sql.agg.exchange.enabled",
                  "TpuHashAggregateExec"),
    "window": (_window, "spark.rapids.tpu.sql.window.exchange.enabled",
               "TpuWindowExec"),
    "sort": (_sort, "spark.rapids.tpu.sql.sort.exchange.enabled",
             "TpuSortExec"),
}


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("kind", list(PARTITIONWISE))
def test_partitionwise_plans_match_reference(kind, transport):
    """The reference's plan with the same confs (an exchange under the
    per-partition exec), and the reference device session's rows in its
    order."""
    fn, key, exec_name = PARTITIONWISE[kind]
    conf = _conf(SHUF, transport, **{key: True})
    jdf = fn(JSession(conf), jpkg)
    jnames = [type(n).__name__ for n in _nodes(jdf.session, jdf)]
    ts = TSession(conf, device="cpu")
    df = fn(ts, tapi)
    nodes = _nodes(ts, df)
    names = [type(n).__name__ for n in nodes]
    assert names == jnames
    assert "TpuShuffleExchangeExec" in names and exec_name in names, names
    (node,) = [n for n in nodes if type(n).__name__ == exec_name]
    assert getattr(node, "per_partition", None) or \
        getattr(node, "partitionwise", None)
    assert_tables_equal(jdf.collect(), df.collect())


def test_two_stage_aggregate_under_process_transport_raises():
    """ici/ici_ring/process turn the two-stage aggregate on, and the
    exchange then names the module that would serve the transport."""
    s = TSession(_conf(SHUF, "process"), device="cpu")
    with pytest.raises(NotImplementedError,
                       match="shuffle/executor_proc.py"):
        _agg(s, tapi).collect()


# ---------------------------------------------------------------------------
# The transports and modes this port does not run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport,module", [
    ("manager", "shuffle/manager.py"),
    ("process", "shuffle/executor_proc.py"),
    ("ici", "shuffle/ici.py"),
    ("ici_ring", "shuffle/ici.py")])
def test_unported_transport_raises_naming_its_module(transport, module):
    s = TSession(_conf(SHUF, transport), device="cpu")
    df = s.create_dataframe(pa.table({"k": [1, 2, 3]})).repartition(2, "k")
    with pytest.raises(NotImplementedError, match=module):
        df.collect()


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_skew_map_side_raises_naming_adaptive(transport):
    """``skew_map_side`` once raised naming exec/adaptive.py; it is
    ported now.  The held-back map output of a hash exchange has the
    reference's per-bucket row counts (and, on the host plane, its
    per-bucket Arrow bytes), each bucket's rows, and one
    ``shuffle.exchange.bucketBytes`` observation per bucket."""
    rng = np.random.default_rng(11)
    t = pa.table({"k": rng.integers(0, 9, 300), "v": rng.normal(size=300)})
    conf = _conf(SHUF, transport)
    outs = {}
    for side, S, kw, cls in (("ref", JSession, {}, jex),
                             ("port", TSession, {"device": "cpu"}, tex)):
        s = S(conf, **kw)
        df = s.create_dataframe(t, num_partitions=3).repartition(4, "k")
        (ex,) = [n for n in _nodes(s, df)
                 if isinstance(n, cls.TpuShuffleExchangeExec)]
        out = ex.skew_map_side()
        assert ex.skew_map_side() is out
        rows = [sum(int(b.num_rows) for b in out.fetch(p))
                for p in range(4)]
        outs[side] = out, rows
    (ref, ref_rows), (port, port_rows) = outs["ref"], outs["port"]
    assert port.row_counts == ref.row_counts == port_rows == ref_rows
    assert sum(port.row_counts) == 300
    assert all((tb > 0) == (r > 0)
               for tb, r in zip(port.totals, port.row_counts))
    if transport == "local":
        assert port.totals == ref.totals
    hist = obsreg.get_registry().snapshot()["bucket_histograms"][
        "shuffle.exchange.bucketBytes"]
    assert hist["count"] >= 4


# ---------------------------------------------------------------------------
# The map side under the scan pipeline and concurrent reducers
# ---------------------------------------------------------------------------

def test_repartition_over_prefetched_parquet_with_two_tasks(tmp_path):
    """A hash repartition above a fused Parquet scan with prefetch depth 2
    and 2 concurrent tasks: the map side runs in one reducer thread while
    the other waits on it, and the scan's prefetcher shares the device
    semaphore; the query must finish with every row."""
    rng = np.random.default_rng(5)
    for i in range(4):
        papq.write_table(pa.table({
            "k": rng.integers(0, 50, 3000),
            "v": rng.normal(size=3000)}), str(tmp_path / f"p{i}.parquet"),
            row_group_size=1000)
    conf = dict(SHUF, **{"spark.rapids.tpu.sql.scan.prefetch.depth": 2,
                         "spark.rapids.tpu.sql.concurrentTpuTasks": 2,
                         "spark.rapids.tpu.sql.reader.batchSizeRows": 1000})
    s = TSession(conf, device="cpu")
    df = s.read.parquet(str(tmp_path)).repartition(4, "k")
    assert "TpuParquetScanExec" in df.explain_string("physical")
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("out",
                                                       df.collect()))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "repartition over the prefetched scan hung"
    want = pa.concat_tables([papq.read_table(str(tmp_path / f"p{i}.parquet"))
                             for i in range(4)])
    assert_tables_equal(want, box["out"], ignore_order=True,
                        approx_float=False)


def test_range_exchange_nan_order_is_the_references_on_each_engine():
    """The reference's host exchange orders a range key with Arrow (NaN
    after every number in both directions) and its device exchange with
    Spark's order (NaN greatest): on a descending double key the two put
    NaN rows in different partitions.  The port keeps both: each of its
    engines equals the reference's same engine."""
    table = pa.table({"d": pa.array([3.0, float("nan"), 1.0, None, 2.0,
                                     float("nan"), -1.0, 0.5] * 4),
                      "v": np.arange(32)})

    def q(s, api):
        return s.create_dataframe(table).repartition_by_range(
            4, api.col("d").desc())
    off = {"spark.rapids.tpu.sql.enabled": False,
           "spark.rapids.tpu.sql.test.enabled": False}
    cpu = {}
    for side, cls, api in (("ref", JSession, jpkg), ("port", TSession,
                                                      tapi)):
        s = cls(dict(SHUF, **off)) if side == "ref" else \
            cls(dict(SHUF, **off), device="cpu")
        cpu[side] = _parts_of(s, q(s, api))
    _same_partitions(cpu["ref"], cpu["port"])
    js, ts = JSession(SHUF), TSession(SHUF, device="cpu")
    dev_ref, dev = _parts_of(js, q(js, jpkg)), _parts_of(ts, q(ts, tapi))
    _same_partitions(dev_ref, dev)
    nan_part = [[i for i, t in enumerate(parts) if t is not None and
                 any(x != x for x in t["d"].to_pylist() if x is not None)]
                for parts in (cpu["port"], dev)]
    assert nan_part[0] != nan_part[1], nan_part
