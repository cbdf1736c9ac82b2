"""The port's window execs against the reference's.

Every case of ``tests/test_window.py`` runs on a port session
(``device="cpu"``) and on the reference's CPU session over the same
seeded table: integers, nulls, rows and their order must match, floats
to ``tests/parity.py``'s tolerance.  Each case's window node must be the
one the reference's planner picks (``TpuWindowExec`` where its
``_tag_window`` accepts, ``CpuWindowExec`` with its reason where it
refuses).  The sort-space helpers of ``exec/tpu_window.py`` are held to
the reference's functions on the same arrays, exactly, float sums bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax import lax

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.api.window import Window as JWindow
from spark_rapids_tpu.exec import tpu_window as jtw

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.window import Window as TWindow
from spark_rapids_tpu_torch.exec import tpu_window as ttw

from tests.data_gen import (BoolGen, IntGen, StringGen, boolean_gen,
                            double_gen, gen_df, int_key_gen, long_gen)
from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
REF = (jcol, JF, JWindow)
PORT = (tcol, TF, TWindow)


def _w(W):
    return W.partition_by("k").order_by("o")


def _keyed(s, seed, hi, vgen, n, null_prob=None):
    ogen = IntGen(32, lo=0, hi=hi) if null_prob is None else \
        IntGen(32, lo=0, hi=hi, null_prob=null_prob)
    return gen_df(s, [int_key_gen, ogen, vgen], ["k", "o", "v"], n=n,
                  seed=seed)


# -- the cases of tests/test_window.py, as fn(session, col, F, Window) --

def row_number_rank(s, col, F, W):
    return gen_df(s, [int_key_gen, IntGen(32, lo=0, hi=9), long_gen],
                  ["k", "o", "v"], n=200).select(
        "k", "o", "v", F.row_number().over(_w(W)).alias("rn"),
        F.rank().over(_w(W)).alias("rk"),
        F.dense_rank().over(_w(W)).alias("dr"))


def window_runs_on_tpu(s, col, F, W):
    df = s.create_dataframe({"k": [1, 1, 2], "o": [1, 2, 1],
                             "v": [10, 20, 30]})
    return df.select("k", F.row_number().over(_w(W)).alias("rn"))


def lead_lag(s, col, F, W):
    return gen_df(s, [int_key_gen, IntGen(32, lo=0, hi=50), long_gen],
                  ["k", "o", "v"], n=150).select(
        "k", "o", F.lead("v").over(_w(W)).alias("ld"),
        F.lag("v", 2).over(_w(W)).alias("lg"),
        F.lead("v", 1, -99).over(_w(W)).alias("ldd"))


def running_aggregates(s, col, F, W):
    return gen_df(s, [int_key_gen, IntGen(32, lo=0, hi=50), long_gen],
                  ["k", "o", "v"], n=150).select(
        "k", "o", "v", F.sum("v").over(_w(W)).alias("rsum"),
        F.count("v").over(_w(W)).alias("rcnt"),
        F.min("v").over(_w(W)).alias("rmin"),
        F.max("v").over(_w(W)).alias("rmax"))


def whole_partition_agg(s, col, F, W):
    w = W.partition_by("k")
    return gen_df(s, [int_key_gen, long_gen], ["k", "v"], n=150).select(
        "k", "v", F.sum("v").over(w).alias("psum"),
        F.avg("v").over(w).alias("pavg"),
        F.count("*").over(w).alias("pcnt"))


def sliding_row_frame_sum(s, col, F, W):
    w = _w(W).rows_between(-2, 2)
    return _keyed(s, 0, 60, long_gen, 150).select(
        "k", "o", F.sum("v").over(w).alias("ssum"),
        F.count("v").over(w).alias("scnt"),
        F.avg("v").over(w).alias("savg"))


def rows_unbounded_following(s, col, F, W):
    w = _w(W).rows_between(0, W.unbounded_following)
    return _keyed(s, 0, 60, long_gen, 120).select(
        "k", "o", F.sum("v").over(w).alias("tailsum"))


def range_current_row_peers(s, col, F, W):
    df = s.create_dataframe({"k": [1, 1, 1, 1, 2, 2],
                             "o": [1, 2, 2, 3, 1, 1],
                             "v": [10, 20, 30, 40, 5, 7]})
    return df.select("k", "o", "v", F.sum("v").over(_w(W)).alias("rsum"))


def window_desc_order(s, col, F, W):
    w = W.partition_by("k").order_by(col("o").desc())
    return _keyed(s, 0, 20, long_gen, 120).select(
        "k", "o", F.row_number().over(w).alias("rn"),
        F.sum("v").over(w).alias("rsum"))


def window_float_agg(s, col, F, W):
    return _keyed(s, 0, 50, double_gen, 120).select(
        "k", "o", F.min("v").over(_w(W)).alias("rmin"),
        F.max("v").over(_w(W)).alias("rmax"))


def finite_range_falls_back(s, col, F, W):
    w = _w(W).range_between(-5, 5)
    return _keyed(s, 0, 60, long_gen, 100).select(
        "k", "o", F.sum("v").over(w).alias("rsum"))


def no_partition_window(s, col, F, W):
    w = W.order_by("o")
    return gen_df(s, [IntGen(32, lo=0, hi=30), long_gen], ["o", "v"],
                  n=100).select("o", F.row_number().over(w).alias("rn"),
                                F.sum("v").over(w).alias("rsum"))


def finite_range_sum_on_tpu_plan(s, col, F, W):
    w = _w(W).range_between(-5, 5)
    return _keyed(s, 21, 60, long_gen, 200).select(
        "k", "o", F.sum("v").over(w).alias("rsum"))


def finite_range_desc_and_counts(s, col, F, W):
    w = W.partition_by("k").order_by(col("o").desc()).range_between(-3, 3)
    return _keyed(s, 22, 40, long_gen, 150).select(
        "k", "o", F.count("v").over(w).alias("c"),
        F.avg("v").over(w).alias("a"))


def finite_range_with_null_order_keys(s, col, F, W):
    w = _w(W).range_between(-2, 2)
    return _keyed(s, 23, 20, long_gen, 150, null_prob=0.2).select(
        "k", "o", F.sum("v").over(w).alias("rsum"))


def finite_range_one_sided(s, col, F, W):
    w = _w(W).range_between(W.unbounded_preceding, 4)
    return _keyed(s, 24, 30, long_gen, 120).select(
        "k", "o", F.sum("v").over(w).alias("rsum"))


def finite_range_double_order_key(s, col, F, W):
    w = _w(W).range_between(-1, 1)
    return gen_df(s, [int_key_gen, double_gen, long_gen], ["k", "o", "v"],
                  n=150, seed=25).select(
        "k", "o", F.sum("v").over(w).alias("rsum"))


def finite_range_desc_null_order_keys(s, col, F, W):
    w = W.partition_by("k").order_by(col("o").desc()).range_between(-2, 2)
    return _keyed(s, 26, 20, long_gen, 150, null_prob=0.25).select(
        "k", "o", F.sum("v").over(w).alias("rsum"),
        F.count("v").over(w).alias("c"))


def finite_range_desc_double_order_key(s, col, F, W):
    w = (W.partition_by("k").order_by(col("o").desc())
         .range_between(-1.5, 1.5))
    return gen_df(s, [int_key_gen, double_gen, long_gen], ["k", "o", "v"],
                  n=150, seed=27).select(
        "k", "o", F.sum("v").over(w).alias("rsum"),
        F.avg("v").over(w).alias("a"))


def sliding_min_max_on_tpu_plan(s, col, F, W):
    w = _w(W).rows_between(-3, 0)
    return _keyed(s, 31, 60, long_gen, 200).select(
        "k", "o", F.min("v").over(w).alias("mn"),
        F.max("v").over(w).alias("mx"))


def sliding_min_max_two_sided(s, col, F, W):
    w = _w(W).rows_between(-2, 2)
    return _keyed(s, 32, 60, long_gen, 150).select(
        "k", "o", F.min("v").over(w).alias("mn"),
        F.max("v").over(w).alias("mx"))


def sliding_min_max_floats(s, col, F, W):
    w = _w(W).rows_between(-3, 1)
    return _keyed(s, 33, 50, double_gen, 200).select(
        "k", "o", F.min("v").over(w).alias("mn"),
        F.max("v").over(w).alias("mx"))


def sliding_min_max_bool(s, col, F, W):
    w = _w(W).rows_between(-2, 0)
    return _keyed(s, 34, 40, boolean_gen, 150).select(
        "k", "o", F.min("v").over(w).alias("mn"),
        F.max("v").over(w).alias("mx"))


def running_min_max_bool(s, col, F, W):
    return _keyed(s, 37, 40, boolean_gen, 150).select(
        "k", "o", F.min("v").over(_w(W)).alias("mn"),
        F.max("v").over(_w(W)).alias("mx"))


def bounded_start_unbounded_end_min_max(s, col, F, W):
    w = _w(W).rows_between(-1, W.unbounded_following)
    return _keyed(s, 35, 40, long_gen, 150).select(
        "k", "o", F.min("v").over(w).alias("mn"),
        F.max("v").over(w).alias("mx"))


def finite_range_min_max(s, col, F, W):
    w = _w(W).range_between(-5, 5)
    return _keyed(s, 36, 30, long_gen, 180, null_prob=0.15).select(
        "k", "o", F.min("v").over(w).alias("mn"),
        F.max("v").over(w).alias("mx"))


def window_sum_int64_overflow_wraps(s, col, F, W):
    big = (1 << 62) + 12345
    df = s.create_dataframe({"k": [1, 1, 1, 1, 2, 2],
                             "o": [1, 2, 3, 4, 1, 2],
                             "v": [big, big, big, -7, big, big]})
    w = _w(W).rows_between(W.unbounded_preceding, W.unbounded_following)
    return df.select("k", "o", F.sum("v").over(w).alias("s"))


CASES = {f.__name__: f for f in (
    row_number_rank, window_runs_on_tpu, lead_lag, running_aggregates,
    whole_partition_agg, sliding_row_frame_sum, rows_unbounded_following,
    range_current_row_peers, window_desc_order, window_float_agg,
    finite_range_falls_back, no_partition_window,
    finite_range_sum_on_tpu_plan, finite_range_desc_and_counts,
    finite_range_with_null_order_keys, finite_range_one_sided,
    finite_range_double_order_key, finite_range_desc_null_order_keys,
    finite_range_desc_double_order_key, sliding_min_max_on_tpu_plan,
    sliding_min_max_two_sided, sliding_min_max_floats, sliding_min_max_bool,
    running_min_max_bool, bounded_start_unbounded_end_min_max,
    finite_range_min_max, window_sum_int64_overflow_wraps)}


# -- what the reference's _tag_window refuses: the node stays on the host
# with the reference's reason ------------------------------------------

def string_window_aggregate(s, col, F, W):
    return gen_df(s, [int_key_gen, IntGen(32, lo=0, hi=20),
                      StringGen(max_len=4)], ["k", "o", "v"], n=80,
                  seed=42).select(
        "k", "o", F.max("v").over(_w(W)).alias("mx"))


def nested_partition_key(s, col, F, W):
    # no nulls: both CPU engines compare list keys with Python's <, which
    # has no order for a null element
    w = W.partition_by(F.array(col("k"), col("o"))).order_by("o")
    return gen_df(s, [IntGen(32, lo=0, hi=3, nullable=False),
                      IntGen(32, lo=0, hi=5, nullable=False), long_gen],
                  ["k", "o", "v"], n=80, seed=43).select(
        "k", "o", F.row_number().over(w).alias("rn"))


def first_window_aggregate(s, col, F, W):
    return _keyed(s, 44, 20, long_gen, 40).select(
        "k", "o", F.first("v").over(_w(W)).alias("f"))


# name -> (case, the reference's reason); neither engine computes First
# over a window (the CPU window has no First either)
REFUSED = {
    "string_window_aggregate":
        (string_window_aggregate,
         "string window aggregates not supported on TPU"),
    "nested_partition_key":
        (nested_partition_key, "nested type array<int> not supported "
                               "as a window partition key on TPU"),
    "first_window_aggregate":
        (first_window_aggregate,
         "window aggregate First not supported on TPU"),
}


@pytest.fixture(scope="module")
def sessions():
    ref_cpu = JSession(dict(CONF, **{"spark.rapids.tpu.sql.enabled": False}))
    ref_tpu = JSession(CONF)
    port = TSession(dict(CONF, **{"spark.rapids.tpu.sql.test.enabled": True}),
                    device="cpu")
    port_loose = TSession(CONF, device="cpu")
    return ref_cpu, ref_tpu, port, port_loose


def _window_nodes(plan_str: str):
    return [ln.strip().split("(")[0].lstrip("*") for ln in
            plan_str.splitlines() if "WindowExec" in ln]


@pytest.mark.parametrize("name", list(CASES))
def test_window_case_matches_reference(name, sessions):
    ref_cpu, ref_tpu, port, _ = sessions
    fn = CASES[name]
    ref = fn(ref_cpu, *REF).collect()
    df = fn(port, *PORT)
    assert_tables_equal(ref, df.collect())
    # the reference's planner (planning only) picks the device node
    want = _window_nodes(fn(ref_tpu, *REF).explain_string("physical"))
    assert want == ["TpuWindowExec"]
    assert _window_nodes(df.explain_string("physical")) == want


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_window_stays_on_host_with_reason(name, sessions):
    ref_cpu, ref_tpu, _, port = sessions
    fn, reason = REFUSED[name]
    ref_df = fn(ref_tpu, *REF)
    assert _window_nodes(ref_df.explain_string("physical")) == \
        ["CpuWindowExec"]
    assert reason in ref_df.explain_string("tpu")
    df = fn(port, *PORT)
    assert _window_nodes(df.explain_string("physical")) == ["CpuWindowExec"]
    assert reason in df.explain_string("tpu")
    if fn is first_window_aggregate:
        for d in (fn(ref_cpu, *REF), df):
            with pytest.raises(NotImplementedError, match="First"):
                d.collect()
        return
    assert_tables_equal(fn(ref_cpu, *REF).collect(), df.collect())


@pytest.mark.parametrize("conf", [
    {"spark.rapids.tpu.sql.window.exchange.enabled": True},
    {"spark.rapids.tpu.shuffle.transport": "ici"}])
def test_partitionwise_window_raises_naming_exchange(conf):
    """``window.exchange.enabled`` plans the reference's partitionwise
    window (a hash exchange on the PARTITION BY keys) and gives its rows;
    under ``shuffle.transport=ici`` that exchange names shuffle/ici.py."""
    s = TSession(dict(CONF, **conf), device="cpu")
    df = row_number_rank(s, *PORT)
    assert "TpuShuffleExchangeExec" in df.explain_string("physical")
    if conf.get("spark.rapids.tpu.shuffle.transport") == "ici":
        with pytest.raises(NotImplementedError, match="shuffle/ici.py"):
            df.collect()
    else:
        ref = row_number_rank(JSession(dict(
            CONF, **conf, **{"spark.rapids.tpu.sql.adaptive.enabled":
                             False})), *REF).collect()
        assert_tables_equal(ref, df.collect())
    # without PARTITION BY there is nothing to exchange on
    assert no_partition_window(s, *PORT).collect().num_rows == 100


def test_partitionwise_window_at_default_adaptive():
    """``window.exchange.enabled`` with adaptive reads on in both
    packages (the default): the window's exchange is no join exchange,
    so neither wraps it, and the rows equal the reference's."""
    conf = dict(CONF, **{"spark.rapids.tpu.sql.window.exchange.enabled":
                         True})
    df = row_number_rank(TSession(conf, device="cpu"), *PORT)
    plan = df.explain_string("physical")
    assert "TpuShuffleExchangeExec" in plan
    assert "TpuAdaptiveJoinReaderExec" not in plan
    ref = row_number_rank(JSession(conf), *REF).collect()
    assert_tables_equal(ref, df.collect())


# -- the sort-space helpers against the reference's, on the same arrays --

def _flags(rng, n, density, huge_tail=0):
    new = rng.random(n) < density
    new[0] = True
    if huge_tail:
        new[n - huge_tail:] = False   # one huge segment, as padding forms
        new[n - huge_tail] = True
    return new


FLAG_CASES = [(1000, 0.1, 0), (4096, 0.01, 3000), (777, 1.0, 0),
              (513, 0.0, 0), (2048, 0.3, 1024)]


@pytest.mark.parametrize("n,density,tail", FLAG_CASES)
def test_segment_bounds_match_reference(n, density, tail):
    new = _flags(np.random.default_rng(n), n, density, tail)
    seg = jtw._boundaries_to_seg(jnp.asarray(new))
    pos = jnp.arange(n, dtype=jnp.int32)
    want_s = jnp.take(jax.ops.segment_min(pos, seg, num_segments=n), seg)
    want_e = jnp.take(jax.ops.segment_max(pos, seg, num_segments=n), seg)
    start, end = ttw.segment_bounds(torch.from_numpy(new))
    np.testing.assert_array_equal(start.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(end.numpy(), np.asarray(want_e))
    # the per-partition counts of _range_frame_bounds' pcount
    mask = np.random.default_rng(1).random(n) < 0.3
    want_c = jnp.take(jax.ops.segment_sum(jnp.asarray(mask, jnp.int64),
                                          seg, num_segments=n), seg)

    class Ctx:
        part_start, part_end = start, end
    got_c = ttw._WinCtx.pcount(Ctx, torch.from_numpy(mask))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def _sorted_segments(rng, n, dtype):
    new = _flags(rng, n, 0.05)
    seg = np.cumsum(new) - 1
    vals = rng.integers(-50, 50, n).astype(dtype)
    order = np.lexsort((vals, seg))
    vals = vals[order]
    start = np.maximum.accumulate(np.where(new, np.arange(n), 0))
    end = np.array([np.flatnonzero(seg == s)[-1] for s in seg])
    return vals, start, end


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_seg_searchsorted_matches_reference(left, dtype):
    rng = np.random.default_rng(7)
    vals, lo, hi = _sorted_segments(rng, 600, dtype)
    # shrink some slices, empty a few (hi = lo - 1)
    lo = lo + (rng.random(600) < 0.2)
    hi = np.where(rng.random(600) < 0.05, lo - 1, hi)
    target = (vals + rng.integers(-3, 4, 600)).astype(dtype)
    want = jtw._seg_searchsorted(jnp.asarray(vals), jnp.asarray(lo),
                                 jnp.asarray(hi), jnp.asarray(target), left)
    got = ttw._seg_searchsorted(torch.from_numpy(vals), torch.from_numpy(lo),
                                torch.from_numpy(hi),
                                torch.from_numpy(target), left)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("off", [0, 1, 5, -1, -5, 2 ** 62, -(2 ** 62),
                                 2 ** 63 - 1, -(2 ** 63), 1.5, -2.5])
def test_sat_add_matches_reference_at_int64_bounds(off):
    imax, imin = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    w = np.array([imax, imax - 1, imax - 4, imin, imin + 1, imin + 4, 0,
                  -1, 1, 2 ** 62, -(2 ** 62)], dtype=np.int64)
    want = jtw._sat_add(jnp.asarray(w), off)
    got = ttw._sat_add(torch.from_numpy(w), off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wf = np.array([1e300, -1e300, 0.5, -0.0, np.inf], dtype=np.float64)
    np.testing.assert_array_equal(
        ttw._sat_add(torch.from_numpy(wf), off).numpy(),
        np.asarray(jtw._sat_add(jnp.asarray(wf), off)))


def test_floor_log2_matches_clz_on_every_power_of_two():
    ns = sorted({v for k in range(32) for v in ((1 << k) - 1, 1 << k,
                                                (1 << k) + 1)
                 if 1 <= v <= 2 ** 31 - 1})
    n32 = np.array(ns, dtype=np.int32)
    want = np.asarray(31 - lax.clz(jnp.asarray(n32)))
    np.testing.assert_array_equal(
        ttw.floor_log2(torch.from_numpy(n32)).numpy(), want)
    np.testing.assert_array_equal(
        ttw.floor_log2(torch.from_numpy(n32.astype(np.int64))).numpy(),
        [v.bit_length() - 1 for v in ns])


def _frames(rng, n, max_len=None):
    a = rng.integers(0, n, n)
    span = rng.integers(-2, (max_len or n) + 1, n)
    if max_len is not None:
        span = np.minimum(span, max_len - 1)
    b = np.minimum(a + span, n - 1)
    return a.astype(np.int64), b.astype(np.int64)


@pytest.mark.parametrize("n", [1, 2, 37, 1024, 1500])
def test_range_sum_bit_for_bit(n):
    rng = np.random.default_rng(n)
    x = rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 19, n)
    a, b = _frames(rng, n)
    want = np.asarray(jtw._range_sum(jnp.asarray(x), jnp.asarray(a),
                                     jnp.asarray(b)))
    got = ttw._range_sum(torch.from_numpy(x), torch.from_numpy(a),
                         torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("max_len", [None, 1, 4, 7, 64])
@pytest.mark.parametrize("kind", ["min_i64", "max_f64", "and_bool"])
def test_range_minmax_with_max_len_matches_reference(max_len, kind):
    rng = np.random.default_rng(3)
    n = 700
    a, b = _frames(rng, n, max_len)
    if kind == "min_i64":
        x = rng.integers(-2 ** 40, 2 ** 40, n)
        jop, top, fill = jnp.minimum, torch.minimum, np.iinfo(np.int64).max
    elif kind == "max_f64":
        x = rng.normal(0, 1e6, n)
        jop, top, fill = jnp.maximum, torch.maximum, -np.inf
    else:
        x = rng.random(n) < 0.9
        jop, top, fill = jnp.logical_and, torch.logical_and, True
    want = np.asarray(jtw._range_minmax(jop, jnp.asarray(x), jnp.asarray(a),
                                        jnp.asarray(b), fill, max_len))
    got = ttw._range_minmax(top, torch.from_numpy(x), torch.from_numpy(a),
                            torch.from_numpy(b),
                            fill.item() if hasattr(fill, "item") else fill,
                            max_len).numpy()
    live = b >= a
    np.testing.assert_array_equal(got[live], want[live])


def test_window_emits_in_the_last_specs_sorted_order(sessions):
    """Two specs: rows come out in the second spec's (partition, order)
    order, ties in input order, exactly as the reference's CPU engine."""
    ref_cpu, _, port, _ = sessions

    def q(s, col, F, W):
        t = pa.table({"k": pa.array([2, 1, 2, 1, 1, 2, None], pa.int32()),
                      "o": pa.array([3, 1, 1, 1, None, 3, 2], pa.int32()),
                      "g": pa.array([0, 1, 0, 1, 0, 1, 0], pa.int32())})
        return s.create_dataframe(t).select(
            "k", "o", "g",
            F.row_number().over(W.partition_by("k").order_by("o"))
            .alias("a"),
            F.rank().over(W.partition_by("g").order_by(col("o").desc()))
            .alias("b"))
    assert_tables_equal(q(ref_cpu, *REF).collect(), q(port, *PORT).collect())


def test_string_lead_lag_with_default(sessions):
    ref_cpu, _, port, _ = sessions

    def q(s, col, F, W):
        return gen_df(s, [int_key_gen, IntGen(32, lo=0, hi=30),
                          StringGen(max_len=9), BoolGen()],
                      ["k", "o", "v", "b"], n=120, seed=44).select(
            "k", "o", F.lag("v", 1, "none").over(_w(W)).alias("lg"),
            F.lead("v", 2).over(_w(W)).alias("ld"),
            F.lead("b", 1, True).over(_w(W)).alias("lb"))
    df = q(port, *PORT)
    assert _window_nodes(df.explain_string("physical")) == ["TpuWindowExec"]
    assert_tables_equal(q(ref_cpu, *REF).collect(), df.collect())
