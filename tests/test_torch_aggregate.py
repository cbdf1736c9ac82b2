"""The port's sorted-key aggregate against the reference, on the CPU.

The same inputs — made with numpy from a seed, uploaded by the reference
and carried across as numpy leaves (columnar/interop.py) — go through the
JAX functions and their port counterparts: ``_group_ctx`` reductions, the
fused-filter update -> concat -> merge -> finalize of a small q6 table
with nulls (with and without the capacity ladder, on both of its
branches), every aggregate function, ``__graft_entry__.entry``, and the q6 plan
against pyarrow.  The port's CPU tensors run the plain torch version of
the segmented-reduction kernel.

Tolerances: keys, counts, integer sums, min/max, first/last and nulls
exactly; float sums and averages to 1e-12 relative (sums taken in
another order round differently — on the CPU the port reproduces the
reference's order, so they usually agree bit for bit).
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.exec import tpu_aggregate as jagg
from spark_rapids_tpu.expr import ir as jir
from spark_rapids_tpu.expr.eval_tpu import ColVal as JColVal
from spark_rapids_tpu.plan.logical import Schema as JSchema

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar.interop import (batch_from_numpy,
                                                     batch_to_numpy)
from spark_rapids_tpu_torch.entry import collect, gen_store_sales, q6_plan
from spark_rapids_tpu_torch.exec import tpu_aggregate as tagg
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.expr.eval_tpu import ColVal as TColVal
from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.plan.logical import Schema as TSchema

from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-12


def jax_leaves(b) -> dict:
    def host(a):
        return None if a is None else np.asarray(a)
    return {"names": list(b.names), "num_rows": int(b.num_rows),
            "columns": [{"dtype": c.dtype.name, "data": host(c.data),
                         "validity": host(c.validity),
                         "lengths": host(c.lengths),
                         "elem_validity": host(c.elem_validity),
                         "vbits": c.vbits, "nonnull": bool(c.nonnull)}
                        for c in b.columns]}


def assert_live_equal(port: dict, ref: dict) -> None:
    """Same names, row count and hints; on the live rows the same
    validity and values (floats to REL), and zeroed padding."""
    assert port["names"] == ref["names"]
    n = ref["num_rows"]
    assert port["num_rows"] == n
    for cp, cr in zip(port["columns"], ref["columns"], strict=True):
        assert cp["dtype"] == cr["dtype"]
        assert (cp["vbits"], cp["nonnull"]) == (cr["vbits"], cr["nonnull"])
        assert np.array_equal(cp["validity"], cr["validity"])
        a, b = cp["data"][:n], cr["data"][:n]
        assert a.dtype == b.dtype
        v = cr["validity"][:n]
        if a.dtype.kind == "f":
            assert np.allclose(a[v], b[v], rtol=REL, atol=0, equal_nan=True)
        else:
            assert np.array_equal(a[v], b[v])
        assert not cp["data"][n:].any()


def _bind(ir, schema, e):
    return ir.bind(e, schema.names, schema.dtypes, schema.nullables)


# ---------------------------------------------------------------------------
# _group_ctx reductions (as tests/test_kernels.py holds xla vs pallas)
# ---------------------------------------------------------------------------

_REDUCTIONS = ["sum_f64", "sum_i64", "sum_i64_narrow", "count_all",
               "count_sub", "min_f64", "max_i64", "n_groups", "keys"]


def _ctx_case(kind):
    rng = np.random.default_rng(17)
    cap, n = 4096, 3700
    live = np.arange(cap) < n
    if kind == "wide_i64":     # no hint: multi-digit radix order
        keys = np.where(live, rng.integers(-(1 << 40), 1 << 40, cap)
                        % 23 * (1 << 35), 0).astype(np.int64)
        valid, vbits = np.ones(cap, bool), None
    else:                      # nullable narrow int32: one-digit sort
        keys = np.where(live, rng.integers(-50, 50, cap), 0).astype(
            np.int32)
        valid, vbits = live & (rng.random(cap) > 0.1), 16
    fvals = np.where(live, rng.uniform(-1e5, 1e5, cap), 0.0)
    ivals = np.where(live, rng.integers(-500, 500, cap), 0).astype(np.int64)
    return cap, n, keys, valid, vbits, fvals, ivals


def _reductions(ctx, ColVal, gather_keys, kv, f, iv, mask, sub, f64, i64):
    out = [ctx.seg_sum(f, mask, out_np=f64), ctx.seg_sum(iv, mask,
                                                         out_np=i64),
           ctx.seg_sum(iv, mask, out_np=i64, narrow_bits=10),
           ctx.seg_count(mask), ctx.seg_count(sub),
           ctx.seg_min_of(f, mask, np.inf),
           ctx.seg_max_of(iv, mask, int(np.iinfo(np.int64).min))]
    k = gather_keys([kv], ctx)[0]
    return out + [ctx.n_groups, k.data, k.validity]


def _ctx_inputs(cap, n, keys, valid, vbits, fvals, ivals):
    live = np.arange(cap) < n
    return [keys, valid, fvals, ivals, live, live & (ivals % 3 == 0)]


def _host_results(arrs):
    ng = int(arrs[7])
    res = [np.asarray(a)[:ng] for a in arrs[:7]] + [np.array([ng])]
    res.append(np.stack([np.asarray(arrs[8])[:ng].astype(np.int64),
                         np.asarray(arrs[9])[:ng].astype(np.int64)]))
    return res


@pytest.fixture(scope="module")
def ctx_results():
    out = {}
    for kind in ("wide_i64", "narrow_i32_nulls"):
        cap, n, keys, valid, vbits, fvals, ivals = case = _ctx_case(kind)
        kdt = "INT64" if keys.dtype == np.int64 else "INT32"

        def ref(k, v, f, iv, mask, sub):
            kv = JColVal(getattr(jdt, kdt), k, v, None, vbits=vbits)
            ctx = jagg._group_ctx([kv], cap, n, backend="xla")
            return _reductions(ctx, JColVal, jagg.gather_group_keys, kv, f,
                               iv, mask, sub, np.float64, np.int64)
        ins = _ctx_inputs(*case)
        jres = jax.jit(ref)(*[jnp.asarray(a) for a in ins])
        t = [torch.from_numpy(np.array(a)) for a in ins]
        kv = TColVal(getattr(tdt, kdt), t[0], t[1], None, vbits=vbits)
        ctx = tagg._group_ctx([kv], cap, n)
        tres = _reductions(ctx, TColVal, tagg.gather_group_keys, kv, *t[2:],
                           torch.float64, torch.int64)
        out[kind] = (_host_results(jres),
                     _host_results([a.numpy() for a in tres]))
    return out


@pytest.mark.parametrize("what", _REDUCTIONS)
@pytest.mark.parametrize("kind", ["wide_i64", "narrow_i32_nulls"])
def test_group_ctx_reductions(kind, what, ctx_results):
    ref, port = ctx_results[kind]
    i = _REDUCTIONS.index(what)
    a, b = port[i], ref[i]
    assert a.dtype == b.dtype, what
    if a.dtype.kind == "f":
        assert np.allclose(a, b, rtol=REL, atol=0), what
    else:
        assert np.array_equal(a, b), what


# ---------------------------------------------------------------------------
# q6: fused-filter update -> concat -> merge -> finalize, 3 partitions
# ---------------------------------------------------------------------------

def _q6_table(n=4096, seed=7) -> pa.Table:
    t = gen_store_sales(n, seed)
    rng = np.random.default_rng(seed)
    cols = {}
    for name in t.column_names:
        a = t[name].to_numpy()
        nulls = rng.random(n) < (0.03 if name == "ss_item_sk" else 0.05)
        if name == "ss_item_sk":       # few groups so partitions share keys
            a = a % 97
        cols[name] = pa.array(a, mask=nulls)
    return pa.table(cols)


def _q6_exprs(ir, schema, threshold):
    key = _bind(ir, schema, ir.UnresolvedAttribute("ss_item_sk"))
    aggs = [ir.Count(None),
            ir.Sum(_bind(ir, schema, ir.UnresolvedAttribute("ss_quantity"))),
            ir.Average(_bind(ir, schema,
                             ir.UnresolvedAttribute("ss_ext_sales_price")))]
    for a in aggs:
        a.resolve()
    cond = _bind(ir, schema, ir.GreaterThan(
        ir.UnresolvedAttribute("ss_sales_price"), ir.Literal(threshold)))
    return [key], aggs, cond


_SCENARIOS = {
    # selective filter, ladder off (cap 4096 is below its rung)
    "no_ladder": (150.0, None),
    # ladder engaged: ~25% survive -> the rung (small) branch
    "ladder_rung": (150.0, 256),
    # ladder engaged: ~95% survive -> the full-capacity branch
    "ladder_full": (10.0, 256),
}


@pytest.fixture(scope="module", params=list(_SCENARIOS))
def q6_run(request):
    threshold, min_rung = _SCENARIOS[request.param]
    mp = pytest.MonkeyPatch()
    if min_rung is not None:
        mp.setattr(jagg, "_LADDER_MIN_RUNG", min_rung)
        mp.setattr(tagg, "_LADDER_MIN_RUNG", min_rung)
    try:
        t = _q6_table()
        js, ts = JSchema.from_arrow(t.schema), TSchema.from_arrow(t.schema)
        jk, ja, jc = _q6_exprs(jir, js, threshold)
        tk, ta, tc = _q6_exprs(tir, ts, threshold)
        jspecs = [jagg.make_spec(a) for a in ja]
        tspecs = [tagg.make_spec(a) for a in ta]
        jparts, tparts, stages = [], [], {}
        jupdate = jax.jit(lambda b: jagg.update_aggregate(b, jk, ja, jspecs,
                                                          jc))
        for i, lo in enumerate(range(0, t.num_rows, 1366)):
            jb = jbatch.from_arrow(t.slice(lo, 1366))
            tb = batch_from_numpy(jax_leaves(jb), "cpu")
            jparts.append(jupdate(jb))
            tparts.append(tagg.update_aggregate(tb, tk, ta, tspecs, tc))
            stages[f"update{i}"] = (jparts[-1], tparts[-1])
        jm = jax.jit(lambda b: jagg.merge_aggregate(b, 1, jspecs))(
            jbatch.concat_batches(jparts))
        tm = tagg.merge_aggregate(tbatch.concat_batches(tparts), 1, tspecs)
        stages["merge"] = (jm, tm)
        names = ["ss_item_sk", "cnt", "qty", "aesp"]
        stages["final"] = (jax.jit(lambda b: jagg.finalize_aggregate(
            b, 1, jspecs, names))(jm),
                           tagg.finalize_aggregate(tm, 1, tspecs, names))
        yield stages
    finally:
        mp.undo()


@pytest.mark.parametrize("stage", ["update0", "update1", "update2", "merge",
                                   "final"])
def test_q6_update_merge_finalize(stage, q6_run):
    jb, tb = q6_run[stage]
    assert tb.capacity == jb.capacity
    assert_live_equal(batch_to_numpy(tb), jax_leaves(jb))


def test_q6_final_arrow_matches_reference(q6_run):
    jb, tb = q6_run["final"]
    ref, got = jbatch.to_arrow(jb), tbatch.to_arrow(tb)
    assert got.schema == ref.schema
    for name in ("ss_item_sk", "cnt", "qty"):
        assert got[name].to_pylist() == ref[name].to_pylist()
    assert np.allclose(got["aesp"].to_numpy(), ref["aesp"].to_numpy(),
                       rtol=REL, atol=0)


# ---------------------------------------------------------------------------
# every aggregate function: update + merge + finalize
# ---------------------------------------------------------------------------

_AGGS = ["count_x", "sum_x", "min_x", "max_x", "avg_x", "first_x",
         "last_x", "max_s", "first_s_ignore_nulls", "max_d", "min_b"]


def _all_aggs(ir, schema):
    def c(name):
        return _bind(ir, schema, ir.UnresolvedAttribute(name))
    aggs = [ir.Count(c("x")), ir.Sum(c("x")), ir.Min(c("x")), ir.Max(c("x")),
            ir.Average(c("x")), ir.First(c("x")), ir.Last(c("x")),
            ir.Max(c("s")), ir.First(c("s"), True),
            ir.Max(c("d")), ir.Min(c("b"))]
    for a in aggs:
        a.resolve()
    return [c("k")], aggs


@pytest.fixture(scope="module")
def all_aggs_run():
    rng = np.random.default_rng(23)
    n = 240
    words = np.array(["", "a", "ab", "b", "zz", "abc", "abé", "m"])
    d = rng.normal(0, 10, n)
    d[rng.random(n) < 0.05] = np.nan
    t = pa.table({
        "k": pa.array(rng.integers(0, 9, n), mask=rng.random(n) < 0.05),
        "x": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(words[rng.integers(0, len(words), n)],
                      mask=rng.random(n) < 0.1),
        "d": pa.array(d, mask=rng.random(n) < 0.05),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
    })
    js, ts = JSchema.from_arrow(t.schema), TSchema.from_arrow(t.schema)
    jk, ja = _all_aggs(jir, js)
    tk, ta = _all_aggs(tir, ts)
    jspecs = [jagg.make_spec(a) for a in ja]
    tspecs = [tagg.make_spec(a) for a in ta]
    jps, tps = [], []
    jupdate = jax.jit(lambda b: jagg.update_aggregate(b, jk, ja, jspecs))
    for lo in (0, 100):              # two overlapping slices of 140
        jb = jbatch.from_arrow(t.slice(lo, 140))
        tb = batch_from_numpy(jax_leaves(jb), "cpu")
        jps.append(jupdate(jb))
        tps.append(tagg.update_aggregate(tb, tk, ta, tspecs))
    names = ["k"] + _AGGS
    jout = jax.jit(lambda b: jagg.finalize_aggregate(jagg.merge_aggregate(
        b, 1, jspecs), 1, jspecs, names))(jbatch.concat_batches(jps))
    tout = tagg.finalize_aggregate(tagg.merge_aggregate(
        tbatch.concat_batches(tps), 1, tspecs), 1, tspecs, names)
    return jbatch.to_arrow(jout), tbatch.to_arrow(tout)


@pytest.mark.parametrize("name", ["k"] + _AGGS)
def test_every_aggregate_function(name, all_aggs_run):
    ref, got = all_aggs_run
    a, b = got[name].to_pylist(), ref[name].to_pylist()
    if name == "avg_x":
        assert [x is None for x in a] == [x is None for x in b]
        assert np.allclose([x for x in a if x is not None],
                           [x for x in b if x is not None], rtol=REL, atol=0)
    elif name == "min_b":
        # the reference's _append_buffers widens a BOOL buffer to int
        # (jnp.where(..., bool, 0)); the port keeps bool: same values
        assert [None if x is None else int(x) for x in a] == b
    else:
        assert [str(x) for x in a] == [str(x) for x in b]


# ---------------------------------------------------------------------------
# __graft_entry__.entry and the q6 plan
# ---------------------------------------------------------------------------

def test_entry_matches_graft_entry():
    import __graft_entry__ as graft
    from spark_rapids_tpu_torch.entry import entry
    jfn, jargs = graft.entry()
    ref = jbatch.to_arrow(jax.jit(jfn)(*jargs))
    step, (batch,) = entry(device="cpu")
    got = tbatch.to_arrow(step(batch))
    assert got.column_names == ref.column_names
    for name in ("k", "cnt", "qty_sum"):
        assert got[name].to_pylist() == ref[name].to_pylist()
    assert np.allclose(got["price_avg"].to_numpy(),
                       ref["price_avg"].to_numpy(), rtol=REL, atol=0)


def test_entry_defaults_to_cuda():
    from spark_rapids_tpu_torch.entry import entry
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


@pytest.mark.parametrize("parts,batch_rows", [(1, 1 << 20), (3, 700),
                                              (8, 300)])
def test_q6_plan_matches_pyarrow(parts, batch_rows):
    t = gen_store_sales(5000, seed=parts)
    kb.reset_counts()
    got = collect(q6_plan(t, partitions=parts, device="cpu",
                          max_batch_rows=batch_rows)).sort_by("ss_item_sk")
    assert kb.fallbacks == {}      # every reduction reached segreduce
    f = t.filter(pc.greater(t["ss_sales_price"], 150.0))
    ref = f.group_by("ss_item_sk").aggregate(
        [("ss_item_sk", "count"), ("ss_quantity", "sum"),
         ("ss_ext_sales_price", "mean")]).sort_by("ss_item_sk")
    assert got["ss_item_sk"].to_pylist() == ref["ss_item_sk"].to_pylist()
    assert got["cnt"].to_pylist() == ref["ss_item_sk_count"].to_pylist()
    assert got["qty"].to_pylist() == ref["ss_quantity_sum"].to_pylist()
    assert np.allclose(got["aesp"].to_numpy(),
                       ref["ss_ext_sales_price_mean"].to_numpy(),
                       rtol=1e-9, atol=0)


def test_two_d_payload_counts_a_fallback():
    """A 2-D payload takes the plain composition where the reference takes
    XLA, and the choice is counted with its reason."""
    kb.reset_counts()
    cap = 64
    kv = TColVal(tdt.INT64, torch.arange(cap) % 5, torch.ones(cap,
                                                             dtype=bool))
    ctx = tagg._group_ctx([kv], cap, cap)
    assert ctx._kernel_op(torch.minimum, torch.uint8, 2) is None
    assert ctx._kernel_op(torch.minimum, torch.int64, 1) == "min"
    assert kb.fallbacks == {"agg.segreduce.ndim": 1}
    assert kb.launches == {}
