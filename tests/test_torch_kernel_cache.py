"""The port's kernel cache (exec/kernel_cache.py) against the reference's.

- ``expr_sig`` of the same DataFrame expressions, planned by a reference
  session and a port session, are equal (``plan/digest`` builds on it);
- the per-family ``kernel.cache.misses`` / ``kernel.dispatches`` deltas
  of a q6-class aggregate, a broadcast join, a sort, q6 over Parquet
  files and a hash repartition, after clearing both caches, are the
  reference's, the download pack, the partial concat, the fused
  reader's decode and the exchange's steps included;
- the OOM retry: ``tests/test_memory.py::test_hbm_oom_recover_spills_
  and_retries`` with a constructed ``torch.cuda.OutOfMemoryError`` as
  well as the reference's ``RESOURCE_EXHAUSTED`` message, a non-OOM
  error raised once, and a session query whose ``agg_update`` dispatch
  runs out of memory once;
- ``tests/test_fusion.py``'s dispatch-count and aliased-projection
  gates on the port;
- the cached steps pin no plan and no batch.
"""

import functools
import gc
import weakref

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import lit as jlit
from spark_rapids_tpu.exec import kernel_cache as jkc
from spark_rapids_tpu.obs import registry as jreg

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api import lit as tlit
from spark_rapids_tpu_torch.columnar.batch import from_arrow
from spark_rapids_tpu_torch.exec import kernel_cache as tkc
from spark_rapids_tpu_torch.exec import tpu_aggregate as tagg
from spark_rapids_tpu_torch.mem import spill as tspill
from spark_rapids_tpu_torch.obs import registry as treg

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
SIDES = {"ref": (JSession, jcol, JF, jkc, jreg),
         "port": (TSession, tcol, TF, tkc, treg)}
LITS = {JF: jlit, TF: tlit}
EXPR_ATTRS = ("exprs", "out_exprs", "condition", "fused_condition",
              "groupings", "aggregates")


def _table(n: int = 400, seed: int = 3) -> pa.Table:
    rng = np.random.default_rng(seed)
    words = np.array(["alpha", "beta", "gamma", "delta", "eps", "zeta"])
    return pa.table({
        "ss_item_sk": pa.array(rng.integers(0, 40, n).astype(np.int64)),
        "ss_quantity": pa.array(rng.integers(1, 100, n).astype(np.int32)),
        "ss_sales_price": pa.array(rng.uniform(0, 300, n)),
        "ss_ext_sales_price": pa.array(rng.uniform(0, 900, n)),
        "s": pa.array(words[rng.integers(0, len(words), n)]),
    })


def _dim() -> pa.Table:
    return pa.table({"ss_item_sk": np.arange(40, dtype=np.int64),
                     "name": [f"n{i}" for i in range(40)]})


def _nodes(plan):
    out, stack = [], [plan]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(reversed(list(n.children)))
    return out


def _plan_exprs(session, df) -> list:
    """Every expression the physical plan holds, node by node."""
    out = []
    for n in _nodes(session._plan_physical(df.plan).plan):
        for attr in EXPR_ATTRS:
            v = getattr(n, attr, None)
            if v is None:
                continue
            out.extend(v if isinstance(v, (list, tuple)) else [v])
    return out


def _sig_query(s, col, F, t):
    lit = LITS[F]
    df = s.create_dataframe(t)
    return df.filter((col("ss_quantity") > 3) & col("s").is_not_null()) \
        .select(
            (col("ss_quantity") + 1).alias("e0"),
            (col("ss_sales_price") * 2.5 - col("ss_ext_sales_price"))
            .alias("e1"),
            (col("ss_quantity") % 7).alias("e2"),
            col("ss_sales_price").cast("int").alias("e3"),
            col("ss_quantity").cast("double").alias("e4"),
            F.when(col("ss_quantity") > 50, 1).otherwise(0).alias("e5"),
            F.coalesce(col("s"), lit("x")).alias("e6"),
            col("ss_item_sk").isin(1, 2, 3).alias("e7"),
            col("s").like("%a%").alias("e8"),
            col("s").startswith("al").alias("e9"),
            F.upper(col("s")).alias("e10"),
            F.length(col("s")).alias("e11"),
            F.substring(col("s"), 2, 3).alias("e12"),
            F.concat(col("s"), col("s")).alias("e13"),
            F.abs(col("ss_sales_price") - 150.0).alias("e14"),
            F.sqrt(col("ss_sales_price")).alias("e15"),
            (col("ss_quantity") / 3).alias("e16"),
            F.isnull(col("s")).alias("e17"),
            (~(col("ss_quantity") < 10)).alias("e18"),
            F.pmod(col("ss_item_sk"), lit(5)).alias("e19"),
            F.hash(col("ss_item_sk")).alias("e20"),
            F.lpad(col("s"), 8, "*").alias("e21"),
            (col("ss_item_sk") == col("ss_quantity")).alias("e22"),
            F.md5(col("s")).alias("e23"))


def _agg_query(s, col, F, t):
    return (s.create_dataframe(t).group_by("ss_item_sk", "s")
            .agg(F.count("*").alias("c"), F.sum("ss_quantity").alias("q"),
                 F.avg("ss_sales_price").alias("a"),
                 F.min("ss_ext_sales_price").alias("mn"),
                 F.max("s").alias("mx"), F.first("ss_quantity").alias("f")))


@pytest.mark.parametrize("build", [_sig_query, _agg_query],
                         ids=["project", "aggregate"])
def test_expr_sig_equals_reference(build):
    t = _table(64)
    sigs = {}
    for side, (Session, col, F, kc, _reg) in SIDES.items():
        s = Session(dict(CONF, **{
            "spark.rapids.tpu.sql.fusion.enabled": False}),
            **({"device": "cpu"} if side == "port" else {}))
        exprs = _plan_exprs(s, build(s, col, F, t))
        sigs[side] = [kc.expr_sig(e) for e in exprs]
        assert kc.exprs_sig(exprs) == tuple(sigs[side])
    assert len(sigs["port"]) >= (20 if build is _sig_query else 6)
    assert sigs["port"] == sigs["ref"]


# ---------------------------------------------------------------------------
# per-family counts against the reference
# ---------------------------------------------------------------------------

def _q6(s, col, F, t, dim, root=None):
    return (s.create_dataframe(t, num_partitions=2)
            .filter(col("ss_sales_price") > 150.0).group_by("ss_item_sk")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_quantity").alias("qty"),
                 F.avg("ss_ext_sales_price").alias("aesp")))


def _join(s, col, F, t, dim, root=None):
    return (s.create_dataframe(t, num_partitions=2)
            .join(s.create_dataframe(dim), on="ss_item_sk")
            .select("ss_item_sk", "name", "ss_quantity"))


def _sort(s, col, F, t, dim, root=None):
    return (s.create_dataframe(t, num_partitions=2)
            .sort(col("ss_quantity").desc(), col("ss_item_sk"))
            .select("ss_item_sk", "ss_quantity"))


def _q6_parquet(s, col, F, t, dim, root=None):
    """q6 over Parquet files: the fused reader's decode step."""
    return (s.read.parquet(root)
            .filter(col("ss_sales_price") > 150.0).group_by("ss_item_sk")
            .agg(F.count("*").alias("cnt"),
                 F.sum("ss_quantity").alias("qty")))


def _repartition(s, col, F, t, dim, root=None):
    """A hash exchange (the exchange's target, apply and slice steps)."""
    return (s.create_dataframe(t, num_partitions=2)
            .repartition(3, "ss_item_sk").group_by("ss_item_sk")
            .agg(F.sum("ss_quantity").alias("qty")))


COUNT_QUERIES = {"q6": _q6, "join": _join, "sort": _sort,
                 "q6_parquet": _q6_parquet, "repartition": _repartition}
COUNT_PREFIXES = ("kernel.cache.misses.", "kernel.dispatches.")


@pytest.fixture(scope="module")
def family_counts(tmp_path_factory):
    """Per side and query: the kernel.cache.misses.* / kernel.dispatches.*
    deltas of one collect after clearing the side's kernel cache, and
    the rows.  The xla backend keeps the reference's compiles short; one
    task thread keeps two partitions from racing to build one key (a
    race both caches allow: the build runs outside the lock)."""
    t, dim = _table(), _dim()
    root = tmp_path_factory.mktemp("kc_parquet")
    for i in range(2):
        papq.write_table(t.slice(200 * i, 200),
                         str(root / f"part-{i}.parquet"))
    conf = dict(CONF, **{"spark.rapids.tpu.kernel.backend": "xla",
                         "spark.rapids.tpu.sql.concurrentTpuTasks": 1,
                         "spark.rapids.tpu.sql.adaptive.enabled": False})
    out = {}
    for side, (Session, col, F, kc, reg) in SIDES.items():
        s = Session(conf, **({"device": "cpu"} if side == "port" else {}))
        for name, q in COUNT_QUERIES.items():
            kc.clear()
            view = reg.get_registry().view()
            rows = q(s, col, F, t, dim, root=str(root)).collect()
            d = view.delta()["counters"]
            out[side, name] = ({k: v for k, v in d.items()
                                if k.startswith(COUNT_PREFIXES)}, rows)
    return out


def test_family_counts_equal_reference_at_default_adaptive():
    """A shuffled join with no adaptive key: both packages read its
    exchanges through the adaptive readers, and each family's misses and
    dispatches (the exchange's ``exch_*`` steps and the readers'
    ``exch_slice``) equal the reference's."""
    t, dim = _table(), _dim()
    conf = dict(CONF, **{"spark.rapids.tpu.kernel.backend": "xla",
                         "spark.rapids.tpu.sql.concurrentTpuTasks": 1,
                         "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                             -1})
    out = {}
    for side, (Session, col, F, kc, reg) in SIDES.items():
        s = Session(conf, **({"device": "cpu"} if side == "port" else {}))
        df = _join(s, col, F, t, dim)
        names = [type(n).__name__
                 for n in _nodes(s._plan_physical(df.plan).plan)]
        assert names.count("TpuAdaptiveJoinReaderExec") == 2, (side, names)
        kc.clear()
        view = reg.get_registry().view()
        rows = df.collect()
        d = view.delta()["counters"]
        out[side] = ({k: v for k, v in d.items()
                      if k.startswith(COUNT_PREFIXES)}, rows)
    assert_tables_equal(out["ref"][1], out["port"][1], ignore_order=True)
    assert out["port"][0] == out["ref"][0]
    assert out["port"][0].get("kernel.dispatches.exch_apply", 0) >= 2


def _family_of(counter: str) -> str:
    return counter.split(".")[3 if counter.startswith("kernel.cache")
                              else 2]


@pytest.mark.parametrize("name", list(COUNT_QUERIES))
def test_family_counts_equal_reference(family_counts, name):
    (ref, ref_rows), (port, port_rows) = family_counts["ref", name], \
        family_counts["port", name]
    assert_tables_equal(ref_rows, port_rows, ignore_order=True)
    assert port == ref
    assert port, "the query dispatched nothing"


ROUTED = ("pack_batch", "concat_nosync", "pq_fused6", "exch_target",
          "exch_apply", "exch_slice")


def test_unrouted_families_pinned(family_counts):
    """The families the port once left as plain torch (the terminal
    download's pack and the aggregate's concat of partials,
    columnar/batch.py; the fused reader's decode; the exchange's steps)
    are kernel-cache dispatches with the reference's counts on every
    query; none is left unrouted."""
    for q in COUNT_QUERIES:
        ref, port = family_counts["ref", q][0], family_counts["port", q][0]
        for fam in ROUTED:
            for prefix in COUNT_PREFIXES:
                assert port.get(prefix + fam) == ref.get(prefix + fam), \
                    (q, prefix + fam)
        assert port["kernel.dispatches.pack_batch"] >= 1, q
    port_q6 = family_counts["port", "q6"][0]
    assert port_q6["kernel.dispatches.concat_nosync"] == 1
    assert port_q6["kernel.cache.misses.pack_batch"] == 1
    assert family_counts["port", "q6_parquet"][0][
        "kernel.dispatches.pq_fused6.xla"] >= 1
    part = family_counts["port", "repartition"][0]
    for fam in ("exch_target", "exch_apply", "exch_slice"):
        assert part[f"kernel.dispatches.{fam}"] >= 1, fam
    # the aggregate's steps carry the plan's backend tag
    assert port_q6["kernel.dispatches.agg_update.xla"] == 2
    assert port_q6["kernel.dispatches.agg_merge.xla"] == 1


# ---------------------------------------------------------------------------
# the OOM retry
# ---------------------------------------------------------------------------

def _oom_errors():
    return [torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB "
                "(constructed)"),
            RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying "
                         "to allocate 123 bytes (simulated)")]


@pytest.mark.parametrize("error", _oom_errors(), ids=["torch", "xla"])
def test_hbm_oom_recover_spills_and_retries(error):
    """``tests/test_memory.py:341``: an out-of-memory error from a cached
    step evicts the whole device tier and retries once; a non-OOM error
    is raised without a retry."""
    tspill.init_catalog(1 << 30, 1 << 30, device="cpu")
    cat = tspill.get_catalog()
    before = cat.spilled_device_bytes
    batch = from_arrow(pa.table({"v": list(range(256))}), device="cpu")
    handle = cat.register(batch)
    assert cat.device_bytes > 0
    reg = treg.get_registry()
    retries = reg.counter("mem.oomRetries")
    calls = {"n": 0}

    def flaky_impl(b):
        calls["n"] += 1
        if calls["n"] == 1:
            raise error
        c = b.columns[0]
        return int(torch.where(c.validity, c.data, 0).sum())

    k = tkc.get_kernel(("oom_recovery_probe", id(flaky_impl)),
                       lambda: flaky_impl)
    assert k(batch) == sum(range(256))
    assert calls["n"] == 2, calls                  # failed, then retried
    assert cat.spilled_device_bytes > before
    assert reg.counter("mem.oomRetries") == retries + 1
    assert handle.tier == tspill.StorageTier.HOST
    assert int(handle.get().num_rows) == 256      # rematerializes
    handle.close()

    calls2 = {"n": 0}

    def always_bad(b):
        calls2["n"] += 1
        raise ValueError("unrelated failure")

    k2 = tkc.get_kernel(("oom_recovery_probe2", id(always_bad)),
                        lambda: always_bad)
    with pytest.raises(ValueError):
        k2(batch)
    assert calls2["n"] == 1, calls2


def test_no_retry_without_the_wrapper():
    """A step registered with ``oom_retry=False`` (one that writes into
    its arguments) raises its OOM at once."""
    calls = {"n": 0}

    def writes_in_place(x):
        calls["n"] += 1
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    k = tkc.get_kernel(("oom_no_retry", id(writes_in_place)),
                       lambda: writes_in_place, oom_retry=False)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        k(torch.zeros(4))
    assert calls["n"] == 1


def test_session_query_oom_retries_agg_update(monkeypatch):
    """A port query whose ``agg_update`` dispatch runs out of memory once
    returns the reference's rows after one spill and retry, and leaves
    a registered batch spilled."""
    t, dim = _table(), _dim()
    ref = _q6(JSession(dict(CONF, **{
        "spark.rapids.tpu.sql.enabled": False})), jcol, JF, t,
        dim).collect()
    # a budget far above the query's estimate, as on the card: at the
    # CPU's 8 GiB the admission's pressure hook spills the held batch
    # before the query starts, and the OOM would find nothing to free
    s = TSession(dict(CONF, **{"spark.rapids.tpu.sched.memoryBudget":
                               64 << 30}), device="cpu")
    held = tspill.get_catalog().register(
        from_arrow(pa.table({"v": list(range(512))}), device="cpu"))
    real = tagg.update_aggregate
    calls = {"n": 0}

    def once_oom(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 1.00 GiB")
        return real(*args, **kwargs)
    monkeypatch.setattr(tagg, "update_aggregate", once_oom)
    reg = treg.get_registry()
    view = reg.view()
    out = _q6(s, tcol, TF, t, dim).collect()
    d = view.delta()["counters"]
    assert_tables_equal(ref, out, ignore_order=True)
    assert d.get("mem.oomRetries", 0) == 1
    assert d.get("kernel.oomRetries.agg_update", 0) == 1
    assert d.get("kernel.dispatches.agg_update.pallas", 0) == 2
    assert held.tier == tspill.StorageTier.HOST
    held.close()


# ---------------------------------------------------------------------------
# tests/test_fusion.py's dispatch accounting on the port
# ---------------------------------------------------------------------------

def _fusion_session(fused: bool) -> TSession:
    return TSession(dict(CONF, **{
        "spark.rapids.tpu.sql.fusion.enabled": fused}), device="cpu")


def _fusion_data(s, num_partitions=2):
    return s.create_dataframe(
        {"a": [1, None, 3, 4, None, 6, 7, 8],
         "b": [10.0, 20.0, None, 40.0, 50.0, 60.0, None, 80.0],
         "s": ["ab", "cd", None, "ef", "gh", None, "ij", "kl"],
         "k": [0, 1, 0, 1, 0, 1, 0, 1]},
        num_partitions=num_partitions)


def test_dispatch_count_drops_with_fusion():
    def build(df):
        return (df.with_column("d", tcol("a") + tcol("b"))
                  .filter(tcol("d") > 15.0)
                  .with_column("e", tcol("d") - tcol("k"))
                  .select("e", "k"))
    counts = {}
    for fused in (True, False):
        s = _fusion_session(fused)
        build(_fusion_data(s)).collect()  # warm
        view = treg.get_registry().view()
        build(_fusion_data(s)).collect()
        d = view.delta()["counters"]
        counts[fused] = d.get("kernel.dispatches", 0)
        if fused:
            assert d.get("fusion.dispatchesSaved", 0) > 0
    assert counts[True] < counts[False]
    assert 1 - counts[True] / counts[False] >= 0.30


def test_aliased_projections_share_one_kernel():
    s = _fusion_session(False)  # raw TpuProjectExec path
    df = _fusion_data(s)
    df.select((tcol("a") + tcol("b")).alias("x")).collect()
    view = treg.get_registry().view()
    out = df.select((tcol("a") + tcol("b")).alias("y")).collect()
    d = view.delta()["counters"]
    assert d.get("kernel.cache.misses.project", 0) == 0
    assert d.get("kernel.cache.hits.project", 0) >= 1
    assert out.column_names == ["y"]


# ---------------------------------------------------------------------------
# the cache pins nothing of a query
# ---------------------------------------------------------------------------

def test_cached_steps_pin_no_plan_or_batch(monkeypatch):
    t, dim = _table(), _dim()
    s = TSession(dict(CONF, **{"spark.rapids.tpu.obs.profile.enabled":
                               False}), device="cpu")
    refs = []
    s.add_plan_listener(lambda r: refs.extend(
        weakref.ref(n) for n in _nodes(r.plan)))
    real = tagg.update_aggregate

    def watched(batch, *args, **kwargs):
        out = real(batch, *args, **kwargs)
        refs.extend((weakref.ref(batch), weakref.ref(out)))
        return out
    monkeypatch.setattr(tagg, "update_aggregate", watched)
    for q in (_q6, _join, _sort):
        q(s, tcol, TF, t, dim).collect()
    assert len(refs) > 10
    gc.collect()
    alive = [r() for r in refs if r() is not None]
    assert alive == []


def test_lru_bound_and_hit_counters():
    view = treg.get_registry().view()
    fam = "lru_probe"
    first = tkc.get_kernel((fam, 0), lambda: functools.partial(abs))
    assert tkc.get_kernel((fam, 0), lambda: None) is first
    for i in range(1, tkc._MAX_ENTRIES + 1):
        tkc.get_kernel((fam, i), lambda: abs)
    d = view.delta()["counters"]
    assert d["kernel.cache.misses." + fam] == tkc._MAX_ENTRIES + 1
    assert d["kernel.cache.hits." + fam] == 1
    assert d["kernel.cache.memHits"] >= 1
    assert (fam, 0) not in tkc._CACHE and len(tkc._CACHE) <= \
        tkc._MAX_ENTRIES
    tkc.clear()
