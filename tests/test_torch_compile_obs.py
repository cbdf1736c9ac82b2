"""The port's compile observatory (obs/compile.py) against the
reference's.

``tests/test_compile_obs.py``'s gates on the port: the ring bound, the
disabled path, re-enabling, concurrent attribution, the tiers (the
``kernels/_build`` counters faked around a first call), the corpus round
trip, the churn order and bucketing, the storm once per query, the
profile's compile section and span, the slow-query fields.  The same
``record_compile`` sequences go through both packages' ledgers and give
equal ``churn_report()`` / ``totals()`` / per-query stats.
"""

import json
import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.obs import compile as jcompile
from spark_rapids_tpu.sched import cancel as jcancel

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.exec import kernel_cache as kc
from spark_rapids_tpu_torch.kernels import _build
from spark_rapids_tpu_torch.obs import compile as obscompile
from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.plan.digest import plan_digest
from spark_rapids_tpu_torch.sched import cancel as sched_cancel

from tests.torch_threads import one_torch_thread  # noqa: F401

MODS = {"ref": (jcompile, jcancel), "port": (obscompile, sched_cancel)}
_LEAVES = ((((4096,), "int64")), (((4096,), "float64")))


@pytest.fixture(autouse=True)
def _fresh_ledger():
    for mod, _c in MODS.values():
        mod.reset()
        mod.configure(True)
    yield
    for mod, _c in MODS.values():
        mod.reset()
        mod.configure(True)


def _fake_compile(mod, key, family="fam", backend="xla", leaves=_LEAVES,
                  dur_ns=1_000_000, tier="fresh"):
    mod.record_compile(key=key, family=family, backend=backend,
                       leaves=leaves, t0_ns=0, dur_ns=dur_ns, tier=tier)


def _df(s, n=300):
    return s.create_dataframe(
        {"k": [i % 7 for i in range(n)],
         "x": [float(i % 100) for i in range(n)]})


def _session(extra=None) -> TSession:
    conf = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    conf.update(extra or {})
    return TSession(conf, device="cpu")


# ---------------------------------------------------------------------------
# ledger mechanics, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", list(MODS))
def test_ledger_ring_bound(side):
    mod = MODS[side][0]
    mod.configure(True, ring_events=16)
    for i in range(40):
        _fake_compile(mod, ("fam", i))
    assert len(mod.events()) == 16
    assert mod.events(max_events=0) == []
    assert len(mod.events(max_events=4)) == 4
    t = mod.totals()
    assert t["events"] == 40 and t["fresh"] == 40
    rows = mod.churn_report()
    assert rows[0]["family"] == "fam"
    assert rows[0]["distinct_signatures"] == 40


def _sequence(mod, cancel):
    """One mixed sequence: families with shape churn, both tiers, two
    registered queries, token-less compiles."""
    mod.register_query(31, "digest-31")
    mod.register_query(32, None)
    for fam, n in (("famC", 8), ("famA", 5), ("famB", 2)):
        for i in range(n):
            cap = 1000 + i
            _fake_compile(mod, ("k", fam, cap), family=fam,
                          leaves=((((cap,), "int64")),),
                          dur_ns=1_000 * (i + 1))
    with cancel.install(cancel.CancelToken(31)):
        for i in range(4):
            _fake_compile(mod, ("q31", i, 4096), family="agg_update",
                          tier="persistent" if i % 2 else "fresh",
                          dur_ns=2_000_000 + i)
    with cancel.install(cancel.CancelToken(32)):
        _fake_compile(mod, ("q32", 1), family="sort_keys", backend="pallas")
    _fake_compile(mod, ("k", 900), family="fx",
                  leaves=((((900,), "int64")),))
    _fake_compile(mod, ("k", 901), family="fx",
                  leaves=((((901,), "float64")),))
    mod.finish_query(31)
    mod.finish_query(32)


def test_same_sequence_same_reports():
    out = {}
    for side, (mod, cancel) in MODS.items():
        _sequence(mod, cancel)
        snap = mod.snapshot(max_events=0)
        out[side] = (mod.churn_report(), mod.totals(), mod.query_stats(31),
                     mod.query_stats(32), mod.row_fields(31),
                     snap["per_query"])
    assert out["port"] == out["ref"]
    churn, totals = out["port"][0], out["port"][1]
    assert [r["family"] for r in churn][:5] == ["famC", "famA",
                                                "agg_update", "fx", "famB"]
    assert churn[0]["est_programs_width_bucketed"] == 1
    assert churn[0]["est_collapse_savings"] == 7
    fx = [r for r in churn if r["family"] == "fx"][0]
    assert fx["distinct_signatures"] == 2
    assert fx["est_programs_width_bucketed"] == 2   # int vs float class
    assert totals["persistent"] == 2
    assert totals["unattributed_fresh"] == 17


@pytest.mark.parametrize("side", list(MODS))
def test_storm_fires_once_per_query(side, tmp_path):
    mod, cancel = MODS[side]
    rec = __import__(mod.__name__.rsplit(".", 1)[0] + ".recorder",
                     fromlist=["recorder"])
    reg = __import__(mod.__name__.rsplit(".", 1)[0] + ".registry",
                     fromlist=["registry"])
    mod.configure(True, storm_threshold=3)
    rec.configure(str(tmp_path))
    try:
        mod.register_query(901, "digest-901")
        with cancel.install(cancel.CancelToken(901)):
            for i in range(6):
                _fake_compile(mod, ("s", i))
        mod.register_query(902, "digest-902")
        with cancel.install(cancel.CancelToken(902)):
            for i in range(5):
                _fake_compile(mod, ("s2", i))
        storms = [e for e in rec.get_recorder().events()
                  if e["kind"] == "compile.storm"]
        assert [e["query"] for e in storms] == [901, 902]
        assert all(e["threshold"] == 3 for e in storms)
        assert storms[0]["plan_digest"] == "digest-901"
        assert mod.query_stats(901)["storm"] is True
        assert reg.get_registry().counter("kernel.compile.storms") >= 2
    finally:
        rec.disable()


def test_corpus_jsonl_roundtrip(tmp_path):
    """A registered digest's first completion appends one record whose
    programs carry ``replay: null``; a repeat of the digest appends
    nothing.  A session query carries its plan digest (the query
    service's, plan/digest.py), so its first run writes one record under
    that digest and a repeat writes none."""
    corpus = tmp_path / "corpus.jsonl"
    obscompile.configure(True, corpus_path=str(corpus))
    for qid in (41, 42):
        obscompile.register_query(qid, "digest-a")
        with sched_cancel.install(sched_cancel.CancelToken(qid)):
            _fake_compile(obscompile, ("agg_update", qid),
                          family="agg_update")
        obscompile.finish_query(qid)
    lines = [json.loads(x) for x in corpus.read_text().splitlines()]
    assert len(lines) == 1
    rec = lines[0]
    assert rec["plan_digest"] == "digest-a" and rec["query_id"] == 41
    assert rec["programs"] == [{
        "family": "agg_update", "key": repr(("agg_update", 41)),
        "signature": "int64[4096];float64[4096]", "backend": "xla",
        "replay": None}]
    kc.clear()
    s = _session({"spark.rapids.tpu.obs.compile.corpusPath":
                  str(tmp_path / "session.jsonl")})
    q = _df(s).group_by("k").agg(F.sum("x").alias("sx"))
    q.collect()
    assert obscompile.totals()["events"] > 1
    q.collect()
    lines = [json.loads(x) for x in
             (tmp_path / "session.jsonl").read_text().splitlines()]
    assert [r["plan_digest"] for r in lines] == [plan_digest(q.plan)]
    assert lines[0]["programs"] and all(
        p["replay"] is None for p in lines[0]["programs"])


def test_threaded_ledger_consistency():
    def spin(tid):
        for i in range(50):
            _fake_compile(obscompile, ("t", tid, i), family=f"thr{tid}")
    threads = [threading.Thread(target=spin, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert obscompile.totals()["events"] == 200
    rows = {r["family"]: r for r in obscompile.churn_report()}
    assert all(rows[f"thr{t}"]["distinct_signatures"] == 50
               for t in range(4))


# ---------------------------------------------------------------------------
# the kernel cache's observe wrapper
# ---------------------------------------------------------------------------

def test_disabled_path_noop():
    obscompile.configure(False)
    _fake_compile(obscompile, ("fam", 1))
    assert obscompile.events() == []
    view = obsreg.get_registry().view()
    fn = kc.get_kernel(("tobs_disabled", 1), lambda: (lambda x: x + 1))
    fn(torch.arange(64))
    d = view.delta()["counters"]
    assert obscompile.events() == []
    assert not any(k.startswith("kernel.compile.") or
                   k in ("kernel.cache.compiles",
                         "kernel.cache.persistentHits") for k in d), d
    assert obscompile.totals()["events"] == 0


def test_reenable_does_not_fake_fresh_compiles():
    obscompile.configure(False)
    fn = kc.get_kernel(("tobs_toggle", 1), lambda: (lambda x: x - 1))
    fn(torch.arange(32))
    obscompile.configure(True)
    fn(torch.arange(32))
    assert obscompile.totals()["events"] == 0
    fn2 = kc.get_kernel(("tobs_toggle", 2), lambda: (lambda x: x - 2))
    fn2(torch.arange(32))                     # recorded
    obscompile.configure(False)
    fn2(torch.arange(64))                     # first call, not recorded
    obscompile.configure(True)
    fn2(torch.arange(64))                     # seen: no bogus event
    assert obscompile.totals()["events"] == 1


def test_observed_first_calls_via_get_kernel():
    view = obsreg.get_registry().view()
    fn = kc.get_kernel(("tobs_real", 7), lambda: (lambda x, n: x * n))
    fn(torch.arange(128), 2)        # first (key, shape): one event
    fn(torch.arange(128), 3)        # a host scalar's value: no event
    fn(torch.arange(256), 2)        # new shape: second event
    fn(torch.arange(256).float(), 2)   # new dtype: third event
    d = view.delta()["counters"]
    assert d.get("kernel.compile.events", 0) == 3
    assert d.get("kernel.cache.compiles", 0) == 3
    evs = [e for e in obscompile.events() if e["family"] == "tobs_real"]
    assert [e["signature"] for e in evs] == [
        "int64[128];int64[]", "int64[256];int64[]",
        "float32[256];int64[]"]
    assert all(e["wall_ms"] >= 0 and e["backend"] == "xla" for e in evs)


def _fake_build(kind):
    """A step that, on its first call, bumps this thread's build
    counters as an nvcc build (``fresh``) or a reload of a library an
    earlier process built (``persistent``) would."""
    def step(x):
        if kind == "fresh":
            _build._thread_tally()[0] += 1
        elif kind == "persistent":
            _build._thread_tally()[1] += 1
        return x + 1
    return step


@pytest.mark.parametrize("kind,tier,counter", [
    ("fresh", "fresh", "kernel.cache.compiles"),
    ("persistent", "persistent", "kernel.cache.persistentHits"),
    ("none", "fresh", "kernel.cache.compiles")])
def test_tiers_from_build_counters(kind, tier, counter):
    view = obsreg.get_registry().view()
    fn = kc.get_kernel(("tobs_tier", kind), lambda: _fake_build(kind))
    fn(torch.zeros(8))
    fn(torch.zeros(8))
    d = view.delta()["counters"]
    assert d.get(counter, 0) == 1
    assert [e["tier"] for e in obscompile.events()
            if e["family"] == "tobs_tier"] == [tier]


def test_builds_on_other_threads_do_not_bleed():
    fn = kc.get_kernel(("tobs_bleed", 1), lambda: (lambda x: x))
    t = threading.Thread(target=lambda: _build._thread_tally().__setitem__(
        0, _build._thread_tally()[0] + 5))
    probe = obscompile.probe_begin()
    t.start()
    t.join()
    assert obscompile.classify_tier(probe) == "fresh"
    fn(torch.zeros(2))
    assert [e["tier"] for e in obscompile.events()
            if e["family"] == "tobs_bleed"] == ["fresh"]


# ---------------------------------------------------------------------------
# query attribution and the surfaces
# ---------------------------------------------------------------------------

def test_concurrent_attribution_no_cross():
    kc.clear()
    s = _session()
    q1 = (_df(s).with_column("y", col("x") * 3.0 - 1.0)
          .filter(col("y") > 30.0).group_by("k")
          .agg(F.count("*").alias("c"), F.sum("y").alias("sy")))
    q2 = _df(s).select("x", "k").sort("x", "k").limit(40)
    qids, errors = {}, []

    def run(name, q):
        try:
            q.collect()
            qids[name] = s.last_query_profile().query_id
        except Exception as e:          # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=run, args=item)
               for item in (("q1", q1), ("q2", q2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    # the profile ring keys every query: take the ids from the events
    evs = [e for e in obscompile.events() if e["query_id"] is not None]
    families = {}
    for e in evs:
        families.setdefault(e["query_id"], set()).add(e["family"])
    assert len(families) == 2, families
    by_kind = sorted(families.values(), key=lambda f: "agg_update" in f)
    assert "sort_keys" in by_kind[0] and "agg_update" not in by_kind[0]
    assert "agg_update" in by_kind[1] and "sort_keys" not in by_kind[1]
    for qid, fams in families.items():
        st = obscompile.query_stats(qid)
        n = sum(1 for e in evs if e["query_id"] == qid)
        assert st["kernels_compiled"] + st["persistent_reloads"] == n


def test_warm_run_records_nothing_and_identity_holds():
    kc.clear()
    s = _session()
    q = (_df(s).filter(col("x") > 40.0).group_by("k")
         .agg(F.sum("x").alias("sx"), F.count("*").alias("c")))
    view = obsreg.get_registry().view()
    q.collect()
    d1 = view.delta()["counters"]
    assert d1.get("kernel.compile.events", 0) > 0
    view = obsreg.get_registry().view()
    q.collect()
    d2 = view.delta()["counters"]
    assert d2.get("kernel.cache.compiles", 0) == 0
    assert d2.get("kernel.compile.events", 0) == 0
    assert d2.get("kernel.cache.memHits", 0) > 0
    snap = obscompile.snapshot(max_events=0)
    t = snap["totals"]
    attributed = sum(r["kernels_compiled"]
                     for r in snap["per_query"].values())
    assert attributed + t["unattributed_fresh"] + t["evicted_compiled"] \
        == d1["kernel.cache.compiles"]


def test_profile_compile_section_and_span():
    kc.clear()
    s = _session({"spark.rapids.tpu.obs.trace.enabled": True})
    try:
        (_df(s).with_column("z", col("x") + 0.5).group_by("k")
         .agg(F.max("z").alias("mz"))).collect()
    finally:
        from spark_rapids_tpu_torch.obs import trace as obs_trace
        obs_trace.configure(False)
    prof = s.last_query_profile()
    comp = prof.metrics["compile"]
    programs = comp.get("kernel.cache.compiles", 0) + \
        comp.get("kernel.cache.persistentHits", 0)
    assert programs > 0, comp
    assert comp.get("kernel.compile.events", 0) == programs
    assert comp.get("kernel.compile.wallNs", 0) > 0
    assert "kernel.compile.wallMs" in comp
    st = obscompile.query_stats(prof.query_id)
    assert prof.wall_breakdown["compile_s"] == st["compile_ms"] / 1e3 > 0
    spans = [sp for sp in prof.spans if sp["name"] == "kernel.compile"]
    assert len(spans) == programs
    assert all(sp["args"]["tier"] in ("fresh", "persistent")
               for sp in spans)
    # the profile's kernel section now counts the dispatches
    assert prof.metrics["kernel"].get("kernel.dispatches", 0) > 0


def test_slow_query_log_compile_fields(tmp_path):
    log = tmp_path / "slow.jsonl"
    kc.clear()
    s = _session({"spark.rapids.tpu.obs.slowQueryMs": 1,
                  "spark.rapids.tpu.obs.slowQueryPath": str(log)})
    q = (_df(s).with_column("v", col("x") * 9.0).group_by("k")
         .agg(F.sum("v").alias("sv")))
    q.collect()
    rec = json.loads(log.read_text().splitlines()[0])
    assert rec["kernels_compiled"] >= 1
    assert rec["compile_ms"] > 0
    assert rec["kernels_compiled"] == obscompile.row_fields(
        rec["query_id"])["kernels_compiled"]
    # warm: null when zero (the reference's field contract)
    s.set_conf("spark.rapids.tpu.obs.slowQueryMs", 0)
    q.collect()
    qid = s.last_query_profile().query_id
    assert obscompile.row_fields(qid) == {"kernels_compiled": None,
                                          "compile_ms": None}


def test_session_configures_the_observatory():
    _session({"spark.rapids.tpu.obs.compile.enabled": False,
              "spark.rapids.tpu.obs.compile.ringEvents": 32,
              "spark.rapids.tpu.obs.compile.stormThreshold": 5})
    snap = obscompile.snapshot()
    assert snap["enabled"] is False and snap["ring_capacity"] == 32
    assert snap["storm_threshold"] == 5
    _session()
    assert obscompile.is_enabled()
    assert obscompile.snapshot()["storm_threshold"] == 64


def test_data_rows_equal_with_observatory_off():
    """The wrappers change no result."""
    rng = np.random.default_rng(1)
    t = pa.table({"k": rng.integers(0, 5, 200), "x": rng.uniform(0, 1, 200)})
    outs = []
    for on in (True, False):
        kc.clear()
        s = _session({"spark.rapids.tpu.obs.compile.enabled": on,
                      "spark.rapids.tpu.obs.accounting.enabled": on})
        outs.append(s.create_dataframe(t).group_by("k")
                    .agg(F.sum("x").alias("sx")).collect()
                    .sort_by("k"))
    assert outs[0].equals(outs[1])
