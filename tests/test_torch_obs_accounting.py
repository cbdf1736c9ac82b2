"""The port's resource ledger (obs/accounting.py) against the reference's.

The ledger cases of ``tests/test_obs_accounting.py`` (:153-230) run on
both packages, and the same charges give equal ``snapshot()`` rows.  On a
port session the accounting identity holds for every charged metric
(``kernel.dispatches``, ``kernel.compile.wallNs``, ``scan.bytesWalked``,
``scan.bytesUploaded``) over two concurrent collects: the sum over
tenant rows equals the global counter's delta, and a session query
bills the tenant ``("(in-process)", "digest:<16 hex>")`` of its plan
digest, as the reference's query service does.  The endpoint case of
``:233`` (without its serve-tier drain) and the four drift-sentinel
cases (:340-430) follow, the sentinel's on both packages.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.obs import accounting as jacct
from spark_rapids_tpu.obs import recorder as jrec
from spark_rapids_tpu.obs import registry as jreg
from spark_rapids_tpu.obs import sentinel as jsent

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.entry import write_store_sales
from spark_rapids_tpu_torch.exec import kernel_cache as kc
from spark_rapids_tpu_torch.obs import accounting as tacct
from spark_rapids_tpu_torch.obs import recorder as trec
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.obs import sentinel as tsent
from spark_rapids_tpu_torch.obs.server import lint_exposition
from spark_rapids_tpu_torch.plan.digest import plan_digest

from tests.torch_sched import Parker, join_query_threads  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

MODS = {"ref": jacct, "port": tacct}
CHARGED = ("kernel.dispatches", "kernel.compile.wallNs", "scan.bytesWalked",
           "scan.bytesUploaded")


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    for m in MODS.values():
        m.reset()
        m.configure(True)
    yield
    for m in MODS.values():
        m.reset()
        m.configure(True)


def _tenant_sum(snap, metric):
    return sum(r["usage"].get(metric, 0.0) for r in snap["tenants"])


def _rows(snap):
    """Snapshot rows without their clock fields."""
    return [{k: v for k, v in r.items()
             if k not in ("first_unix", "last_unix")}
            for r in snap["tenants"]]


@pytest.mark.parametrize("side", list(MODS))
def test_ledger_attributes_and_folds(side):
    acct = MODS[side]
    acct.register_query(101, "sess-a", "select 1")
    acct.charge_qid(101, "kernel.dispatches", 4)
    acct.charge_qid(101, "scan.bytesWalked", 1000)
    assert _tenant_sum(acct.snapshot(), "kernel.dispatches") == 4
    acct.finish_query(101)
    acct.finish_query(101)                 # idempotent
    row = [r for r in acct.snapshot()["tenants"]
           if r["session_id"] == "sess-a"][0]
    assert row["workload"] == "select 1"
    assert row["usage"] == {"kernel.dispatches": 4,
                            "scan.bytesWalked": 1000}
    # token-less charges land on "(unattributed)": counted, not lost
    acct.charge("kernel.dispatches", 2)
    assert _tenant_sum(acct.snapshot(), "kernel.dispatches") == 6


@pytest.mark.parametrize("side", list(MODS))
def test_ledger_flight_settle_shares_sum_to_leader_bill(side):
    acct = MODS[side]
    for q, sess in ((1, "sess-a"), (2, "sess-b"), (3, "sess-c")):
        acct.register_query(q, sess, "q")
    acct.charge_qid(1, "kernel.dispatches", 9)
    acct.charge_qid(1, "kernel.compile.wallNs", 3_000_000)
    acct.settle_flight(1, [2, 3])
    for q in (1, 2, 3):
        acct.finish_query(q)
    snap = acct.snapshot()
    assert _tenant_sum(snap, "kernel.dispatches") == pytest.approx(9)
    assert _tenant_sum(snap, "kernel.compile.wallNs") == \
        pytest.approx(3_000_000)
    by_sess = {r["session_id"]: r["usage"] for r in snap["tenants"]}
    for sid in ("sess-a", "sess-b", "sess-c"):
        assert by_sess[sid]["kernel.dispatches"] == pytest.approx(3)


@pytest.mark.parametrize("side", list(MODS))
def test_ledger_batch_settle_splits_by_row_share(side):
    acct = MODS[side]
    acct.register_query(7, "sess-a", "tpl", hold=True)
    acct.charge_qid(7, "kernel.dispatches", 10)
    acct.finish_query(7)                   # hold: bill stays un-folded
    members = [(acct.tenant_of("sess-a", "tpl", None), 30.0),
               (acct.tenant_of("sess-b", "tpl", None), 10.0)]
    acct.settle_batch(7, members)
    snap = acct.snapshot()
    assert _tenant_sum(snap, "kernel.dispatches") == pytest.approx(10)
    by_sess = {r["session_id"]: r["usage"] for r in snap["tenants"]}
    assert by_sess["sess-a"]["kernel.dispatches"] == pytest.approx(7.5)
    assert by_sess["sess-b"]["kernel.dispatches"] == pytest.approx(2.5)
    acct.register_query(8, "sess-a", "tpl", hold=True)
    acct.charge_qid(8, "kernel.dispatches", 4)
    acct.settle_batch(8, [(("s1", "w"), 0.0), (("s2", "w"), 0.0)])
    assert _tenant_sum(acct.snapshot(), "kernel.dispatches") == \
        pytest.approx(14)


@pytest.mark.parametrize("side", list(MODS))
def test_ledger_disabled_is_inert(side):
    acct = MODS[side]
    acct.configure(False)
    acct.register_query(50, "sess-a", "q")
    acct.charge_qid(50, "kernel.dispatches", 5)
    acct.charge("kernel.dispatches", 5)
    acct.finish_query(50)
    assert acct.snapshot()["tenants"] == []


def _charges(acct):
    acct.register_query(11, "sess-a", "tpl-1")
    acct.register_query(12, None, None, "0123456789abcdef0123")
    acct.register_query(13)
    acct.charge_qid(11, "kernel.dispatches", 7)
    acct.charge_qid(12, "scan.bytesWalked", 4096)
    acct.charge_qid(13, "scan.bytesUploaded", 1 << 20)
    acct.charge_qid(14, "kernel.dispatches", 2)       # never registered
    acct.charge_tenant("sess-b", "tpl-2", None, "kernel.dispatches", 3)
    acct.settle_flight(11, [13])
    for q in (11, 12):
        acct.finish_query(q)
    acct.charge("kernel.compile.wallNs", 5_000)       # no token


def test_same_charges_same_snapshot():
    snaps = {}
    for side, acct in MODS.items():
        _charges(acct)
        snaps[side] = acct.snapshot()
    assert _rows(snaps["port"]) == _rows(snaps["ref"])
    assert snaps["port"]["live_queries"] == snaps["ref"]["live_queries"]
    assert snaps["port"]["tenant_count"] == snaps["ref"]["tenant_count"] \
        == 5
    assert tacct.top_talkers(limit=2) == [
        {k: r[k] for k in ("session_id", "workload", "window")}
        for r in jacct.top_talkers(limit=2)]


@pytest.fixture(scope="module")
def store_sales(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("acct_ss"))
    write_store_sales(root, 3000, files=2, seed=17)
    return root


def test_identity_over_two_concurrent_collects(store_sales):
    kc.clear()
    s = TSession({"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
                  "spark.rapids.tpu.sql.scan.metadataCache.enabled": False},
                 device="cpu")

    def q6():
        return (s.read.parquet(store_sales)
                .filter(col("ss_sales_price") > 150.0)
                .group_by("ss_item_sk")
                .agg(F.count("*").alias("cnt"),
                     F.sum("ss_quantity").alias("qty")))
    reg = obsreg.get_registry()
    view = reg.view()
    errors = []

    def run():
        try:
            q6().collect()
        except Exception as e:              # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errors
    d = view.delta()["counters"]
    snap = tacct.snapshot()
    for metric in CHARGED:
        assert d.get(metric, 0) > 0, metric
        assert _tenant_sum(snap, metric) == pytest.approx(d[metric]), metric
    tenant = ("(in-process)", "digest:" + plan_digest(q6().plan)[:16])
    row = [r for r in snap["tenants"]
           if (r["session_id"], r["workload"]) == tenant][0]
    assert row["queries"] == 2
    assert row["usage"]["kernel.dispatches"] > 0
    assert snap["live_queries"] == 0


# ---------------------------------------------------------------------------
# /tenants, /slo and /metrics under concurrent scrape
# ---------------------------------------------------------------------------

def _get(port, path, timeout=10):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, r.read().decode()


def _agg_df(s, n=600, parts=2, seed=5):
    rng = np.random.default_rng(seed)
    t = pa.table({
        "k": pa.array(rng.integers(0, 9, n).astype(np.int64)),
        "v": pa.array(rng.integers(0, 500, n).astype(np.int64)),
    })
    return (s.create_dataframe(t, num_partitions=parts)
            .group_by("k").agg(F.count("*").alias("c"),
                               F.sum("v").alias("sv")))


def test_endpoints_exactness_and_concurrent_scrape():
    """``tests/test_obs_accounting.py:233`` without its serve-tier drain
    (serve/ is not ported): /tenants, /slo and /metrics serve consistent
    snapshots, never a 500, while eight queries are in flight; after
    them the per-tenant ``kernel.dispatches`` sum EXACTLY to the global
    counter's delta, and each query bills its own ``digest:`` tenant."""
    s = TSession({"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
                  "spark.rapids.tpu.obs.http.enabled": True,
                  "spark.rapids.tpu.sched.maxConcurrent": 8},
                 device="cpu")
    est = 64 << 20              # the default estimate fills the budget
    port = s.obs_server.port
    parker = Parker()
    s.add_plan_listener(parker)
    failures = []
    stop = threading.Event()

    def scraper():
        while not stop.is_set():
            for path in ("/tenants", "/slo", "/metrics"):
                try:
                    code, body = _get(port, path)
                    if code != 200:
                        failures.append((path, code))
                    elif path == "/metrics":
                        lint_exposition(body)
                    else:
                        json.loads(body)
                except Exception as e:
                    failures.append((path, repr(e)))

    threads = [threading.Thread(target=scraper, daemon=True)
               for _ in range(3)]
    try:
        base = obsreg.get_registry().counter("kernel.dispatches")
        dfs = [_agg_df(s, seed=i) for i in range(8)]
        futs = [s.submit(df, estimate_bytes=est) for df in dfs]
        for _ in range(8):                 # all 8 parked at plan time
            assert parker.parked.acquire(timeout=30)
        for t in threads:
            t.start()
        time.sleep(0.3)                    # scrapes against the live batch
        parker.release.set()
        for f in futs:
            assert f.result(timeout=60).num_rows
        time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert not failures, failures[:5]

        code, body = _get(port, "/tenants")
        assert code == 200
        snap = json.loads(body)
        assert snap["enabled"] and snap["tenant_count"] >= 8
        total = obsreg.get_registry().counter("kernel.dispatches")
        assert _tenant_sum(snap, "kernel.dispatches") == \
            pytest.approx(total - base)
        assert total > base
        mine = {("(in-process)", "digest:" + plan_digest(df.plan)[:16])
                for df in dfs}
        assert mine <= {(r["session_id"], r["workload"])
                        for r in snap["tenants"]}

        code, body = _get(port, "/slo")
        slo = json.loads(body)
        lat = slo["histograms"]["slo.latencyMs"]
        assert lat["count"] >= 8 and lat["p95"] is not None
        assert "slo.queueWaitMs" in slo["histograms"]

        samples = lint_exposition(_get(port, "/metrics")[1])
        assert "spark_rapids_tpu_slo_latencyMs_count" in samples
        for gauge in ("queueDepth", "admittedFraction", "runningFraction"):
            assert f"spark_rapids_tpu_sched_{gauge}" in samples
        assert {"/tenants", "/slo"} <= set(
            json.loads(_get(port, "/healthz")[1])["routes"])
    finally:
        stop.set()
        parker.release.set()
        s.remove_plan_listener(parker)
        s.obs_server.shutdown()


# ---------------------------------------------------------------------------
# the drift sentinel, each case on both packages
# ---------------------------------------------------------------------------

SENTINELS = {"ref": (jsent, jreg, jacct, jrec),
             "port": (tsent, obsreg, tacct, trec)}


@pytest.mark.parametrize("side", list(SENTINELS))
def test_sentinel_rules_grammar(side):
    sent = SENTINELS[side][0]
    rules = sent.parse_rules("latency:factor=3,sustain=1;slow")
    assert set(rules) == {"latency", "slow"}
    assert rules["latency"]["factor"] == 3.0
    assert rules["slow"]["min"] == sent.DEFAULT_RULES["slow"]["min"]
    assert set(sent.parse_rules("")) == set(sent.DEFAULT_RULES)
    with pytest.raises(ValueError):
        sent.parse_rules("nosuchrule")
    with pytest.raises(ValueError):
        sent.parse_rules("latency:bogus=1")
    assert tsent.DEFAULT_RULES == jsent.DEFAULT_RULES


def test_sentinel_latency_episode_fires_once(tmp_path):
    """A sustained p95 regression opens ONE episode (one 'slo' bundle
    with the hog tenant among the top talkers, one JSONL line); the
    healthy windows breach nothing; both packages fire on the same
    windows."""
    fired = {}
    for side, (sent_mod, reg_mod, acct, rec) in SENTINELS.items():
        reg_mod.reset_registry()
        rec.configure(str(tmp_path / side / "bundles"))
        log = str(tmp_path / side / "breaches.jsonl")
        sent = sent_mod.DriftSentinel(
            interval_ms=50, rules="latency:factor=2,sustain=2,min=4",
            jsonl_path=log)
        reg = reg_mod.get_registry()

        def window(ms, n=6):
            acct.charge_tenant("sess-hog", "tpl", None,
                               "kernel.dispatches", 50)
            for _ in range(n):
                reg.observe_bucket("slo.latencyMs", ms)
            return sent.tick()

        seq = [window(ms) for ms in
               (10.0, 10.0, 10.0, 10.0, 900.0, 900.0, 900.0, 900.0, 900.0,
                8.0, 8.0, 900.0, 900.0)]
        fired[side] = seq
        assert reg.counter("obs.sentinel.breaches.latency") == 2
        assert reg.counter("obs.sentinel.breaches") == 2
        bundles = sorted(b for b in os.listdir(
            str(tmp_path / side / "bundles")) if "-slo-" in b)
        assert len(bundles) == 2
        with open(os.path.join(str(tmp_path / side / "bundles"),
                               bundles[0], "sentinel.json")) as f:
            payload = json.load(f)
        assert payload["rules"] == ["latency"]
        assert any(t["session_id"] == "sess-hog"
                   for t in payload["top_talkers"])
        with open(log) as f:
            assert len(f.readlines()) == 2
        rec.disable()
        reg_mod.reset_registry()
    assert fired["port"] == fired["ref"]
    assert fired["port"] == [[]] * 5 + [["latency"]] + [[]] * 6 + \
        [["latency"]]


@pytest.mark.parametrize("side", list(SENTINELS))
def test_sentinel_control_run_never_breaches(side):
    sent_mod, reg_mod = SENTINELS[side][:2]
    reg_mod.reset_registry()
    sent = sent_mod.DriftSentinel(interval_ms=50, rules="")
    reg = reg_mod.get_registry()
    for _ in range(10):
        for _ in range(6):
            reg.observe_bucket("slo.latencyMs", 10.0)
        reg.inc("kernel.cache.compiles", 1)
        assert sent.tick() == []
    assert reg.counter("obs.sentinel.breaches") == 0
    reg_mod.reset_registry()


def test_sentinel_session_wiring():
    s = TSession({"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
                  "spark.rapids.tpu.obs.sentinel.enabled": True,
                  "spark.rapids.tpu.obs.sentinel.intervalMs": 60,
                  "spark.rapids.tpu.obs.sentinel.rules": "latency"},
                 device="cpu")
    try:
        assert s.sentinel is not None
        deadline = time.time() + 10
        while s.sentinel.stats()["ticks"] == 0 and \
                time.time() < deadline:
            time.sleep(0.05)
        assert s.sentinel.stats()["ticks"] >= 1
    finally:
        s.sentinel.stop()
    assert not s.sentinel._thread.is_alive()
    # off by default: no watcher constructed
    s2 = TSession({"spark.rapids.tpu.sql.variableFloatAgg.enabled": True},
                  device="cpu")
    assert s2.sentinel is None
    with pytest.raises(ValueError):
        TSession({"spark.rapids.tpu.obs.sentinel.enabled": True,
                  "spark.rapids.tpu.obs.sentinel.rules": "nosuchrule"},
                 device="cpu")
