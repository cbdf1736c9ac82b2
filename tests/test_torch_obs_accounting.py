"""The port's resource ledger (obs/accounting.py) against the reference's.

The ledger cases of ``tests/test_obs_accounting.py`` (:153-230) run on
both packages, and the same charges give equal ``snapshot()`` rows.  On a
port session the accounting identity holds for every charged metric
(``kernel.dispatches``, ``kernel.compile.wallNs``, ``scan.bytesWalked``,
``scan.bytesUploaded``) over two concurrent collects: the sum over
tenant rows equals the global counter's delta, and a session query
bills the tenant ``("(in-process)", "(ad-hoc)")``.
"""

import threading

import pytest

from spark_rapids_tpu.obs import accounting as jacct

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.entry import write_store_sales
from spark_rapids_tpu_torch.exec import kernel_cache as kc
from spark_rapids_tpu_torch.obs import accounting as tacct
from spark_rapids_tpu_torch.obs import registry as obsreg

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
        t.join()
    assert not errors
    d = view.delta()["counters"]
    snap = tacct.snapshot()
    for metric in CHARGED:
        assert d.get(metric, 0) > 0, metric
        assert _tenant_sum(snap, metric) == pytest.approx(d[metric]), metric
    row = [r for r in snap["tenants"]
           if (r["session_id"], r["workload"]) ==
           ("(in-process)", "(ad-hoc)")][0]
    assert row["queries"] == 2
    assert row["usage"]["kernel.dispatches"] > 0
    assert snap["live_queries"] == 0
