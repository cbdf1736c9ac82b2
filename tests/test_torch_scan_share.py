"""The port's shared-scan multicast (``io/scan_share.py``) against the
reference's.

``tests/test_work_sharing.py:290-390``'s cases on a port session
(``device="cpu"``): two concurrent queries over the same scan, filter
and columns decode once (the page walks equal one run's, the
``scan.shared.*`` counters are at least 1, both results equal the
serial run and the reference session's), and with
``sql.scan.shared.enabled`` off each pays its own walks.  Then the
``ScanShare`` state machine against the reference's on the same script
of calls (claim / publish / fail / wait / release / try_steal, the LRU
window, the pressure spiller), a leader that fails so its subscriber
decodes under a fresh claim, the share key (which the port extends by
the scan's device), and the host reader's per-file share.
"""

import threading

import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu.io import scan_share as jshare

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.io import parquet_meta as pm
from spark_rapids_tpu_torch.io import scan_share as tshare
from spark_rapids_tpu_torch.mem import spill
from spark_rapids_tpu_torch.obs import registry as obsreg

from tests.torch_sched import join_query_threads  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

# isolate the scan layer, as the reference's test does: no scheduler
# dedup, no page-walk memoization, no admission-pressure wipe of the
# window
SCAN_CONF = {
    "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
    "spark.rapids.tpu.sched.dedup.enabled": False,
    "spark.rapids.tpu.sql.scan.metadataCache.enabled": False,
    "spark.rapids.tpu.memory.spill.enabled": False,
}


@pytest.fixture(scope="module")
def scan_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("scan_share") / "s.parquet")
    papq.write_table(pa.table(
        {"a": list(range(4000)),
         "b": [float(i % 97) for i in range(4000)]}), p)
    return p


@pytest.fixture(scope="module")
def reference_rows(scan_file):
    s = JSession(SCAN_CONF)
    return s.read.parquet(scan_file).filter(jcol("a") > 10) \
        .select("a", "b").collect()


def _concurrently(fn, n=2):
    out = [None] * n
    errors = []

    def run(i):
        try:
            out[i] = fn()
        except BaseException as e:   # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return out


@pytest.mark.parametrize("fmt_conf", [
    {},
    {"spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled": False}],
    ids=["fused", "host"])
def test_shared_scan_decodes_once_for_two_subscribers(scan_file,
                                                      reference_rows,
                                                      fmt_conf):
    s = TSession(dict(SCAN_CONF, **fmt_conf), device="cpu")
    df = s.read.parquet(scan_file)

    def q():
        return df.filter(tcol("a") > 10).select("a", "b").collect()

    base = q()                      # publishes + retains
    assert base.equals(reference_rows)
    sh = tshare.peek_share()
    assert sh is not None
    sh.clear()
    w0 = pm.walk_count()
    serial = q()                    # fresh decode: the one-run walk bill
    one_run_walks = pm.walk_count() - w0
    assert serial.equals(base)
    if not fmt_conf:
        assert one_run_walks > 0    # metadata cache is off: real walks
    sh.clear()
    view = obsreg.get_registry().view()
    w1 = pm.walk_count()
    results = _concurrently(q)
    # two subscribers, ONE decode: page walks match a single run
    # whether the second query joined the in-flight decode or the
    # retention window
    assert pm.walk_count() - w1 == one_run_walks
    assert results[0].equals(base) and results[1].equals(base)
    d = view.delta()["counters"]
    assert d.get("scan.shared.subscribers", 0) >= 1
    assert d.get("scan.shared.dedupedDecodes", 0) >= 1
    assert d.get("scan.shared.multicastBatches", 0) >= 1


def test_shared_scan_knob_off_decodes_privately(scan_file):
    s = TSession(dict(SCAN_CONF,
                      **{"spark.rapids.tpu.sql.scan.shared.enabled":
                         False}), device="cpu")
    df = s.read.parquet(scan_file)

    def q():
        return df.filter(tcol("a") > 10).select("a", "b").collect()

    base = q()
    w0 = pm.walk_count()
    serial = q()
    one_run_walks = pm.walk_count() - w0
    assert one_run_walks > 0
    view = obsreg.get_registry().view()
    w1 = pm.walk_count()
    _concurrently(q)
    # knob off: every run pays its own walks, no sharing counters
    assert pm.walk_count() - w1 == 2 * one_run_walks
    assert serial.equals(base)
    d = view.delta()["counters"]
    assert d.get("scan.shared.subscribers", 0) == 0
    assert d.get("scan.shared.dedupedDecodes", 0) == 0


def test_different_pushed_filters_share_nothing(scan_file):
    """The share key carries the pushed filter's signature: two
    literals are two keys, so each query decodes its own."""
    s = TSession(SCAN_CONF, device="cpu")
    df = s.read.parquet(scan_file)
    tshare.peek_share() and tshare.peek_share().clear()
    view = obsreg.get_registry().view()
    df.filter(tcol("a") > 10).select("a", "b").collect()
    df.filter(tcol("a") > 11).select("a", "b").collect()
    assert view.delta()["counters"].get("scan.shared.subscribers", 0) == 0


class _Batch:
    def __init__(self, n):
        self.n = n

    def nbytes(self):
        return self.n


def _script(mod):
    """One script of ScanShare calls; returns what each step saw."""
    reg_counts = []
    sh = mod.ScanShare(window_bytes=250)
    seen = []
    role, lead = sh.claim(("k", 1))
    role2, sub = sh.claim(("k", 1))
    seen.append((role, role2, lead is sub))
    sh.publish(lead, _Batch(100))
    sh.release(lead)
    got = sh.wait(sub)
    sh.release(sub)
    seen.append((got.n, sh.stats()))
    # the window keeps k1; k2 and k3 push it out oldest-first
    for i in (2, 3, 4):
        r, e = sh.claim(("k", i))
        sh.publish(e, _Batch(100))
        sh.release(e)
        seen.append((r, sh.stats()))
    r, e = sh.claim(("k", 1))       # evicted: leads a fresh decode
    seen.append(r)
    sh.fail(e, RuntimeError("boom"))
    r2, e2 = sh.claim(("k", 1))     # failed flight closed: leads again
    seen.append(r2)
    sh.release(e)
    r3, sub3 = sh.claim(("k", 1))
    sh.publish(e2, _Batch(50))
    sh.release(e2)
    seen.append((r3, sh.wait(sub3).n))
    sh.release(sub3)
    seen.append(sh.try_steal(e2))   # multicast: never donated
    r4, e4 = sh.claim(("k", 9))
    sh.publish(e4, _Batch(10))
    sh.release(e4)
    seen.append((r4, sh.try_steal(e4), sh.stats()))
    seen.append((sh.pressure_spill(1000), sh.stats()))
    reg_counts.append(sh.stats())
    return seen


def test_scan_share_state_machine_is_the_references():
    assert _script(tshare) == _script(jshare)


def test_subscriber_decodes_under_a_fresh_claim_after_leader_failure():
    sh = tshare.ScanShare(window_bytes=1 << 20)
    _, lead = sh.claim(("f", 1))
    _, sub = sh.claim(("f", 1))
    sh.fail(lead, RuntimeError("cancelled"))
    sh.release(lead)
    assert sh.wait(sub) is None     # the caller decodes locally
    sh.release(sub)
    role, fresh = sh.claim(("f", 1))
    assert role == "lead"
    role2, third = sh.claim(("f", 1))
    assert role2 == "join"
    sh.publish(fresh, _Batch(8))
    sh.release(fresh)
    assert sh.wait(third).n == 8
    sh.release(third)


def test_share_key_carries_the_device(scan_file):
    args = ([(scan_file, 0)], {}, (("a", "int64"),), None, "pallas")
    ref = jshare.share_key(*args)
    port = tshare.share_key(*args, device="cpu")
    assert port[:-1] == ref and port[-1] == "cpu"
    assert tshare.share_key(*args, device="cuda:0") != port
    assert tshare.share_key([("/no/such/file", 0)], *args[1:]) is None


def test_window_registers_as_a_pressure_spiller():
    TSession({}, device="cpu")
    sh = tshare.get_share(1 << 20)
    assert tshare.peek_share() is sh
    sh.clear()
    _, e = sh.claim(("p", 1))
    sh.publish(e, _Batch(4096))
    sh.release(e)
    assert sh.stats()["window_bytes"] == 4096
    spill._aux_pressure_spill(4096)
    assert sh.stats()["window_bytes"] == 0
