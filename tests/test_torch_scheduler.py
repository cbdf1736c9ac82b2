"""The port's query scheduler (sched/) against the reference's.

``tests/test_scheduler.py`` :109-632 and :741 on a port session
(``device="cpu"``): the wait queue, the cancel token, the estimate book
and the plan-shape key (each on both packages with the same inputs),
the task gate and the device semaphore's re-entrance, submit/result
parity, deadlines, admission by budget and count, priorities,
rejection, queue-wait attribution and leak-free cancellation.  Results
are held against the reference's CPU engine (``sql.enabled=false``, no
XLA compile) on the same data.  The port adds single-flight cases (the
reference tests them through its serving tier) and a nested collect
under a cached relation.  The reference's ``:633`` and ``:698`` cases
need the shuffle fetch iterator and the ``process`` transport (ROADMAP
Queue A item 8).

Every wait is bounded, every parked query is released in a
``finally``.
"""

import json
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.sched import admission as jadm
from spark_rapids_tpu.sched import queue as jqueue

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col, functions as F
from spark_rapids_tpu_torch.exec.base import Metrics
from spark_rapids_tpu_torch.mem import device as devmgr
from spark_rapids_tpu_torch.mem import spill
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.sched import admission as tadm
from spark_rapids_tpu_torch.sched import cancel as sched_cancel
from spark_rapids_tpu_torch.sched import queue as tqueue
from spark_rapids_tpu_torch.sched.admission import (QueryRejectedError,
                                                    TaskGate)
from spark_rapids_tpu_torch.sched.cancel import (CancelToken,
                                                 QueryCancelledError,
                                                 QueryTimeoutError)
from spark_rapids_tpu_torch.sched.service import QueryState

from tests.parity import assert_tables_equal
from tests.torch_sched import (Parker, assert_clean,  # noqa: F401
                               join_query_threads, wait_until)
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
QUEUES = {"ref": jqueue, "port": tqueue}
ADMISSION = {"ref": jadm, "port": tadm}


@pytest.fixture(autouse=True)
def _fresh_registry():
    """sched.runningHwm is a process-lifetime high water: admission
    assertions need a clean registry."""
    obsreg.reset_registry()
    yield
    obsreg.reset_registry()


def _session(extra=None):
    return TSession(dict(CONF, **(extra or {})), device="cpu")


def _oracle(extra=None):
    return JSession(dict(CONF, **{"spark.rapids.tpu.sql.enabled": False},
                         **(extra or {})))


def _data(n: int, seed: int = 5) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 7, n).astype(np.int64)),
                     "x": pa.array(rng.integers(0, 50, n).astype(np.float64))})


def _df(s, c, n=400, parts=2, tag="v"):
    return s.create_dataframe(_data(n), num_partitions=parts) \
        .with_column(tag, c("x") * 2.0)


def _query(s, n=400, tag="v", c=col, f=F):
    # the tag rides the output schema (agg alias) so the Parker's
    # admission-order log can tell queries apart
    return (_df(s, c, n, tag=tag).filter(c("x") > 3.0)
            .group_by("k").agg(f.sum(tag).alias("c"),
                               f.count("*").alias(tag)).sort("k"))


# ---------------------------------------------------------------------------
# unit layers, on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", list(QUEUES))
def test_wait_queue_priority_then_fifo(side):
    m = QUEUES[side]
    q = m.WaitQueue()
    a, b, c, d = (m.WaitEntry(0, "a"), m.WaitEntry(5, "b"),
                  m.WaitEntry(5, "c"), m.WaitEntry(0, "d"))
    for e in (a, b, c, d):
        q.push(e)
    assert len(q) == 4
    q.remove(c)  # lazy removal skipped at peek
    order = []
    while q:
        order.append(q.pop_head().payload)
    assert order == ["b", "a", "d"]  # priority 5 first, FIFO within 0


def test_cancel_token_checkpoints_and_callbacks():
    tok = CancelToken(query_id=7)
    fired = []
    tok.add_callback(lambda: fired.append(1))
    with sched_cancel.install(tok):
        sched_cancel.check_current()       # not cancelled: no raise
        assert tok.cancel("stop") is True
        assert tok.cancel("again") is False  # idempotent
        assert fired == [1]
        with pytest.raises(QueryCancelledError):
            sched_cancel.check_current()
    # late registration on a fired token runs immediately
    tok.add_callback(lambda: fired.append(2))
    assert fired == [1, 2]
    t2 = CancelToken()
    t2.cancel("deadline", timed_out=True)
    with pytest.raises(QueryTimeoutError):
        t2.check()
    assert sched_cancel.current() is None  # install() restored


@pytest.mark.parametrize("side", list(ADMISSION))
def test_estimate_book_refines_and_pads(side):
    book_cls = ADMISSION[side].EstimateBook
    book = book_cls(max_entries=2)
    assert book.estimate("shape-a") is None
    book.record("shape-a", 100 << 20)
    book.record("shape-a", 80 << 20)   # a lower observation decays halfway
    assert book.estimate("shape-a") == int((90 << 20) * book_cls.HEADROOM)
    book.record("shape-a", 120 << 20)  # a new high is taken as-is
    assert book.estimate("shape-a") == int((120 << 20) * book_cls.HEADROOM)
    book.record("tiny", 1)             # floor applies
    assert book.estimate("tiny") == book_cls.FLOOR
    book.record("shape-c", 5 << 20)    # LRU eviction at 2 entries
    assert len(book) == 2


def test_plan_shape_key_structural():
    s, j = _session(), _oracle()
    k1 = tadm.plan_shape_key(_query(s, n=100).plan)
    k2 = tadm.plan_shape_key(_query(s, n=300).plan)  # same shape, more rows
    k3 = tadm.plan_shape_key(_df(s, col).plan)        # a different shape
    assert k1 == k2
    assert k1 != k3
    assert k1 == jadm.plan_shape_key(_query(j, n=100, c=jcol, f=JF).plan)


# ---------------------------------------------------------------------------
# the device gate's re-entrance
# ---------------------------------------------------------------------------

def test_semaphore_reentrant_same_thread_no_deadlock():
    devmgr.initialize(1)   # one slot: a second real acquire would hang
    try:
        m = Metrics()
        with devmgr.tpu_semaphore(m):
            with devmgr.tpu_semaphore(m):    # scan-under-exchange shape
                with devmgr.tpu_semaphore(m):
                    pass
        assert m.extra.get("semaphore.acquires") == 1
        assert m.extra.get("semaphore.reentries") == 2
        assert devmgr._get().available() == 1
    finally:
        devmgr.initialize(2)


def test_semaphore_reentry_blocked_ns_not_double_counted():
    """A re-entering holder logs no blocked ns while another thread
    really waits on the slot."""
    devmgr.initialize(1)
    try:
        holder, waiter = Metrics(), Metrics()
        entered, release = threading.Event(), threading.Event()

        def hold():
            with devmgr.tpu_semaphore(holder):
                entered.set()
                release.wait(10)
                with devmgr.tpu_semaphore(holder):   # re-entry under
                    time.sleep(0.05)                 # contention

        def wait_for_slot():
            entered.wait(10)
            with devmgr.tpu_semaphore(waiter):
                pass

        th, tw = (threading.Thread(target=hold),
                  threading.Thread(target=wait_for_slot))
        th.start()
        tw.start()
        time.sleep(0.15)          # let the waiter block on the slot
        release.set()
        th.join(10)
        tw.join(10)
        assert not th.is_alive() and not tw.is_alive()
        assert holder.extra.get("semaphore.waitNs", 0) == 0
        assert holder.extra.get("semaphore.reentries") == 1
        assert waiter.extra.get("semaphore.waitNs", 0) > 0
    finally:
        devmgr.initialize(2)


def test_taskgate_acquire_cancellable_while_blocked():
    gate = TaskGate(1)
    gate.acquire()
    tok = CancelToken()
    errs = []

    def blocked():
        with sched_cancel.install(tok):
            try:
                gate.acquire()
            except QueryCancelledError as e:
                errs.append(e)

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.1)
    tok.cancel("stop waiting")
    t.join(5)
    assert not t.is_alive() and len(errs) == 1
    gate.release()
    assert gate.available() == 1


# ---------------------------------------------------------------------------
# async submission and parity
# ---------------------------------------------------------------------------

def test_async_submit_parity_vs_blocking_collect():
    s = _session()
    q = _query(s)
    blocking = q.collect()
    fut = q.collect_async()
    assert fut.result(timeout=60).equals(blocking)
    assert fut.done() and fut.state is QueryState.SUCCESS
    assert fut.cancel() is False          # too late to cancel
    assert fut.profile is not None
    assert fut.profile.query_id == fut.query_id
    assert_tables_equal(_query(_oracle(), c=jcol, f=JF).collect(), blocking)
    assert_clean(s)


def test_future_result_timeout_does_not_cancel():
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1})
    parker = Parker()
    s.add_plan_listener(parker)
    fut = _query(s).collect_async()
    try:
        assert parker.parked.acquire(timeout=20)
        with pytest.raises(TimeoutError):
            fut.result(timeout=0.05)      # non-cancelling wait
        assert not fut.done()
    finally:
        parker.release.set()
    assert fut.result(timeout=60).num_rows > 0
    assert_clean(s)


def test_profile_ring_under_concurrent_collects():
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 4})
    futs = [_query(s, n=200 + 40 * i).collect_async() for i in range(4)]
    for f in futs:
        f.result(timeout=60)
    for f in futs:
        prof = s.query_profile(f.query_id)
        assert prof is not None and prof.query_id == f.query_id
        assert f.profile is prof
    assert s.last_query_profile().query_id in {f.query_id for f in futs}
    assert_clean(s)


def test_concurrency_smoke_serial_vs_concurrent_bit_identical():
    """Eight mixed queries, serial first, then all submitted at once
    under maxConcurrent=3: results bit-identical to the serial runs and
    to the reference's CPU engine, no deadlock (bounded waits), queue
    wait attributed in at least one profile."""
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 3})
    j = _oracle()

    def q_agg(s, c, f, n, tag):
        return _query(s, n=n, tag=tag, c=c, f=f)

    def q_shuffle(s, c, f, n, tag):
        return (_df(s, c, n=n, tag=tag).repartition(4, "k")
                .group_by("k").agg(f.avg(tag).alias("a")).sort("k"))

    def q_sort(s, c, f, n, tag):
        return (_df(s, c, n=n, tag=tag).filter(c("x") > 5.0)
                .sort(tag, "k").limit(40))

    def q_distinct(s, c, f, n, tag):
        return _df(s, c, n=n, tag=tag).select("k").distinct().sort("k")

    makers = [q_agg, q_shuffle, q_sort, q_distinct] * 2
    queries = [m(s, col, F, 300 + 50 * i, f"t{i}")
               for i, m in enumerate(makers)]
    serial = [q.collect() for q in queries]
    futs = [q.collect_async() for q in queries]
    tables = [f.result(timeout=60) for f in futs]
    for i, (a, b) in enumerate(zip(serial, tables)):
        assert a.equals(b), f"query {i} serial/concurrent diverge"
    for i, m in enumerate(makers):
        assert_tables_equal(m(j, jcol, JF, 300 + 50 * i, f"t{i}").collect(),
                            tables[i])
    waits = [(f.profile.metrics["sched"]["sched.queueWaitNs"]
              if f.profile is not None else 0) for f in futs]
    assert any(w > 0 for w in waits), waits
    assert_clean(s)


def test_nested_collect_inline_no_self_deadlock():
    """A collect issued from inside a running query (a plan listener)
    runs inline under the parent's slot: maxConcurrent=1 does not
    deadlock on its own child."""
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1})
    inner = {}

    def listener(result):
        if "done" not in inner:
            inner["done"] = True   # guard: the nested collect re-plans
            inner["rows"] = _df(s, col, n=50).collect().num_rows

    s.add_plan_listener(listener)
    out = _query(s).collect_async().result(timeout=60)
    assert out.num_rows > 0 and inner["rows"] == 50
    assert_clean(s)


def test_nested_collect_of_a_cached_relation():
    """The cached relation materializes inside the query that first
    reads it; a collect nested in a running query reads it inline under
    maxConcurrent=1."""
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1})
    cached = _df(s, col, n=300).filter(col("x") > 10.0).cache()
    inner = {}

    def listener(result):
        if "rows" not in inner:
            inner["rows"] = -1
            inner["rows"] = cached.group_by("k").agg(
                F.count("*").alias("c")).collect().num_rows

    s.add_plan_listener(listener)
    out = cached.collect_async().result(timeout=60)
    assert inner["rows"] == 7
    want = _df(_oracle(), jcol, n=300).filter(jcol("x") > 10.0).collect()
    assert_tables_equal(want, out, ignore_order=True)
    assert_clean(s)


# ---------------------------------------------------------------------------
# admission: memory budget and maxConcurrent
# ---------------------------------------------------------------------------

def test_small_budget_serializes():
    s = _session({"spark.rapids.tpu.sched.memoryBudget": 1 << 30,
                  "spark.rapids.tpu.sched.maxConcurrent": 3})
    parker = Parker()
    s.add_plan_listener(parker)
    est = 700 << 20     # 2 x 700 MB > 1 GB: admission must serialize
    futs = [_query(s, tag=t).collect_async(estimate_bytes=est)
            for t in ("q_a", "q_b")]
    try:
        assert parker.parked.acquire(timeout=20)
        time.sleep(0.3)  # give the second query time to (wrongly) admit
        stats = s.scheduler.controller.stats()
        assert stats["running"] == 1 and stats["queued"] == 1, stats
    finally:
        parker.release.set()
    for f in futs:
        f.result(timeout=60)
    assert obsreg.get_registry().gauge("sched.runningHwm") == 1
    assert_clean(s)


def test_large_budget_overlaps():
    s = _session({"spark.rapids.tpu.sched.memoryBudget": 4 << 30,
                  "spark.rapids.tpu.sched.maxConcurrent": 3})
    parker = Parker()
    s.add_plan_listener(parker)
    est = 100 << 20     # 3 x 100 MB well under 4 GB: all admit
    futs = [_query(s, tag=f"q_{i}").collect_async(estimate_bytes=est)
            for i in range(3)]
    try:
        for _ in range(3):
            assert parker.parked.acquire(timeout=30)
        stats = s.scheduler.controller.stats()
        assert stats["running"] == 3, stats
        assert stats["admitted_bytes"] == 3 * est, stats
    finally:
        parker.release.set()
    for f in futs:
        f.result(timeout=60)
    assert obsreg.get_registry().gauge("sched.runningHwm") >= 3
    assert_clean(s)


def test_progress_guarantee_oversized_estimate_runs_alone():
    """A query estimated over the whole budget still runs, alone."""
    s = _session({"spark.rapids.tpu.sched.memoryBudget": 64 << 20})
    out = _query(s).collect_async(estimate_bytes=1 << 40).result(timeout=60)
    assert out.num_rows > 0
    assert_clean(s)


def test_priority_ordering_and_fifo():
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1})
    parker = Parker()
    s.add_plan_listener(parker)
    filler = _query(s, tag="q_fill").collect_async()

    def submit_and_wait_queued(tag, priority, n_queued):
        fut = _query(s, tag=tag).collect_async(priority=priority)
        assert wait_until(lambda: s.scheduler.controller.stats()["queued"]
                          >= n_queued)
        assert s.scheduler.controller.stats()["queued"] == n_queued
        return fut

    try:
        assert parker.parked.acquire(timeout=20)
        # each submission confirmed queued before the next: FIFO order
        # is deterministic
        lo1 = submit_and_wait_queued("q_lo1", 0, 1)
        lo2 = submit_and_wait_queued("q_lo2", 0, 2)
        hi = submit_and_wait_queued("q_hi", 10, 3)
    finally:
        parker.release.set()
    for f in (filler, lo1, lo2, hi):
        f.result(timeout=60)
    assert parker.order == ["q_fill", "q_hi", "q_lo1", "q_lo2"]
    assert_clean(s)


def test_queue_full_rejected(tmp_path):
    log = str(tmp_path / "slow.jsonl")
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1,
                  "spark.rapids.tpu.sched.maxQueued": 1,
                  "spark.rapids.tpu.obs.slowQueryMs": 10 ** 9,
                  "spark.rapids.tpu.obs.slowQueryPath": log})
    parker = Parker()
    s.add_plan_listener(parker)
    filler = _query(s, tag="q_fill").collect_async()
    try:
        assert parker.parked.acquire(timeout=20)
        q2 = _query(s, tag="q_two").collect_async()
        assert wait_until(
            lambda: s.scheduler.controller.stats()["queued"] >= 1)
        q3 = _query(s, tag="q_three").collect_async()
        with pytest.raises(QueryRejectedError):
            q3.result(timeout=30)
        assert obsreg.get_registry().counter("sched.rejected") == 1
    finally:
        parker.release.set()
    filler.result(timeout=60)
    q2.result(timeout=60)
    # the rejection stub: in the ring, and logged whatever its wall
    prof = s.query_profile(q3.query_id)
    assert prof.status == "rejected" and "QueryRejectedError" in prof.error
    with open(log) as f:
        assert [json.loads(line)["status"] for line in f] == ["rejected"]
    assert_clean(s)


def test_queue_wait_attribution_in_profile():
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1})
    parker = Parker()
    s.add_plan_listener(parker)
    first = _query(s, tag="q_one").collect_async()
    try:
        assert parker.parked.acquire(timeout=20)
        second = _query(s, tag="q_two").collect_async()
        time.sleep(0.25)   # accrue measurable queue wait
    finally:
        parker.release.set()
    first.result(timeout=60)
    second.result(timeout=60)
    sched_sec = second.profile.metrics["sched"]
    assert sched_sec["sched.queueWaitNs"] > 0.2e9
    assert second.profile.wall_breakdown["queue_wait_s"] > 0.2
    assert second.queue_wait_ns == sched_sec["sched.queueWaitNs"]
    assert first.profile.metrics["sched"]["sched.queueWaitNs"] < 0.1e9
    assert_clean(s)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_deadline_timeout_while_queued_frees_slot():
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1})
    parker = Parker()
    s.add_plan_listener(parker)
    filler = _query(s, tag="q_fill").collect_async()
    try:
        assert parker.parked.acquire(timeout=20)
        doomed = _query(s, tag="q_doom").collect_async(timeout_ms=250)
        with pytest.raises(QueryTimeoutError):
            doomed.result(timeout=30)
        assert doomed.state is QueryState.TIMED_OUT
        assert s.scheduler.controller.stats()["queued"] == 0
        assert obsreg.get_registry().counter("sched.timedOut") >= 1
    finally:
        parker.release.set()
    filler.result(timeout=60)
    assert_clean(s)


def test_deadline_timeout_while_running_unwinds():
    s = _session()
    parker = Parker()
    s.add_plan_listener(parker)
    fut = _query(s).collect_async(timeout_ms=300)
    try:
        assert parker.parked.acquire(timeout=20)   # running, parked
        with pytest.raises(QueryTimeoutError):
            fut.result(timeout=30)
        assert fut.state is QueryState.TIMED_OUT
        assert fut.cancelled()
        assert_clean(s)
    finally:
        parker.release.set()


# ---------------------------------------------------------------------------
# cancellation: before admission and mid-scan, leak-free
# ---------------------------------------------------------------------------

def test_cancel_before_admission_leak_free():
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1})
    parker = Parker()
    s.add_plan_listener(parker)
    filler = _query(s, tag="q_fill").collect_async()
    try:
        assert parker.parked.acquire(timeout=20)
        queued = _query(s, tag="q_queued").collect_async()
        assert wait_until(
            lambda: s.scheduler.controller.stats()["queued"] >= 1)
        assert queued.cancel() is True
        with pytest.raises(QueryCancelledError):
            queued.result(timeout=30)
        assert queued.state is QueryState.CANCELLED
        assert s.scheduler.controller.stats()["queued"] == 0
    finally:
        parker.release.set()
    filler.result(timeout=60)
    # the slot the cancelled query never took is usable at once
    assert _query(s).collect().num_rows > 0
    assert "q_queued" not in parker.order   # never admitted
    assert_clean(s)


def test_cancel_mid_scan_unwinds_leak_free(tmp_path):
    """Cancel during a prefetching file scan: the prefetcher's thunks
    see the token, and no spill-catalog entry or admission/device slot
    leaks."""
    for i in range(4):
        papq.write_table(pa.table({
            "a": np.arange(500, dtype=np.int64) + i,
            "b": np.random.default_rng(i).uniform(size=500)}),
            str(tmp_path / f"p{i}.parquet"))
    s = _session({"spark.rapids.tpu.sql.scan.prefetch.depth": 2})
    cat_baseline = len(spill.get_catalog()._buffers)
    parker = Parker()
    s.add_plan_listener(parker)
    q = (s.read.parquet(str(tmp_path)).filter(col("b") > 0.5)
         .group_by("a").agg(F.count("*").alias("c")))
    fut = q.collect_async()
    try:
        assert parker.parked.acquire(timeout=30)
        # fire the token mid-flight; the query meets it at its next
        # checkpoint (planning is done, the scan is next)
        fut.cancel("mid-scan cancel")
    finally:
        parker.release.set()
    with pytest.raises(QueryCancelledError):
        fut.result(timeout=60)
    assert fut.state is QueryState.CANCELLED
    assert_clean(s)
    assert wait_until(
        lambda: not [t for t in threading.enumerate()
                     if t.name.startswith("scan-prefetch") and t.is_alive()]
        and len(spill.get_catalog()._buffers) <= cat_baseline, 10)
    s.remove_plan_listener(parker)
    assert q.collect().num_rows > 0       # nothing poisoned


def test_cancel_mid_scan_prefetcher_drains_unconsumed():
    """ScanPrefetcher under a cancelled token: queued thunks stop
    running, prepared results get their cleanup, get() raises."""
    from spark_rapids_tpu_torch.exec.scans import ScanPrefetcher
    cleaned = []
    started = threading.Event()
    gate = threading.Event()

    def thunk(i):
        def run():
            started.set()
            gate.wait(10)
            return f"prepared-{i}"
        return run

    tok = CancelToken()
    with sched_cancel.install(tok):
        pf = ScanPrefetcher([thunk(i) for i in range(6)], depth=2,
                            cleanup=cleaned.append)
    assert started.wait(10)
    tok.cancel("abandon scan")
    gate.set()                      # in-flight thunks finish preparing
    pf.close()                      # the consumer never drains: close frees
    time.sleep(0.2)
    assert all(c.startswith("prepared-") for c in cleaned)
    with sched_cancel.install(tok):
        with pytest.raises(QueryCancelledError):
            pf.get(5)


# ---------------------------------------------------------------------------
# single flight (the reference tests it through its serving tier)
# ---------------------------------------------------------------------------

def test_single_flight_joins_identical_submissions():
    s = _session()
    parker = Parker()
    s.add_plan_listener(parker)
    reg = obsreg.get_registry()
    est = 64 << 20      # the default estimate fills the CPU budget
    leader = _query(s, tag="q_sf").collect_async(estimate_bytes=est)
    try:
        assert parker.parked.acquire(timeout=20)
        follower = _query(s, tag="q_sf").collect_async(estimate_bytes=est)
        other = _query(s, tag="q_sf2").collect_async(  # other names
            estimate_bytes=est)
        assert parker.parked.acquire(timeout=20)
    finally:
        parker.release.set()
    a, b = leader.result(timeout=60), follower.result(timeout=60)
    other.result(timeout=60)
    assert a.equals(b)
    assert follower.dedup_of == leader.query_id
    assert reg.counter("sched.dedup.hits") == 1
    assert reg.counter("sched.dedup.flights") == 2
    assert parker.order.count("q_sf") == 1          # planned once
    prof = follower.profile
    assert prof.metrics["sched"]["sched.dedup.leaderQueryId"] == \
        leader.query_id
    assert prof.plan_digest == leader.profile.plan_digest
    rows = {r["query_id"]: r for r in s.scheduler.query_table()}
    assert rows[follower.query_id]["leader_query_id"] == leader.query_id
    assert_clean(s)


def test_single_flight_leader_cancel_promotes_follower():
    s = _session()
    parker = Parker()
    s.add_plan_listener(parker)
    reg = obsreg.get_registry()
    leader = _query(s, tag="q_pr").collect_async()
    try:
        assert parker.parked.acquire(timeout=20)
        follower = _query(s, tag="q_pr").collect_async()
        assert wait_until(lambda: follower.dedup_of is not None)
        assert leader.cancel("leader walks away") is True
        assert leader.state is QueryState.CANCELLED
    finally:
        parker.release.set()
    with pytest.raises(QueryCancelledError):
        leader.result(timeout=30)
    assert follower.result(timeout=60).num_rows > 0   # the flight ran on
    assert follower.state is QueryState.SUCCESS
    assert reg.counter("sched.dedup.promotions") == 1
    assert_clean(s)


def test_dedup_off_runs_each_submission():
    s = _session({"spark.rapids.tpu.sched.dedup.enabled": False})
    parker = Parker()
    s.add_plan_listener(parker)
    futs = [_query(s, tag="q_nd").collect_async(estimate_bytes=64 << 20)
            for _ in range(2)]
    try:
        for _ in range(2):
            assert parker.parked.acquire(timeout=20)
    finally:
        parker.release.set()
    a, b = (f.result(timeout=60) for f in futs)
    assert a.equals(b) and parker.order == ["q_nd", "q_nd"]
    assert obsreg.get_registry().counter("sched.dedup.hits") == 0
    assert_clean(s)


# ---------------------------------------------------------------------------
# estimate refinement end to end
# ---------------------------------------------------------------------------

def test_estimate_refines_from_observed_high_water():
    s = _session({"spark.rapids.tpu.sched.memoryBudget": 2 << 30})
    q = _query(s, n=600, tag="q_refine")
    first_est = s.scheduler._estimate(q.plan, None)
    q.collect()
    refined = s.scheduler.book.estimate(tadm.plan_shape_key(q.plan))
    if refined is not None:     # a batch was registered in the catalog
        assert refined <= first_est
        assert s.scheduler._estimate(q.plan, None) == min(
            refined, s.scheduler.memory_budget)
    assert s.scheduler._estimate(q.plan, 123 << 20) == 123 << 20
    # the derived budget is the grace join's: 8 GiB on the CPU
    assert _session().scheduler.memory_budget == devmgr.memory_budget("cpu")


def test_queue_wait_counted_once():
    """``sched.queueWaitNs`` equals the ledger's sum over tenants in the
    port; the reference bumps the counter in both admission and the
    service, so its counter is twice its ledger's (ROADMAP Queue C)."""
    from spark_rapids_tpu.obs import accounting as jacct
    from spark_rapids_tpu.obs import registry as jreg
    from spark_rapids_tpu_torch.obs import accounting as tacct
    sides = {"ref": (_oracle, jreg, jacct, jcol, JF),
             "port": (_session, obsreg, tacct, col, F)}
    ratio = {}
    for side, (make, reg_mod, acct, c, f) in sides.items():
        reg_mod.reset_registry()
        acct.reset()
        s = make({"spark.rapids.tpu.sched.maxConcurrent": 1})
        parker = Parker()
        s.add_plan_listener(parker)
        first = _query(s, tag="q_w1", c=c, f=f).collect_async()
        try:
            assert parker.parked.acquire(timeout=20)
            second = _query(s, tag="q_w2", c=c, f=f).collect_async()
            time.sleep(0.1)
        finally:
            parker.release.set()
        first.result(timeout=60)
        second.result(timeout=60)
        assert second.queue_wait_ns > 0
        billed = sum(r["usage"].get("sched.queueWaitNs", 0.0)
                     for r in acct.snapshot()["tenants"])
        assert billed == pytest.approx(second.queue_wait_ns)
        ratio[side] = reg_mod.get_registry().counter(
            "sched.queueWaitNs") / billed
        acct.reset()
        reg_mod.reset_registry()
    assert ratio == {"ref": pytest.approx(2.0), "port": pytest.approx(1.0)}
