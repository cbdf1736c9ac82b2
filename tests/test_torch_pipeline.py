"""The port's scan pipeline on the CPU: the prefetcher, the device
semaphore, and the fused reader that runs on both.

``exec/scans.ScanPrefetcher`` is held to the reference's semantics
(each result returned once, out-of-order consumers forcing submission, a
thunk's exception raised again at its ``get``, prepared-but-unconsumed
results released through ``cleanup`` by ``part_done``, ``close``, the GC
finalizer and a cancelled token), with the reference's own
``tests/test_scheduler.py`` cases ported.  ``mem/device.tpu_semaphore``
is held to its re-entrance and its counters.  Last, a port session
(``device="cpu"``) reads Parquet files with prefetching off and on and
must give the reference session's rows on the same conf
(``tests/test_scan_cache.py::test_prefetch_on_vs_off_collect_parity``),
launching one prefetch thunk and taking one semaphore slot per fused
batch; the PERFILE reader takes one slot per row group.  The copies
through pinned memory on the card are held by the ``cuda``-marked test
at the end, which skips without a GPU.

Tolerance: rows as ``tests/parity.py`` compares them (integers exact,
floats to rel 1e-9).
"""

import gc
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

from spark_rapids_tpu import TpuSparkSession as JSession

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.exec.base import Metrics
from spark_rapids_tpu_torch.exec.scans import ScanPrefetcher
from spark_rapids_tpu_torch.mem import device as devmgr
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.sched import cancel as sched_cancel
from spark_rapids_tpu_torch.sched.cancel import (CancelToken,
                                                 QueryCancelledError)

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401


def _counter(name: str) -> float:
    return obsreg.get_registry().counter(name)


# ---------------------------------------------------------------------------
# ScanPrefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_returns_each_result_once_out_of_order():
    """Consumers arrive out of order (partitions drain on a task pool):
    an index past the window forces its submission, every result comes
    back once, and the registry observes one prefetch per thunk."""
    ran = []
    lock = threading.Lock()

    def thunk(i):
        def run():
            with lock:
                ran.append(i)
            return i * i
        return run

    before = obsreg.get_registry().snapshot()["histograms"].get(
        "scan.prefetchNs", {"count": 0})["count"]
    pf = ScanPrefetcher([thunk(i) for i in range(6)], depth=2)
    order = [4, 0, 5, 1, 3, 2]
    assert [pf.get(i) for i in order] == [i * i for i in order]
    assert sorted(ran) == list(range(6))
    with pytest.raises(KeyError):
        pf.get(4)                       # handed out once
    after = obsreg.get_registry().snapshot()["histograms"][
        "scan.prefetchNs"]["count"]
    assert after - before == 6


def test_prefetcher_reraises_a_thunk_exception_at_its_get():
    def thunk(i):
        def run():
            if i == 1:
                raise ValueError("page walk failed")
            return i
        return run

    pf = ScanPrefetcher([thunk(i) for i in range(3)], depth=2)
    assert pf.get(0) == 0
    with pytest.raises(ValueError, match="page walk failed"):
        pf.get(1)
    assert pf.get(2) == 2


def test_prefetcher_counts_stalls_and_overlap():
    """A consumer that outruns the window stalls (counted per exec and in
    the registry); a prepared result that was ready overlaps in full."""
    release = threading.Event()

    def slow():
        release.wait(10)
        return "slow"

    m = Metrics()
    stalls0 = _counter("scan.prefetchStalls")
    overlap0 = _counter("scan.prefetchOverlapNs")
    pf = ScanPrefetcher([lambda: "fast", slow], depth=2, metrics=m)
    deadline = time.time() + 10
    while not pf._futures[0].done() and time.time() < deadline:
        time.sleep(0.01)                # the first thunk is ready
    assert pf.get(0) == "fast"
    threading.Timer(0.05, release.set).start()
    assert pf.get(1) == "slow"          # waits out the second
    assert m.extra["scan.prefetchStalls"] == 1
    assert _counter("scan.prefetchStalls") - stalls0 == 1
    assert _counter("scan.prefetchStallNs") > 0
    assert _counter("scan.prefetchOverlapNs") > overlap0


def test_part_done_and_close_release_unconsumed_results():
    """Once every partition is done, prepared results nobody consumed go
    through ``cleanup``; thunks past the window never run."""
    ran, cleaned = [], []

    def thunk(i):
        def run():
            ran.append(i)
            return f"prepared-{i}"
        return run

    pf = ScanPrefetcher([thunk(i) for i in range(5)], depth=3,
                        cleanup=cleaned.append)
    assert pf.get(0) == "prepared-0"
    deadline = time.time() + 10
    while len(ran) < 4 and time.time() < deadline:
        time.sleep(0.01)
    for _ in range(5):
        pf.part_done()
    assert sorted(cleaned) == [f"prepared-{i}" for i in (1, 2, 3)]
    assert sorted(ran) == [0, 1, 2, 3]
    pf.close()                          # idempotent
    assert len(cleaned) == 3


def test_gc_finalizer_releases_unconsumed_results():
    cleaned = []
    pf = ScanPrefetcher([lambda: "a", lambda: "b"], depth=2,
                        cleanup=cleaned.append)
    deadline = time.time() + 10
    while not all(f.done() for f in pf._futures.values()) and \
            time.time() < deadline:
        time.sleep(0.01)
    del pf
    gc.collect()
    assert sorted(cleaned) == ["a", "b"]


def test_cancel_mid_scan_prefetcher_drains_unconsumed():
    """ScanPrefetcher under a cancelled token: queued thunks stop
    running, prepared results get their cleanup, get() raises."""
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
    pf.close()                      # consumer never drains: close frees
    time.sleep(0.2)
    # the in-flight thunks' results were cleaned up, and thunks that had
    # not started yet either got cancelled or raised at their
    # cancellation checkpoint: nothing is left prepared
    assert all(c.startswith("prepared-") for c in cleaned)
    with sched_cancel.install(tok):
        with pytest.raises(QueryCancelledError):
            pf.get(5)


# ---------------------------------------------------------------------------
# tpu_semaphore
# ---------------------------------------------------------------------------

def test_semaphore_reentrant_same_thread_no_deadlock():
    devmgr.initialize(1)   # one slot: a second real acquire would hang
    try:
        m = Metrics()
        acquires0 = _counter("semaphore.acquires")
        with devmgr.tpu_semaphore(m):
            with devmgr.tpu_semaphore(m):    # scan-under-exchange shape
                with devmgr.tpu_semaphore(m):
                    pass
        assert m.extra.get("semaphore.acquires") == 1
        assert m.extra.get("semaphore.reentries") == 2
        assert _counter("semaphore.acquires") - acquires0 == 1
        assert devmgr._get().available() == 1         # fully released
    finally:
        devmgr.initialize(2)


def test_semaphore_reentry_blocked_ns_not_double_counted():
    """A re-entering holder logs no blocked-ns even while another thread
    waits on the slot; the waiter's wait is counted."""
    devmgr.initialize(1)
    try:
        holder, waiter = Metrics(), Metrics()
        entered, release = threading.Event(), threading.Event()
        wait0 = _counter("semaphore.waitNs")

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
        assert _counter("semaphore.waitNs") > wait0
    finally:
        devmgr.initialize(2)


def test_semaphore_raises_for_a_cancelled_query():
    tok = CancelToken()
    tok.cancel("gone")
    with sched_cancel.install(tok):
        with pytest.raises(QueryCancelledError):
            with devmgr.tpu_semaphore():
                pass
    assert devmgr._get().available() == devmgr._get().slots


# ---------------------------------------------------------------------------
# the fused reader on the pipeline, against the reference session
# ---------------------------------------------------------------------------

def _table(n=1024, seed=0):
    """Dict-encoded strings + nullable float/int + int keys."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64()),
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.2),
        "s": pa.array([f"name_{i % 17}" for i in range(n)]),
        "q": pa.array(rng.integers(0, 100, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    for i in range(4):
        papq.write_table(_table(seed=30 + i),
                         str(root / f"part-{i:02d}.parquet"),
                         row_group_size=512)
    return str(root)


BASE = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        # small reader batches force several fused groups so the
        # prefetch window actually pipelines: one per file, all of one
        # shape, so the reference compiles its decode once
        "spark.rapids.tpu.sql.reader.batchSizeRows": 1024}


def _scan_of(captured):
    scans = []
    captured[-1].foreach(lambda p: scans.append(p)
                         if type(p).__name__ == "TpuParquetScanExec"
                         else None)
    assert len(scans) == 1
    return scans[0]


def test_prefetch_on_vs_off_collect_parity(files):
    """Depth 0 and depth 3 give the same rows, which are the reference
    session's on the same conf; with prefetching on, every fused batch
    is one prefetch thunk and one semaphore slot."""
    off = dict(BASE, **{"spark.rapids.tpu.sql.scan.prefetch.depth": 0,
                        "spark.rapids.tpu.sql.scan.hostPrep.threads": 1})
    on = dict(BASE, **{"spark.rapids.tpu.sql.scan.prefetch.depth": 3,
                       "spark.rapids.tpu.sql.scan.hostPrep.threads": 4})
    t_off = TSession(off, device="cpu").read.parquet(files).collect()
    t_ref = JSession(on).read.parquet(files).collect()

    captured = []
    s_on = TSession(on, device="cpu")
    s_on.add_plan_listener(lambda r: captured.append(r.plan))
    hist0 = obsreg.get_registry().snapshot()["histograms"].get(
        "scan.prefetchNs", {"count": 0})["count"]
    t_on = s_on.read.parquet(files).collect()
    assert_tables_equal(t_on, t_off)
    assert_tables_equal(t_on, t_ref)

    scan = _scan_of(captured)
    extra = scan.metrics.extra
    groups = len(scan._fused_groups())
    assert groups >= 2
    assert extra["semaphore.acquires"] == groups
    assert obsreg.get_registry().snapshot()["histograms"][
        "scan.prefetchNs"]["count"] - hist0 == groups
    assert "scan.hostPrepTime" in extra and "scan.uploadTime" in extra
    assert extra.get("scan.planCacheMisses", 0) + \
        extra.get("scan.planCacheHits", 0) > 0


def test_perfile_reader_decodes_each_row_group_under_the_semaphore(files):
    captured = []
    s = TSession(dict(BASE, **{
        "spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled": False}),
        device="cpu")
    s.add_plan_listener(lambda r: captured.append(r.plan))
    got = s.read.parquet(files).collect()
    want = papq.read_table(files)
    assert got.num_rows == want.num_rows
    scan = _scan_of(captured)
    n_rg = sum(papq.ParquetFile(f"{files}/part-{i:02d}.parquet")
               .metadata.num_row_groups for i in range(4))
    assert scan.metrics.extra["semaphore.acquires"] == n_rg


@pytest.mark.cuda
def test_pinned_uploads_on_the_copy_stream_round_trip():
    """On the card: the fused upload set and an Arrow batch go through
    pinned memory on a copy stream, the consumer waits on the event, and
    the bytes come back as they went."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spark_rapids_tpu_torch.columnar import batch as tbatch
    from spark_rapids_tpu_torch.columnar.interop import fused_arrays_to_torch
    from spark_rapids_tpu_torch.columnar.transfer import (CopyStream,
                                                          PinnedUpload)
    cs = CopyStream("cuda")
    rng = np.random.default_rng(3)
    arrays = {"a": rng.integers(0, 1 << 30, 1 << 20).astype(np.int32),
              "b": rng.integers(0, 256, 12345).astype(np.uint8)}
    up = fused_arrays_to_torch(arrays, "cuda", cs)
    assert isinstance(up, PinnedUpload)
    assert all(t.is_pinned() for t in up.pinned)
    up.wait()
    for k, v in arrays.items():
        np.testing.assert_array_equal(up[k].cpu().numpy(), v)
    t = _table()
    b = tbatch.from_arrow(t, device="cuda", copy_stream=cs)
    assert_tables_equal(tbatch.to_arrow(b), t)
    torch.cuda.synchronize()
    cs.sweep()
    assert cs.peak_held_bytes > 0
