"""The port's spill catalog and host arena against the reference's.

The catalog's tiers (device -> host -> disk -> device, bit for bit), its
budgets, priorities, ``release``, the high-water tracker,
``register_or_hold`` with spill off, ``handle_memory_pressure`` over a
registered spiller and ``hbm_oom_recover`` on a constructed
``torch.cuda.OutOfMemoryError`` (the reference's tests of
``tests/test_memory.py``, with the reference's catalog on the same
batches where the two can be compared); the ``HostArena`` against the
reference's native arena on the same sequence of calls; and an aggregate
forced through the spill path on a port session, against the reference's
CPU session.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.columnar.batch import to_arrow as jto_arrow
from spark_rapids_tpu.mem import spill as jspill
from spark_rapids_tpu.mem.host_arena import HostArena as JArena

from spark_rapids_tpu_torch.columnar.batch import from_arrow, to_arrow
from spark_rapids_tpu_torch.mem import spill
from spark_rapids_tpu_torch.mem.host_arena import HostArena
from spark_rapids_tpu_torch.mem.spill import (ACTIVE_BATCHING_PRIORITY,
                                              OUTPUT_FOR_SHUFFLE_PRIORITY,
                                              BufferCatalog, StorageTier)
from spark_rapids_tpu_torch.obs import registry as obsreg

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401


def _table(n=100, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
        "s": pa.array([None if i % 7 == 0 else f"row{i}" for i in range(n)]),
        "f": pa.array(rng.normal(size=n)),
        "l": pa.array([[i, i + 1] if i % 3 else [] for i in range(n)]),
    })


def _batch(n=100, seed=0):
    t = _table(n, seed)
    return t, from_arrow(t, device="cpu")


def _same_tensors(a, b) -> bool:
    """Every buffer of two batches equal, hints included."""
    if a.names != b.names or int(a.num_rows) != int(b.num_rows):
        return False
    for x, y in zip(a.columns, b.columns):
        if (x.dtype, x.vbits, x.nonnull) != (y.dtype, y.vbits, y.nonnull):
            return False
        for p, q in ((x.data, y.data), (x.validity, y.validity),
                     (x.lengths, y.lengths),
                     (x.elem_validity, y.elem_validity)):
            if (p is None) != (q is None):
                return False
            if p is not None and not (p.dtype == q.dtype and
                                      torch.equal(p, q)):
                return False
    return True


@pytest.fixture
def spill_dir(tmp_path):
    return str(tmp_path / "spill")


@pytest.mark.parametrize("host_budget", [1 << 30, 1],
                         ids=["host", "disk"])
def test_tiers_round_trip_bit_for_bit(spill_dir, host_budget):
    """device -> host (-> disk) -> device gives back every buffer, and
    the reference's catalog gives back the same rows."""
    t, b = _batch()
    cat = BufferCatalog(device_budget=1 << 30, host_budget=host_budget,
                        spill_dir=spill_dir, device="cpu")
    h = cat.register(b)
    assert h.tier == StorageTier.DEVICE
    assert cat.spill_to_fit(1) == b.nbytes()
    want = StorageTier.HOST if host_budget > 1 else StorageTier.DISK
    assert h.tier == want
    assert cat.device_bytes == 0
    got = h.get()
    assert h.tier == StorageTier.DEVICE
    assert _same_tensors(b, got)
    h.close()
    assert cat.device_bytes == cat.host_bytes == 0

    jcat = jspill.BufferCatalog(device_budget=1 << 30,
                                host_budget=host_budget,
                                spill_dir=spill_dir)
    jt = t.drop(["l"])              # the reference spills flat columns
    jh = jcat.register(jfrom_arrow(jt))
    jcat.spill_to_fit(1)
    assert int(jh.tier) == int(want)
    assert to_arrow(got).drop(["l"]).equals(jto_arrow(jh.get()))
    jh.close()


def test_budget_triggers_automatic_spill():
    _, b1 = _batch(200, seed=1)
    size = b1.nbytes()
    cat = BufferCatalog(device_budget=int(size * 1.5), host_budget=1 << 30,
                        device="cpu")
    h1 = cat.register(b1)
    _, b2 = _batch(200, seed=2)
    h2 = cat.register(b2)  # over budget: the lowest priority spills
    assert StorageTier.HOST in {h1.tier, h2.tier}
    assert cat.device_bytes <= cat.device_budget
    assert cat.spilled_device_bytes == size
    h1.close()
    h2.close()


def test_spill_priority_order():
    _, b1 = _batch(100, seed=1)
    _, b2 = _batch(100, seed=2)
    cat = BufferCatalog(device_budget=1 << 30, host_budget=1 << 30,
                        device="cpu")
    h_shuffle = cat.register(b1, OUTPUT_FOR_SHUFFLE_PRIORITY)
    h_active = cat.register(b2, ACTIVE_BATCHING_PRIORITY)
    cat.spill_to_fit(1)  # one spill: the shuffle output goes first
    assert h_shuffle.tier == StorageTier.HOST
    assert h_active.tier == StorageTier.DEVICE
    h_shuffle.close()
    h_active.close()


def test_release_and_high_water():
    _, b = _batch(100)
    cat = BufferCatalog(device="cpu")
    hw = cat.track_high_water()
    h = cat.register(b)
    h2 = cat.register(b)
    assert cat.device_bytes == 2 * b.nbytes() == hw.peak() == hw.delta()
    h.close()
    h2.close()
    assert cat.device_bytes == 0 and cat.num_buffers() == 0
    assert hw.peak() == 2 * b.nbytes()
    hw.close()
    # a closed window no longer moves
    h3 = cat.register(b)
    h3.spill()
    h3.get()
    assert hw.peak() == 2 * b.nbytes()
    h3.close()


def test_register_or_hold_with_spill_off():
    _, b = _batch(50)
    try:
        spill.disable_catalog()
        h = spill.register_or_hold(b)
        assert isinstance(h, spill.PlainBatchHandle)
        assert h.get() is b and h.spill() == 0
        assert h.tier == StorageTier.DEVICE
        h.close()
    finally:
        spill.init_catalog(4 << 30, 8 << 30, device="cpu")
    h = spill.register_or_hold(b)
    assert isinstance(h, spill.SpillableBatch)
    h.close()


class _Spiller:
    def __init__(self):
        self.asked = []

    def pressure_spill(self, n):
        self.asked.append(n)
        return 1000


def test_handle_memory_pressure_reaches_a_registered_spiller():
    obsreg.reset_registry()
    # the process-wide shared-scan window is a registered spiller too
    # (io/scan_share.py): empty, it frees nothing and the pressure
    # reaches this test's spiller
    from spark_rapids_tpu_torch.io import scan_share
    if scan_share.peek_share() is not None:
        scan_share.peek_share().clear()
    cat = spill.init_catalog(1 << 30, 1 << 30, device="cpu")
    _, b = _batch(100)
    h = cat.register(b)
    sp = _Spiller()
    spill.register_pressure_spiller(sp)
    # the device tier covers part of it, the spiller the rest
    freed = spill.handle_memory_pressure(b.nbytes() + 500)
    assert h.tier == StorageTier.HOST
    assert sp.asked == [500]
    assert freed == b.nbytes() + 1000
    c = obsreg.get_registry().snapshot()["counters"]
    assert c["spill.pressureDeviceBytes"] == b.nbytes()
    assert c["spill.pressureAuxBytes"] == 1000
    h.close()
    del sp                      # held by weakref only
    assert spill.handle_memory_pressure(1) == 0
    spill.disable_catalog()
    try:
        assert spill.handle_memory_pressure(1 << 20) == 0
    finally:
        spill.init_catalog(4 << 30, 8 << 30, device="cpu")


def test_hbm_oom_recover_on_a_cuda_oom():
    obsreg.reset_registry()
    cat = spill.init_catalog(1 << 30, 1 << 30, device="cpu")
    _, b = _batch(256)
    h = cat.register(b)
    oom = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB")
    assert spill.hbm_oom_recover(oom)
    assert h.tier == StorageTier.HOST
    assert cat.spilled_device_bytes == b.nbytes()
    assert obsreg.get_registry().counter("mem.oomRetries") == 1
    # nothing left on the device: no bytes freed, no retry
    assert not spill.hbm_oom_recover(oom)
    # the reference's message test still holds; other errors never retry
    h.get()
    assert spill.hbm_oom_recover(RuntimeError("RESOURCE_EXHAUSTED: x"))
    assert not spill.hbm_oom_recover(ValueError("unrelated failure"))
    assert _same_tensors(b, h.get())
    h.close()


_ARENA_CALLS = [("alloc", 1000), ("alloc", 2000), ("alloc", 4000),
                ("free", 1), ("alloc", 100), ("alloc", 1900),
                ("free", 0), ("free", 2), ("alloc", 5000),
                ("alloc", 1 << 15), ("alloc", 1 << 16), ("free", 4),
                ("alloc", 64), ("alloc", 0), ("free", 5), ("free", 7),
                ("alloc", 3), ("free", 3)]


@pytest.mark.parametrize("alignment", [64, 8, 48])
def test_host_arena_matches_the_reference(alignment):
    """First fit, alignment, None on exhaustion, coalescing and peak: the
    same calls give the same offsets and counters in both arenas."""
    arenas = (HostArena(1 << 16, alignment), JArena(1 << 16, alignment))
    assert arenas[1].native
    logs = []
    for a in arenas:
        live, log = [], []
        base = None
        for op, arg in _ARENA_CALLS:
            if op == "alloc":
                al = a.alloc(arg)
                live.append(al)
                if al is None:
                    log.append(None)
                    continue
                addr = al.offset if isinstance(a, HostArena) else al._ptr
                base = addr if base is None else base
                log.append(addr - base if isinstance(a, JArena) else addr)
            elif live[arg] is not None:
                live[arg].close()
            log.append((a.allocated, a.peak, a.largest_free, a.num_live))
        logs.append(log)
        for al in live:
            if al is not None:
                al.close()
        assert a.allocated == 0 and a.num_live == 0
        assert a.largest_free == a.capacity
        a.close()
    assert logs[0] == logs[1]


def test_host_arena_numpy_view():
    a = HostArena(1 << 12)
    al = a.alloc(800)
    arr = al.as_numpy(np.int64, (100,))
    arr[:] = np.arange(100)
    assert al.as_tensor()[:800].view(torch.int64).sum() == 4950
    al.close()
    a.close()
    assert a.alloc(8) is None


def test_aggregate_under_a_tiny_device_budget():
    """Every buffered partial goes through the spill path; the rows equal
    the reference's CPU session."""
    from spark_rapids_tpu import TpuSparkSession as JSession
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
    from spark_rapids_tpu_torch.api import functions as TF
    rng = np.random.default_rng(3)
    t = pa.table({"k": pa.array(rng.integers(0, 10, 500), type=pa.int32()),
                  "v": pa.array(rng.integers(0, 100, 500), type=pa.int64())})
    s = TSession({"spark.rapids.tpu.memory.device.batchStorageSize": 1,
                  "spark.rapids.tpu.sql.variableFloatAgg.enabled": True},
                 device="cpu")
    got = s.create_dataframe(t, num_partitions=4).group_by("k").agg(
        TF.sum("v").alias("s"), TF.count("*").alias("c")).collect()
    cat = spill.get_catalog()
    assert cat.spilled_device_bytes > 0 and cat.num_buffers() == 0
    want = JSession({"spark.rapids.tpu.sql.enabled": False}) \
        .create_dataframe(t, num_partitions=4).group_by("k").agg(
            JF.sum("v").alias("s"), JF.count("*").alias("c")).collect()
    assert_tables_equal(want, got, ignore_order=True)


def test_session_initialises_the_catalog():
    from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
    TSession({}, device="cpu")
    assert spill.is_enabled()
    cat = spill.get_catalog()
    assert (cat.device_budget, cat.host_budget) == (4 << 30, 8 << 30)
    TSession({"spark.rapids.tpu.memory.spill.enabled": False}, device="cpu")
    assert not spill.is_enabled()
    TSession({"spark.rapids.tpu.memory.device.batchStorageSize": 1 << 20},
             device="cpu")
    assert spill.is_enabled()
    assert spill.get_catalog().device_budget == 1 << 20


def test_a_broadcast_join_leaves_the_catalog_empty():
    """The broadcast build side is held through a spill handle while the
    stream partitions probe it, and released when the last one ends."""
    from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
    from spark_rapids_tpu_torch.api import col
    s = TSession({"spark.rapids.tpu.sql.variableFloatAgg.enabled": True},
                 device="cpu")
    big = s.create_dataframe(pa.table({"k": np.arange(400) % 13,
                                       "v": np.arange(400)}),
                             num_partitions=4)
    small = s.create_dataframe(pa.table({"k2": np.arange(13),
                                         "w": np.arange(13) * 2}))
    df = big.join(small, col("k") == col("k2"))
    assert "TpuBroadcastHashJoinExec" in df.explain_string("physical")
    assert df.collect().num_rows == 400
    assert spill.get_catalog().num_buffers() == 0
