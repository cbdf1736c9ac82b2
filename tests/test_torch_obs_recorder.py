"""The port's flight recorder, slow-query log and JSONL rotation against
the reference's.

- The event ring is bounded and a disabled recorder records nothing.
- ``_classify`` names the same bundle reason for each failure type.
- A failed query leaves a bundle of the five files, and a query during
  which ``mem.oomRetries`` moves leaves an ``oom-retry`` bundle, as in
  the reference.
- The grace join of ``tests/test_torch_join_oocore.py``'s configuration
  records the reference's ordered ``join.*`` / ``spill.*`` events, whose
  spill bytes sum to each package's own ``spill.deviceToHostBytes``
  delta.
- The slow-query record has the reference's keys, the threshold filters,
  and ``rotating_append`` keeps one generation.

Every query runs on a port session with ``device="cpu"`` and on a
reference session with the same conf.
"""

import json
import logging
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu.columnar.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.mem import spill as jspill
from spark_rapids_tpu.obs import jsonl as jjsonl
from spark_rapids_tpu.obs import recorder as jrec
from spark_rapids_tpu.obs import registry as jreg
from spark_rapids_tpu.sched import cancel as jcancel

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.columnar.batch import from_arrow as tfrom_arrow
from spark_rapids_tpu_torch.mem import spill as tspill
from spark_rapids_tpu_torch.obs import jsonl as tjsonl
from spark_rapids_tpu_torch.obs import recorder as trec
from spark_rapids_tpu_torch.obs import registry as treg
from spark_rapids_tpu_torch.sched import cancel as tcancel

from tests.test_torch_join_oocore import _BUDGET, _NO_BCAST, _join, _zipf_tables
from tests.torch_threads import one_torch_thread  # noqa: F401

BUNDLE_FILES = ["config.json", "events.jsonl", "profile.json",
                "registry.json", "trace.json"]
SLOW_KEYS = ("ts_unix", "threshold_ms", "session_id", "queue_wait_s",
             "kernels_compiled", "compile_ms", "query_id", "plan_digest",
             "status", "error", "wall_s", "result_rows", "phases",
             "wall_breakdown")


class _Side:
    def __init__(self, name, S, col, rec, reg, spill, cancel, from_arrow,
                 jsonl, kw):
        self.name, self.S, self.col, self.rec, self.reg = \
            name, S, col, rec, reg
        self.spill, self.cancel, self.from_arrow = spill, cancel, from_arrow
        self.jsonl, self.kw = jsonl, kw

    def session(self, conf):
        return self.S(conf, **self.kw)


SIDES = {"ref": _Side("ref", JSession, jcol, jrec, jreg, jspill, jcancel,
                      lambda t: jfrom_arrow(t), jjsonl, {}),
         "port": _Side("port", TSession, tcol, trec, treg, tspill, tcancel,
                       lambda t: tfrom_arrow(t, device="cpu"), tjsonl,
                       {"device": "cpu"})}


@pytest.fixture(autouse=True)
def _recorders_off():
    """The recorder is process-wide: leave both packages' disabled."""
    yield
    for side in SIDES.values():
        side.rec.disable()


def _table(n=200, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 9, n).astype(np.int64),
                     "v": rng.integers(0, 500, n).astype(np.int64)})


def _host_query(s):
    """A bare in-memory scan: a host scan in both packages, no device."""
    return s.create_dataframe(_table())


@pytest.mark.parametrize("side", list(SIDES))
def test_ring_is_bounded_and_disabled_records_nothing(side, tmp_path):
    rec = SIDES[side].rec
    r = rec.configure(str(tmp_path), max_events=32)
    for i in range(200):
        rec.record_event("test.evt", i=i)
    evts = r.events()
    assert len(evts) == 32
    assert [evts[0]["i"], evts[-1]["i"]] == [168, 199]
    assert all("ts_unix" in e and "t_ns" in e for e in evts)
    rec.disable()
    rec.record_event("test.evt", i=-1)
    assert rec.get_recorder() is None and not rec.is_enabled()
    assert len(r.events()) == 32


def test_ring_under_concurrent_writers(tmp_path):
    """Spill events fire on prefetch and task threads: no event is lost
    while bundles snapshot the ring."""
    import sys
    import threading
    r = trec.configure(str(tmp_path), max_events=1 << 16)
    n_threads, per = 8, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write(k):
            for i in range(per):
                trec.record_event("test.evt", thread=k, i=i)
        threads = [threading.Thread(target=write, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        snapshots = [len(r.events()) for _ in range(20)]
        for th in threads:
            th.join(30)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    evts = r.events()
    assert len(evts) == n_threads * per
    assert snapshots == sorted(snapshots)
    for k in range(n_threads):
        assert [e["i"] for e in evts if e["thread"] == k] == list(range(per))


class QueryRejectedError(RuntimeError):
    """A stand-in for ``sched/admission.QueryRejectedError``: the
    recorder classifies by type name."""


@pytest.mark.parametrize("exc", ["QueryTimeoutError", "QueryCancelledError",
                                 "QueryRejectedError", "ValueError", None])
def test_classify_names_the_references_reason(exc):
    def make(side):
        if exc is None:
            return None
        if exc == "QueryRejectedError":
            return QueryRejectedError("queue full")
        if exc == "ValueError":
            return ValueError("boom")
        return getattr(SIDES[side].cancel, exc)("x")
    assert trec._classify(make("port")) == jrec._classify(make("ref"))


def _bundles(root):
    return sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d)))


def _failure_bundle(side, tmp_path):
    rec_dir = str(tmp_path / side.name / "rec")
    data = str(tmp_path / side.name / "data")
    os.makedirs(data)
    path = os.path.join(data, "p0.parquet")
    papq.write_table(_table(), path)
    s = side.session({"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
                      "spark.rapids.tpu.obs.recorder.dir": rec_dir})
    assert s.flight_recorder is not None
    df = s.read.parquet(data)
    os.unlink(path)
    with pytest.raises(Exception):
        df.collect()
    return rec_dir


def test_failure_bundle_holds_the_five_files(tmp_path):
    got = {}
    for name, side in SIDES.items():
        rec_dir = _failure_bundle(side, tmp_path)
        bundles = _bundles(rec_dir)
        assert len(bundles) == 1 and "-failure-" in bundles[0], bundles
        bundle = os.path.join(rec_dir, bundles[0])
        got[name] = sorted(os.listdir(bundle))
        if name == "port":
            prof = json.load(open(os.path.join(bundle, "profile.json")))
            assert prof["status"] == "failure" and prof["error"]
            assert prof["plan"] is not None
            conf = json.load(open(os.path.join(bundle, "config.json")))
            assert conf["spark.rapids.tpu.obs.recorder.dir"] == rec_dir
            reg = json.load(open(os.path.join(bundle, "registry.json")))
            assert "counters" in reg and "gauges" in reg
            assert "traceEvents" in json.load(
                open(os.path.join(bundle, "trace.json")))
            for line in open(os.path.join(bundle, "events.jsonl")):
                assert "kind" in json.loads(line)
    assert got["port"] == got["ref"] == BUNDLE_FILES


def _oom_retry_run(side, rec_dir):
    """A query whose window moves ``mem.oomRetries``: its plan listener
    registers a batch and recovers from a simulated device OOM."""
    s = side.session({"spark.rapids.tpu.obs.recorder.dir": rec_dir})

    def oom(_result):
        h = side.spill.get_catalog().register(side.from_arrow(_table(64)))
        assert side.spill.hbm_oom_recover(
            RuntimeError("RESOURCE_EXHAUSTED: out of memory (simulated)"))
        h.close()
    s.add_plan_listener(oom)
    _host_query(s).collect()
    kinds = [e["kind"] for e in s.flight_recorder.events()]
    spill_section = s.last_query_profile().metrics["spill"]
    s.remove_plan_listener(oom)
    _host_query(s).collect()    # no retry: no second bundle
    return _bundles(rec_dir), kinds, spill_section


def test_oom_retry_bundle(tmp_path):
    got = {name: _oom_retry_run(side, str(tmp_path / name))
           for name, side in SIDES.items()}
    for name, (bundles, kinds, _) in got.items():
        assert len(bundles) == 1 and "-oom-retry-" in bundles[0], \
            (name, bundles)
        assert "mem.oomRetry" in kinds and "spill.deviceToHost" in kinds
    # the reference also records its query service's sched.* events
    mem = {name: [k for k in kinds if k.startswith(("spill.", "mem."))]
           for name, (_, kinds, _) in got.items()}
    assert mem["port"] == mem["ref"] == ["spill.deviceToHost",
                                         "mem.oomRetry"]
    # the spill went through the host arena, whose peak the profile reads
    # without making an arena
    assert got["port"][2]["spill.arenaPeakBytes"] > 0


def _grace_events(side, rec_dir):
    left, right = _zipf_tables()
    # one task thread, so the partitions' events come in one order
    s = side.session(dict(_NO_BCAST, **{
        _BUDGET: 2 << 10, "spark.rapids.tpu.sql.concurrentTpuTasks": 1,
        "spark.rapids.tpu.obs.recorder.dir": rec_dir}))
    view = side.reg.get_registry().view()
    out = _join(s, side.col, left, right).collect()
    delta = view.delta()["counters"]
    events = [e for e in s.flight_recorder.events()
              if e["kind"].startswith(("join.", "spill."))]
    return out, events, delta


def test_grace_join_events_are_the_references(tmp_path):
    got = {name: _grace_events(side, str(tmp_path / name))
           for name, side in SIDES.items()}
    assert got["port"][0].num_rows == got["ref"][0].num_rows
    kinds = {name: [e["kind"] for e in ev] for name, (_, ev, _) in
             got.items()}
    assert kinds["port"] == kinds["ref"]
    assert {"join.graceActivated", "join.graceRecurse",
            "spill.deviceToHost"} <= set(kinds["port"])
    for name, (_, events, delta) in got.items():
        spilled = sum(e["bytes"] for e in events
                      if e["kind"] == "spill.deviceToHost")
        assert spilled == delta["spill.deviceToHostBytes"] > 0, name
        for e in events:
            if e["kind"] == "join.graceActivated":
                assert e["buildBytes"] > e["budget"] == 2 << 10


def _slow_records(side, path, threshold_ms):
    s = side.session({"spark.rapids.tpu.obs.slowQueryMs": threshold_ms,
                      "spark.rapids.tpu.obs.slowQueryPath": path})
    # every query takes at least 2 ms: its planning sleeps
    s.add_plan_listener(lambda _result: time.sleep(0.002))
    _host_query(s).collect()
    _host_query(s).collect()
    if not os.path.exists(path):
        return []
    return [json.loads(line) for line in open(path)]


def test_slow_query_log_has_the_references_keys(tmp_path):
    got = {name: _slow_records(side, str(tmp_path / f"{name}.jsonl"), 1)
           for name, side in SIDES.items()}
    assert sorted(got["ref"][0]) == sorted(SLOW_KEYS)
    for rec in got["port"]:
        assert sorted(rec) == sorted(got["ref"][0])
        assert rec["status"] == "success" and rec["wall_s"] >= 0.001
        assert rec["result_rows"] == 200
        # no obs/compile.py in the port: the reference's null for a query
        # its compile ledger never saw
        assert rec["kernels_compiled"] is None and rec["compile_ms"] is None
    assert len(got["port"]) == len(got["ref"]) == 2


def test_slow_query_threshold_filters(tmp_path):
    for name, side in SIDES.items():
        assert _slow_records(side, str(tmp_path / f"{name}.jsonl"),
                             10 ** 9) == []


@pytest.mark.parametrize("side", list(SIDES))
def test_rotating_append_keeps_one_generation(side, tmp_path):
    path = str(tmp_path / "log.jsonl")
    for i in range(6):
        SIDES[side].jsonl.rotating_append(path, f"record-{i}", max_bytes=20)
    # two 9-byte records fit in 20 bytes: the third starts a new file
    assert open(path).read().splitlines() == ["record-4", "record-5"]
    assert open(path + ".1").read().splitlines() == ["record-2", "record-3"]
    assert sorted(os.listdir(tmp_path)) == ["log.jsonl", "log.jsonl.1"]


def test_a_session_without_a_recorder_leaves_it_alone(tmp_path, caplog):
    first = TSession({"spark.rapids.tpu.obs.recorder.dir": str(tmp_path)},
                     device="cpu")
    TSession({}, device="cpu")
    assert trec.get_recorder() is first.flight_recorder is not None
    with caplog.at_level(logging.WARNING, "spark_rapids_tpu_torch.obs"):
        TSession({"spark.rapids.tpu.obs.profile.enabled": False,
                  "spark.rapids.tpu.obs.slowQueryMs": 5}, device="cpu")
    assert "obs.profile.enabled=false" in caplog.text
