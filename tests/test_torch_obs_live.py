"""The port's live telemetry endpoint (obs/server.py) against the
reference's.

``tests/test_obs_live.py``'s endpoint, query-table and slow-query cases
(:60-160, :351-385) on port sessions (``device="cpu"``): the Prometheus
rendering (the same text as the reference's for the same snapshot), the
routes over localhost, the endpoint off by default, the live query table
through a one-slot engine, and the slow-query log; with them
``tests/test_obs_accounting.py``'s strict-linter case (:110).  The port
adds the ``/resultcache`` pin: with ``serve/`` not ported the route
answers the reference's payload for an empty cache.  The fault-injection and
process-stitching cases need the ``process`` transport (ROADMAP Queue A
item 8); the donation guard (:414) tests a jax 0.4.37 workaround that the
port has no counterpart for.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.obs import registry as jreg
from spark_rapids_tpu.obs import server as jserver

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.obs.server import (lint_exposition,
                                               parse_prometheus,
                                               render_prometheus)

from tests.torch_sched import join_query_threads  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


@pytest.fixture(autouse=True)
def _clean_obs_state():
    yield
    obsrec.disable()


def _session(extra=None):
    return TSession(dict(CONF, **(extra or {})), device="cpu")


def _get(port, path, timeout=10):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, r.read().decode()


def _data(n=500, seed=5):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 9, n).astype(np.int64)),
        "v": pa.array(rng.integers(0, 500, n).astype(np.int64)),
    })


def _agg(s, t, parts=3):
    return (s.create_dataframe(t, num_partitions=parts)
            .group_by("k")
            .agg(F.count("*").alias("c"), F.sum("v").alias("sv")))


def _fill(reg):
    reg.inc("scan.planCacheHits", 7)
    reg.set_gauge("sched.admittedBytes", 123456789)
    reg.observe("sched.queueWait", 2.5e6)
    reg.observe("sched.queueWait", 1.5e6)
    for v in (0.5, 12.0, 40.0, 9000.0):
        reg.observe_bucket("slo.latencyMs", v)


def test_prometheus_rendering_parses_and_sanitizes():
    reg = obsreg.MetricsRegistry()
    _fill(reg)
    text = render_prometheus(reg.snapshot())
    samples = parse_prometheus(text)
    assert samples["spark_rapids_tpu_scan_planCacheHits"] == 7
    assert samples["spark_rapids_tpu_sched_admittedBytes"] == 123456789
    assert samples["spark_rapids_tpu_sched_queueWait_count"] == 2
    assert samples["spark_rapids_tpu_sched_queueWait_sum"] == 4e6
    assert "." not in text.split(" ")[0]
    assert "# TYPE spark_rapids_tpu_scan_planCacheHits counter" in text
    # the same snapshot renders, parses and lints to the reference's
    jr = jreg.MetricsRegistry()
    _fill(jr)
    assert text == jserver.render_prometheus(jr.snapshot())
    assert lint_exposition(text) == jserver.lint_exposition(text)
    for bad in ("", "x 1 2\n", "name with space 1\n"):
        with pytest.raises(ValueError):
            parse_prometheus(bad)
        with pytest.raises(ValueError):
            jserver.parse_prometheus(bad)


_GOOD_HISTOGRAM = ("# TYPE m histogram\n"
                   'm_bucket{le="1"} 1\nm_bucket{le="+Inf"} 2\n'
                   "m_sum 3\nm_count 2\n")


@pytest.mark.parametrize("bad", [
    "loose_metric 1\n",                                       # no TYPE
    _GOOD_HISTOGRAM.replace('le="1"} 1', 'le="1"} 5'),        # not cumulative
    _GOOD_HISTOGRAM.replace("m_count 2", "m_count 9"),        # +Inf != count
    "# TYPE m histogram\n"
    'm_bucket{le="1"} 1\nm_sum 1\nm_count 1\n',               # no +Inf
], ids=["untyped", "noncumulative", "inf_ne_count", "no_inf"])
def test_exposition_linter_rejects_malformed(bad):
    """tests/test_obs_accounting.py:110: the strict linter accepts a
    well-formed histogram and rejects each malformed one, as the
    reference's does."""
    assert lint_exposition(_GOOD_HISTOGRAM) == \
        jserver.lint_exposition(_GOOD_HISTOGRAM)
    for lint in (lint_exposition, jserver.lint_exposition):
        with pytest.raises(ValueError):
            lint(bad)


def test_http_endpoint_routes_and_profile_ring():
    s = _session({"spark.rapids.tpu.obs.http.enabled": True})
    try:
        port = s.obs_server.port
        assert port > 0
        code, body = _get(port, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["ok"] and health["state"] == "serving"

        fut = s.submit(_agg(s, _data()))
        assert fut.result(timeout=60).num_rows

        code, body = _get(port, "/metrics")
        assert code == 200
        samples = lint_exposition(body)
        assert samples["spark_rapids_tpu_sched_submitted"] >= 1
        assert samples["spark_rapids_tpu_sched_running"] == 0

        code, body = _get(port, "/queries")
        mine = [r for r in json.loads(body)["queries"]
                if r["query_id"] == fut.query_id]
        assert mine and mine[0]["state"] == "success"
        for key in ("estimate_bytes", "queue_wait_ms", "priority",
                    "plan_digest"):
            assert key in mine[0]

        code, body = _get(port, f"/profiles/{fut.query_id}")
        prof = json.loads(body)
        assert prof["query_id"] == fut.query_id
        assert prof["status"] == "success"
        assert "wall_breakdown" in prof

        code, body = _get(port, "/compiles?n=4")
        comp = json.loads(body)
        assert {"totals", "events", "selection"} <= set(comp)
        assert len(comp["events"]) <= 4

        for bad in ("/profiles/999999", "/profiles/zzz", "/nope"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(port, bad)
            assert e.value.code == 404
    finally:
        s.obs_server.shutdown()


def test_compiles_selection_reports_launches_and_fallbacks():
    """The /compiles selection block carries the port's fallback counts
    under the reference's names and each hand kernel's launches."""
    from spark_rapids_tpu_torch.kernels import backend as kb
    kb.reset_counts()
    try:
        kb.record_fallback("segreduce", "dtype")
        kb.record_fallback("segreduce", "dtype")
        kb.record_launch("decode.unpack_bits")
        assert kb.selection_snapshot() == {
            "kernel.backend.launches.decode.unpack_bits": 1,
            "kernel.backend.pallas.fallbacks": 2,
            "kernel.backend.pallas.fallbacks.segreduce.dtype": 2}
    finally:
        kb.reset_counts()
    assert kb.selection_snapshot() == {}


def test_resultcache_route_is_the_references_empty_cache():
    """serve/ is not ported: /resultcache answers the reference's payload
    for an empty result cache (ROADMAP Queue C, until item 7)."""
    from spark_rapids_tpu.serve import result_cache as jrc
    s = _session({"spark.rapids.tpu.obs.http.enabled": True})
    try:
        code, body = _get(s.obs_server.port, "/resultcache")
        assert code == 200
        payload = json.loads(body)
        assert payload == {"entries": [], "stats": {"entries": 0,
                                                    "bytes": 0}}
        assert set(payload["stats"]) == set(jrc.stats())
        assert "/resultcache" in json.loads(
            _get(s.obs_server.port, "/healthz")[1])["routes"]
    finally:
        s.obs_server.shutdown()


def test_http_endpoint_off_by_default():
    s = _session()
    assert s.obs_server is None
    assert s.flight_recorder is None
    assert s.sentinel is None
    assert not obsrec.is_enabled()
    obsrec.record_event("anything", x=1)  # must not raise


def test_queries_table_tracks_states():
    s = _session({"spark.rapids.tpu.sched.maxConcurrent": 1})
    t = _data()
    # one plan three times: a submission made while an earlier one runs
    # joins its flight
    futs = [s.submit(_agg(s, t)) for _ in range(3)]
    deadline = time.time() + 60
    while not all(f.done() for f in futs):
        rows = {r["query_id"]: r for r in s.scheduler.query_table()}
        assert all(f.query_id in rows for f in futs)
        assert s.scheduler.controller.stats()["running"] <= 1
        assert time.time() < deadline, "queries never drained"
        time.sleep(0.01)
    for f in futs:
        f.result(timeout=60)
    rows = {r["query_id"]: r for r in s.scheduler.query_table()}
    for f in futs:
        assert rows[f.query_id]["state"] == "success"
        assert rows[f.query_id]["wall_s"] >= 0


def test_slow_query_log_jsonl_schema(tmp_path):
    log = str(tmp_path / "slow.jsonl")
    s = _session({"spark.rapids.tpu.obs.slowQueryMs": 1,
                  "spark.rapids.tpu.obs.slowQueryPath": log})
    _agg(s, _data()).collect()
    _agg(s, _data()).collect()
    lines = [json.loads(line) for line in open(log)]
    assert len(lines) == 2
    for rec in lines:
        for key in ("ts_unix", "query_id", "status", "wall_s",
                    "queue_wait_s", "result_rows", "phases",
                    "wall_breakdown", "threshold_ms", "plan_digest"):
            assert key in rec, f"slow-query record missing {key}"
        assert rec["status"] == "success"
        assert rec["wall_s"] >= 0.001
    assert lines[0]["plan_digest"] == lines[1]["plan_digest"]


def test_slow_query_log_threshold_filters(tmp_path):
    log = str(tmp_path / "slow.jsonl")
    s = _session({"spark.rapids.tpu.obs.slowQueryMs": 10 ** 9,
                  "spark.rapids.tpu.obs.slowQueryPath": log})
    _agg(s, _data()).collect()
    assert not os.path.exists(log)
