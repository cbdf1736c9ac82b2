"""The port's per-query profile, query listeners and plan-metrics walk
against the reference's.

The same numpy-seeded Parquet file and the same conf go through a
reference session and a port session (``device="cpu"``):

- a filter -> aggregate's ``QueryProfile``: status, ``result_rows``, the
  keys of ``to_dict()``, the section names, the plan tree's node names,
  nesting and per-node output rows, the ``wall_breakdown`` keys and the
  ``explain_string('profile')`` lines with the numbers masked;
- the query listeners on success and on failure, and
  ``obs.profile.enabled=false``;
- ``collect_plan_metrics`` / ``merge_plan_metrics`` on the same plan;
- the four ``fusion.*`` counters of ``tests/test_fusion.py:745-756``'s
  fused plan.
"""

import json
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.exec import base as jbase
from spark_rapids_tpu.obs import listener as jlistener
from spark_rapids_tpu.obs import profile as jprofile
from spark_rapids_tpu.obs import registry as jreg
from spark_rapids_tpu.obs import trace as jtrace

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.exec import base as tbase
from spark_rapids_tpu_torch.obs import listener as tlistener
from spark_rapids_tpu_torch.obs import profile as tprofile
from spark_rapids_tpu_torch.obs import registry as treg
from spark_rapids_tpu_torch.obs import trace as ttrace

from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.obs.trace.enabled": True}
SIDES = {"ref": (JSession, jcol, JF, {}),
         "port": (TSession, tcol, TF, {"device": "cpu"})}
LISTENERS = {"ref": jlistener, "port": tlistener}
# exec sections the port's execs time into Metrics.extra (exec/base.timed
# keeps a named section there; the reference's only spans it) and the
# scan's uploaded bytes, which the reference counts in its registry
PORT_ONLY_EXTRAS = ("agg.update", "scan.dispatch", "scan.bytesUploaded",
                    "transition.download")


@pytest.fixture(scope="module", autouse=True)
def _tracers_off():
    """The tracer is process-wide: leave both packages' off and empty."""
    yield
    for tr in (jtrace, ttrace):
        tr.configure(False)
        tr.clear()


def _write(root: str, n: int = 2000, seed: int = 5) -> str:
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    papq.write_table(pa.table({
        "k": rng.integers(0, 9, n).astype(np.int64),
        "v": rng.random(n) * 100.0,
    }), os.path.join(root, "p0.parquet"), row_group_size=512)
    return root


def _session(side: str, **extra):
    S, _col, _F, kw = SIDES[side]
    return S(dict(CONF, **extra), **kw)


def _query(s, side: str, root: str):
    _S, col, F, _kw = SIDES[side]
    return (s.read.parquet(root).filter(col("v") > 10.0).group_by("k")
            .agg(F.count("*").alias("c"), F.sum("v").alias("sv")))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("obs_profile")))


@pytest.fixture(scope="module")
def runs(root):
    """side -> (result, profile, explain_string('profile')).

    Both registries start empty: a view's delta carries every gauge the
    process holds at its current value, so a gauge an earlier file on
    this worker left in one package's registry (``test.hwm`` of
    tests/test_observability.py, say) would be a profile section on
    that side only."""
    jreg.reset_registry()
    treg.reset_registry()
    out = {}
    for side in SIDES:
        s = _session(side)
        df = _query(s, side, root)
        table = df.collect()
        out[side] = (table, s.last_query_profile(),
                     df.explain_string("profile"))
    return out


def _tree(node):
    return (node.name, node.rows, [_tree(c) for c in node.children])


def _masked(text: str, drop=()) -> list:
    """The profile's lines with every number masked and the extras named
    in ``drop`` removed."""
    lines = []
    for line in text.splitlines():
        for key in drop:
            line = re.sub(rf", {re.escape(key)}=[^,\]]*", "", line)
        lines.append(re.sub(r"\d+(\.\d+)?", "#", line))
    return lines


def test_profile_status_rows_and_keys(runs):
    for side, (table, prof, _) in runs.items():
        assert prof is not None and prof.status == "success", side
        assert prof.error is None
        assert prof.result_rows == table.num_rows == prof.plan.rows
    ref, port = runs["ref"][1].to_dict(), runs["port"][1].to_dict()
    assert sorted(port) == sorted(ref)
    assert isinstance(ref["plan_digest"], str)
    # the query service stamps the same digest as the reference's
    assert port["plan_digest"] == ref["plan_digest"]
    assert json.loads(runs["port"][1].to_json())["status"] == "success"


def test_profile_sections(runs):
    assert tprofile.SECTIONS == jprofile.SECTIONS
    ref, port = runs["ref"][1], runs["port"][1]
    assert sorted(port.metrics) == sorted(ref.metrics)
    for sec in tprofile.SECTIONS:
        assert sec in port.metrics, sec
    assert port.metrics["semaphore"].get("semaphore.acquires", 0) >= 1
    assert port.metrics["fusion"] == ref.metrics["fusion"]


def test_plan_tree_names_nesting_and_rows(runs):
    assert _tree(runs["port"][1].plan) == _tree(runs["ref"][1].plan)
    scans = [n for n in runs["port"][1].plan.walk() if "ScanExec" in n.name]
    assert scans and "scan.hostPrepTime" in scans[0].extra


def test_wall_breakdown(runs):
    ref, port = runs["ref"][1], runs["port"][1]
    assert list(port.wall_breakdown) == list(ref.wall_breakdown)
    wall = port.wall_ns / 1e9
    for k, v in port.wall_breakdown.items():
        if k.endswith("_s"):
            assert 0 <= v <= wall, (k, v, wall)
    assert sorted(port.phases) == sorted(ref.phases) == \
        ["collect", "execute", "plan"]


def test_explain_profile_lines_with_numbers_masked(runs):
    ref, port = runs["ref"][2], runs["port"][2]
    assert port.startswith("QueryProfile #")
    assert _masked(port, drop=PORT_ONLY_EXTRAS) == _masked(ref)


def test_chrome_trace_and_spans(runs, tmp_path):
    prof = runs["port"][1]
    assert prof.spans
    path = prof.dump_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    begins = [e for e in doc["traceEvents"] if e["ph"] == "B"]
    ends = [e for e in doc["traceEvents"] if e["ph"] == "E"]
    assert begins and len(begins) == len(ends)


def _capture(side: str):
    class Capture(LISTENERS[side].QueryExecutionListener):
        def __init__(self):
            self.events = []

        def on_success(self, profile):
            self.events.append(("success", profile, None))

        def on_failure(self, profile, exception):
            self.events.append(("failure", profile, exception))
    return Capture()


def _listener_run(side: str, root: str, tmp: str):
    s = _session(side)
    cap = _capture(side)
    s.register_query_listener(cap)
    out = _query(s, side, root).collect()
    bad_root = _write(tmp)
    bad = s.read.parquet(bad_root)     # schema read while the file exists
    os.unlink(os.path.join(bad_root, "p0.parquet"))
    with pytest.raises(Exception) as err:
        bad.collect()
    s.remove_query_listener(cap)

    class Broken(LISTENERS[side].QueryExecutionListener):
        def on_success(self, profile):
            raise RuntimeError("listener bug")
    s.register_query_listener(Broken())
    # a broken listener does not fail the query
    assert _query(s, side, root).collect().num_rows == out.num_rows
    return out, cap.events, err.value


def test_listeners_fire_on_success_and_failure(root, tmp_path):
    got = {side: _listener_run(side, root, str(tmp_path / side))
           for side in SIDES}
    statuses = {side: [(kind, prof.status) for kind, prof, _ in events]
                for side, (_, events, _) in got.items()}
    assert statuses["port"] == statuses["ref"] == [
        ("success", "success"), ("failure", "failure")]
    out, events, err = got["port"]
    assert events[0][1].result_rows == out.num_rows
    _, prof, exc = events[1]
    assert exc is err
    assert type(exc).__name__ in prof.error
    # planning succeeded before the scan failed: the failure profile
    # carries the plan tree
    assert prof.plan is not None
    assert any("ScanExec" in n.name for n in prof.plan.walk())


def test_profile_disabled_records_nothing(root):
    for side in SIDES:
        s = _session(side, **{"spark.rapids.tpu.obs.profile.enabled": False})
        cap = _capture(side)
        s.register_query_listener(cap)
        assert _query(s, side, root).collect().num_rows
        assert s.last_query_profile() is None, side
        assert cap.events == [], side
        assert "no query profile recorded" in \
            _query(s, side, root).explain_string("profile")


def _walk_metrics(side: str, base, root: str):
    s = _session(side)
    plan = s._plan_physical(_query(s, side, root).plan).plan
    nodes = []
    plan.foreach(nodes.append)
    nodes[0].metrics.add_rows(10)
    nodes[0].metrics.add_time_ns(5000)
    nodes[-1].metrics.add_extra("scan.hostPrepTime", 1000)
    recorded = base.collect_plan_metrics(plan)
    again = s._plan_physical(_query(s, side, root).plan).plan
    base.merge_plan_metrics(again, recorded)
    base.merge_plan_metrics(again, recorded[:-1])  # shape mismatch: dropped
    base.merge_plan_metrics(again, recorded, skip_root=True)
    return recorded, base.collect_plan_metrics(again)


def test_collect_and_merge_plan_metrics(root):
    ref = _walk_metrics("ref", jbase, root)
    port = _walk_metrics("port", tbase, root)
    assert port == ref
    recorded, merged = port
    assert recorded[0]["rows"] == 10 and recorded[0]["time_ns"] == 5000
    assert merged[0]["rows"] == 10
    assert merged[-1]["extra"]["scan.hostPrepTime"] == 2000


FUSION_COUNTERS = ("fusion.stages", "fusion.execsFused",
                   "fusion.aggProloguesInlined", "fusion.dispatchesSaved")


def _fusion_deltas(side: str, reg):
    """``tests/test_fusion.py::test_fusion_metrics_in_query_profile``'s
    query on a fresh session with fusion on."""
    S, col, _F, kw = SIDES[side]
    s = S({"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
           "spark.rapids.tpu.sql.fusion.enabled": True}, **kw)
    df = s.create_dataframe(
        {"a": [1, None, 3, 4, None, 6, 7, 8],
         "b": [10.0, 20.0, None, 40.0, 50.0, 60.0, None, 80.0],
         "s": ["ab", "cd", None, "ef", "gh", None, "ij", "kl"],
         "k": [0, 1, 0, 1, 0, 1, 0, 1]}, num_partitions=2)
    q = (df.with_column("d", col("a") + col("b")).filter(col("d") > 15.0)
         .with_column("e", col("d") * 2).select("e", "k"))
    view = reg.get_registry().view()
    q.collect()
    counters = view.delta()["counters"]
    prof = s.last_query_profile()
    # the profile's fusion section, but the reference's
    # fusion.donatedDispatches: XLA input donation, which an eager port
    # has no counterpart for (exec/fused_stage.py)
    section = {k: prof.metrics["fusion"].get(k, 0) for k in FUSION_COUNTERS}
    return ({k: counters.get(k, 0) for k in FUSION_COUNTERS}, section,
            prof.wall_breakdown["fused_stage_s"])


def test_fusion_counters_equal_the_references():
    ref, ref_section, _ = _fusion_deltas("ref", jreg)
    port, port_section, fused_s = _fusion_deltas("port", treg)
    assert port == ref
    assert port["fusion.stages"] >= 1 and port["fusion.dispatchesSaved"] > 0
    assert port_section == ref_section
    assert fused_s > 0
