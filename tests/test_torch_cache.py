"""The port's ``df.cache()`` against the reference's.

``exec/cache.py``: the first action materializes the cached relation (the
child plan runs once on the session's device and each partition becomes
one parquet blob, by the device encoder when the plan ends on the
device), later actions read the blobs through
``TpuInMemoryTableScanExec`` (the PERFILE reader's ``decode_row_group``).
On a port session (``device="cpu"``) against the reference's sessions on
the JAX CPU backend, over tables made with numpy from a seed: the blobs
byte for byte, the rows (integers, strings and nulls exactly, floats to
``tests/parity.py``'s tolerance), the plans, unpersist, both kill
switches with the reference's reason text, empty input, the codecs, and
the device the cache materializes on.
"""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.io import parquet_encode as tpq

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": False}
SIDES = {"ref": (JSession, jcol, JF), "port": (TSession, tcol, TF)}
ENCODE_OFF = {"spark.rapids.tpu.sql.cache.deviceEncode.enabled": False}
DECODE_OFF = {"spark.rapids.tpu.sql.cache.deviceDecode.enabled": False}


def _session(side, conf):
    cls = SIDES[side][0]
    return cls(conf) if side == "ref" else cls(conf, device="cpu")


def _table(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": pa.array(rng.integers(-1000, 1000, n), pa.int64()),
        "l": pa.array(rng.integers(-10**9, 10**9, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "f": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.05),
        "s": pa.array([None if rng.random() < 0.1 else f"v{i % 23}é"
                       for i in range(n)]),
        "d": pa.array(rng.integers(0, 20000, n),
                      pa.int32()).cast(pa.date32()),
        "b": pa.array(rng.random(n) < 0.5),
    })


def _cached(s, col, t, parts=3):
    return s.create_dataframe(t, num_partitions=parts) \
        .filter(col("i") > -600).cache()


def _names(s, df):
    out = []
    s._plan_physical(df.plan).plan.foreach(
        lambda n: out.append(type(n).__name__))
    return out


def test_device_encoded_blobs_equal_reference():
    """Both packages' caches of the same device plan: device-encoded, the
    same blobs byte for byte, the same rows."""
    t = _table()
    blobs, rows = {}, {}
    for side in SIDES:
        s = _session(side, CONF)
        df = _cached(s, SIDES[side][1], t)
        rows[side] = df.collect()
        assert df.plan.device_encoded is True
        blobs[side] = df.plan.blobs
    assert blobs["port"] == blobs["ref"]
    assert len(blobs["port"]) == 3
    assert_tables_equal(rows["ref"], rows["port"])


def test_cache_materializes_once_and_reads_blobs_on_the_device():
    t = _table(2000, seed=4)
    s = _session("port", CONF)
    df = _cached(s, tcol, t)
    first = df.collect()
    blobs = df.plan.blobs
    assert "TpuInMemoryTableScanExec" in _names(s, df)
    second = df.collect()
    assert df.plan.blobs is blobs
    assert first.equals(second)
    want = t.filter(np.asarray(t.column("i")) > -600)
    assert_tables_equal(want, second)


def test_cache_downstream_query_matches_reference():
    t = _table(seed=7)
    out, names = {}, {}
    for side, conf in (("ref", CPU_ENGINE), ("port", CONF)):
        s = _session(side, conf)
        _, col, F = SIDES[side]
        df = s.create_dataframe(t, num_partitions=2).cache()
        assert df.count() == t.num_rows
        q = (df.filter(col("f") > 0).group_by("s")
             .agg(F.sum("l").alias("sl"), F.avg("f").alias("af"),
                  F.count("*").alias("c")).sort("s"))
        out[side] = q.collect()
        names[side] = _names(s, q)
    assert_tables_equal(out["ref"], out["port"])
    assert "TpuInMemoryTableScanExec" in names["port"]


def test_cache_plans_match_reference_device_session():
    t = _table(100)
    for conf in (CONF, dict(CONF, **DECODE_OFF)):
        names, explain = {}, {}
        for side in SIDES:
            s = _session(side, conf)
            df = s.create_dataframe(t).cache()
            q = df.filter(SIDES[side][1]("i") > 0)
            names[side] = _names(s, q)
            explain[side] = [ln for ln in q.explain_string("tpu").splitlines()
                             if "InMemoryTableScan" in ln]
        assert names["port"] == names["ref"]
        assert explain["port"] == explain["ref"]
    assert "CpuInMemoryTableScanExec" in names["port"]
    assert "cached-batch device decode disabled by " \
        "spark.rapids.tpu.sql.cache.deviceDecode.enabled" in explain["port"][0]


@pytest.mark.parametrize("conf,encoded", [
    (CONF, True), (dict(CONF, **ENCODE_OFF), False),
    (dict(CONF, **DECODE_OFF), True),
    (dict(CONF, **{"spark.rapids.tpu.sql.cache.compression": "gzip"}),
     False)])
def test_kill_switches_and_codec_choose_the_encoder_like_the_reference(
        conf, encoded):
    t = _table(500, seed=2)
    got = {}
    for side in SIDES:
        s = _session(side, conf)
        df = _cached(s, SIDES[side][1], t, parts=2)
        rows = df.collect()
        got[side] = (df.plan.device_encoded, len(df.plan.blobs), rows)
    assert got["port"][:2] == got["ref"][:2]
    assert got["port"][0] is encoded
    assert_tables_equal(got["ref"][2], got["port"][2])


@pytest.mark.parametrize("codec", ["none", "snappy", "zstd"])
def test_cache_codecs(codec):
    t = _table(800, seed=3)
    s = _session("port", dict(CONF, **{
        "spark.rapids.tpu.sql.cache.compression": codec}))
    df = _cached(s, tcol, t)
    out = df.collect()
    assert df.plan.device_encoded is True
    assert_tables_equal(t.filter(np.asarray(t.column("i")) > -600), out)


def test_unpersist_restores_the_plan():
    t = _table(500)
    s = _session("port", CONF)
    df = _cached(s, tcol, t)
    rel = df.plan
    df.collect()
    assert df.is_cached and rel.blobs is not None
    df.unpersist()
    assert not df.is_cached and rel.blobs is None
    assert "TpuInMemoryTableScanExec" not in _names(s, df)
    assert df.collect().num_rows == \
        int((np.asarray(t.column("i")) > -600).sum())


def test_empty_input_matches_reference():
    t = _table(50)
    got = {}
    for side in SIDES:
        s = _session(side, CONF)
        df = s.create_dataframe(t, num_partitions=2) \
            .filter(SIDES[side][1]("i") > 1000).cache()
        out = df.collect()
        got[side] = (out.num_rows, out.schema.names, df.plan.device_encoded,
                     len(df.plan.blobs))
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0


def test_cache_materializes_on_the_session_device(monkeypatch):
    """A session on the CPU builds its blobs from CPU tensors, under both
    scans (the device's and, with decode off, the host's)."""
    seen = []
    real = tpq.encode_batch

    def spy(batch, **kw):
        seen.append(batch.device.type)
        return real(batch, **kw)
    monkeypatch.setattr(tpq, "encode_batch", spy)
    for conf in (CONF, dict(CONF, **DECODE_OFF)):
        s = _session("port", conf)
        df = _cached(s, tcol, _table(300), parts=2)
        nodes = []
        s._plan_physical(df.plan).plan.foreach(nodes.append)
        assert all(str(n.device) == "cpu" for n in nodes
                   if "InMemoryTableScan" in type(n).__name__)
        df.collect()
    assert seen == ["cpu"] * 4


def test_sql_over_a_cached_view():
    t = _table(1000, seed=9)
    out = {}
    for side in SIDES:
        s = _session(side, CONF if side == "port" else CPU_ENGINE)
        s.create_dataframe(t, num_partitions=2).cache() \
            .create_or_replace_temp_view("c")
        out[side] = s.sql("SELECT s, count(*) AS n, sum(i) AS si FROM c "
                          "WHERE b GROUP BY s ORDER BY s").collect()
    assert_tables_equal(out["ref"], out["port"])


def test_cached_projection_of_a_scan_materializes_once(tmp_path,
                                                       monkeypatch):
    """Column pruning stops at the cached relation (plan/optimizer.py), so
    a cached projection of a Parquet scan materializes once, from a
    pruned scan, and later actions read its blobs.  (The reference's
    pruning copies the relation below a narrowed projection and builds
    a fresh copy on every action.)  The rows equal the reference's."""
    import pyarrow.parquet as papq
    from spark_rapids_tpu_torch.exec import cache as tcache
    t = _table(1200, seed=5)
    papq.write_table(t, str(tmp_path / "t.parquet"))
    built = []
    real = tcache.materialize

    def counting(rel, *a, **kw):
        if not rel.materialized:
            built.append(rel)
        return real(rel, *a, **kw)
    monkeypatch.setattr(tcache, "materialize", counting)
    out = {}
    for side in SIDES:
        s = _session(side, CONF if side == "port" else CPU_ENGINE)
        col = SIDES[side][1]
        df = s.read.parquet(str(tmp_path)).select("i", "s", "f").cache()
        first = df.collect()
        again = df.filter(col("i") > 0).select("s").collect()
        out[side] = (first, again, df.collect())
        if side == "port":
            assert [r is df.plan for r in built] == [True]
            assert df.plan.device_encoded is True
            assert df.plan.children[0].schema.names == ["i", "s", "f"]
    for a, b in zip(out["ref"], out["port"]):
        assert_tables_equal(a, b)
