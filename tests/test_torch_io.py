"""The port's device Parquet/ORC encoders and its writers against the
reference's.

``io/parquet_encode.encode_batch`` and ``io/orc_encode.encode_batch``
compact each column's non-null values to the front on the device
(``device="cpu"`` here: the plain torch ops) and assemble the file on the
host.  For the same Arrow table and codec the port's blob must equal the
reference's byte for byte (the reference's batch is built by its
``from_arrow`` on the JAX CPU backend), and stock pyarrow must read it
back equal to the input.  ``DataFrame.write`` (io/writers.py): every
mode, the Hive-style partitioned layout, CSV, the ``_SUCCESS`` marker and
``WriteStats`` against a reference session over the same table; which
plans take the device encoder, plan by plan, against the reference's
choice; the kill switches.
"""

import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu.columnar.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.io import orc_encode as jorc
from spark_rapids_tpu.io import parquet_encode as jpq

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.columnar.batch import from_arrow as tfrom_arrow
from spark_rapids_tpu_torch.io import orc_encode as torc
from spark_rapids_tpu_torch.io import parquet_encode as tpq
from spark_rapids_tpu_torch.plan.logical import Schema as TSchema

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": False}
_CHARS = list("abcxyz019 _-") + ["é", "ß", "中",
                                 "\U0001f642"]


def modes_table(n=1500, seed=11, timestamps=True):
    """Every encoder type with ~5% nulls: int32, int64, float32 and
    float64 (NaN and -0.0 among them), bool, date, timestamp, strings of
    0-256 bytes with multi-byte characters, and an all-null column."""
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.05

    f64 = rng.normal(size=n) * 1e3
    f64[rng.random(n) < 0.03] = np.nan
    f64[rng.random(n) < 0.03] = -0.0
    f32 = rng.normal(size=n).astype(np.float32)
    f32[rng.random(n) < 0.03] = np.float32(np.nan)
    f32[rng.random(n) < 0.03] = np.float32(-0.0)
    strs = []
    for _ in range(n):
        s, budget = [], int(rng.integers(0, 257))
        while True:
            c = _CHARS[int(rng.integers(0, len(_CHARS)))]
            if len(("".join(s) + c).encode()) > budget:
                break
            s.append(c)
        strs.append("".join(s))
    cols = {
        "i32": pa.array(rng.integers(-2**31, 2**31 - 1, n), pa.int32(),
                        mask=nulls()),
        "i64": pa.array(rng.integers(-10**15, 10**15, n), pa.int64(),
                        mask=nulls()),
        "f32": pa.array(f32, mask=nulls()),
        "f64": pa.array(f64, mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "d": pa.array(rng.integers(-30000, 30000, n), pa.int32(),
                      mask=nulls()).cast(pa.date32()),
        "s": pa.array(strs, pa.string(), mask=nulls()),
        "none": pa.array([None] * n, pa.int64()),
    }
    if timestamps:
        cols["ts"] = pa.array(
            rng.integers(-2 * 10**15, 2 * 10**15, n), pa.int64(),
            mask=nulls()).cast(pa.timestamp("us", tz="UTC"))
    return pa.table(cols)


@pytest.fixture(scope="module")
def table():
    return modes_table()


@pytest.mark.parametrize("codec", ["none", "uncompressed", "snappy",
                                   "zstd", "gzip"])
def test_parquet_blob_equals_reference(table, codec):
    ref = jpq.encode_batch(jfrom_arrow(table), codec=codec)
    port = tpq.encode_batch(tfrom_arrow(table, device="cpu"), codec=codec)
    assert port == ref
    back = papq.read_table(io.BytesIO(port))
    assert_tables_equal(table.cast(back.schema), back, approx_float=False)


def test_orc_blob_equals_reference(table):
    t = table.drop(["ts"])
    ref = jorc.encode_batch(jfrom_arrow(t))
    port = torc.encode_batch(tfrom_arrow(t, device="cpu"))
    assert port == ref
    back = paorc.ORCFile(io.BytesIO(port)).read()
    assert_tables_equal(t.cast(back.schema), back, approx_float=False)


@pytest.mark.parametrize("enc", ["parquet", "orc"])
def test_all_null_and_one_row_blobs_equal_reference(enc):
    jmod, tmod = (jpq, tpq) if enc == "parquet" else (jorc, torc)
    for t in (pa.table({"a": pa.array([None] * 50, pa.int64()),
                        "s": pa.array([None] * 50, pa.string())}),
              pa.table({"a": pa.array([7], pa.int64()),
                        "s": pa.array([""], pa.string())})):
        assert tmod.encode_batch(tfrom_arrow(t, device="cpu")) == \
            jmod.encode_batch(jfrom_arrow(t))


def test_supported_types_match_reference():
    from spark_rapids_tpu.plan.logical import Schema as JSchema
    for arrow_t in (pa.int32(), pa.int64(), pa.float32(), pa.float64(),
                    pa.bool_(), pa.string(), pa.date32(),
                    pa.timestamp("us", tz="UTC"), pa.list_(pa.int64())):
        sch = pa.schema([("x", arrow_t)])
        for jmod, tmod in ((jpq, tpq), (jorc, torc)):
            assert tmod.supported(TSchema.from_arrow(sch).fields) == \
                jmod.supported(JSchema.from_arrow(sch).fields), arrow_t


def test_compaction_moves_values_to_the_front():
    t = pa.table({"x": pa.array([None, 5, None, 7, 9], pa.int64()),
                  "s": pa.array(["ab", None, "c", None, "dé"])})
    comp = tpq._compact_for_encode(tfrom_arrow(t, device="cpu"))
    x, s = comp.columns
    assert x.data[:3].tolist() == [5, 7, 9]
    assert x.validity[:5].tolist() == [False, True, False, True, True]
    assert s.lengths[:3].tolist() == [2, 1, 3]
    assert bytes(s.data[1, :1].tolist()) == b"c"


# ---------------------------------------------------------------------------
# DataFrame.write
# ---------------------------------------------------------------------------

SIDES = {"ref": (JSession, jcol), "port": (TSession, tcol)}


def _session(side, conf):
    cls = SIDES[side][0]
    return cls(conf) if side == "ref" else cls(conf, device="cpu")


def _files(path):
    out = {}
    for d, _, names in os.walk(path):
        rel = os.path.relpath(d, path)
        for f in names:
            key = os.path.join(rel, f.split("-")[0] + "." +
                               f.rsplit(".", 1)[-1]) if "-" in f \
                else os.path.join(rel, f)
            out[key] = out.get(key, 0) + 1
    return out


def _read_back(path, fmt):
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(path)
                   for f in fs if f.endswith("." + fmt))
    if fmt == "parquet":
        return pa.concat_tables([papq.read_table(f) for f in files])
    if fmt == "orc":
        return pa.concat_tables([paorc.ORCFile(f).read() for f in files])
    import pyarrow.csv as pacsv
    return pa.concat_tables([pacsv.read_csv(f) for f in files])


def _small(n=300, seed=2):
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": pa.array(rng.integers(-1000, 1000, n), pa.int64()),
        "f": pa.array(rng.normal(size=n)),
        "s": pa.array([f"name_{int(x)}" for x in rng.integers(0, 30, n)]),
        "k": pa.array(rng.integers(0, 4, n), pa.int32()),
    })


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_write_matches_reference(tmp_path, fmt):
    """A device plan (a filter) written by the port and by the reference's
    CPU engine: the same stats, the same files and the same rows."""
    t = _small()
    got = {}
    for side in SIDES:
        s = _session(side, CONF if side == "port" else CPU_ENGINE)
        col = SIDES[side][1]
        df = s.create_dataframe(t, num_partitions=3).filter(col("i") > -500)
        path = str(tmp_path / side)
        stats = getattr(df.write, fmt)(path)
        assert os.path.exists(os.path.join(path, "_SUCCESS"))
        got[side] = (stats.num_files, stats.num_rows, _files(path),
                     _read_back(path, fmt).sort_by("i"))
    assert got["port"][:3] == got["ref"][:3]
    assert_tables_equal(got["ref"][3], got["port"][3])


@pytest.mark.parametrize("mode", ["errorifexists", "error", "overwrite",
                                  "ignore", "append"])
def test_write_modes_match_reference(tmp_path, mode):
    t = _small(120)
    got = {}
    for side in SIDES:
        s = _session(side, CONF if side == "port" else CPU_ENGINE)
        col = SIDES[side][1]
        df = s.create_dataframe(t, num_partitions=2).filter(col("k") < 3)
        path = str(tmp_path / side)
        first = df.write.parquet(path)
        w = df.write.mode(mode.upper())
        if mode in ("errorifexists", "error"):
            with pytest.raises(FileExistsError):
                w.parquet(path)
            second = None
        else:
            second = w.parquet(path)
        got[side] = (first.num_rows,
                     second and (second.num_files, second.num_rows),
                     _files(path), _read_back(path, "parquet").num_rows)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_partitioned_layout_matches_reference(tmp_path, fmt):
    t = _small(400, seed=5)
    t = t.set_column(3, "k", pa.array(
        [None if i % 17 == 0 else v for i, v in
         enumerate(t.column("k").to_pylist())], pa.int32()))
    got = {}
    for side in SIDES:
        s = _session(side, CONF if side == "port" else CPU_ENGINE)
        col = SIDES[side][1]
        df = s.create_dataframe(t, num_partitions=2).filter(col("i") > 0)
        path = str(tmp_path / side)
        stats = getattr(df.write.partitionBy("k"), fmt)(path)
        rows = {}
        for p in stats.partitions:
            rows[p] = _read_back(os.path.join(path, p), fmt).num_rows
        got[side] = (stats.num_files, stats.num_rows,
                     sorted(stats.partitions), _files(path), rows)
    assert got["port"] == got["ref"]
    assert "k=__HIVE_DEFAULT_PARTITION__" in got["port"][2]


def _write_plans(tmp_path):
    root = str(tmp_path / "src")
    os.makedirs(root)
    papq.write_table(_small(200), os.path.join(root, "a.parquet"))
    return {
        "create_dataframe": lambda s, col: s.create_dataframe(_small()),
        "device scan": lambda s, col: s.read.parquet(root),
        "scan + projection": lambda s, col: s.read.parquet(root).select(
            col("i"), (col("f") * 2.0).alias("f2")),
        "scan + filter": lambda s, col: s.read.parquet(root).filter(
            col("k") == 1),
        "create_dataframe + filter": lambda s, col: s.create_dataframe(
            _small()).filter(col("k") == 1),
    }


def test_device_encode_choice_matches_reference(tmp_path):
    """Which plans the device encoder takes (the planned root must be the
    terminal download over a device plan), plan by plan, format by
    format and with partition_by, against the reference's device
    session (planned only, never run)."""
    plans = _write_plans(tmp_path)
    choice = {}
    for side in SIDES:
        s = _session(side, CONF)
        col = SIDES[side][1]
        for name, make in plans.items():
            df = make(s, col)
            plan = s._plan_physical(df.plan).plan
            for fmt in ("parquet", "orc"):
                w = df.write
                choice[side, name, fmt] = w._device_encode_ok(plan, fmt)
                choice[side, name, fmt, "part"] = \
                    w.partition_by("k")._device_encode_ok(plan, fmt) \
                    if "k" in df.columns else None
    assert {k[1:]: v for k, v in choice.items() if k[0] == "port"} == \
        {k[1:]: v for k, v in choice.items() if k[0] == "ref"}
    assert choice["port", "create_dataframe", "parquet"] is False
    assert choice["port", "scan + projection", "parquet"] is True


def test_device_encoder_writes_one_blob_per_partition(tmp_path,
                                                      monkeypatch):
    calls = []
    real = tpq.encode_batch

    def counting(batch, **kw):
        calls.append(int(batch.num_rows))
        return real(batch, **kw)
    monkeypatch.setattr(tpq, "encode_batch", counting)
    t = _small(500)
    s = _session("port", CONF)
    df = s.create_dataframe(t, num_partitions=4).filter(tcol("i") > 0)
    stats = df.write.option("compression", "zstd").parquet(
        str(tmp_path / "o"))
    assert len(calls) == stats.num_files == 4
    assert sum(calls) == stats.num_rows
    back = s.read.parquet(str(tmp_path / "o")).collect()
    want = t.filter(np.asarray(t.column("i")) > 0)
    assert_tables_equal(want, back, ignore_order=True)
    # the kill switch takes the host Arrow writer
    calls.clear()
    s2 = _session("port", dict(CONF, **{
        "spark.rapids.tpu.sql.format.parquet.deviceEncode.enabled": False}))
    s2.create_dataframe(t, num_partitions=4).filter(tcol("i") > 0) \
        .write.parquet(str(tmp_path / "h"))
    assert calls == []
    assert _read_back(str(tmp_path / "h"), "parquet").num_rows == \
        stats.num_rows


def test_orc_kill_switch_and_timestamp_fall_back_to_host(tmp_path,
                                                         monkeypatch):
    calls = []
    real = torc.encode_batch
    monkeypatch.setattr(torc, "encode_batch",
                        lambda b, **kw: calls.append(1) or real(b, **kw))
    t = modes_table(200, seed=3)
    s = _session("port", CONF)
    df = s.create_dataframe(t).filter(tcol("i64").is_not_null())
    df.write.orc(str(tmp_path / "ts"))          # timestamps: host writer
    assert calls == []
    df.select("i32", "s", "d").write.orc(str(tmp_path / "dev"))
    assert calls == [1]
    back = _read_back(str(tmp_path / "dev"), "orc")
    want = t.filter(t.column("i64").is_valid()).select(["i32", "s", "d"])
    assert_tables_equal(want, back.cast(want.schema))


@pytest.mark.parametrize("enc", ["parquet", "orc"])
def test_threaded_column_assembly_gives_the_same_blob(table, enc,
                                                      monkeypatch):
    """A batch of ``_THREADED_ROWS`` rows or more assembles its columns on
    a pool of threads; the blob is the serial one."""
    t = table.drop(["ts"]) if enc == "orc" else table
    mod = tpq if enc == "parquet" else torc
    batch = tfrom_arrow(t, device="cpu")
    monkeypatch.setattr(tpq, "_THREADED_ROWS", 1 << 40)
    serial = mod.encode_batch(batch)
    monkeypatch.setattr(tpq, "_THREADED_ROWS", 1)
    assert mod.encode_batch(batch) == serial
