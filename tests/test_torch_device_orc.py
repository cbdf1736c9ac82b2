"""The port's device ORC decode against the reference's.

The nine cases of ``tests/test_device_orc.py``: the same file goes
through both packages' ``read_meta``, ``walk_rlev2`` (the run tables and
packed bytes) and ``decode_stripe`` (each column exact, the same fallback
set), and a planned ``read.orc`` query runs on a port session
(``device="cpu"``) against a reference session.  Each table is written
twice: with pyarrow's default dictionary threshold (every string column
DIRECT_V2) and with Hive's 0.8 (low-cardinality strings DICTIONARY_V2).
"""

from dataclasses import asdict

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pytest

from spark_rapids_tpu.columnar.batch import to_arrow as jto_arrow
from spark_rapids_tpu.io import device_orc as jorc
from spark_rapids_tpu.io.device_parquet import RunTable as JRunTable
from spark_rapids_tpu.plan.logical import Schema as JSchema

from spark_rapids_tpu_torch.columnar.batch import to_arrow as tto_arrow
from spark_rapids_tpu_torch.io import device_orc as torc
from spark_rapids_tpu_torch.io.device_parquet import RunBuilder
from spark_rapids_tpu_torch.plan.logical import Schema as TSchema

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

THRESHOLDS = [0.0, 0.8]


def _write(tmp_path, table, thr, name="t.orc"):
    path = str(tmp_path / name)
    paorc.write_table(table, path, dictionary_key_size_threshold=thr,
                      compression="zlib")
    return path


def _walks(raw: bytes):
    """Every DATA/LENGTH stream of every stripe walked by both packages:
    (reference runs, packed, overlay) and the port's, per stream."""
    jm, tm = jorc.read_meta(raw), torc.read_meta(raw)
    assert asdict(jm) == asdict(tm)
    out = []
    for si_j, si_t in zip(jm.stripes, tm.stripes):
        js, je = jorc.read_stripe_footer(raw, jm, si_j)
        ts, te = torc.read_stripe_footer(raw, tm, si_t)
        assert [asdict(s) for s in js] == [asdict(s) for s in ts]
        assert je == te
        for s in js:
            kind = jm.kinds[s.column]
            if s.kind not in (torc.DATA, torc.LENGTH) or \
                    kind not in torc._INT_KINDS | {torc.K_STRING}:
                continue
            if kind == torc.K_STRING and s.kind == torc.DATA and \
                    je[s.column][0] != torc.ENC_DICTIONARY_V2:
                continue     # a DIRECT_V2 string's DATA is the blob
            buf = jorc._decompress(jm, raw[s.offset:s.offset + s.length])
            signed = kind in torc._INT_KINDS and s.kind == torc.DATA
            n = si_j.num_rows if s.kind == torc.DATA else \
                (je[s.column][1] or si_j.num_rows)
            sides = []
            for mod, runs in ((jorc, JRunTable.empty()),
                              (torc, RunBuilder())):
                packed = bytearray()
                try:
                    ov = mod.walk_rlev2(buf, n, signed, runs, packed)
                except Exception as e:   # PATCHED_BASE, wide DIRECT
                    sides.append(type(e).__name__)
                    continue
                sides.append((runs.counts, runs.is_rle, runs.values,
                              runs.bit_bases, runs.widths, bytes(packed),
                              None if ov is None else ov.tolist()))
            out.append(sides)
    return out


def _roundtrip(tmp_path, table: pa.Table, expect_fallback=()):
    for thr in THRESHOLDS:
        path = _write(tmp_path, table, thr, f"t{thr}.orc")
        with open(path, "rb") as f:
            raw = f.read()
        for j, t in _walks(raw):
            assert j == t
        jb, jf = jorc.decode_stripe(path, 0, JSchema.from_arrow(table.schema))
        tb, tf = torc.decode_stripe(path, 0, TSchema.from_arrow(table.schema),
                                    device="cpu")
        assert sorted(tf) == sorted(jf), (tf, jf)
        if expect_fallback is not None:
            assert sorted(tf) == sorted(expect_fallback), tf
        got = tto_arrow(tb)
        assert got.equals(jto_arrow(jb))
        assert_tables_equal(table, got, approx_float=False)


def test_int_types(tmp_path):
    rng = np.random.default_rng(0)
    n = 3000
    _roundtrip(tmp_path, pa.table({
        "i8": pa.array(rng.integers(-100, 100, n), type=pa.int8()),
        "i16": pa.array(rng.integers(-3000, 3000, n), type=pa.int16()),
        "i32": pa.array(rng.integers(-10**6, 10**6, n), type=pa.int32()),
        "i64": pa.array(rng.integers(-10**6, 10**6, n), type=pa.int64()),
    }))


def test_delta_and_repeat_runs(tmp_path):
    n = 4000
    _roundtrip(tmp_path, pa.table({
        "mono": pa.array(np.arange(n, dtype=np.int64) * 3),
        "const": pa.array(np.full(n, 42, dtype=np.int32)),
        "steps": pa.array((np.arange(n) // 100).astype(np.int64)),
    }))


def test_floats_and_bools(tmp_path):
    rng = np.random.default_rng(1)
    n = 2500
    _roundtrip(tmp_path, pa.table({
        "d": rng.standard_normal(n),
        "f": pa.array(rng.standard_normal(n).astype(np.float32)),
        "b": pa.array([bool(i % 3) for i in range(n)]),
    }))


def test_nulls_all_types(tmp_path):
    rng = np.random.default_rng(2)
    n = 2000
    mask = rng.random(n) < 0.2
    _roundtrip(tmp_path, pa.table({
        "i": pa.array(rng.integers(0, 100, n), type=pa.int64(), mask=mask),
        "x": pa.array(rng.standard_normal(n), mask=mask),
        "s": pa.array([None if mask[i] else f"v{i % 9}" for i in range(n)]),
        "bo": pa.array([None if mask[i] else bool(i % 2)
                        for i in range(n)]),
    }))


def test_strings_dictionary_and_direct(tmp_path):
    n = 3000
    t = pa.table({
        "dict": pa.array([f"cat{i % 6}" for i in range(n)]),
        "uniq": pa.array([f"row-{i:07d}" for i in range(n)]),
        "empty": pa.array(["" if i % 2 else "x" for i in range(n)]),
    })
    _roundtrip(tmp_path, t)
    # the 0.8 threshold really writes the dictionary form
    path = _write(tmp_path, t, 0.8, "enc.orc")
    with open(path, "rb") as f:
        raw = f.read()
    m = torc.read_meta(raw)
    _, enc = torc.read_stripe_footer(raw, m, m.stripes[0])
    assert enc[1][0] == torc.ENC_DICTIONARY_V2
    assert enc[2][0] == torc.ENC_DIRECT_V2


def test_dates(tmp_path):
    rng = np.random.default_rng(3)
    n = 1500
    _roundtrip(tmp_path, pa.table({
        "d": pa.array(rng.integers(0, 20000, n).astype("datetime64[D]")),
    }))


def test_timestamp_falls_back(tmp_path):
    n = 500
    _roundtrip(tmp_path, pa.table({
        "ts": pa.array(np.arange(n) * 10**6,
                       type=pa.timestamp("us", tz="UTC")),
        "i": pa.array(np.arange(n, dtype=np.int64)),
    }), expect_fallback=["ts"])


def test_wide_direct_run_falls_back_per_column(tmp_path):
    """Random 40-bit keys take DIRECT runs past 24 bits: that column
    falls back alone, in both packages."""
    rng = np.random.default_rng(4)
    n = 2000
    _roundtrip(tmp_path, pa.table({
        "wide": pa.array(rng.integers(0, 1 << 40, n), type=pa.int64()),
        "narrow": pa.array(rng.integers(0, 100, n), type=pa.int64()),
    }), expect_fallback=["wide"])


def test_empty_table(tmp_path):
    t = pa.table({"a": pa.array([], type=pa.int64())})
    path = str(tmp_path / "e.orc")
    paorc.write_table(t, path)
    # no stripes at all: nothing to decode
    assert torc.num_stripes(path) == jorc.num_stripes(path) == 0


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_scan_exec_end_to_end(tmp_path, thr):
    """A planned query over .orc files runs through TpuOrcScanExec and
    gives the reference's rows and per-column fallback count."""
    from spark_rapids_tpu import TpuSparkSession as JSession
    from spark_rapids_tpu import col as jcol
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
    from spark_rapids_tpu_torch.api import col as tcol
    from spark_rapids_tpu_torch.api import functions as TF

    rng = np.random.default_rng(5)
    for i in range(2):
        _write(tmp_path, pa.table({
            "k": pa.array(rng.integers(0, 9, 800), type=pa.int32()),
            "v": pa.array(rng.integers(-50, 50, 800), type=pa.int64()),
            "s": pa.array([f"c{j % 5}" for j in range(800)]),
            "w": pa.array(rng.integers(0, 1 << 40, 800), type=pa.int64()),
        }), thr, f"f{i}.orc")

    def q(s, col, F):
        return (s.read.orc(str(tmp_path)).filter(col("v") > -40)
                .group_by("k", "s").agg(F.sum("v").alias("sv"),
                                        F.count("*").alias("c"),
                                        F.max("w").alias("mw")))

    conf = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}
    ts = TSession(conf, device="cpu")
    df = q(ts, tcol, TF)
    assert "TpuOrcScanExec" in df.explain_string("physical")
    captured = []
    ts.add_plan_listener(captured.append)
    got = df.collect()
    scans = []
    captured[-1].plan.foreach(
        lambda n: scans.append(n) if type(n).__name__ == "TpuOrcScanExec"
        else None)
    # the 40-bit column falls back in each file's one stripe
    assert scans[0].metrics.extra["fallbackColumns"] == 2
    assert getattr(scans[0], "_pushed_filter", None) is None
    want = q(JSession({"spark.rapids.tpu.sql.enabled": False}), jcol,
             JF).collect()
    assert_tables_equal(want, got, ignore_order=True)


@pytest.mark.parametrize("py_walk_runs", [0, 4096],
                         ids=["doubling", "header_loop"])
def test_long_walks_match_the_reference(tmp_path, monkeypatch,
                                        py_walk_runs):
    """Streams of many short runs (order keys repeated 1-7 times, a
    3-value dictionary, small signed values with nulls, a descending
    sequence, 60-bit jumps) walk to the reference's run tables, packed
    bytes and overlays, through the pointer-doubling walk and through
    the header loop; the fallback set is the reference's."""
    monkeypatch.setattr(torc, "_PY_WALK_RUNS", py_walk_runs)
    rng = np.random.default_rng(6)
    n = 24000
    keys = np.repeat(np.arange(n), rng.integers(1, 8, n))[:n]
    jumps = np.cumsum(np.where(np.arange(n) % 50 < 25, 1,
                               rng.integers(0, 1 << 60, n)))
    _roundtrip(tmp_path, pa.table({
        "okey": pa.array(keys, type=pa.int64()),
        "flag": pa.array([["A", "N", "R"][i] for i in
                          rng.integers(0, 3, n)]),
        "small": pa.array(rng.integers(-5, 5, n), type=pa.int32(),
                          mask=rng.random(n) < 0.1),
        "down": pa.array(np.arange(n, dtype=np.int64)[::-1] * 7 -
                         (np.arange(n) % 3)),
        "jump": pa.array(jumps, type=pa.int64()),
        "wide_delta": pa.array(np.cumsum(rng.integers(1 << 40, 1 << 41, n)),
                               type=pa.int64()),
    }), expect_fallback=None)


def test_delta_runs_of_64_bit_magnitudes(tmp_path):
    """Increments of 2^57-2^58 take DELTA runs of 64-bit magnitudes,
    which the port unpacks run by run as the reference does."""
    rng = np.random.default_rng(8)
    v = np.cumsum(rng.integers(1 << 57, 1 << 58, 20))
    t = pa.table({"d": pa.array(v, type=pa.int64())})
    path = _write(tmp_path, t, 0.0)
    with open(path, "rb") as f:
        raw = f.read()
    m = torc.read_meta(raw)
    streams, _ = torc.read_stripe_footer(raw, m, m.stripes[0])
    data = [x for x in streams if x.kind == torc.DATA][0]
    r = torc._walk_headers(torc._decompress(
        m, raw[data.offset:data.offset + data.length]), 20, True)
    assert list(r.kind) == [3] and list(r.w) == [64]
    _roundtrip(tmp_path, t)
