"""The port's device CSV decode against the reference's.

The ten cases of ``tests/test_device_csv.py``: the same file goes through
both packages' ``decode_csv`` (columns exact, floats bit for bit, the same
fallback lists) and through a planned scan on a port session
(``device="cpu"``) and a reference session (the same rows, the same
``fallbackColumns`` / ``fallbackFiles`` counters on the scan exec).  A
pipe-delimited TPC-H part/partsupp pair at SF 0.002 adds the layout
``TpchLikeSpark``'s CSV setup reads.
"""

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pytest

from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu import col as jcol
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.columnar.batch import to_arrow as jto_arrow
from spark_rapids_tpu.io import device_csv as jcsv
from spark_rapids_tpu.io import readers as jreaders
from spark_rapids_tpu.plan.logical import Schema as JSchema

from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.api import col as tcol
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.columnar.batch import to_arrow as tto_arrow
from spark_rapids_tpu_torch.io import device_csv as tcsv
from spark_rapids_tpu_torch.io import readers as treaders
from spark_rapids_tpu_torch.plan.logical import Schema as TSchema

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True}


def _write_csv(tmp_path, table, name="t.csv", **opts):
    p = str(tmp_path / name)
    pacsv.write_csv(table, p, pacsv.WriteOptions(quoting_style="none",
                                                 **opts))
    return p


def _raw(tmp_path, name: str, data: bytes) -> str:
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p


def _table(n=120, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "i": pa.array(rng.integers(-10**9, 10**9, n), type=pa.int64()),
        "f": pa.array(np.round(rng.normal(size=n) * 1000, 4)),
        "g": pa.array(rng.normal(size=n) * 1e5),
        "s": pa.array([f"name_{int(x)}" for x in rng.integers(0, 50, n)]),
        "b": pa.array([bool(x) for x in rng.integers(0, 2, n)]),
    })


def _bits(a: pa.ChunkedArray) -> np.ndarray:
    return np.array([np.nan if v is None else v for v in a.to_pylist()],
                    dtype=np.float64).view(np.int64)


def _decode_both(path, arrow_schema, **kw):
    """(reference table, reference fallbacks, port table, port
    fallbacks) of one file."""
    jb, jf = jcsv.decode_csv(path, JSchema.from_arrow(arrow_schema), **kw)
    tb, tf = tcsv.decode_csv(path, TSchema.from_arrow(arrow_schema),
                             device="cpu", **kw)
    return jto_arrow(jb), jf, tto_arrow(tb), tf


def _assert_same(ja, ta):
    """Columns exact; float columns bit for bit."""
    assert ja.schema == ta.schema
    for name in ja.column_names:
        if pa.types.is_floating(ja.schema.field(name).type):
            assert (_bits(ja.column(name)) == _bits(ta.column(name))).all(), \
                name
        assert ja.column(name).to_pylist() == ta.column(name).to_pylist(), \
            name


def test_decode_csv_direct(tmp_path):
    t = _table()
    p = _write_csv(tmp_path, t)
    ja, jf, ta, tf = _decode_both(p, t.schema)
    assert jf == tf == []
    _assert_same(ja, ta)
    assert_tables_equal(t.cast(ta.schema), ta)


def test_decode_csv_nulls_and_crlf(tmp_path):
    p = _raw(tmp_path, "n.csv", b"a,b,s\r\n1,,x\r\n,2.5,\r\n-3,0.25,zz\r\n")
    schema = pa.schema([("a", pa.int64()), ("b", pa.float64()),
                        ("s", pa.string())])
    ja, jf, ta, tf = _decode_both(p, schema)
    assert jf == tf == []
    _assert_same(ja, ta)
    assert ta.column("a").to_pylist() == [1, None, -3]
    assert ta.column("b").to_pylist() == [None, 2.5, 0.25]
    assert ta.column("s").to_pylist() == ["x", None, "zz"]


def test_decode_csv_exotic_numeric_column_falls_back(tmp_path):
    # scientific notation in the float column: that COLUMN is read on the
    # host, the rest stays on the device
    p = _raw(tmp_path, "e.csv", b"a,b\n1,1e3\n2,2.5\n3,-4e-2\n")
    schema = pa.schema([("a", pa.int64()), ("b", pa.float64())])
    ja, jf, ta, tf = _decode_both(p, schema)
    assert jf == tf == ["b"]
    _assert_same(ja, ta)
    assert ta.column("b").to_pylist() == [1000.0, 2.5, -0.04]


def test_decode_csv_quoted_raises(tmp_path):
    p = _raw(tmp_path, "q.csv", b'a,s\n1,"x,y"\n')
    schema = pa.schema([("a", pa.int64()), ("s", pa.string())])
    with pytest.raises(jcsv.UnsupportedCsv):
        jcsv.decode_csv(p, JSchema.from_arrow(schema))
    with pytest.raises(tcsv.UnsupportedCsv):
        tcsv.decode_csv(p, TSchema.from_arrow(schema), device="cpu")


def _planned(side: str, path: str, conf=CONF, **read):
    """(rows, scan node names, the scan's fallback counters) of a
    planned read.csv on one side's session."""
    if side == "port":
        s = TSession(conf, device="cpu")
    else:
        s = JSession(conf)
    captured = []
    s.add_plan_listener(captured.append)
    out = s.read.csv(path, **read).collect()
    nodes = []
    captured[-1].plan.foreach(nodes.append)
    names = [type(n).__name__ for n in nodes]
    scan = [n for n in nodes if type(n).__name__ == "TpuCsvScanExec"]
    counters = {k: scan[0].metrics.extra[k]
                for k in ("fallbackColumns", "fallbackFiles")} \
        if scan else None
    return out, names, counters


def test_planned_csv_scan_runs_on_device(tmp_path):
    t = _table(80, seed=5)
    p = _write_csv(tmp_path, t)
    (jo, jn, jc), (to, tn, tc) = (_planned(s, p) for s in ("ref", "port"))
    assert "TpuCsvScanExec" in tn and tn == jn
    assert tc == jc == {"fallbackColumns": 0, "fallbackFiles": 0}
    _assert_same(jo, to)
    assert_tables_equal(t.cast(to.schema), to, ignore_order=True)


def test_planned_csv_quoted_file_host_fallback_inside_exec(tmp_path):
    # quoted file: the EXEC reads the whole file with Arrow, counted
    p = _raw(tmp_path, "q2.csv", b'a,s\n1,"x,y"\n2,plain\n')
    (jo, _, jc), (to, _, tc) = (_planned(s, p) for s in ("ref", "port"))
    assert to.column("s").to_pylist() == ["x,y", "plain"]
    assert tc == jc == {"fallbackColumns": 0, "fallbackFiles": 1}
    _assert_same(jo, to)


def test_decode_csv_int32_out_of_range_falls_back(tmp_path):
    # 3000000000 fits the int64 fold but not int32: the column takes the
    # host fallback instead of wrapping, where permissive semantics make
    # the overflow null
    p = _raw(tmp_path, "o.csv", b"a,b\n1,x\n3000000000,y\n-5,z\n")
    schema = pa.schema([("a", pa.int32()), ("b", pa.string())])
    ja, jf, ta, tf = _decode_both(p, schema)
    assert jf == tf == ["a"]
    _assert_same(ja, ta)
    assert ta.column("a").to_pylist() == [1, None, -5]
    assert ta.column("b").to_pylist() == ["x", "y", "z"]


def test_decode_csv_fractional_in_int_column_is_null(tmp_path):
    p = _raw(tmp_path, "fr.csv", b"a,b\n1,x\n3.5,y\n-2,z\n")
    schema = pa.schema([("a", pa.int32()), ("b", pa.string())])
    ja, jf, ta, tf = _decode_both(p, schema)
    assert jf == tf == ["a"]
    _assert_same(ja, ta)
    assert ta.column("a").to_pylist() == [1, None, -2]


def test_csv_whole_file_fallback_is_also_permissive(tmp_path):
    p = _raw(tmp_path, "qperm.csv", b'a,s\n1,"x,y"\n3000000000,z\n')
    schema = pa.schema([("a", pa.int32()), ("s", pa.string())])
    with pytest.raises(tcsv.UnsupportedCsv):
        tcsv.decode_csv(p, TSchema.from_arrow(schema), device="cpu")
    opts = {"header": True, "sep": ","}
    jt = jreaders._normalize(jreaders._read_csv(p, opts),
                             JSchema.from_arrow(schema), permissive=True)
    tt = treaders._normalize(treaders._read_csv(p, opts),
                             TSchema.from_arrow(schema), permissive=True)
    assert tt.equals(jt)
    assert tt.column("a").to_pylist() == [1, None]


def test_csv_device_decode_kill_switch(tmp_path):
    t = _table(30, seed=7)
    p = _write_csv(tmp_path, t)
    conf = dict(CONF, **{
        "spark.rapids.tpu.sql.format.csv.deviceDecode.enabled": False})
    (jo, jn, jc), (to, tn, tc) = (_planned(s, p, conf)
                                  for s in ("ref", "port"))
    assert "TpuCsvScanExec" not in tn and tn == jn
    assert tc is None and jc is None
    assert to.num_rows == 30
    _assert_same(jo, to)


def test_date_column_sends_the_whole_file_to_the_host(tmp_path):
    """A DATE32 column, even a pruned one, sends the whole file to the
    host (the reference's rule: the schema's types are checked before
    the prescan)."""
    t = pa.table({"a": pa.array([1, 2, 3], type=pa.int64()),
                  "d": pa.array(np.array([1, 2, 3], dtype="datetime64[D]"))})
    p = _write_csv(tmp_path, t)
    for mod, schema in ((jcsv, JSchema), (tcsv, TSchema)):
        kw = {} if mod is jcsv else {"device": "cpu"}
        with pytest.raises(mod.UnsupportedCsv):
            mod.decode_csv(p, schema.from_arrow(t.schema), columns=["a"],
                           **kw)


@pytest.fixture(scope="module")
def tpch_pipe(tmp_path_factory):
    """TPC-H part and partsupp at SF 0.002, pipe-delimited with a header
    and no trailing delimiter."""
    from spark_rapids_tpu_torch.bench import tpch
    tables = tpch.generate(0.002, seed=7)
    d = tmp_path_factory.mktemp("tpch_pipe")
    paths = {name: _write_csv(d, tables[name], f"{name}.tbl",
                              delimiter="|")
             for name in ("part", "partsupp")}
    return tables, paths


@pytest.mark.parametrize("name", ["part", "partsupp"])
def test_tpch_pipe_delimited_decode(tpch_pipe, name):
    tables, paths = tpch_pipe
    t = tables[name]
    ja, jf, ta, tf = _decode_both(paths[name], t.schema, sep="|")
    assert jf == tf == []
    _assert_same(ja, ta)
    assert ta.num_rows == t.num_rows


def test_tpch_pipe_delimited_planned_join(tpch_pipe):
    """A join and aggregate over both pipe-delimited files on a port
    session, against the reference's CPU session."""
    _, paths = tpch_pipe

    def q(s, col, F):
        ps = s.read.csv(paths["partsupp"], sep="|")
        p = s.read.csv(paths["part"], sep="|")
        return (ps.join(p, col("ps_partkey") == col("p_partkey"))
                .filter(col("p_size") < 20)
                .group_by("p_brand")
                .agg(F.min("ps_supplycost").alias("mc"),
                     F.sum("ps_availqty").alias("qty")))

    ts = TSession(CONF, device="cpu")
    df = q(ts, tcol, TF)
    assert "TpuCsvScanExec" in df.explain_string("physical")
    got = df.collect()
    want = q(JSession({"spark.rapids.tpu.sql.enabled": False}), jcol,
             JF).collect()
    assert_tables_equal(want, got, ignore_order=True)


def test_float_fold_is_the_references_fused_value(tmp_path):
    """The reference's program computes ``int + frac / 10**n`` as one
    fused multiply-add of frac and the rounded reciprocal, which is not
    always Arrow's correctly rounded value: "0.35" parses to
    0.35000000000000003 there and in the port, 0.35 in Arrow; "2.78"
    to 2.78, where the two-step formula gives 2.7800000000000002."""
    p = _raw(tmp_path, "fl.csv", b"x\n0.35\n0.7\n2.78\n-0.35\n")
    schema = pa.schema([("x", pa.float64())])
    ja, _, ta, _ = _decode_both(p, schema)
    _assert_same(ja, ta)
    want = [0.35000000000000003, 0.7000000000000001, 2.78,
            -0.35000000000000003]
    assert ta.column("x").to_pylist() == want
    arrow = pacsv.read_csv(p).column("x").to_pylist()
    assert arrow == [0.35, 0.7, 2.78, -0.35]


def test_pruned_scan_decodes_on_the_device(tmp_path):
    """A scan that reads fewer columns than the file holds: the reference
    hands the pruned schema to decode_csv, whose prescan then counts the
    file's delimiters against fewer columns and sends the whole file to
    the host ("ragged rows"); the port decodes against the unpruned
    schema.  The rows are the same."""
    t = _table(60, seed=9)
    p = _write_csv(tmp_path, t)

    def q(s, col, F):
        return s.read.csv(p).filter(col("i") > 0).group_by("s").agg(
            F.sum("i").alias("si"), F.max("f").alias("mf"))

    outs, counters = {}, {}
    for side, (cls, col, F) in {"ref": (JSession, jcol, JF),
                                "port": (TSession, tcol, TF)}.items():
        s = cls(CONF) if side == "ref" else cls(CONF, device="cpu")
        captured = []
        s.add_plan_listener(captured.append)
        outs[side] = q(s, col, F).collect()
        nodes = []
        captured[-1].plan.foreach(nodes.append)
        scan = [n for n in nodes if type(n).__name__ == "TpuCsvScanExec"][0]
        counters[side] = (scan.metrics.extra["fallbackColumns"],
                          scan.metrics.extra["fallbackFiles"])
    assert counters == {"ref": (0, 1), "port": (0, 0)}
    assert_tables_equal(outs["ref"], outs["port"], ignore_order=True)
