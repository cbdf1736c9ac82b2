"""The port's per-column Parquet decode against the reference, on the CPU.

Small files written with pyarrow from a numpy seed, on the cases of
``tests/test_device_parquet.py`` (plain, dictionary, nulls, all-null,
string dictionary, the plain-string host fallback, booleans, codecs,
date/timestamp, several row groups and pages, pruning, page v2, lists,
mixed dictionary + PLAIN pages, a dotted column name) plus a column
missing from the file and an in-memory blob, decode row group by row group
through the reference's ``decode_row_group`` (its Pallas kernels in
interpret mode) and the port's (the plain torch versions of its kernels).
On the same cases, the run matrix and padded packed bytes that the port's
``_runs_arrays`` fills from its array run tables are held against the
reference's ``_upload_runs`` (which converts lists) for every stream.

Tolerance: the decode moves data and does no arithmetic, so every array of
every column (data, validity, lengths, element validity), the row counts,
capacities, hints and the fallback columns must match exactly, floats bit
for bit; and the port's Arrow output must equal pyarrow's read.
"""

import datetime

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.io import device_parquet as jdp
from spark_rapids_tpu.plan.logical import Schema as JSchema

from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.io import device_parquet as tdp
from spark_rapids_tpu_torch.io import parquet_meta as tpm
from spark_rapids_tpu_torch.plan.logical import Schema as TSchema

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401


def _list_table(n=200, seed=5, with_nulls=True):
    rng = np.random.default_rng(seed)
    py = []
    for i in range(n):
        if with_nulls and i % 11 == 0:
            py.append(None)
        elif i % 7 == 0:
            py.append([])
        else:
            py.append([None if (with_nulls and j % 5 == 3) else
                       int(rng.integers(-1000, 1000))
                       for j in range(int(rng.integers(1, 6)))])
    return pa.table({"l": pa.array(py, type=pa.list_(pa.int64())),
                     "x": pa.array(rng.integers(0, 9, n), type=pa.int32())})


def _case(name):
    """(table, write kwargs, expected fallback columns) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "plain_int_float":
        return pa.table({
            "i32": pa.array(rng.integers(-1000, 1000, 500), pa.int32()),
            "i64": pa.array(rng.integers(-10**12, 10**12, 500), pa.int64()),
            "f32": pa.array(rng.normal(size=500).astype(np.float32)),
            "f64": pa.array(rng.normal(size=500)),
        }), dict(use_dictionary=False), []
    if name == "dictionary":
        return pa.table({
            "k": pa.array(rng.integers(0, 50, 5000), pa.int64()),
            "v": pa.array(rng.choice([1.5, 2.5, 3.5, 4.5], 5000)),
        }), {}, []
    if name in ("nulls_dict", "nulls_plain"):
        n = 3000
        t = pa.table({
            "a": pa.array(rng.integers(0, 30, n).astype(np.int64),
                          mask=rng.random(n) < 0.3),
            "b": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.5)})
        return t, ({} if name == "nulls_dict" else
                   dict(use_dictionary=False)), []
    if name == "all_null":
        return pa.table({"a": pa.array([None] * 100, pa.int32()),
                         "b": pa.array(range(100), pa.int64())}), {}, []
    if name == "string_dictionary":
        words = ["alpha", "beta", "gamma", "", "delta-very-long-value-here"]
        vals = [words[i] for i in rng.integers(0, len(words), 2000)]
        mask = rng.random(2000) < 0.2
        return pa.table({
            "s": pa.array([None if m else v for v, m in zip(vals, mask)],
                          pa.string()),
            "x": pa.array(range(2000), pa.int64())}), {}, []
    if name == "string_plain_falls_back":
        return pa.table({"s": pa.array(["a", "bb", None, "cccc"] * 50),
                         "x": pa.array(range(200), pa.int64())}), \
            dict(use_dictionary=False), ["s"]
    if name == "boolean":
        vals = rng.random(1000) < 0.5
        return pa.table({"b": pa.array(vals, mask=rng.random(1000) < 0.25),
                         "c": pa.array(vals)}), \
            dict(use_dictionary=False), []
    if name in ("snappy", "zstd", "uncompressed"):
        return pa.table({
            "k": pa.array(rng.integers(0, 10, 4000), pa.int32()),
            "v": pa.array(rng.normal(size=4000))}), \
            dict(compression="none" if name == "uncompressed" else name), []
    if name == "date_timestamp":
        base = datetime.date(2020, 1, 1)
        return pa.table({
            "d": pa.array([base + datetime.timedelta(days=int(i))
                           for i in range(300)]),
            "ts": pa.array([datetime.datetime(
                2021, 1, 1, tzinfo=datetime.timezone.utc) +
                datetime.timedelta(seconds=int(i)) for i in range(300)],
                pa.timestamp("us", tz="UTC"))}), {}, []
    if name == "row_groups_and_pages":
        n = 20_000
        return pa.table({
            "k": pa.array(rng.integers(0, 100, n), pa.int32()),
            "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        }), dict(row_group_size=6_000, data_page_size=2_000), []
    if name in ("page_v2_dict", "page_v2_plain"):
        n = 8000
        t = pa.table({
            "k": pa.array(rng.integers(0, 40, n), pa.int32(),
                          mask=rng.random(n) < 0.2),
            "v": pa.array(rng.normal(size=n))})
        kw = dict(data_page_version="2.0", compression="snappy")
        if name == "page_v2_plain":
            kw = dict(data_page_version="2.0", compression="none",
                      use_dictionary=False)
        return t, kw, []
    if name == "list_int":
        return _list_table(), {}, []
    if name == "list_no_nulls":
        return _list_table(with_nulls=False), {}, []
    if name == "list_float_dict":
        vals = [0.5, 1.25, -3.5, 7.0]
        py = [[vals[int(x)] for x in rng.integers(0, 4,
                                                  int(rng.integers(0, 4)))]
              for _ in range(150)]
        return pa.table({"l": pa.array(py, type=pa.list_(pa.float64()))}), \
            {}, []
    if name == "mixed_dict_plain":
        # a small dictionary page limit makes the high-cardinality column
        # overflow its dictionary mid-chunk: dict pages, then PLAIN pages
        n = 60_000
        return pa.table({
            "hi": pa.array(rng.uniform(0, 1, n)),
            "lo": pa.array(rng.integers(0, 50, n), pa.int64()),
        }), dict(dictionary_pagesize_limit=16 << 10,
                 data_page_size=16 << 10), []
    if name == "dotted_name":
        return pa.table({"a.b": pa.array([1, 2, 3], pa.int64()),
                         "c": pa.array([4.0, 5.0, 6.0])}), {}, []
    raise KeyError(name)


CASES = ["plain_int_float", "dictionary", "nulls_dict", "nulls_plain",
         "all_null", "string_dictionary", "string_plain_falls_back",
         "boolean", "snappy", "zstd", "uncompressed", "date_timestamp",
         "row_groups_and_pages", "page_v2_dict", "page_v2_plain",
         "list_int", "list_no_nulls", "list_float_dict",
         "mixed_dict_plain", "dotted_name"]


def _leaves_j(b):
    return [tuple(None if a is None else np.asarray(a) for a in
                  (c.data, c.validity, c.lengths, c.elem_validity))
            for c in b.columns]


def _leaves_t(b):
    return [tuple(None if a is None else a.numpy() for a in
                  (c.data, c.validity, c.lengths, c.elem_validity))
            for c in b.columns]


def assert_batches_equal(tb, jb):
    assert tb.names == jb.names
    assert tb.capacity == jb.capacity
    assert int(tb.num_rows) == int(jb.num_rows)
    assert [c.dtype.name for c in tb.columns] == \
        [c.dtype.name for c in jb.columns]
    assert [(c.vbits, c.nonnull) for c in tb.columns] == \
        [(c.vbits, c.nonnull) for c in jb.columns]
    for name, tl, jl in zip(tb.names, _leaves_t(tb), _leaves_j(jb),
                            strict=True):
        for t, j in zip(tl, jl, strict=True):
            assert (t is None) == (j is None), name
            if t is not None:
                assert t.dtype == j.dtype and t.shape == j.shape, name
                assert np.array_equal(t.view(np.uint8),
                                      j.view(np.uint8)), name


def _decode_both(path, table, columns=None, parquet_file=None):
    """Every row group through both packages; returns the port's Arrow
    output and the fallback columns."""
    js = JSchema.from_arrow(table.schema)
    ts = TSchema.from_arrow(table.schema)
    if columns:
        js = JSchema([js.field(c) for c in columns])
        ts = TSchema([ts.field(c) for c in columns])
    n_rg = papq.ParquetFile(path).metadata.num_row_groups
    got, fbs = [], set()
    for rg in range(n_rg):
        jb, jfb = jdp.decode_row_group(path, rg, js, columns=columns,
                                       parquet_file=parquet_file)
        tb, tfb = tdp.decode_row_group(path, rg, ts, columns=columns,
                                       parquet_file=parquet_file,
                                       device="cpu")
        assert tfb == jfb
        assert tb.device.type == "cpu"
        assert_batches_equal(tb, jb)
        got.append(tbatch.to_arrow(tb))
        fbs.update(tfb)
    return pa.concat_tables(got), sorted(fbs)


@pytest.mark.parametrize("case", CASES)
def test_decode_row_group_matches_reference(tmp_path, case):
    table, kw, expect_fb = _case(case)
    path = str(tmp_path / "t.parquet")
    papq.write_table(table, path, **kw)
    if case == "mixed_dict_plain":
        chunk = tpm.read_chunk_pages(path, 0, 0)
        assert len({p.encoding for p in chunk.data_pages}) > 1
        plan = tdp.plan_chunk(chunk, TSchema.from_arrow(table.schema)
                              .field("hi").dtype, allow_mixed=True)
        assert plan.mode == "mixed"
    if case == "row_groups_and_pages":
        assert papq.ParquetFile(path).metadata.num_row_groups == 4
    got, fbs = _decode_both(path, table)
    assert fbs == expect_fb
    assert_tables_equal(got, table.cast(got.schema))


def test_column_pruning_and_missing_column(tmp_path):
    """A pruned read decodes only its columns; a column the file lacks
    (a partition or evolved-schema column) comes out all-null."""
    t = pa.table({"a": pa.array(range(100), pa.int64()),
                  "b": pa.array(np.arange(100.0)),
                  "c": pa.array(["x"] * 100)})
    path = str(tmp_path / "t.parquet")
    papq.write_table(t, path)
    got, fbs = _decode_both(path, t, columns=["b"])
    assert got.column_names == ["b"] and not fbs
    assert_tables_equal(got, t.select(["b"]))
    wide = t.append_column("gone", pa.array([None] * 100, pa.string())) \
        .append_column("gone_l", pa.array([None] * 100,
                                          pa.list_(pa.int32())))
    js = JSchema.from_arrow(wide.schema)
    ts = TSchema.from_arrow(wide.schema)
    jb, jfb = jdp.decode_row_group(path, 0, js)
    tb, tfb = tdp.decode_row_group(path, 0, ts, device="cpu")
    assert tfb == jfb == []
    assert_batches_equal(tb, jb)
    out = tbatch.to_arrow(tb)
    assert out["gone"].null_count == out["gone_l"].null_count == 100


def test_in_memory_blob(tmp_path):
    """``path`` may be a Parquet blob (bytes): the footer comes from the
    blob and the fallback columns read it too."""
    table, kw, expect_fb = _case("string_plain_falls_back")
    path = str(tmp_path / "t.parquet")
    papq.write_table(table, path, **kw)
    blob = open(path, "rb").read()
    ts = TSchema.from_arrow(table.schema)
    tb, tfb = tdp.decode_row_group(blob, 0, ts, device="cpu")
    jb, jfb = jdp.decode_row_group(blob, 0, JSchema.from_arrow(table.schema))
    assert tfb == jfb == expect_fb
    assert_batches_equal(tb, jb)
    assert_tables_equal(tbatch.to_arrow(tb), table)


def test_decode_chunk_and_list_chunk_match_reference(tmp_path):
    """The chunk-level entry points, flat and list."""
    t = _list_table(300, seed=3)
    path = str(tmp_path / "t.parquet")
    papq.write_table(t, path)
    from spark_rapids_tpu.io import parquet_meta as jpm
    from spark_rapids_tpu import dtypes as jdt
    from spark_rapids_tpu_torch import dtypes as tdt
    tch = tpm.read_chunk_pages(path, 0, 1)
    jch = jpm.read_chunk_pages(path, 0, 1)
    tcol = tdp.decode_chunk(tch, tdt.INT32, 1024, device="cpu")
    jcol = jdp.decode_chunk(jch, jdt.INT32, 1024)
    assert_batches_equal(tbatch.DeviceBatch(["x"], [tcol], 300),
                         jbatch.DeviceBatch(["x"], [jcol], 300))
    tch = tpm.read_chunk_pages(path, 0, 0)
    jch = jpm.read_chunk_pages(path, 0, 0)
    tl = tdp.decode_list_chunk(tch, tdt.list_of(tdt.INT64), 1024, True,
                               device="cpu")
    jl = jdp.decode_list_chunk(jch, jdt.list_of(jdt.INT64), 1024, True)
    assert_batches_equal(tbatch.DeviceBatch(["l"], [tl], 300),
                         jbatch.DeviceBatch(["l"], [jl], 300))


@pytest.mark.parametrize("case", CASES)
def test_upload_runs_matches_reference(tmp_path, case):
    """The run matrix and the padded packed bytes that ``_runs_arrays``
    fills from the run table's arrays for the upload, against the
    reference's ``_upload_runs`` (which converts its lists on every
    call), for every stream of every flat column chunk of every decode
    mode."""
    table, kw, _ = _case(case)
    path = str(tmp_path / "t.parquet")
    papq.write_table(table, path, **kw)
    pf = papq.ParquetFile(path)
    schema = TSchema.from_arrow(table.schema)
    jschema = JSchema.from_arrow(table.schema)
    n_streams = 0
    for rg in range(pf.metadata.num_row_groups):
        for name, leaf in tdp.leaf_map(pf).items():
            chunk = tpm.read_chunk_pages(path, rg, leaf, parquet_file=pf)
            tf, jf = schema.field(name), jschema.field(name)
            try:
                if tf.dtype.is_list:
                    # a list's dictionary index stream: the reference
                    # builds it inside its list decode, so its table is
                    # the port's runs as the reference's lists
                    tp = tdp._plan_list_chunk(chunk, tf.dtype, tf.nullable)
                    r = tp.idx_runs
                    pairs = [] if r is None else [(
                        (r, tp.idx_packed),
                        (jdp.RunTable(r.counts.tolist(), r.is_rle.tolist(),
                                      r.values.tolist(),
                                      r.bit_bases.tolist(),
                                      r.widths.tolist()), tp.idx_packed))]
                else:
                    jp = jdp.plan_chunk(chunk, jf.dtype, True)
                    tp = tdp.plan_chunk(chunk, tf.dtype, True)
                    pairs = [((getattr(tp, f"{k}_runs"),
                               getattr(tp, f"{k}_packed")),
                              (getattr(jp, f"{k}_runs"),
                               getattr(jp, f"{k}_packed")))
                             for k in ("def", "val")]
            except jdp.UnsupportedChunk:
                continue
            for (t_runs, t_packed), (j_runs, j_packed) in pairs:
                got = tdp._runs_arrays(t_runs, t_packed)
                want = jdp._upload_runs(j_runs, j_packed)
                for k in ("runs_mat", "packed"):
                    w = np.asarray(want[k])
                    assert got[k].dtype == w.dtype, (name, k)
                    np.testing.assert_array_equal(got[k], w,
                                                  err_msg=f"{name} {k}")
                n_streams += 1
    assert n_streams > 0
