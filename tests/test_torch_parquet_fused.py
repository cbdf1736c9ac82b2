"""The port's fused Parquet scan against the reference, on the CPU.

Small files written with pyarrow from a numpy seed (several row groups,
small data pages so runs cross pages) go through both packages: the host
page walk (``plan_chunk``), the assembled upload set (``assemble``), and
the decoded batch (``prepare_fused``/``finish_fused``; the reference with
its Pallas kernels in interpret mode, the port with the plain torch
versions of its kernels).  The files cover nulls, a one-entry dictionary,
1-bit streams, a string dictionary, a column missing from one file, a
decimal column that takes the host fallback, and a pushed filter that
defers an int and a string dictionary column.  pyarrow writes a one-entry
dictionary's codes 1 bit wide, so a crafted width-0 stream covers
width 0, and crafted streams hold the vectorised ``assemble`` to the
reference's loops on the general path (more than ``_SLICE_MAX_RUNS``
runs), two widths in one stream, trimmed page-end runs and width-0
pages.  The port's run tables are numpy arrays of fixed dtypes, held to
the reference's lists value for value.  Last, the q6 and q6s
plans against a reference session running the bench's q6 and against
pyarrow.

Tolerance: the decode moves data and does no arithmetic, so every array
and every decoded value must match exactly; aggregate averages to 1e-9
relative (they are sums taken in another order).
"""

import dataclasses
import decimal
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as papq
import pytest
import torch

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.expr import ir as jir
from spark_rapids_tpu.io import device_parquet as jdp
from spark_rapids_tpu.io import parquet_fused as jpf
from spark_rapids_tpu.io import parquet_meta as jpm
from spark_rapids_tpu.plan.logical import Field as JField
from spark_rapids_tpu.plan.logical import Schema as JSchema

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar.interop import fused_arrays_to_torch
from spark_rapids_tpu_torch.config import RapidsTpuConf
from spark_rapids_tpu_torch.entry import (collect, q6_parquet_plan,
                                          q6_perfile_plan, q6s_parquet_plan,
                                          write_store_sales)
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.io import device_parquet as tdp
from spark_rapids_tpu_torch.io import parquet_fused as tpf
from spark_rapids_tpu_torch.io import parquet_meta as tpm
from spark_rapids_tpu_torch.io import scan_cache as tsc
from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.plan.logical import Field as TField
from spark_rapids_tpu_torch.plan.logical import Schema as TSchema

from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-9

# name -> (arrow type, port/reference dtype name)
COLUMNS = {
    "k": (pa.int64(), "bigint"),        # int dictionary with nulls
    "q": (pa.int32(), "int"),           # int dictionary, no nulls
    "p": (pa.float64(), "double"),      # PLAIN, nulls: the condition
    "s": (pa.string(), "string"),       # string dictionary with nulls
    "one": (pa.int64(), "bigint"),      # one-entry dictionary
    "b": (pa.bool_(), "boolean"),       # PLAIN boolean: 1-bit runs
    "f": (pa.float32(), "float"),       # PLAIN with nulls
    "dec": (pa.decimal128(10, 2), "double"),  # host fallback
    "x": (pa.int32(), "int"),           # dictionary, missing from file 1
}
DICT_COLS = ["k", "q", "s", "one", "x"]
FILE_ROWS = (3000, 1700)


def _table(n: int, seed: int, with_x: bool) -> pa.Table:
    rng = np.random.default_rng(seed)
    words = np.array([("w" * (i % 19 + 1)) + str(i) for i in range(30)])
    cols = {
        "k": pa.array(rng.integers(1, 41, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "q": pa.array(rng.integers(1, 91, n), pa.int32()),
        "p": pa.array(np.round(rng.uniform(0.0, 100.0, n), 2),
                      mask=rng.random(n) < 0.05),
        "s": pa.array(words[rng.integers(0, 30, n)],
                      mask=rng.random(n) < 0.1),
        "one": pa.array(np.full(n, 7), pa.int64()),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "f": pa.array(rng.normal(size=n).astype(np.float32),
                      mask=rng.random(n) < 0.2),
        "dec": pa.array([None if i % 11 == 0 else
                         decimal.Decimal(int(v)).scaleb(-2) for i, v in
                         enumerate(rng.integers(-10**6, 10**6, n))],
                        pa.decimal128(10, 2)),
    }
    if with_x:
        cols["x"] = pa.array(rng.integers(0, 300, n), pa.int32())
    return pa.table(cols)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused")
    paths = []
    for i, n in enumerate(FILE_ROWS):
        t = _table(n, 30 + i, with_x=(i == 0))
        p = str(root / f"part-{i}.parquet")
        papq.write_table(t, p, row_group_size=1024, data_page_size=256,
                         use_dictionary=[c for c in DICT_COLS
                                         if c in t.column_names])
        paths.append(p)
    return paths


def _sources(paths):
    return [(papq.ParquetFile(p), p, rg) for p in paths
            for rg in range(papq.ParquetFile(p).metadata.num_row_groups)]


def _schemas():
    j = JSchema([JField(c, jdt.DType(jdt.TypeId(d)))
                 for c, (_, d) in COLUMNS.items()])
    t = TSchema([TField(c, tdt.DType(tdt.TypeId(d)))
                 for c, (_, d) in COLUMNS.items()])
    return j, t


def _conditions(names):
    """p > 40.0, bound over ``names`` in both packages."""
    j, t = _schemas()
    jc = jir.bind(jir.GreaterThan(jir.UnresolvedAttribute("p"),
                                  jir.Literal(40.0)),
                  names, [j.field(c).dtype for c in names],
                  [True] * len(names))
    tc = tir.bind(tir.GreaterThan(tir.UnresolvedAttribute("p"),
                                  tir.Literal(40.0)),
                  names, [t.field(c).dtype for c in names],
                  [True] * len(names))
    return jc, tc


# ---------------------------------------------------------------------------
# the host page walk
# ---------------------------------------------------------------------------

RUN_FIELDS = {"counts": np.int64, "is_rle": np.bool_, "values": np.int64,
              "bit_bases": np.int64, "widths": np.int32}


def _plan_fields(p):
    out = {k: getattr(p, k) for k in ("n_rows", "nullable", "mode",
                                      "def_packed", "val_packed",
                                      "page_segs")}
    out["out_dtype"] = p.out_dtype.name
    for a in ("plain_np", "dict_np", "dict_lens"):
        v = getattr(p, a)
        out[a] = None if v is None else (str(v.dtype), v.tolist())
    return out


def _assert_runs_equal(t_runs, j_runs):
    """The port's run table holds numpy arrays of fixed dtypes; the
    reference's holds lists: compare values as arrays."""
    for k, dtype in RUN_FIELDS.items():
        got = getattr(t_runs, k)
        assert isinstance(got, np.ndarray) and got.dtype == dtype, k
        np.testing.assert_array_equal(
            got, np.asarray(getattr(j_runs, k), dtype=dtype), err_msg=k)


@pytest.mark.parametrize("column", list(COLUMNS))
def test_plan_chunk_matches_reference(files, column):
    j, t = _schemas()
    walks, walked = tpm.walk_count(), tpm.bytes_walked()
    n_chunks = n_bytes = 0
    for pf, path, rg in _sources(files):
        leaf = tdp.leaf_map(pf)
        assert leaf == jdp.leaf_map(pf)
        if column not in leaf:
            continue
        n_chunks += 1
        n_bytes += pf.metadata.row_group(rg).column(
            leaf[column]).total_compressed_size
        tch = tpm.read_chunk_pages(path, rg, leaf[column], parquet_file=pf)
        jch = jpm.read_chunk_pages(path, rg, leaf[column], parquet_file=pf)
        assert dataclasses.asdict(tch) == dataclasses.asdict(jch)
        for mixed in (False, True):
            try:
                jp = jdp.plan_chunk(jch, j.field(column).dtype, mixed)
            except jdp.UnsupportedChunk as e:
                with pytest.raises(tdp.UnsupportedChunk, match=str(e)):
                    tdp.plan_chunk(tch, t.field(column).dtype, mixed)
                continue
            tp = tdp.plan_chunk(tch, t.field(column).dtype, mixed)
            assert _plan_fields(tp) == _plan_fields(jp)
            _assert_runs_equal(tp.def_runs, jp.def_runs)
            _assert_runs_equal(tp.val_runs, jp.val_runs)
    assert tpm.walk_count() == walks + n_chunks
    assert tpm.bytes_walked() == walked + n_bytes


# ---------------------------------------------------------------------------
# the assembled upload set
# ---------------------------------------------------------------------------

def _plans(pkg_dp, schema, files, wanted):
    srcs = _sources(files)
    out = []
    for c in wanted:
        col = []
        for pf, path, rg in srcs:
            leaf = pkg_dp.leaf_map(pf)
            if c not in leaf:
                col.append(None)
                continue
            pm = tpm if pkg_dp is tdp else jpm
            chunk = pm.read_chunk_pages(path, rg, leaf[c], parquet_file=pf)
            col.append(pkg_dp.plan_chunk(chunk, schema.field(c).dtype))
        out.append(col)
    n_rows = [pf.metadata.row_group(rg).num_rows for pf, _, rg in srcs]
    return out, n_rows


DEVICE_COLS = [c for c in COLUMNS if c != "dec"]


@pytest.mark.parametrize("pushed", [False, True])
def test_assemble_matches_reference(files, pushed):
    j, t = _schemas()
    jplans, n_rows = _plans(jdp, j, files, DEVICE_COLS)
    tplans, _ = _plans(tdp, t, files, DEVICE_COLS)
    jc, tc = _conditions(DEVICE_COLS) if pushed else (None, None)
    jfp = jpf.assemble(jplans, [j.field(c).dtype for c in DEVICE_COLS],
                       DEVICE_COLS, n_rows, backend="pallas",
                       pushed_filter=jc, scan_names=DEVICE_COLS)
    tfp = tpf.assemble(tplans, [t.field(c).dtype for c in DEVICE_COLS],
                       DEVICE_COLS, n_rows, pushed_filter=tc,
                       scan_names=DEVICE_COLS, device="cpu")
    assert sorted(tfp.arrays) == sorted(jfp.arrays)
    for k, v in jfp.arrays.items():
        assert tfp.arrays[k].dtype == v.dtype, k
        assert np.array_equal(tfp.arrays[k], v), k
    assert tfp.stream_path == jfp.stream_path
    assert tfp.widths == jfp.widths
    assert (tfp.cap, tfp.vcap, tfp.nslcap, tfp.col_vbits) == \
        (jfp.cap, jfp.vcap, jfp.nslcap, jfp.col_vbits)
    assert [[dataclasses.asdict(s) for s in row] for row in tfp.specs] == \
        [[dataclasses.asdict(s) for s in row] for row in jfp.specs]
    if pushed:
        assert tfp.pushed[2] == jfp.pushed[2] == ("k", "q", "s", "one",
                                                  "x")
    else:
        assert tfp.pushed is None and jfp.pushed is None
    # 1-bit streams (def levels, booleans) and several code widths
    assert tfp.widths[0][0] == 1 and len(tfp.widths) >= 4


def _crafted_runs(rng, pages):
    """(rows, packed) of one hybrid stream walked page by page: each page
    ``(w, n_runs, trim)`` alternates RLE runs and bit-packed groups of
    width w over random bytes, the page's last bit-packed run trimmed by
    ``trim`` values (its padding stays in the packed bytes).  A width-0
    page holds RLE runs only, with no value bytes."""
    rows, packed = [], bytearray()
    for w, n_runs, trim in pages:
        last_bp = None
        for k in range(n_runs):
            if k % 2 == 0 or not w:
                v = int(rng.integers(0, 1 << w)) if w else 0
                rows.append([int(rng.integers(1, 40)), True, v, 0, w])
            else:
                g = int(rng.integers(1, 5))
                rows.append([8 * g, False, 0, len(packed) * 8, w])
                packed += rng.integers(0, 256, g * w, np.uint8).tobytes()
                last_bp = len(rows) - 1
        if trim and last_bp is not None:
            rows[last_bp][0] -= trim
    return rows, bytes(packed)


def _crafted_plans():
    """Both packages' ChunkPlans of two dictionary columns over two row
    groups: nullable segments whose def-level streams hold more than
    ``_SLICE_MAX_RUNS`` runs (the general path), index streams mixing
    widths 3 and 5 across pages with trimmed page-end runs, and width-0
    pages (RLE runs of no value bytes) before a 3-bit page."""
    rng = np.random.default_rng(77)
    out = {"t": [[], []], "j": [[], []]}
    n_rows = []
    for rg in range(2):
        d_rows, d_packed = _crafted_runs(rng, [(1, 13, 3), (1, 6, 0)])
        n = sum(r[0] for r in d_rows)
        n_rows.append(n)
        for ci, pages in enumerate(([(3, 9, 5), (5, 7, 2)],
                                    [(0, 3, 0), (3, 4, 1)])):
            v_rows, v_packed = _crafted_runs(rng, pages)
            for name, pkg_dp, pkg_dt in (("t", tdp, tdt), ("j", jdp, jdt)):
                def table(rows):
                    cols = list(zip(*rows)) if rows else [[]] * 5
                    return pkg_dp.RunTable(*[list(c) for c in cols])
                out[name][ci].append(pkg_dp.ChunkPlan(
                    n_rows=n, nullable=True, out_dtype=pkg_dt.INT64,
                    mode="dict", def_runs=table(d_rows),
                    def_packed=d_packed, val_runs=table(v_rows),
                    val_packed=v_packed,
                    dict_np=np.arange(40, dtype=np.int64)))
    return out, n_rows


def test_assemble_matches_reference_on_crafted_streams():
    """The vectorised assembly against the reference's loops on streams
    the files above do not all give: the general path, mixed widths in
    one stream, trimmed page-end runs, width-0 pages and nulls."""
    plans, n_rows = _crafted_plans()
    tfp = tpf.assemble(plans["t"], [tdt.INT64] * 2, ["a", "b"], n_rows,
                       device="cpu")
    jfp = jpf.assemble(plans["j"], [jdt.INT64] * 2, ["a", "b"], n_rows,
                       backend="pallas")
    assert sorted(tfp.arrays) == sorted(jfp.arrays)
    for k, v in jfp.arrays.items():
        assert tfp.arrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tfp.arrays[k], v, err_msg=k)
    assert tfp.stream_path == jfp.stream_path
    assert {p for p, _ in tfp.stream_path} == {"slice", "general"}
    assert (tfp.widths, tfp.nslcap, tfp.cap, tfp.vcap) == \
        (jfp.widths, jfp.nslcap, jfp.cap, jfp.vcap)
    assert [w for w, _ in tfp.widths] == [1, 3, 5]
    assert [[dataclasses.asdict(s) for s in row] for row in tfp.specs] == \
        [[dataclasses.asdict(s) for s in row] for row in jfp.specs]


def test_width_zero_stream_matches_reference():
    """A dictionary page whose codes are 0 bits wide: RLE runs with no
    value bytes, across two pages."""
    page = bytes([0xD0, 0x0F])               # RLE run of 1000, no value
    plans = {}
    for name, pkg_dp in (("t", tdp), ("j", jdp)):
        # the port walks into RunBuilder lists and freezes them into arrays
        runs = tdp.RunBuilder() if name == "t" else jdp.RunTable.empty()
        packed = bytearray()
        for _ in range(2):
            assert pkg_dp.walk_hybrid(page, 0, 2, 0, packed, runs) == 1000
        assert runs.values == [0, 0] and runs.widths == [0, 0]
        if name == "t":
            runs = runs.table()
        dtype = (tdt if name == "t" else jdt).INT64
        plans[name] = pkg_dp.ChunkPlan(
            n_rows=2000, nullable=False, out_dtype=dtype, mode="dict",
            def_runs=pkg_dp.RunTable.empty(), val_runs=runs,
            val_packed=bytes(packed), dict_np=np.array([7], np.int64))
    tfp = tpf.assemble([[plans["t"]]], [tdt.INT64], ["z"], [2000],
                       device="cpu")
    jfp = jpf.assemble([[plans["j"]]], [jdt.INT64], ["z"], [2000],
                       backend="pallas")
    assert tfp.widths == jfp.widths == ()
    assert sorted(tfp.arrays) == sorted(jfp.arrays)
    for k, v in jfp.arrays.items():
        assert np.array_equal(tfp.arrays[k], v), k
    (col,), total = tpf._make_kernel(tfp)(
        fused_arrays_to_torch(tfp.arrays, "cpu"))
    assert total == 2000
    assert col.data[:2000].tolist() == [7] * 2000
    assert bool(col.validity[:2000].all()) and not col.data[2000:].any()


# ---------------------------------------------------------------------------
# the decoded batch
# ---------------------------------------------------------------------------

def _j_leaves(b):
    return [(np.asarray(c.data), np.asarray(c.validity),
             None if c.lengths is None else np.asarray(c.lengths))
            for c in b.columns]


def _t_leaves(b):
    return [(c.data.numpy(), c.validity.numpy(),
             None if c.lengths is None else c.lengths.numpy())
            for c in b.columns]


def _assert_leaves_equal(tl, jl):
    for (td, tv, tln), (jd, jv, jln) in zip(tl, jl, strict=True):
        assert td.dtype == jd.dtype and td.shape == jd.shape
        assert np.array_equal(tv, jv)
        assert np.array_equal(td, jd, equal_nan=td.dtype.kind == "f")
        assert (tln is None) == (jln is None)
        if tln is not None:
            assert np.array_equal(tln, jln)


@pytest.fixture(scope="module", params=[False, True],
                ids=["eager", "pushed"])
def decoded(request, files):
    """One fused batch over every row group of both files, decoded by
    both packages (the reference with backend pallas, interpreted)."""
    j, t = _schemas()
    names = list(COLUMNS)
    jc, tc = _conditions(names) if request.param else (None, None)
    jprep = jpf.prepare_fused(_sources(files), j, columns=names,
                              backend="pallas", pushed_filter=jc,
                              scan_names=names)
    jb, jfb = jpf.finish_fused(jprep)
    kb.reset_counts()
    tprep = tpf.prepare_fused(_sources(files), t, columns=names,
                              pushed_filter=tc, scan_names=names,
                              device="cpu")
    tb, tfb = tpf.finish_fused(tprep)
    return dict(jprep=jprep, jb=jb, jfb=jfb, tprep=tprep, tb=tb, tfb=tfb,
                fallbacks=dict(kb.fallbacks), pushed=request.param)


def test_finish_fused_matches_reference(decoded):
    jb, tb = decoded["jb"], decoded["tb"]
    assert decoded["tfb"] == decoded["jfb"] == ["dec"]
    assert tb.names == jb.names and tb.capacity == jb.capacity
    assert tb.num_rows == int(jb.num_rows) == sum(FILE_ROWS)
    assert tb.device.type == "cpu"
    _assert_leaves_equal(_t_leaves(tb), _j_leaves(jb))
    assert [(c.vbits, c.nonnull) for c in tb.columns] == \
        [(c.vbits, c.nonnull) for c in jb.columns]
    assert tbatch.to_arrow(tb).equals(jbatch.to_arrow(jb))
    deferred = decoded["tprep"].fp.pushed
    assert (deferred is not None) == decoded["pushed"]
    # no reference kernel gate refused a deferral on these shapes
    assert not any(k.startswith("scan.filterDecode")
                   for k in decoded["fallbacks"])


def test_decoded_values_match_pyarrow(decoded, files):
    """Live rows decode to the files' values, except where the pushed
    filter dropped the row: a deferred column holds 0 there."""
    got = tbatch.to_arrow(decoded["tb"])
    want = pa.concat_tables([papq.read_table(p) for p in files],
                            promote_options="default")
    keep = np.ones(got.num_rows, bool)
    if decoded["pushed"]:
        keep = pc.fill_null(pc.greater(want["p"], 40.0), False).to_numpy()
    for c in COLUMNS:
        w = want[c].cast(got[c].type)
        if decoded["pushed"] and c in DICT_COLS:
            assert got[c].filter(keep).equals(w.filter(keep)), c
        else:
            assert got[c].equals(w), c


def test_same_upload_set_through_both_device_halves(decoded):
    """The reference's assembled upload set, carried across as numpy,
    decodes through the port's device half to the reference's batch."""
    jfp = decoded["jprep"].fp
    tfp = decoded["tprep"].fp
    arrays = fused_arrays_to_torch(jfp.arrays, "cpu")
    cols, total = tpf._make_kernel(tfp)(arrays)
    assert total == sum(FILE_ROWS)
    jcols = [c for n, c in zip(decoded["jb"].names, decoded["jb"].columns)
             if n in decoded["tprep"].dev_cols]
    _assert_leaves_equal(
        _t_leaves(tbatch.DeviceBatch(tfp.names, cols, total)),
        [(np.asarray(c.data), np.asarray(c.validity),
          None if c.lengths is None else np.asarray(c.lengths))
         for c in jcols])


def test_unpack_dense_writes_each_width_in_place(decoded):
    """Phase 0 allocates the dense array once and unpacks each width
    into its slice: the same array as a zero pad, each width's values
    and a zero pad concatenated."""
    from spark_rapids_tpu_torch.kernels import decode as tdec
    fp = decoded["tprep"].fp
    assert fp.widths
    arrays = fused_arrays_to_torch(fp.arrays, "cpu")
    pad = torch.zeros(fp.vcap, dtype=torch.int32)
    want = torch.cat([pad] + [tdec.plain_unpack_bits(arrays[f"bits_{w}"], w,
                                                     ncap)
                              for w, ncap in fp.widths] + [pad])
    assert torch.equal(tpf.unpack_dense(fp, arrays), want)


def test_scan_without_device_columns_keeps_its_device(files):
    batch, fallbacks = tpf.decode_row_groups_fused(
        _sources(files), TSchema([]), columns=[], device="cpu")
    assert fallbacks == [] and batch.columns == []
    assert batch.device.type == "cpu"
    assert batch.num_rows == sum(FILE_ROWS)


def test_list_column_in_fused_batch_matches_reference(tmp_path):
    """A list column of a fused batch decodes per row group through the
    list decode and concatenates on the device, beside the fused flat
    columns, as in the reference."""
    rng = np.random.default_rng(21)
    paths = []
    for i, n in enumerate((700, 450)):
        py = [None if j % 9 == 0 else
              [int(x) for x in rng.integers(-50, 50, int(rng.integers(0, 5)))]
              for j in range(n)]
        t = pa.table({"l": pa.array(py, type=pa.list_(pa.int32())),
                      "q": pa.array(rng.integers(0, 20, n), pa.int32())})
        p = str(tmp_path / f"l{i}.parquet")
        papq.write_table(t, p, row_group_size=300)
        paths.append(p)
    jschema = JSchema([JField("l", jdt.list_of(jdt.INT32)),
                       JField("q", jdt.INT32)])
    tschema = TSchema([TField("l", tdt.list_of(tdt.INT32)),
                       TField("q", tdt.INT32)])
    jb, jfb = jpf.finish_fused(jpf.prepare_fused(_sources(paths), jschema,
                                                 backend="pallas"))
    tb, tfb = tpf.decode_row_groups_fused(_sources(paths), tschema,
                                          device="cpu")
    assert tfb == jfb == []
    assert tb.names == jb.names and tb.capacity == jb.capacity
    _assert_leaves_equal(_t_leaves(tb), _j_leaves(jb))
    jl, tl = jb.columns[0], tb.columns[0]
    assert np.array_equal(tl.elem_validity.numpy(),
                          np.asarray(jl.elem_validity))
    want = pa.concat_tables([papq.read_table(p) for p in paths])
    assert tbatch.to_arrow(tb).equals(want)


# ---------------------------------------------------------------------------
# q6 and q6s end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store_sales(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store_sales"))
    write_store_sales(root, 40_003, files=3, seed=100, item_id=True)
    return root


def _q6_pyarrow(root):
    t = papq.read_table(root)
    return t.filter(pc.greater(t["ss_sales_price"], 150.0))


def test_write_store_sales_is_the_bench_dataset(store_sales):
    import bench
    paths = sorted(os.listdir(store_sales))
    assert paths == [f"part-{i:04d}.parquet" for i in range(3)]
    rows = [papq.ParquetFile(os.path.join(store_sales, p)).metadata.num_rows
            for p in paths]
    assert rows == [13_335, 13_334, 13_334]
    t = papq.read_table(os.path.join(store_sales, paths[1]))
    ref = bench._gen_store_sales(13_334, seed=101)
    assert t.drop_columns(["ss_item_id"]).equals(ref)
    meta = papq.ParquetFile(os.path.join(store_sales, paths[1])).metadata
    encs = {meta.schema.column(i).name:
            "RLE_DICTIONARY" in meta.row_group(0).column(i).encodings
            for i in range(meta.num_columns)}
    assert encs == {"ss_sold_date_sk": True, "ss_item_sk": True,
                    "ss_quantity": True, "ss_list_price": False,
                    "ss_sales_price": False, "ss_ext_sales_price": False,
                    "ss_item_id": True}


def test_q6_parquet_plan_matches_reference_session_and_pyarrow(
        store_sales):
    import bench
    from spark_rapids_tpu import TpuSparkSession
    kb.reset_counts()
    tsc.clear()
    conf = RapidsTpuConf({"spark.rapids.tpu.sql.reader.batchSizeRows":
                          16_384})
    plan = q6_parquet_plan(store_sales, device="cpu", conf=conf)
    out = collect(plan).sort_by("ss_item_sk")
    scan = plan.children[0].children[0]
    assert scan.metrics.num_output_batches == 3
    assert scan.metrics.extra["fallbackColumns"] == 0
    assert not kb.fallbacks
    session = TpuSparkSession({
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True})
    ref = bench._query(session, store_sales).collect().sort_by("ss_item_sk")
    pa_ref = _q6_pyarrow(store_sales).group_by("ss_item_sk").aggregate(
        [("ss_item_sk", "count"), ("ss_quantity", "sum"),
         ("ss_ext_sales_price", "mean")]).sort_by("ss_item_sk")
    for want_k, want_c, want_q, want_a in (
            (ref["ss_item_sk"], ref["cnt"], ref["qty"], ref["aesp"]),
            (pa_ref["ss_item_sk"], pa_ref["ss_item_sk_count"],
             pa_ref["ss_quantity_sum"],
             pa_ref["ss_ext_sales_price_mean"])):
        assert out["ss_item_sk"].to_pylist() == want_k.to_pylist()
        assert out["cnt"].to_pylist() == want_c.to_pylist()
        assert out["qty"].to_pylist() == want_q.to_pylist()
        a, r = out["aesp"].to_numpy(), want_a.to_numpy()
        assert np.all(np.abs(a - r) <= REL * np.abs(r))
    # a warm run serves every chunk plan from the cache: no page walks
    walks = tpm.walk_count()
    again = collect(q6_parquet_plan(store_sales, device="cpu", conf=conf))
    assert tpm.walk_count() == walks
    assert again.sort_by("ss_item_sk").equals(out)


def test_q6s_parquet_plan_matches_pyarrow(store_sales):
    from spark_rapids_tpu import TpuSparkSession, col
    from spark_rapids_tpu import functions as F
    out = collect(q6s_parquet_plan(store_sales, device="cpu"))
    out = out.sort_by("ss_item_id")
    session = TpuSparkSession()
    ref = (session.read.parquet(store_sales)
           .filter(col("ss_sales_price") > 150.0)
           .group_by("ss_item_id")
           .agg(F.count("*").alias("cnt"),
                F.sum("ss_quantity").alias("qty"))
           ).collect().sort_by("ss_item_id")
    pa_ref = _q6_pyarrow(store_sales).group_by("ss_item_id").aggregate(
        [("ss_item_id", "count"), ("ss_quantity", "sum")]
    ).sort_by("ss_item_id")
    for want_k, want_c, want_q in (
            (ref["ss_item_id"], ref["cnt"], ref["qty"]),
            (pa_ref["ss_item_id"], pa_ref["ss_item_id_count"],
             pa_ref["ss_quantity_sum"])):
        assert out["ss_item_id"].to_pylist() == want_k.to_pylist()
        assert out["cnt"].to_pylist() == want_c.to_pylist()
        assert out["qty"].to_pylist() == want_q.to_pylist()
    assert all(len(s) == 16 for s in out["ss_item_id"].to_pylist())


def _predicted_perfile_counts(root):
    """Expand launches, mixed-width fallbacks and streams with a packed
    width (whose expansion reads bits in the same launch) that q6 through
    the PERFILE reader must make, from its chunk plans' streams."""
    from spark_rapids_tpu_torch.kernels import decode as tdec
    names = ["ss_item_sk", "ss_quantity", "ss_sales_price",
             "ss_ext_sales_price"]
    want = {"expand": 0, "packed": 0, "mixed": 0}
    for f in sorted(os.listdir(root)):
        path = os.path.join(root, f)
        pf = papq.ParquetFile(path)
        schema = TSchema.from_arrow(pf.schema_arrow)
        leaf = tdp.leaf_map(pf)
        for rg in range(pf.metadata.num_row_groups):
            for c in names:
                chunk = tpm.read_chunk_pages(path, rg, leaf[c],
                                             parquet_file=pf)
                p = tdp.plan_chunk(chunk, schema.field(c).dtype,
                                   allow_mixed=True)
                streams = [p.def_runs] if p.nullable else []
                if p.mode != "plain":
                    streams.append(p.val_runs)
                for runs in streams:
                    ok, w, _ = tdec.stream_width(runs)
                    want["expand"] += ok
                    want["packed"] += ok and w > 0
                    want["mixed"] += not ok
    return want


def test_q6_perfile_plan_matches_reference_session_and_pyarrow(
        store_sales):
    """q6 with fused decode off: the port's PERFILE reader (one batch per
    row group, decoded column by column) against a reference session with
    the same key off, and against pyarrow; then the fused reader and the
    PERFILE reader each find their own cached plans warm."""
    import bench
    from spark_rapids_tpu import TpuSparkSession
    kb.reset_counts()
    tsc.clear()
    plan = q6_perfile_plan(store_sales, device="cpu")
    out = collect(plan).sort_by("ss_item_sk")
    scan = plan.children[0].children[0]
    assert scan.metrics.num_output_batches == 3       # one per row group
    assert scan.metrics.extra["fallbackColumns"] == 0
    assert scan.metrics.extra["scan.decode"] > 0
    want = _predicted_perfile_counts(store_sales)
    assert want["expand"] >= 9 and want["packed"] >= 3
    assert not kb.launches                            # CPU: plain versions
    assert kb.fallbacks == ({"decode.expand.mixed_widths": want["mixed"]}
                            if want["mixed"] else {})
    session = TpuSparkSession({
        "spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
        "spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled": False})
    ref = bench._query(session, store_sales).collect().sort_by("ss_item_sk")
    pa_ref = _q6_pyarrow(store_sales).group_by("ss_item_sk").aggregate(
        [("ss_item_sk", "count"), ("ss_quantity", "sum"),
         ("ss_ext_sales_price", "mean")]).sort_by("ss_item_sk")
    for want_k, want_c, want_q, want_a in (
            (ref["ss_item_sk"], ref["cnt"], ref["qty"], ref["aesp"]),
            (pa_ref["ss_item_sk"], pa_ref["ss_item_sk_count"],
             pa_ref["ss_quantity_sum"],
             pa_ref["ss_ext_sales_price_mean"])):
        assert out["ss_item_sk"].to_pylist() == want_k.to_pylist()
        assert out["cnt"].to_pylist() == want_c.to_pylist()
        assert out["qty"].to_pylist() == want_q.to_pylist()
        a, r = out["aesp"].to_numpy(), want_a.to_numpy()
        assert np.all(np.abs(a - r) <= REL * np.abs(r))
    # the fused reader walks with allow_mixed False and keeps its own
    # plans: after one cold run of each, warm runs of both walk nothing
    collect(q6_parquet_plan(store_sales, device="cpu"))
    walks = tpm.walk_count()
    again = collect(q6_perfile_plan(store_sales, device="cpu"))
    collect(q6_parquet_plan(store_sales, device="cpu"))
    assert tpm.walk_count() == walks
    assert again.sort_by("ss_item_sk").equals(out)


def test_perfile_reader_sets_input_file(store_sales):
    """The PERFILE reader names each batch's file in the
    ``input_file_name()`` slot while the batch is consumed, and clears
    the slot when its file is done."""
    from spark_rapids_tpu_torch.exec.context import input_file
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    scan = q6_perfile_plan(store_sales, device="cpu").children[0].children[0]
    assert isinstance(scan, TpuParquetScanExec)
    seen = []
    for part, path in zip(scan.execute(), scan.scan.paths):
        for batch in part:
            seen.append(input_file())
            assert batch.device.type == "cpu"
        assert input_file() == ""
    assert seen == list(scan.scan.paths)
