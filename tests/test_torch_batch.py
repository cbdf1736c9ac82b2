"""The port's batch currency, expressions and key encoding vs the reference.

Arrow -> batch -> Arrow round trips, the same capacity, buffers and
vbits/nonnull hints as the reference's ``from_arrow`` on
tests/data_gen.py tables, the numpy-leaves interop, expression and
sort-key parity on the same padded batch, ``compact``/``concat_batches``,
and that importing the port loads neither jax nor the reference package.
Everything runs on CPU tensors; integers, nulls and bit patterns must
match exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu import dtypes as jdt
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.exec import kernel_abi as jabi
from spark_rapids_tpu.exec import sortkeys as jkeys
from spark_rapids_tpu.exec.cpu import CpuScanExec as JCpuScanExec
from spark_rapids_tpu.exec.tpu_basic import compact as jcompact
from spark_rapids_tpu.expr import eval_tpu as jeval
from spark_rapids_tpu.expr import ir as jir

from spark_rapids_tpu_torch import dtypes as tdt
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.columnar.interop import (batch_from_numpy,
                                                     batch_to_numpy)
from spark_rapids_tpu_torch.exec import kernel_abi as tabi
from spark_rapids_tpu_torch.exec import sortkeys as tkeys
from spark_rapids_tpu_torch.exec.cpu import CpuScanExec as TCpuScanExec
from spark_rapids_tpu_torch.exec.tpu_basic import compact as tcompact
from spark_rapids_tpu_torch.expr import eval_tpu as teval
from spark_rapids_tpu_torch.expr import ir as tir
from spark_rapids_tpu_torch.plan.logical import Schema as TSchema

from tests import data_gen as g
from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

_DT = {jir: jdt, tir: tdt}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_leaves(b) -> dict:
    """The numpy leaves of a reference (JAX) DeviceBatch."""
    def host(a):
        return None if a is None else np.asarray(a)
    return {"names": list(b.names), "num_rows": int(b.num_rows),
            "columns": [{"dtype": c.dtype.name, "data": host(c.data),
                         "validity": host(c.validity),
                         "lengths": host(c.lengths),
                         "elem_validity": host(c.elem_validity),
                         "vbits": c.vbits, "nonnull": bool(c.nonnull)}
                        for c in b.columns]}


def assert_leaves_equal(a: dict, b: dict) -> None:
    assert a["names"] == b["names"] and a["num_rows"] == b["num_rows"]
    for ca, cb in zip(a["columns"], b["columns"], strict=True):
        assert (ca["dtype"], ca["vbits"], ca["nonnull"]) == \
            (cb["dtype"], cb["vbits"], cb["nonnull"])
        for k in ("data", "validity", "lengths", "elem_validity"):
            x, y = ca[k], cb[k]
            assert (x is None) == (y is None), k
            if x is not None:
                assert x.shape == y.shape and x.dtype == y.dtype, k
                assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), k


_GENS = {
    "byte": g.byte_gen, "short": g.short_gen, "int": g.int_gen,
    "long": g.long_gen, "float": g.float_gen, "double": g.double_gen,
    "bool": g.boolean_gen, "string": g.string_gen, "date": g.date_gen,
    "timestamp": g.timestamp_gen, "int_key": g.int_key_gen,
    "nonnull_long": g.IntGen(64, lo=-5, hi=70000, nullable=False),
}


def _list_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    vals = [None if rng.random() < 0.1 else
            [None if rng.random() < 0.1 else int(x)
             for x in rng.integers(-9, 9, int(rng.integers(0, 6)))]
            for _ in range(n)]
    return pa.table({"l": pa.array(vals, type=pa.list_(pa.int64()))})


def _table(name: str, n: int, seed: int = 0) -> pa.Table:
    if name == "list":
        return _list_table(n, seed)
    return g.gen_table([_GENS[name]], [name], n=n, seed=seed)


_TABLES = list(_GENS) + ["list"]


@pytest.mark.parametrize("n", [0, 5, 300])
@pytest.mark.parametrize("name", _TABLES)
def test_arrow_round_trip(name, n):
    t = _table(name, n, seed=n)
    out = tbatch.to_arrow(tbatch.from_arrow(t, device="cpu"))
    assert_tables_equal(t, out, approx_float=False)


@pytest.mark.parametrize("n", [5, 300])
@pytest.mark.parametrize("name", _TABLES)
def test_from_arrow_matches_reference(name, n):
    """Same capacity, buffers and hints as the reference's upload; and
    the leaves carry across through interop unchanged."""
    t = _table(name, n, seed=n + 1)
    ref = jax_leaves(jbatch.from_arrow(t))
    port = tbatch.from_arrow(t, device="cpu")
    assert port.capacity == ref["columns"][0]["data"].shape[0]
    assert_leaves_equal(batch_to_numpy(port), ref)
    assert_leaves_equal(batch_to_numpy(batch_from_numpy(ref, "cpu")), ref)


def _null_rows_spanning_bytes() -> pa.Array:
    """["ab", null, "", null, "xyz"] whose null rows own bytes of the
    buffer ("cde", "fgh")."""
    offsets = np.array([0, 2, 5, 5, 8, 11], np.int32)
    validity = np.packbits([1, 0, 1, 0, 1], bitorder="little")
    return pa.Array.from_buffers(
        pa.string(), 5, [pa.py_buffer(validity.tobytes()),
                         pa.py_buffer(offsets.tobytes()),
                         pa.py_buffer(b"abcdefghxyz")])


@pytest.mark.parametrize("form", ["plain", "sliced", "chunked", "large",
                                  "all_null", "empty_strings",
                                  "null_rows_spanning_bytes"])
def test_string_upload_matches_reference(form):
    """Strings copied from the Arrow offsets and bytes: multi-byte UTF-8,
    nulls, a sliced array, several chunks, large_string and null rows that
    span bytes of the buffer give the reference's matrix and lengths."""
    rng = np.random.default_rng(3)
    words = ["", "a", "h\u00e9llo", "\u65e5\u672c\u8a9e", "x" * 33, None]
    vals = [words[i] for i in rng.integers(0, len(words), 200)]
    arr = {"plain": pa.array(vals),
           "sliced": pa.array(vals).slice(7, 150),
           "chunked": pa.chunked_array([pa.array(vals[:90]),
                                        pa.array(vals[90:])]),
           "large": pa.array(vals, pa.large_string()),
           "all_null": pa.array([None] * 9, pa.string()),
           "empty_strings": pa.array([""] * 9),
           "null_rows_spanning_bytes": _null_rows_spanning_bytes()}[form]
    t = pa.table({"s": arr.cast(pa.string())})
    ref = jax_leaves(jbatch.from_arrow(t))
    port = tbatch.from_arrow(pa.table({"s": arr}), device="cpu")
    assert_leaves_equal(batch_to_numpy(port), ref)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 63, 64, 65, 1000, 4096,
                               262145, 1 << 20, 28_800_991])
@pytest.mark.parametrize("min_bucket", [1, 16, 32])
def test_capacity_tiers_match_reference(n, min_bucket):
    assert tabi.tier_rows(n, min_bucket) == jabi.tier_rows(n, min_bucket)
    assert tbatch.bucket_rows(n, min_bucket) == \
        jbatch.bucket_rows(n, min_bucket)


@pytest.mark.parametrize("lo,hi", [(0, 0), (-1, 1), (1, 18000),
                                   (-(1 << 20), 1 << 20), (0, 1 << 40),
                                   (-(1 << 62), 1 << 62)])
def test_vbits_buckets_match_reference(lo, hi):
    assert tbatch.bits_for_range(lo, hi) == jbatch.bits_for_range(lo, hi)
    vb = tbatch.bits_for_range(lo, hi)
    assert tabi.bucket_vbits(vb) == jabi.bucket_vbits(vb)


def test_import_loads_neither_jax_nor_the_reference():
    """Every module of the port imports (the observability layer named
    too), and a session plans and runs q6 on the CPU and assembles its
    profile, with neither jax nor the reference package loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import spark_rapids_tpu_torch.obs.jsonl, "
        "spark_rapids_tpu_torch.obs.listener, "
        "spark_rapids_tpu_torch.obs.profile, "
        "spark_rapids_tpu_torch.obs.recorder\n"
        "from spark_rapids_tpu_torch.api.session import TpuSparkSession\n"
        "from spark_rapids_tpu_torch.entry import gen_store_sales, "
        "q6_query\n"
        "s = TpuSparkSession({'spark.rapids.tpu.sql.variableFloatAgg."
        "enabled': True, 'spark.rapids.tpu.sql.test.enabled': True}, "
        "device='cpu')\n"
        "out = q6_query(s.create_dataframe(gen_store_sales(2000))).collect()\n"
        "assert out.num_rows > 100, out.num_rows\n"
        "assert s.last_query_profile().result_rows == out.num_rows\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'spark_rapids_tpu' or "
        "m.startswith('spark_rapids_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# expressions on the same padded batch
# ---------------------------------------------------------------------------

_EXPR_COLS = ["int", "long", "double", "float", "bool", "string", "date",
              "timestamp", "short"]


@pytest.fixture(scope="module")
def expr_batches():
    t = g.gen_table([_GENS[c] for c in _EXPR_COLS], _EXPR_COLS, n=200,
                    seed=11)
    jb = jbatch.from_arrow(t)
    tb = batch_from_numpy(jax_leaves(jb), "cpu")
    return t, jb, tb


def _col(name):
    return lambda ir: ir.UnresolvedAttribute(name)


def _lit(v):
    return lambda ir: ir.Literal(v)


def _bin(cls, a, b):
    return lambda ir: getattr(ir, cls)(a(ir), b(ir))


def _un(cls, a):
    return lambda ir: getattr(ir, cls)(a(ir))


def _cast(a, to):
    return lambda ir: ir.Cast(a(ir), getattr(_DT[ir], to))


_EXPRS = {
    "ref": _col("long"),
    "lit": _lit(150.0),
    "gt_double_nan": _bin("GreaterThan", _col("double"), _lit(0.5)),
    "eq_double": _bin("EqualTo", _col("double"), _col("double")),
    "lt_int_long": _bin("LessThan", _col("int"), _col("long")),
    "le_float_double": _bin("LessThanOrEqual", _col("float"),
                            _col("double")),
    "ge_string": _bin("GreaterThanOrEqual", _col("string"), _lit("M")),
    "eq_string": _bin("EqualTo", _col("string"), _col("string")),
    "and_or_not": _bin("Or", _bin("And", _col("bool"), _bin(
        "GreaterThan", _col("int"), _lit(0))), _un("Not", _col("bool"))),
    "add_wrap": _bin("Add", _col("long"), _col("long")),
    "sub_int": _bin("Subtract", _col("int"), _col("short")),
    "mul_double": _bin("Multiply", _col("double"), _col("float")),
    "div_by_zero": _bin("Divide", _col("long"), _bin(
        "Subtract", _col("int"), _col("int"))),
    "div": _bin("Divide", _col("double"), _col("int")),
    "cast_double_int": _cast(_col("double"), "INT32"),
    "cast_double_long": _cast(_col("double"), "INT64"),
    "cast_long_int": _cast(_col("long"), "INT32"),
    "cast_int_double": _cast(_col("int"), "FLOAT64"),
    "cast_bool_int": _cast(_col("bool"), "INT32"),
    "cast_int_bool": _cast(_col("int"), "BOOL"),
    "cast_date_ts": _cast(_col("date"), "TIMESTAMP_US"),
    "cast_ts_date": _cast(_col("timestamp"), "DATE32"),
    "cast_ts_long": _cast(_col("timestamp"), "INT64"),
    "isnull": _un("IsNull", _col("string")),
    "isnotnull": _un("IsNotNull", _col("double")),
}


def _bound(ir, schema_names, schema_dtypes, schema_nullables, build):
    return ir.bind(build(ir), schema_names, schema_dtypes, schema_nullables)


@pytest.mark.parametrize("name", list(_EXPRS))
def test_expression_parity(name, expr_batches):
    t, jb, tb = expr_batches
    from spark_rapids_tpu.plan.logical import Schema as JSchema
    js, ts = JSchema.from_arrow(t.schema), TSchema.from_arrow(t.schema)
    je = _bound(jir, js.names, js.dtypes, js.nullables, _EXPRS[name])
    te = _bound(tir, ts.names, ts.dtypes, ts.nullables, _EXPRS[name])
    jv, tv = jeval.evaluate(je, jb), teval.evaluate(te, tb)
    assert jv.dtype.name == tv.dtype.name
    valid = np.asarray(jv.validity)
    assert np.array_equal(tv.validity.numpy(), valid)
    jd, td = np.asarray(jv.data), tv.data.numpy()
    assert jd.dtype == td.dtype
    assert np.array_equal(td[valid], jd[valid],
                          equal_nan=jd.dtype.kind == "f")


def test_unported_expression_names_the_node(expr_batches):
    t, _, tb = expr_batches
    ts = TSchema.from_arrow(t.schema)
    e = tir.bind(tir.SubstringIndex(tir.UnresolvedAttribute("string"),
                                    tir.Literal("a"), tir.Literal(1)),
                 ts.names, ts.dtypes, ts.nullables)
    with pytest.raises(NotImplementedError, match="SubstringIndex"):
        teval.evaluate(e, tb)


# ---------------------------------------------------------------------------
# sort keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("col,vbits", [
    ("int", None), ("long", None), ("long", 16), ("long", 40),
    ("double", None), ("float", None), ("bool", None), ("string", None),
    ("date", None)])
def test_sort_key_encoding_matches_reference(col, vbits, desc,
                                             expr_batches):
    """encode_fields / fields_to_digits / encode_keys give the reference's
    bit patterns (uint64/uint32 there, int64-carried here) and the radix
    order is the reference's stable order."""
    _, jb, tb = expr_batches
    i = _EXPR_COLS.index(col)
    jc, tc = jb.columns[i], tb.columns[i]
    if vbits is not None:   # a narrowing hint the values satisfy
        d = np.asarray(jc.data)
        keep = (d > -(1 << (vbits - 2))) & (d < (1 << (vbits - 2)))
        jd = jnp.where(jnp.asarray(keep), jc.data, 0)
        jv = jeval.ColVal(jc.dtype, jd, jc.validity, jc.lengths, vbits=vbits)
        tv = teval.ColVal(tc.dtype, torch.from_numpy(np.array(jd)),
                          tc.validity, tc.lengths, vbits=vbits)
    else:
        jv = jeval.ColVal(jc.dtype, jc.data, jc.validity, jc.lengths)
        tv = teval.ColVal(tc.dtype, tc.data, tc.validity, tc.lengths)
    jf = jkeys.encode_fields(jv, not desc, True)
    tf = tkeys.encode_fields(tv, not desc, True)
    assert [w for w, _ in jf] == [w for w, _ in tf]
    for (_, a), (_, b) in zip(jf, tf):
        assert np.array_equal(np.asarray(a).view(np.int64), b.numpy())
    jdig, tdig = jkeys.fields_to_digits(jf), tkeys.fields_to_digits(tf)
    assert np.array_equal(np.asarray(jdig).astype(np.int64), tdig.numpy())
    assert np.array_equal(np.asarray(jkeys.radix_order_digits(jdig)),
                          tkeys.radix_order_digits(tdig).numpy())
    for a, b in zip(jkeys.encode_keys(jv, not desc, desc),
                    tkeys.encode_keys(tv, not desc, desc), strict=True):
        assert np.array_equal(np.asarray(a).view(np.int64), b.numpy())


# ---------------------------------------------------------------------------
# compact, concat, scan partitioning
# ---------------------------------------------------------------------------

def _assert_batches_equal(jb, tb):
    assert_leaves_equal(batch_to_numpy(tb), jax_leaves(jb))


def test_compact_matches_reference(expr_batches):
    _, jb, tb = expr_batches
    keep = np.random.default_rng(3).random(jb.capacity) < 0.4
    _assert_batches_equal(jcompact(jb, jnp.asarray(keep)),
                          tcompact(tb, torch.from_numpy(keep)))


@pytest.mark.parametrize("device_counts", [False, True])
def test_concat_matches_reference(device_counts):
    """Host-known counts take the exact-capacity concat; device counts the
    no-sync concat over the summed capacities (as the reference's traced
    counts do)."""
    parts = [_table("nonnull_long", n, seed=n) for n in (5, 40, 17)]
    parts = [p.append_column("s", _table("string", p.num_rows, 1)["string"])
             for p in parts]
    jbs = [jbatch.from_arrow(p) for p in parts]
    tbs = [batch_from_numpy(jax_leaves(b), "cpu") for b in jbs]
    if device_counts:
        for jb_, tb_ in zip(jbs, tbs):
            jb_.num_rows = jnp.asarray(jb_.num_rows, jnp.int32)
            tb_.num_rows = torch.tensor(tb_.num_rows)
    jout, tout = jbatch.concat_batches(jbs), tbatch.concat_batches(tbs)
    assert tout.capacity == jout.capacity
    _assert_batches_equal(jout, tout)


def test_batch_without_columns_needs_a_device():
    with pytest.raises(ValueError, match="needs a device"):
        tbatch.DeviceBatch(["a"], [], 5)
    b = tbatch.DeviceBatch(["a"], [], 5, device="cpu")
    assert b.device == torch.device("cpu") and b.capacity == 16
    assert tbatch.DeviceBatch([], [], torch.tensor(3)).device.type == "cpu"


@pytest.mark.parametrize("parts,rows", [(1, 10), (3, 100), (8, 7)])
def test_cpu_scan_partitions_match_reference(parts, rows):
    t = _table("nonnull_long", 1000)
    ref = [[b.num_rows for b in it]
           for it in JCpuScanExec(t, parts, rows).execute()]
    got = [[b.num_rows for b in it]
           for it in TCpuScanExec(t, parts, rows).execute()]
    assert got == ref


def test_dtype_bridge_matches_reference():
    for jd, td in zip(jdt.ALL_TYPES, tdt.ALL_TYPES):
        assert jd.name == td.name and jd.to_np() == td.to_np()
        assert td.to_torch() == torch.from_numpy(
            np.zeros(1, td.to_np())).dtype


@pytest.mark.parametrize("parts", [1, 3])
def test_filter_project_execs_match_pyarrow(parts):
    """CpuScanExec -> HostToDeviceExec -> TpuFilterExec -> TpuProjectExec
    -> DeviceToHostExec on CPU tensors against pyarrow.compute."""
    from spark_rapids_tpu_torch.entry import collect
    from spark_rapids_tpu_torch.exec.tpu_basic import (DeviceToHostExec,
                                                       HostToDeviceExec,
                                                       TpuFilterExec,
                                                       TpuProjectExec)
    from spark_rapids_tpu_torch.plan.logical import Field
    t = g.gen_table([g.int_gen, g.double_gen], ["a", "x"], n=500, seed=4)
    scan = TCpuScanExec(t, parts, 128)
    s = scan.schema
    cond = tir.bind(tir.GreaterThan(tir.UnresolvedAttribute("x"),
                                    tir.Literal(0.0)), s.names, s.dtypes,
                    s.nullables)
    expr = tir.bind(tir.Add(tir.UnresolvedAttribute("a"),
                            tir.UnresolvedAttribute("a")), s.names,
                    s.dtypes, s.nullables)
    plan = DeviceToHostExec(TpuProjectExec(
        TpuFilterExec(HostToDeviceExec(scan, device="cpu"), cond), [expr],
        TSchema([Field("aa", expr.dtype)])))
    got = collect(plan)["aa"].to_pylist()
    x = t["x"].to_numpy(zero_copy_only=False)
    valid = t["x"].is_valid().to_numpy(zero_copy_only=False)
    keep = valid & (np.isnan(x) | (x > 0))   # Spark: NaN is greatest
    # int + int wraps in int32
    want = [None if v is None else (2 * v + (1 << 31)) % (1 << 32) - (1 << 31)
            for v in t["a"].filter(pa.array(keep)).to_pylist()]
    assert got == want


def test_conf_keys_validate_and_drive_the_abi():
    from spark_rapids_tpu_torch import config as cfg
    with pytest.raises(ValueError, match="kernel.backend"):
        cfg.configure({"spark.rapids.tpu.kernel.backend": "cuda"})
    try:
        cfg.configure({"spark.rapids.tpu.kernel.backend": "xla",
                       "spark.rapids.tpu.kernel.pallas.tileBytes": 1024,
                       "spark.rapids.tpu.kernel.abi.tierStride": "1"})
        assert tabi.tier_rows(1000) == 1024 and tabi.tier_rows(1100) == 2048
    finally:
        cfg.configure({})
    assert tabi.tier_rows(1100) == 4096
