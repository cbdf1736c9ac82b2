"""The rest of the port's ``exec/sortkeys.py`` and its ``TpuSortExec`` vs
the reference's.

The same padded batch goes into both packages; every sort-key function
the sort and the joins use must give the reference's arrays (uint64 /
uint32 there, int64-carried here), ``hash_group_ids`` the reference's
group ids id for id (the join's sorted order depends on them), and a
port session's ``sort`` the reference session's rows in the reference's
order over int, float (NaN, -0.0), string, bool and null keys, ascending
and descending, nulls first and last, on one key and several.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_tpu as jpkg
from spark_rapids_tpu import TpuSparkSession as JSession
from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.exec import sortkeys as jkeys
from spark_rapids_tpu.expr import eval_tpu as jeval

from spark_rapids_tpu_torch import api as tapi
from spark_rapids_tpu_torch.api import TpuSparkSession as TSession
from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.exec import sortkeys as tkeys
from spark_rapids_tpu_torch.expr import eval_tpu as teval
from spark_rapids_tpu_torch.obs import registry as obsreg

from tests.parity import assert_tables_equal
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 150
COLS = ("i", "f", "s", "b", "w")


def _table(n: int = N, seed: int = 0) -> pa.Table:
    rng = np.random.default_rng(seed)
    f = rng.choice([-1.5, -0.0, 0.0, 2.25, np.nan, 7.0], n)
    words = ["", "a", "ab", "abc", "b", "zz", "héllo", "abcdefghijk"]
    return pa.table({
        "i": pa.array(rng.integers(-5, 5, n), mask=rng.random(n) < 0.15),
        "f": pa.array(f, mask=rng.random(n) < 0.1),
        "s": pa.array([None if rng.random() < 0.1 else
                       words[rng.integers(0, len(words))]
                       for _ in range(n)]),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        # wide values: every 64-bit word of the encodings is exercised
        "w": pa.array(rng.choice(rng.integers(-(1 << 62), 1 << 62, 12), n)),
        "seq": pa.array(np.arange(n)),
    })


@pytest.fixture(scope="module")
def batches():
    t = _table()
    return (jbatch.from_arrow(t, capacity=256),
            tbatch.from_arrow(t, capacity=256, device="cpu"))


def _vals(batches, names):
    jb, tb = batches
    out = []
    for n in names:
        i = jb.names.index(n)
        jc, tc = jb.columns[i], tb.columns[i]
        out.append((jeval.ColVal(jc.dtype, jc.data, jc.validity, jc.lengths),
                    teval.ColVal(tc.dtype, tc.data, tc.validity,
                                 tc.lengths)))
    return out


def _u64(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint64).view(np.int64)


KEYSETS = [("i",), ("f",), ("s",), ("b",), ("w",), ("i", "s"),
           ("b", "f", "w")]


def _key_groups(batches, names, asc, nulls_first):
    pairs = _vals(batches, names)
    jg = [jkeys.encode_keys(j, asc, nulls_first) for j, _ in pairs]
    tg = [tkeys.encode_keys(t, asc, nulls_first) for _, t in pairs]
    return jg, tg


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False)])
@pytest.mark.parametrize("names", KEYSETS, ids=lambda k: "+".join(k))
def test_word_sort_and_boundaries(names, asc, nulls_first, batches):
    jb, tb = batches
    jg, tg = _key_groups(batches, names, asc, nulls_first)
    jmask, tmask = jb.row_mask(), tb.row_mask()
    jw = jkeys.stack_sort_words(jg, jmask)
    tw = tkeys.stack_sort_words(tg, tmask)
    assert np.array_equal(_u64(jw), tw.numpy())
    jo = jkeys.lexsort_indices(jg, jmask)
    to = tkeys.lexsort_indices(tg, tmask)
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert np.array_equal(np.asarray(jkeys.shared_lexsort(jw)),
                          tkeys.shared_lexsort(tw).numpy())
    assert np.array_equal(
        np.asarray(jkeys.group_boundaries(jg, jo, jmask)),
        tkeys.group_boundaries(tg, to, tmask).numpy())


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (True, False),
                                             (False, True), (False, False)])
@pytest.mark.parametrize("names", KEYSETS, ids=lambda k: "+".join(k))
def test_digit_sort_and_boundaries(names, asc, nulls_first, batches):
    jb, tb = batches
    pairs = _vals(batches, names)
    jf = [jkeys.encode_fields(j, asc, nulls_first) for j, _ in pairs]
    tf = [tkeys.encode_fields(t, asc, nulls_first) for _, t in pairs]
    jd = jkeys.stack_sort_digits(jf, jb.row_mask())
    td = tkeys.stack_sort_digits(tf, tb.row_mask())
    assert np.array_equal(np.asarray(jd).astype(np.int64), td.numpy())
    jo, to = jkeys.shared_digit_sort(jd), tkeys.shared_digit_sort(td)
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert np.array_equal(
        np.asarray(jkeys.digit_boundaries(jd, jo, jb.row_mask())),
        tkeys.digit_boundaries(td, to, tb.row_mask()).numpy())


def test_single_digit_sort():
    """A spec that fits one u32 digit sorts in one stable pass."""
    rng = np.random.default_rng(2)
    d = rng.integers(0, 1 << 32, (1, 500))
    assert np.array_equal(
        np.asarray(jkeys.shared_digit_sort(jnp.asarray(d, jnp.uint32))),
        tkeys.shared_digit_sort(torch.from_numpy(d)).numpy())


def _hash_case(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "wide":
        pool = rng.integers(-(1 << 62), 1 << 62, (40, 3))
        return pool[rng.integers(0, 40, n)]
    if kind == "colliding":
        # few distinct keys, many repeats: long probe chains in a small
        # table
        return rng.integers(0, 4, (n, 2))
    return rng.integers(0, 1 << 20, (n, 1))


@pytest.mark.parametrize("kind", ["wide", "colliding", "narrow"])
@pytest.mark.parametrize("n,cap", [(100, 128), (1000, 1024), (7, 64)])
def test_hash_group_ids_id_for_id(kind, n, cap):
    words = np.zeros((cap, _hash_case(kind, 1, 0).shape[1]), np.int64)
    words[:n] = _hash_case(kind, n, n + cap)
    mask = np.arange(cap) < n
    jseg, jn = jkeys.hash_group_ids(
        [jnp.asarray(w.view(np.uint64)) for w in words.T],
        jnp.asarray(mask))
    reg = obsreg.get_registry()
    rounds0 = reg.counter("join.hashRounds")
    tseg, tn = tkeys.hash_group_ids(
        [torch.from_numpy(w.copy()) for w in words.T],
        torch.from_numpy(mask))
    assert int(tn) == int(jn)
    assert np.array_equal(tseg.numpy(), np.asarray(jseg))
    assert reg.counter("join.hashRounds") > rounds0
    # equal keys share an id, different keys do not
    live = words[:n]
    ids = tseg.numpy()[:n]
    _, inv = np.unique(live, axis=0, return_inverse=True)
    assert len(np.unique(ids)) == len(np.unique(inv))
    assert all(len(set(ids[inv.ravel() == g])) == 1
               for g in np.unique(inv))


# ---------------------------------------------------------------------------
# TpuSortExec through the sessions
# ---------------------------------------------------------------------------

SORTS = [
    [("i", True, None)],
    [("i", False, None)],
    [("f", True, None)],
    [("f", False, "first")],
    [("s", True, "last")],
    [("s", False, "first")],
    [("b", True, None), ("i", False, "first")],
    [("w", True, None)],
    [("i", True, "last"), ("f", False, None), ("s", True, None)],
]


def _order(api, name, asc, nulls):
    """asc/desc with the default null placement (first for ascending,
    last for descending), or the other one."""
    c = api.col(name)
    if nulls is None:
        return c.asc() if asc else c.desc()
    return getattr(c, f"{'asc' if asc else 'desc'}_nulls_{nulls}")()


@pytest.fixture(scope="module")
def sort_sessions():
    conf = {"spark.rapids.tpu.sql.test.enabled": True}
    t = _table(97, 5)
    js = JSession(conf)
    ts = TSession(conf, device="cpu")
    return ((js.create_dataframe(t, num_partitions=2), jpkg),
            (ts.create_dataframe(t, num_partitions=2), tapi))


@pytest.mark.parametrize("spec", SORTS, ids=lambda s: "+".join(
    f"{n}{'a' if a else 'd'}{nl or ''}" for n, a, nl in s))
def test_sort_exec_matches_reference(spec, sort_sessions):
    (jdf, japi), (tdf, tapi_) = sort_sessions
    ref = jdf.sort(*[_order(japi, *o) for o in spec]).collect()
    tq = tdf.sort(*[_order(tapi_, *o) for o in spec])
    got = tq.collect()
    assert "TpuSortExec" in tq.explain_string("physical")
    # ties keep their input order in both (stable sorts), so the whole
    # row order, "seq" included, is the reference's
    assert_tables_equal(ref, got)
