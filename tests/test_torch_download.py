"""The port's packed download (``to_arrow_all``) vs the reference's.

The same Arrow table uploads into both packages' batches at the same
capacity; both download through ``to_arrow_all`` and the tables must be
equal: nulls, strings, bools, lists, dates, timestamps, padded
capacities that compact to a download tier, device row counts and an
empty batch.  Also the pack layout the host epilogue cuts by, and one
pinned copy per wire dtype on the CUDA path (marked ``cuda``).
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import batch as jbatch
from spark_rapids_tpu.exec import kernel_abi as jabi
from spark_rapids_tpu.exec.tpu_basic import compact as jcompact

from spark_rapids_tpu_torch.columnar import batch as tbatch
from spark_rapids_tpu_torch.exec import kernel_abi as tabi
from spark_rapids_tpu_torch.exec.tpu_basic import compact as tcompact

from tests.torch_threads import one_torch_thread  # noqa: F401


def _table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.2
    words = ["", "a", "héllo", "sixteen-bytes-xx", "w" * 40]
    lists = [None if rng.random() < 0.1 else
             [None if rng.random() < 0.2 else int(x)
              for x in rng.integers(-5, 5, rng.integers(0, 4))]
             for _ in range(n)]
    base = datetime.date(2000, 1, 1)
    return pa.table({
        "i64": pa.array(rng.integers(-1 << 40, 1 << 40, n), mask=nulls),
        "i32": pa.array(rng.integers(-100, 100, n).astype(np.int32)),
        "f64": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.3),
        "s": pa.array([None if m else words[i % len(words)]
                       for i, m in enumerate(nulls)]),
        "l": pa.array(lists, type=pa.list_(pa.int64())),
        "d": pa.array([base + datetime.timedelta(days=int(x))
                       for x in rng.integers(0, 5000, n)],
                      type=pa.date32()),
        "ts": pa.array(rng.integers(0, 1 << 50, n).astype("datetime64[us]"),
                       type=pa.timestamp("us", tz="UTC")),
    })


def _pair(t: pa.Table, capacity=None):
    jb = jbatch.from_arrow(t, capacity=capacity)
    tb = tbatch.from_arrow(t, capacity=capacity, device="cpu")
    return jb, tb


@pytest.mark.parametrize("n,capacity", [(37, None), (1000, None),
                                        (300, 1 << 16), (5000, 1 << 16)],
                         ids=["small", "tier", "padded", "padded_large"])
def test_to_arrow_all_matches_reference(n, capacity):
    t = _table(n, n)
    jb, tb = _pair(t, capacity)
    ref = jbatch.to_arrow_all([jb])[0]
    got = tbatch.to_arrow_all([tb])[0]
    assert got.equals(ref)
    assert got.equals(t.cast(got.schema))


def test_to_arrow_all_several_batches_and_device_counts():
    """Batches whose row count is a device value (a compaction's output)
    read their counts together and download with the others."""
    ts = [_table(n, 7 + n) for n in (50, 3, 200)]
    js, tl = zip(*[_pair(t, 1 << 16) for t in ts])
    keep = [np.arange(jb.capacity) % 3 != 1 for jb in js]
    js = [jcompact(jb, jax_keep) for jb, jax_keep in zip(js, keep)]
    tl = [tcompact(tb, torch.from_numpy(k)) for tb, k in zip(tl, keep)]
    assert all(isinstance(tb.num_rows, torch.Tensor) for tb in tl)
    ref = jbatch.to_arrow_all(js)
    got = tbatch.to_arrow_all(tl)
    assert len(got) == len(ref) == 3
    for g_, r_ in zip(got, ref):
        assert g_.equals(r_)


def test_to_arrow_empty_batch():
    t = _table(10, 3).slice(0, 0)
    jb, tb = _pair(t)
    ref = jbatch.to_arrow_all([jb])[0]
    got = tbatch.to_arrow(tb)
    assert got.num_rows == ref.num_rows == 0
    assert got.schema == ref.schema


@pytest.mark.parametrize("n,capacity,tier", [
    (300, 1 << 16, 4096), (5000, 1 << 16, None), (5000, 1 << 20, 65536),
    (10, 64, None)])
def test_download_tier_matches_reference(n, capacity, tier):
    assert tbatch._dl_tier(n, capacity) == jbatch._dl_tier(n, capacity) \
        == tier


def test_pack_layout_and_wire_buffers():
    """One buffer per wire dtype; the layout is the ABI's erased key, the
    same positional layout the reference keys its pack program by."""
    t = _table(20, 11)
    jb, tb = _pair(t)
    layout, packed = tbatch._dispatch_pack(tb)
    assert layout == tabi.erased_key(tb)
    assert layout == jabi.erased_key(jb)
    jpacked = jbatch._pack_batch_impl(jabi.erase(jb, pad=False,
                                                 strip_hints=True))
    assert sorted(packed) == sorted(jpacked)
    for k, v in packed.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jpacked[k]))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_cuda_download_matches_cpu():
    t = _table(500, 5)
    tb = tbatch.from_arrow(t, capacity=1 << 16, device="cuda")
    assert tbatch.to_arrow_all([tb])[0].equals(
        tbatch.to_arrow(tbatch.from_arrow(t, device="cpu")))
