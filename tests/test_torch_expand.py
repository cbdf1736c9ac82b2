"""The port's run expansion (``expand_stream``) against the reference, on
the CPU.

The same hybrid RLE / bit-packed streams, made with numpy from a seed, go
through the reference's ``kernels/decode.expand_stream`` on its ``pallas``
backend (the Pallas kernel in interpret mode) and on its ``xla`` backend
(the window-gather composition), and through the port's, which on CPU
tensors runs the plain torch version of the expand kernel of
``csrc/decode.cu``.  Expansion moves integers: every value must match bit
for bit, on every lane of the capacity against the Pallas path, and on
the stream's live lanes against the XLA path (its padding lanes follow
another formula) and the numpy golden.

Covered: widths 0, 1, 3, 7, 11, 24, 25, 31 and 32 (the XLA path stops at
24 and raises ``UnsupportedChunk`` past it), a width-0 run before a wider
one, int64 step functions (an RLE value of 2^32 - 5 at width 32), the
mixed-width fallback with its counted reason on both sides, the kernel's
last phase on raw step functions, and the reference's TPU gates.  The run
table the kernel searches is a cumsum of the reference's run matrix
(int64 steps, shared starts, padding rows), widened to int64 where an
int32 sum would wrap (the port's repair of the reference's int32 wrap,
pinned to the golden values); every
width 0-32 goes through the table path; and a Python model of the
kernel's tile decomposition (narrowing rounds, staged and in-place row
searches) is held against ``plain_expand_device`` on short runs, one RLE
run, shared starts, the trimmed-runs input and 32-bit values.

The CUDA kernel itself only runs on a GPU: the ``cuda``-marked test skips
without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.io import device_parquet as jdp
from spark_rapids_tpu.kernels import backend as jkb
from spark_rapids_tpu.kernels import decode as jdec
from spark_rapids_tpu.kernels import tiling as jtiling
from spark_rapids_tpu.obs import registry as obsreg

from spark_rapids_tpu_torch.io import device_parquet as tdp
from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.kernels import decode as tdec


@pytest.fixture(autouse=True)
def _restore_reference_backend():
    yield
    jkb.set_default_backend(jkb.PALLAS)


def _bitpack(values: np.ndarray, w: int) -> bytes:
    """Parquet's LSB-first bit-pack of a multiple of 8 values."""
    if not w:
        return b""
    bits = ((np.asarray(values, dtype=np.uint64)[:, None] >>
             np.arange(w, dtype=np.uint64)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _streams(segs, w: int):
    """(reference RunTable, port RunTable, packed bytes, golden values)
    from [('rle', count, value) | ('bp', values[, trimmed count])]."""
    cols = {k: [] for k in ("counts", "is_rle", "values", "bit_bases",
                            "widths")}
    packed = bytearray()
    expect = []
    for seg in segs:
        if seg[0] == "rle":
            _, c, v = seg
            row = (c, True, v, 0)
            expect.extend([v] * c)
        else:
            vals = np.asarray(seg[1], dtype=np.uint64)
            vals8 = np.concatenate([vals, np.zeros((-len(vals)) % 8,
                                                   np.uint64)])
            keep = seg[2] if len(seg) > 2 else len(vals8)
            row = (keep, False, 0, len(packed) * 8)
            packed += _bitpack(vals8, w)
            expect.extend(int(v) for v in vals8[:keep])
        for k, v in zip(("counts", "is_rle", "values", "bit_bases"), row):
            cols[k].append(v)
        cols["widths"].append(w)
    j = jdp.RunTable(**{k: list(v) for k, v in cols.items()})
    t = tdp.RunTable(**{k: list(v) for k, v in cols.items()})
    return j, t, bytes(packed), np.asarray(expect, dtype=np.uint64)


def _concat(a, b):
    """Stream a then stream b, b's bit bases shifted past a's bytes."""
    (ja, ta, pa_, ea), (jb, tb, pb, eb) = a, b
    out = []
    for ra, rb in ((ja, jb), (ta, tb)):
        rt = type(ra).empty()
        for k in ("counts", "is_rle", "values", "widths"):
            getattr(rt, k).extend(getattr(ra, k) + getattr(rb, k))
        rt.bit_bases.extend(ra.bit_bases +
                            [x + len(pa_) * 8 for x in rb.bit_bases])
        out.append(rt)
    return out[0], out[1], pa_ + pb, np.concatenate([ea, eb])


def _ref(runs, packed, cap, backend):
    with jkb.backend_override(backend):
        return np.asarray(jdec.expand_stream(runs, packed, cap))


def _port(runs, packed, cap):
    got = tdec.expand_stream(runs, packed, cap, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (cap,)
    return got.numpy().view(np.uint32)


def _segments(w: int, rng) -> list:
    """RLE and bit-packed runs of width w, RLE values up to 2^w - 1."""
    hi = 1 << w
    segs = []
    for k in range(6):
        if k % 2 == 0:
            segs.append(("rle", int(rng.integers(1, 200)),
                         int(rng.integers(0, hi)) if w else 0))
        else:
            segs.append(("bp", rng.integers(0, hi, int(
                rng.integers(1, 30)) * 8, dtype=np.uint64) if w
                else np.zeros(8 * int(rng.integers(1, 30)), np.uint64)))
    return segs


@pytest.mark.parametrize("w", [0, 1, 3, 7, 11, 24, 25, 31, 32])
def test_expand_stream_matches_reference(w):
    rng = np.random.default_rng(100 + w)
    jr, tr, packed, expect = _streams(_segments(w, rng), w)
    total, cap = jr.total, 2048
    kb.reset_counts()
    got = _port(tr, packed, cap)
    assert not kb.fallbacks
    assert tdec.stream_width(tr) == jdec.stream_width(jr)
    np.testing.assert_array_equal(got, _ref(jr, packed, cap, "pallas"))
    np.testing.assert_array_equal(got[:total].astype(np.uint64), expect)
    if w <= tdp._MAX_W:
        np.testing.assert_array_equal(got[:total],
                                      _ref(jr, packed, cap, "xla")[:total])
    else:
        with pytest.raises(jdp.UnsupportedChunk):
            _ref(jr, packed, cap, "xla")


@pytest.mark.parametrize("w", [0, 7, 32])
def test_dense_meta_matches_reference(w):
    rng = np.random.default_rng(200 + w)
    segs = _segments(w, rng)
    if w == 32:
        segs.append(("rle", 100, (1 << 32) - 5))   # widens the steps
    jr, tr, _, _ = _streams(segs, w)
    rcap = 16
    j = jdec._dense_meta(jr, w, rcap)
    t = tdec._dense_meta(tr, w, rcap)
    assert t.dtype == j.dtype == (np.int64 if w == 32 else np.int32)
    np.testing.assert_array_equal(t, j)


def test_expand_stream_zero_then_wider_width():
    """A width-0 bit-packed run (one-entry dictionary page) before a
    3-bit page: the 0-bit run holds no bytes and must decode as 0, not
    alias the next run's values."""
    rng = np.random.default_rng(8)
    s0 = _streams([("bp", np.zeros(8, np.uint64))], 0)
    s1 = _streams([("bp", rng.integers(1, 8, 64))], 3)
    jr, tr, packed, expect = _concat(s0, s1)
    kb.reset_counts()
    got = _port(tr, packed, 128)
    assert not kb.fallbacks
    assert not got[:8].any()
    np.testing.assert_array_equal(got[:jr.total].astype(np.uint64), expect)
    np.testing.assert_array_equal(got, _ref(jr, packed, 128, "pallas"))


def test_expand_stream_int64_steps():
    """At width 32 an RLE value of 2^32 - 5 needs 33-bit step deltas:
    both packages widen the run matrix to int64."""
    rng = np.random.default_rng(32)
    vals = rng.integers(0, 1 << 32, 512, dtype=np.uint64)
    jr, tr, packed, expect = _streams(
        [("bp", vals[:256]), ("rle", 100, (1 << 32) - 5),
         ("bp", vals[256:])], 32)
    assert tdec._dense_meta(tr, 32, 8).dtype == np.int64
    got = _port(tr, packed, 1024)
    np.testing.assert_array_equal(got[:jr.total].astype(np.uint64),
                                  expect)
    np.testing.assert_array_equal(got, _ref(jr, packed, 1024, "pallas"))


def _mixed(w1: int, w2: int):
    rng = np.random.default_rng(w1 * 100 + w2)
    return _concat(
        _streams([("bp", rng.integers(0, 1 << w1, 64)),
                  ("rle", 40, 3)], w1),
        _streams([("bp", rng.integers(0, 1 << w2, 32))], w2))


def test_expand_stream_mixed_width_fallback_counted():
    """Two bit-packed widths in one stream: both packages take the
    window-gather composition and count a ``mixed_widths`` fallback; the
    port matches the reference's composition on every lane."""
    jr, tr, packed, expect = _mixed(3, 5)
    view = obsreg.get_registry().view()
    ref = {bk: _ref(jr, packed, 256, bk) for bk in ("pallas", "xla")}
    d = view.delta()["counters"]
    assert d.get("kernel.backend.pallas.fallbacks.decode.expand."
                 "mixed_widths", 0) == 1, d
    kb.reset_counts()
    got = _port(tr, packed, 256)
    assert kb.fallbacks == {"decode.expand.mixed_widths": 1}
    assert tdec.stream_width(tr) == jdec.stream_width(jr) == \
        (False, 0, "mixed_widths")
    np.testing.assert_array_equal(got, ref["xla"])
    np.testing.assert_array_equal(got, ref["pallas"])
    np.testing.assert_array_equal(got[:jr.total].astype(np.uint64), expect)


def test_expand_stream_mixed_width_past_24_bits_raises():
    jr, tr, packed, _ = _mixed(7, 25)
    with pytest.raises(jdp.UnsupportedChunk, match="25"):
        _ref(jr, packed, 256, "pallas")
    with pytest.raises(tdp.UnsupportedChunk, match="25"):
        _port(tr, packed, 256)


def test_expand_stream_trimmed_runs_keep_their_padding():
    """Three pages' 1-bit runs of 24 packed values, each trimmed to 21:
    the later runs start past the earlier pages' padding, so the values
    reach dense position 68 although the stream holds 63.  The port and
    the reference's XLA path give the golden values; the reference's
    Pallas path sizes its dense array from the 63 and reads clipped values
    at the end (ROADMAP Queue C)."""
    rng = np.random.default_rng(0)
    segs = [("bp", rng.integers(0, 2, 24), 21) for _ in range(3)]
    jr, tr, packed, expect = _streams(segs, 1)
    assert jr.total == 63 and len(packed) * 8 == 72
    got = _port(tr, packed, 128)
    np.testing.assert_array_equal(got[:63].astype(np.uint64), expect)
    np.testing.assert_array_equal(got[:63], _ref(jr, packed, 128,
                                                 "xla")[:63])
    pallas = _ref(jr, packed, 128, "pallas")[:63]
    assert not np.array_equal(pallas.astype(np.uint64), expect)
    np.testing.assert_array_equal(pallas[:58], got[:58])


@pytest.mark.parametrize("step", [np.int32, np.int64])
def test_plain_expand_matches_reference_kernel(step):
    """The kernel's function on raw step functions, against the
    reference's Pallas kernel: RLE lanes (odd C, negative ones too), and
    gathers whose index falls before, inside and past the dense array."""
    rng = np.random.default_rng(7 if step is np.int32 else 8)
    cap, dlen = 4096, 700
    dense = rng.integers(0, 1 << 32, dlen, dtype=np.uint64).astype(
        np.uint32)
    info = np.iinfo(step)
    a = rng.integers(-cap - 50, dlen + 50, cap).astype(step)
    c = rng.integers(info.min // 2, info.max // 2, cap,
                     dtype=np.int64).astype(step)
    c[::3] &= ~step(1)                     # gather lanes
    want = np.asarray(jdec._expand_pallas(
        jnp.asarray(dense), jnp.asarray(a), jnp.asarray(c), cap))
    got = tdec.plain_expand(torch.from_numpy(dense.view(np.int32)),
                            torch.from_numpy(a), torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_step_functions_add_at_shared_starts_and_drop_padding():
    """Deltas at one start add; padding rows (start 2^30) drop."""
    mat = torch.tensor([[0, 5, 1], [3, 2, 0], [3, 1, 2], [1 << 30, 9, 9]],
                       dtype=torch.int32)
    a, c = tdec.step_functions(mat, 6)
    assert a.dtype == c.dtype == torch.int32
    assert a.tolist() == [5, 5, 5, 8, 8, 8]
    assert c.tolist() == [1, 1, 1, 3, 3, 3]


@pytest.mark.parametrize("w,ncap,cap", [(7, 1 << 20, 1 << 20),
                                        (0, 64, 1 << 20), (15, 96, 256),
                                        (3, 64, 12288), (32, 1 << 14, 64)])
def test_expand_gates_match_reference(w, ncap, cap):
    """The reference's TPU gates past stream_width, which the port keeps
    only as the CPU fallback count."""
    ok = not w or jdec._unpack_supported(w, ncap, ncap * w // 8)
    ok = ok and cap % jtiling.plan("decode.expand", cap, max(ncap, 32),
                                   4, jdec._EXPAND_BLOCK).block == 0
    assert tdec._expand_supported(w, ncap, cap) == ok


def test_expand_kernel_refuses_cpu_tensors():
    table = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.kernel_expand(table, torch.zeros(8, dtype=torch.uint8), 1, 64,
                           64)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [0, 1, 7, 15, 32])
def test_cuda_expand_matches_plain(w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(w)
    segs = _segments(w, rng)
    if w == 32:
        segs.append(("rle", 50, (1 << 32) - 5))
    _, tr, packed, expect = _streams(segs, w)
    kb.reset_counts()
    got = tdec.expand_stream(tr, packed, 1 << 16, device="cuda")
    assert kb.launches["decode.expand_stream"] == 1
    want = tdec.expand_stream(tr, packed, 1 << 16, device="cpu")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(
        got[:len(expect)].cpu().numpy().view(np.uint32), expect)
    table = torch.zeros((8, 3), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        tdec.kernel_expand(table.float(), got.to(torch.uint8), w, 64, 64)


# ---------------------------------------------------------------------------
# the run table and the one-launch kernel
# ---------------------------------------------------------------------------

def _table_case(case: str):
    """(reference RunTable, port RunTable, packed, golden, w, rcap) for a
    run-table case: int32 C values that wrap in the cumsum, int64 steps,
    zero-count runs that share a start, and a table mostly of padding."""
    rng = np.random.default_rng(len(case))
    if case == "int32_wrap":
        # C = 2^31 - 1 then 2^31 + 1: deltas fit int32, the cumsum wraps
        segs, w = [("bp", rng.integers(0, 1 << 31, 16)),
                   ("rle", 8, (1 << 30) - 1), ("rle", 8, 1 << 30),
                   ("rle", 8, 5)], 31
    elif case == "int64":
        segs, w = [("bp", rng.integers(0, 1 << 32, 16, dtype=np.uint64)),
                   ("rle", 9, (1 << 32) - 5),
                   ("bp", rng.integers(0, 1 << 32, 8, dtype=np.uint64))], 32
    elif case == "shared_starts":
        segs, w = [("rle", 5, 3), ("rle", 0, 6), ("bp", rng.integers(
            0, 16, 8), 0), ("bp", rng.integers(0, 16, 16), 13),
            ("rle", 0, 1), ("rle", 7, 9)], 4
    else:
        segs, w = [("bp", rng.integers(0, 128, 24), 20),
                   ("rle", 30, 100)], 7
    jr, tr, packed, expect = _streams(segs, w)
    return jr, tr, packed, expect, w, 64 if case == "padding" else 8


@pytest.mark.parametrize("case", ["int32_wrap", "int64", "shared_starts",
                                  "padding"])
def test_run_table_is_the_cumsum_of_the_reference_meta(case):
    """The table equals a cumsum of the reference's run matrix, in its
    dtype unless a running sum leaves int32 (then in int64, with the
    golden sums where the reference's int32 cumsum wraps), and each row
    holds the step functions' values at its start (the last row of a
    shared start); its deltas give the matrix back."""
    jr, tr, _, _, w, rcap = _table_case(case)
    mat = tdec._dense_meta(tr, w, rcap)
    ref = jdec._dense_meta(jr, w, rcap)
    np.testing.assert_array_equal(mat, ref)
    table = tdec.run_table(mat)
    want = ref.astype(np.int64)
    want[:, 1:] = np.cumsum(ref[:, 1:], axis=0, dtype=np.int64)
    assert table.dtype == (np.int64 if case == "int32_wrap" else ref.dtype)
    np.testing.assert_array_equal(table, want)
    cap = 64
    a, c = tdec.step_functions(tdec.table_deltas(torch.from_numpy(table)),
                               cap)
    starts = table[:, 0]
    for r in range(rcap):
        s = int(starts[r])
        if s < cap and (r + 1 == rcap or int(starts[r + 1]) != s):
            assert (int(a[s]), int(c[s])) == tuple(table[r, 1:]), r
    np.testing.assert_array_equal(
        tdec.table_deltas(torch.from_numpy(table)).numpy(), mat)
    if case == "int32_wrap":
        assert ref.dtype == np.int32 and table[2, 2] == (1 << 31) + 1
    if case == "padding":
        assert (starts[len(tr.counts):] == 1 << 30).all()


def test_expand_stream_int32_wrap_matches_reference():
    """An RLE value of 2^30 after one of 2^30 - 1 at width 31: the
    reference keeps int32 steps (the deltas fit) and its cumsum wraps, so
    it gives 3 * 2^30 for 2^30; the port's run table widens to int64 and
    gives the golden values on every live lane, and matches the reference
    on every lane but those eight."""
    jr, tr, packed, expect, _, _ = _table_case("int32_wrap")
    got = _port(tr, packed, 64)
    ref = _ref(jr, packed, 64, "pallas")
    assert (ref[24:32] == 3 << 30).all() and (expect[24:32] == 1 << 30).all()
    np.testing.assert_array_equal(got[:40].astype(np.uint64), expect)
    np.testing.assert_array_equal(np.delete(got, range(24, 32)),
                                  np.delete(ref, range(24, 32)))


@pytest.mark.parametrize("w", range(33))
def test_expand_stream_every_width_matches_reference_xla(w):
    """The table path (plain_expand_device on the CPU) against the
    reference's XLA composition on the live lanes (it stops at 24 bits:
    wider streams are held against the golden values here, and against
    the reference's Pallas path in test_expand_stream_matches_reference)."""
    rng = np.random.default_rng(300 + w)
    jr, tr, packed, expect = _streams(_segments(w, rng), w)
    got = _port(tr, packed, 2048)
    np.testing.assert_array_equal(got[:jr.total].astype(np.uint64), expect)
    if w <= tdp._MAX_W:
        np.testing.assert_array_equal(
            got[:jr.total], _ref(jr, packed, 2048, "xla")[:jr.total])


def _wrap(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _kernel_model(table: np.ndarray, packed: np.ndarray, w: int, ncap: int,
                  cap: int, threads: int):
    """csrc/decode.cu's expand kernel, block by block, in Python: tiles of
    4 elements per thread, the k-ary narrowing of the tile's rows (one
    __syncthreads_count per key and round), staging (rows that fit one
    load per thread) or the in-place search, then per thread a binary
    search and a forward walk over its 4 elements, and the packed reads.
    Returns (values as uint32, rounds, staged tiles, in-place tiles)."""
    tile = 4 * threads
    bits = 8 * table.dtype.itemsize
    nrows = table.shape[0]
    rows_all = [tuple(int(x) for x in r) for r in table]
    words = np.frombuffer(packed.tobytes() + bytes(-len(packed) % 4), "<u4")
    dlen = ncap if w else 32
    mask = (1 << w) - 1
    out = np.zeros(cap, np.uint32)
    rounds = staged = in_place = 0
    for t0 in range(0, cap, tile):
        t1 = min(t0 + tile, cap) - 1
        rng_ = [[0, nrows, t0], [0, nrows, t1]]
        while any(lo < hi for lo, hi, _ in rng_) and \
                rng_[1][1] - max(rng_[0][0] - 1, 0) > threads:
            rounds += 1
            for r in rng_:
                lo, hi, x = r
                st = -(-(hi - lo) // threads) if hi > lo else 0
                cnt = sum(1 for t in range(threads) if lo + t * st < hi and
                          rows_all[lo + t * st][0] <= x)
                if lo < hi:
                    r[:2] = [lo, lo] if cnt == 0 else \
                        [lo + (cnt - 1) * st + 1, min(lo + cnt * st, hi)]
        first = max(rng_[0][0] - 1, 0)
        rows = rows_all[first:rng_[1][1]]
        staged += len(rows) <= threads
        in_place += len(rows) > threads
        rstarts = [r[0] for r in rows]
        for e in range(t0, t1 + 1, 4):
            j = int(np.searchsorted(rstarts, e, side="right")) - 1
            for i in range(e, min(e + 4, t1 + 1)):
                while j + 1 < len(rows) and rows[j + 1][0] <= i:
                    j += 1
                a, c = rows[j][1:] if j >= 0 else (0, 0)
                if c & 1:
                    out[i] = (c >> 1) & 0xFFFFFFFF
                elif w:
                    d = min(max(_wrap(a + i, bits), 0), dlen - 1)
                    bit = d * w
                    word, s = bit >> 5, bit & 31
                    x = int(words[word]) >> s if word < len(words) else 0
                    if s + w > 32 and word + 1 < len(words):
                        x |= int(words[word + 1]) << (32 - s)
                    out[i] = x & mask
    return out, rounds, staged, in_place


def _layout(name: str, rng):
    """(segments, width) of the kernel-model layouts."""
    if name == "short_runs":
        # RLE runs of 1 between bit-packed groups trimmed to 1-8 values:
        # dense offsets at every position of a word
        segs = []
        for k in range(90):
            segs.append(("rle", 1, int(rng.integers(0, 1 << 7))))
            segs.append(("bp", rng.integers(0, 1 << 7, 8), 1 + k % 8))
        return segs, 7
    if name == "one_rle":
        return [("rle", 700, 77)], 7
    if name == "shared_starts":
        segs = []
        for k in range(40):
            segs.append(("rle", k % 3 * 5, k))
            segs.append(("bp", rng.integers(0, 1 << 11, 16), k % 17))
        return segs, 11
    if name == "trimmed":
        return [("bp", rng.integers(0, 2, 24), 21) for _ in range(3)], 1
    return [("bp", rng.integers(0, 1 << 32, 64, dtype=np.uint64)),
            ("rle", 50, (1 << 32) - 5),
            ("bp", rng.integers(0, 1 << 32, 128, dtype=np.uint64), 120)], 32


@pytest.mark.parametrize("layout,step", [
    (layout, step) for layout in ("short_runs", "one_rle", "shared_starts",
                                  "trimmed", "wide")
    for step in (np.int32, np.int64)
    if not (layout == "wide" and step is np.int32)])   # 2^32 - 5: int64
def test_kernel_model_matches_plain_expand_device(layout, step):
    """The expand kernel's tile decomposition (8 threads, tiles of 32:
    narrowing rounds, staged and in-place searches)
    against plain_expand_device on the same table, bit for bit, and the
    golden values on the live lanes."""
    from spark_rapids_tpu_torch.columnar.batch import bucket_rows
    rng = np.random.default_rng(len(layout))
    segs, w = _layout(layout, rng)
    _, tr, packed, expect = _streams(segs, w)
    mat = tdec._dense_meta(tr, w, bucket_rows(len(tr.counts), 8))
    table = tdec.run_table(mat.astype(step))
    ncap = bucket_rows(max(tdec._dense_extent(tr, w), 1), 32)
    pk = tdp._pad_np(np.frombuffer(packed, np.uint8), max(ncap * w // 8, 4))
    cap = 1024 + 3 if layout != "one_rle" else 700
    got, rounds, staged, in_place = _kernel_model(
        table, pk, w, ncap, cap, threads=8)
    want = tdec.plain_expand_device(torch.from_numpy(table),
                                    torch.from_numpy(pk.copy()), w, ncap,
                                    cap).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:len(expect)].astype(np.uint64),
                                  expect)
    assert staged > 0
    if layout == "short_runs":
        assert in_place > 0 and rounds > 0
