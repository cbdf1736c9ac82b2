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
function on raw step functions, and the reference's TPU gates.

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
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.kernel_expand(z, z, z)


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
    with pytest.raises(ValueError):
        tdec.kernel_expand(got, got.float(), got)
