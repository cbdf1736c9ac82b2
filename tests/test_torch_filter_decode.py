"""The port's predicated dictionary gathers against the reference, on the
CPU.

The same dictionaries, codes and keep masks, made with numpy from a seed,
go through the reference's Pallas kernels ``decode_pallas`` and
``decode_str_pallas`` (interpret mode) and the port's ``decode`` and
``decode_str``, which on CPU tensors run the plain torch versions of
``csrc/filter_decode.cu``.  The gathers copy data, so every value must
match bit for bit, floats included.  The reference's deferral gates
(``supported``, ``str_supported``) must agree as well.

Python models of the CUDA kernels' tiling (decode's groups of rows per
lane and its row-by-row reads of unaligned views and the ragged tail;
decode_str's 16-byte output windows, their row walk, the wide and the
clipped byte paths, unaligned outputs and dictionary buffers) are held
against the plain versions and the reference's Pallas kernels, bit for
bit.

The CUDA kernels only run on a GPU: the tests marked ``cuda`` skip without
one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.kernels import backend as jkb
from spark_rapids_tpu.kernels import filter_decode as jfd

from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.kernels import filter_decode as tfd


def _dict(np_t, n, rng):
    if np.dtype(np_t).kind == "f":
        return rng.normal(scale=1e3, size=n).astype(np_t)
    return rng.integers(-1000, 1000, n).astype(np_t)


def _decode_inputs(np_t, seed):
    rng = np.random.default_rng(seed)
    cap = 4096
    dbuf = _dict(np_t, 512, rng)
    codes = rng.integers(-3, 515, cap).astype(np.int32)   # clipped ends
    keep = rng.random(cap) < 0.25
    keep[1024:2048] = False                               # a dropped block
    return dbuf, codes, keep


@pytest.mark.parametrize("np_t", [np.int32, np.int64, np.float64])
def test_decode_matches_reference(np_t):
    dbuf, codes, keep = _decode_inputs(np_t, 9)
    got = tfd.decode(torch.from_numpy(dbuf), torch.from_numpy(codes),
                     torch.from_numpy(keep)).numpy()
    ref = np.asarray(jfd.decode_pallas(jnp.asarray(dbuf),
                                       jnp.asarray(codes),
                                       jnp.asarray(keep)))
    assert got.dtype == ref.dtype
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))
    assert not got[~keep].any()
    assert np.array_equal(got[keep], dbuf[np.clip(codes, 0, 511)][keep])


def test_decode_str_matches_reference():
    """tests/test_kernel_tiling.py's ragged-tile case, with rows of
    lw = 0 and byte bases that run past the end of the buffer."""
    rng = np.random.default_rng(3)
    cap, n_dict, L = 4096, 700, 12
    mats = rng.integers(65, 91, (n_dict, L)).astype(np.uint8)
    dbuf = mats.reshape(-1)                     # 8400 B: ragged at 4 KiB
    idx = rng.integers(0, n_dict, cap).astype(np.int32)
    bb = idx * L
    bb[:8] = dbuf.shape[0] - 5                  # reads clip at the end
    lw = np.full(cap, L, np.int32)
    lw[8:40] = 0
    keep = rng.random(cap) < 0.3
    keep[:40] = True
    with jkb.tile_bytes_override(4 << 10):
        ref = np.asarray(jfd.decode_str_pallas(
            jnp.asarray(dbuf), jnp.asarray(bb), jnp.asarray(lw),
            jnp.asarray(keep), 16))
    got = tfd.decode_str(torch.from_numpy(dbuf), torch.from_numpy(bb),
                         torch.from_numpy(lw), torch.from_numpy(keep),
                         16).numpy()
    assert got.dtype == np.uint8 and got.shape == (cap, 16)
    assert np.array_equal(got, ref)
    assert not got[~keep].any() and not got[8:40].any()
    live = keep.copy()
    live[:40] = False
    assert np.array_equal(got[live][:, :L], mats[idx[live]])
    assert np.array_equal(got[:8, :L], np.broadcast_to(
        np.concatenate([dbuf[-5:], np.repeat(dbuf[-1:], L - 5)]), (8, L)))


@pytest.mark.parametrize("cap", [16, 2048, 4096, 1 << 20, 3 << 12])
@pytest.mark.parametrize("width", [1, 16, 64, 4096, 200_000])
def test_deferral_gates_match_reference(cap, width):
    assert tfd.supported(cap) == jfd.supported(cap)
    assert tfd.str_supported(cap, width) == jfd.str_supported(cap, width)


def test_kernels_refuse_cpu_tensors():
    z = torch.zeros(8, dtype=torch.int32)
    k = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.kernel_decode(z, z, k)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.kernel_decode_str(torch.zeros(8, dtype=torch.uint8), z, z, k, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("np_t", [np.int32, np.int64, np.float32,
                                  np.float64])
def test_cuda_decode_matches_plain(np_t):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dbuf, codes, keep = (torch.from_numpy(a).cuda()
                         for a in _decode_inputs(np_t, 11))
    kb.reset_counts()
    got = tfd.decode(dbuf, codes, keep)
    assert kb.launches == {"filter_decode.decode": 1}
    want = tfd.plain_decode(dbuf, codes, keep)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    # views the kernel reads row by row, of a ragged length
    codes, keep = codes[1:-2], keep[3:]
    got = tfd.decode(dbuf, codes, keep)
    want = tfd.plain_decode(dbuf, codes, keep)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 7, 16, 17, 33, 256])
def test_cuda_decode_str_matches_plain(width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(width)
    cap = 1 << 14
    dbuf = torch.from_numpy(rng.integers(0, 256, 5000).astype(np.uint8))
    bb = torch.from_numpy(rng.integers(-8, 5000, cap).astype(np.int32))
    lw = torch.from_numpy(rng.integers(0, width + 1, cap).astype(np.int32))
    keep = torch.from_numpy(rng.random(cap) < 0.5)
    dbuf, bb, lw, keep = (t.cuda() for t in (dbuf, bb, lw, keep))
    kb.reset_counts()
    got = tfd.decode_str(dbuf, bb, lw, keep, width)
    assert kb.launches == {"filter_decode.decode_str": 1}
    want = tfd.plain_decode_str(dbuf, bb, lw, keep, width)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # views at odd offsets, of a ragged length; an unaligned buffer
    dbuf, bb, lw, keep = dbuf[5:], bb[1:-4], lw[2:-3], keep[5:]
    got = tfd.decode_str(dbuf, bb, lw, keep, width)
    want = tfd.plain_decode_str(dbuf, bb, lw, keep, width)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# models of the CUDA kernels' tiling (csrc/filter_decode.cu)
# ---------------------------------------------------------------------------

ROWS = 16        # DECODE_ROWS: rows per lane per iteration
WINDOWS = 4      # STR_WINDOWS: windows per lane, one-row kernel
MASK128 = (1 << 128) - 1


def _blocks(n: int, per_block: int) -> int:
    """The kernels' grid: the whole work in one pass."""
    return max(-(-n // per_block), 1)


def _striped(n: int, per_lane: int, threads: int):
    """The items a warp-striped kernel visits, in its order: per block,
    warp and iteration, ``per_lane`` items per lane, lanes on neighbouring
    items; every item must come up exactly once."""
    warps = threads // 32
    nblocks = _blocks(n, threads * per_lane)
    step = nblocks * warps * 32 * per_lane
    for blk in range(nblocks):
        for w in range(warps):
            base = (blk * warps + w) * 32 * per_lane
            while base < n:
                for u in range(per_lane):
                    for lane in range(32):
                        if base + u * 32 + lane < n:
                            yield base + u * 32 + lane
                base += step


def _decode_model(dbuf, codes, keep, codes_addr: int, threads: int = 64):
    """csrc/filter_decode.cu's decode kernel, group by group: R = 16 /
    element size consecutive rows per lane, warp-striped, DECODE_ROWS / R
    groups per lane per iteration.  The codes are read as one vector per
    group where the view's byte address (codes_addr) allows it and the
    group is whole; else row by row, the codes of kept rows only (a view
    at an odd offset, the rows past the last whole group); keep likewise,
    which gives the same bits either way.  A group with no kept row reads
    no code.  Returns (out, groups whose codes were read as a vector, row
    by row)."""
    cap = codes.shape[0]
    R = 16 // dbuf.dtype.itemsize
    hi = min(dbuf.shape[0] - 1, (1 << 31) - 1)
    codes_vec = codes_addr % (4 * R) == 0
    out = np.zeros(cap, dbuf.dtype)
    written = np.zeros(cap, np.int64)
    vec = rowwise = 0
    for g in _striped(-(-cap // R), ROWS // R, threads):
        r = g * R
        rows = range(r, min(r + R, cap))
        whole = r + R <= cap
        # one word (keep_vec and whole) or row by row: the same bits
        kw = [bool(keep[i]) for i in rows]
        c = [0] * len(kw)
        if any(kw):
            if codes_vec and whole:
                c = [int(x) for x in codes[r:r + R]]
                vec += 1
            else:
                c = [int(codes[i]) if k else 0 for i, k in zip(rows, kw)]
                rowwise += 1
        for j, i in enumerate(rows):
            out[i] = dbuf[min(max(c[j], 0), hi)] if kw[j] else 0
            written[i] += 1
    assert (written == 1).all()
    return out, vec, rowwise


def _row_bytes(dbuf, dbuf_addr: int, bb: int, lw: int, width: int, c: int,
               b: int, seg: int, acc: int, stats: dict) -> int:
    """row_bytes: a kept row's columns [c, c + seg) into window bytes
    [b, b + seg) of acc (a 128-bit int).  Live bytes held in 16-byte
    blocks wholly inside the buffer come from one or two aligned block
    loads (the blocks are read from the buffer here, so a block outside it
    fails); else each byte is read with the reference's clip."""
    dlen = dbuf.shape[0]
    n = min(max(max(min(lw, width), 0) - c, 0), seg)
    if n == 0:
        return acc
    s = bb + c
    if s >= 0:
        a = dbuf_addr + s
        a0 = a & ~15
        need = 32 if (a - a0) + n > 16 else 16
        if a0 >= dbuf_addr and a0 + need <= dbuf_addr + dlen:
            blk = dbuf[a0 - dbuf_addr:a0 - dbuf_addr + need]
            assert blk.shape[0] == need
            v = int.from_bytes(blk.tobytes() + bytes(32 - need), "little")
            v = (v >> (8 * (a - a0))) & MASK128 & ((1 << (8 * n)) - 1)
            stats["wide"] += 1
            return acc | ((v << (8 * b)) & MASK128)
    for i in range(b, b + n):
        acc |= int(dbuf[min(max(s + i - b, 0), dlen - 1)]) << (8 * i)
    stats["bytewise"] += 1
    return acc


def _decode_str_model(dbuf, bb, lw, keep, width: int, out_lead: int = 0,
                      dbuf_addr: int = 0, threads: int = 64):
    """csrc/filter_decode.cu's decode_str kernels, window by window: a
    window is one aligned 16-byte chunk of the flat output (``out_lead``:
    the output's address mod 16), its first row found by one division.
    With width % 16 == 0 and an aligned output (the one-row kernel,
    STR_WINDOWS warp-striped windows per lane) a window lies in one row;
    else it walks its rows, loading each row's keep, lw and byte base once.
    Partial windows at either end are stored byte by byte.  Returns (out,
    stats)."""
    cap = bb.shape[0]
    total = cap * width
    nwin = (total + out_lead + 15) // 16
    one_row = width % 16 == 0 and out_lead == 0
    out = np.zeros(total, np.uint8)
    written = np.zeros(total, np.int64)
    stats = {"wide": 0, "bytewise": 0, "row_loads": 0, "partial": 0,
             "max_rows": 0}
    order = _striped(nwin, WINDOWS, threads) if one_row else range(nwin)
    for k in order:
        first = out_lead if k == 0 else 0
        bend = min(16, total + out_lead - 16 * k)
        acc = 0
        if one_row:
            per_row = width // 16
            r = k // per_row
            segs = [(r, 16 * (k - r * per_row), 0, 16)]
        else:
            r, c = divmod(16 * k + first - out_lead, width)
            segs, b = [], first
            while b < bend:
                seg = min(bend - b, width - c)
                segs.append((r, c, b, seg))
                b += seg
                r, c = r + 1, 0
        stats["max_rows"] = max(stats["max_rows"], len(segs))
        for r, c, b, seg in segs:
            stats["row_loads"] += 1
            if keep[r]:
                acc = _row_bytes(dbuf, dbuf_addr, int(bb[r]), int(lw[r]),
                                 width, c, b, seg, acc, stats)
        stats["partial"] += (first, bend) != (0, 16)
        for i in range(first, bend):
            t = 16 * k - out_lead + i
            out[t] = (acc >> (8 * i)) & 0xFF
            written[t] += 1
    assert (written == 1).all()
    return out.reshape(cap, width), stats


def _model_decode_inputs(np_t, cap: int, density: float, seed: int):
    rng = np.random.default_rng(seed)
    dbuf = _dict(np_t, 500, rng)
    codes = rng.integers(-3, 503, cap).astype(np.int32)   # clipped ends
    if density in (0.0, 1.0):
        keep = np.full(cap, bool(density))
    else:
        keep = rng.random(cap) < density
        keep[256:512] = False                              # dropped groups
    return dbuf, codes, keep


# the codes' address mod 16: aligned, and the views codes[1:], codes[2:]
# (aligned for 8-byte elements' pairs of codes)
CODES_ADDRS = (0, 4, 8)


@pytest.mark.parametrize("density", [0.125, 0.0, 1.0])
@pytest.mark.parametrize("cap", [1003, 517])
@pytest.mark.parametrize("np_t", [np.int32, np.float32, np.int64,
                                  np.float64])
def test_decode_kernel_model_matches_plain_and_reference(np_t, cap, density):
    """The decode kernel's groups, its row-by-row reads of unaligned views
    and of the ragged tail, against plain_decode and the reference's
    decode_pallas (interpret mode), bit for bit."""
    dbuf, codes, keep = _model_decode_inputs(np_t, cap, density, cap)
    want = tfd.plain_decode(torch.from_numpy(dbuf), torch.from_numpy(codes),
                            torch.from_numpy(keep)).numpy()
    ref = np.asarray(jfd.decode_pallas(jnp.asarray(dbuf), jnp.asarray(codes),
                                       jnp.asarray(keep)))
    assert np.array_equal(want.view(np.uint8), ref.view(np.uint8))
    for codes_addr in CODES_ADDRS:
        got, vec, rowwise = _decode_model(dbuf, codes, keep, codes_addr)
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
            codes_addr
        R = 16 // dbuf.dtype.itemsize
        if density and codes_addr % (4 * R):
            assert vec == 0 and rowwise > 0
        elif density:
            assert vec > 0 and rowwise <= 1       # at most the tail


def _model_str_inputs(cap: int, width: int, dlen: int, density: float,
                      seed: int):
    """Random rows, and before them: rows that run past the end, negative
    byte bases, bases at every offset mod 16 within 32 bytes of both ends
    (full rows), and lengths of 0, below 0 and above the width."""
    rng = np.random.default_rng(seed)
    bb = rng.integers(0, dlen, cap).astype(np.int32)
    lw = rng.integers(0, width + 1, cap).astype(np.int32)
    bb[:8] = dlen - 3
    bb[8:16] = -3 * np.arange(1, 9)
    bb[16:48] = np.arange(32)
    bb[48:80] = dlen - 32 + np.arange(32)
    lw[:80] = width
    lw[80:90] = 0
    lw[90:100] = -3
    lw[100:110] = width + 7
    if density in (0.0, 1.0):
        keep = np.full(cap, bool(density))
    else:
        keep = rng.random(cap) < density
        keep[:110] = True
    return bb, lw, keep


# (output address, dictionary buffer address) mod 16
STR_ADDRS = ((0, 0), (5, 0), (0, 5), (3, 11))


@pytest.mark.parametrize("density", [0.5, 0.0, 1.0])
@pytest.mark.parametrize("cap", [301, 130])
@pytest.mark.parametrize("width", [1, 7, 16, 17, 33, 256])
def test_decode_str_kernel_model_matches_plain_and_reference(width, cap,
                                                             density):
    """The decode_str kernels' windows (the one-row kernel and the row
    walk), their wide and clipped byte paths, unaligned outputs and
    dictionary buffers, against plain_decode_str and the reference's
    decode_str_pallas (interpret mode), bit for bit."""
    rng = np.random.default_rng(width)
    dbuf = rng.integers(0, 256, 1000).astype(np.uint8)   # ragged: 1000 B
    bb, lw, keep = _model_str_inputs(cap, width, dbuf.shape[0], density,
                                     width + cap)
    want = tfd.plain_decode_str(torch.from_numpy(dbuf), torch.from_numpy(bb),
                                torch.from_numpy(lw), torch.from_numpy(keep),
                                width).numpy()
    ref = np.asarray(jfd.decode_str_pallas(
        jnp.asarray(dbuf), jnp.asarray(bb), jnp.asarray(lw),
        jnp.asarray(keep), width))
    assert np.array_equal(want, ref)
    for out_lead, dbuf_addr in STR_ADDRS:
        got, stats = _decode_str_model(dbuf, bb, lw, keep, width, out_lead,
                                       dbuf_addr)
        assert np.array_equal(got, want), (out_lead, dbuf_addr, stats)
        # keep, lw and the byte base are loaded once per row of a window
        assert stats["max_rows"] <= (16 if width == 1 else
                                     -(-15 // width) + 1)
        if width % 16 == 0 and out_lead == 0:
            assert stats["max_rows"] == 1 and stats["partial"] == 0
        if out_lead or (cap * width) % 16:
            assert stats["partial"] > 0
        if density:
            assert stats["bytewise"] > 0
            assert stats["wide"] > 0 or width == 1 and dbuf_addr
