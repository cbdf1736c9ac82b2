#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # every phase, one CUDA card

Phases (any failure exits non-zero):

  1. build   — compile every CUDA source of the port with nvcc, one
               process per source, all started together (kernels/_build.py),
               and print the build time;
  2. parity  — every kernel, through the wrappers the main paths call,
               against its plain torch version on the card: segreduce for
               each type pair x op, sorted and with the fused gather, at
               capacities 2^18, 2^20 and 2^24 over two group-start
               densities, no flag at all and a flag at each tile's end
               (and one segment at 2^24), at 2^20+7 and 1-7 elements, and
               gathered from a longer source; every float sum three times,
               bit for bit; one device launch per call; unpack_bits for
               every width 1-32 at 2^20, 2^22 and a ragged count, fresh and
               into offset slices of a larger array; decode over 4- and
               8-byte dictionaries of 2^7, 2^15 and 2^20 entries at 2^21
               and 2^21+3 rows, keep densities 0.125, 0.25, 0 and 1 and a
               fully dropped range, and codes/keep views at odd offsets;
               decode_str at widths 1, 7, 16, 17, 33, 64 and 256, 2^18 and
               2^18+5 rows, with empty, negative and over-wide lengths,
               byte bases below 0, past the end and at every offset mod 16
               near both ends, over an aligned, an offset and a ragged
               dictionary buffer, all-kept and all-dropped masks and
               views at odd offsets; the run expansion (one launch from the
               run table and the packed bits) for every width 0-32 at
               capacities 2^16-2^22 and a ragged one, with int32 and int64
               rows, over hybrid streams, runs of 1 and bit-packed groups
               at every offset (more rows per tile than shared memory
               holds), one RLE run, shared starts and trimmed page-end
               runs, and an RLE value of 2^30 whose running sum leaves
               int32 (against the golden values), bit for bit; one device
               launch per expand, unpack, decode and decode_str call;
  3. entry   — ``entry(device="cuda")`` against pyarrow on the same table;
  4. q6      — the q6 query at TPC-DS SF10 ``store_sales`` scale
               (28,800,991 rows, 8 partitions) in memory, through
               TpuHashAggregateExec, checked against an independent pyarrow
               group_by, with its wall and sections;
  5. q6-parquet — the same rows written as 8 Parquet files (the reference
               bench's dataset) and scanned by the fused Parquet decode
               with the filter pushed into the scan; cold run, then the
               median of 5 warm runs with sections, the fused batches and
               their capacities;
  6. q6-perfile — the same files through the scan's PERFILE reader (fused
               decode off: one batch per row group, decoded column by column
               through expand_stream); cold run, then 5 warm runs with
               sections and the host part of the decode.  Its expand
               launches and its mixed-width fallbacks must equal the counts
               predicted from the chunk plans' streams, with no unpack
               launch, in every run;
  7. q6s-parquet — q6's filter grouped by the string key ss_item_id over 4
               files of 2^20 rows (the string kernel's path, cut for time);
  8. perfile-modes — 2 files of 2^21 rows with about 4% nulls, a boolean,
               a dictionary that overflows into PLAIN pages, a 16-character
               string dictionary and a list<int32>, through the PERFILE
               reader, each row group checked against pyarrow;
  9. timing  — per kernel at the shapes and on the inputs the q6 paths
               gave it (segreduce from every q6 run; later runs' entries are
               named ``name@q6-parquet`` and ``name@q6-perfile``): a check
               against the plain version, its time (CUDA events, L2
               flushed), its bytes bound, the plain version's time and a
               library call's where one computes the same function.

Before each q6 path the kernel launch counts are set to 0, and they are
read just after it: every kernel of the path must have launched, with no
fallback but the PERFILE path's predicted mixed-width ones.  The line
before the last carries the kernel table as JSON, the line before it the
card's name and power limit; the last line is the result JSON.  Long
output goes to chiprun_out/chip_smoke.log.  ``python3 chip_smoke.py
build,parity`` (or any comma-separated subset of build, parity, entry, q6,
q6p, q6pf, q6s, modes) runs only those phases and prints no kernel table.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial

try:
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as papq
    import torch
    from spark_rapids_tpu_torch.kernels import _build
    from spark_rapids_tpu_torch.kernels import backend as kb
    from spark_rapids_tpu_torch.kernels import decode as kdec
    from spark_rapids_tpu_torch.kernels import filter_decode as kfd
    from spark_rapids_tpu_torch.kernels import segreduce as kseg
except ImportError as e:  # run outside a checkout of the repo
    print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
    sys.exit(2)

Q6_ROWS = 28_800_991
Q6_PARTS = 8
Q6S_FILES = 4
Q6S_ROWS = Q6S_FILES << 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
OUT_DIR = "chiprun_out"
SOURCES = ["segreduce", "decode", "filter_decode"]
REPLACES = {
    "segreduce.seg_scan_sorted": "spark_rapids_tpu/kernels/segreduce.py:278",
    "segreduce.gather_seg_scan": "spark_rapids_tpu/kernels/segreduce.py:286",
    "decode.unpack_bits": "spark_rapids_tpu/kernels/decode.py:155",
    "filter_decode.decode": "spark_rapids_tpu/kernels/filter_decode.py:125",
    "filter_decode.decode_str":
        "spark_rapids_tpu/kernels/filter_decode.py:178",
    "decode.expand_stream": "spark_rapids_tpu/kernels/decode.py:336",
}
SOURCE_OF = {"segreduce": kseg.SOURCE, "decode": kdec.SOURCE,
             "filter_decode": kfd.SOURCE}
SEGREDUCE = ["segreduce.seg_scan_sorted", "segreduce.gather_seg_scan"]
# the kernels each Parquet q6 path must launch
Q6P_KERNELS = SEGREDUCE + ["decode.unpack_bits", "filter_decode.decode"]
Q6S_KERNELS = ["decode.unpack_bits", "filter_decode.decode",
               "filter_decode.decode_str"]
# the kernels the PERFILE q6 must launch (its dictionary columns are not
# deferred: the per-column decode ignores the pushed filter; the expansion
# reads the packed bits itself, so nothing unpacks)
Q6PF_KERNELS = ["decode.expand_stream"] + SEGREDUCE
Q6PF_COLUMNS = ["ss_item_sk", "ss_quantity", "ss_sales_price",
                "ss_ext_sales_price"]
MODES_FILES = 2
MODES_ROWS = MODES_FILES << 21

_log_lines = []


def log(msg: str) -> None:
    print(msg, flush=True)
    _log_lines.append(msg)


def detail(msg: str) -> None:
    _log_lines.append(msg)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    _write_log()
    sys.exit(1)


def _write_log() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "w") as f:
        f.write("\n".join(_log_lines) + "\n")


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    """One nvcc per source, all started together."""
    import concurrent.futures as cf
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(_build.load, name) for name in SOURCES}
    for name, fut in futures.items():
        try:
            fut.result()
        except RuntimeError as e:
            fail(str(e)[-4000:])
        detail(f"--- nvcc {name}.cu ---\n"
               f"{_build.compiler_output.get(name, '(already built)')}")
    log(f"build: {len(SOURCES)} source(s), {len(_build.compiler_output)} "
        f"compiled in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 2. kernel vs plain version
# ---------------------------------------------------------------------------

def _float_tol(x_scan_abs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float sums: another reduction tree than the plain version, so
    |diff| <= rel * (segmented scan of |x|), rel 1e-12 for float64 and
    1e-5 for float32 (about 20 rounding steps of float32's 6e-8)."""
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    return rel * x_scan_abs + 1e-300


def wrapper_scan(new, x, op, ident, order=None, out=None):
    """The call the main path makes for these inputs: seg_scan_sorted
    without ``order``, gather_seg_scan (widening to ``out``) with it."""
    if order is None:
        if out not in (None, x.dtype):
            raise ValueError("seg_scan_sorted does not widen")
        return kseg.seg_scan_sorted(new, x, op, ident)
    return kseg.gather_seg_scan(x, order, new, op, ident, scan_np=out)


def compare(new, x, op, ident, order=None, out=None):
    """Kernel, through its wrapper, vs plain version on the same CUDA
    tensors.  Integers and min/max must agree exactly, float sums within
    :func:`_float_tol`.  Returns (max_abs_err, ok)."""
    got = wrapper_scan(new, x, op, ident, order, out)
    want = kseg.plain_seg_scan(new, x, op, ident, order, out)
    torch.cuda.synchronize()
    out_t = out or x.dtype
    if not out_t.is_floating_point:
        if out_t == torch.uint64:
            got, want = got.view(torch.int64), want.view(torch.int64)
        err = float(torch.abs(got.double() - want.double()).max())
        return err, bool(torch.equal(got, want))
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    d = torch.where(same, 0.0, torch.abs(got.double() - want.double()))
    if op != "add":
        return float(d.max()), bool(same.all())
    ax = torch.abs(x.to(out_t) if order is None
                   else x[order.long()].to(out_t))
    tol = _float_tol(kseg.plain_seg_scan(new, ax, "add", 0), out_t)
    return float(d.max()), bool((same | (d <= tol)).all())


def _values(dtype, cap, gen):
    if dtype == torch.bool:
        return torch.rand(cap, generator=gen, device="cuda") < 0.5
    if dtype.is_floating_point:
        return (torch.rand(cap, generator=gen, device="cuda",
                           dtype=torch.float64) * 2e6 - 1e6).to(dtype)
    if dtype == torch.uint64:
        v = torch.randint(0, 1 << 62, (cap,), generator=gen, device="cuda")
        return (v * 3).view(torch.uint64)   # uses the top bit too
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), (cap,),
                         generator=gen, device="cuda", dtype=dtype)


def _identity(op, dtype):
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    npd = kseg._np_dtype(dtype)
    info = np.iinfo(npd)
    return info.max if op == "min" else info.min


# the update's two rungs and the merge's: 64, 256 and 4096 tiles of 4096
# elements (twice as many tiles of 2048 for 8-byte outputs)
PARITY_CAPS = (1 << 18, 1 << 20, 1 << 24)
# group starts: q6-like short groups (every tile holds a start), and
# groups of ~2^16 rows that carry across many tiles, with no start at row 0
PARITY_DENSITIES = (1 / 60, 1 / 65536)
# layouts that stress the look-back, beside the densities: no flag at all
# (row 0 included); a flag only at each tile's last element; one segment
# spanning the capacity (the global aggregate), at 2^24 only
PARITY_LAYOUTS = ("none", "tile_last")
# capacities that are not a multiple of the tile
RAGGED_CAPS = ((1 << 20) + 7,) + tuple(range(1, 8))


def _layout_flags(layout, cap: int, tile: int, gen) -> torch.Tensor:
    if isinstance(layout, float):
        new = torch.rand(cap, generator=gen, device="cuda") < layout
        new[0] = layout > 1e-3
        return new
    new = torch.zeros(cap, dtype=torch.bool, device="cuda")
    if layout == "tile_last":
        new[tile - 1::tile] = True
    elif layout == "one_segment":
        new[0] = True
    return new


def _layout_tag(layout) -> str:
    return f"starts~1/{round(1 / layout)}" if isinstance(layout, float) \
        else layout


def phase_parity() -> None:
    """segreduce through its wrappers against its plain version, for every
    type pair x op, sorted and with the fused gather, over the densities
    and layouts above, ragged capacities and a gather from a source longer
    than the capacity.  Every float add also runs twice more and must give
    the same bits each time (the look-back folds in a fixed order)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    n_ok = n_rep = 0

    def run_all(cap: int, layouts, src: int = 0) -> None:
        nonlocal n_ok, n_rep
        order = torch.randperm(src or cap, generator=gen, device="cuda")[
            :cap].to(torch.int32)
        for layout in layouts:
            for tin, tout in sorted(kseg.KERNEL_TYPES, key=str):
                new = _layout_flags(layout, cap, kseg.tile_elems(tout), gen)
                for op in ("add", "min", "max"):
                    x = _values(tin, src or cap, gen)
                    ident = _identity(op, tout)
                    # seg_scan_sorted never widens, nor reads a longer
                    # source: gather only then
                    paths = (None, order) if tin == tout and not src \
                        else (order,)
                    for o in paths:
                        out = None if tin == tout else tout
                        err, ok = compare(new, x, op, ident, o, out)
                        tag = (f"{tin}->{tout} {op} "
                               f"{'sorted' if o is None else 'gather'} "
                               f"cap={cap} src={x.shape[0]} "
                               f"{_layout_tag(layout)}")
                        detail(f"parity {tag}: max_abs_err={err} ok={ok}")
                        if not ok:
                            fail(f"kernel != plain for {tag} "
                                 f"(max err {err})")
                        n_ok += 1
                        if op == "add" and tout.is_floating_point:
                            first = wrapper_scan(new, x, op, ident, o, out)
                            for _ in range(2):
                                again = wrapper_scan(new, x, op, ident, o,
                                                     out)
                                if not torch.equal(again.view(torch.uint8),
                                                   first.view(torch.uint8)):
                                    fail(f"float sum not repeatable: {tag}")
                            n_rep += 1

    for cap in PARITY_CAPS:
        run_all(cap, PARITY_DENSITIES + PARITY_LAYOUTS +
                (("one_segment",) if cap == 1 << 24 else ()))
    for cap in RAGGED_CAPS:
        run_all(cap, (PARITY_DENSITIES[0], "none"))
    run_all(1 << 18, PARITY_DENSITIES, src=1 << 20)
    caps = ", ".join(f"2^{c.bit_length() - 1}" for c in PARITY_CAPS)
    log(f"parity: {n_ok} kernel/plain comparisons through the wrappers "
        f"agree (caps {caps}: {len(PARITY_DENSITIES)} group-start "
        f"densities, no flag, a flag at each tile's end, one segment at "
        f"2^24; caps 2^20+7 and 1-7; cap 2^18 gathered from 2^20); "
        f"{n_rep} float sums gave the same bits over 3 calls")
    _one_launch_per_call(gen)


def _one_launch_per_call(gen) -> None:
    """Each wrapper call is one kernel launch: the device kernels that
    torch.profiler records for one call after a warm one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cap = 1 << 20
    new = _layout_flags(PARITY_DENSITIES[0], cap, 0, gen)
    x = _values(torch.float64, cap, gen)
    order = torch.randperm(cap, generator=gen, device="cuda").to(torch.int32)
    runs, packed = _synthetic_stream(7, cap, np.random.default_rng(5))
    table, pk, ncap = _stream_inputs(runs, packed, 7, "cuda")
    raw = torch.randint(0, 256, (cap * 7 // 8,), generator=gen,
                        device="cuda", dtype=torch.uint8)
    dbuf = torch.randint(0, 1 << 20, (1 << 15,), generator=gen,
                         device="cuda", dtype=torch.int32)
    codes = torch.randint(0, 1 << 15, (cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    keep = torch.rand(cap, generator=gen, device="cuda") < 0.125
    sbuf = torch.randint(0, 256, (STR_DLEN,), generator=gen, device="cuda",
                         dtype=torch.uint8)
    bb, lw, skeep = _str_inputs(cap, 17, STR_DLEN, gen)
    for name, fn in (
            ("seg_scan_sorted", partial(kseg.seg_scan_sorted, new, x, "add",
                                        0)),
            ("gather_seg_scan", partial(kseg.gather_seg_scan, x, order, new,
                                        "add", 0)),
            ("expand_stream", partial(kdec.expand_device, table, pk, 7, ncap,
                                      cap)),
            ("unpack_bits", partial(kdec.unpack_bits, raw, 7, cap)),
            ("decode", partial(kfd.decode, dbuf, codes, keep)),
            ("decode int64", partial(kfd.decode, dbuf.long(), codes, keep)),
            ("decode_str width 16", partial(kfd.decode_str, sbuf, bb, lw,
                                            skeep, 16)),
            ("decode_str width 17", partial(kfd.decode_str, sbuf, bb, lw,
                                            skeep, 17))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if not names:
            log(f"launches per {name} call: not measured (the profiler "
                f"recorded no device activity)")
        elif len(names) != 1:
            fail(f"{name} ran {len(names)} device operations per call: "
                 f"{names}")
        else:
            log(f"launches per {name} call: 1 ({names[0][:60]})")


def _exact(got: torch.Tensor, want: torch.Tensor):
    """(max_abs_err, bit-for-bit equal) of a kernel's output against its
    plain version's."""
    torch.cuda.synchronize()
    if got.dtype.is_floating_point:
        bits = torch.int32 if got.element_size() == 4 else torch.int64
        same = torch.equal(got.view(bits), want.view(bits))
    else:
        same = torch.equal(got, want)
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    return err, same


DECODE_CAP = 1 << 21
DECODE_CAPS = (DECODE_CAP, DECODE_CAP + 3)
DECODE_DICTS = (1 << 7, 1 << 15, 1 << 20)
DECODE_TYPES = (torch.int32, torch.float32, torch.int64, torch.float64)
# q6's share of kept rows, a quarter, none and all
DECODE_DENSITIES = (0.125, 0.25, 0.0, 1.0)
# (codes offset, keep offset) of views the kernel cannot read as vectors
DECODE_VIEWS = ((1, 0), (0, 3), (1, 3), (2, 1))
STR_CAP = 1 << 18
STR_WIDTHS = (1, 7, 16, 17, 33, 64, 256)
STR_DLEN = 18_000 * 16          # the q6s dictionary's bytes


def phase_parity_decode() -> None:
    """unpack_bits, decode and decode_str through their wrappers against
    their plain versions; integers and bytes must agree exactly, and the
    float dictionaries' gathers bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    n_ok = 0

    def check(tag, got, want):
        nonlocal n_ok
        err, ok = _exact(got, want)
        detail(f"parity {tag}: max_abs_err={err} ok={ok}")
        if not ok:
            fail(f"kernel != plain for {tag} (max err {err})")
        n_ok += 1

    n_unpack = 0
    for ncap in UNPACK_NCAPS:
        for w in range(1, 33):
            # one spare word in front: a 4-byte-aligned source that is not
            # 16-byte aligned takes the word loads
            buf = torch.randint(0, 256, (ncap * w // 8 + 4,), generator=gen,
                                device="cuda", dtype=torch.uint8)
            whole = torch.full((ncap + 32,), -7, dtype=torch.int32,
                               device="cuda")
            for src_off in (0, 4):
                raw = buf[src_off:src_off + ncap * w // 8]
                want = kdec.plain_unpack_bits(raw, w, ncap)
                tag = f"unpack_bits w={w} ncap={ncap} src+{src_off}"
                check(tag, kdec.unpack_bits(raw, w, ncap), want)
                # into slices of a larger array: 16-byte aligned, and not
                for off in (16, 3):
                    whole.fill_(-7)
                    dst = whole[off:off + ncap]
                    kdec.unpack_bits(raw, w, ncap, out=dst)
                    check(f"{tag} out@{off}", dst, want)
                    if not (bool((whole[:off] == -7).all()) and
                            bool((whole[off + ncap:] == -7).all())):
                        fail(f"{tag} out@{off} wrote outside its slice")
                n_unpack += 3
    n_gather = _parity_gathers(check, gen)
    rng = np.random.default_rng(13)
    n_expand = 0
    for layout, caps, widths in EXPAND_LAYOUTS:
        for cap in caps:
            for w in widths:
                runs, packed = EXPAND_STREAMS[layout](w, cap, rng)
                n_expand += _check_expand(check, f"{layout} w={w} cap={cap}",
                                          runs, packed, w, cap)
    _check_int32_wrap(check)
    n_expand += 1
    log(f"parity: {n_ok} unpack_bits/decode/decode_str/expand comparisons "
        f"through the wrappers agree exactly ({n_unpack} unpack: w 1-32 at "
        f"ncap {', '.join(map(str, UNPACK_NCAPS))}, aligned and unaligned "
        f"sources, fresh and into 16-byte aligned and unaligned slices; "
        f"{n_gather} decode/decode_str: dictionaries of 2^7, 2^15, 2^20 "
        f"entries at caps 2^21 and 2^21+3, keep densities "
        f"{', '.join(map(str, DECODE_DENSITIES))}, views at odd offsets; "
        f"string widths {', '.join(map(str, STR_WIDTHS))} at caps {STR_CAP} "
        f"and {STR_CAP + 5}, negative bases, bases at every offset mod 16 "
        f"near both ends, aligned, offset and ragged dictionary buffers, "
        f"views at odd offsets; {n_expand} expand: "
        + "; ".join(f"{layout} at caps {', '.join(map(str, caps))}"
                    for layout, caps, _ in EXPAND_LAYOUTS)
        + ", w 0-32, int32 and int64 rows; an RLE value of 2^30 whose "
        "running sum leaves int32, against the golden values)")


def _parity_gathers(check, gen) -> int:
    """decode and decode_str through their wrappers against their plain
    versions, bit for bit; returns the number of comparisons."""
    n = 0
    for dlen in DECODE_DICTS:
        for dtype in DECODE_TYPES:
            dbuf = (torch.randn(dlen, generator=gen, device="cuda",
                                dtype=torch.float64) * 1e6).to(dtype)
            for cap in DECODE_CAPS:
                # codes past both ends: the clip applies
                codes = torch.randint(-2, dlen + 2, (cap,), generator=gen,
                                      device="cuda", dtype=torch.int32)
                for density in DECODE_DENSITIES:
                    keep = torch.rand(cap, generator=gen,
                                      device="cuda") < density
                    if 0 < density < 1:
                        keep[1 << 18:(1 << 18) + (1 << 16)] = False
                    check(f"decode {dtype} dict={dlen} cap={cap} "
                          f"keep={density}", kfd.decode(dbuf, codes, keep),
                          kfd.plain_decode(dbuf, codes, keep))
                    n += 1
    # views at odd offsets, of a ragged length
    cap = DECODE_CAP + 1
    for dtype in DECODE_TYPES:
        dbuf = (torch.randn(1 << 15, generator=gen, device="cuda",
                            dtype=torch.float64) * 1e6).to(dtype)
        codes_all = torch.randint(-2, (1 << 15) + 2, (cap + 4,),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
        keep_all = torch.rand(cap + 4, generator=gen, device="cuda") < 0.125
        for co, ko in DECODE_VIEWS:
            codes, keep = codes_all[co:co + cap], keep_all[ko:ko + cap]
            check(f"decode {dtype} dict=32768 cap={cap} codes[{co}:] "
                  f"keep[{ko}:]", kfd.decode(dbuf, codes, keep),
                  kfd.plain_decode(dbuf, codes, keep))
            n += 1
    base = torch.randint(0, 256, (STR_DLEN + 16,), generator=gen,
                         device="cuda", dtype=torch.uint8)
    buffers = {"aligned": base[:STR_DLEN], "at+5": base[5:5 + STR_DLEN],
               "ragged end": base[:STR_DLEN - 7]}
    for width in STR_WIDTHS:
        for cap in (STR_CAP, STR_CAP + 5):
            for bname, dbuf in buffers.items():
                bb, lw, keep = _str_inputs(cap, width, dbuf.shape[0], gen)
                check(f"decode_str width={width} cap={cap} dict {bname}",
                      kfd.decode_str(dbuf, bb, lw, keep, width),
                      kfd.plain_decode_str(dbuf, bb, lw, keep, width))
                n += 1
    dbuf = buffers["aligned"]
    for width in (7, 16, 17, 33):
        for density in (0.0, 1.0):
            bb, lw, keep = _str_inputs(STR_CAP, width, STR_DLEN, gen,
                                       density)
            check(f"decode_str width={width} keep={density}",
                  kfd.decode_str(dbuf, bb, lw, keep, width),
                  kfd.plain_decode_str(dbuf, bb, lw, keep, width))
            n += 1
        # views at odd offsets
        bb, lw, keep = _str_inputs(STR_CAP + 4, width, STR_DLEN, gen)
        bb, lw, keep = bb[1:1 + STR_CAP], lw[2:2 + STR_CAP], \
            keep[3:3 + STR_CAP]
        check(f"decode_str width={width} bb[1:] lw[2:] keep[3:]",
              kfd.decode_str(dbuf, bb, lw, keep, width),
              kfd.plain_decode_str(dbuf, bb, lw, keep, width))
        n += 1
    return n


def _str_inputs(cap: int, width: int, dlen: int, gen, density=0.5):
    """decode_str's byte bases, lengths and keep mask: random rows, rows
    that run past the buffer's end, negative bases, bases at every offset
    mod 16 within 48 bytes of either end (full rows), and lengths of 0,
    below 0 and above the width; at density 0.5 the edge rows are kept,
    else keep is all one value."""
    bb = torch.randint(0, dlen, (cap,), generator=gen, device="cuda",
                       dtype=torch.int32)
    lw = torch.randint(0, width + 1, (cap,), generator=gen, device="cuda",
                       dtype=torch.int32)
    bb[:1024] = dlen - 3
    bb[1024:1064] = torch.arange(-40, 0, device="cuda", dtype=torch.int32)
    edge = torch.arange(48, device="cuda", dtype=torch.int32)
    bb[1064:1112] = edge
    bb[1112:1160] = dlen - 48 + edge
    lw[1024:1160] = width
    lw[2000:2100] = 0
    lw[2100:2150] = -5
    lw[2150:2200] = width + 9
    if density in (0.0, 1.0):
        keep = torch.full((cap,), bool(density), device="cuda")
    else:
        keep = torch.rand(cap, generator=gen, device="cuda") < density
        keep[:2200] = True
    return bb, lw, keep


def _bitpack(values: np.ndarray, w: int) -> bytes:
    """Parquet's LSB-first bit-pack of a multiple of 8 values."""
    bits = ((np.asarray(values, dtype=np.uint64)[:, None] >>
             np.arange(w, dtype=np.uint64)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def _check_int32_wrap(check) -> None:
    """An RLE value of 2^30 after one of 2^30 - 1 at width 31 (the C
    steps' running sum leaves int32): the run table is int64 and the
    kernel gives the golden values, 2^30 included."""
    vals = np.random.default_rng(17).integers(0, 1 << 31, 16).astype(
        np.uint64)
    runs = _run_table([(16, False, 0, 0, 31), (8, True, (1 << 30) - 1, 0, 31),
                       (8, True, 1 << 30, 0, 31), (8, True, 5, 0, 31)])
    packed = _bitpack(vals, 31)
    golden = np.concatenate([vals, np.repeat(np.uint64((1 << 30) - 1), 8),
                             np.repeat(np.uint64(1 << 30), 8),
                             np.repeat(np.uint64(5), 8)]).astype(np.uint32)
    table, pk, ncap = _stream_inputs(runs, packed, 31, "cuda")
    if table.dtype != torch.int64:
        fail(f"int32 wrap: the run table is {table.dtype}, not int64")
    got = kdec.expand_stream(runs, packed, 64, device="cuda")
    if not np.array_equal(got[:40].cpu().numpy().view(np.uint32), golden):
        fail("int32 wrap: the expansion is not the golden values")
    check("expand int32 wrap w=31 cap=64 (golden)", got,
          kdec.plain_expand_device(table, pk, 31, ncap, 64))


def _check_expand(check, tag: str, runs, packed, w: int, cap: int) -> int:
    """The one-launch expansion through its wrapper against
    plain_expand_device on the same table, with the table's own rows and,
    where they are int32, widened to int64."""
    w = kdec.stream_width(runs)[1]      # as expand_stream takes it
    table, pk, ncap = _stream_inputs(runs, packed, w, "cuda")
    dtypes = [table.dtype] if table.dtype == torch.int64 else \
        [table.dtype, torch.int64]
    for rows in dtypes:
        t = table.to(rows)
        check(f"expand {tag} rows={rows} nrows={t.shape[0]}",
              kdec.expand_device(t, pk, w, ncap, cap),
              kdec.plain_expand_device(t, pk, w, ncap, cap))
    return len(dtypes)


UNPACK_NCAPS = (1 << 20, 1 << 22, (1 << 20) + 40)
EXPAND_CAPS = (1 << 16, 1 << 18, 1 << 20, 1 << 22, (1 << 20) + 7)


def _run_table(rows) -> object:
    """A RunTable from (count, is_rle, value, bit_base, width) rows."""
    from spark_rapids_tpu_torch.io.device_parquet import RunTable
    runs = RunTable.empty()
    for count, rle, value, base, width in rows:
        runs.counts.append(int(count))
        runs.is_rle.append(bool(rle))
        runs.values.append(int(value))
        runs.bit_bases.append(int(base))
        runs.widths.append(int(width))
    return runs


def _synthetic_stream(w: int, cap: int, rng):
    """A hybrid stream of width w filling most of ``cap``: about 400
    alternating RLE runs and bit-packed runs over random packed bytes,
    some trimmed below their 8-value groups as at a page's end; at
    w = 32 one RLE value of 2^32 - 5 (int64 rows)."""
    rows = []
    bits = 0
    total = 0
    target = cap - cap // 16
    mean = max(target // 400, 8)
    k = 0
    while total < target:
        n = int(rng.integers(1, 2 * mean))
        if k % 2 == 0:
            v = (1 << 32) - 5 if w == 32 and k == 2 else \
                int(rng.integers(0, 1 << w)) if w else 0
            rows.append((min(n, target - total), True, v, 0, w))
        else:
            groups = -(-n // 8)
            rows.append((min(groups * 8 - int(rng.integers(0, 8)),
                             target - total), False, 0, bits, w))
            bits += groups * 8 * w
        total += rows[-1][0]
        k += 1
    packed = rng.integers(0, 256, -(-bits // 8), dtype=np.uint8).tobytes()
    return _run_table(rows), packed


def _short_runs_stream(w: int, cap: int, rng):
    """RLE runs of 1 between bit-packed groups of 8 trimmed to 1-8 values,
    so the dense index of a run starts at every offset within a word and
    a tile of the kernel (1024 elements) covers about 370 rows, more than
    it stages (256)."""
    k = np.arange(2 * (cap // 5) + 2)
    counts = np.where(k % 2 == 0, 1, 1 + (k // 2) % 8)
    ends = np.cumsum(counts)
    n = int(np.searchsorted(ends, cap - 1)) + 1    # runs up to cap - 1
    k, counts = k[:n], counts[:n]
    counts[-1] -= int(ends[n - 1]) - (cap - 1)
    rle = k % 2 == 0
    values = np.where(rle, rng.integers(0, 1 << w, n) if w else 0, 0)
    bases = np.where(rle, 0, np.cumsum(np.where(rle, 0, 8 * w)) - 8 * w)
    rows = zip(counts.tolist(), rle.tolist(), values.tolist(),
               bases.tolist(), [w] * n)
    nbytes = int((~rle).sum()) * w
    return _run_table(rows), rng.integers(0, 256, nbytes,
                                          dtype=np.uint8).tobytes()


def _one_rle_stream(w: int, cap: int, rng):
    """One RLE run over the whole capacity (2^32 - 5 at w = 32)."""
    v = (1 << 32) - 5 if w == 32 else int(rng.integers(0, 1 << w)) if w \
        else 0
    return _run_table([(cap, True, v, 0, w)]), b""


def _shared_starts_stream(w: int, cap: int, rng):
    """The hybrid stream with zero-count runs, RLE and bit-packed,
    before every third run: rows that share a start."""
    runs, packed = _synthetic_stream(w, cap, rng)
    rows = []
    for i, row in enumerate(zip(runs.counts, runs.is_rle, runs.values,
                                runs.bit_bases, runs.widths)):
        if i % 3 == 0:
            rows.append((0, True, int(rng.integers(0, 1 << w)) if w else 0,
                         0, w))
            rows.append((0, False, 0, row[3] if not row[1] else 0, w))
        rows.append(row)
    return _run_table(rows), packed


def _trimmed_stream(w: int, cap: int, rng):
    """Pages' last 1-bit runs of 24 packed values trimmed to 21 (the
    input of ROADMAP Queue C), repeated over most of the capacity: later
    runs start past earlier pages' padding."""
    n = max(cap // 32, 3)
    rows = [(21, False, 0, 24 * i, 1) for i in range(n)]
    return _run_table(rows), rng.integers(0, 256, -(-24 * n // 8),
                                          dtype=np.uint8).tobytes()


EXPAND_STREAMS = {"hybrid": _synthetic_stream, "short_runs": _short_runs_stream,
                  "one_rle": _one_rle_stream,
                  "shared_starts": _shared_starts_stream,
                  "trimmed": _trimmed_stream}
# (layout, caps, widths)
EXPAND_LAYOUTS = (
    ("hybrid", EXPAND_CAPS, range(33)),
    ("short_runs", (1 << 16, 1 << 18), range(33)),
    ("one_rle", EXPAND_CAPS, range(33)),
    ("shared_starts", (1 << 18, (1 << 20) + 7), range(33)),
    ("trimmed", EXPAND_CAPS, (1,)),
)


def _stream_inputs(runs, packed, w: int, device):
    """expand_stream's two uploads, as it makes them: the run table and
    the padded packed bytes, with the dense capacity."""
    from spark_rapids_tpu_torch.columnar.batch import bucket_rows
    from spark_rapids_tpu_torch.io.device_parquet import _pad_np
    ncap = bucket_rows(max(kdec._dense_extent(runs, w), 1), 32)
    table = kdec.run_table(kdec._dense_meta(
        runs, w, bucket_rows(len(runs.counts), 8)))
    pk = _pad_np(np.frombuffer(packed, np.uint8), max(ncap * w // 8, 4))
    return (torch.from_numpy(table).to(device),
            torch.from_numpy(pk.copy()).to(device), ncap)


# ---------------------------------------------------------------------------
# 3. entry
# ---------------------------------------------------------------------------

def phase_entry() -> None:
    from spark_rapids_tpu_torch.columnar.batch import to_arrow
    from spark_rapids_tpu_torch.entry import _example_table, entry
    step, (batch,) = entry(device="cuda")
    out = to_arrow(step(batch)).sort_by("k")
    t = _example_table()
    f = t.filter(pc.greater(t["price"], 50.0))
    ref = f.group_by("k").aggregate(
        [("k", "count"), ("qty", "sum"), ("price", "mean")]).sort_by("k")
    if out["k"].to_pylist() != ref["k"].to_pylist() or \
            out["cnt"].to_pylist() != ref["k_count"].to_pylist() or \
            out["qty_sum"].to_pylist() != ref["qty_sum"].to_pylist():
        fail("entry(cuda) keys/counts/sums differ from pyarrow")
    a = out["price_avg"].to_numpy()
    r = ref["price_mean"].to_numpy()
    if not np.all(np.abs(a - r) <= 1e-9 * np.abs(r)):
        fail("entry(cuda) averages differ from pyarrow")
    log(f"entry: {out.num_rows} groups on cuda match pyarrow")


# ---------------------------------------------------------------------------
# 4. q6 at scale, with the shapes each kernel saw
# ---------------------------------------------------------------------------

class ShapeRecorder:
    """Wraps the launcher of every kernel to keep one copy of the inputs
    of each distinct call shape (first call of its class, keyed by kernel
    name and shape) and the number of calls per class.  Counting stays
    where it is: in the wrappers."""

    LAUNCHERS = ((kseg, "kernel_seg_scan"), (kdec, "kernel_unpack_bits"),
                 (kfd, "kernel_decode"), (kfd, "kernel_decode_str"),
                 (kdec, "kernel_expand"))

    def __init__(self):
        self.classes = {}
        self._orig = [getattr(mod, attr) for mod, attr in self.LAUNCHERS]

    def _keep(self, key, args) -> None:
        c = self.classes.get(key)
        if c is None:
            self.classes[key] = c = {
                "name": key[0], "calls": 0,
                "args": tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args)}
        c["calls"] += 1

    def __enter__(self):
        seg, unpack, decode, decode_str, expand = self._orig

        def rec_seg(new, x, op_key, identity, order=None, out_dtype=None,
                    name="segreduce"):
            self._keep((name, str(x.dtype), str(out_dtype or x.dtype),
                        op_key, int(new.shape[0]), int(x.shape[0])),
                       (new, x, op_key, identity, order, out_dtype))
            return seg(new, x, op_key, identity, order, out_dtype,
                       name=name)

        def rec_unpack(b, w, ncap, out=None):
            # a call into a slice keeps a copy of the slice to write into
            self._keep(("decode.unpack_bits", w, ncap, out is not None),
                       (b, w, ncap, out))
            return unpack(b, w, ncap, out)

        def rec_decode(dbuf, codes, keep):
            self._keep(("filter_decode.decode", str(dbuf.dtype),
                        dbuf.shape[0], codes.shape[0]), (dbuf, codes, keep))
            return decode(dbuf, codes, keep)

        def rec_decode_str(dbuf, bb, lw, keep, width):
            self._keep(("filter_decode.decode_str", dbuf.shape[0],
                        bb.shape[0], width), (dbuf, bb, lw, keep, width))
            return decode_str(dbuf, bb, lw, keep, width)

        def rec_expand(table, packed, w, ncap, cap):
            self._keep(("decode.expand_stream", w, ncap, cap,
                        table.shape[0], str(table.dtype)),
                       (table, packed, w, ncap, cap))
            return expand(table, packed, w, ncap, cap)

        for (mod, attr), fn in zip(self.LAUNCHERS, (
                rec_seg, rec_unpack, rec_decode, rec_decode_str,
                rec_expand)):
            setattr(mod, attr, fn)
        return self

    def __exit__(self, *a):
        for (mod, attr), fn in zip(self.LAUNCHERS, self._orig):
            setattr(mod, attr, fn)


def q6_reference(table: pa.Table) -> pa.Table:
    f = table.filter(pc.greater(table["ss_sales_price"], 150.0))
    return f.group_by("ss_item_sk").aggregate(
        [("ss_item_sk", "count"), ("ss_quantity", "sum"),
         ("ss_ext_sales_price", "mean")]).sort_by("ss_item_sk")


def check_q6(out: pa.Table, ref: pa.Table) -> float:
    out = out.sort_by("ss_item_sk")
    if out.num_rows != ref.num_rows:
        fail(f"q6 rows {out.num_rows} != pyarrow {ref.num_rows}")
    for got, want in (("ss_item_sk", "ss_item_sk"),
                      ("cnt", "ss_item_sk_count"),
                      ("qty", "ss_quantity_sum")):
        if not np.array_equal(out[got].to_numpy(), ref[want].to_numpy()):
            fail(f"q6 column {got} differs from pyarrow")
    a = out["aesp"].to_numpy()
    r = ref["ss_ext_sales_price_mean"].to_numpy()
    rel = np.abs(a - r) / np.abs(r)
    if not (np.all(np.isfinite(a)) and rel.max() <= 1e-9):
        fail(f"q6 averages differ from pyarrow (max rel {rel.max()})")
    return float(rel.max())


def phase_q6():
    from spark_rapids_tpu_torch.entry import collect, gen_store_sales, q6_plan
    t0 = time.perf_counter()
    table = gen_store_sales(Q6_ROWS, seed=42)
    ref = q6_reference(table)
    log(f"q6: generated {Q6_ROWS} rows + pyarrow reference in "
        f"{time.perf_counter() - t0:.1f} s ({ref.num_rows} groups)")
    torch.cuda.reset_peak_memory_stats()
    kb.reset_counts()
    with ShapeRecorder() as shapes:
        out = collect(q6_plan(table, partitions=Q6_PARTS, device="cuda"))
    launches = dict(kb.launches)
    fallbacks = dict(kb.fallbacks)
    rel = check_q6(out, ref)
    log(f"q6: {out.num_rows} groups match pyarrow (avg max rel {rel:.3g}); "
        f"launches {launches}; fallbacks {fallbacks}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in SEGREDUCE:
        if launches.get(name, 0) <= 0:
            fail(f"q6 did not launch {name}")
    if fallbacks:
        fail(f"q6 took plain fallbacks: {fallbacks}")
    walls, events, sections = [], [], []
    for i in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        plan = q6_plan(table, partitions=Q6_PARTS, device="cuda")
        o = collect(plan)
        end.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        events.append(start.elapsed_time(end) / 1e3)
        if i == 0:
            check_q6(o, ref)
        else:
            sections.append(_sections(plan))
    log(f"q6 wall: median {statistics.median(walls[1:]) * 1e3:.1f} ms of 5 "
        f"after 1 warm-up on the host clock, "
        f"{statistics.median(events[1:]) * 1e3:.1f} ms between CUDA events "
        f"(host-clock runs ms: "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}); host table "
        f"{table.nbytes / 2**30:.2f} GiB")
    med = {k: statistics.median(s[k] for s in sections)
           for k in sections[0]}
    log("q6 wall by section (host clock, median of 5; the aggregate's "
        "rung and merge choices read the device, so its sections include "
        "the device work): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in med.items()))
    return launches, shapes.classes


# exec sections timed in Metrics.extra (nanoseconds); the other extras
# are counts
TIME_SECTIONS = ("transition.upload", "scan.hostPrepTime", "scan.uploadTime",
                 "scan.dispatch", "scan.decode", "agg.update", "agg.merge")


def _sections(plan) -> dict:
    """Host seconds per exec section of one q6 run: the upload (Arrow ->
    device in memory; host prep, upload and the fused decode's dispatch
    for Parquet), the aggregate's update and merge; the rest of the wall
    is the scan's slicing, finalize and the download."""
    out = {}

    def one(node):
        for k, ns in node.metrics.extra.items():
            if k in TIME_SECTIONS:
                out[k] = out.get(k, 0.0) + ns / 1e9
    plan.foreach(one)
    return out


# ---------------------------------------------------------------------------
# 5-6. q6 and q6s over Parquet files
# ---------------------------------------------------------------------------

def _parquet_dir(tag: str) -> str:
    """A fresh directory under chiprun_out/ for one phase's files; the
    phase removes it (the files are far larger than what a run may bring
    back)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"{tag}-", dir=OUT_DIR)


def _check_launches(tag: str, launches, fallbacks, want) -> None:
    for name in want:
        if launches.get(name, 0) <= 0:
            fail(f"{tag} did not launch {name}")
    if fallbacks:
        fail(f"{tag} took plain fallbacks: {fallbacks}")


def _scan_of(plan):
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    found = []
    plan.foreach(lambda n: found.append(n)
                 if isinstance(n, TpuParquetScanExec) else None)
    return found[0]


def _fmt_sections(sec: dict, wall: float) -> str:
    rest = wall - sum(sec.values())
    return ", ".join([f"{k} {v * 1e3:.1f} ms" for k, v in sec.items()] +
                     [f"rest {rest * 1e3:.1f} ms"])


def _timed_run(make_plan):
    """(output, plan, host-clock s, CUDA-event s) of one run."""
    from spark_rapids_tpu_torch.entry import collect
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    plan = make_plan()
    out = collect(plan)
    end.record()
    torch.cuda.synchronize()
    return out, plan, time.perf_counter() - t0, start.elapsed_time(end) / 1e3


def write_q6_files(root: str) -> pa.Table:
    """The bench's 8 SF10 files under ``root``; returns the pyarrow q6."""
    from spark_rapids_tpu_torch.entry import write_store_sales
    t0 = time.perf_counter()
    write_store_sales(root, Q6_ROWS, files=Q6_PARTS)
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for f in os.listdir(root))
    ref = q6_reference(papq.read_table(root, columns=Q6PF_COLUMNS))
    log(f"q6 files: wrote {Q6_ROWS} rows in {Q6_PARTS} files "
        f"({nbytes / 2**20:.1f} MiB) + pyarrow reference in "
        f"{time.perf_counter() - t0:.1f} s ({ref.num_rows} groups)")
    return ref


def phase_q6_parquet(root: str, ref: pa.Table):
    from spark_rapids_tpu_torch.columnar.batch import bucket_rows
    from spark_rapids_tpu_torch.entry import q6_parquet_plan
    from spark_rapids_tpu_torch.io import parquet_meta as pm
    from spark_rapids_tpu_torch.io import scan_cache as sc
    # room for every chunk plan of both readers, so warm runs walk nothing
    sc.configure(True, 8 << 30)
    sc.clear()
    torch.cuda.reset_peak_memory_stats()
    walks0 = pm.walk_count()
    kb.reset_counts()
    with ShapeRecorder() as shapes:
        out, plan, wall, ev = _timed_run(
            lambda: q6_parquet_plan(root, device="cuda"))
    launches = dict(kb.launches)
    fallbacks = dict(kb.fallbacks)
    walks = pm.walk_count() - walks0
    rel = check_q6(out, ref)
    scan = _scan_of(plan)
    fb_cols = scan.metrics.extra["fallbackColumns"]
    log(f"q6-parquet: {out.num_rows} groups match pyarrow (avg max rel "
        f"{rel:.3g}); launches {launches}; fallbacks {fallbacks}; "
        f"fallbackColumns {fb_cols}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _check_launches("q6-parquet", launches, fallbacks, Q6P_KERNELS)
    if fb_cols:
        fail(f"q6-parquet decoded {fb_cols} columns on the host")
    groups = scan._fused_groups()
    caps = {}
    for srcs, _pv in groups:
        rows = sum(sc.get_footer(p).metadata.row_group(rg).num_rows
                   for p, rg in srcs)
        caps[bucket_rows(rows)] = caps.get(bucket_rows(rows), 0) + 1
    log(f"q6-parquet fused batches: {len(groups)} "
        f"({scan.metrics.num_output_batches} emitted), capacities "
        + ", ".join(f"{n} x 2^{c.bit_length() - 1}"
                    for c, n in sorted(caps.items())))
    log(f"q6-parquet cold run (footers, {walks} page walks, plan cache "
        f"empty): {wall * 1e3:.1f} ms on the host clock, "
        f"{ev * 1e3:.1f} ms between CUDA events; sections "
        f"{_fmt_sections(_sections(plan), wall)}")
    walls, events, sections = [], [], []
    walks0 = pm.walk_count()
    for i in range(5):
        o, plan, wall, ev = _timed_run(
            lambda: q6_parquet_plan(root, device="cuda"))
        walls.append(wall)
        events.append(ev)
        sections.append(_sections(plan))
        if i == 0:
            check_q6(o, ref)
    if pm.walk_count() != walks0:
        fail(f"warm q6-parquet runs walked "
             f"{pm.walk_count() - walks0} chunks")
    med_wall = statistics.median(walls)
    med = {k: statistics.median(s[k] for s in sections)
           for k in sections[0]}
    log(f"q6-parquet warm wall: median {med_wall * 1e3:.1f} ms of 5 on "
        f"the host clock, {statistics.median(events) * 1e3:.1f} ms "
        f"between CUDA events (host-clock runs ms: "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}); 0 page walks; "
        f"plan cache {sc.stats()}")
    log("q6-parquet warm wall by section (host clock, median of 5; the "
        "aggregate's rung and merge choices read the device, so its "
        "sections include the device work): "
        + _fmt_sections(med, med_wall))
    return launches, shapes.classes


def _perfile_prediction(root: str) -> dict:
    """The expand launches, unpack launches and mixed-width fallbacks q6
    through the PERFILE reader must make: one expand launch or one
    fallback per stream of its chunk plans (served by the plan cache, so
    nothing is walked), by the stream's bit widths, and no unpack launch:
    the expansion reads the packed bits itself."""
    from spark_rapids_tpu_torch.io import scan_cache as sc
    from spark_rapids_tpu_torch.io.device_parquet import leaf_map
    from spark_rapids_tpu_torch.plan.logical import Schema
    want = {"expand": 0, "unpack": 0, "mixed": 0, "streams": 0,
            "row_groups": 0, "widths": {}}
    for f in sorted(os.listdir(root)):
        path = os.path.join(root, f)
        pf = sc.get_footer(path)
        schema = Schema.from_arrow(pf.schema_arrow)
        leaf = leaf_map(pf)
        for rg in range(pf.metadata.num_row_groups):
            want["row_groups"] += 1
            for c in Q6PF_COLUMNS:
                p = sc.get_chunk_plan(sc.handle_key(pf, path), path, rg,
                                      leaf[c], schema.field(c).dtype, True,
                                      pf)
                streams = [("def", p.def_runs)] if p.nullable else []
                if p.mode != "plain":
                    streams.append((p.mode, p.val_runs))
                for kind, runs in streams:
                    ok, w, _ = kdec.stream_width(runs)
                    want["streams"] += 1
                    want["expand"] += ok
                    want["mixed"] += not ok
                    ws = sorted({int(x) for x, r in zip(runs.widths,
                                                        runs.is_rle)
                                 if not r})
                    key = f"{c}.{kind}: bit-packed widths {ws or 'none'}"
                    want["widths"][key] = want["widths"].get(key, 0) + 1
    return want


class HostTimer:
    """Adds up the host time of the per-column decode's O(runs) Python
    (stream_width, the dense extent, _dense_meta, and the run matrix of
    the window-gather composition) while it is entered."""

    TARGETS = (("kdec", "stream_width"), ("kdec", "_dense_extent"),
               ("kdec", "_dense_meta"), ("dp", "_upload_runs"))

    def __init__(self):
        from spark_rapids_tpu_torch.io import device_parquet as dp
        self.mods = {"kdec": kdec, "dp": dp}
        self.seconds = {}

    def __enter__(self):
        self._orig = [getattr(self.mods[m], a) for m, a in self.TARGETS]
        for (m, a), fn in zip(self.TARGETS, self._orig):
            def timed_fn(*args, _fn=fn, _a=a):
                t0 = time.perf_counter()
                try:
                    return _fn(*args)
                finally:
                    self.seconds[_a] = self.seconds.get(_a, 0.0) + \
                        time.perf_counter() - t0
            setattr(self.mods[m], a, timed_fn)
        return self

    def __exit__(self, *a):
        for (m, attr), fn in zip(self.TARGETS, self._orig):
            setattr(self.mods[m], attr, fn)


def _check_perfile_counts(tag: str, launches, fallbacks, want) -> None:
    got = (launches.get("decode.expand_stream", 0),
           launches.get("decode.unpack_bits", 0),
           fallbacks.get("decode.expand.mixed_widths", 0))
    if got != (want["expand"], want["unpack"], want["mixed"]):
        fail(f"{tag}: expand/unpack launches and mixed-width fallbacks "
             f"{got} != predicted {(want['expand'], want['unpack'], want['mixed'])}")
    other = {k: v for k, v in fallbacks.items()
             if k != "decode.expand.mixed_widths"}
    if other:
        fail(f"{tag} took other plain fallbacks: {other}")
    for name in SEGREDUCE:
        if launches.get(name, 0) <= 0:
            fail(f"{tag} did not launch {name}")


def phase_q6_perfile(root: str, ref: pa.Table):
    """q6 through the PERFILE reader over the q6-parquet phase's files."""
    from spark_rapids_tpu_torch.entry import q6_perfile_plan
    from spark_rapids_tpu_torch.io import parquet_meta as pm
    from spark_rapids_tpu_torch.io import scan_cache as sc
    # room for both readers' plans (they key plans apart): warm runs walk
    # nothing
    sc.configure(True, 8 << 30)
    torch.cuda.reset_peak_memory_stats()
    walks0 = pm.walk_count()
    kb.reset_counts()
    with ShapeRecorder() as shapes:
        out, plan, wall, ev = _timed_run(
            lambda: q6_perfile_plan(root, device="cuda"))
    launches = dict(kb.launches)
    fallbacks = dict(kb.fallbacks)
    walks = pm.walk_count() - walks0
    rel = check_q6(out, ref)
    scan = _scan_of(plan)
    fb_cols = scan.metrics.extra["fallbackColumns"]
    want = _perfile_prediction(root)
    log(f"q6-perfile: {out.num_rows} groups match pyarrow (avg max rel "
        f"{rel:.3g}); {scan.metrics.num_output_batches} batches (one per "
        f"row group of {want['row_groups']}); launches {launches}; "
        f"fallbacks {fallbacks}; fallbackColumns {fb_cols}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"q6-perfile predicted from the plans' {want['streams']} streams: "
        f"{want['expand']} expand, {want['unpack']} unpack launches, "
        f"{want['mixed']} mixed-width fallbacks; streams by width: "
        f"{want['widths']}")
    _check_perfile_counts("q6-perfile", launches, fallbacks, want)
    if fb_cols:
        fail(f"q6-perfile decoded {fb_cols} columns on the host")
    if scan.metrics.num_output_batches != want["row_groups"]:
        fail("q6-perfile did not emit one batch per row group")
    log(f"q6-perfile cold run ({walks} page walks; the fused reader's "
        f"plans are cached, the PERFILE reader walks with allow_mixed): "
        f"{wall * 1e3:.1f} ms on the host clock, {ev * 1e3:.1f} ms between "
        f"CUDA events; sections {_fmt_sections(_sections(plan), wall)}")
    walls, events, sections, hosts = [], [], [], []
    walks0 = pm.walk_count()
    for i in range(5):
        kb.reset_counts()
        with HostTimer() as ht:
            o, plan, wall, ev = _timed_run(
                lambda: q6_perfile_plan(root, device="cuda"))
        _check_perfile_counts(f"warm q6-perfile run {i}", dict(kb.launches),
                              dict(kb.fallbacks), want)
        walls.append(wall)
        events.append(ev)
        sections.append(_sections(plan))
        hosts.append(ht.seconds)
        if i == 0:
            check_q6(o, ref)
    if pm.walk_count() != walks0:
        fail(f"warm q6-perfile runs walked {pm.walk_count() - walks0} "
             f"chunks")
    med_wall = statistics.median(walls)
    med = {k: statistics.median(s[k] for s in sections)
           for k in sections[0]}
    host = {k: statistics.median(h.get(k, 0.0) for h in hosts)
            for k in hosts[0]}
    log(f"q6-perfile warm wall: median {med_wall * 1e3:.1f} ms of 5 on the "
        f"host clock, {statistics.median(events) * 1e3:.1f} ms between CUDA "
        f"events (host-clock runs ms: "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}); 0 page walks; "
        f"plan cache {sc.stats()}")
    log("q6-perfile warm wall by section (host clock, median of 5; "
        "scan.decode is host work and enqueue, the aggregate's sections "
        "include the device work they wait for): "
        + _fmt_sections(med, med_wall))
    log("q6-perfile host part of scan.decode (median of 5, O(runs) "
        "Python): " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                for k, v in host.items())
        + f"; total {sum(host.values()) * 1e3:.1f} ms")
    return launches, shapes.classes


def phase_q6s_parquet():
    from spark_rapids_tpu_torch.entry import (q6s_parquet_plan,
                                              write_store_sales)
    root = _parquet_dir("q6s-parquet")
    try:
        write_store_sales(root, Q6S_ROWS, files=Q6S_FILES, item_id=True)
        t = papq.read_table(root, columns=["ss_item_id", "ss_quantity",
                                           "ss_sales_price"])
        f = t.filter(pc.greater(t["ss_sales_price"], 150.0))
        ref = f.group_by("ss_item_id").aggregate(
            [("ss_item_id", "count"), ("ss_quantity", "sum")]
        ).sort_by("ss_item_id")
        kb.reset_counts()
        with ShapeRecorder() as shapes:
            out, _plan, wall, ev = _timed_run(
                lambda: q6s_parquet_plan(root, device="cuda"))
        launches = dict(kb.launches)
        fallbacks = dict(kb.fallbacks)
        out = out.sort_by("ss_item_id")
        for got, want in (("ss_item_id", "ss_item_id"),
                          ("cnt", "ss_item_id_count"),
                          ("qty", "ss_quantity_sum")):
            if out[got].to_pylist() != ref[want].to_pylist():
                fail(f"q6s column {got} differs from pyarrow")
        log(f"q6s-parquet: {Q6S_ROWS} rows in {Q6S_FILES} files, "
            f"{out.num_rows} string groups match pyarrow; cold wall "
            f"{wall * 1e3:.1f} ms ({ev * 1e3:.1f} ms between CUDA events); "
            f"launches {launches}; fallbacks {fallbacks}")
        _check_launches("q6s-parquet", launches, fallbacks, Q6S_KERNELS)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, shapes.classes


def _modes_table(n: int, seed: int) -> pa.Table:
    """About 4% nulls in every column; a boolean; a double dictionary
    that overflows into PLAIN pages; 16-character string keys; a
    list<int32> of 0-4 elements, some lists and elements null."""
    from spark_rapids_tpu_torch.entry import item_ids
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.04
    null_list = nulls()
    # a null list spans no elements (pyarrow refuses one that does)
    lens = np.where(null_list, 0, rng.integers(0, 5, n)).astype(np.int32)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    elems = pa.array(rng.integers(0, 100, int(offsets[-1])).astype(np.int32),
                     mask=rng.random(int(offsets[-1])) < 0.04)
    lists = pa.ListArray.from_arrays(pa.array(offsets), elems,
                                     mask=pa.array(null_list))
    return pa.table({
        "k": pa.array(rng.integers(0, 1000, n), pa.int64(), mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, mask=nulls()),
        "f": pa.array(np.round(rng.uniform(0, 1e6, n), 2), mask=nulls()),
        "s": pa.array(item_ids(rng.integers(1, 5001, n)).to_numpy(
            zero_copy_only=False), type=pa.string(), mask=nulls()),
        "l": lists,
    })


def _list_matches(col, want: pa.ListArray, n: int) -> bool:
    """The port's [cap, L] list column against pyarrow's list array."""
    lens = np.where(want.is_null().to_numpy(zero_copy_only=False), 0,
                    np.diff(want.offsets.to_numpy()))
    L = col.data.shape[1]
    if lens.max(initial=0) > L:
        return False
    flat = want.flatten()
    rows = np.repeat(np.arange(n), lens)
    cols = np.arange(rows.shape[0]) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    data = np.zeros((n, L), np.int32)
    ev = np.zeros((n, L), bool)
    data[rows, cols] = flat.fill_null(0).to_numpy()
    ev[rows, cols] = ~flat.is_null().to_numpy(zero_copy_only=False)
    valid = ~want.is_null().to_numpy(zero_copy_only=False)
    return (np.array_equal(col.validity[:n].cpu().numpy(), valid) and
            np.array_equal(col.lengths[:n].cpu().numpy(), lens) and
            np.array_equal(col.data[:n].cpu().numpy(), data) and
            np.array_equal(col.elem_validity[:n].cpu().numpy(), ev))


def phase_perfile_modes() -> None:
    """Every decode mode of the PERFILE reader at 2^21 rows per file,
    checked row group by row group against pyarrow."""
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, to_arrow
    from spark_rapids_tpu_torch.config import RapidsTpuConf
    from spark_rapids_tpu_torch.io import device_parquet as dp
    from spark_rapids_tpu_torch.io import parquet_meta as pm
    from spark_rapids_tpu_torch.io.device_scan import TpuParquetScanExec
    from spark_rapids_tpu_torch.plan.logical import FileScan, Schema
    root = _parquet_dir("perfile-modes")
    try:
        t0 = time.perf_counter()
        paths = []
        for i in range(MODES_FILES):
            p = os.path.join(root, f"part-{i:04d}.parquet")
            papq.write_table(_modes_table(MODES_ROWS // MODES_FILES, 300 + i),
                             p, use_dictionary=["k", "f", "s", "l"],
                             dictionary_pagesize_limit=256 << 10,
                             data_page_version="1.0")
            paths.append(p)
        pf = papq.ParquetFile(paths[0])
        modes = {}
        schema = Schema.from_arrow(pf.schema_arrow)
        for c, leaf in dp.leaf_map(pf).items():
            if schema.field(c).dtype.is_list:
                modes[c] = "list"
                continue
            chunk = pm.read_chunk_pages(paths[0], 0, leaf, parquet_file=pf)
            modes[c] = dp.plan_chunk(chunk, schema.field(c).dtype,
                                     allow_mixed=True).mode
        if modes != {"k": "dict", "b": "bool", "f": "mixed",
                     "s": "dict_str", "l": "list"}:
            fail(f"perfile-modes: files do not hold every mode: {modes}")
        log(f"perfile-modes: wrote {MODES_ROWS} rows in {MODES_FILES} files "
            f"in {time.perf_counter() - t0:.1f} s; first chunks' modes "
            f"{modes}")
        scan = TpuParquetScanExec(
            FileScan("parquet", paths, schema, {}),
            RapidsTpuConf({"spark.rapids.tpu.sql.format.parquet.fusedDecode"
                           ".enabled": False}), device="cuda")
        kb.reset_counts()
        t0 = time.perf_counter()
        n_rg = 0
        for part, path in zip(scan.execute(), paths):
            want_pf = papq.ParquetFile(path)
            for rg, batch in enumerate(part):
                want = want_pf.read_row_group(rg)
                n = want.num_rows
                if int(batch.num_rows) != n:
                    fail(f"perfile-modes {path}#{rg}: {batch.num_rows} rows "
                         f"!= {n}")
                flat = [c for c in batch.names if c != "l"]
                got = to_arrow(DeviceBatch(
                    flat, [batch.columns[batch.names.index(c)]
                           for c in flat], n))
                if not got.equals(want.select(flat).cast(got.schema)):
                    fail(f"perfile-modes {path}#{rg}: flat columns differ "
                         f"from pyarrow")
                lcol = batch.columns[batch.names.index("l")]
                if not _list_matches(lcol, want["l"].combine_chunks(), n):
                    fail(f"perfile-modes {path}#{rg}: the list column "
                         f"differs from pyarrow")
                n_rg += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, fallbacks = dict(kb.launches), dict(kb.fallbacks)
        fb_cols = scan.metrics.extra["fallbackColumns"]
        log(f"perfile-modes: {n_rg} row groups match pyarrow in "
            f"{wall:.1f} s (check included); launches {launches}; "
            f"fallbacks {fallbacks}; fallbackColumns {fb_cols}")
        if launches.get("decode.expand_stream", 0) <= 0:
            fail("perfile-modes did not launch decode.expand_stream")
        if launches.get("decode.unpack_bits", 0):
            fail("perfile-modes launched decode.unpack_bits")
        if set(fallbacks) - {"decode.expand.mixed_widths"} or fb_cols:
            fail("perfile-modes took fallbacks other than mixed widths")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# 9. kernel timings at the q6 shapes
# ---------------------------------------------------------------------------

# GPU cycles each timed rep waits before its first event: about 3 ms on
# the H100, far longer than the host takes to enqueue one call (40-160 us
# measured for segreduce by segreduce_profile.py), so no idle time lands
# between the events.  A sleep of 200,000 cycles (about 0.1 ms) is
# shorter than the host at times, and then counts idle time as kernel
# time.
SLEEP_CYCLES = 5_000_000


def _time_device(fn, reps: int = 20, flush=None) -> float:
    """Mean ms per call on the device: per rep, flush L2 (the q6 caller
    finds its inputs cold), keep the GPU busy while the host enqueues,
    and time the call between CUDA events."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _segments(new: torch.Tensor) -> torch.Tensor:
    starts = torch.nonzero(new).flatten()
    if starts.numel() == 0 or int(starts[0]) != 0:
        starts = torch.cat([starts.new_zeros(1), starts])
    ends = torch.cat([starts[1:], starts.new_full((1,), new.shape[0])])
    return ends - starts


def _summary(label: str, name: str, rows, launches) -> dict:
    """One kernel's JSON entry: launch-weighted means over its shapes."""
    calls = sum(r["calls"] for r in rows)

    def mean(k):
        have = [r for r in rows if r[k] is not None]
        if not have:
            return None
        w = sum(r["calls"] for r in have)
        return sum(r[k] * r["calls"] for r in have) / w
    entry = {
        "name": label, "route": "cuda",
        "source": SOURCE_OF[name.split(".")[0]], "replaces": REPLACES[name],
        "launches": launches.get(name, 0),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"), "bound_by": "bytes",
        "library_ms": mean("library_ms")}
    log(f"timing {label}: {calls} calls/query, launch-weighted mean "
        f"kernel {entry['ms']:.4f} ms vs bound {entry['bound_ms']:.4f} ms")
    return entry


class Case:
    """One recorded kernel input: ``run`` calls the kernel through its
    wrapper, ``plain`` its plain version; ``check`` returns (max_abs_err,
    ok) of the two, bit for bit unless given; ``nbytes`` is what the
    function must move (each input read once, each output written once,
    counting what this input's data needs); ``library`` is one torch call
    computing the same function, or None."""

    def __init__(self, run, plain, nbytes, shape, check=None, library=None):
        self.run, self.plain = run, plain
        self.nbytes, self.shape = nbytes, shape
        self.check = check or (lambda: _exact(run(), plain()))
        self.library = library


def _case(name: str, args) -> Case:
    if name in SEGREDUCE:
        new, x, op, ident, order, out = args
        out_t = out or x.dtype
        cap = new.shape[0]
        gathered = (x if order is None else x[order.long()]).to(out_t)
        reduce = {"add": "sum", "min": "min", "max": "max"}[op]
        return Case(
            partial(wrapper_scan, new, x, op, ident, order, out),
            partial(kseg.plain_seg_scan, new, x, op, ident, order, out),
            cap * ((4 if order is not None else 0) + 1 + x.element_size() +
                   gathered.element_size()),
            f"{x.dtype}->{out_t} {op} cap={cap} src={x.shape[0]}",
            check=partial(compare, new, x, op, ident, order, out),
            library=partial(torch.segment_reduce, gathered, reduce,
                            lengths=_segments(new)))
    if name == "decode.expand_stream":
        # the whole expansion: the run table and the packed bytes in, 4*cap
        # out (the run matrix the bound counted before has the table's
        # size)
        table, packed, w, ncap, cap = args
        return Case(partial(kdec.expand_device, table, packed, w, ncap, cap),
                    partial(kdec.plain_expand_device, table, packed, w, ncap,
                            cap),
                    table.numel() * table.element_size() + packed.numel() +
                    4 * cap,
                    f"w={w} ncap={ncap} cap={cap} rows={table.shape[0]} "
                    f"{table.dtype}")
    if name == "decode.unpack_bits":
        b, w, ncap, out = args
        where = " in place" if out is not None else ""
        return Case(partial(kdec.unpack_bits, b, w, ncap, out=out),
                    partial(kdec.plain_unpack_bits, b, w, ncap),
                    b.shape[0] + 4 * ncap, f"w={w} ncap={ncap}{where}")
    if name == "filter_decode.decode":
        # keep bytes; per kept row its code; each dictionary entry at
        # most once; the output
        dbuf, codes, keep = args
        cap, esize, dlen = codes.shape[0], dbuf.element_size(), dbuf.shape[0]
        kept = int(keep.sum())
        return Case(partial(kfd.decode, dbuf, codes, keep),
                    partial(kfd.plain_decode, dbuf, codes, keep),
                    cap + 4 * kept + min(kept, dlen) * esize + cap * esize,
                    f"{dbuf.dtype} dict={dlen} cap={cap} kept={kept}")
    # decode_str: keep bytes; per kept row its byte base and length; each
    # dictionary byte at most once; the output
    dbuf, bb, lw, keep, width = args
    cap, dlen = bb.shape[0], dbuf.shape[0]
    kept = int(keep.sum())
    kept_bytes = int(torch.where(keep, lw.clamp(0, width), 0).sum())
    return Case(partial(kfd.decode_str, dbuf, bb, lw, keep, width),
                partial(kfd.plain_decode_str, dbuf, bb, lw, keep, width),
                cap + 8 * kept + min(kept_bytes, dlen) + cap * width,
                f"dict={dlen} B cap={cap} width={width} kept={kept} "
                f"kept_bytes={kept_bytes}")


def phase_timing(paths):
    """``paths``: (tag, launches, recorded classes, kernel names) of each
    q6 run.  Each listed kernel is checked against its plain version and
    timed at every shape that run gave it; a kernel listed under more than
    one run is named ``name@tag`` after its first entry.  No single torch
    call computes the predicated decode functions, so their library_ms is
    null; segreduce's is ``torch.segment_reduce`` where the dtype has one."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    kernels, seen = [], set()
    for tag, launches, classes, names in paths:
        for name in names:
            rows = []
            for key, c in sorted(classes.items(), key=lambda kv: str(kv[0])):
                if c["name"] != name:
                    continue
                case = _case(name, c["args"])
                err, ok = case.check()
                if not ok:
                    fail(f"kernel != plain at the {tag} shape {key} "
                         f"(max err {err})")
                ms = _time_device(case.run, flush=flush)
                plain_ms = _time_device(case.plain, reps=5, flush=flush)
                library_ms = None
                if case.library is not None:
                    try:
                        library_ms = _time_device(case.library, flush=flush)
                    except (RuntimeError, NotImplementedError):
                        pass       # no segment_reduce for this dtype
                bound_ms = case.nbytes / HBM_BYTES_PER_S * 1e3
                rows.append({"calls": c["calls"], "ms": ms,
                             "plain_ms": plain_ms, "library_ms": library_ms,
                             "bound_ms": bound_ms, "max_abs_err": err})
                lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
                log(f"timing {name} {tag} [{case.shape}] x{c['calls']}/query: "
                    f"kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_ms / ms:.1%} of roofline), plain "
                    f"{plain_ms:.3f} ms, library {lib}, max_abs_err "
                    f"{err:g}")
            if not rows:
                fail(f"no recorded call of {name} in {tag}")
            label = f"{name}@{tag}" if name in seen else name
            seen.add(name)
            kernels.append(_summary(label, name, rows, launches))
    return kernels


ALL_PHASES = ["build", "parity", "entry", "q6", "q6p", "q6pf", "q6s",
              "modes"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    phases = sys.argv[1].split(",") if len(sys.argv) > 1 else ALL_PHASES
    log(f"torch {torch.__version__} cuda {torch.version.cuda} pyarrow "
        f"{pa.__version__} on {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    phase_build()
    if "parity" in phases:
        phase_parity()
        phase_parity_decode()
    if "entry" in phases:
        phase_entry()
    runs = {}
    if "q6" in phases:
        runs["q6"] = ("q6", *phase_q6(), SEGREDUCE)
    if "q6p" in phases or "q6pf" in phases:
        root = _parquet_dir("q6-parquet")
        try:
            ref = write_q6_files(root)
            if "q6p" in phases:
                runs["q6p"] = ("q6-parquet", *phase_q6_parquet(root, ref),
                               Q6P_KERNELS)
            if "q6pf" in phases:
                runs["q6pf"] = ("q6-perfile", *phase_q6_perfile(root, ref),
                                Q6PF_KERNELS)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if "q6s" in phases:
        runs["q6s"] = ("q6s-parquet", *phase_q6s_parquet(),
                       ["filter_decode.decode_str"])
    if "modes" in phases:
        phase_perfile_modes()
    kernels = None
    if set(ALL_PHASES) <= set(phases):
        kernels = phase_timing([runs[k] for k in ("q6", "q6p", "q6s",
                                                  "q6pf")])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    _write_log()
    print(smi.stdout.strip() or f"nvidia-smi rc={smi.returncode}")
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
