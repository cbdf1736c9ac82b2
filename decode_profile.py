#!/usr/bin/env python3
"""Time the Parquet decode kernels at the inputs the q6 Parquet paths give
them.

    python3 decode_profile.py record CASES.pt [PATHS] # run the q6 Parquet
                                                      # paths, keep every
                                                      # kernel input
    python3 decode_profile.py time CASES.pt LABEL     # time this checkout's
                                                      # kernels on those inputs

``record`` runs q6 over the bench's 8 Parquet files through the fused
reader and through the PERFILE reader, and q6s over 4 files
(``chip_smoke.py``'s phases q6p, q6pf and q6s; PATHS, a comma-separated
subset of them, runs only those), and saves the inputs of each distinct
call shape of ``unpack_bits`` (the fused reader's phase 0), of the
expansion (the PERFILE reader's streams: the run table and the packed
bytes) and of the predicated dictionary gathers ``filter_decode.decode``
(fused q6 and q6s) and ``filter_decode.decode_str`` (q6s), with their calls
per query.  ``time`` needs only the saved file, so a checkout of another
commit can time its own kernels on the same inputs: run it from that
checkout's root (it imports that checkout's package and ``chip_smoke.py``).
A checkout whose expansion takes per-run deltas in three phases (the dense
unpack, the step functions, the gather, each its own launches) gets the
deltas from the table and is timed twice: its whole device half and its
last phase alone.  ``unpack_bits`` is timed writing a fresh array in every
checkout.  Beside each expansion and gather, ``fill_out`` times one
``torch.full`` of its output: the least a kernel that writes those bytes
costs.  Each gather's row also carries its bytes bound (``chip_smoke.py``'s
count) and the floor that counts the whole 32-byte sectors of the per-row
inputs (codes and dictionary entries; lw and byte_base) that its kept rows
touch.

Per shape and timed function, ``time`` prints one JSON line: its time as
``chip_smoke.py`` takes it (``_time_device``: CUDA events around one call
after a 5,000,000-cycle sleep on the GPU, L2 flushed, mean of 20); the
host's time to enqueue the call; from ``torch.profiler`` over 20 calls, the
device time and launches per call (the flush and the sleep left out) and
the device time per kernel name; and a sha256 of the output, so that two
checkouts can be seen to give the same values.  Output goes to stdout and
to ``chiprun_out/decode_profile-<label>.log``.  Needs one CUDA card.
"""

import hashlib
import json
import os
import shutil
import sys
import time
from functools import partial

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402  (the checkout being timed)
from spark_rapids_tpu_torch.kernels import decode as kdec  # noqa: E402
from spark_rapids_tpu_torch.kernels import filter_decode as kfd  # noqa: E402

REPS = 20
KERNELS = ("decode.unpack_bits", "decode.expand_stream",
           "filter_decode.decode", "filter_decode.decode_str")
PATHS = ("q6p", "q6pf", "q6s")


def record(path: str, paths=PATHS) -> None:
    cs.phase_build()
    runs = []
    if "q6p" in paths or "q6pf" in paths:
        root = cs._parquet_dir("q6-parquet")
        try:
            ref = cs.write_q6_files(root)
            if "q6p" in paths:
                runs.append(("q6-parquet",
                             cs.phase_q6_parquet(root, ref)[1]))
            if "q6pf" in paths:
                runs.append(("q6-perfile",
                             cs.phase_q6_perfile(root, ref)[1]))
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if "q6s" in paths:
        runs.append(("q6s-parquet", cs.phase_q6s_parquet()[1]))
    cases = {}
    for tag, classes in runs:
        for key, c in sorted(classes.items(), key=lambda kv: str(kv[0])):
            if c["name"] in KERNELS:
                # unpack is timed into a fresh array: the slice it wrote
                # into is not kept
                args = c["args"][:3] if c["name"] == KERNELS[0] \
                    else c["args"]
                cases[f"{tag} {' '.join(map(str, key))}"] = {
                    "name": c["name"], "calls": c["calls"], "args": args}
    torch.save(cases, path)
    print(f"saved {len(cases)} kernel input shapes to {path}")


def _deltas(table: torch.Tensor) -> torch.Tensor:
    """Absolute (start, A, C) rows back to per-row deltas, for a checkout
    whose package predates the run table."""
    mat = table.clone()
    mat[1:, 1:] -= table[:-1, 1:]
    return mat


def _sectors(mask: torch.Tensor, esize: int) -> int:
    """32-byte sectors of a ``[n]`` array of ``esize``-byte elements that
    hold at least one element where ``mask`` is true."""
    per = 32 // esize
    pad = -mask.shape[0] % per
    m = torch.cat([mask, mask.new_zeros(pad)]) if pad else mask
    return int(m.view(-1, per).any(1).sum())


def _gather_bounds(name: str, args) -> dict:
    """The bytes bound chip_smoke.py times the gather against, and the
    floor in whole 32-byte sectors: keep, the sectors of the per-row
    inputs that kept rows touch (decode: the codes and the dictionary
    entries; decode_str: lw and byte_base, with the dictionary bytes as
    the bound counts them), and the output."""
    case = cs._case(name, args)
    if name == "filter_decode.decode":
        dbuf, codes, keep = args
        es = dbuf.element_size()
        idx = codes[keep].long().clamp(0, dbuf.shape[0] - 1)
        hit = torch.zeros(dbuf.shape[0], dtype=torch.bool,
                          device=dbuf.device)
        hit[idx] = True
        nbytes = (keep.shape[0] + 32 * _sectors(keep, 4) +
                  32 * _sectors(hit, es) + keep.shape[0] * es)
    else:
        dbuf, bb, lw, keep, width = args
        kept = int(keep.sum())
        # the bound's count, less its 8 B per kept row of lw and byte_base
        nbytes = case.nbytes - 8 * kept + 2 * 32 * _sectors(keep, 4)
    return {"bound_ms": case.nbytes / cs.HBM_BYTES_PER_S * 1e3,
            "sector_floor_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}


def _functions(name: str, args) -> dict:
    """label -> the call to time, for this checkout's API."""
    if name == "filter_decode.decode":
        dbuf, codes, keep = args
        return {"kernel": partial(kfd.decode, dbuf, codes, keep),
                "fill_out": partial(torch.full, (codes.shape[0],), 7,
                                    dtype=dbuf.dtype, device=dbuf.device)}
    if name == "filter_decode.decode_str":
        dbuf, bb, lw, keep, width = args
        # the same bytes as int32: the profiler counts a uint8 fill as the
        # harness's L2 flush
        return {"kernel": partial(kfd.decode_str, dbuf, bb, lw, keep, width),
                "fill_out": partial(torch.full, (-(-bb.shape[0] * width // 4),),
                                    7, dtype=torch.int32, device=dbuf.device)}
    if name == "decode.unpack_bits":
        b, w, ncap = args[:3]
        return {"kernel": partial(kdec.unpack_bits, b, w, ncap)}
    table, packed, w, ncap, cap = args
    # the least a kernel that writes the output costs: one fill of it
    floor = {"fill_out": partial(torch.full, (cap,), 7, dtype=torch.int32,
                                 device=table.device)}
    if hasattr(kdec, "plain_expand_device"):       # one launch
        return {"kernel": partial(kdec.expand_device, table, packed, w, ncap,
                                  cap), **floor}
    mat = _deltas(table)
    dense = kdec.unpack_bits(packed, w, ncap) if w else \
        torch.zeros(32, dtype=torch.int32, device=table.device)
    a, c = kdec.step_functions(mat, cap)
    return {"half": partial(kdec.expand_device, mat, packed, w, ncap, cap),
            "phase2": partial(kdec.expand, dense, a, c), **floor}


def _enqueue_us(fn, flush) -> float:
    """Mean host time to enqueue one call, the GPU kept busy meanwhile."""
    fn()
    torch.cuda.synchronize()
    host = 0.0
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(cs.SLEEP_CYCLES)
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
        torch.cuda.synchronize()
    return host / REPS * 1e6


def _is_harness(kernel: str) -> bool:
    """The flush (a uint8 fill) and the sleep, not the function's own."""
    return "FillFunctor<unsigned char>" in kernel or "spin" in kernel.lower()


def _profiled(fn, flush) -> dict:
    """Device us and launches per call over REPS calls, each after an L2
    flush and a short sleep, and the device us per call of each kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            torch.cuda._sleep(200_000)
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not _is_harness(e.name):
            name = e.name if len(e.name) <= 70 else e.name[:70] + "..."
            t, n = per.get(name, (0.0, 0))
            per[name] = (t + e.device_time_total, n + 1)
    return {"device_us_per_call":
            round(sum(t for t, _ in per.values()) / REPS, 2),
            "launches_per_call": sum(n for _, n in per.values()) / REPS,
            "device_us_by_kernel": {k: round(t / REPS, 2)
                                    for k, (t, _) in per.items()}}


def time_cases(path: str, label: str) -> None:
    from spark_rapids_tpu_torch.kernels import _build
    _build.load("decode")
    _build.load("filter_decode")
    cases = torch.load(path, weights_only=False)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    with open(os.path.join(cs.OUT_DIR, f"decode_profile-{label}.log"),
              "w") as log:
        def out(row):
            line = json.dumps(row)
            print(line, flush=True)
            log.write(line + "\n")
        out({"label": label, "card": smi, "torch": torch.__version__})
        for case, c in cases.items():
            for fname, fn in _functions(c["name"], c["args"]).items():
                got = fn()
                torch.cuda.synchronize()
                row = {"label": label, "case": case, "fn": fname,
                       "calls": c["calls"],
                       "out_sha256": hashlib.sha256(
                           got.cpu().numpy().tobytes()).hexdigest()[:16],
                       "time_device_ms": cs._time_device(fn, flush=flush),
                       "host_enqueue_us": _enqueue_us(fn, flush)}
                row.update(_profiled(fn, flush))
                if fname == "kernel" and c["name"].startswith("filter_"):
                    row.update(_gather_bounds(c["name"], c["args"]))
                out(row)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if len(sys.argv) < 3 or sys.argv[1] not in ("record", "time"):
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "record":
        record(sys.argv[2], sys.argv[3].split(",") if len(sys.argv) > 3
               else PATHS)
    else:
        time_cases(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
