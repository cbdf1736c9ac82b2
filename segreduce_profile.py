#!/usr/bin/env python3
"""Profile the segreduce kernel at the inputs the q6 paths give it.

    python3 segreduce_profile.py record CASES.pt   # run the q6 paths, keep
                                                   # every segreduce input
    python3 segreduce_profile.py time CASES.pt     # profile this checkout's
                                                   # kernel on those inputs

``record`` runs q6 in memory, over 8 Parquet files through the fused
reader and through the PERFILE reader (``chip_smoke.py``'s phases q6, q6p
and q6pf) and saves the inputs of each distinct segreduce call shape with
its calls per query.  ``time`` needs only the saved file, so a checkout of
another commit can time its own kernel on the same inputs: run it from
that checkout's root (it imports that checkout's ``chip_smoke.py``).

Per shape, ``time`` prints one JSON line: the kernel's agreement with its
plain version; its time as that checkout's ``chip_smoke.py`` takes it
(``_time_device``: CUDA events around one call after a sleep on the GPU,
L2 flushed, mean of 20); the event time after a 200,000-cycle sleep
(about 0.12 ms) with the host's time to enqueue the call; the event time
after a 5,000,000-cycle sleep, long enough that the host has surely
enqueued the call before the GPU reaches it; and, from ``torch.profiler``
over 20 reps, each after an L2 flush, the device time per call of every
kernel the call launched.  It also describes the flags: their number,
and the tiles of 2048 rows that hold none.  Output goes to stdout and to
``chiprun_out/segreduce_profile-<label>.log``.  Needs one CUDA card.
"""

import json
import os
import shutil
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402  (the checkout being profiled)

REPS = 20


def record(path: str) -> None:
    cs.phase_build()
    runs = [("q6", cs.phase_q6()[1])]
    root = cs._parquet_dir("q6-parquet")
    try:
        ref = cs.write_q6_files(root)
        runs.append(("q6-parquet", cs.phase_q6_parquet(root, ref)[1]))
        runs.append(("q6-perfile", cs.phase_q6_perfile(root, ref)[1]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cases = {}
    for tag, classes in runs:
        for key, c in sorted(classes.items(), key=lambda kv: str(kv[0])):
            if c["name"].startswith("segreduce"):
                cases[f"{tag} {' '.join(map(str, key))}"] = {
                    "calls": c["calls"], "args": c["args"]}
    torch.save(cases, path)
    print(f"saved {len(cases)} segreduce shapes to {path}")


def describe(new: torch.Tensor, tile: int = 2048) -> dict:
    cap = new.numel()
    nb = -(-cap // tile)
    f = torch.zeros(nb * tile, dtype=torch.bool, device=new.device)
    f[:cap] = new
    has = f.view(nb, tile).any(1)
    return {"flags": int(new.sum()), "tiles_2048": nb,
            "tiles_2048_without_flag": int((~has).sum())}


def _event_ms(fn, flush, sleep_cycles: int):
    """(mean event ms, mean host enqueue us) over REPS calls."""
    fn()
    torch.cuda.synchronize()
    total = host = 0.0
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        host += time.perf_counter() - t0
        b.synchronize()
        total += a.elapsed_time(b)
    return total / REPS, host / REPS * 1e6


def _profiled(fn, flush) -> dict:
    """Device us per launch of each kernel, over REPS reps, each after
    an L2 flush."""
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
    # the profiler may drop a rep's events: average over those it kept
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name if len(e.name) <= 70 else e.name[:70] + "..."
            t, c = per.get(name, (0.0, 0))
            per[name] = (t + e.device_time_total, c + 1)
    return {k: round(t / c, 2) for k, (t, c) in per.items()}


def time_cases(path: str, label: str) -> None:
    cs.phase_build()
    cases = torch.load(path, weights_only=False)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    with open(os.path.join(cs.OUT_DIR, f"segreduce_profile-{label}.log"),
              "w") as log:
        def out(row):
            line = json.dumps(row)
            print(line, flush=True)
            log.write(line + "\n")
        out({"label": label, "card": smi, "torch": torch.__version__})
        for name, c in cases.items():
            new, x, op, ident, order, dtype = c["args"]

            def fn(new=new, x=x, op=op, ident=ident, order=order,
                   dtype=dtype):
                return cs.wrapper_scan(new, x, op, ident, order, dtype)
            err, ok = cs.compare(new, x, op, ident, order, dtype)
            row = {"label": label, "case": name, "calls": c["calls"],
                   "ok": ok, "max_abs_err": err}
            row.update(describe(new))
            row["time_device_ms"] = cs._time_device(fn, flush=flush)
            row["event_ms"], row["host_enqueue_us"] = _event_ms(
                fn, flush, 200_000)
            row["event_ms_long_sleep"], _ = _event_ms(fn, flush, 5_000_000)
            row["profiler_device_us"] = _profiled(fn, flush)
            out(row)


def main() -> int:
    if not torch.cuda.is_available():
        print("segreduce_profile: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if len(sys.argv) < 3 or sys.argv[1] not in ("record", "time"):
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "record":
        record(sys.argv[2])
    else:
        time_cases(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
