#!/usr/bin/env python3
"""Time the warm q6 and the window q47 walls of one checkout, for runs in
turns with another checkout in one chip call: what the kernel cache's
wrappers (first-call observe, OOM retry, dispatch count and ledger
charge) cost on the main path.

    python3 dispatch_profile.py write ROOT          # the SF10 files
    python3 dispatch_profile.py time ROOT LABEL     # one checkout
    python3 dispatch_profile.py turns OTHER [ROUNDS]  # both, in turns
    python3 dispatch_profile.py bypass ROOT         # cache vs direct

``write`` writes ``chip_smoke.py``'s SF10 q6 files under ``ROOT/q6`` and
its window files (store_sales, item, date_dim, store) under
``ROOT/star``, and the pyarrow references of q6 and q47 under
``ROOT/refs``.  ``time``, run from the root of the checkout being timed,
imports that checkout's package with this script's ``chip_smoke.py``,
builds its kernels and times, with CUDA events on the card:

- q6 over the files on one session (``bench.py::_query``; the smoke's
  ``compile`` phase's warm q6): one cold run, one warm-up, then
  ``Q6_RUNS`` warm runs;
- q47 (``bench/tpcds.py``; the smoke's ``window`` phase), a fresh session
  per run as there: one cold run, then ``Q47_RUNS`` warm runs.

A garbage-collector pass precedes every run, outside its time.  Every
output is checked against its reference.  Each query prints one JSON
line with every run's wall and the ``kernel.dispatches`` counter's move
in each run (0 in a checkout without the kernel cache), also written to
``chiprun_out/dispatch_profile-LABEL.json``.  ``turns OTHER`` writes the
files under ``chiprun_out/``, runs ``time`` from OTHER's root and this
one's in turns (other, this, this, other; ``ROUNDS`` times, default 1),
each in a process of its own and always with this checkout's script,
prints each side's median, min and max per query over all its processes
and each process's median, and removes the files.

``bypass`` (this checkout, files from ``write``) isolates the wrappers
from the noise between processes: in one process, ``BYPASS_PAIRS``
pairs of warm runs of each query, alternating which mode runs first,
with ``exec/kernel_cache.get_kernel`` as it is and swapped for a direct
call of the step's builder (no cache, no wrapper: each exec still
builds its keys).  It prints each mode's median and quartiles, and the
pairs the cached mode won.  Needs one CUDA card.
"""

import importlib.util
import json
import os
import shutil
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
Q6_RUNS = 7
Q47_RUNS = 4
BYPASS_PAIRS = 10
Q6_CONF = {"spark.rapids.tpu.sql.variableFloatAgg.enabled": True,
           "spark.rapids.tpu.sql.test.enabled": True}


def _smoke():
    """This script's chip_smoke.py, importing the package of the checkout
    in the working directory."""
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location(
        "dispatch_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def write(root: str) -> None:
    import pyarrow.parquet as papq
    cs = _smoke()
    if os.path.exists(root):
        shutil.rmtree(root)
    for d in ("q6", "star", "refs"):
        os.makedirs(os.path.join(root, d))
    refs = {"q6": cs.write_q6_files(os.path.join(root, "q6"))}
    tables = cs.write_star_files(os.path.join(root, "star"))
    tables["store"] = cs.write_store_file(os.path.join(root, "star"))
    refs["q47"] = cs.window_reference("q47", tables)
    for q, t in refs.items():
        papq.write_table(t, os.path.join(root, "refs", f"{q}.parquet"))


def _queries(root: str, label: str):
    """(chip_smoke module, card, {query: timed run}) for the checkout in
    the working directory: each timed run returns (CUDA-event ms, the
    ``kernel.dispatches`` counter's move)."""
    import gc
    import pyarrow.parquet as papq
    import torch
    cs = _smoke()
    cs.LOG_NAME = f"dispatch_profile-{label}.log"
    import spark_rapids_tpu_torch
    from spark_rapids_tpu_torch.api import TpuSparkSession
    from spark_rapids_tpu_torch.obs import registry as obsreg
    cs.log(f"{label}: package "
           f"{os.path.dirname(spark_rapids_tpu_torch.__file__)}")
    cs.phase_build()
    card = cs._card()
    reg = obsreg.get_registry()
    refs = {q: papq.read_table(os.path.join(root, "refs", f"{q}.parquet"))
            for q in ("q6", "q47")}
    s = TpuSparkSession(dict(cs.SCAN_CONF, **Q6_CONF), device="cuda")
    df = cs.bench_query(s, os.path.join(root, "q6"))
    run47 = cs.query_run("q47", os.path.join(root, "star"),
                         cs.WINDOW_TABLES, cs.STAR_CONF)

    def q6():
        out, _wall, ev = cs._timed_collect(df)
        cs.check_q6(out, refs["q6"])
        return ev

    def q47():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, _plan = run47({})
        end.record()
        torch.cuda.synchronize()
        cs.check_rows("q47", out, refs["q47"])
        return start.elapsed_time(end) / 1e3

    def timed(fn):
        def run():
            gc.collect()
            before = reg.counter("kernel.dispatches")
            ev = fn()
            return ev * 1e3, int(reg.counter("kernel.dispatches") - before)
        return run
    return cs, card, {"q6": timed(q6), "q47": timed(q47)}


def time_queries(root: str, label: str) -> None:
    cs, card, runs_of = _queries(root, label)
    lines = []
    for query, warmups, runs in (("q6", 1, Q6_RUNS), ("q47", 0, Q47_RUNS)):
        timed = runs_of[query]
        cold, cold_disp = timed()
        for _ in range(warmups):
            timed()
        walls, disp = [], []
        for _ in range(runs):
            ms, n = timed()
            walls.append(ms)
            disp.append(n)
        line = {"label": label, "query": query, "cold_ms": cold,
                "cold_dispatches": cold_disp, "walls_ms": walls,
                "dispatches": disp, "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, f"dispatch_profile-{label}.json"),
              "w") as f:
        json.dump(lines, f, indent=1)
    cs._write_log()


def turns(other: str, rounds: int) -> int:
    """Write the files, then time ``other`` and this checkout in turns
    (other, this, this, other; ``rounds`` times), each in a process of
    its own."""
    import subprocess
    root = os.path.abspath(os.path.join("chiprun_out", "dp-root"))
    script = os.path.join(HERE, "dispatch_profile.py")
    runs = []
    try:
        write(root)
        order = [("other", other), ("this", "."), ("this", "."),
                 ("other", other)] * rounds
        for i, (who, cwd) in enumerate(order):
            label = f"{who}{i + 1}"
            proc = subprocess.run(
                [sys.executable, script, "time", root, label],
                cwd=cwd, capture_output=True, text=True)
            sys.stderr.write(proc.stderr[-2000:])
            if proc.returncode != 0:
                print(proc.stdout[-4000:])
                print(f"{label}: rc={proc.returncode}")
                return 1
            for ln in proc.stdout.splitlines():
                if ln.startswith("{"):
                    print(ln, flush=True)
                    runs.append(json.loads(ln))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sides, meds = {}, {}
    for r in runs:
        who = "other" if r["label"].startswith("other") else "this"
        sides.setdefault((r["query"], who), []).extend(r["walls_ms"])
        meds.setdefault((r["query"], who), []).append(
            statistics.median(r["walls_ms"]))
    for (query, who), walls in sorted(sides.items()):
        print(f"{query} {who}: median {statistics.median(walls):.1f} ms, "
              f"min {min(walls):.1f}, max {max(walls):.1f} over "
              f"{len(walls)} warm runs; per process "
              + ", ".join(f"{m:.1f}" for m in meds[(query, who)]))
    return 0


def bypass(root: str) -> None:
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    cs, card, runs_of = _queries(root, "bypass")
    cached = kc.get_kernel

    def direct(key, builder, oom_retry=True, backend=None):
        return builder()
    modes = {"cached": cached, "direct": direct}
    for query, timed in runs_of.items():
        timed()                                  # cold, cached
        walls = {"cached": [], "direct": []}
        disp = {"cached": set(), "direct": set()}
        try:
            for i in range(BYPASS_PAIRS + 1):
                for mode in (("cached", "direct") if i % 2 else
                             ("direct", "cached")):
                    kc.get_kernel = modes[mode]
                    ms, n = timed()
                    if i:                        # pair 0 warms both
                        walls[mode].append(ms)
                        disp[mode].add(n)
        finally:
            kc.get_kernel = cached
        won = sum(c < d for c, d in zip(walls["cached"], walls["direct"]))
        qs = {m: statistics.quantiles(w, n=4) for m, w in walls.items()}
        print(json.dumps({"query": query, "walls_ms": walls,
                          "dispatches": {m: sorted(v)
                                         for m, v in disp.items()},
                          "card": card}), flush=True)
        print(f"{query}: cached median {qs['cached'][1]:.1f} ms (quartiles "
              f"{qs['cached'][0]:.1f}-{qs['cached'][2]:.1f}), direct median "
              f"{qs['direct'][1]:.1f} ms (quartiles {qs['direct'][0]:.1f}-"
              f"{qs['direct'][2]:.1f}); cached faster in {won} of "
              f"{BYPASS_PAIRS} pairs [{card}]", flush=True)
    cs._write_log()


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[1] not in ("write", "time", "turns",
                                                 "bypass"):
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "write":
        write(sys.argv[2])
        return 0
    if sys.argv[1] == "bypass":
        bypass(sys.argv[2])
        return 0
    if sys.argv[1] == "turns":
        return turns(sys.argv[2],
                     int(sys.argv[3]) if len(sys.argv) > 3 else 1)
    if len(sys.argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    time_queries(sys.argv[2], sys.argv[3])
    return 0


if __name__ == "__main__":
    sys.exit(main())
