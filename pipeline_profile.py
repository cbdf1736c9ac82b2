#!/usr/bin/env python3
"""Time the q6 forms' sections in one checkout, for runs in turns with
another checkout in one chip call.

    python3 pipeline_profile.py write ROOT           # the SF10 q6 files
    python3 pipeline_profile.py time ROOT LABEL [DEPTHS]
    python3 pipeline_profile.py turns OTHER [DEPTHS]  # both, in turns

``write`` writes the 8 SF10 Parquet files of ``chip_smoke.py``'s q6
phases under ``ROOT`` once, for every checkout to read.  ``time``, run
from the root of the checkout being timed, imports that checkout's
package and builds its kernels, makes the in-memory SF10 table, and
times the fused q6 and the PERFILE q6 (``bench.py::_query`` on a
session) and the in-memory q6 (``entry.q6_plan``) with this script's
``chip_smoke.py`` (``form_sections``): per form, the median of 5 warm
runs after a warm-up, on the host clock, of the wall, every exec section
(``scan.hostPrepTime``, ``scan.uploadTime``, ``scan.dispatch``,
``scan.decode``, ``transition.upload``, ``agg.update``, ``agg.merge``)
and the host functions that split them (the fused host prep's
``_collect_plans`` and ``assemble``; the PERFILE decode's O(runs)
Python: ``stream_width``, ``_dense_extent``, ``_dense_meta`` and the
run matrix's ``_runs_arrays`` (``_upload_runs`` in a checkout that
uploads column by column); the in-memory upload's
``_np_column_from_arrow`` and
``_upload_hints``).  ``DEPTHS`` (default ``2``) lists the
``sql.scan.prefetch.depth`` values the fused q6 runs at; a checkout
that has no prefetcher ignores the key.  Every output is checked
against pyarrow first.  Each form prints one JSON line, also written to
``chiprun_out/pipeline_profile-LABEL.json``.  Needs one CUDA card.

To compare two commits: unpack the other with ``git archive`` into a
git-ignored directory, write the files once, then run ``time`` from the
root of each checkout in turns (other, this, this, other), always with
this checkout's script.  ``turns OTHER`` does all of that from this
checkout's root (files under ``chiprun_out/``, removed at the end; the
other checkout at its default depth, this one at ``DEPTHS``, default
``2,0``) and prints, per form and section, the mean of each checkout's
two medians.
"""

import importlib.util
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    """This script's chip_smoke.py, importing the package of the checkout
    in the working directory."""
    sys.path.insert(0, os.getcwd())
    spec = importlib.util.spec_from_file_location(
        "pipeline_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def write(root: str) -> None:
    cs = _smoke()
    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    cs.write_q6_files(root)


def time_forms(root: str, label: str, depths) -> None:
    import pyarrow.parquet as papq
    cs = _smoke()
    cs.LOG_NAME = f"pipeline_profile-{label}.log"
    import spark_rapids_tpu_torch
    cs.log(f"{label}: package "
           f"{os.path.dirname(spark_rapids_tpu_torch.__file__)}")
    cs.phase_build()
    table, mem_ref = cs.q6_table()
    ref = cs.q6_reference(papq.read_table(root, columns=cs.Q6PF_COLUMNS))
    forms = cs.pipeline_forms(root, table)
    refs = {"fused": ref, "perfile": ref, "memory": mem_ref}
    lines = []
    for form, run in forms.items():
        cs.check_q6(run({})[0], refs[form])
        for depth in (depths if form == "fused" else (None,)):
            conf = {} if depth is None else {cs.DEPTH_KEY: depth}
            sec = cs.form_sections(form, run, conf)
            line = {"label": label, "form": form, "depth": depth,
                    "ms": {k: v * 1e3 for k, v in sec.items()
                           if k != "walls"},
                    "walls_ms": [w * 1e3 for w in sec["walls"]]}
            print(json.dumps(line), flush=True)
            lines.append(line)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, f"pipeline_profile-{label}.json"),
              "w") as f:
        json.dump(lines, f, indent=1)
    cs._write_log()


def turns(other: str, depths: str) -> int:
    """Write the files, then time ``other`` and this checkout in turns
    (other, this, this, other), each in a process of its own."""
    import subprocess
    root = os.path.abspath(os.path.join("chiprun_out", "pp-root"))
    write(root)
    script = os.path.join(HERE, "pipeline_profile.py")
    runs = []
    try:
        for label, cwd, dep in (("other", other, "2"), ("this", ".", depths),
                                ("this2", ".", depths),
                                ("other2", other, "2")):
            proc = subprocess.run(
                [sys.executable, script, "time", root, label, dep],
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
    table = {}
    for r in runs:
        who = "other" if r["label"].startswith("other") else "this"
        key = (r["form"], r["depth"] if who == "this" else None, who)
        for k, v in r["ms"].items():
            table.setdefault(key, {}).setdefault(k, []).append(v)
    for (form, depth, who), secs in sorted(table.items(), key=str):
        print(f"{form} {who}" + (f" depth {depth}" if depth is not None
                                 else "") + ": " + ", ".join(
            f"{k} {sum(v) / len(v):.1f} ms" for k, v in secs.items()))
    return 0


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[1] not in ("write", "time", "turns"):
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "write":
        write(sys.argv[2])
        return 0
    if sys.argv[1] == "turns":
        return turns(sys.argv[2], sys.argv[3] if len(sys.argv) > 3
                     else "2,0")
    if len(sys.argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    depths = [int(d) for d in sys.argv[4].split(",")] \
        if len(sys.argv) > 4 else [2]
    time_forms(sys.argv[2], sys.argv[3], depths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
