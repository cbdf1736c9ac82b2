#!/usr/bin/env python3
"""Time design variants of the predicated dictionary gathers
(``spark_rapids_tpu_torch/csrc/filter_decode.cu``) on recorded q6 inputs.

    python3 decode_profile.py record CASES.pt q6p,q6s
    python3 filter_decode_variants.py CASES.pt [NAME,...]

Each variant is the checkout's source with a few textual edits (``VARIANTS``
below; ``base`` has none).  All are compiled with the same ``nvcc`` flags as
the package (``kernels/_build.py``), one process each, in parallel, into
``build/variants/``; then each is loaded in turn in place of the package's
library and times ``filter_decode.decode`` and ``filter_decode.decode_str``
on every gather input of CASES.pt, as ``chip_smoke.py`` times a kernel
(``_time_device``: CUDA events, L2 flushed, mean of 20).  The variants run
in order and then in reverse, on one card in one process, so each is timed
twice; every output is checked against the plain version first.  One JSON
line per variant and case goes to stdout and to
``chiprun_out/filter_decode_variants.log``.  Needs one CUDA card.
"""

import concurrent.futures as cf
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from spark_rapids_tpu_torch.kernels import _build  # noqa: E402
from spark_rapids_tpu_torch.kernels import filter_decode as kfd  # noqa: E402

SOURCE = Path(kfd.SOURCE)
OUT = _build.BUILD_DIR / "variants"


def _capped(per_sm: int) -> dict:
    """The grid capped at per_sm blocks per SM, each block looping."""
    return {"  const long long most = INT32_MAX;": (
        "  int sms = 132;\n"
        "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);\n"
        f"  const long long most = static_cast<long long>(sms) * {per_sm};")}


VARIANTS = {
    "base": {},
    # 8-byte elements in groups of 4 rows: two 16-byte stores per lane,
    # each store instruction of a warp striding over 1 KB
    "rows4_8byte": {
        "  constexpr int R = 16 / sizeof(T);":
            "  constexpr int R = 4;",
        "      __stcs(reinterpret_cast<ulonglong2*>(out + r),\n"
        "             make_ulonglong2(v[0], v[1]));":
            "      __stcs(reinterpret_cast<ulonglong2*>(out + r),\n"
            "             make_ulonglong2(v[0], v[1]));\n"
            "      if constexpr (R == 4)\n"
            "        __stcs(reinterpret_cast<ulonglong2*>(out + r) + 1,\n"
            "               make_ulonglong2(v[2], v[3]));"},
    "grid_8_per_sm": _capped(8),
    "grid_4_per_sm": _capped(4),
    "rows_per_lane_8": {"constexpr int DECODE_ROWS = 16;":
                        "constexpr int DECODE_ROWS = 8;"},
    "rows_per_lane_32": {"constexpr int DECODE_ROWS = 16;":
                         "constexpr int DECODE_ROWS = 32;"},
    # every width through the row-walking decode_str kernel
    "walk_only": {"  if (width % 16 == 0 && lead == 0) {": "  if (false) {"},
    "windows2": {"constexpr int STR_WINDOWS = 4;":
                 "constexpr int STR_WINDOWS = 2;"},
    "windows8": {"constexpr int STR_WINDOWS = 4;":
                 "constexpr int STR_WINDOWS = 8;"},
}


def build(name: str, edits: dict) -> Path:
    src = SOURCE.read_text()
    for old, new in edits.items():
        if old not in src:
            raise RuntimeError(f"variant {name}: the source has no {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    cmd = _build.compile_command("filter_decode", lib)
    cmd[-1] = str(cu)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for variant {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return lib


def use(lib: Path) -> None:
    """Route the package's wrappers to this library."""
    dll = ctypes.CDLL(str(lib.resolve()))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.filter_decode.argtypes = [ci, vp, ll, vp, vp, ll, vp, ci, vp]
    dll.filter_decode.restype = ci
    dll.filter_decode_str.argtypes = [vp, ll, vp, vp, vp, ll, ci, vp, ci, vp]
    dll.filter_decode_str.restype = ci
    kfd._lib = dll


def main() -> int:
    if not torch.cuda.is_available():
        print("filter_decode_variants: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    names = sys.argv[2].split(",") if len(sys.argv) > 2 else list(VARIANTS)
    if "base" not in names:
        names.insert(0, "base")
    with cf.ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {n: pool.submit(build, n, VARIANTS[n]) for n in names}
    libs = {n: f.result() for n, f in futures.items()}
    cases = {}
    for key, c in torch.load(sys.argv[1], weights_only=False).items():
        if c["name"] == "filter_decode.decode":
            cases[key] = (kfd.decode, kfd.plain_decode, c)
        elif c["name"] == "filter_decode.decode_str":
            cases[key] = (kfd.decode_str, kfd.plain_decode_str, c)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    with open(os.path.join(cs.OUT_DIR, "filter_decode_variants.log"),
              "w") as log:
        def out(row):
            line = json.dumps(row)
            print(line, flush=True)
            log.write(line + "\n")
        out({"card": smi, "torch": torch.__version__, "variants": names})
        for rnd, order in enumerate((names, names[::-1])):
            for name in order:
                use(libs[name])
                for key, (fn, plain, c) in cases.items():
                    got, want = fn(*c["args"]), plain(*c["args"])
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.uint8),
                                       want.view(torch.uint8)):
                        out({"variant": name, "case": key, "ok": False})
                        return 1
                    out({"variant": name, "round": rnd, "case": key,
                         "calls": c["calls"],
                         "time_device_ms": cs._time_device(
                             lambda: fn(*c["args"]), flush=flush)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
