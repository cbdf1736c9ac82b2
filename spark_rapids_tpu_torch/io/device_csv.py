"""Device-side CSV decode: the delimiter scan and the field parse run as
torch operations over the file's raw bytes on the device.

Ported from ``spark_rapids_tpu/io/device_csv.py`` (``prescan`` :48,
``_decode_kernel`` :82, ``_parse_column`` :130, ``decode_csv`` :213).
The reference composes XLA ops in one jitted program; the port composes
the same torch ops eagerly:

  * the raw file bytes upload ONCE as a uint8 tensor (through pinned
    memory on the card, ``columnar/transfer``);
  * an elementwise compare finds every delimiter and newline, a cumsum
    ranks them, and their byte positions scatter into a
    ``[cap * n_cols + 1]`` boundary vector whose last slot takes every
    non-delimiter byte and drops (``columnar/batch.scatter_drop``);
  * per parsed column, a ``[rows, width]`` byte window gathers the field
    and a fixed-step fold (``v = v*10 + digit``) parses ints and floats.

The host runs an O(bytes) numpy prescan only to size the shapes (row
count, per-column width buckets) and to refuse dialects the device parse
does not cover (quoted fields, ragged rows): :class:`UnsupportedCsv`,
on which the scan reads the whole file with Arrow.  Exotic numerics
(exponents, NaN, a second dot, more than 18 digits, an int32 overflow)
clear the column's ok flag and that column is read on the host.

Floats are ``int + frac / 10**n`` in float64 as the reference's XLA
program computes it on the CPU, ``fma(frac, RN(10**-n), int)`` rounded
once (:func:`_fold_float`): the result equals the reference's bit for
bit, and is not always Arrow's correctly rounded value.

Coverage: int32/int64/float32/float64 (fixed-point, optional sign,
optional fraction), bool (true/false), strings, empty-string nulls,
trailing ``\\r`` (CRLF), header skip.  A schema with any other type
(DATE32 among them) sends the whole file to the host, even when that
column is pruned: the reference's rule.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, DeviceColumn,
                                                   _bucket_strlen,
                                                   bucket_rows,
                                                   resolve_device,
                                                   scatter_drop)
from spark_rapids_tpu_torch.plan.logical import Schema


class UnsupportedCsv(Exception):
    pass


def prescan(raw: bytes, n_cols: int, sep: bytes = b",",
            header: bool = True):
    """Vectorized host prescan: row count, per-column width buckets,
    dialect checks.  O(bytes) numpy, no per-field work."""
    a = np.frombuffer(raw, dtype=np.uint8)
    if header:
        # strip the header BEFORE the quote check: writers commonly
        # quote column names while leaving data unquoted
        first_nl = int(np.argmax(a == 0x0A)) if 0x0A in a[:1 << 20] \
            else -1
        if first_nl < 0:
            raise UnsupportedCsv("no header newline")
        a = a[first_nl + 1:]
    if np.any(a == ord('"')):
        raise UnsupportedCsv("quoted fields")
    if a.shape[0] and a[-1] != 0x0A:
        a = np.concatenate([a, np.array([0x0A], np.uint8)])
    is_nl = a == 0x0A
    n_rows = int(is_nl.sum())
    if n_rows == 0:
        return a, 0, [1] * n_cols
    is_delim = (a == sep[0]) | is_nl
    pos = np.flatnonzero(is_delim)
    if pos.shape[0] != n_rows * n_cols:
        raise UnsupportedCsv("ragged rows")
    bounds = pos.reshape(n_rows, n_cols)
    starts = np.empty_like(bounds)
    starts[:, 1:] = bounds[:, :-1] + 1
    starts[0, 0] = 0
    starts[1:, 0] = bounds[:-1, -1] + 1
    widths = (bounds - starts).max(axis=0)
    return a, n_rows, [max(int(w), 1) for w in widths]


# RN(10**-k), the reciprocals of the exact powers of ten (an 18-digit
# fraction needs at most 10**18)
_RCP10 = tuple(1.0 / float(10 ** k) for k in range(19))


def _two_sum(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor):
    """The exact error of ``s = a + b`` (Knuth's TwoSum)."""
    bb = s - a
    return (a - (s - bb)) + (b - bb)


def _two_prod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor):
    """The exact error of ``p = a * b`` (Dekker's product over Veltkamp
    splits; no fused multiply-add)."""
    def split(x):
        c = x * 134217729.0          # 2**27 + 1
        hi = c - (c - x)
        return hi, x - hi
    ah, al = split(a)
    bh, bl = split(b)
    return ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fold_float(int_v: torch.Tensor, frac_v: torch.Tensor,
                frac_n: torch.Tensor) -> torch.Tensor:
    """``int + frac / 10**n`` in float64 as the reference's program gives
    it: XLA's CPU backend turns the division into a multiply by the
    rounded reciprocal and fuses it with the add, so the value is
    ``fma(frac, RN(10**-n), int)``, rounded once.  Torch has no float64
    fused multiply-add, so this computes the exact sum of the rounded
    terms with error-free transformations and rounds it once: the sum of
    ``s + u`` is correct except where it lands exactly on a midpoint,
    which the last term ``v`` breaks.  Every step is its own rounded
    torch operation."""
    rcp = torch.tensor(_RCP10, dtype=torch.float64, device=int_v.device)
    a = frac_v.to(torch.float64)
    b = rcp[torch.clamp(frac_n, 0, len(_RCP10) - 1).long()]
    c = int_v.to(torch.float64)
    p = a * b
    e = _two_prod(a, b, p)
    s = c + p
    t = _two_sum(c, p, s)
    u = t + e
    v = _two_sum(t, e, u)
    w = s + u
    z = _two_sum(s, u, w)
    # exact = w + z + v with |v| <= ulp(u) / 2: only a z of exactly half
    # the gap to w's neighbour (a tie for w's rounding) lets v decide
    nxt = torch.nextafter(w, torch.where(z > 0, math.inf, -math.inf)
                          .to(torch.float64))
    half = (nxt - w).abs() * 0.5
    fix = (z != 0) & (z.abs() == half) & (v != 0) & \
        ((v > 0) == (z > 0))
    return torch.where(fix, nxt, w)


def decode_columns(raw: torch.Tensor, n_rows: int, n_cols: int, cap: int,
                   widths: Sequence[int], dtypes_key: Sequence[str],
                   sep: int, parse_cols: Sequence[int]):
    """Delimiter scan -> boundary matrix -> per-column parse (the
    reference's ``_decode_kernel``).  ``raw`` is the padded byte tensor;
    returns one ``(data, validity, lengths, ok)`` tuple per parsed
    column, ``ok`` a 0-d bool tensor."""
    dev = raw.device
    nb = raw.shape[0]
    is_nl = raw == 0x0A
    is_delim = (raw == sep) | is_nl
    # rank every delimiter and scatter its byte position; every other
    # byte lands in the dropped slot cap * n_cols (the prescan checked
    # there are exactly n_rows * n_cols delimiters, so rows past n_rows
    # stay zero and row_pad masks them)
    did = torch.cumsum(is_delim.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(is_delim, did, cap * n_cols)
    bounds = scatter_drop(tgt, torch.arange(nb, dtype=torch.int32,
                                            device=dev), cap * n_cols)
    bounds = bounds.reshape(cap, n_cols)
    first = torch.cat([torch.zeros((1, 1), dtype=torch.int32, device=dev),
                       bounds[:-1, -1:] + 1])
    starts = torch.cat([first, bounds[:, :-1] + 1], dim=1)
    lens = bounds - starts
    # strip a trailing \r (CRLF) from the LAST field of each row
    last_byte = raw[torch.clamp(bounds[:, -1] - 1, 0, nb - 1).long()]
    cr = (last_byte == 0x0D) & (lens[:, -1] > 0)
    lens = torch.cat([lens[:, :-1], (lens[:, -1] - cr.to(torch.int32))
                      [:, None]], dim=1)

    row_pad = torch.arange(cap, device=dev) < n_rows
    out = []
    # column pruning: the delimiter scan covers every column, but the
    # gather and the parse run only for the requested ones
    for c in parse_cols:
        F = widths[c]
        st = torch.where(row_pad, starts[:, c], 0)
        ln = torch.where(row_pad, lens[:, c], 0)
        pos_in = torch.arange(F, dtype=torch.int32, device=dev)
        idx = (st[:, None] + pos_in[None, :]).long()
        in_field = pos_in[None, :] < ln[:, None]
        mat = torch.where(in_field & row_pad[:, None],
                          raw[torch.clamp(idx, 0, nb - 1)], 0)
        out.append(_parse_column(mat, ln, row_pad, dtypes_key[c], F))
    return out


def _parse_column(mat: torch.Tensor, ln: torch.Tensor,
                  row_pad: torch.Tensor, dkey: str, F: int):
    """(data, validity, lengths, ok) for one column; ``ok`` is a 0-d
    False when a field used syntax the device parse does not cover."""
    dev = mat.device
    empty = ln == 0
    true_ = torch.ones((), dtype=torch.bool, device=dev)
    if dkey == "string":
        valid = row_pad & ~empty
        return (torch.where(valid[:, None], mat, 0), valid,
                torch.where(valid, ln, 0).to(torch.int32), true_)
    if dkey == "bool":
        def word(wd: bytes):
            m = ln == len(wd)
            for j, byte in enumerate(wd):
                if j < F:
                    m = m & ((mat[:, j] | 0x20) == (byte | 0x20))
                else:
                    m = torch.zeros_like(m)
            return m
        is_t = word(b"true")
        is_f = word(b"false")
        valid = row_pad & ~empty & (is_t | is_f)
        ok = torch.all(~row_pad | empty | is_t | is_f)
        return is_t & valid, valid, None, ok

    # numeric: [-]digits[.digits]
    neg = mat[:, 0] == ord("-")
    digit = mat.to(torch.int64) - ord("0")
    is_digit = (digit >= 0) & (digit <= 9)
    is_dot = mat == ord(".")
    pos_in = torch.arange(F, dtype=torch.int32, device=dev)[None, :]
    in_field = pos_in < ln[:, None]
    legal = ~in_field | is_digit | is_dot | ((pos_in == 0) & neg[:, None])
    ok = torch.all(legal | ~row_pad[:, None])
    one_dot = (is_dot & in_field).to(torch.int32).sum(dim=1) <= 1
    ok = ok & torch.all(one_dot | ~row_pad)

    dot_pos = torch.where(is_dot & in_field, pos_in,
                          F).min(dim=1).values
    rows = mat.shape[0]
    int_v = torch.zeros(rows, dtype=torch.int64, device=dev)
    frac_v = torch.zeros(rows, dtype=torch.int64, device=dev)
    frac_n = torch.zeros(rows, dtype=torch.int32, device=dev)
    n_dig = torch.zeros(rows, dtype=torch.int32, device=dev)
    for i in range(F):
        d = digit[:, i]
        live = is_digit[:, i] & (i < ln)
        take_int = live & (i < dot_pos)
        take_frac = live & (i > dot_pos)
        int_v = torch.where(take_int, int_v * 10 + d, int_v)
        frac_v = torch.where(take_frac, frac_v * 10 + d, frac_v)
        frac_n = frac_n + take_frac.to(torch.int32)
        n_dig = n_dig + (take_int | take_frac).to(torch.int32)
    # a bare '-' / '.' is NOT a number, and >18 digits would silently
    # wrap the int64 fold: both take the host fallback instead
    ok = ok & torch.all((n_dig >= 1) | empty | ~row_pad)
    ok = ok & torch.all((n_dig <= 18) | ~row_pad)
    valid = row_pad & ~empty
    if dkey in ("int32", "int64"):
        # a '.' in an integer column falls back
        ok = ok & torch.all(dot_pos >= torch.where(row_pad, ln, 0))
        v = torch.where(neg, -int_v, int_v)
        v = torch.where(valid, v, 0)
        if dkey == "int32":
            # the 18-digit guard only protects the int64 fold; values
            # outside the int32 range would wrap on the cast, so they
            # take the host fallback like other unsupported numerics
            in_range = (v >= -2 ** 31) & (v <= 2 ** 31 - 1)
            ok = ok & torch.all(in_range | ~row_pad)
            v = v.to(torch.int32)
        return v, valid, None, ok
    v = _fold_float(int_v, frac_v, frac_n)
    v = torch.where(neg, -v, v)
    v = torch.where(valid, v, 0.0)
    if dkey == "float32":
        v = v.to(torch.float32)
    return v, valid, None, ok


_DKEY = {dt.TypeId.INT32: "int32", dt.TypeId.INT64: "int64",
         dt.TypeId.FLOAT32: "float32", dt.TypeId.FLOAT64: "float64",
         dt.TypeId.BOOL: "bool", dt.TypeId.STRING: "string"}


def _upload_raw(a: np.ndarray, bcap: int, dev: torch.device,
                copy_stream) -> torch.Tensor:
    """The file's bytes, zero-padded to ``bcap``, as one uint8 tensor on
    ``dev``.  On the card they are written once into a pinned buffer and
    copied on ``copy_stream`` (a fresh one when None)."""
    from spark_rapids_tpu_torch.columnar import transfer
    if dev.type != "cuda":
        buf = np.zeros(bcap, dtype=np.uint8)
        buf[:a.shape[0]] = a
        return torch.from_numpy(buf)
    stage = transfer.PinnedStage()
    buf = stage.empty((bcap,), np.uint8)
    buf[:a.shape[0]] = a
    buf[a.shape[0]:] = 0
    stream = copy_stream if copy_stream is not None \
        else transfer.CopyStream(dev)
    up = stream.upload(stage, {"raw": buf})
    up.wait()
    return up["raw"]


def decode_csv(path: str, schema: Schema,
               columns: Optional[List[str]] = None, sep: str = ",",
               header: bool = True, device="cuda",
               copy_stream=None) -> Tuple[DeviceBatch, List[str]]:
    """Decode one CSV file to a DeviceBatch on ``device`` (raises
    :class:`UnsupportedCsv` for dialects the device parse does not
    cover: the caller reads the file with Arrow).

    Returns (batch, fallback_columns): columns whose content used
    unsupported numeric syntax are re-read on the host."""
    dev = resolve_device(device)
    wanted = columns or [f.name for f in schema.fields]
    all_names = [f.name for f in schema.fields]
    for f in schema.fields:
        if f.dtype.id not in _DKEY:
            raise UnsupportedCsv(f"dtype {f.dtype.name}")
    with open(path, "rb") as fh:
        raw = fh.read()
    a, n_rows, widths = prescan(raw, len(all_names), sep.encode(), header)
    cap = bucket_rows(max(n_rows, 1))
    bcap = bucket_rows(max(a.shape[0], 64), 64)
    dev_raw = _upload_raw(a, bcap, dev, copy_stream)
    widths_b = [_bucket_strlen(w) for w in widths]
    dkeys = [_DKEY[f.dtype.id] for f in schema.fields]
    parse_cols = [i for i, nme in enumerate(all_names) if nme in wanted]
    outs = decode_columns(dev_raw, n_rows, len(all_names), cap, widths_b,
                          dkeys, ord(sep), parse_cols)
    out_by_idx = dict(zip(parse_cols, outs))

    # one host read for the per-column ok flags
    oks = torch.stack([o[3] for o in outs]).tolist() if outs else []
    fallbacks = [all_names[i] for i, okf in zip(parse_cols, oks)
                 if not okf]
    host_cols = {}
    if fallbacks:
        from spark_rapids_tpu_torch.columnar.batch import from_arrow
        from spark_rapids_tpu_torch.io.readers import _normalize, _read_csv
        fb_schema = Schema([schema.field(n) for n in fallbacks])
        t = _normalize(_read_csv(path, {"header": header, "sep": sep}),
                       fb_schema, permissive=True)
        sub = from_arrow(t, capacity=cap, device=dev,
                         copy_stream=copy_stream)
        host_cols = dict(zip(sub.names, sub.columns))

    cols, names = [], []
    for i, (name, f) in enumerate(zip(all_names, schema.fields)):
        if name not in wanted:
            continue
        o = out_by_idx[i]
        if name in host_cols:
            cols.append(host_cols[name])
        elif f.dtype.is_string:
            cols.append(DeviceColumn(f.dtype, o[0], o[1], o[2]))
        else:
            cols.append(DeviceColumn(f.dtype, o[0], o[1], None))
        names.append(name)
    return DeviceBatch(names, cols, n_rows, dev), fallbacks
