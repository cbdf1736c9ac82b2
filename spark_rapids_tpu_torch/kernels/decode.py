"""The Parquet stream kernels: the dense bit unpack and the run expansion.

Ported from ``spark_rapids_tpu/kernels/decode.py``.

``unpack_bits`` (reference :155, Pallas kernel ``_unpack_pallas`` :139)
is phase 0 of every decode.  The fused decode
(io/parquet_fused.py) concatenates every bit-packed region of one width
into one byte buffer and unpacks it here, once per width, in place into
that width's slice of one dense value array (``out=``): Parquet packs
LSB-first, so the value j of each group of 32 is word ``(j*w) >> 5`` at
shift ``(j*w) & 31``, spilling into the next word.

Routing, by the tensor's device:

  * a CUDA tensor launches the hand-written kernel ``csrc/decode.cu``
    (built with nvcc for sm_90a on first use, kernels/_build.py) or
    raises;
  * a CPU tensor runs :func:`plain_unpack_bits`, the counterpart of the
    reference's ``_unpack_xla`` :73 with its three branches.  The
    reference's gate ``_unpack_supported`` decides there whether the
    call counts as a ``decode.unpack`` fallback, as the reference counts
    its XLA fallbacks; the result is the same either way.

Values are unsigned 32-bit, returned in an ``int32`` tensor as bit
patterns (torch's uint32 has few ops); callers cast them to int32 as the
reference does.  Integer-exact on both routes.

``expand_stream`` (reference :336, Pallas kernel ``_expand_pallas`` :215)
expands one hybrid RLE / bit-packed stream of the per-column decode
(io/device_parquet.decode_plan) to ``[cap]`` values in one launch.  The
host turns the stream's runs into per-run (start, dA, dC) deltas
(:func:`_dense_meta`, held against the reference's) and then into
absolute (start, A, C) rows (:func:`run_table`, one cumsum); the table
and the packed bytes are the two uploads.  The kernel reads, for element
i, the row of the last start <= i: the RLE value where C is odd, else the
w bits of dense value ``clip(A + i)`` straight from the packed bytes.
What the reference computes in three phases (``_expand_impl`` :310: the
dense unpack, the step functions A and C by a delta scatter plus a
cumsum, the gather) has no intermediate array here: no step function and
no dense array is materialised on the card.  On a CPU tensor
:func:`plain_expand_device` runs those three phases in plain torch
(:func:`plain_unpack_bits`, :func:`step_functions`, :func:`plain_expand`).

A stream whose bit-packed runs mix widths (``stream_width``) has no single
dense array: as in the reference, it takes the window-gather composition
``io/device_parquet.expand_runs_matrix`` on either device and counts a
``decode.expand.mixed_widths`` fallback; that composition stops at 24-bit
widths and raises ``UnsupportedChunk`` past them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.kernels import backend as kb

SOURCE = "spark_rapids_tpu_torch/csrc/decode.cu"

_UNPACK_BLOCK = 8192      # the reference's base values per grid step
_EXPAND_BLOCK = 8192      # the reference's base elements per grid step


def _unpack_block(ncap: int) -> int:
    """The reference's adaptive phase-0 block."""
    return kb.tpu_block(ncap, _UNPACK_BLOCK)


def _unpack_supported(w: int, ncap: int, nbytes: int) -> bool:
    """The reference's Pallas gate, kept as the CPU fallback count."""
    return (1 <= w <= 32 and ncap % 32 == 0 and
            ncap % min(ncap, _unpack_block(ncap)) == 0 and
            nbytes == ncap * w // 8 and nbytes % 4 == 0)


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits
    (the reference's uint32, as a bit pattern)."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _check_out(out: torch.Tensor, ncap: int, dev) -> None:
    if out.device != dev or out.dtype != torch.int32 or out.dim() != 1 or \
            out.shape[0] != ncap or not out.is_contiguous():
        raise ValueError(f"unpack_bits: out must be a contiguous 1-D int32 "
                         f"tensor of {ncap} values on {dev}")


def plain_unpack_bits(bytes_arr: torch.Tensor, w: int, ncap: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain torch (``_unpack_xla``): w == 1
    expands bits, the word path reads 32 values from each w little-endian
    words, the bit path sums bits for shapes off the 32-value grid.  With
    ``out`` the values are written into it (a slice of a larger array)."""
    vals = _plain_unpack(bytes_arr, w, ncap)
    if out is None:
        return vals
    _check_out(out, ncap, bytes_arr.device)
    out.copy_(vals)
    return out


def _plain_unpack(bytes_arr: torch.Tensor, w: int, ncap: int) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=bytes_arr.device)
    if w == 1:
        bits = (bytes_arr[:, None] >> shifts) & 1
        return bits.reshape(-1).to(torch.int32)
    if ncap % 32 == 0 and bytes_arr.shape[0] % 4 == 0:
        words = (bytes_arr.reshape(-1, 4).to(torch.int64) <<
                 torch.arange(0, 32, 8, device=bytes_arr.device)).sum(1)
        W = words.reshape(ncap // 32, w)
        mask = (1 << w) - 1
        outs = []
        for j in range(32):
            a, s = (j * w) >> 5, (j * w) & 31
            v = W[:, a] >> s
            if s + w > 32:
                v = v | ((W[:, a + 1] << (32 - s)) & 0xFFFFFFFF)
            outs.append(v & mask)
        return _as_int32(torch.stack(outs, dim=1).reshape(-1))
    bits = (bytes_arr[:, None] >> shifts) & 1
    vals = bits.reshape(ncap, w).to(torch.int64)
    return _as_int32((vals << torch.arange(
        w, device=bytes_arr.device)).sum(1))


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from spark_rapids_tpu_torch.kernels import _build
        lib = _build.load("decode")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.decode_unpack_bits.argtypes = [vp, ll, ctypes.c_int, ll, vp,
                                           ctypes.c_int, vp]
        lib.decode_unpack_bits.restype = ctypes.c_int
        lib.decode_expand.argtypes = [vp, ctypes.c_int, ll, vp, ll,
                                      ctypes.c_int, ll, ll, vp, ctypes.c_int,
                                      vp]
        lib.decode_expand.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_unpack_bits(bytes_arr: torch.Tensor, w: int, ncap: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/decode.cu on a CUDA byte buffer, into ``out`` when
    given (no fallback: anything it does not take raises)."""
    dev = bytes_arr.device
    if dev.type != "cuda":
        raise ValueError(f"unpack_bits: the kernel needs a CUDA tensor, "
                         f"got {dev}")
    if bytes_arr.dtype != torch.uint8 or bytes_arr.dim() != 1:
        raise ValueError("unpack_bits: needs a 1-D uint8 buffer")
    if not 1 <= w <= 32:
        raise ValueError(f"unpack_bits: width {w} is not in 1..32")
    if ncap * w % 8 or bytes_arr.shape[0] != ncap * w // 8:
        raise ValueError(f"unpack_bits: {bytes_arr.shape[0]} bytes do not "
                         f"hold {ncap} values of {w} bits")
    if out is None:
        out = torch.empty(ncap, dtype=torch.int32, device=dev)
    else:
        _check_out(out, ncap, dev)
    src = _aligned(bytes_arr)
    err = _kernel_lib().decode_unpack_bits(
        src.data_ptr(), src.shape[0], w, ncap, out.data_ptr(),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"unpack_bits: CUDA launch failed with error "
                           f"{err}")
    kb.record_launch("decode.unpack_bits")
    return out


def _aligned(bytes_arr: torch.Tensor) -> torch.Tensor:
    """The buffer, contiguous and 4-byte aligned (the kernels load words)."""
    src = bytes_arr.contiguous()
    return src.clone() if src.data_ptr() % 4 else src


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


def unpack_bits(bytes_arr: torch.Tensor, w: int, ncap: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense phase-0 unpack of one width's packed byte buffer
    (uint8 ``[ncap*w/8]``) to ``[ncap]`` 32-bit values, returned as int32
    bit patterns; with ``out`` (a contiguous int32 slice of ncap values)
    they are written into it in place."""
    if bytes_arr.device.type == "cpu":
        if not _unpack_supported(w, ncap, bytes_arr.shape[0]):
            kb.record_fallback("decode.unpack", "shape")
        return plain_unpack_bits(bytes_arr, w, ncap, out)
    return kernel_unpack_bits(bytes_arr, w, ncap, out)


# ---------------------------------------------------------------------------
# run expansion
# ---------------------------------------------------------------------------

def stream_width(runs) -> Tuple[bool, int, str]:
    """(supported, width, reason): a stream expands through one dense
    array when its bit-packed runs share one nonzero width <= 32.

    Width-0 bit-packed runs (a page written against a one-entry
    dictionary) hold zero packed bytes and decode to 0, so they do not
    constrain the width: :func:`_dense_meta` rewrites them as RLE-0 runs
    (mapping one through ``bit_base // w`` would alias the next run's
    values).  The reference walks the runs in order and stops at the
    first width that differs from the one before it or passes 32; over
    the table's arrays that is the first width's test, then whether any
    other differs from it."""
    ws = runs.widths[~runs.is_rle & (runs.widths != 0)]
    if ws.size == 0:
        return True, 0, ""
    w = int(ws[0])
    if w > 32:
        return False, 0, "width"
    if (ws != w).any():
        return False, 0, "mixed_widths"
    return True, w, ""


def _dense_meta(runs, w: int, rcap: int) -> np.ndarray:
    """Per-run (start, dA, dC) deltas, ``[rcap, 3]``: the coefficients
    phase 1 scatters, from the run table's arrays.  Starts are a cumsum
    of the counts; A (dense index of the run's first value minus its
    start) is set by the bit-packed runs of nonzero width and carried
    forward through RLE and width-0 runs, so the deltas (``np.diff`` of A
    and C) telescope.  The matrix widens to int64 when a wide RLE payload
    overflows int32 deltas; padding rows start at 2^30 and drop."""
    n = runs.counts.shape[0]
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(runs.counts[:-1], out=starts[1:])
    sets_a = ~runs.is_rle & (runs.widths != 0)
    a_own = (runs.bit_bases // w if w else 0) - starts
    last = np.maximum.accumulate(np.where(sets_a, np.arange(n), -1))
    a = np.where(last >= 0, a_own[np.maximum(last, 0)], 0)
    # RLE: value * 2 + 1; width-0 bit-pack: every value 0, an RLE-0 run
    c = np.where(runs.is_rle, (runs.values << 1) | 1,
                 np.where(sets_a, 0, 1))
    da = np.diff(a, prepend=0)
    dc = np.diff(c, prepend=0)
    lo = min(0, int(da.min(initial=0)), int(dc.min(initial=0)))
    hi = max(0, int(da.max(initial=0)), int(dc.max(initial=0)))
    np_t = np.int32 if -(1 << 31) <= lo and hi < (1 << 31) else np.int64
    mat = np.zeros((rcap, 3), dtype=np_t)
    mat[n:, 0] = np_t(1 << 30)
    mat[:n, 0] = starts
    mat[:n, 1] = da
    mat[:n, 2] = dc
    return mat


def _dense_extent(runs, w: int) -> int:
    """Values the dense array must hold: at least the stream's bit-packed
    values, and past the end of its last bit-packed run.  A page's last
    bit-packed run is trimmed to the page's value count, but its packed
    padding stays, so later runs start past the trimmed count.  (The
    reference sizes the array from the count alone and, where the padding
    carries the last run past the capacity tier, reads clipped values
    there: ROADMAP Queue C.)"""
    bp = ~runs.is_rle
    nvals = int(runs.counts[bp].sum())
    if not w:
        return nvals
    m = bp & (runs.widths != 0)
    end = int((runs.bit_bases[m] // w + runs.counts[m]).max(initial=0))
    return max(nvals, end)


def _expand_supported(w: int, ncap: int, cap: int) -> bool:
    """The reference's Pallas gates past ``stream_width``, kept as the
    CPU fallback count: the unpack's grid and the expand grid's block."""
    if w and not _unpack_supported(w, ncap, ncap * w // 8):
        return False
    return cap % kb.tpu_block(cap, _EXPAND_BLOCK) == 0


def run_table(mat: np.ndarray) -> np.ndarray:
    """The run matrix's (start, dA, dC) deltas as absolute (start, A, C)
    rows, the table the expand kernel searches: one cumsum down the rows.
    The table keeps the matrix's dtype unless a running sum leaves it: an
    int32 matrix whose A or C sums leave int32 (an RLE value of 2^30 or
    more after a smaller one, whose deltas still fit) gets an int64
    table, so the sums hold the golden values where the reference's int32
    cumsum wraps (ROADMAP Queue C).  A row holds A and C from its start
    on; rows with one start leave the last of them in force, as the summed
    deltas do; padding rows start past every element."""
    sums = np.cumsum(mat[:, 1:], axis=0, dtype=np.int64)
    np_t = mat.dtype
    if np_t != np.int64 and sums.size and \
            (sums.min() < -(1 << 31) or sums.max() >= (1 << 31)):
        np_t = np.int64
    table = mat.astype(np_t)
    table[:, 1:] = sums
    return table


def table_deltas(table: torch.Tensor) -> torch.Tensor:
    """:func:`run_table` undone on the table's device: per-row deltas
    (wrapping in the dtype), the run matrix :func:`step_functions` takes."""
    mat = table.clone()
    mat[1:, 1:] -= table[:-1, 1:]
    return mat


def step_functions(mat: torch.Tensor, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step functions A and C over ``[cap]`` elements, in the run
    matrix's dtype, from its (start, dA, dC) rows.  Deltas at one start
    add; starts at or past ``cap`` (padding rows) land in slot cap of a
    cap+1 buffer and drop.  The cumsum keeps the dtype (and wraps like the
    reference's)."""
    starts = torch.clamp(mat[:, 0], max=cap).long()

    def step(delta: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros(cap + 1, dtype=mat.dtype, device=mat.device)
        acc.index_add_(0, starts, delta.contiguous())
        return torch.cumsum(acc[:cap], 0, dtype=mat.dtype)

    return step(mat[:, 1]), step(mat[:, 2])


def plain_expand(dense: torch.Tensor, a: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """The expansion's last phase in plain torch: the RLE value where C is
    odd, else ``dense[clip(A + i, 0, dlen - 1)]``; int32 bit patterns of
    the reference's uint32."""
    i = torch.arange(a.shape[0], dtype=a.dtype, device=a.device)
    idx = torch.clamp(a + i, 0, dense.shape[0] - 1)
    v = c >> 1
    if v.dtype == torch.int64:
        v = _as_int32(v & 0xFFFFFFFF)
    return torch.where((c & 1) != 0, v, dense[idx.long()])


def plain_expand_device(table: torch.Tensor, packed: torch.Tensor, w: int,
                        ncap: int, cap: int) -> torch.Tensor:
    """The expand kernel's function in plain torch, as the reference's
    ``_expand_impl`` computes it: the dense unpack, the step functions
    from the table's deltas, the gather."""
    if w:
        dense = plain_unpack_bits(packed, w, ncap)
    else:
        # no bit-packed width (single-entry dictionary, all-RLE levels):
        # every bit-packed value is 0
        dense = torch.zeros(32, dtype=torch.int32, device=table.device)
    a, c = step_functions(table_deltas(table), cap)
    return plain_expand(dense, a, c)


def kernel_expand(table: torch.Tensor, packed: torch.Tensor, w: int,
                  ncap: int, cap: int) -> torch.Tensor:
    """Launch the expand kernel of csrc/decode.cu: one launch for the
    whole stream (no fallback: anything it does not take raises)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"expand: the kernel needs CUDA tensors, got {dev}")
    if packed.device != dev:
        raise ValueError("expand: the table and the packed bytes must share "
                         "one device")
    if table.dtype not in (torch.int32, torch.int64) or table.dim() != 2 \
            or table.shape[1] != 3:
        raise ValueError(f"expand: the run table must be [rows, 3] int32 or "
                         f"int64, got {tuple(table.shape)} {table.dtype}")
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise ValueError("expand: the packed bytes must be a 1-D uint8 "
                         "tensor")
    if not 0 <= w <= 32:
        raise ValueError(f"expand: width {w} is not in 0..32")
    if w and (ncap <= 0 or packed.shape[0] * 8 < ncap * w):
        raise ValueError(f"expand: {packed.shape[0]} packed bytes do not "
                         f"hold {ncap} values of {w} bits")
    table, src = table.contiguous(), _aligned(packed)
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    err = _kernel_lib().decode_expand(
        table.data_ptr(), table.element_size(), table.shape[0],
        src.data_ptr(), src.shape[0], w, ncap if w else 32, cap,
        out.data_ptr(), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"expand: CUDA launch failed with error {err}")
    kb.record_launch("decode.expand_stream")
    return out


def expand_device(table: torch.Tensor, packed: torch.Tensor, w: int,
                  ncap: int, cap: int) -> torch.Tensor:
    """The device half of one stream's expansion, on the tensors' device:
    the kernel on CUDA, its plain version on the CPU."""
    if table.device.type == "cpu":
        return plain_expand_device(table, packed, w, ncap, cap)
    return kernel_expand(table, packed, w, ncap, cap)


def stream_prep(runs, packed: bytes, cap: int, dev: torch.device):
    """The host half of :func:`expand_stream`: ``(width, ncap, arrays)``
    for the kernel route, whose arrays are the run table and the packed
    bytes, or ``(None, None, arrays)`` for the window-gather composition
    (``io/device_parquet.expand_runs_matrix``), whose arrays are its run
    matrix and bytes.  The route is chosen (and a fallback counted)
    here."""
    from spark_rapids_tpu_torch.columnar.batch import bucket_rows
    from spark_rapids_tpu_torch.io import device_parquet as dp
    ok, w, reason = stream_width(runs)
    if kb.choose("decode.expand", ok, reason) == kb.XLA:
        return None, None, dp.expand_runs_arrays(runs, packed)
    ncap = bucket_rows(max(_dense_extent(runs, w), 1), 32)
    if dev.type == "cpu" and not _expand_supported(w, ncap, cap):
        kb.record_fallback("decode.expand", "shape")
    rcap = bucket_rows(max(runs.counts.shape[0], 1), 8)
    table = run_table(_dense_meta(runs, w, rcap))
    pbytes = np.zeros(max(ncap * w // 8, 4), dtype=np.uint8)
    src = np.frombuffer(packed, dtype=np.uint8)[:pbytes.shape[0]]
    pbytes[:src.shape[0]] = src
    return w, ncap, {"table": table, "packed": pbytes}


def stream_expand(prep, tensors, cap: int) -> torch.Tensor:
    """The device half of :func:`expand_stream`, from :func:`stream_prep`'s
    result and its arrays uploaded under the same keys."""
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    from spark_rapids_tpu_torch.io import device_parquet as dp
    w, ncap, _ = prep
    if w is None:
        return dp.expand_runs_matrix(tensors["runs_mat"], tensors["packed"],
                                     cap)
    table = tensors["table"]
    # the reference's key; its interpret flag and tile plan have no
    # counterpart (None)
    kern = kc.get_kernel(
        ("decode_expand", kb.PALLAS, w, int(table.shape[0]), ncap, cap,
         str(table.dtype).replace("torch.", ""), None, None, None),
        lambda: functools.partial(expand_device, w=w, ncap=ncap, cap=cap),
        backend=kb.PALLAS)
    return kern(table, tensors["packed"])


def expand_stream(runs, packed: bytes, cap: int,
                  device="cuda") -> torch.Tensor:
    """Expand one hybrid RLE / bit-packed stream to ``[cap]`` values on
    ``device`` (int32 bit patterns of the reference's uint32): the run
    table and the packed bytes are the two uploads."""
    dev = torch.device(device)
    prep = stream_prep(runs, packed, cap, dev)
    return stream_expand(prep, {k: torch.from_numpy(a).to(dev)
                                for k, a in prep[2].items()}, cap)
