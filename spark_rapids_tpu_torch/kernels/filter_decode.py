"""Predicated dictionary gathers of the fused Parquet decode.

Ported from ``spark_rapids_tpu/kernels/filter_decode.py``:
``decode_pallas`` :125 and ``decode_str_pallas`` :178.  When a filter is
pushed into the fused scan, dictionary columns the condition does not
read stay codes through definition levels and row-group stitching; once
the condition's mask is known, these gathers decode only the rows that
survive it (dropped rows hold zeros, and the consumer re-applies the same
mask, so nothing downstream sees them):

  * :func:`decode` — ``out[i] = keep[i] ? dbuf[clip(codes[i])] : 0``
    over an int32/int64/float32/float64 dictionary (and the int32
    lengths buffer of a string dictionary);
  * :func:`decode_str` — the string dictionary's bytes, ``out[r, c] =
    keep[r] && c < lw[r] ? dbuf[clip(byte_base[r] + c)] : 0`` into a
    uint8 ``[cap, width]`` matrix.

Routing, by the tensors' device: CUDA tensors launch the hand-written
kernels of ``csrc/filter_decode.cu`` or raise; CPU tensors run the plain
torch versions :func:`plain_decode` (the reference's ``decode_xla``) and
:func:`plain_decode_str` (``str_decode_xla``).

The kernels are bound by the bytes they move (the ``.cu`` note has the
numbers).  ``decode`` gives each lane groups of rows whose outputs fill
one 16-byte store (4 rows of 4-byte elements, 2 of 8-byte ones): keep as
one word and the codes as one vector per group, lanes on neighbouring
groups, several groups' loads in flight before any dictionary gather, no
code read for a group without a kept row.  ``decode_str`` gives each
thread one aligned 16-byte window of the flat ``[cap * width]`` output,
written with one 16-byte store: one division finds the window's first
row, each row's keep, length and byte base are read once, and a row's
bytes come from aligned 16-byte loads where they lie inside the buffer,
else byte by byte with the reference's clip.  Views at any offset and
ragged lengths are handled inside the kernels; each call is one launch.

:func:`supported` and :func:`str_supported` are the reference's gates on
the deferral, with its TPU limits (the element block of ``_block`` and
the 4 MiB VMEM tile budget of ``_str_block``).  The fused scan applies
them only when it decodes into CPU tensors, so the CPU port defers
exactly where the reference does; on the card every capacity and width
goes to the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from spark_rapids_tpu_torch.kernels import backend as kb

SOURCE = "spark_rapids_tpu_torch/csrc/filter_decode.cu"

_BLOCK = 2048
# minimum element block of the reference's 2-D string gather
_STR_MIN_BLOCK = 8
# the reference's default kernel.pallas.tileBytes (its VMEM tile budget)
_TILE_BYTES = 4 << 20


def _block(cap: int) -> int:
    """The reference's adaptive element block of the 1-D gather."""
    return min(cap, kb.tpu_block(cap, _BLOCK))


def _str_block(cap: int, width: int) -> int:
    """The reference's element block of the 2-D string gather: bounded so
    the (B, width) output block and its index planes (~5 bytes per cell)
    fit the tile budget; 0 when not even the minimum block fits."""
    budget = max(_TILE_BYTES // max(width * 5, 1), 1)
    b = _STR_MIN_BLOCK
    while b * 2 <= min(budget, _BLOCK):
        b *= 2
    if b > budget:
        return 0
    return min(cap, b)


def supported(cap: int) -> Tuple[bool, str]:
    """The reference's gate on a deferred int/float dictionary column."""
    B = _block(cap)
    if not (cap <= B or cap % B == 0):
        return False, "shape"
    return True, ""


def str_supported(cap: int, width: int) -> Tuple[bool, str]:
    """The reference's gate on a deferred string dictionary column."""
    B = _str_block(cap, width)
    if B < _STR_MIN_BLOCK:
        return False, "string_layout"
    if not (cap <= B or cap % B == 0):
        return False, "shape"
    return True, ""


# ---------------------------------------------------------------------------
# the plain torch versions
# ---------------------------------------------------------------------------

def plain_decode(dbuf: torch.Tensor, codes: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
    """Unpredicated gather + select (``decode_xla``)."""
    idx = torch.clamp(codes, 0, dbuf.shape[0] - 1).long()
    return torch.where(keep, dbuf[idx],
                       torch.zeros((), dtype=dbuf.dtype, device=dbuf.device))


def plain_decode_str(dbuf: torch.Tensor, byte_base: torch.Tensor,
                     lw: torch.Tensor, keep: torch.Tensor,
                     width: int) -> torch.Tensor:
    """``str_decode_xla``: per (row, byte) cell, the byte at
    ``byte_base + c`` (clipped into ``dbuf``) where the row is kept and
    ``c < lw``, else 0.  Byte offsets are computed in int64."""
    col = torch.arange(width, dtype=torch.int64, device=dbuf.device)[None, :]
    bidx = torch.clamp(byte_base.to(torch.int64)[:, None] + col, 0,
                       dbuf.shape[0] - 1)
    live = keep[:, None] & (col < lw[:, None])
    return torch.where(live, dbuf[bidx],
                       torch.zeros((), dtype=torch.uint8, device=dbuf.device))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from spark_rapids_tpu_torch.kernels import _build
        lib = _build.load("filter_decode")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.filter_decode.argtypes = [ci, vp, ll, vp, vp, ll, vp, ci, vp]
        lib.filter_decode.restype = ci
        lib.filter_decode_str.argtypes = [vp, ll, vp, vp, vp, ll, ci, vp,
                                          ci, vp]
        lib.filter_decode_str.restype = ci
        _lib = lib
    return _lib


_DICT_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)


def _launch_args(dev: torch.device):
    return (dev.index if dev.index is not None
            else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    return dev


def kernel_decode(dbuf: torch.Tensor, codes: torch.Tensor,
                  keep: torch.Tensor) -> torch.Tensor:
    """Launch ``filter_decode`` of csrc/filter_decode.cu (no fallback)."""
    dev = _check_cuda("decode", dbuf, codes, keep)
    cap = codes.shape[0]
    if dbuf.dtype not in _DICT_DTYPES or dbuf.dim() != 1 or \
            dbuf.shape[0] == 0:
        raise ValueError(f"decode: needs a non-empty 1-D dictionary of "
                         f"int32/int64/float32/float64, got {dbuf.dtype} "
                         f"{tuple(dbuf.shape)}")
    if codes.dtype != torch.int32 or keep.dtype != torch.bool or \
            codes.dim() != 1 or tuple(keep.shape) != (cap,):
        raise ValueError(f"decode: needs int32 codes and bool keep of "
                         f"shape [{cap}]")
    dbuf, codes, keep = dbuf.contiguous(), codes.contiguous(), \
        keep.contiguous()
    out = torch.empty(cap, dtype=dbuf.dtype, device=dev)
    err = _kernel_lib().filter_decode(
        dbuf.element_size(), dbuf.data_ptr(), dbuf.shape[0],
        codes.data_ptr(), keep.data_ptr(), cap, out.data_ptr(),
        *_launch_args(dev))
    if err != 0:
        raise RuntimeError(f"decode: CUDA launch failed with error {err}")
    kb.record_launch("filter_decode.decode")
    return out


def kernel_decode_str(dbuf: torch.Tensor, byte_base: torch.Tensor,
                      lw: torch.Tensor, keep: torch.Tensor,
                      width: int) -> torch.Tensor:
    """Launch ``filter_decode_str`` of csrc/filter_decode.cu (no
    fallback)."""
    dev = _check_cuda("decode_str", dbuf, byte_base, lw, keep)
    cap = byte_base.shape[0]
    if dbuf.dtype != torch.uint8 or dbuf.dim() != 1 or dbuf.shape[0] == 0:
        raise ValueError("decode_str: needs a non-empty 1-D uint8 "
                         "dictionary buffer")
    if byte_base.dtype != torch.int32 or lw.dtype != torch.int32 or \
            keep.dtype != torch.bool or byte_base.dim() != 1 or \
            tuple(lw.shape) != (cap,) or tuple(keep.shape) != (cap,):
        raise ValueError(f"decode_str: needs int32 byte_base and lw and "
                         f"bool keep of shape [{cap}]")
    if width < 0:
        raise ValueError(f"decode_str: negative width {width}")
    dbuf, byte_base, lw, keep = (t.contiguous()
                                 for t in (dbuf, byte_base, lw, keep))
    out = torch.empty((cap, width), dtype=torch.uint8, device=dev)
    err = _kernel_lib().filter_decode_str(
        dbuf.data_ptr(), dbuf.shape[0], byte_base.data_ptr(),
        lw.data_ptr(), keep.data_ptr(), cap, width, out.data_ptr(),
        *_launch_args(dev))
    if err != 0:
        raise RuntimeError(f"decode_str: CUDA launch failed with error "
                           f"{err}")
    kb.record_launch("filter_decode.decode_str")
    return out


def decode(dbuf: torch.Tensor, codes: torch.Tensor,
           keep: torch.Tensor) -> torch.Tensor:
    """Predicated dictionary gather: the counterpart of
    ``decode_pallas``."""
    if codes.device.type == "cpu":
        return plain_decode(dbuf, codes, keep)
    return kernel_decode(dbuf, codes, keep)


def decode_str(dbuf: torch.Tensor, byte_base: torch.Tensor,
               lw: torch.Tensor, keep: torch.Tensor,
               width: int) -> torch.Tensor:
    """Predicated string-dictionary byte gather into uint8
    ``[cap, width]``: the counterpart of ``decode_str_pallas``."""
    if byte_base.device.type == "cpu":
        return plain_decode_str(dbuf, byte_base, lw, keep, width)
    return kernel_decode_str(dbuf, byte_base, lw, keep, width)
