"""Segmented reduction kernel: gather + segmented inclusive scan.

Ported from ``spark_rapids_tpu/kernels/segreduce.py`` (the TPU kernel's
two entry points, ``seg_scan_sorted`` :278 and ``gather_seg_scan`` :286,
which reach ``pallas_call`` in ``_run``).  The sorted-key aggregate
computes every grouped reduction as one call of these: the sorted-order
gather of the values feeds a segmented scan that restarts at each group
start, and the aggregate reads the scan at each group's last row.

Routing, by the tensors' device:

  * CUDA tensors launch the hand-written kernel ``csrc/segreduce.cu``
    (built with nvcc for sm_90a on first use, kernels/_build.py) or
    raise — a shape or dtype the kernel does not take is an error, not a
    silent fallback;
  * CPU tensors run the plain torch version of the same function,
    :func:`plain_seg_scan` (a take into sorted order + exec/scans.seg_scan,
    which reproduces the reference's reduction tree).

Which reductions reach the kernel is the caller's business
(:func:`kernel_gate`).  On CPU tensors the aggregate keeps the
reference's gate (``supported``), so it falls back where the reference
falls back to XLA.  On CUDA tensors the gate's capacity limits do not
apply: they are the TPU kernel's (its 2^15-element scan blocks and its
64 MiB VMEM element block), and csrc/segreduce.cu takes any capacity.
There only a 2-D payload takes the plain composition; both choices are
counted as fallbacks with their reason.

Tolerance against the plain version: integers (wrapping) and min/max
exactly; float sums to rounding, because the kernel's reduction tree is
not the reference's ``jax.lax.associative_scan`` tree.  The kernel's own
float sums repeat bit for bit from call to call (its look-back folds tile
prefixes in a fixed order).

The kernel is one launch with a decoupled look-back across tiles.  Its
tile statuses live in a state buffer that this module keeps per device
and stream (:class:`ScanState`), tagged with a per-call epoch so that no
call has to clear it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.exec import scans
from spark_rapids_tpu_torch.kernels import backend as kb

_BLOCK = 1 << 15          # MUST match exec/scans._BLOCK

_OPS = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}

SOURCE = "spark_rapids_tpu_torch/csrc/segreduce.cu"

# element-block ceiling of the reference's non-blocked scan path (bytes):
# part of its `supported` gate, kept so both packages fall back alike
_NARROW_BLOCK_MAX_BYTES = 64 << 20

_SIGN64 = -(1 << 63)


def op_name(op) -> Optional[str]:
    if op is torch.add:
        return "add"
    if op is torch.minimum:
        return "min"
    if op is torch.maximum:
        return "max"
    return None


_NP_OF = {torch.bool: np.dtype(np.bool_), torch.int8: np.dtype(np.int8),
          torch.int16: np.dtype(np.int16), torch.int32: np.dtype(np.int32),
          torch.int64: np.dtype(np.int64), torch.uint8: np.dtype(np.uint8),
          torch.uint64: np.dtype(np.uint64),
          torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64)}
_TORCH_OF = {v: k for k, v in _NP_OF.items()}


def _np_dtype(dtype) -> np.dtype:
    return _NP_OF[dtype] if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype)


def supported(cap: int, dtype, op: Optional[str], ndim: int = 1
              ) -> Tuple[bool, str]:
    """The reference's gate: add/min/max over 1-D payloads of kind
    i/u/f/b, capacities on the 2^15 block grid, narrow out dtypes only up
    to the non-blocked scan's 64 MiB element block."""
    if op is None:
        return False, "op"
    if ndim != 1:
        return False, "ndim"
    dt_ = _np_dtype(dtype)
    if dt_.kind not in "iufb":
        return False, "dtype"
    if not (cap <= _BLOCK or cap % _BLOCK == 0):
        return False, "shape"
    if dt_.itemsize < 8 and cap > _BLOCK and \
            cap * dt_.itemsize > _NARROW_BLOCK_MAX_BYTES:
        return False, "wide_block"
    return True, ""


def kernel_gate(cap: int, dtype, op: Optional[str], ndim: int,
                device: torch.device) -> Tuple[bool, str]:
    """Whether a reduction on ``device`` goes through the wrappers below.
    CPU: the reference's :func:`supported`.  CUDA: every 1-D add/min/max
    of kind i/u/f/b, whatever the capacity; a 2-D payload is (False,
    "ndim"); anything else raises, since no plain path stands in for the
    kernel on the card."""
    if device.type != "cuda":
        return supported(cap, dtype, op, ndim)
    if ndim != 1:
        return False, "ndim"
    if op is None or _np_dtype(dtype).kind not in "iufb":
        raise ValueError(f"segreduce: no kernel for op {op!r} over "
                         f"{dtype}")
    return True, ""


# ---------------------------------------------------------------------------
# the plain torch version
# ---------------------------------------------------------------------------

def plain_seg_scan(new: torch.Tensor, x: torch.Tensor, op_key: str,
                   identity, order: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernel's function in plain torch: ``take`` into sorted order
    (when ``order`` is given), widen to ``out_dtype``, then
    exec/scans.seg_scan.  uint64 values scan as int64 bit patterns, with
    the sign bit flipped around min/max so signed order is unsigned
    order."""
    unsigned = (out_dtype or x.dtype) == torch.uint64
    v = x.view(torch.int64) if x.dtype == torch.uint64 else x
    if order is not None:
        v = v[order.long()]
    if out_dtype is not None and out_dtype != x.dtype:
        v = v.to(torch.int64 if unsigned else out_dtype)
    ident = identity
    if unsigned:
        ident = int(np.array(identity, dtype=np.uint64).view(np.int64))
        if op_key != "add":
            v, ident = v ^ _SIGN64, ident ^ _SIGN64
    s = scans.seg_scan(_OPS[op_key], new, v, ident)
    if unsigned:
        if op_key != "add":
            s = s ^ _SIGN64
        s = s.view(torch.uint64)
    return s


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_CODES = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
          torch.int64: 4, torch.uint8: 5, torch.uint64: 6,
          torch.float32: 7, torch.float64: 8}
# (in, out) pairs the kernel is instantiated for (csrc/segreduce.cu)
KERNEL_TYPES = {
    (torch.int8, torch.int8), (torch.int16, torch.int16),
    (torch.int32, torch.int32), (torch.int64, torch.int64),
    (torch.uint64, torch.uint64), (torch.float32, torch.float32),
    (torch.float64, torch.float64), (torch.bool, torch.int32),
    (torch.int8, torch.int64), (torch.int16, torch.int64),
    (torch.int32, torch.int64), (torch.uint8, torch.uint64),
    (torch.float32, torch.float64)}
_OP_CODES = {"add": 0, "min": 1, "max": 2}

# threads per block and elements per thread of csrc/segreduce.cu (checked
# against the library when it loads)
_THREADS = 256
# the look-back words carry a 30-bit call epoch (csrc/segreduce.cu)
_EPOCH_LIMIT = 1 << 30
# a state's least size in tiles: 256 KiB, enough for capacities up to 2^24
# at any output width, so the aggregate's calls never regrow it
_MIN_TILES = 1 << 13


def tile_elems(out_dtype: torch.dtype) -> int:
    """Elements per tile of the kernel for this output dtype: 16 per
    thread for outputs of up to 4 bytes, 8 for 8-byte outputs."""
    return _THREADS * (16 if out_dtype.itemsize <= 4 else 8)


def state_bytes(tiles: int) -> int:
    """Bytes of a look-back state for ``tiles`` tiles: the tile counter
    (16 B), then four 8-byte words per tile (its prefix and its
    aggregate, one or two words each)."""
    return 16 + 32 * tiles


class ScanState:
    """The look-back state one device and stream share across calls.

    Each call takes a new epoch; the kernel tags every word it writes with
    it, so a word written by an earlier call reads as empty and the buffer is
    never cleared between calls (no memset, no second launch).  The buffer
    is zeroed only when it is (re)allocated: on the first call, when a call
    needs more tiles than it holds (it grows to at least double), or when
    the epochs run out.  Calls on one stream run in order, so they never
    share a live epoch."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.tiles = 0
        self.epoch = 0

    def claim(self, tiles: int, device) -> Tuple[torch.Tensor, int]:
        """(buffer, epoch) for a call over ``tiles`` tiles."""
        if self.buf is None or tiles > self.tiles or \
                self.epoch + 1 >= _EPOCH_LIMIT:
            self.tiles = max(tiles, 2 * self.tiles, _MIN_TILES)
            self.buf = torch.zeros(state_bytes(self.tiles),
                                   dtype=torch.uint8, device=device)
            self.epoch = 0
        self.epoch += 1
        return self.buf, self.epoch


# (device index, stream handle) -> its ScanState
_states: Dict[Tuple[int, int], ScanState] = {}

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from spark_rapids_tpu_torch.kernels import _build
        lib = _build.load("segreduce")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.segreduce_scan.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, ll, vp, vp, vp,
            ll, ctypes.c_ulonglong, vp, ll, ctypes.c_uint, ctypes.c_int, vp]
        lib.segreduce_scan.restype = ctypes.c_int
        lib.segreduce_state_bytes.argtypes = [ll]
        lib.segreduce_state_bytes.restype = ll
        lib.segreduce_tile.argtypes = [ctypes.c_int]
        lib.segreduce_tile.restype = ctypes.c_int
        if [lib.segreduce_tile(t.itemsize) for t in (torch.int32,
                                                     torch.int64)] != \
                [tile_elems(torch.int32), tile_elems(torch.int64)] or \
                lib.segreduce_state_bytes(1000) != state_bytes(1000):
            raise RuntimeError("segreduce: csrc/segreduce.cu and "
                               "kernels/segreduce.py disagree on the tile "
                               "or state layout")
        _lib = lib
    return _lib


def _ident_bits(identity, out_dtype: torch.dtype) -> int:
    """The identity's bit pattern in out_dtype, as the low bytes of a
    uint64."""
    b = np.array(identity).astype(_np_dtype(out_dtype)).tobytes()
    return int.from_bytes(b.ljust(8, b"\0"), "little")


def check_args(new: torch.Tensor, x: torch.Tensor, op_key: str,
               order: Optional[torch.Tensor], out_dtype: torch.dtype,
               name: str = "segreduce") -> None:
    """Raise on what csrc/segreduce.cu does not take, whatever the
    device."""
    cap = new.shape[0]
    if x.device != new.device or (order is not None and
                                  order.device != new.device):
        raise ValueError(f"{name}: tensors on different devices")
    if op_key not in _OP_CODES:
        raise ValueError(f"{name}: op {op_key!r} is not add/min/max")
    if (x.dtype, out_dtype) not in KERNEL_TYPES:
        raise ValueError(f"{name}: no kernel for {x.dtype} -> {out_dtype}")
    if new.dtype != torch.bool or new.dim() != 1 or x.dim() != 1:
        raise ValueError(f"{name}: needs 1-D values and a 1-D bool flag "
                         f"vector")
    if order is not None and (order.dtype != torch.int32 or
                              order.dim() != 1 or order.shape[0] != cap):
        raise ValueError(f"{name}: order must be int32 [{cap}]")
    if order is None and x.shape[0] != cap:
        raise ValueError(f"{name}: sorted values must be [{cap}]")


def kernel_seg_scan(new: torch.Tensor, x: torch.Tensor, op_key: str,
                    identity, order: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    name: str = "segreduce") -> torch.Tensor:
    """Launch csrc/segreduce.cu on CUDA tensors (no fallback: anything
    it does not take raises)."""
    out_dtype = out_dtype or x.dtype
    check_args(new, x, op_key, order, out_dtype, name)
    cap = new.shape[0]
    dev = new.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got "
                         f"{dev}")
    new, x = new.contiguous(), x.contiguous()
    if order is not None:
        order = order.contiguous()
    y = torch.empty(cap, dtype=out_dtype, device=dev)
    lib = _kernel_lib()
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = _states.setdefault((index, stream), ScanState())
    buf, epoch = state.claim(-(-cap // tile_elems(out_dtype)), dev)
    err = lib.segreduce_scan(
        _CODES[x.dtype], _CODES[out_dtype], _OP_CODES[op_key],
        x.data_ptr(), x.shape[0],
        None if order is None else order.data_ptr(), new.data_ptr(),
        y.data_ptr(), cap, _ident_bits(identity, out_dtype),
        buf.data_ptr(), state.tiles, epoch, index, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    kb.record_launch(name)
    return y


def _run(name: str, new, x, op_key, identity, order=None, out_dtype=None):
    if new.device.type == "cpu":
        return plain_seg_scan(new, x, op_key, identity, order, out_dtype)
    return kernel_seg_scan(new, x, op_key, identity, order, out_dtype,
                           name=name)


def seg_scan_sorted(new: torch.Tensor, x_sorted: torch.Tensor,
                    op_key: str, identity) -> torch.Tensor:
    """Inclusive segmented scan over already-sorted values."""
    return _run("segreduce.seg_scan_sorted", new, x_sorted, op_key,
                identity)


def gather_seg_scan(x_masked: torch.Tensor, order: torch.Tensor,
                    new: torch.Tensor, op_key: str, identity,
                    scan_np=None) -> torch.Tensor:
    """Sorted-order gather + segmented scan in one pass: ``x_masked``
    stays in ORIGINAL row space (the caller pre-masks with the op's
    identity) and is read through ``order``; ``scan_np`` (a torch or
    numpy dtype) widens after the gather."""
    out = None
    if scan_np is not None:
        out = scan_np if isinstance(scan_np, torch.dtype) else \
            _TORCH_OF[np.dtype(scan_np)]
    return _run("segreduce.gather_seg_scan", new, x_masked, op_key,
                identity, order, out)

