"""Phase 0 of the fused Parquet decode: the dense bit unpack.

Ported from ``spark_rapids_tpu/kernels/decode.py``: ``unpack_bits`` :155,
whose Pallas kernel is ``_unpack_pallas`` :139.  The fused decode
(io/parquet_fused.py) concatenates every bit-packed region of one width
into one byte buffer and unpacks it here, once per width: Parquet packs
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

The per-column stream expansion (``expand_stream``) waits for a later
slice.
"""

from __future__ import annotations

import ctypes

import torch

from spark_rapids_tpu_torch.kernels import backend as kb

SOURCE = "spark_rapids_tpu_torch/csrc/decode.cu"

_UNPACK_BLOCK = 8192      # the reference's base values per grid step


def _unpack_block(ncap: int) -> int:
    """The reference's adaptive phase-0 block."""
    return kb.tpu_block(ncap, _UNPACK_BLOCK)


def _unpack_supported(w: int, ncap: int, nbytes: int) -> bool:
    """The reference's Pallas gate, kept as the CPU fallback count."""
    return (1 <= w <= 32 and ncap % 32 == 0 and
            ncap % min(ncap, _unpack_block(ncap)) == 0 and
            nbytes == ncap * w // 8 and nbytes % 4 == 0)


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def plain_unpack_bits(bytes_arr: torch.Tensor, w: int,
                      ncap: int) -> torch.Tensor:
    """The kernel's function in plain torch (``_unpack_xla``): w == 1
    expands bits, the word path reads 32 values from each w little-endian
    words, the bit path sums bits for shapes off the 32-value grid."""
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
        _lib = lib
    return _lib


def kernel_unpack_bits(bytes_arr: torch.Tensor, w: int,
                       ncap: int) -> torch.Tensor:
    """Launch csrc/decode.cu on a CUDA byte buffer (no fallback: anything
    it does not take raises)."""
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
    src = bytes_arr.contiguous()
    if src.data_ptr() % 4:
        src = src.clone()          # the kernel loads aligned words
    out = torch.empty(ncap, dtype=torch.int32, device=dev)
    err = _kernel_lib().decode_unpack_bits(
        src.data_ptr(), src.shape[0], w, ncap, out.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"unpack_bits: CUDA launch failed with error "
                           f"{err}")
    kb.record_launch("decode.unpack_bits")
    return out


def unpack_bits(bytes_arr: torch.Tensor, w: int, ncap: int) -> torch.Tensor:
    """Dense phase-0 unpack of one width's packed byte buffer
    (uint8 ``[ncap*w/8]``) to ``[ncap]`` 32-bit values, returned as int32
    bit patterns."""
    if bytes_arr.device.type == "cpu":
        if not _unpack_supported(w, ncap, bytes_arr.shape[0]):
            kb.record_fallback("decode.unpack", "shape")
        return plain_unpack_bits(bytes_arr, w, ncap)
    return kernel_unpack_bits(bytes_arr, w, ncap)
