"""The port's phase-0 bit unpack against the reference, on the CPU.

The same packed bytes, made with numpy from a seed, go through the
reference's Pallas kernel ``_unpack_pallas`` (interpret mode), its XLA
version ``_unpack_xla`` and the port's ``unpack_bits``, which on a CPU
tensor runs the plain torch version of ``csrc/decode.cu``; the numpy
golden is the one of ``tests/test_kernels.py``.  Integer unpacking is
exact: every value must match bit for bit.

``unpack_bits(..., out=)`` writes into a slice of a larger array, and a
Python model of the kernel's chunking is held against the plain version
on ragged shapes.  The CUDA kernel itself only runs on a GPU:
``test_cuda_unpack_matches_plain`` is marked ``cuda`` and skips without
one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.kernels import decode as jdec

from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.kernels import decode as tdec

from tests.torch_threads import one_torch_thread  # noqa: F401


def _golden(raw: np.ndarray, w: int, ncap: int) -> np.ndarray:
    bits = np.unpackbits(raw, bitorder="little")[:ncap * w]
    return (bits.reshape(ncap, w).astype(np.uint64) <<
            np.arange(w, dtype=np.uint64)).sum(axis=1)


@pytest.mark.parametrize("w", range(1, 33))
def test_unpack_bits_matches_reference(w):
    rng = np.random.default_rng(w)
    ncap = 2048
    raw = rng.integers(0, 256, ncap * w // 8).astype(np.uint8)
    kb.reset_counts()
    got = tdec.unpack_bits(torch.from_numpy(raw), w, ncap)
    assert got.dtype == torch.int32 and tuple(got.shape) == (ncap,)
    assert not kb.fallbacks          # on the reference's Pallas grid
    got = got.numpy().view(np.uint32)
    ref = np.asarray(jdec._unpack_pallas(jnp.asarray(raw), w, ncap))
    assert np.array_equal(got, ref)
    assert np.array_equal(got.astype(np.uint64), _golden(raw, w, ncap))


@pytest.mark.parametrize("w,ncap", [(3, 16), (7, 16), (15, 48), (32, 24)])
def test_unpack_bits_off_the_grid_matches_reference(w, ncap):
    """Shapes off the 32-value grid take the reference's bit path and
    count as a ``decode.unpack`` fallback, as in the reference."""
    rng = np.random.default_rng(100 + w)
    raw = rng.integers(0, 256, ncap * w // 8).astype(np.uint8)
    assert not tdec._unpack_supported(w, ncap, raw.shape[0])
    assert tdec._unpack_supported(w, ncap, raw.shape[0]) == \
        jdec._unpack_supported(w, ncap, raw.shape[0])
    kb.reset_counts()
    got = tdec.unpack_bits(torch.from_numpy(raw), w, ncap).numpy()
    assert kb.fallbacks == {"decode.unpack.shape": 1}
    ref = np.asarray(jdec._unpack_xla(jnp.asarray(raw), w, ncap))
    assert np.array_equal(got.view(np.uint32), ref)
    assert np.array_equal(got.view(np.uint32).astype(np.uint64),
                          _golden(raw, w, ncap))


@pytest.mark.parametrize("w,ncap", [(5, 1 << 20), (32, 1 << 18),
                                    (9, 1 << 22)])
def test_unpack_gate_matches_reference(w, ncap):
    assert tdec._unpack_block(ncap) == jdec._unpack_block(ncap)
    for nbytes in (ncap * w // 8, ncap * w // 8 + 4):
        assert tdec._unpack_supported(w, ncap, nbytes) == \
            jdec._unpack_supported(w, ncap, nbytes)


@pytest.mark.parametrize("w,ncap", [(1, 64), (7, 2048), (15, 48),
                                    (32, 24)])
def test_unpack_bits_out_writes_only_its_slice(w, ncap):
    """With ``out`` the values land in that slice of a larger array, the
    rest of which stays as it was."""
    rng = np.random.default_rng(400 + w)
    raw = torch.from_numpy(rng.integers(0, 256, ncap * w // 8)
                           .astype(np.uint8))
    whole = torch.full((ncap + 37,), -7, dtype=torch.int32)
    dst = whole[13:13 + ncap]
    got = tdec.unpack_bits(raw, w, ncap, out=dst)
    assert got.data_ptr() == dst.data_ptr()
    assert torch.equal(dst, tdec.plain_unpack_bits(raw, w, ncap))
    assert (whole[:13] == -7).all() and (whole[13 + ncap:] == -7).all()
    with pytest.raises(ValueError, match="out"):
        tdec.unpack_bits(raw, w, ncap, out=whole[:ncap + 1])


def _unpack_model(raw: np.ndarray, w: int, ncap: int,
                  vals: int = 4096) -> np.ndarray:
    """csrc/decode.cu's unpack kernel, block by block, in Python: a block
    stages its chunk of vals*w/8 bytes (zeros past the buffer), then
    extracts groups of 4 values and writes those below ncap."""
    out = np.zeros(ncap, np.uint32)
    mask = (1 << w) - 1
    for v0 in range(0, ncap, vals):
        b0, chunk = v0 // 8 * w, vals // 8 * w
        staged = raw[b0:b0 + chunk].tobytes()
        words = np.frombuffer(staged + bytes(chunk - len(staged)), "<u4")
        for e in range(v0, min(v0 + vals, ncap), 4):
            for i in range(e, min(e + 4, ncap)):
                bit = (i - v0) * w
                a, s = bit >> 5, bit & 31
                x = int(words[a]) >> s
                if s + w > 32:
                    x |= int(words[a + 1]) << (32 - s)
                out[i] = x & mask
    return out


@pytest.mark.parametrize("w,ncap", [(3, 40), (7, 4104), (13, 8),
                                    (32, 4100), (5, 8192)])
def test_unpack_kernel_model_matches_plain(w, ncap):
    """The unpack kernel's chunking, with ragged last chunks, against the
    plain version."""
    rng = np.random.default_rng(500 + w)
    raw = rng.integers(0, 256, ncap * w // 8).astype(np.uint8)
    want = tdec.plain_unpack_bits(torch.from_numpy(raw), w, ncap)
    np.testing.assert_array_equal(_unpack_model(raw, w, ncap),
                                  want.numpy().view(np.uint32))


def test_unpack_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tdec.kernel_unpack_bits(torch.zeros(8, dtype=torch.uint8), 2, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 7, 15, 31, 32])
def test_cuda_unpack_matches_plain(w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(w)
    for ncap in (1 << 16, 48, 4096 + 40):
        raw = torch.from_numpy(
            rng.integers(0, 256, ncap * w // 8).astype(np.uint8)).cuda()
        kb.reset_counts()
        got = tdec.unpack_bits(raw, w, ncap)
        assert kb.launches == {"decode.unpack_bits": 1}
        want = tdec.plain_unpack_bits(raw, w, ncap)
        whole = torch.full((ncap + 9,), -7, dtype=torch.int32,
                           device="cuda")
        tdec.unpack_bits(raw, w, ncap, out=whole[5:5 + ncap])
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(whole[5:5 + ncap], want)
        assert (whole[:5] == -7).all() and (whole[5 + ncap:] == -7).all()
