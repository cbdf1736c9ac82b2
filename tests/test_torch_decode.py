"""The port's phase-0 bit unpack against the reference, on the CPU.

The same packed bytes, made with numpy from a seed, go through the
reference's Pallas kernel ``_unpack_pallas`` (interpret mode), its XLA
version ``_unpack_xla`` and the port's ``unpack_bits``, which on a CPU
tensor runs the plain torch version of ``csrc/decode.cu``; the numpy
golden is the one of ``tests/test_kernels.py``.  Integer unpacking is
exact: every value must match bit for bit.

The CUDA kernel itself only runs on a GPU: ``test_cuda_unpack_matches_plain``
is marked ``cuda`` and skips without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.kernels import decode as jdec

from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.kernels import decode as tdec


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


def test_unpack_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tdec.kernel_unpack_bits(torch.zeros(8, dtype=torch.uint8), 2, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 7, 15, 31, 32])
def test_cuda_unpack_matches_plain(w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(w)
    for ncap in (1 << 16, 48):
        raw = torch.from_numpy(
            rng.integers(0, 256, ncap * w // 8).astype(np.uint8)).cuda()
        kb.reset_counts()
        got = tdec.unpack_bits(raw, w, ncap)
        assert kb.launches == {"decode.unpack_bits": 1}
        want = tdec.plain_unpack_bits(raw, w, ncap)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
