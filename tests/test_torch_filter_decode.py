"""The port's predicated dictionary gathers against the reference, on the
CPU.

The same dictionaries, codes and keep masks, made with numpy from a seed,
go through the reference's Pallas kernels ``decode_pallas`` and
``decode_str_pallas`` (interpret mode) and the port's ``decode`` and
``decode_str``, which on CPU tensors run the plain torch versions of
``csrc/filter_decode.cu``.  The gathers copy data, so every value must
match bit for bit, floats included.  The reference's deferral gates
(``supported``, ``str_supported``) must agree as well.

The CUDA kernels only run on a GPU: the tests marked ``cuda`` skip without
one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_tpu.kernels import backend as jkb
from spark_rapids_tpu.kernels import filter_decode as jfd

from spark_rapids_tpu_torch.kernels import backend as kb
from spark_rapids_tpu_torch.kernels import filter_decode as tfd


def _dict(np_t, n, rng):
    if np.dtype(np_t).kind == "f":
        return rng.normal(scale=1e3, size=n).astype(np_t)
    return rng.integers(-1000, 1000, n).astype(np_t)


def _decode_inputs(np_t, seed):
    rng = np.random.default_rng(seed)
    cap = 4096
    dbuf = _dict(np_t, 512, rng)
    codes = rng.integers(-3, 515, cap).astype(np.int32)   # clipped ends
    keep = rng.random(cap) < 0.25
    keep[1024:2048] = False                               # a dropped block
    return dbuf, codes, keep


@pytest.mark.parametrize("np_t", [np.int32, np.int64, np.float64])
def test_decode_matches_reference(np_t):
    dbuf, codes, keep = _decode_inputs(np_t, 9)
    got = tfd.decode(torch.from_numpy(dbuf), torch.from_numpy(codes),
                     torch.from_numpy(keep)).numpy()
    ref = np.asarray(jfd.decode_pallas(jnp.asarray(dbuf),
                                       jnp.asarray(codes),
                                       jnp.asarray(keep)))
    assert got.dtype == ref.dtype
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))
    assert not got[~keep].any()
    assert np.array_equal(got[keep], dbuf[np.clip(codes, 0, 511)][keep])


def test_decode_str_matches_reference():
    """tests/test_kernel_tiling.py's ragged-tile case, with rows of
    lw = 0 and byte bases that run past the end of the buffer."""
    rng = np.random.default_rng(3)
    cap, n_dict, L = 4096, 700, 12
    mats = rng.integers(65, 91, (n_dict, L)).astype(np.uint8)
    dbuf = mats.reshape(-1)                     # 8400 B: ragged at 4 KiB
    idx = rng.integers(0, n_dict, cap).astype(np.int32)
    bb = idx * L
    bb[:8] = dbuf.shape[0] - 5                  # reads clip at the end
    lw = np.full(cap, L, np.int32)
    lw[8:40] = 0
    keep = rng.random(cap) < 0.3
    keep[:40] = True
    with jkb.tile_bytes_override(4 << 10):
        ref = np.asarray(jfd.decode_str_pallas(
            jnp.asarray(dbuf), jnp.asarray(bb), jnp.asarray(lw),
            jnp.asarray(keep), 16))
    got = tfd.decode_str(torch.from_numpy(dbuf), torch.from_numpy(bb),
                         torch.from_numpy(lw), torch.from_numpy(keep),
                         16).numpy()
    assert got.dtype == np.uint8 and got.shape == (cap, 16)
    assert np.array_equal(got, ref)
    assert not got[~keep].any() and not got[8:40].any()
    live = keep.copy()
    live[:40] = False
    assert np.array_equal(got[live][:, :L], mats[idx[live]])
    assert np.array_equal(got[:8, :L], np.broadcast_to(
        np.concatenate([dbuf[-5:], np.repeat(dbuf[-1:], L - 5)]), (8, L)))


@pytest.mark.parametrize("cap", [16, 2048, 4096, 1 << 20, 3 << 12])
@pytest.mark.parametrize("width", [1, 16, 64, 4096, 200_000])
def test_deferral_gates_match_reference(cap, width):
    assert tfd.supported(cap) == jfd.supported(cap)
    assert tfd.str_supported(cap, width) == jfd.str_supported(cap, width)


def test_kernels_refuse_cpu_tensors():
    z = torch.zeros(8, dtype=torch.int32)
    k = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.kernel_decode(z, z, k)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.kernel_decode_str(torch.zeros(8, dtype=torch.uint8), z, z, k, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("np_t", [np.int32, np.int64, np.float32,
                                  np.float64])
def test_cuda_decode_matches_plain(np_t):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dbuf, codes, keep = (torch.from_numpy(a).cuda()
                         for a in _decode_inputs(np_t, 11))
    kb.reset_counts()
    got = tfd.decode(dbuf, codes, keep)
    assert kb.launches == {"filter_decode.decode": 1}
    want = tfd.plain_decode(dbuf, codes, keep)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 16, 256])
def test_cuda_decode_str_matches_plain(width):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rng = np.random.default_rng(width)
    cap = 1 << 14
    dbuf = torch.from_numpy(rng.integers(0, 256, 5000).astype(np.uint8))
    bb = torch.from_numpy(rng.integers(-8, 5000, cap).astype(np.int32))
    lw = torch.from_numpy(rng.integers(0, width + 1, cap).astype(np.int32))
    keep = torch.from_numpy(rng.random(cap) < 0.5)
    dbuf, bb, lw, keep = (t.cuda() for t in (dbuf, bb, lw, keep))
    kb.reset_counts()
    got = tfd.decode_str(dbuf, bb, lw, keep, width)
    assert kb.launches == {"filter_decode.decode_str": 1}
    want = tfd.plain_decode_str(dbuf, bb, lw, keep, width)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
