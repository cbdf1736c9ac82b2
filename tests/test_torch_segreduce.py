"""The port's segmented-reduction kernel wrapper against the reference.

Both JAX entry points (``seg_scan_sorted``, ``gather_seg_scan``) run as
tests/test_kernels.py runs them — the Pallas kernel in interpret mode on
the CPU — and the port's wrapper runs the same numpy inputs on CPU
tensors, i.e. its plain torch version (take + exec/scans.seg_scan).

Tolerances: integers, uint64 and min/max exactly; float sums to
|diff| <= 1e-12 * (sum of |x| over the segment so far), because a sum
taken in another reduction tree rounds differently.  (The plain torch
version reproduces the reference's tree, so on the CPU the two usually
agree bit for bit; the bound is what the port promises, and what the
CUDA kernel, whose tree differs, is held to.)

The CUDA kernel itself only runs on a GPU: ``test_cuda_kernel_matches_plain``
is marked ``cuda`` and skips without one.  What of its design can be
checked here is: a model of its tile decomposition (local scans per tile,
carries folded forward from the nearest flagged tile) against the plain
version, over the flag layouts that stress the look-back; the look-back
state's sizing and epochs; and the wrapper's argument checks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.exec import scans as jscans
from spark_rapids_tpu.kernels import segreduce as jseg

from spark_rapids_tpu_torch.exec import scans as tscans
from spark_rapids_tpu_torch.kernels import segreduce as tseg

from tests.torch_threads import one_torch_thread  # noqa: F401

# float64 second: its cap-2^16 case is the blocked float add
_DTYPES = [np.int32, np.float64, np.int64, np.uint64]
_OPS = ["add", "min", "max"]
_PATHS = ("sorted", "gather", "gather_widen")
# a narrower source for the widening (scan_np) path of each out dtype
_NARROW = {np.int32: np.bool_, np.int64: np.int32, np.uint64: np.uint8,
           np.float64: np.float32}


def _identity(op, np_t):
    if op == "add":
        return np.zeros((), np_t)[()]
    if np.dtype(np_t).kind == "f":
        return np_t(np.inf if op == "min" else -np.inf)
    info = np.iinfo(np_t)
    return info.max if op == "min" else info.min


def _values(rng, np_t, cap):
    k = np.dtype(np_t).kind
    if k == "b":
        return rng.random(cap) < 0.5
    if k == "f":
        return rng.uniform(-1e6, 1e6, cap).astype(np_t)
    if k == "u":
        hi = 250 if np_t == np.uint8 else 1 << 62
        return (rng.integers(0, hi, cap).astype(np_t) *
                np_t(3 if np_t == np.uint64 else 1))
    return rng.integers(-1000, 1000, cap).astype(np_t)


def _cases():
    # each dtype sees every op and every path (sorted, gather, gather +
    # widening scan) once, across cap 1024 and cap 2^16 (blocked scans
    # for 8-byte values)
    out = []
    for di, np_t in enumerate(_DTYPES):
        for cap, k in ((1024, 0), (1024, 1), (1 << 16, 2)):
            out.append((cap, np_t, _OPS[(di + k) % 3],
                        _PATHS[(di + 2 * k) % 3]))
    return [pytest.param(*c, id=f"{c[0]}-{c[1].__name__}-{c[2]}-{c[3]}")
            for c in out]


def _assert_close(got, want, abs_scan, np_t, op):
    if np.dtype(np_t).kind == "f" and op == "add":
        bound = 1e-12 * abs_scan
        assert np.all(np.abs(got - want) <= bound), \
            np.max(np.abs(got - want))
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("cap,np_t,op,path", _cases())
def test_segreduce_parity(cap, np_t, op, path):
    rng = np.random.default_rng(cap % 97 + len(op))
    flags = np.zeros(cap, bool)
    flags[rng.integers(0, cap, 40)] = True
    flags[0] = True
    ident = _identity(op, np_t)
    src_t = _NARROW[np_t] if path == "gather_widen" else np_t
    vals = _values(rng, src_t, cap)
    order = rng.permutation(cap).astype(np.int32)
    if path == "sorted":
        want = np.asarray(jseg.seg_scan_sorted(
            jnp.asarray(flags), jnp.asarray(vals), op, ident))
        got = tseg.seg_scan_sorted(torch.from_numpy(flags),
                                   torch.from_numpy(vals), op, ident)
        sorted_vals = vals
    else:
        scan_np = np_t if path == "gather_widen" else None
        want = np.asarray(jseg.gather_seg_scan(
            jnp.asarray(vals), jnp.asarray(order), jnp.asarray(flags), op,
            ident, scan_np=scan_np))
        got = tseg.gather_seg_scan(
            torch.from_numpy(vals), torch.from_numpy(order),
            torch.from_numpy(flags), op, ident, scan_np=scan_np)
        sorted_vals = vals[order]
    got = got.numpy()
    assert got.dtype == want.dtype
    # the bound's Σ|x| over the segment so far, from a plain segmented scan
    abs_scan = tscans.seg_scan(
        torch.add, torch.from_numpy(flags),
        torch.from_numpy(np.abs(sorted_vals.astype(np.float64))), 0.0)
    _assert_close(got, want, abs_scan.numpy(), np_t, op)


@pytest.mark.parametrize("cap", [1000, (1 << 15) + 1, 3 * (1 << 15) + 7])
@pytest.mark.parametrize("np_t,op,ident", [
    (np.float64, "add", 0.0), (np.int64, "max", np.iinfo(np.int64).min),
    (np.float32, "min", np.float32(np.inf)), (np.int32, "add", 0)])
def test_seg_scan_matches_reference_tree(cap, np_t, op, ident):
    """exec/scans.seg_scan reproduces the reference's scan tree and block
    structure (2^15 blocks for 8-byte values): on the CPU even float sums
    agree bit for bit."""
    rng = np.random.default_rng(cap)
    flags = rng.random(cap) < 0.01
    vals = _values(rng, np_t, cap)
    ref = jax.jit(lambda f, v: jscans.seg_scan(jseg._OPS[op], f, v, ident))
    want = np.asarray(ref(jnp.asarray(flags), jnp.asarray(vals)))
    got = tscans.seg_scan(tseg._OPS[op], torch.from_numpy(flags),
                          torch.from_numpy(vals), ident).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [7, (1 << 15) + 5])
def test_cumsum_matches_reference(n):
    rng = np.random.default_rng(n)
    ref = jax.jit(jscans.cumsum)
    for vals in (rng.uniform(-1, 1, n), rng.integers(-9, 9, n),
                 rng.integers(-9, 9, n).astype(np.int32)):
        want = np.asarray(ref(jnp.asarray(vals)))
        got = tscans.cumsum(torch.from_numpy(vals)).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


_GATE = [(cap, dtype, op, ndim)
         for cap in (1024, 1 << 15, (1 << 15) + 1024, 1 << 20, 1 << 25)
         for dtype in (np.bool_, np.int32, np.int64, np.uint64, np.float32,
                       np.float64, np.uint8)
         for op, ndim in (("add", 1), ("min", 1), (None, 1), ("max", 2))]


@pytest.mark.parametrize("cap,dtype,op,ndim", _GATE)
def test_supported_gate_matches_reference(cap, dtype, op, ndim):
    assert tseg.supported(cap, dtype, op, ndim) == \
        jseg.supported(cap, dtype, op, ndim)


@pytest.mark.parametrize("cap,dtype,op,ndim,want", [
    (1024, np.int64, "add", 1, (True, "")),
    ((1 << 15) + 1024, np.int64, "min", 1, (True, "")),   # ref: "shape"
    (1 << 25, np.int32, "add", 1, (True, "")),     # ref: "wide_block"
    (1 << 20, np.uint8, "max", 2, (False, "ndim")),
    (1 << 20, np.float64, None, 1, ValueError),
    (1 << 20, np.dtype("U4"), "add", 1, ValueError)])
def test_kernel_gate_on_cuda(cap, dtype, op, ndim, want):
    """On CUDA tensors the reference's capacity limits (TPU scan blocks,
    VMEM) do not apply: every 1-D add/min/max of kind i/u/f/b goes to the
    kernel, a 2-D payload to the plain composition, the rest raises.
    Only the device's type is read, so no GPU is needed here."""
    dev = torch.device("cuda")
    if want is ValueError:
        with pytest.raises(ValueError, match="no kernel"):
            tseg.kernel_gate(cap, dtype, op, ndim, dev)
    else:
        assert tseg.kernel_gate(cap, dtype, op, ndim, dev) == want
    # on the CPU it is the reference's gate
    assert tseg.kernel_gate(cap, dtype, op, ndim, torch.device("cpu")) == \
        jseg.supported(cap, dtype, op, ndim)


def test_op_names():
    assert [tseg.op_name(f) for f in (torch.add, torch.minimum,
                                      torch.maximum, torch.mul)] == \
        ["add", "min", "max", None]


def test_kernel_wrapper_raises_on_cpu_tensors():
    """The kernel path never quietly runs the plain version."""
    flags = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tseg.kernel_seg_scan(flags, torch.arange(8), "add", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ("q6", "sparse", "none", "tile_last",
                                    "one_segment"))
@pytest.mark.parametrize("np_t,op", [(np.float64, "add"), (np.int64, "min"),
                                     (np.int32, "max"), (np.float32, "add")])
def test_cuda_kernel_matches_plain(np_t, op, layout):
    """The kernel against its plain version at 2^20 + 7 rows (not a
    multiple of the tile) over every flag layout; float sums must repeat
    bit for bit over three calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(5)
    cap = (1 << 20) + 7
    tile = tseg.tile_elems(torch.from_numpy(np.zeros(1, np_t)).dtype)
    flags = _flags(layout, cap, tile, rng)
    vals = _values(rng, np_t, cap)
    order = rng.permutation(cap).astype(np.int32)
    ident = _identity(op, np_t)
    f, v, o = (torch.from_numpy(a).cuda() for a in (flags, vals, order))
    got = tseg.gather_seg_scan(v, o, f, op, ident).cpu().numpy()
    want = tseg.plain_seg_scan(f.cpu(), v.cpu(), op, ident,
                               o.cpu()).numpy()
    abs_scan = _abs_scan(flags, vals[order])
    if np_t == np.float32 and op == "add":
        assert np.all(np.abs(got.astype(np.float64) - want) <=
                      1e-5 * abs_scan)
    else:
        _assert_close(got, want, abs_scan, np_t, op)
    if op == "add" and np.dtype(np_t).kind == "f":
        for _ in range(2):
            again = tseg.gather_seg_scan(v, o, f, op, ident).cpu().numpy()
            assert again.tobytes() == got.tobytes()


# ---------------------------------------------------------------------------
# the kernel's tile decomposition (csrc/segreduce.cu), modelled in numpy
# ---------------------------------------------------------------------------

_NP_OPS = {"add": np.add, "min": np.minimum, "max": np.maximum}
_LAYOUTS = ("q6", "sparse", "none", "tile_last", "one_segment")


def _flags(layout, cap, tile, rng):
    """Group starts: q6-like short groups; rare starts with none at row 0;
    no flag at all (row 0 included); a flag only at each tile's last
    element; one segment spanning the capacity (the global aggregate)."""
    f = np.zeros(cap, bool)
    if layout == "q6":
        f = rng.random(cap) < 1 / 60
        f[0] = True
    elif layout == "sparse":
        f = rng.random(cap) < 1 / 2000
        f[0] = False
    elif layout == "tile_last":
        f[tile - 1::tile] = True
    elif layout == "one_segment":
        f[0] = True
    return f


def _tile_model(flags, vals, op, ident, tile, rng):
    """y as the kernel composes it: every tile scans its own elements
    (the plain version on the slice); P_j, the inclusive prefix through
    tile j, is a_j (the tile's aggregate) when tile j holds a flag or is
    tile 0, else P_{j-1} op a_j; rows of tile j before its first flag
    combine with P_{j-1}.  The look-back finds a published prefix P_k
    somewhere between the nearest flagged tile and j-1 and folds the
    aggregates after it forward: the model picks k at random and checks
    that the fold gives P_{j-1} bit for bit."""
    npop = _NP_OPS[op]
    n = vals.shape[0]
    nb = -(-n // tile)
    local, agg, has = [], [], []
    for j in range(nb):
        sl = slice(j * tile, min(n, (j + 1) * tile))
        s = tseg.plain_seg_scan(torch.from_numpy(flags[sl]),
                                torch.from_numpy(vals[sl]), op,
                                ident).numpy()
        local.append(s)
        agg.append(s[-1])
        has.append(bool(flags[sl].any()))
    prefix = []
    for j in range(nb):
        prefix.append(agg[j] if j == 0 or has[j]
                      else npop(prefix[j - 1], agg[j]))
    out = []
    for j in range(nb):
        y = local[j]
        if j > 0 and not flags[j * tile]:
            start = max([i for i in range(j) if has[i]], default=0)
            k = int(rng.integers(start, j))
            carry = prefix[k]
            for i in range(k + 1, j):
                carry = npop(carry, agg[i])
            assert np.asarray(carry).tobytes() == \
                np.asarray(prefix[j - 1]).tobytes()
            before = np.cumsum(flags[j * tile:j * tile + y.shape[0]]) == 0
            y = np.where(before, npop(carry, y), y)
        out.append(y)
    return np.concatenate(out)


def _abs_scan(flags, vals):
    return tscans.seg_scan(
        torch.add, torch.from_numpy(flags),
        torch.from_numpy(np.abs(vals.astype(np.float64))), 0.0).numpy()


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("np_t,op", [
    (np.float64, "add"), (np.float32, "add"), (np.int32, "add"),
    (np.int64, "min"), (np.uint64, "max"), (np.float64, "max")])
def test_tile_model_matches_plain(layout, np_t, op):
    """The decomposition the kernel computes equals the plain scan
    (integers, uint64 and min/max exactly, float sums within 1e-12 x
    sum|x|, float32 within 1e-5 x sum|x|) at random tile sizes and a
    capacity that is not a multiple of the tile."""
    rng = np.random.default_rng(len(layout) * 31 + len(op))
    for tile in (32, int(rng.integers(33, 700)), 4096):
        cap = 3 * tile + int(rng.integers(1, tile))
        flags = _flags(layout, cap, tile, rng)
        vals = _values(rng, np_t, cap)
        ident = _identity(op, np_t)
        want = tseg.plain_seg_scan(torch.from_numpy(flags),
                                   torch.from_numpy(vals), op, ident).numpy()
        got = _tile_model(flags, vals, op, ident, tile, rng)
        assert got.dtype == want.dtype
        if np_t == np.float32 and op == "add":
            assert np.all(np.abs(got.astype(np.float64) - want) <=
                          1e-5 * _abs_scan(flags, vals))
        else:
            _assert_close(got, want, _abs_scan(flags, vals), np_t, op)


@pytest.mark.parametrize("cap", range(1, 8))
def test_tile_model_tiny_capacities(cap):
    """Capacities of 1-7 elements: one partial tile, every layout."""
    rng = np.random.default_rng(cap)
    for layout in _LAYOUTS:
        flags = _flags(layout, cap, 4, rng)
        vals = _values(rng, np.int64, cap)
        want = tseg.plain_seg_scan(torch.from_numpy(flags),
                                   torch.from_numpy(vals), "add", 0).numpy()
        for tile in (1, 2, 4096):
            got = _tile_model(flags, vals, "add", np.int64(0), tile, rng)
            assert np.array_equal(got, want), (layout, tile)


def test_tile_sizes_and_state_layout():
    """The wrapper's mirror of csrc/segreduce.cu: 256 threads x 16
    elements for outputs of up to 4 bytes, x 8 for 8-byte outputs; the
    state is a 16-byte counter, then four 8-byte words per tile (its
    prefix and its aggregate, one word each for outputs of up to 4 bytes,
    two for 8-byte outputs)."""
    for dt, tile in ((torch.int8, 4096), (torch.int16, 4096),
                     (torch.int32, 4096), (torch.float32, 4096),
                     (torch.int64, 2048), (torch.uint64, 2048),
                     (torch.float64, 2048)):
        assert tseg.tile_elems(dt) == tile
    assert tseg.state_bytes(1) == 16 + 32
    assert tseg.state_bytes(5) == 16 + 5 * 32
    # the largest capacity the aggregate uses, at 8-byte outputs
    tiles = -(-(1 << 24) // tseg.tile_elems(torch.float64))
    assert tiles == tseg._MIN_TILES


def test_scan_state_epochs_and_growth():
    """One buffer serves call after call with a new epoch each; it is
    reallocated (zeroed, epochs from 1) only to grow or when the 30-bit
    epochs run out."""
    st = tseg.ScanState()
    buf, e1 = st.claim(64, "cpu")
    assert e1 == 1 and st.tiles == tseg._MIN_TILES
    assert buf.numel() == tseg.state_bytes(st.tiles) and not buf.any()
    buf[:] = 7
    b2, e2 = st.claim(256, "cpu")
    assert b2 is buf and e2 == 2
    b3, e3 = st.claim(st.tiles + 1, "cpu")
    assert b3 is not buf and e3 == 1 and not b3.any()
    assert st.tiles == 2 * tseg._MIN_TILES
    st.epoch = tseg._EPOCH_LIMIT - 2
    b4, e4 = st.claim(1, "cpu")
    assert b4 is b3 and e4 == tseg._EPOCH_LIMIT - 1
    b5, e5 = st.claim(1, "cpu")
    assert b5 is not b3 and e5 == 1


_F8 = torch.ones(8, dtype=torch.bool)


@pytest.mark.parametrize("args,match", [
    ((_F8, torch.arange(8), "mul", None, torch.int64), "add/min/max"),
    ((_F8, torch.arange(8), "add", None, torch.int32), "no kernel"),
    ((_F8, torch.arange(8, dtype=torch.int8), "add", None, torch.int32),
     "no kernel"),
    ((_F8.int(), torch.arange(8), "add", None, torch.int64), "1-D"),
    ((_F8, torch.arange(16).view(2, 8), "add", None, torch.int64), "1-D"),
    ((_F8, torch.arange(9), "add", None, torch.int64), "sorted values"),
    ((_F8, torch.arange(9), "add", torch.arange(8), torch.int64),
     "order must be int32"),
    ((_F8, torch.arange(9), "add", torch.arange(7, dtype=torch.int32),
      torch.int64), "order must be int32")])
def test_kernel_argument_checks(args, match):
    """What the kernel does not take raises before any launch, on any
    device."""
    new, x, op, order, out = args
    with pytest.raises(ValueError, match=match):
        tseg.check_args(new, x, op, order, out)
    with pytest.raises(ValueError, match=match):
        tseg.kernel_seg_scan(new, x, op, 0, order, out)


def test_kernel_argument_checks_pass_on_good_args():
    """A gather from a source longer than the capacity (the ladder's
    rungs) and every instantiated type pair pass the checks."""
    order = torch.arange(8, dtype=torch.int32)
    for tin, tout in tseg.KERNEL_TYPES:
        tseg.check_args(_F8, torch.zeros(32, dtype=tin), "min", order, tout)
