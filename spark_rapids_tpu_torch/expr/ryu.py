"""Device float -> string: the exact shortest round-trip decimal (Ryu).

Ported from ``spark_rapids_tpu/expr/ryu.py``.  The engine's cast
float -> string is Python's ``repr`` (the shortest decimal that parses
back to the same double; the CPU oracle is ``repr(float(x))``).  This is
the Ryu algorithm (Adams, PLDI 2018) over every row at once.

The reference holds its state in ``uint64``.  torch has no unsigned
64-bit arithmetic, so each 64-bit word here is a pair ``(hi, lo)`` of
32-bit halves, each held unsigned in int64, as the murmur3 hash holds its
words (``expr/eval_tpu.py``):

  * 32 x 32 -> 64 products are taken in 16-bit limbs, so no intermediate
    leaves int64's positive range (nothing relies on signed overflow);
    ``_umul128`` combines four of them into a 128-bit product;
  * unsigned ``<`` and ``<=`` compare the halves;
  * divisions by 5 and 10 are exact integer divisions of the high half,
    then of ``remainder << 32 | low half`` (below 2^36): the same
    quotients as the reference's multiply-high constants;
  * the 5^q / 5^-q tables (``_INV_TAB``, ``_POW_TAB``) and the modular
    inverses of 5^p are split into halves once per device;
  * the two 18-step ``fori_loop``s and the digit extraction are Python
    loops over whole-column operations.

Output is the engine's device string layout: (bytes [n, 32] u8,
lengths i32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_MANT_BITS = 52
_BIAS = 1023
_POW5_INV_BITCOUNT = 125
_POW5_BITCOUNT = 125
_MAX_LEN = 32          # "-2.2250738585072014e-308" is 24; bucket 32
_M32 = 0xFFFFFFFF

Pair = Tuple[torch.Tensor, torch.Tensor]     # (hi, lo), each in [0, 2^32)


def _pow5bits(e: int) -> int:
    return ((e * 1217359) >> 19) + 1


def _build_tables():
    """The reference's tables as Python ints: floor(2^k / 5^q) + 1,
    floor(5^i / 2^(b - 121)) (both 128-bit), and 5^-p mod 2^64 with
    its bound (2^64 - 1) // 5^p."""
    inv = []
    for q in range(292):
        k = _pow5bits(q) + _POW5_INV_BITCOUNT - 1
        inv.append((1 << k) // 5 ** q + 1)
    pw = []
    for i in range(326):
        k = _pow5bits(i) - _POW5_BITCOUNT
        pw.append(5 ** i >> k if k >= 0 else 5 ** i << -k)
    inv5 = pow(5, -1, 1 << 64)
    minv = [pow(inv5, p, 1 << 64) for p in range(24)]
    mbound = [((1 << 64) - 1) // 5 ** p for p in range(24)]
    return inv, pw, minv, mbound


_INV_TAB, _POW_TAB, _MODINV5, _MODBOUND5 = _build_tables()

_TABLES: Dict[torch.device, dict] = {}


def _limbs(vals, n_limbs: int, dev) -> torch.Tensor:
    """``[len(vals), n_limbs]`` int64: 32-bit limbs, least significant
    first."""
    a = np.array([[(v >> (32 * i)) & _M32 for i in range(n_limbs)]
                  for v in vals], dtype=np.int64)
    return torch.from_numpy(a).to(dev)


def _tables(dev) -> dict:
    t = _TABLES.get(dev)
    if t is None:
        t = {"inv": _limbs(_INV_TAB, 4, dev), "pow": _limbs(_POW_TAB, 4, dev),
             "minv": _limbs(_MODINV5, 2, dev),
             "mbound": _limbs(_MODBOUND5, 2, dev)}
        _TABLES[dev] = t
    return t


# ---------------------------------------------------------------------------
# 64-bit words as (hi, lo) pairs
# ---------------------------------------------------------------------------

def _add(a: Pair, b) -> Pair:
    """(a + b) mod 2^64; ``b`` a pair or a small non-negative int."""
    bh, bl = b if isinstance(b, tuple) else (0, b)
    lo = a[1] + bl
    return (a[0] + bh + (lo >> 32)) & _M32, lo & _M32


def _sub(a: Pair, b) -> Pair:
    """(a - b) mod 2^64 (the low half's borrow is ``lo >> 32`` = -1)."""
    bh, bl = b if isinstance(b, tuple) else (0, b)
    lo = a[1] - bl
    return (a[0] - bh + (lo >> 32)) & _M32, lo & _M32


def _mul32(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """The full 64-bit product of two 32-bit words, from 16-bit limbs."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    mid = a0 * b1 + a1 * b0                     # < 2^33
    lo = a0 * b0 + ((mid & 0xFFFF) << 16)       # < 2^33
    hi = a1 * b1 + (mid >> 16) + (lo >> 32)
    return hi, lo & _M32


def _umul128(a: Pair, b: Pair) -> Tuple[Pair, Pair]:
    """The full 64 x 64 -> 128-bit product as (lo pair, hi pair)."""
    h00, l00 = _mul32(a[1], b[1])
    h01, l01 = _mul32(a[1], b[0])
    h10, l10 = _mul32(a[0], b[1])
    h11, l11 = _mul32(a[0], b[0])
    t1 = h00 + l01 + l10
    t2 = h01 + h10 + l11 + (t1 >> 32)
    r3 = (h11 + (t2 >> 32)) & _M32
    return (t1 & _M32, l00), (r3, t2 & _M32)


def _mullo(a: Pair, b: Pair) -> Pair:
    """(a * b) mod 2^64."""
    h00, l00 = _mul32(a[1], b[1])
    _, l01 = _mul32(a[1], b[0])
    _, l10 = _mul32(a[0], b[1])
    return (h00 + l01 + l10) & _M32, l00


def _lt(a: Pair, b: Pair) -> torch.Tensor:
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def _le(a: Pair, b: Pair) -> torch.Tensor:
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def _eq(a: Pair, b: Pair) -> torch.Tensor:
    return (a[0] == b[0]) & (a[1] == b[1])


def _where(c: torch.Tensor, a: Pair, b: Pair) -> Pair:
    return torch.where(c, a[0], b[0]), torch.where(c, a[1], b[1])


def _divmod(x: Pair, d: int) -> Tuple[Pair, torch.Tensor]:
    """(x // d, x % d) for a small constant d, exactly."""
    qh = x[0] // d
    t = ((x[0] - qh * d) << 32) | x[1]          # < d * 2^32
    ql = t // d
    return (qh, ql), t - ql * d


def _shr128(limbs, dist: torch.Tensor) -> Pair:
    """The low 64 bits of a 128-bit number (four 32-bit limbs, least
    significant first) shifted right by ``dist`` in [0, 64)."""
    q = dist >> 5
    b = dist & 31
    low_mask = (1 << b) - 1

    def limb(k):
        lo_src = torch.where(q == 0, limbs[k], limbs[k + 1])
        hi_src = torch.where(q == 0, limbs[k + 1], limbs[k + 2])
        return (lo_src >> b) | ((hi_src & low_mask) << (32 - b))
    return limb(1), limb(0)


def _mul_shift64(m: Pair, mul: torch.Tensor, j: torch.Tensor) -> Pair:
    """(m * mul) >> j for a 128-bit ``mul`` (``[n, 4]`` limbs) and
    64 < j < 128: the reference's two 64 x 64 products, the carry of
    their middle sum, then the shift of the top 128 bits by j - 64."""
    lo0, hi0 = _umul128(m, (mul[:, 1], mul[:, 0]))
    lo2, hi2 = _umul128(m, (mul[:, 3], mul[:, 2]))
    del lo0
    s_lo = _add(hi0, lo2)
    s_hi = _add(hi2, _lt(s_lo, hi0).to(torch.int64))
    # a row whose branch is not taken may carry any j; clamp it so the
    # limb selection stays in range (its value is discarded)
    dist = torch.clamp(j - 64, 0, 63)
    zero = torch.zeros_like(s_lo[1])
    return _shr128((s_lo[1], s_lo[0], s_hi[1], s_hi[0], zero), dist)


def _multiple_of_pow5(value: Pair, p: torch.Tensor, tabs) -> torch.Tensor:
    """value % 5^p == 0 for p in [0, 23]: value * 5^-p mod 2^64 is at
    most (2^64 - 1) // 5^p exactly then."""
    inv, bound = tabs["minv"][p], tabs["mbound"][p]
    prod = _mullo(value, (inv[:, 1], inv[:, 0]))
    return _le(prod, (bound[:, 1], bound[:, 0]))


def _log10_pow2(e):
    return (e * 78913) >> 18


def _log10_pow5(e):
    return (e * 732923) >> 20


def _low_bits_zero(x: Pair, q: torch.Tensor) -> torch.Tensor:
    """x & ((1 << q) - 1) == 0 for q in [0, 63]."""
    q_lo = torch.clamp(q, 0, 32)
    q_hi = torch.clamp(q - 32, 0, 31)
    return ((x[1] & ((1 << q_lo) - 1)) == 0) & \
        ((x[0] & ((1 << q_hi) - 1)) == 0)


def _d2d(hi: torch.Tensor, lo: torch.Tensor):
    """Core Ryu: IEEE754 bits (finite nonzero, as halves) -> (digits
    pair, exp) with digits the shortest decimal mantissa and value ==
    digits * 10^exp."""
    tabs = _tables(hi.device)
    ieee_mant = (hi & 0xFFFFF, lo)
    ieee_exp = (hi >> 20) & 0x7FF

    subnormal = ieee_exp == 0
    e2 = torch.where(subnormal, 1 - _BIAS - _MANT_BITS - 2,
                     ieee_exp - _BIAS - _MANT_BITS - 2)
    m2 = (torch.where(subnormal, ieee_mant[0], ieee_mant[0] | (1 << 20)),
          ieee_mant[1])
    accept = (m2[1] & 1) == 0                   # even mantissa
    mv = (((m2[0] << 2) | (m2[1] >> 30)) & _M32, (m2[1] << 2) & _M32)
    mm_shift = ((ieee_mant[0] != 0) | (ieee_mant[1] != 0) |
                (ieee_exp <= 1)).to(torch.int64)
    mv_p = _add(mv, 2)
    mv_m = _sub(_sub(mv, 1), mm_shift)

    # ---- e2 >= 0 branch --------------------------------------------
    e2u = torch.clamp(e2, min=0)
    q_a = _log10_pow2(e2u) - (e2u > 3).to(torch.int64)
    q_a_u = torch.clamp(q_a, min=0)
    k_a = _POW5_INV_BITCOUNT + ((q_a_u * 1217359) >> 19)
    i_a = -e2u + q_a_u + k_a
    mul_a = tabs["inv"][torch.clamp(q_a_u, 0, len(_INV_TAB) - 1)]
    vr_a = _mul_shift64(mv, mul_a, i_a)
    vp_a = _mul_shift64(mv_p, mul_a, i_a)
    vm_a = _mul_shift64(mv_m, mul_a, i_a)
    qp = torch.clamp(q_a_u, 0, 23)
    _, mv_mod5 = _divmod(mv, 5)
    small_q = q_a_u <= 21
    vr_tz_a = small_q & (mv_mod5 == 0) & _multiple_of_pow5(mv, qp, tabs)
    vm_tz_a = small_q & (mv_mod5 != 0) & accept & \
        _multiple_of_pow5(mv_m, qp, tabs)
    vp_a = _sub(vp_a, (small_q & (mv_mod5 != 0) & ~accept &
                       _multiple_of_pow5(mv_p, qp, tabs)).to(torch.int64))
    e10_a = q_a

    # ---- e2 < 0 branch ---------------------------------------------
    ne2 = torch.clamp(-e2, min=0)
    q_b = _log10_pow5(ne2) - (ne2 > 1).to(torch.int64)
    q_b_u = torch.clamp(q_b, min=0)
    i_b_idx = torch.clamp(ne2 - q_b_u, 0, len(_POW_TAB) - 1)
    k_b = ((i_b_idx * 1217359) >> 19) + 1 - _POW5_BITCOUNT
    j_b = torch.clamp(q_b_u - k_b, min=65)
    mul_b = tabs["pow"][i_b_idx]
    vr_b = _mul_shift64(mv, mul_b, j_b)
    vp_b = _mul_shift64(mv_p, mul_b, j_b)
    vm_b = _mul_shift64(mv_m, mul_b, j_b)
    tiny_q = q_b_u <= 1
    vr_tz_b = tiny_q | ((q_b_u < 63) &
                        _low_bits_zero(mv, torch.clamp(q_b_u, 0, 63)))
    vm_tz_b = tiny_q & accept & (mm_shift == 1)
    vp_b = _sub(vp_b, (tiny_q & ~accept).to(torch.int64))
    e10_b = q_b + e2

    pos = e2 >= 0
    vr = _where(pos, vr_a, vr_b)
    vp = _where(pos, vp_a, vp_b)
    vm = _where(pos, vm_a, vm_b)
    vr_tz = torch.where(pos, vr_tz_a, vr_tz_b)
    vm_tz = torch.where(pos, vm_tz_a, vm_tz_b)
    e10 = torch.where(pos, e10_a, e10_b)

    # ---- digit removal ---------------------------------------------
    last = torch.zeros_like(e10)
    removed = torch.zeros_like(e10)
    for _ in range(18):
        vp10, _ = _divmod(vp, 10)
        vm10, vm_r = _divmod(vm, 10)
        vr10, vr_r = _divmod(vr, 10)
        go = _lt(vm10, vp10)
        vm_tz = torch.where(go, vm_tz & (vm_r == 0), vm_tz)
        vr_tz = torch.where(go, vr_tz & (last == 0), vr_tz)
        last = torch.where(go, vr_r, last)
        vr = _where(go, vr10, vr)
        vp = _where(go, vp10, vp)
        vm = _where(go, vm10, vm)
        removed = removed + go.to(torch.int64)

    # the second loop matters only for rows where vm had trailing zeros
    vr2, vm2, vr_tz2, last2, removed2 = vr, vm, vr_tz, last, removed
    for _ in range(18):
        vm10, vm_r = _divmod(vm2, 10)
        vr10, vr_r = _divmod(vr2, 10)
        go = vm_r == 0
        vr_tz2 = torch.where(go, vr_tz2 & (last2 == 0), vr_tz2)
        last2 = torch.where(go, vr_r, last2)
        vr2 = _where(go, vr10, vr2)
        vm2 = _where(go, vm10, vm2)
        removed2 = removed2 + go.to(torch.int64)
    use2 = vm_tz
    vr = _where(use2, vr2, vr)
    vm = _where(use2, vm2, vm)
    vr_tz = torch.where(use2, vr_tz2, vr_tz)
    last = torch.where(use2, last2, last)
    removed = torch.where(use2, removed2, removed)

    # round-to-even correction for exact halves
    last = torch.where(vr_tz & (last == 5) & ((vr[1] & 1) == 0), 4, last)
    need_inc = (_eq(vr, vm) & (~accept | ~vm_tz)) | (last >= 5)
    return _add(vr, need_inc.to(torch.int64)), e10 + removed


def _digits_of(out: torch.Tensor):
    """``out`` (int64, 1..17 digits) -> ([n, 17] digits, least
    significant first, and the digit count)."""
    p10 = torch.tensor([10 ** i for i in range(17)], dtype=torch.int64,
                       device=out.device)
    q = out[:, None] // p10[None, :]
    dig = (q % 10).to(torch.uint8)
    length = 1 + torch.sum(q[:, 1:] > 0, dim=1)
    return dig, length


def _lit(s: str, dev) -> Tuple[torch.Tensor, int]:
    b = np.zeros((_MAX_LEN,), np.uint8)
    b[:len(s)] = np.frombuffer(s.encode(), dtype=np.uint8)
    return torch.from_numpy(b).to(dev)[None, :], len(s)


def f64_to_string(data: torch.Tensor, validity: torch.Tensor):
    """Python-repr format of f64 -> (bytes [n, 32] u8, lengths i32).

    Specials: NaN / Infinity / -Infinity / 0.0 / -0.0 (repr style).
    Finite nonzero: shortest digits D of length L with decimal point
    exponent dexp; fixed notation for -4 <= dexp < 16, else
    scientific  d[.ddd]e(+|-)XX  with >= 2 exponent digits.
    """
    from spark_rapids_tpu_torch.expr.eval_tpu import f64_bits
    dev = data.device
    bits = f64_bits(data)
    hi, lo = (bits >> 32) & _M32, bits & _M32
    sign = (hi >> 31) != 0
    ahi = hi & 0x7FFFFFFF
    ieee_exp = ahi >> 20
    is_nan = (ieee_exp == 0x7FF) & (((ahi & 0xFFFFF) != 0) | (lo != 0))
    is_inf = (ieee_exp == 0x7FF) & ~is_nan
    is_zero = (ahi == 0) & (lo == 0)

    digits, exp = _d2d(ahi, lo)
    dig, L = _digits_of((digits[0] << 32) | digits[1])
    dexp = exp + L - 1                    # exponent of the first digit

    sci = (dexp < -4) | (dexp >= 16)
    cols = torch.arange(_MAX_LEN, dtype=torch.int64, device=dev)[None, :]
    s_off = sign.to(torch.int64)[:, None]        # '-' column shift
    Lc = L[:, None]
    dx = dexp[:, None]
    zero_ch, dot = ord("0"), ord(".")

    def dchar(idx_from_msd):
        """ASCII digit k positions after the most significant digit."""
        sel = torch.clamp(Lc - 1 - idx_from_msd, 0, 16)
        return torch.gather(dig, 1, sel.expand(-1, _MAX_LEN)) + zero_ch

    # ---- fixed notation --------------------------------------------
    # dexp >= 0:  D[0..dexp] (zero-padded) '.' D[dexp+1..] (or '0')
    # dexp < 0 :  '0' '.' zeros(-dexp-1) D[0..]
    ip_len = torch.where(dx >= 0, dx + 1, 1)        # integer digits
    fr_len = torch.where(dx >= 0, torch.clamp(Lc - (dx + 1), min=1),
                         (-dx - 1) + Lc)
    fix_len = ip_len + 1 + fr_len
    j = cols - s_off
    in_int = (j >= 0) & (j < ip_len)
    at_dot = j == ip_len
    in_frac = (j > ip_len) & (j < fix_len)
    fj = j - ip_len - 1                              # fraction index
    int_digit = torch.where((dx >= 0) & (j < Lc), dchar(j), zero_ch)
    # for dexp >= 0 the k-th fraction char is digit (dexp+1+k); for
    # dexp < 0 it's zeros until k == -dexp-1 then digit (k + dexp + 1)
    frac_pos = fj + dx + 1
    frac_digit = torch.where((frac_pos >= 0) & (frac_pos < Lc),
                             dchar(frac_pos), zero_ch)
    fixed_ch = torch.where(
        in_int, int_digit,
        torch.where(at_dot, dot, torch.where(in_frac, frac_digit, 0)))

    # ---- scientific notation ---------------------------------------
    # d '.' rest | 'e' sign dd[d]
    has_frac = Lc > 1
    mant_len = torch.where(has_frac, Lc + 1, 1)
    aexp = torch.abs(dx)
    e_digits = torch.where(aexp >= 100, 3, 2)
    sci_len = mant_len + 2 + e_digits
    ej = j - mant_len - 2
    e1, e2_, e3 = aexp // 100, (aexp // 10) % 10, aexp % 10
    exp_digit = torch.where(
        e_digits == 3,
        torch.where(ej == 0, e1, torch.where(ej == 1, e2_, e3)),
        torch.where(ej == 0, e2_, e3)) + zero_ch
    sci_ch = torch.where(
        j == 0, dchar(torch.zeros_like(j)),
        torch.where(
            (j == 1) & has_frac, dot,
            torch.where(
                (j >= 2) & (j < mant_len), dchar(j - 1),
                torch.where(
                    j == mant_len, ord("e"),
                    torch.where(
                        j == mant_len + 1,
                        torch.where(dx < 0, ord("-"), ord("+")),
                        torch.where((j >= mant_len + 2) & (j < sci_len),
                                    exp_digit, 0))))))

    ch = torch.where(sci[:, None], sci_ch, fixed_ch).to(torch.uint8)
    length = torch.where(sci, sci_len[:, 0], fix_len[:, 0]) + \
        sign.to(torch.int64)
    ch = torch.where((cols == 0) & sign[:, None], ord("-"), ch)

    # ---- specials ---------------------------------------------------
    for m, s in ((is_nan, "NaN"), (is_inf & ~sign, "Infinity"),
                 (is_inf & sign, "-Infinity"), (is_zero & ~sign, "0.0"),
                 (is_zero & sign, "-0.0")):
        b, le = _lit(s, dev)
        ch = torch.where(m[:, None], b, ch)
        length = torch.where(m, le, length)

    ch = torch.where(validity[:, None], ch, 0)
    length = torch.where(validity, length, 0)
    # zero the columns past each row's length (device string contract)
    ch = torch.where(cols < length[:, None], ch, 0).to(torch.uint8)
    return ch, length.to(torch.int32)
