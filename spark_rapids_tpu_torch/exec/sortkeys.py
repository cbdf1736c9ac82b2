"""Total-order sort-key encoding for device columns, on torch tensors.

Ported from ``spark_rapids_tpu/exec/sortkeys.py``.  Every column encodes
into unsigned keys whose ascending numeric order is the column's SQL
order (sign-bit flip for ints, the IEEE total-order transform for
floats after canonicalizing NaN and -0.0, 0/1 for bools, big-endian
packed bytes plus the length for strings, a leading null flag).

Torch has no general uint64 arithmetic, so the unsigned keys are CARRIED
IN int64: the tensor holds the reference's uint64 bit pattern.  Bitwise
ops, equality and wrapping adds are the same on both; anything that
orders keys (a sort, a min or a max) must first flip the sign bit
(:func:`signed_order`).  The u32 radix digits of ``fields_to_digits``
are non-negative int64 values below 2^32, so they sort as they are.

``radix_order_digits`` replaces the reference's LSD radix loop (which
only dodged XLA's sort-compile bill) with a loop of stable
``torch.sort`` passes, least significant digit first: the same
permutation.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.expr.eval_tpu import ColVal, f64_bits

SIGN64 = -(1 << 63)            # the uint64 sign bit, as an int64
_MASK32 = 0xFFFFFFFF


def signed_order(u: torch.Tensor) -> torch.Tensor:
    """int64-carried uint64 keys -> int64 values in the same order."""
    return u ^ SIGN64


def _int_key(data: torch.Tensor) -> torch.Tensor:
    # two's-complement value, sign bit flipped: the uint64 order key
    return data.to(torch.int64) ^ SIGN64


def _float_key(data: torch.Tensor, is32: bool) -> torch.Tensor:
    x = data
    # canonicalize: -0.0 -> 0.0, NaN -> canonical quiet NaN (positive)
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    if is32:
        bits = x.contiguous().view(torch.int32).to(torch.int64)
        bits = bits << 32  # keep ordering in the top bits
        neg = bits < 0
        return torch.where(neg, ~bits, bits ^ SIGN64)
    u = f64_bits(x)
    neg = u < 0
    return torch.where(neg, ~u, u ^ SIGN64)


def encode_keys(v: ColVal, ascending: bool = True,
                nulls_first: bool = True) -> List[torch.Tensor]:
    """Encode one column into uint64 keys (carried in int64),
    most-significant first."""
    keys: List[torch.Tensor] = []
    one = 1 if nulls_first else 0
    keys.append(torch.where(v.validity, one, 1 - one).to(torch.int64))
    d = v.dtype
    if d.is_string:
        w = v.data.shape[1]
        for word_start in range(0, w, 8):
            word = torch.zeros(v.data.shape[0], dtype=torch.int64,
                               device=v.data.device)
            for k in range(8):
                j = word_start + k
                if j < w:
                    byte = v.data[:, j].to(torch.int64)
                    word = word | (byte << (8 * (7 - k)))
            keys.append(word)
        keys.append(v.lengths.to(torch.int64))
    elif d.is_floating:
        keys.append(_float_key(v.data, d.id == dt.TypeId.FLOAT32))
    elif d.is_bool:
        keys.append(v.data.to(torch.int64))
    else:
        keys.append(_int_key(v.data))

    if not ascending:
        keys = [keys[0]] + [~k for k in keys[1:]]
    # null rows: zero out value keys so equal nulls tie deterministically
    for i in range(1, len(keys)):
        keys[i] = torch.where(v.validity, keys[i], 0)
    return keys


def narrow_int_bits(v: ColVal) -> Optional[int]:
    """Effective bit width encode_fields uses for an integer-backed
    column (dtype width capped by the vbits range hint), or None for
    non-integer / full-width columns."""
    d = v.dtype
    if d.is_string or d.is_floating or d.is_bool:
        return None
    npd = np.dtype(d.to_np())
    if not np.issubdtype(npd, np.integer):
        return None
    vb = min(getattr(v, "vbits", None) or 64, npd.itemsize * 8)
    return vb if vb < 64 else None


def _mask(w: int) -> int:
    return (1 << w) - 1


def encode_fields(v: ColVal, ascending: bool = True,
                  nulls_first: bool = True, nullable: bool = True
                  ) -> List[Tuple[int, torch.Tensor]]:
    """Encode one column as bit-width-aware key fields, most significant
    first: (width_bits, values masked to width, int64-carried).  Fields
    pack to their true width (bool=1, 32-bit types=32, 64-bit types as
    two 32-bit halves, string length=16, a vbits hint narrows integers)
    so fields_to_digits chops them into few u32 digits."""
    fields: List[Tuple[int, torch.Tensor]] = []
    if nullable:
        one = 1 if nulls_first else 0
        fields.append((1, torch.where(v.validity, one, 1 - one)
                       .to(torch.int64)))

    def split64(u: torch.Tensor) -> List[Tuple[int, torch.Tensor]]:
        return [(32, (u >> 32) & _MASK32), (32, u & _MASK32)]

    d = v.dtype
    vals: List[Tuple[int, torch.Tensor]] = []
    if d.is_string:
        w = v.data.shape[1]
        for word_start in range(0, w, 4):
            word = torch.zeros(v.data.shape[0], dtype=torch.int64,
                               device=v.data.device)
            for k in range(4):
                j = word_start + k
                if j < w:
                    byte = v.data[:, j].to(torch.int64)
                    word = word | (byte << (8 * (3 - k)))
            vals.append((32, word))
        vals.append((16, v.lengths.to(torch.int64) & 0xFFFF))
    elif d.is_floating:
        if d.id == dt.TypeId.FLOAT32:
            x = v.data
            x = torch.where(x == 0.0, torch.zeros_like(x), x)
            x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")),
                            x)
            bits = x.contiguous().view(torch.int32)
            u = bits.to(torch.int64) & _MASK32
            neg = bits < 0
            key = torch.where(neg, (~u) & _MASK32, u ^ 0x80000000)
            vals.append((32, key))
        else:
            vals.extend(split64(_float_key(v.data, False)))
    elif d.is_bool:
        vals.append((1, v.data.to(torch.int64)))
    else:
        npd = np.dtype(d.to_np())
        vb = v.vbits if getattr(v, "vbits", None) else None
        vb = min(vb or 64, npd.itemsize * 8)
        if vb < 64:
            # all valid values fit signed vb bits: the biased value is an
            # order-preserving unsigned vb-bit key
            biased = v.data.to(torch.int64) + (1 << (vb - 1))
            if vb <= 32:
                vals.append((vb, biased))
            else:
                vals.append((vb - 32, (biased >> 32) & _MASK32))
                vals.append((32, biased & _MASK32))
        else:
            vals.extend(split64(_int_key(v.data)))

    if not ascending:
        vals = [(w, (~k) & _mask(w)) for w, k in vals]
    # null rows: zero value fields so equal nulls tie deterministically
    vals = [(w, torch.where(v.validity, k, 0)) for w, k in vals]
    return fields + vals


def fields_to_digits(fields: List[Tuple[int, torch.Tensor]]
                     ) -> torch.Tensor:
    """Concatenate MSB-first bit fields and chop the bitstring into u32
    radix digits (int64-carried, non-negative), LEAST significant digit
    first.  Every field must be <= 32 bits."""
    digits: List[torch.Tensor] = []
    cur = None
    cur_bits = 0
    for w, vals in reversed(fields):   # least-significant field first
        assert w <= 32, w
        v = vals & _mask(w)
        if cur is None:
            cur = torch.zeros_like(v)
        # cur_bits < 32 and w <= 32: the packed value stays below 2^63
        cur = cur | (v << cur_bits)
        cur_bits += w
        while cur_bits >= 32:
            digits.append(cur & _MASK32)
            cur = cur >> 32
            cur_bits -= 32
    assert cur is not None, "fields_to_digits needs at least one field"
    if cur_bits or not digits:
        digits.append(cur & _MASK32)
    return torch.stack(digits)           # [d, cap], LSB digit first


def radix_order_digits(digits: torch.Tensor) -> torch.Tensor:
    """Stable order (int64 indices) from [d, cap] digits, least
    significant digit first: one stable sort per digit, each pass
    ordering by its digit while keeping the previous passes' order."""
    cap = digits.shape[1]
    perm = torch.arange(cap, dtype=torch.int64, device=digits.device)
    for di in range(digits.shape[0]):
        _, p = torch.sort(digits[di][perm], stable=True)
        perm = perm[p]
    return perm


def radix_order(wm: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic order of a [m, cap] word matrix (uint64 keys
    carried in int64, row 0 most significant): one stable sort per word,
    least significant first, each ordering by the word's unsigned value
    (:func:`signed_order`)."""
    cap = wm.shape[1]
    perm = torch.arange(cap, dtype=torch.int64, device=wm.device)
    for i in range(wm.shape[0] - 1, -1, -1):
        _, p = torch.sort(signed_order(wm[i][perm]), stable=True)
        perm = perm[p]
    return perm


def lexsort_indices(key_groups: List[List[torch.Tensor]],
                    row_mask: torch.Tensor) -> torch.Tensor:
    """Stable sort indices; padding rows always sort to the end.

    key_groups: per sort column (primary first), the encode_keys output.
    """
    return radix_order(stack_sort_words(key_groups, row_mask))


def _starts(x: torch.Tensor) -> torch.Tensor:
    """True at row 0 and wherever a row differs from the one before."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                      x[1:] != x[:-1]])


def group_boundaries(key_groups: List[List[torch.Tensor]],
                     order: torch.Tensor,
                     row_mask: torch.Tensor) -> torch.Tensor:
    """After sorting with `order`, mark rows that start a new key group.

    Null keys compare equal (SQL GROUP BY semantics).  Padding rows always
    start their own group so they never merge into the last real group.
    """
    new_group = _starts(row_mask[order])
    for group in key_groups:
        for k in group:
            new_group = new_group | _starts(k[order])
    return new_group


# ---------------------------------------------------------------------------
# Standalone sorts shared by the sort, the joins and the aggregate
# ---------------------------------------------------------------------------
#
# The reference runs these as standalone jitted kernels keyed on (word or
# digit count, capacity) so that XLA compiles each sort once per process;
# here they are eager torch sorts.

def stack_sort_words(key_groups: List[List[torch.Tensor]],
                     row_mask: torch.Tensor) -> torch.Tensor:
    """[m, cap] word matrix, most-significant first, with the padding key
    leading so padding rows always sort last."""
    flat: List[torch.Tensor] = []
    for group in key_groups:
        flat.extend(group)
    pad_key = (~row_mask).to(torch.int64)
    return torch.stack([pad_key] + flat)


def stack_sort_digits(field_groups: List[List[Tuple[int, torch.Tensor]]],
                      row_mask: torch.Tensor) -> torch.Tensor:
    """Bit-width-aware u32 digit matrix for a full sort spec: the padding
    flag leads (so padding rows always sort last), then each column's
    encode_fields output in priority order."""
    fields: List[Tuple[int, torch.Tensor]] = [
        (1, (~row_mask).to(torch.int64))]
    for g in field_groups:
        fields.extend(g)
    return fields_to_digits(fields)


def _digit_sort_impl(digits: torch.Tensor) -> torch.Tensor:
    if digits.shape[0] == 1:
        # everything fits one u32: a single stable sort
        return torch.sort(digits[0], stable=True)[1]
    return radix_order_digits(digits)


def shared_digit_sort(digits: torch.Tensor) -> torch.Tensor:
    """Stable order for a [d, cap] digit matrix (LSB digit first), via
    the shared per-(d, cap) step of the kernel cache."""
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    d, cap = int(digits.shape[0]), int(digits.shape[1])
    fn = kc.get_kernel(("shared_digit_sort", d, cap),
                       lambda: _digit_sort_impl)
    return fn(digits)


def digit_boundaries(digits: torch.Tensor, order: torch.Tensor,
                     row_mask: torch.Tensor) -> torch.Tensor:
    """After sorting with ``order``, mark rows whose key differs from the
    previous row's (group starts) — the digits analog of
    group_boundaries.  Padding rows always start their own group."""
    new_group = _starts(row_mask[order])
    for di in range(digits.shape[0]):
        new_group = new_group | _starts(digits[di][order])
    return new_group


def shared_lexsort(wm: torch.Tensor) -> torch.Tensor:
    """Stable sort order for a [m, cap] word matrix, via the shared
    per-(m, cap) step of the kernel cache."""
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    m, cap = int(wm.shape[0]), int(wm.shape[1])
    fn = kc.get_kernel(("shared_lexsort4", m, cap), lambda: radix_order)
    return fn(wm)



def _shared_partition_order_impl(targets: torch.Tensor) -> torch.Tensor:
    return torch.sort(targets, stable=True)[1]


def shared_partition_order(targets: torch.Tensor) -> torch.Tensor:
    """Stable order grouping rows by non-negative int32 target id: rows
    of one target keep their input order (the reference sorts
    ``target << 32 | row`` as u64; a stable sort of the targets is the
    same permutation).  A shared step keyed on capacity only."""
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    fn = kc.get_kernel(("shared_partition_order", int(targets.shape[0])),
                       lambda: _shared_partition_order_impl)
    return fn(targets)


DUMP_SLOTS = 1 << 16


def dump_where(keep: torch.Tensor, idx: torch.Tensor, n: int
               ) -> torch.Tensor:
    """Scatter targets for a reducing scatter into a buffer of
    ``n + DUMP_SLOTS``: ``idx`` where ``keep``, else one of the spare
    slots past ``n``, chosen by row.  A row that only drops (a padding
    row, one that claims nothing) must not land on one shared slot: the
    scatter's atomics on a single address serialize, which took hundreds
    of milliseconds per call on the H100 at 2^24 rows."""
    spare = torch.arange(idx.shape[0], device=idx.device) & (DUMP_SLOTS - 1)
    return torch.where(keep, idx, n + spare)


def hash_group_ids(words: List[torch.Tensor], row_mask: torch.Tensor):
    """Dense group ids for equal-key rows WITHOUT sorting: linear-probe
    hash build with scatter claims (the cudf hash-groupby analog).

    Returns (seg, n_groups): seg[i] in [0, n_groups) for real rows —
    equal keys share an id — and cap-1 for padding rows (safe: padding
    implies n_groups < cap).  Ids are dense but hash-ordered, and equal
    the reference's id for id: the FNV-1a hash is the reference's uint32
    arithmetic in int64 masked to 32 bits, and each claim round takes
    the smallest claiming row per slot, as its scatter-min does.

    Each round reads whether any row is unresolved (one host sync, the
    reference's ``while_loop`` condition); the rounds are counted in the
    ``join.hashRounds`` registry counter."""
    from spark_rapids_tpu_torch.obs import registry as obsreg
    cap = int(row_mask.shape[0])
    dev = row_mask.device
    wm = torch.stack(words)                    # [W, cap] int64-carried u64
    h = torch.full((cap,), 2166136261, dtype=torch.int64, device=dev)
    for i in range(wm.shape[0]):
        for part in (wm[i] & _MASK32, (wm[i] >> 32) & _MASK32):
            h = ((h ^ part) * 16777619) & _MASK32
    # the probe wraparound is a bitmask, so the table size is a power of
    # two whatever the batch capacity
    T = 1
    while T < 2 * cap:
        T <<= 1
    tmask = T - 1
    maxi = int(np.iinfo(np.int32).max)
    row_idx = torch.arange(cap, dtype=torch.int64, device=dev)
    slot = torch.where(row_mask, h & tmask, 0)
    resolved = ~row_mask
    owner = torch.full((T,), -1, dtype=torch.int64, device=dev)
    rounds = 0
    while bool((~resolved).any()):
        rounds += 1
        unres = ~resolved
        own = owner[slot]
        cand = torch.where(unres & (own < 0), row_idx, maxi)
        claimed = torch.full((T + DUMP_SLOTS,), maxi, dtype=torch.int64,
                             device=dev)
        claimed.scatter_reduce_(0, dump_where(cand < maxi, slot, T),
                                cand, "amin")
        claimed = claimed[:T]
        owner = torch.where((owner < 0) & (claimed < maxi), claimed, owner)
        own2 = owner[slot]
        ref = torch.clamp(own2, 0, cap - 1)
        eq = own2 >= 0
        for i in range(wm.shape[0]):
            eq = eq & (wm[i] == wm[i][ref])
        done = (own2 == row_idx) | eq
        resolved = resolved | (unres & done)
        slot = torch.where(resolved, slot, (slot + 1) & tmask)
    obsreg.get_registry().inc("join.hashRounds", rounds)
    used = owner >= 0
    dense = torch.cumsum(used.to(torch.int32), 0, dtype=torch.int32) - 1
    n_groups = used.to(torch.int32).sum()
    seg = torch.where(row_mask, dense[slot],
                      torch.full((), cap - 1, dtype=torch.int32, device=dev))
    return seg, n_groups
