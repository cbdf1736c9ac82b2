"""Capacity tiers and batch erasure of the shape-erased kernel ABI.

Ported from ``spark_rapids_tpu/exec/kernel_abi.py``.  The reference
erases batches so that jax.jit compiles fewer programs; the port runs
eagerly and compiles nothing per shape, but it keeps the same ladders so
that batches are born at the reference's capacities.  That matters for
results: the segmented scans block by capacity (exec/scans.py), and the
aggregate's capacity ladder picks its rung from the capacity.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, List, Optional, Tuple

_enabled = True          # kernel.abi.enabled default
_tier_stride = 2         # capacity ladder: every 2**stride-th pow2 rung
_width_stride = 2        # string/list max_len ladder
_bucket_hints = True     # re-bucket vbits at the ABI boundary

# the ABI hint buckets: <=16 single-digit sort, <=32 i32 gather + segment
# sums, <=56 packed radix fields under 64 bits
ABI_VBIT_BUCKETS = (16, 32, 56)

_CANON = [f"_c{i}" for i in range(64)]


def configure(conf) -> None:
    """Install the ABI knobs from a conf.  Last call wins."""
    global _enabled, _tier_stride, _width_stride, _bucket_hints
    from spark_rapids_tpu_torch import config as cfg
    _enabled = bool(conf.get(cfg.KERNEL_ABI_ENABLED))
    _tier_stride = max(1, int(conf.get(cfg.KERNEL_ABI_TIER_STRIDE)))
    _width_stride = max(1, int(conf.get(cfg.KERNEL_ABI_WIDTH_STRIDE)))
    _bucket_hints = bool(conf.get(cfg.KERNEL_ABI_BUCKET_HINTS))


def tier_rows(n: int, min_bucket: int = 16) -> int:
    """Smallest capacity tier >= max(n, min_bucket): power-of-two rungs
    restricted to every ``tierStride``-th step of one ladder anchored at
    1 (stride 2: 1, 4, 16, 64, 256, ...).  ``min_bucket`` is a floor, not
    an anchor."""
    if not _enabled:
        cap = max(int(min_bucket), 1)
        n = max(int(n), 1)
        while cap < n:
            cap <<= 1
        return cap
    cap = 1
    lo = max(int(n), int(min_bucket), 1)
    step = 1 << _tier_stride
    while cap < lo:
        cap *= step
    return cap


def tier_strlen(n: int) -> int:
    """String/list width tier >= n (1, 4, 16, 64, ... by default)."""
    if n <= 0:
        return 1
    cap = 1
    step = 1 << (_width_stride if _enabled else 1)
    while cap < n:
        cap *= step
    return cap


def bucket_vbits(vb: Optional[int]) -> Optional[int]:
    """ABI hint bucket for a precise vbits value (a weaker bound, always
    sound); identity when the ABI or hint bucketing is off."""
    if vb is None or not (_enabled and _bucket_hints):
        return vb
    for b in ABI_VBIT_BUCKETS:
        if vb <= b:
            return b
    return None


def canonical_input_names(n: int) -> List[str]:
    if n <= len(_CANON):
        return _CANON[:n]
    return _CANON + [f"_c{i}" for i in range(len(_CANON), n)]


def _erase_column(c, strip_hints: bool = False):
    """Hint-bucketed (or, for steps that never read hints, hint-stripped)
    view of one column; shares every buffer."""
    if strip_hints:
        if c.vbits is None and not c.nonnull:
            return c
        return replace(c, vbits=None, nonnull=False)
    vb = bucket_vbits(c.vbits)
    if vb == c.vbits:
        return c
    return replace(c, vbits=vb)


def _pad_column(c, cap: int, width: Optional[int]):
    """Pad one column's buffers to ``cap`` rows (and 2-D payloads to
    ``width``) with the batch contract's zeros/False."""
    def pad(a, w=None):
        if a is None:
            return None
        shape = (max(cap, a.shape[0]),) + (
            (max(w or 0, a.shape[1]),) if a.dim() == 2 else ())
        if tuple(a.shape) == shape:
            return a
        out = a.new_zeros(shape)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    return replace(c, data=pad(c.data, width), validity=pad(c.validity),
                   lengths=pad(c.lengths),
                   elem_validity=pad(c.elem_validity, width))


def erase(batch, pad: bool = True, strip_hints: bool = False):
    """The erased view of a batch at an exec boundary: canonical
    positional names, ABI-bucketed hints, and (``pad=True``) capacity /
    var-len widths padded up to their tiers.  Shares the input's buffers
    whenever no padding is needed; ``num_rows`` passes through.

    ``pad=False`` is for steps whose host epilogue reads the original
    buffer shapes back (the packed download): names and hints erase,
    shapes stay.  ``strip_hints=True`` drops the hints instead of
    bucketing them, for steps that never read vbits/nonnull (the pack),
    so a hint cannot make a new argument signature for the same work."""
    if not _enabled:
        return batch
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    cols = [_erase_column(c, strip_hints) for c in batch.columns]
    if pad and cols:
        cap = tier_rows(batch.capacity, min_bucket=min(16, batch.capacity))
        widths = [tier_strlen(c.max_len) if c.dtype.has_lengths else None
                  for c in cols]
        if cap != batch.capacity or any(
                w is not None and w != c.max_len
                for w, c in zip(widths, cols)):
            cols = [_pad_column(c, cap, w)
                    for c, w in zip(cols, widths)]
    out = DeviceBatch.__new__(DeviceBatch)
    out.names = canonical_input_names(len(cols))
    out.columns = cols
    out.num_rows = batch.num_rows
    out._capacity = cols[0].capacity if cols else batch._capacity
    out.device = batch.device
    return out


def layout_key(batch) -> Tuple:
    """Positional physical layout of a batch: the capacity and, per
    column, (dtype name, var-len width, has-elem-validity).  No names."""
    return (batch._capacity,
            tuple((c.dtype.name,
                   c.max_len if c.dtype.has_lengths else 0,
                   c.elem_validity is not None)
                  for c in batch.columns))


def erased_key(batch) -> Any:
    """The layout under the ABI; with the ABI off, the layout with the
    batch's names (the reference's named key), so a key taken under one
    setting never matches one taken under the other.  The layout is
    always element 1."""
    if _enabled:
        return ("abi", layout_key(batch))
    return ("named", layout_key(batch), tuple(batch.names))
