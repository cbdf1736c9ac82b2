"""Device-resident columnar batches on torch tensors.

Ported from ``spark_rapids_tpu/columnar/batch.py``; the batch contract is
the reference's:

  * ``capacity`` — the padded physical row count, a tier of the kernel
    ABI's ladder (exec/kernel_abi.py), and
  * ``num_rows`` — the logical row count: a host int, or a 0-d device
    tensor for the output of device work that has not been read back.

Rows in ``[num_rows, capacity)`` are padding: validity False, data zeroed.
Strings are a ``uint8 [capacity, max_len]`` byte matrix plus ``int32``
lengths; lists add ``elem_validity``.

Every entry point that creates device data takes an explicit ``device``
(default ``"cuda"``, which raises when no GPU is present); everything
else follows the device of the tensors it is given.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import dtypes as dt


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  ``cuda`` without a GPU
    raises: the port never carries on on the CPU unasked."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain torch versions")
    return d


def scatter_drop(dest: torch.Tensor, src: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``zeros(n).at[dest].set(src, mode="drop")``: positions >= n drop.
    Torch indexing faults on an out-of-range index, so the scatter lands
    in an n+1 buffer whose last slot takes every dropped row."""
    out = src.new_zeros((n + 1,) + tuple(src.shape[1:]))
    out[dest.clamp(0, n).long()] = src
    return out[:n]


def compact_arrays(keep: torch.Tensor, dest: torch.Tensor, data,
                   validity, lengths=None, elem_validity=None):
    """Stable-compaction scatter: row i moves to dest[i] when keep[i],
    rows with dest >= len drop.  Returns (data, validity, lengths,
    elem_validity)."""
    n = data.shape[0]
    d = scatter_drop(dest, data, n)
    v = scatter_drop(dest, validity & keep, n)
    ln = None if lengths is None else \
        scatter_drop(dest, torch.where(keep, lengths, 0).to(lengths.dtype), n)
    ev = None if elem_validity is None else \
        scatter_drop(dest, elem_validity & keep[:, None], n)
    return d, v, ln, ev


def bucket_rows(n: int, min_bucket: int = 16) -> int:
    """Smallest capacity tier >= n (>= min_bucket), from the kernel ABI's
    ladder (exec/kernel_abi.tier_rows)."""
    from spark_rapids_tpu_torch.exec import kernel_abi
    return kernel_abi.tier_rows(n, min_bucket)


def _bucket_strlen(n: int) -> int:
    from spark_rapids_tpu_torch.exec import kernel_abi
    return kernel_abi.tier_strlen(n)


@dataclass(frozen=True)
class DeviceColumn:
    """One column: device buffers + validity.

    STRING and LIST share the var-len layout: a padded 2-D payload
    ``[capacity, max_len]`` + per-row ``lengths``; LIST additionally
    carries ``elem_validity``."""

    dtype: dt.DType
    data: torch.Tensor              # [capacity] or [capacity, max_len]
    validity: torch.Tensor          # bool [capacity]
    lengths: Optional[torch.Tensor] = None  # int32 [capacity]
    elem_validity: Optional[torch.Tensor] = None  # bool [cap, max_len]
    # static value-range hint for integer-backed columns: every VALID
    # value v satisfies -2^(vbits-1) <= v < 2^(vbits-1); None = unknown
    vbits: Optional[int] = None
    # static no-nulls hint: validity is True at every live row
    nonnull: bool = False

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def max_len(self) -> int:
        assert self.dtype.has_lengths
        return int(self.data.shape[1])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.data, self.validity, self.lengths,
                             self.elem_validity) if t is not None)

    def gather(self, indices: torch.Tensor,
               valid: torch.Tensor) -> "DeviceColumn":
        """Row gather; ``valid`` masks rows whose source index is
        meaningful (indices must lie in [0, capacity))."""
        idx = indices.long()
        data = self.data[idx]
        validity = self.validity[idx] & valid
        lengths = ev = None
        if self.lengths is not None:
            lengths = torch.where(valid, self.lengths[idx], 0).to(
                self.lengths.dtype)
        data = torch.where(_bcast(valid, data), data,
                           torch.zeros((), dtype=data.dtype,
                                       device=data.device))
        if self.elem_validity is not None:
            ev = self.elem_validity[idx] & valid[:, None]
        return DeviceColumn(self.dtype, data, validity, lengths, ev,
                            self.vbits)


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dim() == 2:
        return mask[:, None]
    return mask


class DeviceBatch:
    """A batch of device columns with a logical row count.

    A batch without columns (a scan that reads no column, a count(*))
    has no tensor to take its device from, so it needs ``device`` or a
    ``num_rows`` that is a device tensor."""

    def __init__(self, names: Sequence[str], columns: Sequence[DeviceColumn],
                 num_rows, device=None):
        self.names: List[str] = list(names)
        self.columns: List[DeviceColumn] = list(columns)
        # a host int, or a 0-d device tensor not yet read back
        self.num_rows = int(num_rows) if isinstance(
            num_rows, (int, np.integer)) else num_rows
        if self.columns:
            caps = {c.capacity for c in self.columns}
            assert len(caps) == 1, f"ragged capacities {caps}"
            self._capacity = caps.pop()
            self.device = self.columns[0].data.device
        else:
            self._capacity = bucket_rows(int(num_rows))
            if device is not None:
                self.device = torch.device(device)
            elif isinstance(num_rows, torch.Tensor):
                self.device = num_rows.device
            else:
                raise ValueError("DeviceBatch without columns needs a "
                                 "device")

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> DeviceColumn:
        return self.columns[self.names.index(name)]

    def schema_key(self) -> Tuple:
        """Hashable (schema, shape-bucket) key: names, dtype names,
        capacity and var-len widths (a kernel-cache key component)."""
        return (tuple(self.names),
                tuple(c.dtype.name for c in self.columns),
                self._capacity,
                tuple(c.max_len if c.dtype.has_lengths else 0
                      for c in self.columns))

    def row_mask(self) -> torch.Tensor:
        return torch.arange(self._capacity, device=self.device) < \
            self.num_rows

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.dtype.name}" for n, c in
                         zip(self.names, self.columns))
        return (f"DeviceBatch(rows={int(self.num_rows)}/{self._capacity}, "
                f"[{cols}])")


# ---------------------------------------------------------------------------
# Host (Arrow) <-> device conversion
# ---------------------------------------------------------------------------

def _np_strings_from_arrow(arr, valid: np.ndarray, capacity: int, zeros):
    """(data [capacity, max_len] u8, lengths [capacity] i32) of a string
    array, copied from its offsets and bytes with numpy (no Python loop
    over rows: a per-row loop took seconds per million strings).  Where
    the live rows' bytes lie back to back in the buffer (no null row
    spans bytes), one masked assignment copies them: a boolean mask's
    cells are filled in row-major order, which is the buffer's order."""
    if not pa.types.is_large_string(arr.type):
        arr = arr.cast(pa.large_string())
    n = len(arr)
    _, obuf, dbuf = arr.buffers()
    offsets = np.frombuffer(obuf, dtype=np.int64)[
        arr.offset:arr.offset + n + 1] if n else np.zeros(1, np.int64)
    lens = np.where(valid, offsets[1:] - offsets[:-1], 0)
    max_len = _bucket_strlen(int(lens.max(initial=0)))
    data = zeros((capacity, max_len), np.uint8)
    lengths = zeros(capacity, np.int32)
    lengths[:n] = lens
    if dbuf is not None:
        buf = np.frombuffer(dbuf, dtype=np.uint8)
        starts = offsets[:-1]
        if np.array_equal(lens, offsets[1:] - starts):
            mask = np.arange(max_len)[None, :] < lens[:, None]
            data[:n][mask] = buf[offsets[0]:offsets[n]]
            return data, lengths
        # one byte position at a time, over the rows that long
        for j in range(int(lens.max(initial=0))):
            rows = np.flatnonzero(lens > j)
            data[rows, j] = buf[starts[rows] + j]
    return data, lengths


def _np_column_from_arrow(arr, dtype: dt.DType, capacity: int,
                          empty=np.empty
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     Optional[np.ndarray],
                                     Optional[np.ndarray]]:
    """One Arrow column as padded numpy arrays (data, validity, lengths,
    element validity), each built in place in a buffer from ``empty(shape,
    dtype)``: the pad is the only host copy of the values, and only the
    padding rows are zeroed."""
    def zeros(shape, np_dtype):
        a = empty(shape, np_dtype)
        a[...] = 0
        return a

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.chunk(0) if arr.num_chunks == 1 else arr.combine_chunks()
    n = len(arr)
    validity = empty(capacity, np.bool_)
    validity[n:] = False
    if arr.null_count:
        validity[:n] = ~np.asarray(arr.is_null())
    else:
        validity[:n] = True

    if dtype.is_list:
        # a null list has length 0; a null element keeps ev False and a
        # 0 payload.  Element k of row i is child value offs[i] + k.
        offs = arr.offsets.to_numpy(zero_copy_only=False).astype(np.int64)
        lens = np.where(validity[:n], offs[1:] - offs[:-1], 0)
        max_len = _bucket_strlen(int(lens.max()) if n else 0)
        data = zeros((capacity, max_len), dtype.element.to_np())
        ev = zeros((capacity, max_len), np.bool_)
        lengths = zeros(capacity, np.int32)
        lengths[:n] = lens
        rows = np.repeat(np.arange(n), lens)
        cols = np.arange(len(rows)) - np.repeat(np.cumsum(lens) - lens, lens)
        src = np.repeat(offs[:-1], lens) + cols
        child = arr.values
        ok = np.asarray(child.is_valid())[src]
        vals = child.fill_null(_zero_value(dtype.element)).to_numpy(
            zero_copy_only=False)[src]
        ev[rows, cols] = ok
        data[rows, cols] = np.where(ok, vals, 0)
        return data, validity, lengths, ev

    if dtype.is_string:
        data, lengths = _np_strings_from_arrow(arr, validity[:n], capacity,
                                               zeros)
        return data, validity, lengths, None

    np_dtype = dtype.to_np()
    data = empty(capacity, np_dtype)
    data[n:] = 0
    if pa.types.is_timestamp(arr.type):
        arr = arr.cast(pa.timestamp("us"))
        vals = arr.to_numpy(zero_copy_only=False)
        ints = vals.astype("datetime64[us]").astype(np.int64)
        ints = np.where(validity[:n], ints, 0)
        data[:n] = ints
    elif pa.types.is_date32(arr.type):
        vals = arr.to_numpy(zero_copy_only=False)
        ints = vals.astype("datetime64[D]").astype(np.int64).astype(np.int32)
        ints = np.where(validity[:n], ints, 0)
        data[:n] = ints
    else:
        # no nulls: the values are read in place (no fill_null copy)
        vals = (arr.fill_null(_zero_value(dtype)) if arr.null_count
                else arr).to_numpy(zero_copy_only=False)
        data[:n] = vals.astype(np_dtype, copy=False)
    return data, validity, None, None


def _zero_value(dtype: dt.DType):
    if dtype.is_bool:
        return False
    if dtype.is_floating:
        return 0.0
    return 0


def from_arrow(table: pa.Table, min_bucket: int = 16,
               capacity: Optional[int] = None,
               device="cuda", copy_stream=None) -> DeviceBatch:
    """Upload an Arrow table into a padded DeviceBatch on ``device``.

    On the card each column is padded straight into pinned host buffers
    and copied on ``copy_stream`` (a ``columnar/transfer.CopyStream``; a
    fresh one when None) while the next column is padded; the caller's
    stream waits for the copies before anything reads them."""
    from spark_rapids_tpu_torch.columnar import transfer
    dev = resolve_device(device)
    n = table.num_rows
    cap = capacity or bucket_rows(n, min_bucket)
    if dev.type == "cuda" and copy_stream is None:
        copy_stream = transfer.CopyStream(dev)
    names, cols = [], []
    for field_, col in zip(table.schema, table.columns):
        dtype = dt.from_arrow(field_.type)
        if dtype is None:
            raise TypeError(f"unsupported Arrow type {field_.type} "
                            f"for column {field_.name}")
        if dtype == dt.NULL:
            dtype = dt.BOOL  # void columns materialize as all-null bool
        stage = transfer.PinnedStage() if copy_stream is not None else None
        host = _np_column_from_arrow(
            col, dtype, cap, stage.empty if stage is not None else np.empty)
        names.append(field_.name)
        vb, nn = _upload_hints(dtype, host[0], host[1], n)
        if stage is not None:
            up = copy_stream.upload(stage, {str(k): a for k, a in
                                            enumerate(host)
                                            if a is not None})
            up.wait()
            arrays = [up.get(str(k)) for k in range(4)]
        else:
            arrays = [_upload(a, dev) for a in host]
        cols.append(DeviceColumn(dtype, *arrays, vbits=vb, nonnull=nn))
    return DeviceBatch(names, cols, n, dev)


def _upload(a: Optional[np.ndarray], dev: torch.device):
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


_VBIT_BUCKETS = (8, 16, 24, 32, 40, 48, 56)


def bits_for_range(lo: int, hi: int):
    """Smallest vbits bucket whose signed range covers [lo, hi] (None
    when none does)."""
    for b in _VBIT_BUCKETS:
        if -(1 << (b - 1)) <= lo and hi < (1 << (b - 1)):
            return b
    return None


def _upload_hints(dtype: dt.DType, data: np.ndarray,
                  validity: np.ndarray, n: int):
    """Static hints for an uploaded column: one O(n) host pass bounds the
    valid values (see DeviceColumn.vbits) and detects no-null columns."""
    if n == 0:
        return None, True
    live_valid = validity[:n]
    nn = bool(live_valid.all())
    if (dtype.is_string or dtype.is_bool or dtype.is_list or
            not np.issubdtype(np.asarray(data).dtype, np.integer)):
        return None, nn
    vals = data[:n][live_valid] if not nn else data[:n]
    from spark_rapids_tpu_torch.exec import kernel_abi
    if vals.size == 0:
        return kernel_abi.bucket_vbits(_VBIT_BUCKETS[0]), nn
    return kernel_abi.bucket_vbits(
        bits_for_range(int(vals.min()), int(vals.max()))), nn


def _strings_to_arrow(data: np.ndarray, lengths: np.ndarray,
                      validity: np.ndarray, n: int) -> pa.Array:
    """Vectorized padded-byte-matrix -> Arrow utf8 (no per-row Python)."""
    data, lengths, validity = data[:n], lengths[:n], validity[:n]
    lens = np.where(validity, lengths, 0).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    if offsets[-1] > np.iinfo(np.int32).max:
        py = [bytes(data[i, :lens[i]]).decode("utf-8", errors="replace")
              if validity[i] else None for i in range(n)]
        return pa.array(py, type=pa.string())
    mask = np.arange(data.shape[1])[None, :] < lens[:, None]
    flat = np.ascontiguousarray(data)[mask]
    offsets = offsets.astype(np.int32)
    null_bitmap = pa.py_buffer(
        np.packbits(validity, bitorder="little").tobytes())
    return pa.Array.from_buffers(
        pa.utf8(), n,
        [None if validity.all() else null_bitmap,
         pa.py_buffer(offsets.tobytes()), pa.py_buffer(flat.tobytes())])


# ---------------------------------------------------------------------------
# Packed download
# ---------------------------------------------------------------------------

def _pack_wire_key(d: torch.Tensor) -> str:
    if d.dtype == torch.bool:
        return "uint8"
    return str(d.dtype).replace("torch.", "")


def _pack_batch_impl(batch: DeviceBatch) -> Dict[str, torch.Tensor]:
    """One buffer per wire dtype holding the row count and every column's
    data/validity/lengths/elem_validity at FULL capacity, each a flat
    view, concatenated on the batch's device."""
    bufs: Dict[str, List[torch.Tensor]] = {}

    def put(key: str, arr: torch.Tensor) -> None:
        bufs.setdefault(key, []).append(arr.reshape(-1))

    n = batch.num_rows
    put("int32", n.reshape(1).to(torch.int32) if isinstance(n, torch.Tensor)
        else torch.full((1,), int(n), dtype=torch.int32,
                        device=batch.device))
    for c in batch.columns:
        d = c.data
        put(_pack_wire_key(d), d.to(torch.uint8) if d.dtype == torch.bool
            else d)
        put("uint8", c.validity.to(torch.uint8))
        if c.lengths is not None:
            put("int32", c.lengths.to(torch.int32))
        if c.elem_validity is not None:
            put("uint8", c.elem_validity.to(torch.uint8))
    return {k: (v[0] if len(v) == 1 else torch.cat(v))
            for k, v in bufs.items()}


def _dispatch_pack(batch: DeviceBatch):
    """(layout, packed buffers) of one batch; no host read.  The layout is
    the batch's erased key (exec/kernel_abi.erased_key): the capacity and
    each column's dtype, width and element-validity flag, from which the
    host epilogue cuts the packed buffers back into columns.

    The pack is one kernel-cache dispatch keyed on that layout, over the
    name- and hint-erased batch at its own shapes (``pad=False``: the
    epilogue reads the original shapes back; ``strip_hints``: the pack
    never reads vbits/nonnull)."""
    from spark_rapids_tpu_torch.exec import kernel_abi
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    layout = kernel_abi.erased_key(batch)
    fn = kc.get_kernel(("pack_batch", layout), lambda: _pack_batch_impl)
    return layout, fn(kernel_abi.erase(batch, pad=False, strip_hints=True))


def _download_batch(batch: DeviceBatch, layout,
                    host: Dict[str, np.ndarray]):
    """Cut one batch's downloaded buffers back into columns, at the
    capacity and widths its pack layout recorded.  Returns (num_rows,
    [(data, validity, lengths, ev), ...]) as numpy arrays at full
    capacity."""
    cap, cols_layout = layout[1]
    pos = {k: 0 for k in host}

    def take(key: str, count: int):
        off = pos[key]
        pos[key] = off + count
        return host[key][off:off + count]

    n = int(take("int32", 1)[0])
    cols = []
    for c, (_name, width, has_ev) in zip(batch.columns, cols_layout):
        shape = (cap, width) if c.dtype.has_lengths else (cap,)
        count = int(np.prod(shape))
        data = take(_pack_wire_key(c.data), count).reshape(shape)
        if c.data.dtype == torch.bool:
            data = data.astype(bool)
        validity = take("uint8", cap).astype(bool)
        lengths = take("int32", cap) if c.lengths is not None else None
        ev = take("uint8", count).reshape(shape).astype(bool) \
            if has_ev else None
        cols.append((data, validity, lengths, ev))
    return n, cols


# Fixed compaction tiers: a batch with a huge capacity but few rows
# compacts to the smallest tier >= its row count, so the download moves
# rows, not padding.
_DL_TIERS = (4096, 65536, 1048576)


def _dl_tier(n: int, capacity: int):
    for t in _DL_TIERS:
        if n <= t and capacity > 4 * t:
            return t
    return None


def _read_counts(batches: Sequence[DeviceBatch]) -> None:
    """Resolve every device row count of ``batches`` with one read."""
    traced = [b for b in batches
              if not isinstance(b.num_rows, (int, np.integer))]
    if traced:
        counts = torch.stack([b.num_rows.to(torch.int64).reshape(())
                              for b in traced]).tolist()
        for b, n in zip(traced, counts):
            b.num_rows = int(n)


def _compact_for_download(batches: Sequence[DeviceBatch]):
    """Re-bucket batches whose capacity vastly exceeds their row count
    (an aggregate output that inherited a multi-million-row capacity) so
    the download moves rows, not padding: each slices to the smallest
    tier that holds its rows.  The row counts are read once for all
    batches; then every batch is packed.  (The reference builds one
    slice and one pack program per tier first; eager torch needs none.)

    The slice is a kernel-cache dispatch per (layout, tier) over the
    name-erased batch; the real names are restamped on its output.  (The
    reference also builds and warms every candidate tier once per
    process, for its tunneled runtime; the port builds the tier it
    uses.)

    Returns (batches, (layout, packed) per batch)."""
    if any(b.capacity > 4 * _DL_TIERS[0] for b in batches):
        _read_counts(batches)
    out, out_packed = [], []
    for b in batches:
        tier = _dl_tier(int(b.num_rows), b.capacity) \
            if isinstance(b.num_rows, (int, np.integer)) else None
        if tier is not None:
            b = _run_compact(b, tier)
        out.append(b)
        out_packed.append(_dispatch_pack(b))
    return out, out_packed


def _run_compact(b: DeviceBatch, tier: int) -> DeviceBatch:
    """One erased ``dl_compact`` dispatch and the host-side restamp of
    the real names (the slice gathers by position only)."""
    from spark_rapids_tpu_torch.exec import kernel_abi
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    fn = kc.get_kernel(("dl_compact", kernel_abi.erased_key(b), tier),
                       lambda: functools.partial(_slice_head, cap=tier))
    nb = fn(kernel_abi.erase(b, pad=False))
    return DeviceBatch(b.names, nb.columns, nb.num_rows, b.device)


def _slice_head(batch: DeviceBatch, cap: int) -> DeviceBatch:
    idx = torch.arange(cap, device=batch.device)
    valid = idx < batch.num_rows
    idx = torch.clamp(idx, 0, batch.capacity - 1)
    cols = [c.gather(idx, valid) for c in batch.columns]
    return DeviceBatch(batch.names, cols, batch.num_rows, batch.device)


def _download_all(packed: Sequence[Dict[str, torch.Tensor]],
                  copy_stream=None) -> List[Dict[str, np.ndarray]]:
    """Every packed buffer to the host: on the card one pinned copy per
    buffer on ``copy_stream`` (a ``columnar/transfer.CopyStream``; a
    fresh one when None) and one wait on its event; on the CPU the
    buffers are read in place."""
    devs = {t.device for p in packed for t in p.values()}
    if not devs or all(d.type == "cpu" for d in devs):
        return [{k: t.numpy() for k, t in p.items()} for p in packed]
    from spark_rapids_tpu_torch.columnar import transfer
    dev = next(iter(devs))
    if copy_stream is None:
        copy_stream = transfer.CopyStream(dev)
    return copy_stream.download(packed)


def to_arrow_all(batches: Sequence[DeviceBatch],
                 copy_stream=None) -> List[pa.Table]:
    """Convert many batches: every batch is packed before the first copy,
    and the host waits once for all copies."""
    batches, packed = _compact_for_download(batches)
    host = _download_all([p for _, p in packed], copy_stream)
    return [_to_arrow_host(b, layout, h)
            for b, (layout, _), h in zip(batches, packed, host)]


def to_arrow(batch: DeviceBatch) -> pa.Table:
    """Download a DeviceBatch to an Arrow table (strips padding), through
    one packed copy per wire dtype."""
    return to_arrow_all([batch])[0]


def _to_arrow_host(batch: DeviceBatch, layout,
                   host: Dict[str, np.ndarray]) -> pa.Table:
    n, host_cols = _download_batch(batch, layout, host)
    arrays, fields = [], []
    for name, col, (data, validity, lengths, ev) in zip(
            batch.names, batch.columns, host_cols):
        validity = validity[:n]
        mask = ~validity
        if col.dtype.is_string:
            arr = _strings_to_arrow(data, lengths, validity, n)
        elif col.dtype.is_list:
            data = data[:n]
            lens = np.where(validity, lengths[:n], 0).astype(np.int64)
            ev = np.ones(data.shape, dtype=bool) if ev is None else ev[:n]
            live = np.arange(data.shape[1])[None, :] < lens[:, None]
            offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
            el = col.dtype.to_arrow().value_type
            values = pa.array(data[live], type=el, mask=~ev[live])
            arr = pa.ListArray.from_arrays(
                pa.array(offsets), values, type=col.dtype.to_arrow(),
                mask=pa.array(mask))
        elif col.dtype.id == dt.TypeId.TIMESTAMP_US:
            arr = pa.array(data[:n].astype("datetime64[us]"),
                           type=pa.timestamp("us", tz="UTC"), mask=mask)
        elif col.dtype.id == dt.TypeId.DATE32:
            arr = pa.array(data[:n].astype("datetime64[D]"),
                           type=pa.date32(), mask=mask)
        else:
            arr = pa.array(data[:n], mask=mask)
        arrays.append(arr)
        fields.append(pa.field(name, arr.type))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _combined_hints(cols: Sequence[DeviceColumn]):
    """Hint union for concatenated columns: the widest vbits if every
    input carries one, nonnull only if every input is."""
    vbs = [c.vbits for c in cols]
    vb = max(vbs) if all(v is not None for v in vbs) else None
    return vb, all(c.nonnull for c in cols)


def _pad_rows(a: torch.Tensor, cap: int, width: Optional[int] = None):
    shape = (cap,) + ((width if width is not None else a.shape[1],)
                      if a.dim() == 2 else ())
    out = a.new_zeros(shape)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def concat_batches(batches: Sequence[DeviceBatch],
                   min_bucket: int = 16) -> DeviceBatch:
    """Device-side concatenation.  Batches whose ``num_rows`` is a device
    tensor concatenate without reading it (see _concat_batches_nosync),
    exactly where the reference keeps a traced count."""
    if any(not isinstance(b.num_rows, (int, np.integer))
           for b in batches):
        return _concat_batches_nosync(batches, min_bucket)
    batches = [b for b in batches if int(b.num_rows) > 0] or list(batches[:1])
    if len(batches) == 1:
        return batches[0]
    total = sum(int(b.num_rows) for b in batches)
    cap = bucket_rows(total, min_bucket)
    names = batches[0].names
    out_cols: List[DeviceColumn] = []
    for ci in range(len(names)):
        dtype = batches[0].columns[ci].dtype
        parts = [(b.columns[ci], int(b.num_rows)) for b in batches]
        if dtype.has_lengths:
            max_len = max(c.max_len for c, _ in parts)
            has_ev = any(c.elem_validity is not None for c, _ in parts)
            data = torch.cat([_pad_rows(c.data[:nb], nb, max_len)
                              for c, nb in parts])
            ev = None
            if has_ev:
                ev = torch.cat([_pad_rows(
                    c.elem_validity[:nb] if c.elem_validity is not None
                    else torch.ones((nb, c.max_len), dtype=torch.bool,
                                    device=c.data.device), nb, max_len)
                    for c, nb in parts])
                ev = _pad_rows(ev, cap)
            out_cols.append(DeviceColumn(
                dtype, _pad_rows(data, cap),
                _pad_rows(torch.cat([c.validity[:nb] for c, nb in parts]),
                          cap),
                _pad_rows(torch.cat([c.lengths[:nb] for c, nb in parts]),
                          cap), ev))
        else:
            vb, nn = _combined_hints([c for c, _ in parts])
            out_cols.append(DeviceColumn(
                dtype,
                _pad_rows(torch.cat([c.data[:nb] for c, nb in parts]), cap),
                _pad_rows(torch.cat([c.validity[:nb] for c, nb in parts]),
                          cap),
                None, vbits=vb, nonnull=nn))
    return DeviceBatch(names, out_cols, total, batches[0].device)


def _concat_batches_nosync(batches: Sequence[DeviceBatch],
                           min_bucket: int = 16) -> DeviceBatch:
    """Concatenate without reading any device value: the output capacity
    is the bucketed sum of input capacities, live rows compact to the
    front through one scatter of an identity map, and the result's
    num_rows is the device-side sum."""
    kept = [b for b in batches
            if not (isinstance(b.num_rows, (int, np.integer))
                    and int(b.num_rows) == 0)]
    batches = kept or list(batches[:1])
    if len(batches) == 1:
        return batches[0]
    from spark_rapids_tpu_torch.exec import kernel_abi
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    cap = bucket_rows(sum(b.capacity for b in batches), min_bucket)
    key = ("concat_nosync", cap,
           tuple(kernel_abi.erased_key(b) for b in batches))
    fn = kc.get_kernel(key, lambda: functools.partial(_concat_nosync_impl,
                                                      cap=cap))
    # schema-erased dispatch (the concat is positional); the real names
    # are restamped on the output
    out = fn(tuple(kernel_abi.erase(b, pad=False) for b in batches))
    return DeviceBatch(batches[0].names, out.columns, out.num_rows,
                       out.device)


def _concat_nosync_impl(batches: Sequence[DeviceBatch],
                        cap: int) -> DeviceBatch:
    dev = batches[0].device
    exists = torch.cat([b.row_mask() for b in batches])
    exists = _pad_rows(exists, cap)
    dest = torch.where(exists, torch.cumsum(exists.to(torch.int32), 0) - 1,
                       cap)
    src = torch.arange(cap, dtype=torch.int32, device=dev)
    order = scatter_drop(dest, src, cap)
    n_live = exists.sum()
    sorted_exists = exists[order.long()] & \
        (torch.arange(cap, device=dev) < n_live)
    names = batches[0].names
    out_cols: List[DeviceColumn] = []
    for ci in range(len(names)):
        cols = [b.columns[ci] for b in batches]
        dtype = cols[0].dtype
        if dtype.has_lengths:
            max_len = max(c.max_len for c in cols)
            has_ev = any(c.elem_validity is not None for c in cols)
            ev = None
            if has_ev:
                ev = _pad_rows(torch.cat([_pad_rows(
                    c.elem_validity if c.elem_validity is not None
                    else torch.ones((c.capacity, c.max_len),
                                    dtype=torch.bool, device=dev),
                    c.capacity, max_len) for c in cols]), cap)
            col = DeviceColumn(
                dtype,
                _pad_rows(torch.cat([_pad_rows(c.data, c.capacity, max_len)
                                     for c in cols]), cap),
                _pad_rows(torch.cat([c.validity for c in cols]), cap),
                _pad_rows(torch.cat([c.lengths for c in cols]), cap), ev)
        else:
            col = DeviceColumn(
                dtype, _pad_rows(torch.cat([c.data for c in cols]), cap),
                _pad_rows(torch.cat([c.validity for c in cols]), cap))
        # gather() zeroes data/lengths/ev where the mask is False, so the
        # padding-rows-are-zeroed contract holds as-is
        gcol = col.gather(order, sorted_exists)
        if not dtype.has_lengths:
            # the compaction maps live outputs to live inputs, so the
            # inputs' hints survive
            vb, nn = _combined_hints(cols)
            gcol = replace(gcol, vbits=vb, nonnull=nn)
        out_cols.append(gcol)
    total = sum(torch.as_tensor(b.num_rows, dtype=torch.int64, device=dev)
                for b in batches)
    return DeviceBatch(names, out_cols, total, dev)
