"""Device equi-join and nested-loop join execs.

Ported from ``spark_rapids_tpu/exec/tpu_join.py``.  The reference's
analog of ``GpuBroadcastHashJoinExec``: the build side is gathered once,
each stream batch is probed against it, and the output size is found in
two passes (count, then emit at a capacity the host picks from the
count).  Two routes, chosen per pair of batches as the reference
chooses them:

  * **probe** (``_probe_code_bits``): when every key is integer-backed
    and both sides carry value-range hints (``DeviceColumn.vbits``) whose
    biased fields and null flags pack into at most ``_PROBE_MAX_BITS``
    bits, the hash table is a dense direct-address table of that code:
    a per-code build count, one gather per stream row, and an emit that
    maps code -> build row (unique build keys) or expands match ranges
    from the build rows grouped by code (duplicated keys);
  * **sort**: the combined build+stream key space is grouped (the narrow
    code itself, or ``sortkeys.hash_group_ids``), one stable sort of
    (group id, side) brings each stream row behind its build matches,
    and segment arithmetic yields each stream row's match range.

Both routes emit row for row what the reference emits, so a float
aggregate above the join adds in the reference's order.  The host reads
the count pass's totals (one sync per probe: total and the largest match
count together; one per sort-route count) and the hash grouping's claim
rounds; both are counted in the process registry
(``join.hostSyncs``, ``join.hashRounds``), as is each pair's route
(``join.route.probe`` / ``join.route.sort``).

Every pass is a dispatch through the process kernel cache under the
reference's keys and families (:611-1023): ``probe_count`` then
``probe_emit_u`` or ``probe_bpack`` + ``shared_lexsort4`` +
``probe_emit_d`` on the probe route; ``join_pack`` + ``shared_lexsort4``
then ``count`` and ``emit`` (or ``semi``) on the sort route;
``probe_semi``; ``cross``.  Where the reference's count and emit kernels
each recompute the route's tables, the port's count step returns them
(``_ProbeTables``, ``_JoinCtx``) and the emit step takes them.  The
cached steps capture key names and constants, never a batch or the exec.

``TpuShuffledHashJoinExec`` joins co-partitioned exchange outputs
partition by partition: inner/left/semi/anti gather the build partition
once and probe it per stream batch; right and full outer joins gather
both partitions, and a full outer join takes the sort route, appending
its unmatched build rows after the pairs.  Both modes take the grace
join of ``exec/join_partition.py`` when the planner stamped an
out-of-core budget (``_oocore``) and a partition's build side measures
over it: the streamed mode re-streams the probe slices of each grace
partition, the gathered mode joins each grace partition's two sides as
single batches (the reference's branches, :805-830 and :855-870).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch,
                                                   _combined_hints,
                                                   bucket_rows,
                                                   concat_batches,
                                                   scatter_drop)
from spark_rapids_tpu_torch.exec import kernel_abi, scans, sortkeys
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, TpuExec, timed
from spark_rapids_tpu_torch.exec.tpu_aggregate import normalize_key
from spark_rapids_tpu_torch.exec.tpu_basic import compact
from spark_rapids_tpu_torch.expr import eval_tpu, ir
from spark_rapids_tpu_torch.expr.eval_tpu import ColVal
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.plan.logical import Schema

_BIG32 = int(np.iinfo(np.int32).max)  # > any position (cap-1)
_ALL_ONES = -1                        # the uint64 0xFFFF_FFFF_FFFF_FFFF


def _count(name: str, n: int = 1) -> None:
    obsreg.get_registry().inc(name, n)


def _host_ints(*xs: torch.Tensor) -> List[int]:
    """Read device scalars with one host sync (counted)."""
    _count("join.hostSyncs")
    return [int(v) for v in torch.stack(
        [x.to(torch.int64).reshape(()) for x in xs]).tolist()]


def _live(batch: DeviceBatch) -> bool:
    """Whether ``batch`` has rows: a host sync (counted) when its row
    count is still on the device."""
    if isinstance(batch.num_rows, torch.Tensor):
        return _host_ints(batch.num_rows)[0] > 0
    return int(batch.num_rows) > 0


def _gather(child: PhysicalPlan) -> Optional[DeviceBatch]:
    """Coalesce all of a child's partitions into one batch (the build
    side's RequireSingleBatch); each arriving batch is held through a
    spill handle until the concat."""
    from spark_rapids_tpu_torch.mem.spill import register_or_hold
    handles = []
    for it in child.execute():
        for b in it:
            handles.append(register_or_hold(b))
    if not handles:
        return None
    try:
        return concat_batches([h.get() for h in handles])
    finally:
        for h in handles:
            h.close()


def _canon_side(batch: DeviceBatch, prefix: str) -> DeviceBatch:
    """The ABI's erased view of one side (bucketed hints, capacity and
    widths at their tiers), renamed positionally with the side's
    ``__l*``/``__r*`` prefix so the two sides never share a name."""
    names = [f"{prefix}{i}" for i in range(batch.num_cols)]
    eb = kernel_abi.erase(batch)
    return DeviceBatch(names, eb.columns, eb.num_rows, eb.device)


def _key_vals(batch: DeviceBatch, key_names: Sequence[str]) -> List[ColVal]:
    out = []
    for k in key_names:
        c = batch.column(k)
        out.append(normalize_key(ColVal(c.dtype, c.data, c.validity,
                                        c.lengths, vbits=c.vbits,
                                        nonnull=c.nonnull)))
    return out


def _concat_colvals(a: ColVal, b: ColVal) -> ColVal:
    """Concatenate two key columns (for the combined build+stream space).

    Mismatched numeric key pairs are promoted to the common type before
    comparison (Spark's implicit cast), never truncated to one side's
    type."""
    if a.dtype.is_string:
        wa, wb = a.data.shape[1], b.data.shape[1]
        w = max(wa, wb)
        da = torch.nn.functional.pad(a.data, (0, w - wa))
        db = torch.nn.functional.pad(b.data, (0, w - wb))
        return ColVal(a.dtype, torch.cat([da, db]),
                      torch.cat([a.validity, b.validity]),
                      torch.cat([a.lengths, b.lengths]))
    out_dt = a.dtype if a.dtype == b.dtype else dt.promote(a.dtype, b.dtype)
    tgt = out_dt.to_torch()
    vb, nn = _combined_hints([a, b])
    merged = ColVal(out_dt, torch.cat([a.data.to(tgt), b.data.to(tgt)]),
                    torch.cat([a.validity, b.validity]),
                    vbits=vb, nonnull=nn)
    # float32 keys promoted to float64 need canonical NaN/-0.0 again
    return normalize_key(merged)


def _pad1(x: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, pad), value=value) if pad else x


def _narrow_key_codes(combined: List[ColVal], pad: int):
    """Equality-preserving per-row key code for narrow hinted keys (the
    biased fields and null flags of every key packed into at most 62
    bits), or None when a key is not integer-backed with a hint of at
    most 32 bits.  Equal keys share a code, so the code is the group id
    and the hash grouping is skipped."""
    fields = []
    total = 0
    for v in combined:
        vb = sortkeys.narrow_int_bits(v)
        if vb is None or vb > 32:
            return None
        kf = sortkeys.encode_fields(v, True, True, nullable=True)
        fields.extend(kf)
        total += sum(w for w, _ in kf)
    if not fields or total > 62:         # code << 1 | side fits u64
        return None
    code = None
    for w, vals in fields:               # MSB-first fold
        code = vals if code is None else (code << w) | vals
    return _pad1(code, pad)


def _join_sort_key(build: DeviceBatch, stream: DeviceBatch,
                   build_keys: Sequence[str], stream_keys: Sequence[str]):
    """(null key, exists, side, group ids, packed sort key) over the
    combined build+stream row space, padded to a capacity tier."""
    cap_b, cap_s = build.capacity, stream.capacity
    cap2 = bucket_rows(cap_b + cap_s)
    pad = cap2 - (cap_b + cap_s)
    dev = build.device
    bk = _key_vals(build, build_keys)
    sk = _key_vals(stream, stream_keys)
    combined = [_concat_colvals(b, s) for b, s in zip(bk, sk)]
    exists = _pad1(torch.cat([build.row_mask(), stream.row_mask()]), pad,
                   False)
    side = _pad1(torch.cat([
        torch.zeros(cap_b, dtype=torch.int64, device=dev),
        torch.ones(cap_s, dtype=torch.int64, device=dev)]), pad)
    seg0 = _narrow_key_codes(combined, pad)
    if seg0 is None:
        key_groups = [sortkeys.encode_keys(v, True, True)
                      for v in combined]
        words = [_pad1(w, pad) for g in key_groups for w in g]
        seg0, _ = sortkeys.hash_group_ids(words, exists)
    packed = (seg0.to(torch.int64) << 1) | side
    packed = torch.where(exists, packed, _ALL_ONES)
    null_key = torch.zeros(cap_b + cap_s, dtype=torch.bool, device=dev)
    for v in combined:
        null_key = null_key | ~v.validity
    null_key = _pad1(null_key, pad, False)
    return null_key, exists, side, seg0, packed


class _JoinCtx:
    """Combined sorted space over build+stream rows (the sort route)."""

    def __init__(self, build: DeviceBatch, stream: DeviceBatch,
                 parts, order: torch.Tensor):
        """``parts`` is ``_join_sort_key``'s output, ``order`` the shared
        sort of its packed key."""
        self.cap_b = build.capacity
        self.cap_s = stream.capacity
        null_key, exists, side, seg0, packed = parts
        cap = int(packed.shape[0])
        self.cap = cap
        dev = packed.device
        seg_sorted_raw = seg0[order]
        exists_sorted = exists[order]
        new_group = torch.cat([
            torch.ones(1, dtype=torch.bool, device=dev),
            (seg_sorted_raw[1:] != seg_sorted_raw[:-1]) |
            (exists_sorted[1:] != exists_sorted[:-1])])
        seg = torch.cumsum(new_group.to(torch.int32), 0,
                           dtype=torch.int32) - 1

        self.order = order
        self.seg = seg
        sorted_side = side[order]
        self.sorted_null_key = null_key[order]
        self.is_build = exists_sorted & (sorted_side == 0)
        self.is_stream = exists_sorted & (sorted_side == 1)
        # per-group counts and the build run's start, from cumsum diffs
        # at each group's end position and a segmented min-scan
        pos = torch.arange(cap, dtype=torch.int32, device=dev)
        nxt_new = torch.cat([new_group[1:],
                             torch.ones(1, dtype=torch.bool, device=dev)])
        end_pos = scatter_drop(torch.where(nxt_new, seg, cap), pos,
                               cap).long()

        def per_group_count(mask):
            c = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
            ce = c[end_pos]
            return ce - torch.cat([ce[:1] * 0, ce[:-1]])

        match_build = self.is_build & ~self.sorted_null_key
        self.b_count = per_group_count(match_build)
        run_min = scans.seg_scan(
            torch.minimum, new_group,
            torch.where(match_build, pos, _BIG32), _BIG32)
        self.build_start = run_min[end_pos]
        match_stream = self.is_stream & ~self.sorted_null_key
        self.s_count = per_group_count(match_stream)
        # per sorted-row match count (stream rows only)
        self.m = torch.where(match_stream, self.b_count[seg.long()], 0)

    def unmatched_build(self) -> torch.Tensor:
        """Sorted build rows no stream row matches (a full outer join
        emits them after the pairs); a null-key build row never
        matches."""
        return self.is_build & (self.s_count[self.seg.long()] == 0)


def _pairs_layout(ctx: _JoinCtx, outer: bool):
    """Per-sorted-row emission count and its inclusive cumsum."""
    if outer:
        m_out = torch.where(ctx.is_stream, torch.clamp(ctx.m, min=1), 0)
    else:
        m_out = torch.where(ctx.is_stream, ctx.m, 0)
    return m_out, torch.cumsum(m_out.to(torch.int64), 0)


def _emit(build: DeviceBatch, stream: DeviceBatch, ctx: _JoinCtx,
          m_out: torch.Tensor, incl: torch.Tensor, out_cap: int,
          build_first: bool, full: bool = False) -> DeviceBatch:
    """Pass 2 of the sort route: the joined batch at capacity out_cap.
    A full outer join appends the unmatched build rows after the pairs,
    in sorted-build order (a cumsum and a scatter, no sort)."""
    dev = incl.device
    total_pairs = incl[-1]
    k = torch.arange(out_cap, dtype=torch.int64, device=dev)
    # slot -> sorted stream row: each emitting row's index lands at its
    # first output slot, then a running max forward-fills
    starts = incl - m_out
    marks = torch.zeros(out_cap + sortkeys.DUMP_SLOTS, dtype=torch.int64,
                        device=dev)
    marks.scatter_reduce_(
        0, sortkeys.dump_where((m_out > 0) & (starts < out_cap), starts,
                               out_cap),
        torch.arange(ctx.cap, dtype=torch.int64, device=dev), "amax")
    r = torch.clamp(torch.cummax(marks[:out_cap], 0).values, 0,
                    ctx.cap - 1)
    j = k - starts[r]
    valid_pair = k < total_pairs

    stream_orig = torch.clamp(ctx.order[r] - ctx.cap_b, 0, ctx.cap_s - 1)
    has_match = ctx.m[r] > 0
    bpos = torch.clamp(ctx.build_start[ctx.seg[r].long()] + j, 0,
                       ctx.cap - 1)
    build_orig = torch.clamp(ctx.order[bpos], 0, ctx.cap_b - 1)
    build_valid = valid_pair & has_match
    num_rows = total_pairs
    if full:
        unmatched = ctx.unmatched_build()
        u_count = unmatched.to(torch.int64).sum()
        u_dest = torch.where(
            unmatched, torch.cumsum(unmatched.to(torch.int32), 0) - 1,
            ctx.cap)
        u_order = scatter_drop(u_dest, torch.arange(
            ctx.cap, dtype=torch.int32, device=dev), ctx.cap)
        tail_pos = u_order[torch.clamp(k - total_pairs, 0,
                                       ctx.cap - 1)].long()
        in_tail = (k >= total_pairs) & (k < total_pairs + u_count)
        build_orig = torch.where(
            in_tail, torch.clamp(ctx.order[tail_pos], 0, ctx.cap_b - 1),
            build_orig)
        build_valid = build_valid | in_tail
        num_rows = total_pairs + u_count
    s_cols = [c.gather(stream_orig, valid_pair) for c in stream.columns]
    b_cols = [c.gather(build_orig, build_valid) for c in build.columns]
    return _assemble(build, stream, b_cols, s_cols, num_rows, build_first)


def _assemble(build, stream, b_cols, s_cols, num_rows,
              build_first: bool) -> DeviceBatch:
    if build_first:
        names, cols = list(build.names) + list(stream.names), b_cols + s_cols
    else:
        names, cols = list(stream.names) + list(build.names), s_cols + b_cols
    return DeviceBatch(names, cols, num_rows, stream.device)


def _semi(stream: DeviceBatch, ctx: _JoinCtx, anti: bool) -> DeviceBatch:
    """Sort-route semi/anti join: each stream row's match count scattered
    back to its original position."""
    m_orig = torch.zeros(ctx.cap, dtype=ctx.m.dtype, device=ctx.m.device)
    m_orig[ctx.order] = ctx.m
    m_stream = m_orig[ctx.cap_b:ctx.cap_b + ctx.cap_s]
    keep = (m_stream == 0) if anti else (m_stream > 0)
    return compact(stream, keep)


# ---------------------------------------------------------------------------
# Direct-address probe route (narrow keys)
# ---------------------------------------------------------------------------

_PROBE_MAX_BITS = 22    # direct table <= 4M entries


def _probe_code_bits(build: DeviceBatch, stream: DeviceBatch,
                     build_keys: Sequence[str],
                     stream_keys: Sequence[str]) -> Optional[int]:
    """Static (host-side) width of the packed direct-address code, or None
    when the narrow encoding does not apply: 1 null bit + vbits value
    bits per key, every key integer-backed with a hint on both sides."""
    total = 0
    for kb_, ks in zip(build_keys, stream_keys):
        b, s = build.column(kb_), stream.column(ks)
        for c in (b, s):
            if c.dtype.is_string or c.dtype.is_floating or \
                    c.dtype.is_bool or c.dtype.is_nested or \
                    c.dtype.is_temporal:
                return None
        out_dt = b.dtype if b.dtype == s.dtype \
            else dt.promote(b.dtype, s.dtype)
        if not out_dt.is_numeric or out_dt.is_floating:
            return None
        vb, _nn = _combined_hints([b, s])
        npd = np.dtype(out_dt.to_np())
        vb = min(vb or 64, npd.itemsize * 8)
        if vb > 32:
            return None
        total += vb + 1                     # null flag + biased value
    return total if total else None


class _ProbeTables:
    """Per-side codes, valid masks, the dense per-code build count table
    and each stream row's match count."""

    def __init__(self, build: DeviceBatch, stream: DeviceBatch,
                 build_keys: Sequence[str], stream_keys: Sequence[str],
                 bits: int):
        bk = _key_vals(build, build_keys)
        sk = _key_vals(stream, stream_keys)
        combined = [_concat_colvals(b, s) for b, s in zip(bk, sk)]
        code = _narrow_key_codes(combined, 0)
        null_key = torch.zeros(code.shape[0], dtype=torch.bool,
                               device=code.device)
        for v in combined:
            null_key = null_key | ~v.validity
        cap_b = build.capacity
        T = 1 << bits
        self.T = T
        self.bcode = code[:cap_b]
        self.scode = code[cap_b:]
        self.bvalid = build.row_mask() & ~null_key[:cap_b]
        self.svalid = stream.row_mask() & ~null_key[cap_b:]
        # invalid build rows count into spare slots past T, which drop
        # (the reference's .at[...].add(1, mode="drop"))
        cnt = torch.zeros(T + sortkeys.DUMP_SLOTS, dtype=torch.int32,
                          device=code.device)
        cnt.index_add_(0, sortkeys.dump_where(self.bvalid, self.bcode, T),
                       torch.ones(cap_b, dtype=torch.int32,
                                  device=code.device))
        self.cnt = cnt[:T]
        self.m = torch.where(self.svalid, self.cnt[self.scode], 0)


def _probe_totals(stream: DeviceBatch, pt: _ProbeTables, how: str):
    """(total output rows, the largest per-stream-row match count) as
    device scalars."""
    m_out = torch.where(stream.row_mask(), torch.clamp(pt.m, min=1), 0) \
        if how == "left" else pt.m
    return m_out.to(torch.int64).sum(), pt.m.max()


def _probe_emit_unique(build: DeviceBatch, stream: DeviceBatch,
                       pt: _ProbeTables, how: str, out_cap: int,
                       build_first: bool) -> DeviceBatch:
    """Emit when every matched build key is unique (max match count <= 1):
    the dense table maps code -> build row directly; output rows are the
    stream rows (left and inner_inplace: in place; inner: compacted)."""
    cap_b, cap_s = build.capacity, stream.capacity
    dev = stream.device
    # row+1 table: 0 = no build row, ONE gather gives the flag and the row
    rows1 = scatter_drop(torch.where(pt.bvalid, pt.bcode, pt.T),
                         torch.arange(1, cap_b + 1, dtype=torch.int32,
                                      device=dev), pt.T)
    hit = torch.where(pt.svalid, rows1[pt.scode], 0)
    matched = hit > 0
    build_row = torch.clamp(hit - 1, 0, cap_b - 1)
    if how in ("left", "inner_inplace"):
        # inner_inplace: every stream row matched (the host saw total ==
        # stream rows), so the output rows ARE the stream rows
        s_cols = list(stream.columns)
        b_cols = [c.gather(build_row, matched) for c in build.columns]
        total_out = stream.num_rows
    else:
        keep = matched
        count = keep.to(torch.int64).sum()
        dest = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0) - 1,
                           out_cap)
        src = scatter_drop(dest, torch.arange(cap_s, dtype=torch.int32,
                                              device=dev), out_cap)
        out_valid = torch.arange(out_cap, device=dev) < count
        s_cols = [c.gather(src, out_valid) for c in stream.columns]
        br = build_row[src.long()]
        b_cols = [c.gather(br, out_valid) for c in build.columns]
        total_out = count
    return _assemble(build, stream, b_cols, s_cols, total_out, build_first)


def _probe_emit_dup(build: DeviceBatch, stream: DeviceBatch,
                    pt: _ProbeTables, grouped_rows: torch.Tensor, how: str,
                    out_cap: int, build_first: bool) -> DeviceBatch:
    """Emit with duplicated build keys: build rows grouped by code
    (``grouped_rows``, the stable sort of ``_probe_bpack``), match ranges from
    the dense start/count tables, the expansion by cumsum, a scatter and
    a running-max forward fill."""
    cap_b, cap_s = build.capacity, stream.capacity
    dev = stream.device
    starts_tbl = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(pt.cnt.to(torch.int64), 0)[:-1]])
    st = torch.where(pt.svalid, starts_tbl[pt.scode], 0)

    m_out = torch.where(stream.row_mask(), torch.clamp(pt.m, min=1), 0) \
        if how == "left" else pt.m
    incl = torch.cumsum(m_out.to(torch.int64), 0)
    total_out = incl[-1]
    starts_out = incl - m_out
    k = torch.arange(out_cap, dtype=torch.int64, device=dev)
    marks = torch.zeros(out_cap + sortkeys.DUMP_SLOTS, dtype=torch.int64,
                        device=dev)
    marks.scatter_reduce_(
        0, sortkeys.dump_where((m_out > 0) & (starts_out < out_cap),
                               starts_out, out_cap),
        torch.arange(cap_s, dtype=torch.int64, device=dev), "amax")
    r = torch.clamp(torch.cummax(marks[:out_cap], 0).values, 0, cap_s - 1)
    j = k - starts_out[r]
    valid_pair = k < total_out
    has_match = pt.m[r] > 0
    bpos = torch.clamp(st[r] + j, 0, cap_b - 1)
    build_row = torch.clamp(grouped_rows[bpos], 0, cap_b - 1)
    s_cols = [c.gather(r, valid_pair) for c in stream.columns]
    b_cols = [c.gather(build_row, valid_pair & has_match)
              for c in build.columns]
    return _assemble(build, stream, b_cols, s_cols, total_out, build_first)


def _side_key(batch: DeviceBatch):
    """Erased cache-key component for one (already canonical) side."""
    return kernel_abi.erased_key(batch)


def _sort_count(build, stream, order, parts, how: str):
    """The sort route's count step: the combined-space context, each
    sorted row's emission count, its inclusive cumsum and the output
    row total (a device scalar)."""
    ctx = _JoinCtx(build, stream, parts, order)
    m_out, incl = _pairs_layout(ctx, how in ("left", "full"))
    n_out = incl[-1]
    if how == "full":
        n_out = n_out + ctx.unmatched_build().to(torch.int64).sum()
    return ctx, m_out, incl, n_out


def _probe_count(build, stream, bkeys, skeys, how: str, bits: int):
    """The probe route's count step: the tables, the output row total
    and the largest per-row match count (device scalars)."""
    pt = _ProbeTables(build, stream, bkeys, skeys, bits)
    total, maxm = _probe_totals(stream, pt, how)
    return pt, total, maxm


def _probe_bpack(pt: "_ProbeTables") -> torch.Tensor:
    """Build codes as one sort word, invalid rows last."""
    return torch.where(pt.bvalid, pt.bcode, 0xFFFFFFFF).reshape(1, -1)


def _check_total(total: int) -> None:
    if total >= (1 << 31):
        raise MemoryError(
            f"join output of {total} rows exceeds the single-batch "
            f"2^31 limit; repartition the inputs")


class _BroadcastBuildMixin:
    """Caches the one-time gather of the broadcast (build) side, held
    through a spill handle while the stream partitions probe it.  The
    handle closes when the last stream partition of an ``execute`` ends
    (the reference leaves it to the garbage collector), so a finished
    query leaves nothing in the spill catalog."""

    def _init_build(self, build_side: str) -> None:
        self.build_side = build_side
        self._built = None
        self._build_done = False
        self._build_lock = threading.Lock()
        self._open_parts = 0

    def _stream_parts(self, sits, run):
        """``run`` over each stream partition; the build's handle closes
        once every partition ended."""
        with self._build_lock:
            self._open_parts += len(sits)

        def part(sit):
            try:
                yield from run(sit)
            finally:
                with self._build_lock:
                    self._open_parts -= 1
                    if self._open_parts == 0 and self._built is not None:
                        self._built.close()
                        self._built = None
                        self._build_done = False
        return [part(it) for it in sits]

    def _build(self):
        # concurrent stream partitions gather the build side once; it is
        # held through the whole probe phase
        from spark_rapids_tpu_torch.mem.spill import register_or_hold
        with self._build_lock:
            if not self._build_done:
                side = 1 if self.build_side == "right" else 0
                built = _gather(self.children[side])
                self._built = None if built is None \
                    else register_or_hold(built)
                self._build_done = True
        return None if self._built is None else self._built.get()


class _HashJoinBase(TpuExec):
    """Shared probe machinery of the hash joins."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 how: str, condition: Optional[ir.Expression],
                 schema: Schema):
        super().__init__()
        self.children = (left, right)
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how
        self.condition = condition
        self._schema = schema
        self._kernels = {}

    @property
    def schema(self) -> Schema:
        return self._schema

    def _kernel(self, key, factory):
        """The cached step of ``key``, memoized per exec."""
        k = self._kernels.get(key)
        if k is None:
            from spark_rapids_tpu_torch.exec import kernel_cache as kc
            k = self._kernels[key] = kc.get_kernel(key, factory)
        return k

    def _sort_order(self, build: DeviceBatch, stream: DeviceBatch,
                    bkeys, skeys):
        """(combined-space sort order, ``_join_sort_key`` parts): a
        per-schema ``join_pack`` step feeding the shared per-capacity
        sort step."""
        bk, sk = list(bkeys), list(skeys)
        pack = self._kernel(
            ("join_pack", tuple(bkeys), tuple(skeys), _side_key(build),
             _side_key(stream)),
            lambda: lambda b, s: _join_sort_key(b, s, bk, sk))
        parts = pack(build, stream)
        return sortkeys.shared_lexsort(parts[4].reshape(1, -1)), parts

    def _route(self, name: str) -> None:
        self.metrics.add_extra(name, 1)
        _count(name)

    def _finish(self, out: DeviceBatch, semi: bool = False):
        """Restamp the join's names and apply its condition (the
        reference applies none to a semi or anti join's output)."""
        out = DeviceBatch(self._schema.names, out.columns, out.num_rows,
                          out.device)
        if self.condition is not None and not semi:
            v = eval_tpu.evaluate(self.condition, out)
            out = compact(out, v.data.to(torch.bool) & v.validity)
        self.metrics.add_rows(out.num_rows)
        self.metrics.add_batches()
        return out

    def _probe_pair(self, build: DeviceBatch, stream: DeviceBatch,
                    bkeys, skeys, emit_how: str, build_first: bool,
                    bits: int):
        """Direct-address probe join (narrow keys): count, then the host
        picks the unique or duplicated-build-key emit."""
        self._route("join.route.probe")
        bk, sk = list(bkeys), list(skeys)
        sig = (bits, emit_how, tuple(bkeys), tuple(skeys),
               _side_key(build), _side_key(stream))
        count = self._kernel(
            ("probe_count",) + sig,
            lambda: lambda b, s: _probe_count(b, s, bk, sk, emit_how, bits))
        with timed(self.metrics, "join.probeCount"):
            pt, total, maxm = count(build, stream)
            total, maxm = _host_ints(total, maxm)
        _check_total(total)
        with timed(self.metrics, "join.probeEmit"):
            if maxm <= 1:
                variant = emit_how
                if emit_how == "inner" and \
                        isinstance(stream.num_rows, (int, np.integer)) and \
                        total == int(stream.num_rows):
                    variant = "inner_inplace"   # FK join: all rows match
                out_cap = bucket_rows(stream.capacity) \
                    if variant != "inner" else bucket_rows(total)
                emit = self._kernel(
                    ("probe_emit_u", variant, out_cap, build_first) + sig,
                    lambda: lambda b, s, t: _probe_emit_unique(
                        b, s, t, variant, out_cap, build_first))
                out = emit(build, stream, pt)
            else:
                out_cap = bucket_rows(total)
                bpack = self._kernel(("probe_bpack",) + sig,
                                     lambda: lambda b, s, t: _probe_bpack(t))
                emit = self._kernel(
                    ("probe_emit_d", out_cap, build_first) + sig,
                    lambda: lambda b, s, t, o: _probe_emit_dup(
                        b, s, t, o, emit_how, out_cap, build_first))
                border = sortkeys.shared_lexsort(bpack(build, stream, pt))
                out = emit(build, stream, pt, border)
        yield self._finish(out)

    def _join_pair(self, left: DeviceBatch, right: DeviceBatch,
                   build_side: str = "right"):
        """Join two single batches; yields one output batch."""
        how = self.how
        # positional __l*/__r* names: no duplicate-name lookups
        lkeys = [f"__l{left.names.index(k)}" for k in self.left_keys]
        rkeys = [f"__r{right.names.index(k)}" for k in self.right_keys]
        left = _canon_side(left, "__l")
        right = _canon_side(right, "__r")

        if how in ("semi", "anti"):
            anti = how == "anti"
            bits = _probe_code_bits(right, left, rkeys, lkeys)
            with timed(self.metrics, "join.semi"):
                if bits is not None and bits <= _PROBE_MAX_BITS:
                    self._route("join.route.probe")

                    def probe_semi(b, s):
                        pt = _ProbeTables(b, s, rkeys, lkeys, bits)
                        keep = (pt.m == 0) if anti else (pt.m > 0)
                        return compact(s, keep & s.row_mask())
                    semi = self._kernel(
                        ("probe_semi", how, bits, tuple(lkeys),
                         tuple(rkeys), _side_key(left), _side_key(right)),
                        lambda: probe_semi)
                    out = semi(right, left)
                else:
                    self._route("join.route.sort")
                    semi = self._kernel(
                        ("semi", how, tuple(lkeys), tuple(rkeys),
                         _side_key(left), _side_key(right)),
                        lambda: lambda b, s, o, g: _semi(
                            s, _JoinCtx(b, s, g, o), anti))
                    order, parts = self._sort_order(right, left, rkeys,
                                                    lkeys)
                    out = semi(right, left, order, parts)
            yield self._finish(out, semi=True)
            return

        if build_side == "left" or how == "right":
            # right outer == left outer with the sides swapped
            build, stream = left, right
            bkeys, skeys = lkeys, rkeys
            emit_how = "left" if how == "right" else how
            build_first = True
        else:
            build, stream = right, left
            bkeys, skeys = rkeys, lkeys
            emit_how = how
            build_first = False
        full = emit_how == "full"
        # the probe route serves inner and left only
        bits = _probe_code_bits(build, stream, bkeys, skeys)
        if bits is not None and bits <= _PROBE_MAX_BITS and not full:
            yield from self._probe_pair(build, stream, bkeys, skeys,
                                        emit_how, build_first, bits)
            return
        self._route("join.route.sort")
        count = self._kernel(
            ("count", emit_how, tuple(bkeys), tuple(skeys),
             _side_key(build), _side_key(stream)),
            lambda: lambda b, s, o, g: _sort_count(b, s, o, g, emit_how))
        with timed(self.metrics, "join.count"):
            order, parts = self._sort_order(build, stream, bkeys, skeys)
            ctx, m_out, incl, n_out = count(build, stream, order, parts)
            (total,) = _host_ints(n_out)
        _check_total(total)
        out_cap = bucket_rows(total)
        emit = self._kernel(
            ("emit", emit_how, out_cap, tuple(bkeys), tuple(skeys),
             build_first, _side_key(build), _side_key(stream)),
            lambda: lambda b, s, c, m, i: _emit(b, s, c, m, i, out_cap,
                                                build_first, full))
        with timed(self.metrics, "join.emit"):
            out = emit(build, stream, ctx, m_out, incl)
        yield self._finish(out)


class TpuBroadcastHashJoinExec(_BroadcastBuildMixin, _HashJoinBase):
    """Equi-join with the build side broadcast: gathered once across all
    its partitions, then probed per stream batch so the stream side stays
    partitioned."""

    def __init__(self, *args, build_side: str = "right",
                 transport: str = "local"):
        super().__init__(*args)
        self._init_build(build_side)
        self.transport = transport

    def _build_for(self):
        if self.transport in ("ici", "ici_ring"):
            # the reference replicates the build side over the device
            # mesh with one broadcast (shuffle/ici.py)
            raise NotImplementedError(
                f"a broadcast join under shuffle.transport="
                f"{self.transport} needs spark_rapids_tpu/shuffle/ici.py, "
                f"which the torch port has not ported yet")
        return self._build()

    def execute(self):
        stream_side = 0 if self.build_side == "right" else 1
        sits = self.children[stream_side].execute()

        def run(sit):
            # materialize the build side BEFORE pulling any stream batch:
            # stream scans hold the device semaphore across their yield,
            # and the build side's own scan acquiring it then would
            # deadlock the task pool
            build = self._build_for()
            for sb in sit:
                if not _live(sb):
                    continue
                b = build if build is not None else _empty_like(
                    self.children[1 - stream_side].schema, sb.device)
                if self.build_side == "right":
                    yield from self._join_pair(sb, b, "right")
                else:
                    yield from self._join_pair(b, sb, "left")

        return self._stream_parts(sits, run)


class TpuShuffledHashJoinExec(_HashJoinBase):
    """Equi-join over co-partitioned children (the hash exchanges the
    planner put on both sides): each partition pair joins on its own.

    ``_oocore`` is the planner's out-of-core stamp
    (exec/join_partition.resolve_oocore): when set, a partition whose
    build side measures over its budget takes the grace join; None (an
    unstamped join, or the keys off) keeps the unconditional gather."""

    def execute(self):
        from spark_rapids_tpu_torch.mem.spill import register_or_hold
        lits = self.children[0].execute()
        rits = self.children[1].execute()
        if len(lits) != len(rits):
            raise ValueError(f"join children not co-partitioned: "
                             f"{len(lits)} vs {len(rits)}")
        oocore = getattr(self, "_oocore", None)

        def run_streamed(lit, rit):
            """inner/left/semi/anti: the build partition gathered once and
            held while each stream batch probes it."""
            if oocore is not None:
                rbs = [b for b in rit if int(b.num_rows)]
                build_bytes = sum(int(b.nbytes()) for b in rbs)
                if rbs and build_bytes > oocore["budget"]:
                    from spark_rapids_tpu_torch.exec import join_partition
                    yield from join_partition.grace_join(
                        self, lit, rbs, build_bytes, oocore,
                        build_is_left=False, gathered=False)
                    return
                right = concat_batches(rbs) if rbs else None
            else:
                right = _gather_partition(rit)
            if right is None and self.how == "inner":
                for _ in lit:       # nothing can match; drain the stream
                    pass
                return
            rh = None if right is None else register_or_hold(right)
            try:
                for lb in lit:
                    if not _live(lb):
                        continue
                    build = rh.get() if rh is not None else _empty_like(
                        self.children[1].schema, lb.device)
                    yield from self._join_pair(lb, build)
            finally:
                if rh is not None:
                    rh.close()

        def run_gathered(lit, rit):
            """right/full: unmatched rows need every batch of the pair, so
            both partitions join as single batches."""
            if oocore is not None:
                lbs = [b for b in lit if int(b.num_rows)]
                rbs = [b for b in rit if int(b.num_rows)]
                # _join_pair's build side: a right outer join builds on
                # the LEFT (the swapped left outer), a full one on the
                # right
                build_is_left = self.how == "right"
                bbs = lbs if build_is_left else rbs
                build_bytes = sum(int(b.nbytes()) for b in bbs)
                if bbs and build_bytes > oocore["budget"]:
                    from spark_rapids_tpu_torch.exec import join_partition
                    yield from join_partition.grace_join(
                        self, rbs if build_is_left else lbs, bbs,
                        build_bytes, oocore, build_is_left=build_is_left,
                        gathered=True)
                    return
                left = concat_batches(lbs) if lbs else None
                right = concat_batches(rbs) if rbs else None
            else:
                left = _gather_partition(lit)
                right = _gather_partition(rit)
            if left is None and right is None:
                return
            dev = (left if left is not None else right).device
            if left is None:
                left = _empty_like(self.children[0].schema, dev)
            if right is None:
                right = _empty_like(self.children[1].schema, dev)
            yield from self._join_pair(left, right)

        run = run_gathered if self.how in ("right", "full") \
            else run_streamed
        return [run(lit, rit) for lit, rit in zip(lits, rits)]


def _empty_like(schema: Schema, device) -> DeviceBatch:
    """A 0-row device batch (for outer joins against an empty side)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import from_arrow
    t = pa.Table.from_arrays(
        [pa.array([], type=f.dtype.to_arrow()) for f in schema.fields],
        names=schema.names)
    return from_arrow(t, device=device)


def _gather_partition(it) -> Optional[DeviceBatch]:
    batches = [b for b in it if int(b.num_rows)]
    return concat_batches(batches) if batches else None


class _NestedLoopBase(TpuExec):
    """Shared cross-product step (Table.crossJoin + filter analog)."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 condition: Optional[ir.Expression], schema: Schema):
        super().__init__()
        self.children = (left, right)
        self.condition = condition
        self._schema = schema
        self._kernels = {}

    @property
    def schema(self) -> Schema:
        return self._schema

    def _cross_pair(self, left: DeviceBatch, right: DeviceBatch):
        nl, nr = int(left.num_rows), int(right.num_rows)
        if nl == 0 or nr == 0:
            return
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        from spark_rapids_tpu_torch.exec.fused_stage import canonical_names
        # the step builds positional names (the condition reads by
        # ordinal); the schema's are restamped after
        left = _canon_side(left, "__l")
        right = _canon_side(right, "__r")
        n_out = left.num_cols + right.num_cols
        out_cap = bucket_rows(nl * nr)
        cond = self.condition
        key = ("cross", out_cap, kc.expr_sig(cond), _side_key(left),
               _side_key(right))
        if key not in self._kernels:
            def impl(lb, rb, n_l, n_r):
                dev = lb.device
                k = torch.arange(out_cap, dtype=torch.int64, device=dev)
                li = torch.clamp(k // max(n_r, 1), 0, lb.capacity - 1)
                ri = torch.clamp(k % max(n_r, 1), 0, rb.capacity - 1)
                valid = k < n_l * n_r
                cols = [c.gather(li, valid) for c in lb.columns] + \
                    [c.gather(ri, valid) for c in rb.columns]
                out = DeviceBatch(canonical_names(n_out), cols, n_l * n_r,
                                  dev)
                if cond is not None:
                    v = eval_tpu.evaluate(cond, out)
                    out = compact(out, v.data.to(torch.bool) & v.validity)
                return out
            self._kernels[key] = kc.get_kernel(key, lambda: impl)
        with timed(self.metrics, "join.nestedLoop"):
            out = self._kernels[key](left, right, nl, nr)
        out = DeviceBatch(self._schema.names, out.columns, out.num_rows,
                          out.device)
        self.metrics.add_rows(out.num_rows)
        self.metrics.add_batches()
        yield out


class TpuBroadcastNestedLoopJoinExec(_BroadcastBuildMixin, _NestedLoopBase):
    """Cross join (+ optional condition) with one side broadcast: the
    stream side keeps its partitioning, the build side is gathered once."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 condition: Optional[ir.Expression], schema: Schema,
                 build_side: str = "right"):
        super().__init__(left, right, condition, schema)
        self._init_build(build_side)

    def execute(self):
        stream_side = 0 if self.build_side == "right" else 1
        sits = self.children[stream_side].execute()

        def run(sit):
            build = self._build()
            if build is None:
                return
            for sb in sit:
                if not int(sb.num_rows):
                    continue
                if stream_side == 0:
                    yield from self._cross_pair(sb, build)
                else:
                    yield from self._cross_pair(build, sb)

        return self._stream_parts(sits, run)


class TpuCartesianProductExec(_NestedLoopBase):
    """Partition-pairwise cross join: output partition (i, j) crosses left
    partition i with right partition j.

    Each side's partition is gathered once and shared by every pair it
    takes part in.  The pairs run on concurrent task threads, so the
    gather of a partition holds a lock: the reference's unlocked cache
    lets two threads drain one partition's iterator at once ("generator
    already executing"; ROADMAP Queue C)."""

    def execute(self):
        lits = self.children[0].execute()
        rits = self.children[1].execute()
        cache: dict = {}
        lock = threading.Lock()
        locks = {("l", i): threading.Lock() for i in range(len(lits))}
        locks.update({("r", j): threading.Lock() for j in range(len(rits))})

        def side(key, it) -> Optional[DeviceBatch]:
            with locks[key]:
                with lock:
                    if key in cache:
                        return cache[key]
                got = _gather_partition(it)
                with lock:
                    cache[key] = got
                return got

        def run(i, lit, j, rit):
            left = side(("l", i), lit)
            right = side(("r", j), rit)
            if left is None or right is None:
                return
            yield from self._cross_pair(left, right)

        return [run(i, lit, j, rit)
                for i, lit in enumerate(lits)
                for j, rit in enumerate(rits)]
