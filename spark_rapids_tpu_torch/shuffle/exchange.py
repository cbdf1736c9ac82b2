"""Shuffle exchange execs and the four partitionings.

Ported from ``spark_rapids_tpu/shuffle/exchange.py``: the partitionings
(:65-110), the device targets (murmur3 pmod ``hash_targets``, the
exact-rank ``range_targets_from_order`` / ``_range_spans`` with equal-key
groups kept in one span, ``round_robin_targets``), the reorder and slice
of ``TpuShuffleExchangeExec`` (one stable sort of the targets, then one
contiguous span per output partition; padding rows target ``n_parts`` and
park after every span), ``ShuffleBlockStore``, the host exchange
``CpuShuffleExchangeExec`` and the coalesce execs.  The reference does
this work with XLA ops and no Pallas kernel; the port composes torch ops.

``TpuShuffleExchangeExec`` runs two of the reference's transports:

  * ``local``: each map batch's slices are downloaded together (one
    packed ``to_arrow_all``), Arrow-IPC-serialized with the configured
    codec into the in-process block store, and on read concatenated and
    uploaded once per reducer (``exchange.upload``);
  * ``device``: the slices stay on the card and each reducer
    concatenates its own (``exchange.concat``).

The map side runs once, under a lock, in whichever reducer thread asks
first; one host read per map batch fetches its per-partition counts
(``exchange.partition``).  The other transports raise
``NotImplementedError`` naming the reference module that serves them:
``manager`` (``shuffle/manager.py``), ``process``
(``shuffle/executor_proc.py``) and ``ici``/``ici_ring``
(``shuffle/ici.py``).

``skew_map_side`` (reference :765) runs the same map side without the
reduce concat for the skew join reader of ``exec/adaptive.py``: blocks
stay per (map, reduce bucket) and each map's per-bucket sizes aggregate
at a ``_MapOutputTracker`` as the map completes.  Each bucket's total
lands in the ``shuffle.exchange.bucketBytes`` histogram.
"""

from __future__ import annotations

import functools
import itertools
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, bucket_rows,
                                                   concat_batches,
                                                   from_arrow, to_arrow_all)
from spark_rapids_tpu_torch.exec import sortkeys
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, TpuExec, timed
from spark_rapids_tpu_torch.exec.cpu import concat_tables
from spark_rapids_tpu_torch.expr import eval_cpu, eval_tpu, ir
from spark_rapids_tpu_torch.obs import registry as obsreg
from spark_rapids_tpu_torch.plan.logical import Schema, SortOrder
from spark_rapids_tpu_torch.sched import cancel as _cancel
from spark_rapids_tpu_torch.shuffle.serializer import (deserialize_table,
                                                       get_codec,
                                                       serialize_table)

# the transports this port does not run, and the reference module each
# needs
UNPORTED_TRANSPORTS = {"manager": "shuffle/manager.py",
                       "process": "shuffle/executor_proc.py",
                       "ici": "shuffle/ici.py",
                       "ici_ring": "shuffle/ici.py"}


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs spark_rapids_tpu/{module}, which the torch port "
        f"has not ported yet")


# ---------------------------------------------------------------------------
# Partitioning specs
# ---------------------------------------------------------------------------

@dataclass
class Partitioning:
    num_partitions: int

    def exprs(self) -> List[ir.Expression]:
        return []

    def cache_sig(self) -> Any:
        """Kernel-cache signature: everything the target step closes
        over.  Subclasses with extra state (sort direction, null
        ordering) extend it."""
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        return kc.exprs_sig(self.exprs())


@dataclass
class SinglePartitioning(Partitioning):
    pass


@dataclass
class HashPartitioning(Partitioning):
    keys: List[ir.Expression] = None

    def exprs(self) -> List[ir.Expression]:
        return list(self.keys)


@dataclass
class RoundRobinPartitioning(Partitioning):
    pass


@dataclass
class RangePartitioning(Partitioning):
    orders: List[SortOrder] = None

    def exprs(self) -> List[ir.Expression]:
        return [o.expr for o in self.orders]

    def cache_sig(self) -> Any:
        # the direction and null order shape the encoded keys: an ASC step
        # must not serve a DESC order of the same expression
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        return tuple((kc.expr_sig(o.expr), o.ascending,
                      o.nulls_first_resolved) for o in self.orders)


# ---------------------------------------------------------------------------
# Device-side target computation
# ---------------------------------------------------------------------------

def hash_targets(batch: DeviceBatch, keys: Sequence[ir.Expression],
                 n_parts: int) -> torch.Tensor:
    """Spark murmur3(seed=42) pmod targets (floored, as ``jnp``'s %)."""
    h = torch.full((batch.capacity,), 42, dtype=torch.int32,
                   device=batch.device)
    for k in keys:
        h = eval_tpu.hash_colval(eval_tpu.evaluate(k, batch), h)
    return torch.remainder(h, n_parts).to(torch.int32)


def range_targets_from_order(batch: DeviceBatch,
                             orders: Sequence[SortOrder],
                             order: torch.Tensor,
                             n_parts: int) -> torch.Tensor:
    """Exact-rank range targets with equal-key group cohesion, the sort
    already done; re-derives the key groups for the boundaries only."""
    key_groups = [sortkeys.encode_keys(eval_tpu.evaluate(o.expr, batch),
                                       o.ascending, o.nulls_first_resolved)
                  for o in orders]
    return _range_spans(batch, key_groups, order, n_parts)


def _range_spans(batch: DeviceBatch, key_groups, order: torch.Tensor,
                 n_parts: int) -> torch.Tensor:
    """Sorted position r goes to span ``r * n_parts // n``, except that
    every row of an equal-key group takes its group head's span."""
    exists = batch.row_mask()
    cap = batch.capacity
    dev = batch.device
    n = torch.clamp(torch.as_tensor(batch.num_rows, dtype=torch.int64,
                                    device=dev), min=1)
    new_group = sortkeys.group_boundaries(key_groups, order, exists)
    seg = (torch.cumsum(new_group.to(torch.int32), 0) - 1).long()
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    head_pos = torch.full((cap,), 1 << 62, dtype=torch.int64,
                          device=dev).scatter_reduce(
        0, seg, torch.where(exists[order], pos, 1 << 62), "amin")
    span = torch.div(head_pos[seg] * n_parts, n, rounding_mode="floor")
    span = torch.clamp(span, 0, n_parts - 1).to(torch.int32)
    # back to the original row order
    target = torch.zeros(cap, dtype=torch.int32, device=dev)
    target[order] = span
    return target


def round_robin_targets(batch: DeviceBatch, n_parts: int,
                        start: int) -> torch.Tensor:
    """Row i of the batch goes to ``(i + start) % n_parts``, in wrapping
    int32 as the reference computes it."""
    i = torch.arange(batch.capacity, dtype=torch.int32, device=batch.device)
    st = (start + (1 << 31)) % (1 << 32) - (1 << 31)    # int32 wrap
    return torch.remainder(i + st, n_parts).to(torch.int32)


def _partition_counts(targets: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Rows per partition; targets equal to ``n_parts`` (padding) are
    not counted."""
    return torch.bincount(targets.long(), minlength=n_parts + 1)[:n_parts]


def partition_order(targets: torch.Tensor, n_parts: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stable order grouping rows by target, per-partition counts);
    targets equal to ``n_parts`` (padding) park after every span and are
    not counted."""
    return (sortkeys.shared_partition_order(targets),
            _partition_counts(targets, n_parts))


def _range_sort_words(orders: Sequence[SortOrder],
                      batch: DeviceBatch) -> torch.Tensor:
    """The range exchange's sort words (the ``exch_rkeys`` step)."""
    groups = [sortkeys.encode_keys(eval_tpu.evaluate(o.expr, batch),
                                   o.ascending, o.nulls_first_resolved)
              for o in orders]
    return sortkeys.stack_sort_words(groups, batch.row_mask())


def _range_span_targets(orders: Sequence[SortOrder], n_parts: int,
                        batch: DeviceBatch,
                        order: torch.Tensor) -> torch.Tensor:
    """Range targets from the sorted order (the ``exch_rspan`` step)."""
    t = range_targets_from_order(batch, orders, order, n_parts)
    return torch.where(batch.row_mask(), t, n_parts)


def _adj_targets(p: Partitioning, batch: DeviceBatch,
                 rows_seen: int) -> torch.Tensor:
    """Per-row targets of a single, round-robin or hash exchange, padding
    rows at ``n_parts`` (the ``exch_target`` step)."""
    n_parts = p.num_partitions
    if isinstance(p, SinglePartitioning):
        t = torch.zeros(batch.capacity, dtype=torch.int32,
                        device=batch.device)
    elif isinstance(p, RoundRobinPartitioning):
        t = round_robin_targets(batch, n_parts, rows_seen)
    elif isinstance(p, HashPartitioning):
        t = hash_targets(batch, p.keys, n_parts)
    else:
        raise NotImplementedError(type(p).__name__)
    return torch.where(batch.row_mask(), t, n_parts)


def _apply_order(n_parts: int, batch: DeviceBatch, targets: torch.Tensor,
                 order: torch.Tensor) -> Tuple[DeviceBatch, torch.Tensor]:
    """(the batch gathered into partition order, per-partition counts);
    targets equal to ``n_parts`` (padding) are not counted (the
    ``exch_apply`` step)."""
    counts = _partition_counts(targets, n_parts)
    exists = batch.row_mask()[order]
    cols = [c.gather(order, exists) for c in batch.columns]
    return DeviceBatch(batch.names, cols, batch.num_rows,
                       batch.device), counts


def slice_span(batch: DeviceBatch, offset: int, count: int,
               out_cap: int) -> DeviceBatch:
    """Rows [offset, offset + count) into a fresh bucketed batch."""
    dev = batch.device
    k = torch.arange(out_cap, dtype=torch.int64, device=dev)
    idx = torch.clamp(k + offset, 0, batch.capacity - 1)
    valid = k < count
    return DeviceBatch(batch.names,
                       [c.gather(idx, valid) for c in batch.columns],
                       count, dev)


# ---------------------------------------------------------------------------
# Local shuffle block store (the 'local' data plane)
# ---------------------------------------------------------------------------

class ShuffleBlockStore:
    """In-process map-output store of serialized Arrow slices, keyed
    (map_idx, reduce_idx) like shuffle block ids."""

    def __init__(self, codec_name: str):
        self.codec = get_codec(codec_name)
        self._blocks: Dict[Tuple[int, int], bytes] = {}
        self.bytes_written = 0

    def put(self, map_idx: int, reduce_idx: int, table: pa.Table) -> None:
        if table.num_rows == 0:
            return
        data = serialize_table(table, self.codec)
        self.bytes_written += len(data)
        obsreg.get_registry().inc_many(
            ("shuffle.bytesWritten", len(data)),
            ("shuffle.blocksWritten", 1))
        self._blocks[(map_idx, reduce_idx)] = data

    def fetch(self, reduce_idx: int) -> List[pa.Table]:
        return [deserialize_table(data)
                for (_m, r), data in sorted(self._blocks.items())
                if r == reduce_idx]


# ---------------------------------------------------------------------------
# Map-output tracking for the skew join (reference :283-483)
# ---------------------------------------------------------------------------

class _MapOutputTracker:
    """Per-reduce-bucket byte totals of one exchange's map side, summed
    as each map task completes (the MapOutputStatistics role): what the
    skew join reader consults before any reducer fetches.  The
    reference's tracker also keeps the per-map completion book that its
    pipelined ``process`` transport's readers wait on; the port has no
    such transport (ROADMAP Queue A), so nothing here waits."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bucket_bytes: Optional[List[int]] = None

    def record_sizes(self, map_id: int, sizes: Sequence[int]) -> None:
        """Aggregate one map task's per-reduce-bucket output sizes."""
        with self._lock:
            if self._bucket_bytes is None:
                self._bucket_bytes = [0] * len(sizes)
            for i, s in enumerate(sizes):
                self._bucket_bytes[i] += int(s)

    def bucket_totals(self) -> Optional[List[int]]:
        """Aggregated per-reduce-bucket bytes across all completed maps
        (None until the first map reports)."""
        with self._lock:
            return None if self._bucket_bytes is None \
                else list(self._bucket_bytes)


# per-exchange reduce-bucket size distribution (bytes): byte-scaled
# bounds, not the registry's default ms bounds
_BUCKET_BYTE_BOUNDS = (1 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20,
                       4 << 20, 16 << 20, 64 << 20, 256 << 20)

class SkewMapOutput:
    """Map output held back at per-(map, reduce-bucket) granularity.

    The default reduce path concatenates every bucket before the join
    sees it; this keeps blocks separate so a hot bucket can be
    re-planned (split / replicated) BEFORE the reduce concat.
    ``totals`` / ``row_counts`` come from the tracker's aggregation, not
    a second pass over the blocks."""

    def __init__(self, exchange: "TpuShuffleExchangeExec", host: bool,
                 store: Optional["ShuffleBlockStore"],
                 dev: Optional[List[List[DeviceBatch]]],
                 totals: List[int], row_counts: List[int], device=None):
        self.exchange = exchange
        self.host = host
        self.store = store
        self.dev = dev
        self.totals = totals
        self.row_counts = row_counts
        self.device = device

    def fetch(self, pidx: int) -> List[DeviceBatch]:
        """All of reduce bucket ``pidx`` as device batches (one uploaded
        batch for the host plane, the raw slices for the device plane)."""
        ex = self.exchange
        if self.host:
            tables = [t for t in self.store.fetch(pidx) if t.num_rows]
            if not tables:
                return []
            t = concat_tables(tables, ex.schema)
            with timed(ex.metrics, "exchange.upload"):
                return [from_arrow(t, ex.min_bucket, device=self.device,
                                   copy_stream=ex.copy_stream)]
        return [s for s in self.dev[pidx] if int(s.num_rows)]


# ---------------------------------------------------------------------------
# Host exchange
# ---------------------------------------------------------------------------

class CpuShuffleExchangeExec(PhysicalPlan):
    """Host-side exchange (the CPU session's and the fallbacks' plan)."""

    def __init__(self, child: PhysicalPlan, partitioning: Partitioning):
        super().__init__()
        self.children = (child,)
        self.partitioning = partitioning

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def _targets(self, table: pa.Table, start: int) -> np.ndarray:
        p = self.partitioning
        n = table.num_rows
        if isinstance(p, SinglePartitioning):
            return np.zeros(n, dtype=np.int64)
        if isinstance(p, RoundRobinPartitioning):
            # `start` carries the running row offset so the round-robin
            # wheel keeps turning across input batches
            return (np.arange(n, dtype=np.int64) + start) % p.num_partitions
        if isinstance(p, HashPartitioning):
            h = eval_cpu.evaluate(ir.Murmur3Hash(list(p.keys), 42), table)
            m = np.asarray(h.data, dtype=np.int64) % p.num_partitions
            return np.where(m < 0, m + p.num_partitions, m)
        if isinstance(p, RangePartitioning):
            # same exact-rank + group-cohesion contract as the device path
            import pyarrow.compute as pc
            vals = [eval_cpu.evaluate(o.expr, table) for o in p.orders]
            # stable multi-key order built least-significant-key-first
            order = np.arange(n)
            for v, o in zip(reversed(vals), reversed(p.orders)):
                arr = eval_cpu.to_arrow_array(v).take(pa.array(order))
                oi = pc.sort_indices(
                    arr,
                    sort_keys=[("", "ascending" if o.ascending
                                else "descending")],
                    null_placement="at_start" if o.nulls_first_resolved
                    else "at_end")
                order = order[np.asarray(oi)]
            # equal-key group heads over the sorted order: adjacent-row
            # equality per key (nulls equal, NaN==NaN, -0.0==0.0), then a
            # prefix-max of new-group positions
            same = np.ones(n, dtype=bool)
            for v in vals:
                sv = v.data[order]
                sm = v.valid[order]
                if np.issubdtype(np.asarray(v.data).dtype, np.floating):
                    x = sv.astype(np.float64)
                    x = np.where(x == 0.0, 0.0, x)  # fold -0.0
                    eq = (x[1:] == x[:-1]) | (np.isnan(x[1:]) &
                                              np.isnan(x[:-1]))
                else:
                    eq = sv[1:] == sv[:-1]
                pair_eq = np.concatenate(
                    [[True], (sm[1:] & sm[:-1] & eq) |
                     (~sm[1:] & ~sm[:-1])])
                same &= pair_eq
            pos = np.arange(n, dtype=np.int64)
            heads = np.maximum.accumulate(np.where(same, 0, pos))
            heads[0] = 0
            span = (heads * p.num_partitions) // max(n, 1)
            target = np.zeros(n, dtype=np.int64)
            target[order] = np.clip(span, 0, p.num_partitions - 1)
            return target
        raise NotImplementedError(type(p).__name__)

    def execute(self):
        n_parts = self.partitioning.num_partitions
        state = {"slices": None}
        lock = threading.Lock()

        def input_batches():
            """(map_idx, table) pairs; range partitioning needs the global
            rank, so its whole input coalesces into one map task."""
            if isinstance(self.partitioning, RangePartitioning):
                all_t = []
                for it in self.children[0].execute():
                    all_t.extend(t for t in it if t.num_rows)
                t = concat_tables(all_t, self.schema)
                if t.num_rows:
                    yield 0, t
                return
            for m, it in enumerate(self.children[0].execute()):
                for t in it:
                    if t.num_rows:
                        yield m, t

        def materialize():
            # readers may run on concurrent tasks; one thread materializes
            with lock:
                if state["slices"] is None:
                    state["slices"] = _materialize_locked()
                return state["slices"]

        def _materialize_locked():
            slices: List[List[pa.Table]] = [[] for _ in range(n_parts)]
            rows_seen = 0
            for _m, t in input_batches():
                tgt = self._targets(t, rows_seen)
                rows_seen += t.num_rows
                order = np.argsort(tgt, kind="stable")
                sorted_t = t.take(pa.array(order))
                counts = np.bincount(tgt, minlength=n_parts)
                off = 0
                for pidx in range(n_parts):
                    c = int(counts[pidx])
                    if c:
                        slices[pidx].append(sorted_t.slice(off, c))
                    off += c
            return slices

        def reader(pidx: int) -> Iterator[pa.Table]:
            out = concat_tables(materialize()[pidx], self.schema)
            self.metrics.add_rows(out.num_rows)
            yield out

        return [reader(p) for p in range(n_parts)]


# ---------------------------------------------------------------------------
# Device exchange
# ---------------------------------------------------------------------------

class TpuShuffleExchangeExec(TpuExec):
    """Device-side exchange over the ``local`` or ``device`` transport
    (see the module docstring)."""

    def __init__(self, child: PhysicalPlan, partitioning: Partitioning,
                 conf_obj):
        super().__init__()
        self.children = (child,)
        self.partitioning = partitioning
        self.transport = str(conf_obj.get(cfg.SHUFFLE_TRANSPORT))
        self.codec_name = str(conf_obj.get(cfg.SHUFFLE_COMPRESSION_CODEC))
        self.min_bucket = conf_obj.get(cfg.MIN_BUCKET_ROWS)
        # the session's columnar/transfer.CopyStream (the local
        # transport's uploads and downloads); None makes fresh ones
        self.copy_stream = None
        # this exec's kernel-cache steps by key (one lookup per key)
        self._kernels: Dict[Any, Any] = {}
        # the skew join's held-back map output (skew_map_side), once run,
        # under this exec's own lock: the reference's module-wide lock
        # is held while the map side drains its child, so a skew join
        # below this exchange would wait on it forever
        self._skew_out: Optional[SkewMapOutput] = None
        self._skew_lock = threading.Lock()

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def simple_string(self) -> str:
        return (f"TpuShuffleExchangeExec({type(self.partitioning).__name__}"
                f"({self.partitioning.num_partitions}), {self.transport})")

    def _compute_targets(self, batch: DeviceBatch,
                         rows_seen: int) -> torch.Tensor:
        """Per-row target partition ids; padding rows target n_parts.
        Each step is a kernel-cache dispatch at the reference's key,
        looked up once per exec and key; a range exchange's sort goes
        through the shared sort (``sortkeys.shared_lexsort``)."""
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        p = self.partitioning
        n_parts = p.num_partitions
        if isinstance(p, RangePartitioning):
            orders = p.orders
            rkey = ("exch_rkeys", p.cache_sig(), batch.schema_key())
            if rkey not in self._kernels:
                self._kernels[rkey] = kc.get_kernel(
                    rkey, lambda: functools.partial(_range_sort_words,
                                                    orders))
            order = sortkeys.shared_lexsort(self._kernels[rkey](batch))
            skey = ("exch_rspan", p.cache_sig(), n_parts,
                    batch.schema_key())
            if skey not in self._kernels:
                self._kernels[skey] = kc.get_kernel(
                    skey, lambda: functools.partial(_range_span_targets,
                                                    orders, n_parts))
            return self._kernels[skey](batch, order)
        key = ("exch_target", type(p).__name__, n_parts, p.cache_sig(),
               batch.schema_key())
        if key not in self._kernels:
            self._kernels[key] = kc.get_kernel(
                key, lambda: functools.partial(_adj_targets, p))
        return self._kernels[key](batch, rows_seen)

    def _partition_one(self, batch: DeviceBatch, rows_seen: int
                       ) -> Tuple[DeviceBatch, List[int]]:
        """(batch reordered so each partition is one span, its counts,
        read to the host: the one sync of a map batch)."""
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        n_parts = self.partitioning.num_partitions
        akey = ("exch_apply", n_parts, batch.schema_key())
        if akey not in self._kernels:
            self._kernels[akey] = kc.get_kernel(
                akey, lambda: functools.partial(_apply_order, n_parts))
        with timed(self.metrics, "exchange.partition"):
            t = self._compute_targets(batch, rows_seen)
            order = sortkeys.shared_partition_order(t)
            reordered, counts = self._kernels[akey](batch, t, order)
            counts = counts.tolist()
        return reordered, counts

    def _slice(self, reordered: DeviceBatch, offset: int, count: int
               ) -> DeviceBatch:
        from spark_rapids_tpu_torch.exec import kernel_cache as kc
        out_cap = bucket_rows(count, self.min_bucket)
        key = ("exch_slice", out_cap, reordered.schema_key())
        if key not in self._kernels:
            self._kernels[key] = kc.get_kernel(
                key, lambda: functools.partial(slice_span, out_cap=out_cap))
        return self._kernels[key](reordered, offset, count)

    def _input_batches(self):
        """Device input batches of the map side; range partitioning needs
        the global rank, so its whole input coalesces into one batch (the
        total sort's contract)."""
        if isinstance(self.partitioning, RangePartitioning):
            all_b = []
            for it in self.children[0].execute():
                all_b.extend(it)
            if all_b:
                yield concat_batches(all_b)
            return
        for it in self.children[0].execute():
            yield from it

    def skew_map_side(self) -> SkewMapOutput:
        """Run this exchange's map side WITHOUT the reduce-side concat:
        the same partition/slice pipeline as :meth:`execute`, but blocks
        stay per (map, reduce bucket) and every map's per-bucket sizes
        aggregate at a map-output tracker as it completes.  The skew
        join reader consults the totals to split hot buckets before any
        reduce fetch.  Runs on the in-process planes ('local',
        'device')."""
        with self._skew_lock:
            if self._skew_out is not None:
                return self._skew_out
            n_parts = self.partitioning.num_partitions
            host = self.transport == "local"
            store = ShuffleBlockStore(self.codec_name) if host else None
            dev: List[List[DeviceBatch]] = [[] for _ in range(n_parts)]
            tracker = _MapOutputTracker()
            rows = [0] * n_parts
            rows_seen = 0
            device = None
            for m, batch in enumerate(self._input_batches()):
                _cancel.check_current()  # per-batch map-side checkpoint
                device = batch.device
                reordered, counts = self._partition_one(batch, rows_seen)
                rows_seen += sum(counts)
                offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
                parts = [(p, self._slice(reordered, int(offs[p]), c))
                         for p, c in enumerate(counts) if c]
                sizes = [0] * n_parts
                if host:
                    tables = to_arrow_all([s for _, s in parts],
                                          self.copy_stream)
                    for (pidx, _), t in zip(parts, tables):
                        store.put(m, pidx, t)
                        sizes[pidx] = int(t.nbytes)
                else:
                    for pidx, s in parts:
                        dev[pidx].append(s)
                        # occupancy-scaled: bucket padding must not
                        # mask (or fake) a size skew
                        sizes[pidx] = int(s.nbytes() * (
                            counts[pidx] / max(int(s.capacity), 1)))
                for pidx, c in enumerate(counts):
                    rows[pidx] += c
                tracker.record_sizes(m, sizes)
            totals = tracker.bucket_totals() or [0] * n_parts
            reg = obsreg.get_registry()
            for tb in totals:
                reg.observe_bucket("shuffle.exchange.bucketBytes",
                                   float(tb), bounds=_BUCKET_BYTE_BOUNDS)
            if store is not None:
                self.metrics.extra["bytes_written"] = store.bytes_written
            self._skew_out = SkewMapOutput(self, host, store, dev, totals,
                                           rows, device)
            return self._skew_out

    def execute(self):
        module = UNPORTED_TRANSPORTS.get(self.transport)
        if module is not None:
            raise _not_ported(f"shuffle.transport={self.transport}", module)
        n_parts = self.partitioning.num_partitions
        host = self.transport == "local"
        state = {"done": False, "store": None, "dev_slices": None,
                 "device": None}
        lock = threading.Lock()

        def materialize():
            with lock:
                if not state["done"]:
                    _materialize_locked()
                    state["done"] = True

        def _materialize_locked():
            store = ShuffleBlockStore(self.codec_name) if host else None
            dev_slices: List[List[DeviceBatch]] = \
                [[] for _ in range(n_parts)]
            rows_seen = 0
            for m, batch in enumerate(self._input_batches()):
                _cancel.check_current()  # per-batch map-side checkpoint
                state["device"] = batch.device
                reordered, counts = self._partition_one(batch, rows_seen)
                rows_seen += sum(counts)
                offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
                parts = [(p, self._slice(reordered, int(offs[p]), c))
                         for p, c in enumerate(counts) if c]
                if host:
                    tables = to_arrow_all([s for _, s in parts],
                                          self.copy_stream)
                    for (pidx, _), t in zip(parts, tables):
                        store.put(m, pidx, t)
                else:
                    for pidx, s in parts:
                        dev_slices[pidx].append(s)
            state["store"] = store
            state["dev_slices"] = dev_slices
            if store is not None:
                self.metrics.extra["bytes_written"] = store.bytes_written

        def reader(pidx: int) -> Iterator[DeviceBatch]:
            materialize()
            if host:
                tables = state["store"].fetch(pidx)
                if not tables:
                    return
                # the reduce side's coalesce: concat the host slices,
                # upload once
                t = concat_tables(tables, self.schema)
                with timed(self.metrics, "exchange.upload"):
                    b = from_arrow(t, self.min_bucket,
                                   device=state["device"],
                                   copy_stream=self.copy_stream)
            else:
                slices = state["dev_slices"][pidx]
                if not slices:
                    return
                with timed(self.metrics, "exchange.concat"):
                    b = concat_batches(slices)
            self.metrics.add_rows(int(b.num_rows))
            self.metrics.add_batches()
            yield b

        return [reader(p) for p in range(n_parts)]


# ---------------------------------------------------------------------------
# Coalesce
# ---------------------------------------------------------------------------

def _coalesce(its, num_partitions: int):
    """Chain contiguous input partitions into at most ``num_partitions``
    outputs (no data movement)."""
    n = min(num_partitions, len(its)) or 1
    groups = np.array_split(np.arange(len(its)), n)
    return [itertools.chain.from_iterable(its[i] for i in g)
            for g in groups if len(g)]


class CpuCoalescePartitionsExec(PhysicalPlan):
    """Merge contiguous input partitions into at most n output partitions
    by chaining their iterators."""

    def __init__(self, child: PhysicalPlan, num_partitions: int):
        super().__init__()
        self.children = (child,)
        self.num_partitions = num_partitions

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        return _coalesce(self.children[0].execute(), self.num_partitions)


class TpuCoalescePartitionsExec(TpuExec):
    """Device-currency twin of CpuCoalescePartitionsExec."""

    def __init__(self, child: PhysicalPlan, num_partitions: int):
        super().__init__()
        self.children = (child,)
        self.num_partitions = num_partitions

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self):
        return _coalesce(self.children[0].execute(), self.num_partitions)
