"""Adaptive (AQE-analog) shuffle reads for join exchanges.

Ported from ``spark_rapids_tpu/exec/adaptive.py``, imports retargeted.
The reference's ``GpuCustomShuffleReaderExec`` role: the engine derives
coalesced and skew-split partition specs from the measured map output,
with Spark's scoping rules:

  * only planner-inserted join exchanges participate: a user's
    ``df.repartition(n, ...)`` fixed the partition count explicitly and
    is exempt (Spark's REPARTITION_BY_NUM exemption);
  * both join sides share ONE spec list computed from the combined
    per-partition sizes, so the join's co-partitioning survives;
  * a skewed partition (side bytes > skewedPartitionFactor x median and
    > the absolute threshold) is split by rows into advisory-sized
    chunks while the other side's matching partition is replicated per
    chunk.  Sides are split only where the join type allows it: the
    left for inner/left/semi/anti, the right for inner/right, neither
    for full outer;
  * ``minPartitionNum`` constrains only coalescing, never skew splitting.

The coordinator materializes every reduce partition before the first
read (specs need both sides' sizes).  Every buffered partition batch is
registered in the spill catalog (``mem/spill.register_or_hold``), so the
device store can evict it to host or disk under pressure; partition
buffers are refcounted and released as the last spec that references
them drains.

The skew half of ``sql.join.skew.enabled`` (``_JoinSkewState`` /
``TpuSkewJoinReaderExec``) reads the exchanges' held-back map output
(``shuffle/exchange.TpuShuffleExchangeExec.skew_map_side``) and splits a
hot probe bucket before the reduce concat; it counts
``shuffle.skew.detected|splits|broadcasts|replications`` and records a
``shuffle.bucketSplit`` event per split bucket.

Row slices go through the kernel cache's ``exch_slice`` family at the
exchange's key, as the reference's do.  The reference colocates ICI
shards at pull time; the port has no ICI transport (ROADMAP Queue A),
so every batch is already on the session's device.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, bucket_rows,
                                                   concat_batches)
from spark_rapids_tpu_torch.exec.base import PhysicalPlan, TpuExec, timed
from spark_rapids_tpu_torch.plan.logical import Schema
from spark_rapids_tpu_torch.shuffle.exchange import slice_span


@dataclass(frozen=True)
class CoalescedSpec:
    """Output partition = input partitions [start, end)."""
    start: int
    end: int


@dataclass(frozen=True)
class SkewSplitSpec:
    """Output partition = rows [row_start, row_end) of input partition."""
    partition: int
    row_start: int
    row_end: int


def skewed_indices(sizes: Sequence[int], factor: int, threshold: int
                   ) -> Set[int]:
    nonzero = sorted(s for s in sizes if s > 0)
    if not nonzero:
        return set()
    median = nonzero[len(nonzero) // 2]
    cut = max(factor * median, threshold)
    return {i for i, s in enumerate(sizes) if s > cut}


def coalesce_runs(sizes: Sequence[int], advisory: int,
                  skew: Set[int]) -> List:
    """Greedy contiguous coalescing up to ``advisory`` bytes; indices in
    ``skew`` become standalone ``("skew", i)`` markers.  Returns a list
    of CoalescedSpec | ("skew", i)."""
    specs: List = []
    run_start: Optional[int] = None
    run_bytes = 0

    def flush(end: int) -> None:
        nonlocal run_start, run_bytes
        if run_start is not None and end > run_start:
            specs.append(CoalescedSpec(run_start, end))
        run_start, run_bytes = None, 0

    for i, s in enumerate(sizes):
        if i in skew:
            flush(i)
            specs.append(("skew", i))
            continue
        if run_start is None:
            run_start = i
        run_bytes += s
        if run_bytes >= advisory:
            flush(i + 1)
    flush(len(sizes))
    return specs


def _row_chunks(rows: int, size: int, advisory: int
                ) -> List[Tuple[int, int]]:
    n_chunks = max(2, -(-size // advisory))
    chunk = max(1, -(-rows // n_chunks))
    return [(st, min(st + chunk, rows))
            for st in range(0, max(rows, 1), chunk)]


def plan_join_specs(lsizes: Sequence[int], rsizes: Sequence[int],
                    lrows: Sequence[int], rrows: Sequence[int],
                    how: str, advisory: int, factor: int, threshold: int,
                    min_parts: int) -> List[Tuple]:
    """One shared spec list for both join sides.

    Returns [(left_spec, right_spec), ...]; coalesced specs are identical
    on both sides, skew entries pair row chunks of the split side with a
    replica of the other side's whole partition."""
    lskew = skewed_indices(lsizes, factor, threshold) \
        if how in ("inner", "left", "semi", "anti") else set()
    rskew = skewed_indices(rsizes, factor, threshold) \
        if how in ("inner", "right") else set()
    skew = lskew | rskew
    combined = [a + b for a, b in zip(lsizes, rsizes)]
    runs = coalesce_runs(combined, advisory, skew)

    def expand(runs_list) -> List[Tuple]:
        out: List[Tuple] = []
        for sp in runs_list:
            if isinstance(sp, CoalescedSpec):
                out.append((sp, sp))
                continue
            _, i = sp
            lchunks = _row_chunks(lrows[i], lsizes[i], advisory) \
                if i in lskew else [(0, lrows[i])]
            rchunks = _row_chunks(rrows[i], rsizes[i], advisory) \
                if i in rskew else [(0, rrows[i])]
            for ls, le in lchunks:
                for rs, re in rchunks:
                    out.append((SkewSplitSpec(i, ls, le),
                                SkewSplitSpec(i, rs, re)))
        return out

    specs = expand(runs)
    if len(specs) < min_parts:
        # minPartitionNum limits coalescing only: retry without it
        identity = []
        for sp in runs:
            if isinstance(sp, CoalescedSpec):
                identity.extend(CoalescedSpec(p, p + 1)
                                for p in range(sp.start, sp.end))
            else:
                identity.append(sp)
        specs = expand(identity)
    return specs


def _effective_bytes(b: DeviceBatch) -> int:
    """Occupancy-scaled bytes: capacity padding (buckets pad up to 2x)
    must not mask, or fake, a size skew."""
    return int(b.nbytes() * (int(b.num_rows) / max(int(b.capacity), 1)))


def _row_slice(exec_obj, batch: DeviceBatch, start: int, count: int
               ) -> DeviceBatch:
    """Rows [start, start + count) of ``batch`` through the kernel
    cache's ``exch_slice`` step (the exchange's key)."""
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    cap = bucket_rows(count, exec_obj.min_bucket)
    key = ("exch_slice", cap, batch.schema_key())
    if key not in exec_obj._kernels:
        exec_obj._kernels[key] = kc.get_kernel(
            key, lambda: functools.partial(slice_span, out_cap=cap))
    return exec_obj._kernels[key](batch, start, count)


class _JoinAdaptiveState:
    """Shared coordinator: pulls both exchanges once, plans one spec
    list, hands per-side views their batches.  Buffers are spillable
    (registered in the spill catalog when enabled), refcounted per
    (side, partition), and dropped when the last referencing spec
    drains."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, how: str,
                 conf_obj):
        self._lock = threading.Lock()
        self.children = (left, right)
        self.how = how
        self.advisory = int(conf_obj.get(
            cfg.ADAPTIVE_ADVISORY_PARTITION_SIZE))
        self.factor = int(conf_obj.get(cfg.ADAPTIVE_SKEW_FACTOR))
        self.threshold = int(conf_obj.get(cfg.ADAPTIVE_SKEW_THRESHOLD))
        self.min_parts = int(conf_obj.get(cfg.ADAPTIVE_MIN_PARTITION_NUM))
        self.specs: Optional[List[Tuple]] = None
        # handles with .get()/.close() (SpillableBatch/PlainBatchHandle)
        self.batches: List[List[List]] = [[], []]
        self._refs: List[Dict[int, int]] = [{}, {}]

    def ensure(self) -> None:
        with self._lock:
            self._ensure_locked()

    def _ensure_locked(self) -> None:
        if self.specs is not None:
            return
        from spark_rapids_tpu_torch.mem.spill import register_or_hold
        per_side_sizes = []
        per_side_rows = []
        for side, child in enumerate(self.children):
            sizes: List[int] = []
            rows: List[int] = []
            handles: List[List] = []
            for it in child.execute():
                bs = list(it)
                sizes.append(sum(_effective_bytes(b) for b in bs))
                rows.append(sum(int(b.num_rows) for b in bs))
                handles.append([register_or_hold(b) for b in bs])
            self.batches[side] = handles
            per_side_sizes.append(sizes)
            per_side_rows.append(rows)
        self.specs = plan_join_specs(
            per_side_sizes[0], per_side_sizes[1],
            per_side_rows[0], per_side_rows[1],
            self.how, self.advisory, self.factor, self.threshold,
            self.min_parts)
        # pre-concat partitions that skew chunks will row-slice, and
        # count references so buffers free as readers drain
        for side in (0, 1):
            refs: Dict[int, int] = {}
            for sp in (s[side] for s in self.specs):
                if isinstance(sp, SkewSplitSpec):
                    refs[sp.partition] = refs.get(sp.partition, 0) + 1
                else:
                    for p in range(sp.start, sp.end):
                        refs[p] = refs.get(p, 0) + 1
            self._refs[side] = refs
            skew_parts = {sp[side].partition for sp in self.specs
                          if isinstance(sp[side], SkewSplitSpec)}
            for p in skew_parts:
                hs = self.batches[side][p]
                if len(hs) > 1:
                    merged = concat_batches([h.get() for h in hs])
                    for h in hs:
                        h.close()
                    self.batches[side][p] = [register_or_hold(merged)]

    def release(self, side: int, parts) -> None:
        # partition readers run concurrently under the task thread pool
        with self._lock:
            for p in parts:
                self._refs[side][p] -= 1
                if self._refs[side][p] == 0:
                    for h in self.batches[side][p]:
                        h.close()
                    self.batches[side][p] = []


class TpuAdaptiveJoinReaderExec(TpuExec):
    """One join side's view of the shared coordinated specs (the
    CustomShuffleReader node that appears in explain output)."""

    def __init__(self, state: _JoinAdaptiveState, side: int,
                 child: PhysicalPlan, conf_obj):
        super().__init__()
        self.state = state
        self.side = side
        self.children = (child,)
        self.min_bucket = conf_obj.get(cfg.MIN_BUCKET_ROWS)
        self._kernels: Dict = {}

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def simple_string(self) -> str:
        n = len(self.state.specs) if self.state.specs is not None else "?"
        return f"TpuAdaptiveJoinReaderExec(side={self.side}, specs={n})"

    def execute(self):
        self.state.ensure()
        side = self.side
        batches = self.state.batches[side]

        def reader(spec) -> Iterator[DeviceBatch]:
            if isinstance(spec, CoalescedSpec):
                group = [h.get() for p in range(spec.start, spec.end)
                         for h in batches[p]]
                if group:
                    with timed(self.metrics, "adaptive.coalesce"):
                        out = group[0] if len(group) == 1 \
                            else concat_batches(group)
                    self.metrics.add_rows(int(out.num_rows))
                    self.metrics.add_batches()
                    self.state.release(side, range(spec.start, spec.end))
                    yield out
                else:
                    self.state.release(side, range(spec.start, spec.end))
            else:
                hs = batches[spec.partition]
                count = spec.row_end - spec.row_start
                if hs and count > 0:
                    first = hs[0].get()
                    with timed(self.metrics, "adaptive.split"):
                        # a replica spec spanning the whole partition
                        # (the non-split side) reuses the batch as-is
                        if spec.row_start == 0 and \
                                count == int(first.num_rows):
                            out = first
                        else:
                            out = _row_slice(self, first, spec.row_start,
                                             count)
                    self.metrics.add_rows(int(out.num_rows))
                    self.metrics.add_batches()
                    self.state.release(side, [spec.partition])
                    yield out
                else:
                    self.state.release(side, [spec.partition])

        return [reader(sp[side]) for sp in self.state.specs]


class _JoinSkewState:
    """Shared coordinator for runtime hot-bucket splitting at the
    map-output tracker.

    Unlike :class:`_JoinAdaptiveState` (which materializes every reduce
    partition to size them), this consults the per-bucket byte totals
    the exchanges' map-output trackers aggregated as maps completed;
    blocks are still per (map, bucket) when the split decision lands.
    A probe-side bucket over ``skew.bucketFactor`` x the nonzero median
    (and over ``minBucketBytes``) is split into S contiguous row chunks
    while the matching build-side bucket is shared across all S
    sub-partitions: counted as a broadcast when it is under
    ``broadcastThresholdBytes``, a replication otherwise (in-process
    both are one refcounted buffer; the distinction tracks which plan
    Spark would have picked).  Buckets that are not hot stream straight
    from the held-back map output.

    The probe side is the one the join type lets us split without
    duplicating preserved rows: the left for inner/left/semi/anti, the
    right for how='right'.  Full outer is ineligible and falls through
    to the adaptive reader."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, how: str,
                 conf_obj):
        self._lock = threading.Lock()
        self.children = (left, right)
        self.how = how
        self.probe = 1 if how == "right" else 0
        self.factor = float(conf_obj.get(cfg.JOIN_SKEW_FACTOR))
        self.min_bucket_bytes = int(conf_obj.get(
            cfg.JOIN_SKEW_MIN_BUCKET_BYTES))
        self.max_splits = int(conf_obj.get(cfg.JOIN_SKEW_MAX_SPLITS))
        self.broadcast_threshold = int(conf_obj.get(
            cfg.JOIN_SKEW_BROADCAST_THRESHOLD))
        self.specs: Optional[List[Tuple]] = None
        self.outs: List = [None, None]       # per-side SkewMapOutput
        # hot partition -> refcounted concat handle, per side
        self.handles: List[Dict[int, object]] = [{}, {}]
        self._refs: List[Dict[int, int]] = [{}, {}]
        # hot partition -> [(row_start, row_count), ...] probe chunks
        self.chunks: Dict[int, List[Tuple[int, int]]] = {}

    def ensure(self) -> None:
        with self._lock:
            if self.specs is None:
                self._plan_locked()

    def _plan_locked(self) -> None:
        from spark_rapids_tpu_torch.mem.spill import register_or_hold
        from spark_rapids_tpu_torch.obs import registry as obsreg
        from spark_rapids_tpu_torch.obs.recorder import record_event
        outs = [c.skew_map_side() for c in self.children]
        self.outs = outs
        probe, build = self.probe, 1 - self.probe
        totals = outs[probe].totals
        rows = outs[probe].row_counts
        nonzero = sorted(s for s in totals if s > 0)
        median = nonzero[len(nonzero) // 2] if nonzero else 0
        cut = max(self.factor * median, self.min_bucket_bytes)
        hot = {p for p, s in enumerate(totals)
               if median and s > cut and rows[p] >= 2}
        reg = obsreg.get_registry()
        specs: List[Tuple] = []
        for p in range(len(totals)):
            if p not in hot:
                specs.append(("plain", p))
                continue
            n_splits = min(self.max_splits, rows[p],
                           max(2, -(-totals[p] // max(median, 1))))
            chunk = max(1, -(-rows[p] // n_splits))
            self.chunks[p] = [(st, min(chunk, rows[p] - st))
                              for st in range(0, rows[p], chunk)]
            n_splits = len(self.chunks[p])
            for side in (probe, build):
                bs = outs[side].fetch(p)
                merged = bs[0] if len(bs) == 1 else \
                    (concat_batches(bs) if bs else None)
                if merged is not None:
                    self.handles[side][p] = register_or_hold(merged)
                self._refs[side][p] = n_splits
            bcast = outs[build].totals[p] <= self.broadcast_threshold
            reg.inc_many(
                ("shuffle.skew.detected", 1),
                ("shuffle.skew.splits", n_splits),
                (("shuffle.skew.broadcasts" if bcast
                  else "shuffle.skew.replications"), 1))
            record_event("shuffle.bucketSplit", partition=p,
                         bucket_bytes=int(totals[p]),
                         median_bytes=int(median), splits=n_splits,
                         build_bytes=int(outs[build].totals[p]),
                         mode="broadcast" if bcast else "replicate")
            specs.extend(("split", p, j, n_splits)
                         for j in range(n_splits))
        self.specs = specs

    def release(self, side: int, p: int) -> None:
        # sub-partition readers run concurrently under the task pool
        with self._lock:
            self._refs[side][p] -= 1
            if self._refs[side][p] == 0:
                h = self.handles[side].pop(p, None)
                if h is not None:
                    h.close()


class TpuSkewJoinReaderExec(TpuExec):
    """One join side's view of the skew-split fetch plan (the
    CustomShuffleReader node of the skew half; shows in explain)."""

    def __init__(self, state: _JoinSkewState, side: int,
                 child: PhysicalPlan, conf_obj):
        super().__init__()
        self.state = state
        self.side = side
        self.children = (child,)
        self.min_bucket = conf_obj.get(cfg.MIN_BUCKET_ROWS)
        self._kernels: Dict = {}

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def simple_string(self) -> str:
        n = len(self.state.specs) if self.state.specs is not None else "?"
        return f"TpuSkewJoinReaderExec(side={self.side}, specs={n})"

    def execute(self):
        self.state.ensure()
        side = self.side
        is_probe = side == self.state.probe
        out = self.state.outs[side]

        def plain(p: int) -> Iterator[DeviceBatch]:
            for b in out.fetch(p):
                self.metrics.add_rows(int(b.num_rows))
                self.metrics.add_batches()
                yield b

        def split(p: int, j: int) -> Iterator[DeviceBatch]:
            try:
                h = self.state.handles[side].get(p)
                if h is None:
                    return
                whole = h.get()
                if is_probe:
                    start, count = self.state.chunks[p][j]
                    if count <= 0:
                        return
                    with timed(self.metrics, "skew.split"):
                        b = whole if count == int(whole.num_rows) \
                            else _row_slice(self, whole, start, count)
                else:
                    # replicated/broadcast build bucket: every probe
                    # chunk joins against the same shared buffer
                    b = whole
                self.metrics.add_rows(int(b.num_rows))
                self.metrics.add_batches()
                yield b
            finally:
                self.state.release(side, p)

        return [plain(sp[1]) if sp[0] == "plain" else split(sp[1], sp[2])
                for sp in self.state.specs]


def wrap_join_children(left: PhysicalPlan, right: PhysicalPlan, how: str,
                       conf_obj) -> Tuple[PhysicalPlan, PhysicalPlan]:
    """Wrap a shuffled join's two exchange children in coordinated
    adaptive (or skew-splitting) readers: a no-op unless both children
    are hash exchanges of one partition count and the respective knob
    is on."""
    from spark_rapids_tpu_torch.shuffle.exchange import (
        HashPartitioning, TpuShuffleExchangeExec)
    eligible = (isinstance(left, TpuShuffleExchangeExec)
                and isinstance(right, TpuShuffleExchangeExec)
                and isinstance(left.partitioning, HashPartitioning)
                and isinstance(right.partitioning, HashPartitioning)
                and left.partitioning.num_partitions
                == right.partitioning.num_partitions)
    # skew splitting takes over the skew half of the adaptive reader for
    # eligible joins; ineligible shapes (full outer, other transports)
    # fall through to the adaptive reader
    if (eligible and conf_obj.get(cfg.JOIN_SKEW_ENABLED)
            and how in ("inner", "left", "right", "semi", "anti")
            and left.transport in ("local", "device")
            and right.transport in ("local", "device")):
        state = _JoinSkewState(left, right, how, conf_obj)
        return (TpuSkewJoinReaderExec(state, 0, left, conf_obj),
                TpuSkewJoinReaderExec(state, 1, right, conf_obj))
    if not conf_obj.get(cfg.ADAPTIVE_ENABLED) or not eligible:
        return left, right
    state = _JoinAdaptiveState(left, right, how, conf_obj)
    return (TpuAdaptiveJoinReaderExec(state, 0, left, conf_obj),
            TpuAdaptiveJoinReaderExec(state, 1, right, conf_obj))
