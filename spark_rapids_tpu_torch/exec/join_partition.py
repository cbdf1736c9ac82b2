"""Out-of-core grace hash-join partitioning.

Ported from ``spark_rapids_tpu/exec/join_partition.py``.  When a shuffled
join's per-partition build side exceeds ``join.buildSideBudgetBytes``,
both sides are hash-partitioned into 2^k *grace partitions* with a
murmur3 seed decorrelated from the exchange's bucketing (seed 42), every
partition slice is parked in the spill catalog at the coldest priority
(``GRACE_JOIN_PARTITION_PRIORITY``) and demoted off the device at once,
then each grace partition is re-streamed and joined alone through the
join's unchanged ``_join_pair``.  A partition still over budget recurses
with the next level's seed; a partition that cannot shrink (one hot key
hashes to one bucket under every seed) falls back to streaming the probe
side slice by slice against the oversized build partition: always
correct, always terminating.

Grace partitioning changes only WHICH (build, probe) pairs ``_join_pair``
sees and in what order: each probe row still meets exactly the build
rows sharing its key (the partitioning hashes the promoted, normalized
key columns), so the output differs from the unpartitioned run only in
row order.

The split is the exchange's map side over the port's murmur3 targets
(``expr/eval_tpu.hash_colval``, ``sortkeys.shared_partition_order``,
``shuffle/exchange.slice_span``), dispatched through the process kernel
cache under the reference's per-schema keys (``split_batch``).  A
``GraceJoinState`` tracks every live partition handle, registers as a
pressure spiller so ``mem/spill.handle_memory_pressure`` reaches parked
join state, and drains the catalog on any exit, including a mid-join
``close()`` of the generator.  Activations, recursions and fallbacks
count in the ``join.grace.*`` registry counters and record the
reference's flight-recorder events (``join.graceActivated``,
``join.graceRecurse``, ``join.graceFallback``).
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import config as cfg
from spark_rapids_tpu_torch import dtypes as dt
from spark_rapids_tpu_torch.columnar.batch import (DeviceBatch, bucket_rows,
                                                   concat_batches)
from spark_rapids_tpu_torch.exec import sortkeys
from spark_rapids_tpu_torch.mem import device as devmgr
from spark_rapids_tpu_torch.obs import recorder as obsrec
from spark_rapids_tpu_torch.obs import registry as obsreg

_MAX_PARTS_LOG2 = 5          # 32-way cap per level (matches the conf doc)


def _level_seed(level: int) -> int:
    """Per-recursion-level murmur seed, deliberately != 42: rows arrive
    already routed by the exchange's seed-42 hash, and re-splitting with
    that seed would park an entire partition in one grace bucket."""
    s = (0x7F4A7C15 + level * 0x9E3779B9) & 0xFFFFFFFF
    return s - (1 << 32) if s >= (1 << 31) else s


def resolve_oocore(conf_obj, device=None) -> Optional[dict]:
    """Resolve the ``join.*`` out-of-core keys into the stamp the planner
    attaches to a shuffled join (``_oocore``); ``None`` disables the
    budget check (the one-key revert, and the default of a hand-built
    join that is never stamped).

    A budget of 0 derives one query's share of the admission budget:
    ``sched.memoryBudget``, else 0.9 of the card's memory on a CUDA
    ``device`` (the reference's pool fraction of its HBM limit), else
    the reference's 8 GiB; divided by ``sched.maxConcurrent``."""
    if not conf_obj.get(cfg.JOIN_OOCORE_ENABLED):
        return None
    budget = int(conf_obj.get(cfg.JOIN_BUILD_BUDGET))
    if budget < 0:
        return None
    if budget == 0:
        base = int(conf_obj.get(cfg.SCHED_MEMORY_BUDGET) or 0)
        if base <= 0:
            base = devmgr.memory_budget(device)
        budget = max(1, base // max(1, int(conf_obj.get(
            cfg.SCHED_MAX_CONCURRENT))))
    return {
        "budget": budget,
        "parts_log2": max(0, int(conf_obj.get(
            cfg.JOIN_OOCORE_PARTITIONS_LOG2))),
        "max_recursion": max(0, int(conf_obj.get(
            cfg.JOIN_OOCORE_MAX_RECURSION))),
    }


def _fanout(build_bytes: int, oocore: dict, level: int) -> int:
    """2^k grace partitions: the smallest k whose expected per-partition
    build size fits the budget (an explicit partitionsLog2 pins level
    0)."""
    if level == 0 and oocore["parts_log2"] > 0:
        return 1 << min(oocore["parts_log2"], _MAX_PARTS_LOG2)
    k = 1
    while (build_bytes >> k) > oocore["budget"] and k < _MAX_PARTS_LOG2:
        k += 1
    return 1 << k


def promoted_key_dtypes(exec_obj) -> List[Optional[dt.DType]]:
    """The common promoted dtype per key position, or None for keys that
    hash as they are (strings; already-equal dtypes).

    Both sides MUST cast to the promoted dtype BEFORE hashing: murmur3's
    int and long steps disagree for the same value, so an int32 key on
    one side and int64 on the other would route equal keys to different
    grace partitions."""
    lsch = exec_obj.children[0].schema
    rsch = exec_obj.children[1].schema
    out: List[Optional[dt.DType]] = []
    for lk, rk in zip(exec_obj.left_keys, exec_obj.right_keys):
        a, b = lsch.field(lk).dtype, rsch.field(rk).dtype
        if a.is_string or b.is_string or a == b:
            out.append(None)
        else:
            out.append(dt.promote(a, b))
    return out


def _grace_key_colval(batch: DeviceBatch, name: str,
                      tgt: Optional[dt.DType]):
    from spark_rapids_tpu_torch.exec.tpu_aggregate import normalize_key
    from spark_rapids_tpu_torch.expr.eval_tpu import ColVal
    c = batch.column(name)
    v = normalize_key(ColVal(c.dtype, c.data, c.validity, c.lengths,
                             vbits=c.vbits, nonnull=c.nonnull))
    if tgt is not None and v.dtype != tgt:
        v = normalize_key(ColVal(tgt, v.data.to(tgt.to_torch()),
                                 v.validity))
    return v


def split_batch(kernels: dict, batch: DeviceBatch,
                key_names: Sequence[str],
                key_dtypes: Sequence[Optional[dt.DType]], seed: int,
                n_parts: int,
                min_bucket: int = 16) -> List[Optional[DeviceBatch]]:
    """Hash-partition one device batch into ``n_parts`` sub-batches by
    the salted murmur3 of its (promoted, normalized) key columns: the
    exchange's map side, as the reference's kernel split (:150-188): a
    per-schema ``grace_target`` step (the seed is an argument, so one
    step serves every recursion level), the shared
    ``shared_partition_order`` sort, a per-schema ``grace_apply`` gather
    with the per-partition counts (one host read), and a bucketed
    ``grace_slice`` per partition.  ``kernels`` memoizes the steps per
    exec.  Returns one batch (or None when empty) per partition."""
    from spark_rapids_tpu_torch.exec import kernel_cache as kc
    from spark_rapids_tpu_torch.expr.eval_tpu import hash_colval
    from spark_rapids_tpu_torch.shuffle.exchange import slice_span
    knames = tuple(key_names)
    kdts = tuple(None if d is None else d.id for d in key_dtypes)
    tkey = ("grace_target", n_parts, knames, kdts, batch.schema_key())
    if tkey not in kernels:
        kn, kd = list(key_names), list(key_dtypes)

        def targets(b, sd):
            h = torch.full((b.capacity,), sd, dtype=torch.int32,
                           device=b.device)
            for nm, td in zip(kn, kd):
                h = hash_colval(_grace_key_colval(b, nm, td), h)
            return torch.where(b.row_mask(),
                               torch.remainder(h, n_parts).to(torch.int32),
                               n_parts)
        kernels[tkey] = kc.get_kernel(tkey, lambda: targets)
    t = kernels[tkey](batch, seed)
    order = sortkeys.shared_partition_order(t)
    akey = ("grace_apply", n_parts, batch.schema_key())
    if akey not in kernels:
        def apply_order(b, tt, o):
            counts = torch.bincount(tt.long(),
                                    minlength=n_parts + 1)[:n_parts]
            exists = b.row_mask()
            cols = [c.gather(o, exists[o]) for c in b.columns]
            return DeviceBatch(b.names, cols, b.num_rows, b.device), counts
        kernels[akey] = kc.get_kernel(akey, lambda: apply_order)
    reordered, counts = kernels[akey](batch, t, order)
    out: List[Optional[DeviceBatch]] = [None] * n_parts
    off = 0
    for p, c in enumerate(counts.tolist()):
        if c:
            out_cap = bucket_rows(c, min_bucket)
            skey = ("grace_slice", out_cap, reordered.schema_key())
            if skey not in kernels:
                kernels[skey] = kc.get_kernel(
                    skey, lambda oc=out_cap:
                    lambda b, o, cc: slice_span(b, o, cc, oc))
            out[p] = kernels[skey](reordered, off, c)
        off += c
    return out


class GraceJoinState:
    """Every live grace-partition handle of one in-flight join.

    Registered as a pressure spiller, so ``handle_memory_pressure``
    reaches parked join state (the join's generator holds the strong
    reference; the spill module keeps a weakref).  ``close_all`` is the
    cancel/error drain: after it, the join owns no catalog entry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handles: dict = {}          # id(handle) -> handle

    def track(self, handle) -> None:
        with self._lock:
            self._handles[id(handle)] = handle

    def untrack(self, handle) -> None:
        with self._lock:
            self._handles.pop(id(handle), None)

    def pressure_spill(self, bytes_needed: int) -> int:
        from spark_rapids_tpu_torch.mem.spill import StorageTier
        with self._lock:
            handles = list(self._handles.values())
        freed = 0
        for h in handles:
            if freed >= bytes_needed:
                break
            try:
                if h.tier == StorageTier.DEVICE:
                    freed += h.spill()
            except Exception:
                pass      # racing close; the sweep is advisory
        return freed

    def close_all(self) -> None:
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
        for h in handles:
            try:
                h.close()
            except Exception:
                pass


class _Part:
    """One parked partition slice: its spill handle and the sizes taken
    at park time (the batch may be off the device later)."""

    __slots__ = ("handle", "nbytes", "rows")

    def __init__(self, handle, nbytes: int, rows: int):
        self.handle = handle
        self.nbytes = nbytes
        self.rows = rows


def _park(state: GraceJoinState, batch: DeviceBatch) -> _Part:
    """Register one partition slice at the coldest spill priority and
    demote it off the device at once: a parked partition is by
    definition not being joined, device residency stays bounded by the
    partition in flight, and the later ``get()`` unspill is the counted
    proof of the re-stream."""
    from spark_rapids_tpu_torch.mem import spill as sp
    nb, rows = int(batch.nbytes()), int(batch.num_rows)
    h = sp.register_or_hold(batch, priority=sp.GRACE_JOIN_PARTITION_PRIORITY)
    state.track(h)
    h.spill()
    return _Part(h, nb, rows)


def _unpark(state: GraceJoinState, part: _Part) -> DeviceBatch:
    b = part.handle.get()
    state.untrack(part.handle)
    part.handle.close()
    return b


def _materialize(state: GraceJoinState, parts: List[_Part],
                 count_spilled: bool = False) -> Optional[DeviceBatch]:
    from spark_rapids_tpu_torch.mem.spill import StorageTier
    if not parts:
        return None
    if count_spilled:
        spilled = sum(p.nbytes for p in parts
                      if p.handle.tier != StorageTier.DEVICE)
        if spilled:
            obsreg.get_registry().inc("join.grace.spilledBuildBytes",
                                      spilled)
    return concat_batches([_unpark(state, p) for p in parts])


def _close_parts(state: GraceJoinState, parts: List[_Part]) -> None:
    for p in parts:
        state.untrack(p.handle)
        p.handle.close()


def _split_parts(exec_obj, state: GraceJoinState, parts: List[_Part],
                 key_names, key_dtypes, seed: int,
                 n_parts: int) -> List[List[_Part]]:
    """Re-partition parked slices into ``n_parts`` child partitions (the
    recursion step): each slice is re-streamed, split with the new
    level's seed and its children parked; the parent handle closes."""
    out: List[List[_Part]] = [[] for _ in range(n_parts)]
    for p in parts:
        b = _unpark(state, p)
        for i, s in enumerate(split_batch(exec_obj._kernels, b, key_names,
                                          key_dtypes, seed, n_parts)):
            if s is not None:
                out[i].append(_park(state, s))
    return out


def _empty_side(exec_obj, side: int, device) -> DeviceBatch:
    from spark_rapids_tpu_torch.exec.tpu_join import _empty_like
    return _empty_like(exec_obj.children[side].schema, device)


def _run_level(exec_obj, state: GraceJoinState, build: List[_Part],
               probe: List[_Part], level: int, oocore: dict, key_dtypes,
               build_is_left: bool, gathered: bool,
               device) -> Iterator[DeviceBatch]:
    """Join ONE grace partition: recurse while over budget and shrinking,
    else re-stream and join through the unchanged ``_join_pair`` (the
    streamed mode probes slice by slice; the fallback for an
    unsplittable hot key is this same loop)."""
    from spark_rapids_tpu_torch.mem import spill as sp
    reg = obsreg.get_registry()
    how = exec_obj.how
    if not build and not probe:
        return
    build_bytes = sum(p.nbytes for p in build)
    over = build_bytes > oocore["budget"]
    bkeys = exec_obj.left_keys if build_is_left else exec_obj.right_keys
    pkeys = exec_obj.right_keys if build_is_left else exec_obj.left_keys
    if over and level < oocore["max_recursion"]:
        n_child = _fanout(build_bytes, oocore, level)
        seed = _level_seed(level + 1)
        child_b = _split_parts(exec_obj, state, build, bkeys, key_dtypes,
                               seed, n_child)
        if sum(1 for part in child_b if part) >= 2:
            # progress: every child partition is strictly smaller
            reg.gauge_max("join.grace.maxRecursionDepth", level + 1)
            reg.inc("join.grace.partitions", n_child)
            obsrec.record_event("join.graceRecurse", level=level + 1,
                                partitions=n_child,
                                buildBytes=build_bytes,
                                budget=oocore["budget"])
            child_p = _split_parts(exec_obj, state, probe, pkeys,
                                   key_dtypes, seed, n_child)
            for i in range(n_child):
                yield from _run_level(exec_obj, state, child_b[i],
                                      child_p[i], level + 1, oocore,
                                      key_dtypes, build_is_left, gathered,
                                      device)
            return
        # one hot key: re-hashing cannot shrink this partition under ANY
        # seed; stop recursing and fall back below (the children all
        # landed in one bucket: they ARE the partition)
        build = [p for part in child_b for p in part]
        reg.inc("join.grace.fallbacks")
        obsrec.record_event("join.graceFallback", level=level,
                            buildBytes=build_bytes,
                            budget=oocore["budget"], reason="noShrink")
    elif over:
        reg.inc("join.grace.fallbacks")
        obsrec.record_event("join.graceFallback", level=level,
                            buildBytes=build_bytes,
                            budget=oocore["budget"],
                            reason="maxRecursion")

    reg.inc("join.grace.restreams")
    if gathered:
        # right/full: unmatched-build emission needs the whole stream
        # side of the partition, so the pair joins as two single
        # batches (the partitions are key-disjoint, so each unmatched
        # row is emitted exactly once)
        b = _materialize(state, build, count_spilled=True)
        s = _materialize(state, probe)
        if b is None and s is None:
            return
        lb, rb = (b, s) if build_is_left else (s, b)
        lb = lb if lb is not None else _empty_side(exec_obj, 0, device)
        rb = rb if rb is not None else _empty_side(exec_obj, 1, device)
        yield from exec_obj._join_pair(lb, rb)
        return
    # streamed (inner/left/semi/anti, build = right): probe slices
    # re-stream one at a time against the held build partition
    b = _materialize(state, build, count_spilled=True)
    if b is None:
        if how in ("inner", "semi"):
            _close_parts(state, probe)
            return
        b = _empty_side(exec_obj, 1, device)
    with sp.register_or_hold(b) as rh:
        for p in probe:
            pb = _unpark(state, p)
            if not int(pb.num_rows):
                continue
            yield from exec_obj._join_pair(pb, rh.get())


def grace_join(exec_obj, probe_input, build_batches: List[DeviceBatch],
               build_bytes: int, oocore: dict, build_is_left: bool,
               gathered: bool) -> Iterator[DeviceBatch]:
    """Grace join of one co-partitioned partition pair.

    ``probe_input`` is an iterable of stream-side device batches (the
    raw partition iterator in streamed mode, never concatenated);
    ``build_batches`` the collected build side that measured over
    budget.  Yields joined batches; all partition state drains through
    the spill catalog on any exit, including generator close."""
    from spark_rapids_tpu_torch.mem import spill as sp
    reg = obsreg.get_registry()
    state = GraceJoinState()
    sp.register_pressure_spiller(state)
    device = build_batches[0].device
    n_parts = _fanout(build_bytes, oocore, 0)
    key_dtypes = promoted_key_dtypes(exec_obj)
    bkeys = exec_obj.left_keys if build_is_left else exec_obj.right_keys
    pkeys = exec_obj.right_keys if build_is_left else exec_obj.left_keys
    seed = _level_seed(0)
    reg.inc_many(("join.grace.activations", 1),
                 ("join.grace.partitions", n_parts))
    obsrec.record_event("join.graceActivated", how=exec_obj.how,
                        buildBytes=build_bytes, budget=oocore["budget"],
                        partitions=n_parts)
    exec_obj.metrics.add_extra("join.gracePartitions", n_parts)
    try:
        build_parts: List[List[_Part]] = [[] for _ in range(n_parts)]
        for b in build_batches:
            for i, s in enumerate(split_batch(exec_obj._kernels, b, bkeys,
                                              key_dtypes, seed, n_parts)):
                if s is not None:
                    build_parts[i].append(_park(state, s))
        # the caller's list too: from here only the parked slices hold
        # the build side
        build_batches.clear()
        probe_parts: List[List[_Part]] = [[] for _ in range(n_parts)]
        for pb in probe_input:
            if not int(pb.num_rows):
                continue
            for i, s in enumerate(split_batch(exec_obj._kernels, pb, pkeys,
                                              key_dtypes, seed, n_parts)):
                if s is not None:
                    probe_parts[i].append(_park(state, s))
        for i in range(n_parts):
            yield from _run_level(exec_obj, state, build_parts[i],
                                  probe_parts[i], 0, oocore, key_dtypes,
                                  build_is_left, gathered, device)
    finally:
        state.close_all()
