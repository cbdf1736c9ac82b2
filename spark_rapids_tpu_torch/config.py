"""Typed configuration registry: the keys the port reads so far.

Ported from ``spark_rapids_tpu/config.py``.  Keys keep their reference
names (``spark.rapids.tpu.*``), defaults and types, so one conf dict
drives both packages in a parity test.  Keys the port does not read yet
are absent from this registry and pass through unread; the per-operator
kill switches (``spark.rapids.tpu.sql.exec.<Name>``,
``...sql.expression.<Name>``) are read by name through
:meth:`RapidsTpuConf.is_operator_enabled`, as in the reference.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

_REGISTRY: Dict[str, "ConfEntry"] = {}
_REGISTRY_LOCK = threading.Lock()


@dataclass(frozen=True)
class ConfEntry:
    """One typed configuration key with default + documentation."""

    key: str
    default: Any
    doc: str
    value_type: type

    def get(self, conf: "RapidsTpuConf") -> Any:
        raw = conf._settings.get(self.key, self.default)
        if raw is None:
            return None
        if self.value_type is bool and isinstance(raw, str):
            return raw.strip().lower() in ("true", "1", "yes")
        if self.value_type in (int, float) and isinstance(raw, str):
            return self.value_type(raw)
        return raw


def _register(entry: ConfEntry) -> ConfEntry:
    with _REGISTRY_LOCK:
        if entry.key in _REGISTRY:
            raise ValueError(f"duplicate conf key {entry.key}")
        _REGISTRY[entry.key] = entry
    return entry


def conf(key: str, default: Any, doc: str,
         value_type: type = str) -> ConfEntry:
    return _register(ConfEntry(key=key, default=default, doc=doc,
                               value_type=value_type))


# ---------------------------------------------------------------------------
# Planner and session keys (reference config.py:71-704)
# ---------------------------------------------------------------------------

SQL_ENABLED = conf(
    "spark.rapids.tpu.sql.enabled", True,
    "Enable or disable device acceleration of SQL operators entirely.",
    bool)

EXPLAIN = conf(
    "spark.rapids.tpu.sql.explain", "NONE",
    "Explain why parts of a query were or were not placed on the device: "
    "NONE, NOT_ON_TPU, ALL.")

INCOMPATIBLE_OPS = conf(
    "spark.rapids.tpu.sql.incompatibleOps.enabled", False,
    "Enable operators that produce results that differ from Spark in "
    "corner cases (e.g. float aggregation ordering).", bool)

BATCH_SIZE_BYTES = conf(
    "spark.rapids.tpu.sql.batchSizeBytes", 2 << 30,
    "Target size in bytes of one coalesced batch. The query service's "
    "default admission estimate is this times (concurrentTpuTasks + "
    "scan.prefetch.depth).", int)

VARIABLE_FLOAT_AGG = conf(
    "spark.rapids.tpu.sql.variableFloatAgg.enabled", False,
    "Allow float/double aggregations whose result may vary run-to-run "
    "due to reduction ordering.", bool)

MIN_BUCKET_ROWS = conf(
    "spark.rapids.tpu.sql.shape.minBucketRows", 16,
    "Smallest padded row-capacity bucket of an uploaded batch.", int)

CONCURRENT_TPU_TASKS = conf(
    "spark.rapids.tpu.sql.concurrentTpuTasks", 2,
    "Number of partitions the session drains concurrently, one thread "
    "each, all on the session's device.", int)

TEST_ENABLED = conf(
    "spark.rapids.tpu.sql.test.enabled", False,
    "Test mode: assert that every supported operator actually runs on "
    "the device.", bool)

TEST_ALLOWED_NON_TPU = conf(
    "spark.rapids.tpu.sql.test.allowedNonTpu", "",
    "Comma-separated exec/expr class names allowed to stay on CPU in test "
    "mode.")

CAST_STRING_TO_FLOAT = conf(
    "spark.rapids.tpu.sql.castStringToFloat.enabled", False,
    "Enable string-to-float casts on the device.", bool)

CAST_FLOAT_TO_STRING = conf(
    "spark.rapids.tpu.sql.castFloatToString.enabled", True,
    "Enable float-to-string casts on the device.", bool)

ALLOW_INCOMPAT_UTC_ONLY = conf(
    "spark.rapids.tpu.sql.castStringToTimestamp.enabled", False,
    "Enable string-to-timestamp casts (UTC only).", bool)

COLUMN_PRUNING = conf(
    "spark.rapids.tpu.sql.columnPruning.enabled", True,
    "Prune unreferenced columns out of file and in-memory scans before "
    "physical planning (plan/optimizer.py).", bool)

AGG_FUSED_FILTER = conf(
    "spark.rapids.tpu.sql.agg.fusedFilter.enabled", True,
    "Fuse a Filter directly under a hash aggregate into the aggregate's "
    "update as a row mask instead of a compaction.", bool)

FUSION_ENABLED = conf(
    "spark.rapids.tpu.sql.fusion.enabled", True,
    "Whole-stage fusion (plan/fusion.py): collapse chains of "
    "Project/Filter execs into one TpuFusedStageExec and inline the "
    "projections and filters directly under a hash aggregate into it.",
    bool)

FUSION_MAX_EXPRS = conf(
    "spark.rapids.tpu.sql.fusion.maxExprs", 256,
    "Ceiling on the expression-node count of one fused stage's composed "
    "output and condition; past it the chain stays unfused.", int)

AGG_EXCHANGE = conf(
    "spark.rapids.tpu.sql.agg.exchange.enabled", False,
    "Plan grouped aggregates as a hash exchange on the grouping keys "
    "followed by a per-partition aggregate.", bool)

SORT_EXCHANGE = conf(
    "spark.rapids.tpu.sql.sort.exchange.enabled", False,
    "Plan global ORDER BY as a range exchange followed by per-partition "
    "sorts.", bool)

WINDOW_EXCHANGE = conf(
    "spark.rapids.tpu.sql.window.exchange.enabled", False,
    "Plan window functions over PARTITION BY keys as a hash exchange on "
    "those keys followed by per-partition window evaluation "
    "(auto-enabled when shuffle.transport=ici/ici_ring).", bool)

ENABLE_FLOAT_SORT = conf(
    "spark.rapids.tpu.sql.sort.float.enabled", True,
    "Enable sorting on float columns (NaN ordering matches Spark: NaN sorts "
    "greatest).", bool)

SHUFFLE_TRANSPORT = conf(
    "spark.rapids.tpu.shuffle.transport", "local",
    "Shuffle transport of the reference ('local', 'device', 'manager', "
    "'ici', 'ici_ring', 'process').  The exchange runs 'local' (slices "
    "downloaded, Arrow-IPC-serialized into an in-process block store, "
    "re-uploaded once per reducer) and 'device' (slices stay on the "
    "card); the others raise naming the reference module that serves "
    "them (shuffle/manager.py, shuffle/executor_proc.py, shuffle/ici.py), "
    "as does a broadcast join under 'ici'/'ici_ring'.")

SHUFFLE_COMPRESSION_CODEC = conf(
    "spark.rapids.tpu.shuffle.compression.codec", "none",
    "Codec of the 'local' transport's serialized blocks: none (copy), "
    "lz4, zstd, or zlib (accepted; Arrow IPC has no zlib buffer "
    "compression, so those blocks are stored uncompressed).")

SHUFFLE_PARTITIONS = conf(
    "spark.rapids.tpu.sql.shuffle.partitions", 8,
    "Default number of shuffle partitions.", int)

ADAPTIVE_ENABLED = conf(
    "spark.rapids.tpu.sql.adaptive.enabled", True,
    "Adaptive shuffle reads: after a join's exchanges materialize, "
    "coalesce undersized reduce partitions and split skewed ones using "
    "the measured per-partition sizes (exec/adaptive.py; the AQE "
    "CustomShuffleReaderExec analog).", bool)

ADAPTIVE_ADVISORY_PARTITION_SIZE = conf(
    "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes",
    64 << 20,
    "Target output partition size for adaptive coalescing and skew "
    "splitting.", int)

ADAPTIVE_MIN_PARTITION_NUM = conf(
    "spark.rapids.tpu.sql.adaptive.coalescePartitions.minPartitionNum", 1,
    "Lower bound on the post-coalesce partition count.", int)

ADAPTIVE_SKEW_FACTOR = conf(
    "spark.rapids.tpu.sql.adaptive.skewJoin.skewedPartitionFactor", 5,
    "A partition is skewed if its bytes exceed this multiple of the "
    "median partition size (and the absolute threshold).", int)

ADAPTIVE_SKEW_THRESHOLD = conf(
    "spark.rapids.tpu.sql.adaptive.skewJoin."
    "skewedPartitionThresholdInBytes", 256 << 20,
    "Absolute minimum bytes for a partition to be considered skewed.",
    int)

AUTO_BROADCAST_THRESHOLD = conf(
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold", 10 << 20,
    "Max estimated byte size of a join side to broadcast it (-1 "
    "disables).", int)

PARQUET_DEVICE_DECODE = conf(
    "spark.rapids.tpu.sql.format.parquet.deviceDecode.enabled", True,
    "Decode parquet pages on the device (TpuParquetScanExec); off, the "
    "scan stays a host CpuFileScanExec.", bool)

CSV_DEVICE_DECODE = conf(
    "spark.rapids.tpu.sql.format.csv.deviceDecode.enabled", True,
    "Decode CSV files on the device: one pass of torch operations over "
    "the raw bytes finds the delimiters and parses the fields of each "
    "file (io/device_csv.py). Quoted/ragged/exotic files fall back to "
    "the host Arrow reader.", bool)

ORC_DEVICE_DECODE = conf(
    "spark.rapids.tpu.sql.format.orc.deviceDecode.enabled", True,
    "Decode ORC stripes on the device: the host parses stripe footers "
    "and RLEv2 run boundaries, the device expands runs/PRESENT streams "
    "and gathers string dictionaries (io/device_orc.py). Columns with "
    "unsupported encodings fall back to host Arrow decode "
    "individually.", bool)

PARQUET_DEVICE_ENCODE = conf(
    "spark.rapids.tpu.sql.format.parquet.deviceEncode.enabled", True,
    "Encode parquet writes from device batches: per-column null "
    "compaction on the device, one packed download, host page/footer "
    "assembly (io/parquet_encode.py). Unsupported types or partitioned "
    "writes fall back to the host Arrow writer.", bool)

ORC_DEVICE_ENCODE = conf(
    "spark.rapids.tpu.sql.format.orc.deviceEncode.enabled", True,
    "Encode ORC writes from device batches: per-column null compaction "
    "on the device, one packed download, host RLEv1/protobuf stripe "
    "assembly (io/orc_encode.py). Unsupported types or partitioned "
    "writes fall back to the host Arrow writer.", bool)

CACHE_DEVICE_ENCODE = conf(
    "spark.rapids.tpu.sql.cache.deviceEncode.enabled", True,
    "Compress df.cache() batches to parquet blobs with the device "
    "encoder instead of host Arrow.", bool)

CACHE_COMPRESSION = conf(
    "spark.rapids.tpu.sql.cache.compression", "snappy",
    "Parquet compression codec for df.cache() blobs "
    "(none|snappy|zstd|gzip|lz4).")

CACHE_DEVICE_DECODE = conf(
    "spark.rapids.tpu.sql.cache.deviceDecode.enabled", True,
    "Decode cached parquet blobs on the device, falling back per column "
    "like file scans.", bool)

PARQUET_READER_TYPE = conf(
    "spark.rapids.tpu.sql.format.parquet.reader.type", "AUTO",
    "Host parquet reader strategy: AUTO, PERFILE, COALESCING, "
    "MULTITHREADED.")

PARQUET_MULTITHREAD_READ_NUM_THREADS = conf(
    "spark.rapids.tpu.sql.format.parquet.multiThreadedRead.numThreads", 20,
    "Thread pool size for the MULTITHREADED host reader.", int)

CLOUD_SCHEMES = conf(
    "spark.rapids.tpu.cloudSchemes", "gs,s3,s3a,s3n,wasbs,abfs",
    "URI schemes treated as high-latency cloud stores (selects the "
    "MULTITHREADED reader under AUTO).")

SCAN_METADATA_CACHE_ENABLED = conf(
    "spark.rapids.tpu.sql.scan.metadataCache.enabled", True,
    "Cache parsed parquet footers and chunk plans process-wide "
    "(io/scan_cache.py).", bool)

SCAN_METADATA_CACHE_MAX_BYTES = conf(
    "spark.rapids.tpu.sql.scan.metadataCache.maxBytes", 256 << 20,
    "Byte budget of the scan metadata/plan cache.", int)


KERNEL_BACKEND = conf(
    "spark.rapids.tpu.kernel.backend", "pallas",
    "Kernel backend of the reference ('pallas' or 'xla').  The planner "
    "stamps it on every plan node and pushes scan filters only under "
    "'pallas', as the reference does; the kernels do not switch on it: a "
    "CUDA tensor always runs the hand-written kernel, a CPU tensor its "
    "plain torch version.")

KERNEL_ABI_ENABLED = conf(
    "spark.rapids.tpu.kernel.abi.enabled", True,
    "Shape-erased kernel ABI (exec/kernel_abi.py): canonical positional "
    "column names, coarse vbits hint buckets and capacity tiers.", bool)

KERNEL_ABI_TIER_STRIDE = conf(
    "spark.rapids.tpu.kernel.abi.tierStride", 2,
    "Row-capacity tier ladder stride: capacities quantize to every "
    "2^stride-th power-of-two rung (default tiers 16, 64, 256, ...).", int)

KERNEL_ABI_WIDTH_STRIDE = conf(
    "spark.rapids.tpu.kernel.abi.widthStride", 2,
    "String/list max-width tier ladder stride (default tiers 1, 4, 16, "
    "64, ...).", int)

KERNEL_ABI_BUCKET_HINTS = conf(
    "spark.rapids.tpu.kernel.abi.bucketHints", True,
    "Re-bucket DeviceColumn.vbits value-range hints to {16, 32, 56}.",
    bool)

MAX_READER_BATCH_SIZE_ROWS = conf(
    "spark.rapids.tpu.sql.reader.batchSizeRows", 1 << 21,
    "Max rows a file reader emits per batch. (reference: RapidsConf.scala:378)",
    int)

MAX_READER_BATCH_SIZE_BYTES = conf(
    "spark.rapids.tpu.sql.reader.batchSizeBytes", 2 << 30,
    "Max bytes a file reader emits per batch.", int)

PARQUET_FUSED_DECODE = conf(
    "spark.rapids.tpu.sql.format.parquet.fusedDecode.enabled", True,
    "Decode all columns of all coalesced row groups of a scan batch in "
    "one fused pass (io/parquet_fused.py); off, the scan takes its "
    "PERFILE reader (one batch per row group, decoded column by "
    "column).", bool)

SCAN_HOST_PREP_THREADS = conf(
    "spark.rapids.tpu.sql.scan.hostPrep.threads", 4,
    "Thread-pool size for parallel scan host prep: page-header and RLE "
    "run-boundary walks across (column, row-group) pairs run "
    "concurrently instead of sequentially (page reads and codec "
    "decompression release the GIL). 1 disables the pool.", int)

SCAN_PREFETCH_DEPTH = conf(
    "spark.rapids.tpu.sql.scan.prefetch.depth", 2,
    "Bounded look-ahead for the fused parquet scan: up to this many "
    "batches' host prep + packed-page upload run ahead of the "
    "dispatch-only device decode of the current batch (prep of batch "
    "k+1 overlaps decode of batch k; no device->host read happens "
    "before the terminal barrier). 0 disables pipelining.", int)

SCAN_SHARED_ENABLED = conf(
    "spark.rapids.tpu.sql.scan.shared.enabled", True,
    "Multicast decoded scan batches across concurrent queries: when "
    "two plans decode the same (file, row-group, column-set, stamp) "
    "key at the same time, one decodes and every subscriber receives "
    "the decoded batch (refcounted retention window; eviction is "
    "always correctness-safe: a miss just re-decodes). Off reverts to "
    "per-query decoding (io/scan_share.py).", bool)

SCAN_SHARED_WINDOW_BYTES = conf(
    "spark.rapids.tpu.sql.scan.shared.windowBytes", 64 << 20,
    "Byte budget for the shared-scan multicast retention window "
    "(decoded batches kept briefly so a slightly-behind subscriber "
    "still shares the decode). LRU eviction; the window also registers "
    "as a pressure spiller so memory pressure drops retained batches "
    "first.", int)

# ---------------------------------------------------------------------------
# Memory, out-of-core join and admission keys (reference config.py:282-298,
# :483-516, :739-753)
# ---------------------------------------------------------------------------

MEM_DEVICE_LIMIT = conf(
    "spark.rapids.tpu.memory.device.batchStorageSize", 4 << 30,
    "Bytes of device budget for registered spillable batches; exceeding "
    "it triggers synchronous device->host spill (mem/spill.py).", int)

MEM_SPILL_ENABLED = conf(
    "spark.rapids.tpu.memory.spill.enabled", True,
    "Enable device->host->disk spill of registered batches under memory "
    "pressure.", bool)

MEM_HOST_SPILL_LIMIT = conf(
    "spark.rapids.tpu.memory.host.spillStorageSize", 8 << 30,
    "Bytes of host memory used to cache spilled device batches before "
    "falling through to disk.", int)

MEM_SPILL_DIR = conf(
    "spark.rapids.tpu.memory.spill.dir", "",
    "Directory for the disk spill tier (defaults to a temp dir).")

JOIN_OOCORE_ENABLED = conf(
    "spark.rapids.tpu.sql.join.oocore.enabled", True,
    "Out-of-core grace hash join (exec/join_partition.py): when a "
    "join's per-partition build side exceeds join.buildSideBudgetBytes "
    "it is hash-partitioned (a different murmur seed per recursion "
    "level, decorrelated from the exchange's bucketing) into 2^k grace "
    "partitions together with its probe side; partitions spill through "
    "the device->host->disk tiers and each grace partition is "
    "re-streamed and joined alone, recursing on a still-oversized "
    "partition. Under-budget joins take the unpartitioned path; off "
    "reverts entirely.", bool)

JOIN_BUILD_BUDGET = conf(
    "spark.rapids.tpu.sql.join.buildSideBudgetBytes", 0,
    "Per-partition build-side byte budget that activates the "
    "out-of-core grace join. 0 (default) derives it from the admission "
    "budget: sched.memoryBudget (or 0.9 of the card's memory; 8 GiB on "
    "the CPU) divided by sched.maxConcurrent. -1 disables the budget "
    "check (build sides gather unconditionally).", int)

JOIN_OOCORE_PARTITIONS_LOG2 = conf(
    "spark.rapids.tpu.sql.join.oocore.partitionsLog2", 0,
    "Explicit grace fan-out exponent: partition both sides into 2^k "
    "pieces when the build side exceeds the budget. 0 (default) picks "
    "the smallest k whose expected per-partition build size fits the "
    "budget, capped at 5 (32-way).", int)

JOIN_OOCORE_MAX_RECURSION = conf(
    "spark.rapids.tpu.sql.join.oocore.maxRecursion", 3,
    "Recursion-depth bound for grace partitions that stay over budget "
    "after a split (duplicate-heavy keys). At the bound, or as soon as "
    "a level fails to shrink the partition (a single hot key cannot "
    "hash-split), the join streams the probe side in chunks against "
    "the oversized build partition.", int)

JOIN_SKEW_ENABLED = conf(
    "spark.rapids.tpu.sql.join.skew.enabled", False,
    "Runtime hot-bucket splitting at the shuffle boundary: the "
    "map-output tracker aggregates per-(map, reduce-bucket) sizes as "
    "map tasks complete; a probe-side bucket over "
    "join.skew.bucketFactor x the median splits into sub-readers "
    "BEFORE the reduce fetch, each joined against a replica (or "
    "broadcast, when small) of the matching build bucket. Takes over "
    "the skew half of the adaptive reader for eligible joins; off "
    "(default) keeps the plan shape exactly.", bool)

JOIN_SKEW_FACTOR = conf(
    "spark.rapids.tpu.sql.join.skew.bucketFactor", 4.0,
    "A reduce bucket is hot when its projected probe-side bytes exceed "
    "this multiple of the median nonzero bucket size (and the "
    "join.skew.minBucketBytes floor).", float)

JOIN_SKEW_MIN_BUCKET_BYTES = conf(
    "spark.rapids.tpu.sql.join.skew.minBucketBytes", 4 << 20,
    "Absolute floor for hot-bucket detection: buckets under this many "
    "bytes are never split regardless of the factor.", int)

JOIN_SKEW_MAX_SPLITS = conf(
    "spark.rapids.tpu.sql.join.skew.maxSplits", 8,
    "Upper bound on the sub-readers one hot bucket splits into (the "
    "split count otherwise targets the median bucket size).", int)

JOIN_SKEW_BROADCAST_THRESHOLD = conf(
    "spark.rapids.tpu.sql.join.skew.broadcastThresholdBytes", 8 << 20,
    "When the hot bucket's matching build-side bucket is under this "
    "many bytes it is broadcast (one shared device batch reused by "
    "every sub-join); over it the bucket is still shared by reference "
    "but counted as a replication.", int)

SCHED_MEMORY_BUDGET = conf(
    "spark.rapids.tpu.sched.memoryBudget", 0,
    "Device byte budget the admission controller packs query estimates "
    "into: queries are admitted while the sum of their declared "
    "working-set estimates stays under it (sched.maxConcurrent is the "
    "hard count cap); excess queries queue instead of running out of "
    "the card. 0 derives it from the session's device (0.9 of the "
    "card's memory; 8 GiB on the CPU). The grace join's default budget "
    "is one query's share of it.", int)

SCHED_MAX_CONCURRENT = conf(
    "spark.rapids.tpu.sched.maxConcurrent", 4,
    "Hard cap on concurrently RUNNING queries in the per-session "
    "QueryService, regardless of memory estimates (the inter-query "
    "layer above sql.concurrentTpuTasks, which still bounds "
    "device-task concurrency inside admitted queries).", int)

SCHED_DEFAULT_TIMEOUT_MS = conf(
    "spark.rapids.tpu.sched.defaultTimeoutMs", 0,
    "Default per-query deadline in milliseconds, covering queue wait "
    "AND execution; on expiry the query's CancelToken fires with "
    "timed_out=true and the query unwinds (admission slot released, "
    "prefetcher drained, spill entries freed), raising "
    "QueryTimeoutError from result(). 0 disables; "
    "submit(timeout_ms=...) overrides per query.", int)

SCHED_MAX_QUEUED = conf(
    "spark.rapids.tpu.sched.maxQueued", 1024,
    "Bound on the admission wait queue; submissions past it are "
    "rejected with QueryRejectedError (back-pressure instead of an "
    "unbounded thread pile-up).", int)

SCHED_QUERY_ESTIMATE_BYTES = conf(
    "spark.rapids.tpu.sched.queryEstimateBytes", 0,
    "Fixed device working-set estimate per query for admission control. "
    "0 (default) derives batchSizeBytes x (concurrentTpuTasks + "
    "scan.prefetch.depth), then refines per plan shape from the spill "
    "catalog's device-bytes high-water mark of prior runs; "
    "submit(estimate_bytes=...) overrides per query.", int)

SCHED_DEDUP_ENABLED = conf(
    "spark.rapids.tpu.sched.dedup.enabled", True,
    "Single-flight execution: concurrent submissions of the same "
    "deterministic plan (same canonical digest + output names) join "
    "one in-flight execution instead of running N copies; followers' "
    "futures resolve from the leader's result, and cancelling the "
    "leader promotes a follower instead of killing the flight. "
    "Non-deterministic plans always bypass. Off reverts to "
    "one execution per submission.", bool)

# ---------------------------------------------------------------------------
# Observability keys (reference config.py:719-737, :790-863, :1168-1210, :1243)
# ---------------------------------------------------------------------------

OBS_TRACE_ENABLED = conf(
    "spark.rapids.tpu.obs.trace.enabled", False,
    "Record execution spans (scan prep/upload/dispatch, exchange "
    "phases, semaphore waits, pyworker batches) into the bounded "
    "in-process ring buffer. Disabled, the instrumented paths take a "
    "single-bool-check no-op. Spans surface through the per-query "
    "profile and the Chrome trace exporter "
    "(obs/trace.py; open in Perfetto or chrome://tracing).", bool)

OBS_TRACE_BUFFER_SPANS = conf(
    "spark.rapids.tpu.obs.trace.bufferSpans", 65536,
    "Capacity of the span ring buffer; when a query outruns it the "
    "oldest spans drop (bounded memory, never the process).", int)

OBS_TRACE_CHROME_PATH = conf(
    "spark.rapids.tpu.obs.trace.chromePath", "",
    "When set (and tracing is enabled), every query's span window is "
    "also written to this path as Chrome trace-event JSON, overwriting "
    "the previous query's file.")

OBS_PROFILE_ENABLED = conf(
    "spark.rapids.tpu.obs.profile.enabled", True,
    "Assemble a QueryProfile after every action (annotated plan tree, "
    "wall breakdown, per-query registry delta, explain report) — "
    "surfaced via session.last_query_profile(), "
    "DataFrame.explain('profile'), and query listeners.", bool)

SCHED_PROFILE_RING = conf(
    "spark.rapids.tpu.sched.profileRing", 64,
    "How many completed QueryProfiles the session retains, keyed by "
    "query id (last_query_profile() returns the most recently "
    "COMPLETED query's profile).", int)

OBS_RECORDER_DIR = conf(
    "spark.rapids.tpu.obs.recorder.dir", "",
    "Directory for flight-recorder diagnostic bundles. Non-empty "
    "enables the recorder: a bounded in-memory ring of recent engine "
    "events (spill traffic, OOM retries, grace-join activations, slow "
    "queries) is kept, and on query failure, timeout, cancellation, or "
    "an OOM-retried success a self-contained bundle (profile.json + "
    "trace.json + events.jsonl + config.json + registry.json) is "
    "written here. Empty (default) disables the recorder entirely; "
    "event hooks cost one bool check. Bundles ride the QueryProfile "
    "assembly path, so obs.profile.enabled must stay true (its "
    "default) for them to fire.")

OBS_RECORDER_MAX_EVENTS = conf(
    "spark.rapids.tpu.obs.recorder.maxEvents", 4096,
    "Capacity of the flight recorder's in-memory event ring; the "
    "oldest events drop when a busy engine outruns it (bounded memory, "
    "never the process).", int)

OBS_SLOW_QUERY_MS = conf(
    "spark.rapids.tpu.obs.slowQueryMs", 0,
    "Wall-clock threshold in milliseconds for the structured "
    "slow-query log: a completed (or failed) query at or over it emits "
    "ONE JSONL record (ts, query_id, status, error, wall_s, "
    "queue_wait_s, result_rows, phases, wall_breakdown) to "
    "obs.slowQueryPath, or through the "
    "'spark_rapids_tpu_torch.obs.slowquery' python logger when no path "
    "is set. 0 (default) disables. Rides the QueryProfile assembly "
    "path, so obs.profile.enabled must stay true (its default).", int)

OBS_SLOW_QUERY_PATH = conf(
    "spark.rapids.tpu.obs.slowQueryPath", "",
    "Append-mode file for slow-query JSONL records (one JSON object "
    "per line). Empty routes records to the python logger instead.")

OBS_SLOW_QUERY_MAX_BYTES = conf(
    "spark.rapids.tpu.obs.slowQueryMaxBytes", 16 * 1024 * 1024,
    "Size-based rotation for the slow-query JSONL file (and the drift "
    "sentinel's breach log): when an append "
    "would push the file past this many bytes, it is atomically "
    "renamed to <path>.1 (replacing the previous .1) and a fresh file "
    "starts — the keep-1 logrotate shape, at most 2x this size on disk. "
    "0 disables rotation (unbounded append).", int)

OBS_ACCOUNTING_ENABLED = conf(
    "spark.rapids.tpu.obs.accounting.enabled", True,
    "Per-tenant resource metering (obs/accounting.py): attributes "
    "kernel dispatches, compile wall and scan bytes walked/uploaded to "
    "the owning (session, statement template | plan digest) tenant. "
    "Off: every charging hook is one bool check (the obs.compile "
    "pattern).", bool)

OBS_HTTP_ENABLED = conf(
    "spark.rapids.tpu.obs.http.enabled", False,
    "Serve the live operational telemetry endpoint from a background "
    "daemon thread: /metrics (Prometheus text exposition of the "
    "MetricsRegistry plus live scheduler gauges), /queries (the "
    "QueryService's queued/running/recently-completed table), "
    "/profiles/<qid> (QueryProfile JSON from the profile ring), "
    "/compiles, /tenants, /slo and /healthz. Off by default: nothing "
    "binds a socket and the serving path costs nothing.", bool)

OBS_HTTP_PORT = conf(
    "spark.rapids.tpu.obs.http.port", 0,
    "TCP port for the telemetry endpoint when obs.http.enabled=true. "
    "0 binds an ephemeral port (discover it via "
    "session.obs_server.port).", int)

OBS_HTTP_HOST = conf(
    "spark.rapids.tpu.obs.http.host", "127.0.0.1",
    "Bind address for the telemetry endpoint (loopback by default; "
    "widen deliberately, the endpoint is unauthenticated).")

OBS_SENTINEL_ENABLED = conf(
    "spark.rapids.tpu.obs.sentinel.enabled", False,
    "Drift sentinel (obs/sentinel.py): a background watcher sampling "
    "the metrics registry every obs.sentinel.intervalMs, comparing "
    "windowed rates against a trailing EWMA baseline, and on a "
    "sustained breach (p95 latency regression, slow-query spike, "
    "result-cache hit-rate collapse, compile storm, spill surge) "
    "emitting ONE flight-recorder bundle per episode (reason 'slo') "
    "with per-tenant top-talkers attached, obs.sentinel.breaches[.rule]"
    " counters, and a structured JSONL line. Off by default: no "
    "thread runs.", bool)

OBS_SENTINEL_INTERVAL_MS = conf(
    "spark.rapids.tpu.obs.sentinel.intervalMs", 1000,
    "Sampling window of the drift sentinel in milliseconds; each tick "
    "evaluates the rule set against the delta since the previous "
    "tick.", int)

OBS_SENTINEL_RULES = conf(
    "spark.rapids.tpu.obs.sentinel.rules", "",
    "Rule spec for the drift sentinel: semicolon-separated "
    "rule:key=val,key=val entries, e.g. "
    "'latency:factor=2,sustain=2;slow:min=5' enables ONLY those rules "
    "with the given overrides. Empty (default) enables every rule "
    "(latency, slow, cacheHit, compile, spill) at its defaults; a "
    "mistyped rule or parameter raises at session init rather than "
    "silently disarming the watcher.")

OBS_SENTINEL_PATH = conf(
    "spark.rapids.tpu.obs.sentinel.path", "",
    "JSONL file for the sentinel's structured breach records (rotated "
    "by obs.slowQueryMaxBytes, the slow-query log's writer). Empty "
    "disables the breach log; flight-recorder bundles and counters "
    "still fire.")

OBS_COMPILE_ENABLED = conf(
    "spark.rapids.tpu.obs.compile.enabled", True,
    "Record a CompileEvent for every first (kernel, arg-shape) call "
    "through the process kernel cache — the compile observatory "
    "(obs/compile.py): kernel family, canonical shape/dtype signature, "
    "backend, first-call wall, tier (fresh nvcc build / reload of a "
    "library an earlier process built), and the triggering query id + "
    "plan digest. Events land in a bounded ring with process-lifetime "
    "per-family aggregates, surface as kernel.compile spans in the "
    "Chrome trace, a 'compile' QueryProfile section and "
    "kernel.compile.* registry counters. Disabled, kernels built "
    "afterwards carry no observe wrapper.", bool)

OBS_COMPILE_RING_EVENTS = conf(
    "spark.rapids.tpu.obs.compile.ringEvents", 4096,
    "Capacity of the compile observatory's event ring; the oldest "
    "events drop past it (process-lifetime aggregates — per-family "
    "program/signature counts, compile wall — are unaffected).", int)

OBS_COMPILE_STORM_THRESHOLD = conf(
    "spark.rapids.tpu.obs.compile.stormThreshold", 64,
    "Programs one query may record before the observatory flags a "
    "'compile storm': a flight-recorder compile.storm event (once per "
    "query) plus the kernel.compile.storms counter.", int)

OBS_COMPILE_CORPUS_PATH = conf(
    "spark.rapids.tpu.obs.compile.corpusPath", "",
    "Append-mode JSONL file for the precompile corpus: on the first "
    "completion of each distinct plan digest that recorded at least "
    "one program, one record {plan_digest, query_id, programs: "
    "[{family, key, signature, backend, replay}]} is appended. Empty "
    "(default) disables corpus emission.")

OBS_COMPILE_CORPUS_REPLAY = conf(
    "spark.rapids.tpu.obs.compile.corpusReplay", True,
    "Attach a replay payload to each corpus program record so the "
    "precompile service (sched/precompile.py) can warm a fresh "
    "process. The port's payload names the csrc libraries the program's "
    "step loaded (kernels/_build.py), with the program's key and "
    "signature; a program that loads none carries null and counts as "
    "skipped at replay.", bool)

SCHED_PRECOMPILE_ENABLED = conf(
    "spark.rapids.tpu.sched.precompile.enabled", False,
    "Start the background precompile service at session init "
    "(sched/precompile.py): replays the precompile corpus "
    "(sched.precompile.corpusPath, falling back to "
    "obs.compile.corpusPath) at low priority, pausing whenever the "
    "scheduler has live queries, so a restarted process builds or "
    "reopens its kernel libraries off the serving path.", bool)

SCHED_PRECOMPILE_CORPUS_PATH = conf(
    "spark.rapids.tpu.sched.precompile.corpusPath", "",
    "Corpus JSONL the precompile service replays (a file written by a "
    "previous process via obs.compile.corpusPath). A DIRECTORY "
    "replays every *.jsonl inside it. Empty: falls back to this "
    "session's obs.compile.corpusPath.")

SCHED_PRECOMPILE_IDLE_WAIT_MS = conf(
    "spark.rapids.tpu.sched.precompile.idleWaitMs", 25,
    "How long the precompile service sleeps between corpus programs, "
    "and while waiting for the scheduler to drain live queries before "
    "replaying the next one.", int)


class RapidsTpuConf:
    """Accessor over a settings map."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings: Dict[str, Any] = dict(settings or {})

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self)

    def get_raw(self, key: str, default: Any = None) -> Any:
        return self._settings.get(key, default)

    def set(self, key: str, value: Any) -> "RapidsTpuConf":
        self._settings[key] = value
        return self

    def is_operator_enabled(self, key: str, incompat: bool,
                            disabled_by_default: bool) -> bool:
        """Per-operator kill-switch lookup."""
        raw = self._settings.get(key)
        if raw is not None:
            if isinstance(raw, str):
                return raw.strip().lower() in ("true", "1", "yes")
            return bool(raw)
        if disabled_by_default:
            return False
        if incompat:
            return self.get(INCOMPATIBLE_OPS)
        return True

    @property
    def sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED)

    @property
    def explain(self) -> str:
        return str(self.get(EXPLAIN)).upper()

    @property
    def shuffle_partitions(self) -> int:
        return self.get(SHUFFLE_PARTITIONS)

    @property
    def test_enabled(self) -> bool:
        return self.get(TEST_ENABLED)

    @property
    def test_allowed_non_tpu(self) -> List[str]:
        raw = self.get(TEST_ALLOWED_NON_TPU) or ""
        return [s.strip() for s in raw.split(",") if s.strip()]


def configure(settings) -> RapidsTpuConf:
    """Apply a conf (dict or :class:`RapidsTpuConf`) to the process-wide
    knobs the port reads: the kernel-backend validation and the kernel
    ABI ladders.  Last call wins, as with the reference's session init."""
    from spark_rapids_tpu_torch.exec import kernel_abi
    from spark_rapids_tpu_torch.kernels import backend
    c = settings if isinstance(settings, RapidsTpuConf) \
        else RapidsTpuConf(settings)
    backend.configure(c)
    kernel_abi.configure(c)
    return c
